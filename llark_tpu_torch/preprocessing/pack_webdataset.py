"""Pack instruct JSONL + audio encodings into WebDataset training shards
(counterpart of llark_tpu/preprocessing/pack_webdataset.py).

Fills the gap noted in SURVEY.md §3.4: the reference ships packing
*helpers* (m2t/dataset_utils/__init__.py:234-272) but no packing script.
Output sample layout matches what the training pipeline reads:
  <key>.json               {..., "response": [{question, answer}, ...]}
  <key>.audio_encoding.pyd pickled [T, mm_hidden] float32

Usage:
  python -m llark_tpu_torch.preprocessing.pack_webdataset \
      --instruct-jsonl qa.jsonl --encodings-dir /encs \
      --output-pattern '/shards/mir-train-%05d.tar' \
      [--id-col id] [--max-count 512]
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
from typing import Dict

import numpy as np

from llark_tpu_torch.data.webdataset import TarShardWriter
from llark_tpu_torch.dataset_utils import example_id_to_wds_key

log = logging.getLogger(__name__)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--instruct-jsonl", required=True)
    p.add_argument("--encodings-dir", required=True)
    p.add_argument("--output-pattern", required=True)
    p.add_argument("--id-col", default="id")
    p.add_argument("--max-count", type=int, default=512)
    ns = p.parse_args(argv)

    enc_by_id: Dict[str, str] = {}
    for f in glob.glob(os.path.join(ns.encodings_dir, "*.npy")):
        enc_by_id[os.path.splitext(os.path.basename(f))[0]] = f

    written = skipped = 0
    with TarShardWriter(ns.output_pattern, max_count=ns.max_count) as w:
        with open(ns.instruct_jsonl) as f:
            for line in f:
                if not line.strip():
                    continue
                row = json.loads(line)
                key = str(row[ns.id_col])
                enc_path = enc_by_id.get(key)
                if enc_path is None:
                    log.warning("no encoding for %s; skipping", key)
                    skipped += 1
                    continue
                if not isinstance(row.get("response"), list) or not row["response"]:
                    log.warning("no response list for %s; skipping", key)
                    skipped += 1
                    continue
                enc = np.load(enc_path).astype(np.float32)
                w.write(
                    {
                        # dots in ids (crop windows) would read back as tar
                        # field extensions; encode them (reference key format)
                        "__key__": example_id_to_wds_key(key),
                        "json": row,
                        "audio_encoding.pyd": enc,
                    }
                )
                written += 1
    print(f"packed {written} samples ({skipped} skipped) -> {ns.output_pattern}")


if __name__ == "__main__":
    main()
