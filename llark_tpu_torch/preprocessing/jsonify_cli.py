"""CLI over the jsonifier registry (counterpart of
llark_tpu/preprocessing/jsonify_cli.py).

Parity: scripts/preprocessing/jsonify_dataset.py:34-66.

  python -m llark_tpu_torch.preprocessing.jsonify_cli \
      --dataset mtg-jamendo --input-dir /data/jamendo --split train \
      [--output /path/out.jsonl]
"""

from __future__ import annotations

import argparse

from llark_tpu_torch.preprocessing.jsonify import _JSONIFIERS, get_jsonifier


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True, choices=sorted(_JSONIFIERS))
    p.add_argument("--input-dir", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--output", default=None)
    ns = p.parse_args(argv)
    j = get_jsonifier(ns.dataset, ns.input_dir, ns.split)
    j.load_raw_data()
    path = j.export_to_json(ns.output)
    print(f"{ns.dataset}/{ns.split}: {len(j.data)} rows -> {path}")


if __name__ == "__main__":
    main()
