"""Batch inference over WebDataset eval shards -> CSV (counterpart of
llark_tpu/inference/from_webdataset.py; parity:
scripts/inference/infer_from_webdataset.py). Usage:

  python -m llark_tpu_torch.inference.from_webdataset \
      --checkpoint-dir run --input 'eval-{000..003}.tar' \
      --output results.csv [--prompt "..."] [--max-samples N] \
      [--continuous-batching 8 --kv-block-size 128 --kv-cache-int8 \
       --prefill-chunk 256] [--device cpu]

`--checkpoint-dir` is a run directory written by the port's `train()`
(an HF checkpoint is imported through `train()` first). Each row's
example id is its sample key with the packer's crop-window encoding
undone. The model runs on the GPU unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from llark_tpu_torch.data.shards import expand_url_to_file_list
from llark_tpu_torch.data.webdataset import TarShardReader
from llark_tpu_torch.dataset_utils import wds_key_to_original_id
from llark_tpu_torch.infer import batch_infer, batch_infer_continuous
from llark_tpu_torch.inference.common import (
    add_generation_args,
    apply_serving_overrides,
    check_serving_args,
    load_draft,
    load_generator,
    make_gen_cfg,
    write_results_csv,
)
from llark_tpu_torch.models.utils import load_pretrained_model

log = logging.getLogger(__name__)


def iter_eval_rows(urls, max_samples=None):
    """Rows {example_id, prompt, response, audio_encoding} of the shards'
    samples that hold an encoding (`.pyd` or `.npy`), at most `max_samples`."""
    n = 0
    for sample in TarShardReader(urls):
        js = sample.get("json") or {}
        enc = sample.get("audio_encoding.pyd")
        if enc is None:
            enc = sample.get("audio_encoding.npy")
        if enc is None:
            continue
        responses = js.get("response") or [{}]
        first = responses[0] if isinstance(responses, list) else {}
        yield {
            # undo the packer's dot->underscore key encoding so CSV ids
            # join against the original (crop-window) example ids
            "example_id": wds_key_to_original_id(sample["__key__"]),
            "prompt": first.get("question"),
            "response": first.get("answer", ""),
            "audio_encoding": np.asarray(enc, np.float32),
        }
        n += 1
        if max_samples is not None and n >= max_samples:
            return


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--ckpt-num", type=int, default=None)
    p.add_argument("--input", required=True, help="shard url pattern")
    p.add_argument("--output", required=True, help="output csv path")
    p.add_argument("--prompt", default=None, help="override prompt for all rows")
    p.add_argument("--max-samples", type=int, default=None)
    add_generation_args(p)
    p.add_argument("--max-audio-frames", type=int, default=None)
    p.add_argument("--continuous-batching", type=int, default=0, metavar="SLOTS",
                   help="serve through the continuous-batching engine with SLOTS "
                        "decode slots (0 = one-at-a-time Generator)")
    p.add_argument("--device", default="cuda",
                   help="device to run on (default: the GPU; 'cpu' runs the plain "
                        "PyTorch path)")
    args = p.parse_args(argv)
    check_serving_args(args)

    cfg, params, bundle = load_pretrained_model(args.checkpoint_dir, args.ckpt_num, args.device)
    cfg = apply_serving_overrides(args, cfg)
    urls = expand_url_to_file_list(args.input)
    rows = list(iter_eval_rows(urls, args.max_samples))
    log.info("running inference over %d rows", len(rows))
    if args.continuous_batching:
        draft_cfg, draft_params = load_draft(args, args.device)
        results = batch_infer_continuous(
            rows, cfg, params, bundle,
            gen_cfg=make_gen_cfg(args),
            max_batch=args.continuous_batching,
            max_cache_len=args.max_cache_len,
            max_audio_frames=args.max_audio_frames or 256,
            prefill_chunk=args.prefill_chunk,
            draft_cfg=draft_cfg,
            draft_params=draft_params,
            gamma=args.gamma,
            spec_rounds=args.spec_rounds,
            spec_mode="ngram" if args.speculative == "ngram" else None,
            allow_divergent_spec=args.allow_divergent_spec,
            prompt_override=args.prompt,
            prefix_cache=args.prefix_cache,
            kv_block_size=args.kv_block_size,
            kv_pool_blocks=args.kv_pool_blocks,
            admit_batch=args.admit_batch,
            admit_min_fill=args.admit_min_fill,
            admit_max_wait_s=args.admit_max_wait_ms / 1000.0,
            admit_reorder=args.admit_reorder,
            admit_reorder_age_s=args.admit_reorder_age_ms / 1000.0,
            decode_chunk=args.decode_chunk,
            decode_chunk_drain=args.decode_chunk_drain,
            drain_max_active=args.drain_max_active,
            device=args.device,
        )
    else:
        gen = load_generator(args, bundle, cfg, params, device=args.device)
        results = batch_infer(
            rows, gen, bundle,
            prompt_override=args.prompt,
            max_audio_frames=args.max_audio_frames,
        )
    write_results_csv(args.output, results)
    print(f"wrote {len(results)} rows to {args.output}")


if __name__ == "__main__":
    main()
