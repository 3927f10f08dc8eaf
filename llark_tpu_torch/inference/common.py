"""Shared CLI plumbing for batch inference (counterpart of
llark_tpu/inference/common.py)."""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, Sequence


def write_results_csv(path: str, rows: Sequence[Dict]) -> None:
    """CSV contract matching the reference's eval substrate
    (reference: scripts/inference/infer_from_webdataset.py:150-151)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fields = ["example_id", "prompt", "response", "model_completion"]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for r in rows:
            w.writerow({k: r.get(k, "") for k in fields})


def add_generation_args(p) -> None:
    """Generation flags shared by the batch-inference CLIs (the JAX
    package's set, so one command line drives either)."""
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--max-cache-len", type=int, default=2048)
    p.add_argument("--speculative", choices=("off", "ngram", "draft"), default="off",
                   help="speculative decoding: 'ngram' = prompt-lookup drafting (no "
                        "extra weights), 'draft' = a small draft checkpoint "
                        "(--draft-checkpoint-dir)")
    p.add_argument("--gamma", type=int, default=4,
                   help="speculative draft length per verify round")
    p.add_argument("--allow-divergent-spec", action="store_true",
                   help="permit --speculative below fp32: bf16 products round "
                        "differently between the verify and decode shapes, so "
                        "speculative output can differ from plain greedy decode. "
                        "Without this flag, sub-fp32 speculation is refused")
    p.add_argument("--spec-rounds", type=int, default=2,
                   help="with --continuous-batching + --speculative draft: fused "
                        "propose/verify rounds per decode round")
    p.add_argument("--prefix-cache", action="store_true",
                   help="with --continuous-batching: prefill the KV of the longest "
                        "common token prefix of all prompts ONCE (every LLark "
                        "prompt opens with the same conversation header); "
                        "admission computes only each request's suffix")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="with --continuous-batching: admit prompts in chunks of "
                        "this many tokens, interleaving decode rounds so live "
                        "slots keep emitting during long prefills")
    p.add_argument("--kv-cache-int8", action="store_true",
                   help="store the KV cache as int8 with per-position scales "
                        "(half the cache memory)")
    p.add_argument("--kv-block-size", type=int, default=None,
                   help="with --continuous-batching: paged KV -- the cache becomes "
                        "a physical block pool of this block size with per-slot "
                        "block tables; memory scales with the live-token budget "
                        "instead of slots x max-cache-len")
    p.add_argument("--kv-pool-blocks", type=int, default=None,
                   help="physical pool size for --kv-block-size, including one "
                        "parking block per slot (default: dense-equivalent "
                        "capacity)")
    p.add_argument("--admit-batch", type=int, default=None,
                   help="with --continuous-batching: admission prefill rows per "
                        "forward (default: all slots), the transient-memory knob")
    p.add_argument("--admit-min-fill", type=int, default=1,
                   help="with --continuous-batching: admission hysteresis -- hold "
                        "queued requests until this many are waiting (or "
                        "--admit-max-wait-ms passes, or no slot is decoding)")
    p.add_argument("--decode-chunk", type=int, default=8,
                   help="with --continuous-batching: tokens decoded per round for "
                        "all live slots (one host read per round)")
    p.add_argument("--decode-chunk-drain", type=int, default=None,
                   help="with --continuous-batching: SHORTER decode chunk used "
                        "while at most --drain-max-active slots are live, so "
                        "arrivals are admitted sooner at low load")
    p.add_argument("--drain-max-active", type=int, default=None,
                   help="with --decode-chunk-drain: drain rounds fire only while "
                        "at most this many slots are live (default: half of "
                        "--continuous-batching)")
    p.add_argument("--admit-reorder", action="store_true",
                   help="with --continuous-batching: the largest queued same-"
                        "bucket group wins each admission wave instead of "
                        "strict FIFO, bounded by --admit-reorder-age-ms")
    p.add_argument("--admit-reorder-age-ms", type=float, default=500.0,
                   help="anti-starvation bound for --admit-reorder")
    p.add_argument("--admit-max-wait-ms", type=float, default=50.0,
                   help="hysteresis deadline for --admit-min-fill")
    p.add_argument("--num-beams", type=int, default=1,
                   help="beam search width (1 = greedy/sampling; the HF generate "
                        "num_beams counterpart)")
    p.add_argument("--draft-checkpoint-dir", default=None)
    p.add_argument("--draft-ckpt-num", type=int, default=None)


def apply_serving_overrides(args, cfg):
    """Apply serving-only config overrides from CLI flags."""
    if getattr(args, "kv_cache_int8", False):
        cfg = dataclasses.replace(cfg, kv_cache_quant=True)
    return cfg


def make_gen_cfg(args):
    """One GenerationConfig from the shared flags, for the one-at-a-time
    and the continuous-batching paths alike."""
    from llark_tpu_torch.generate import GenerationConfig

    return GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        top_p=getattr(args, "top_p", 1.0),
        top_k=getattr(args, "top_k", 0),
        stop_text="###",
    )


def check_serving_args(args) -> None:
    """Reject flag combinations that would otherwise be silently ignored
    (llark_tpu/inference/common.py:146-196)."""
    if getattr(args, "continuous_batching", 0):
        spec = getattr(args, "speculative", "off")
        if spec == "draft" and not getattr(args, "draft_checkpoint_dir", None):
            raise SystemExit("--speculative draft requires --draft-checkpoint-dir")
        if getattr(args, "kv_block_size", None):
            if getattr(args, "prefix_cache", False) and not getattr(args, "prefill_chunk", None):
                raise SystemExit(
                    "--prefix-cache with --kv-block-size (paged KV) rides the "
                    "direct-to-pool chunked admission path: also pass "
                    "--prefill-chunk (a bucket-sized chunk gives one-shot "
                    "admission behavior)"
                )
        elif getattr(args, "prefix_cache", False) and getattr(args, "prefill_chunk", None):
            raise SystemExit(
                "--prefix-cache and --prefill-chunk are mutually exclusive without "
                "--kv-block-size (dense prefix caching already prefills only the "
                "short per-request suffix); drop one or add --kv-block-size for "
                "the paged direct-to-pool path"
            )
    elif getattr(args, "kv_block_size", None):
        raise SystemExit("--kv-block-size requires --continuous-batching")
    pfc = getattr(args, "prefill_chunk", None)
    if pfc is not None:
        if not getattr(args, "continuous_batching", 0):
            raise SystemExit("--prefill-chunk requires --continuous-batching")
        if pfc < 1:
            raise SystemExit("--prefill-chunk must be >= 1")
    ab = getattr(args, "admit_batch", None)
    if ab is not None:
        if not getattr(args, "continuous_batching", 0):
            raise SystemExit("--admit-batch requires --continuous-batching")
        if ab < 1:
            raise SystemExit("--admit-batch must be >= 1")
    if getattr(args, "num_beams", 1) > 1:
        if getattr(args, "continuous_batching", 0):
            raise SystemExit("--num-beams is not supported with --continuous-batching")
        if getattr(args, "speculative", "off") != "off":
            raise SystemExit("--num-beams is not supported with --speculative")
        if getattr(args, "temperature", 0.0) > 0.0:
            raise SystemExit("--num-beams performs deterministic beam search; drop --temperature")


def load_generator(args, bundle, cfg, params, device="cuda"):
    """The one-at-a-time generator the flags ask for, on `device`: beam
    search, speculative decoding (with the draft checkpoint loaded onto the
    same device) or plain `Generator` (llark_tpu/inference/common.py:199-247)."""
    from llark_tpu_torch.generate import Generator

    if getattr(args, "num_beams", 1) > 1:
        from llark_tpu_torch.inference.beam import BeamSearchConfig, BeamSearcher

        return BeamSearcher(
            cfg, params, audio_patch_id=bundle.audio_patch_id,
            beam_cfg=BeamSearchConfig(num_beams=args.num_beams,
                                      max_new_tokens=args.max_new_tokens, stop_text="###"),
            max_cache_len=args.max_cache_len, device=device,
        )
    if getattr(args, "speculative", "off") != "off":
        from llark_tpu_torch.inference.speculative import SpeculativeGenerator

        if args.speculative == "draft" and not getattr(args, "draft_checkpoint_dir", None):
            raise SystemExit("--speculative draft requires --draft-checkpoint-dir")
        draft_cfg, draft_params = load_draft(args, device)
        return SpeculativeGenerator(
            cfg, params, audio_patch_id=bundle.audio_patch_id, gen_cfg=make_gen_cfg(args),
            max_cache_len=args.max_cache_len, draft_cfg=draft_cfg, draft_params=draft_params,
            gamma=args.gamma, allow_divergent=getattr(args, "allow_divergent_spec", False),
            device=device,
        )
    return Generator(
        cfg, params, audio_patch_id=bundle.audio_patch_id, gen_cfg=make_gen_cfg(args),
        max_cache_len=args.max_cache_len, device=device,
    )


def load_draft(args, device="cuda"):
    """(draft_cfg, draft_params) on `device` for --speculative draft, else
    (None, None) (llark_tpu/inference/common.py:250-261)."""
    if getattr(args, "speculative", "off") != "draft":
        return None, None
    if not getattr(args, "draft_checkpoint_dir", None):
        raise SystemExit("--speculative draft requires --draft-checkpoint-dir")
    from llark_tpu_torch.models.utils import load_pretrained_model

    draft_cfg, draft_params, _ = load_pretrained_model(
        args.draft_checkpoint_dir, getattr(args, "draft_ckpt_num", None), device
    )
    return draft_cfg, draft_params
