"""Weight-delta release tooling (vicuna-style) + checkpoint consolidation
(counterpart of llark_tpu/interop/delta.py).

Reference parity: m2t/llava/model/{make_delta,apply_delta,consolidate}.py.
The reference distributes finetuned weights as target-minus-base deltas so
the release carries no licensed base weights; `apply_delta` reconstructs
the finetune from a base checkpoint + the delta. Shape rules (reference
apply_delta.py:29-43):

  * keys absent from the base must be the multimodal projector
    (`model.mm_projector.{weight,bias}`) -- passed through unchanged;
  * equal-shape tensors add/subtract elementwise;
  * `model.embed_tokens.weight` / `lm_head.weight` may be LARGER in the
    target (audio special tokens resized the vocab) -- the base is
    added/subtracted into the top-left block only, leaving the new rows
    as absolute values in the delta.

Operates on HF-format state dicts of CPU tensors, so deltas interoperate
with reference checkpoints in both directions. 16-bit floats are widened
to fp32 first, as the JAX package's loader widens bf16 `.bin` tensors, so
a delta of bf16 checkpoints is not rounded back to bf16. `consolidate`
rewrites a sharded checkpoint directory as one single-file checkpoint
(consolidate.py:15-24).

    python -m llark_tpu_torch.interop.delta make --base-model-path BASE \
        --target-model-path TARGET --delta-path DELTA
    python -m llark_tpu_torch.interop.delta apply --base-model-path BASE \
        --target-model-path TARGET --delta-path DELTA
    python -m llark_tpu_torch.interop.delta consolidate --src SHARDED --dst ONE
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
from typing import Dict

import torch

from llark_tpu_torch.interop.hf import load_hf_state_dict

log = logging.getLogger(__name__)

StateDict = Dict[str, torch.Tensor]

_PROJECTOR_KEYS = ("model.mm_projector.weight", "model.mm_projector.bias")
_RESIZABLE_KEYS = ("model.embed_tokens.weight", "lm_head.weight")
_AUX_FILES = (
    "config.json",
    "generation_config.json",
    "tokenizer.model",
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
    "added_tokens.json",
)


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


def _combine(primary: StateDict, base: StateDict, sign: float) -> StateDict:
    out: StateDict = {}
    for name, param in primary.items():
        param = _wide(param)
        if name not in base:
            if name not in _PROJECTOR_KEYS:
                raise KeyError(f"{name} not in base model")
            out[name] = param
            continue
        bparam = _wide(base[name])
        if param.shape == bparam.shape:
            out[name] = param + sign * bparam
        else:
            if name not in _RESIZABLE_KEYS:
                raise ValueError(
                    f"{name} dimension mismatch: {tuple(param.shape)} vs {tuple(bparam.shape)}"
                )
            param = param.clone()
            param[: bparam.shape[0], : bparam.shape[1]] += sign * bparam
            out[name] = param
    return out


def make_delta_state(base: StateDict, target: StateDict) -> StateDict:
    """delta = target - base (projector kept absolute; resized-vocab rows
    beyond the base stay absolute)."""
    return _combine(target, base, sign=-1.0)


def apply_delta_state(base: StateDict, delta: StateDict) -> StateDict:
    """target = delta + base -- the inverse of make_delta_state (up to one
    fp32 rounding of each element)."""
    return _combine(delta, base, sign=+1.0)


def _save_state_dict(path: str, sd: StateDict, src_dir: str = "") -> None:
    """Write a single-file HF checkpoint; carry tokenizer/config sidecars
    over from src_dir when present (reference tools re-save the tokenizer)."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.contiguous() for k, v in sd.items()},
               os.path.join(path, "pytorch_model.bin"))
    if src_dir and os.path.isdir(src_dir):
        for name in _AUX_FILES:
            src = os.path.join(src_dir, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(path, name))


def make_delta(base_path: str, target_path: str, delta_path: str) -> None:
    log.info("loading base %s", base_path)
    base = load_hf_state_dict(base_path)
    log.info("loading target %s", target_path)
    target = load_hf_state_dict(target_path)
    _save_state_dict(delta_path, make_delta_state(base, target), target_path)
    log.info("wrote delta to %s", delta_path)


def apply_delta(base_path: str, target_path: str, delta_path: str) -> None:
    log.info("loading base %s", base_path)
    base = load_hf_state_dict(base_path)
    log.info("loading delta %s", delta_path)
    delta = load_hf_state_dict(delta_path)
    _save_state_dict(target_path, apply_delta_state(base, delta), delta_path)
    log.info("wrote target to %s", target_path)


def consolidate(src_path: str, dst_path: str) -> None:
    """Rewrite a (possibly sharded) checkpoint as a single weight file."""
    sd = load_hf_state_dict(src_path)
    _save_state_dict(dst_path, sd, src_path)
    # remove any stale shard index so loaders pick the single file
    for index_name in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
        stale = os.path.join(dst_path, index_name)
        if os.path.exists(stale):
            os.remove(stale)
    log.info("consolidated %s -> %s", src_path, dst_path)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    for cmd in ("make", "apply"):
        p = sub.add_parser(cmd)
        p.add_argument("--base-model-path", required=True)
        p.add_argument("--target-model-path", required=True)
        p.add_argument("--delta-path", required=True)
    p = sub.add_parser("consolidate")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    args = parser.parse_args(argv)
    if args.cmd == "make":
        make_delta(args.base_model_path, args.target_model_path, args.delta_path)
    elif args.cmd == "apply":
        apply_delta(args.base_model_path, args.target_model_path, args.delta_path)
    else:
        consolidate(args.src, args.dst)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
