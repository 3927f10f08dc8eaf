"""Self-describing run directories: `model_config.json` beside the
checkpoints (counterpart of llark_tpu/models/utils.py).

The file holds the model configuration and the tokenizer, so a trained
directory rebuilds its architecture and vocabulary without the flags it
was trained with; `load_pretrained_model` reads the port's own run
directories (`checkpoint-N/state.pt`, as `train()` writes them).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.tokenization import TokenizerBundle, WordTokenizer


def save_model_metadata(output_dir: str, cfg: ModelConfig, bundle: TokenizerBundle) -> None:
    """Write model_config.json next to the checkpoints, in the JAX
    package's format: a word-level tokenizer whole ("word"), an HF one
    by its directory ("hf")."""
    os.makedirs(output_dir, exist_ok=True)
    tok = bundle.tokenizer
    if isinstance(tok, WordTokenizer):
        tok_meta: Dict[str, Any] = {"type": "word", **tok.to_dict()}
    else:
        tok_meta = {
            "type": "hf",
            "path": getattr(tok, "name_or_path", None),
            "model_max_length": bundle.model_max_length,
        }
    payload = {
        "model_config": dataclasses.asdict(cfg),
        "tokenizer": tok_meta,
    }
    with open(os.path.join(output_dir, "model_config.json"), "w") as f:
        json.dump(payload, f, indent=2)


def load_model_metadata(checkpoint_dir: str) -> Tuple[ModelConfig, TokenizerBundle]:
    """(ModelConfig, TokenizerBundle) of a run directory. Fields of a
    configuration written by the JAX package that the port's ModelConfig
    does not have are left out; the decoder raises on the feature they
    describe (MoE) when it meets its weights. The LoRA fields (`lora_rank`,
    `lora_alpha`, `lora_dropout`) round-trip. An "hf" tokenizer loads
    through `transformers`, imported only here."""
    with open(os.path.join(checkpoint_dir, "model_config.json")) as f:
        payload = json.load(f)
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in payload["model_config"].items() if k in known})
    tok_meta = payload["tokenizer"]
    if tok_meta["type"] == "word":
        tok = WordTokenizer.from_dict(tok_meta)
    else:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(tok_meta["path"], use_fast=False)
    return cfg, TokenizerBundle.from_tokenizer(tok, tok_meta["model_max_length"])


class NotARunDirectory(FileNotFoundError, NotImplementedError):
    """A directory without model_config.json: missing, or an HF checkpoint
    directory. A FileNotFoundError, as the reference raises there
    (llark_tpu/models/utils.py:47-48); a NotImplementedError too, since the
    port reads only its own train()'s run directories and names the route."""


def load_pretrained_model(
    checkpoint_dir: str,
    ckpt_num: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[ModelConfig, Dict[str, Any], TokenizerBundle]:
    """(cfg, params, tokenizer bundle) for inference from a run directory
    of the port's `train()`: model_config.json and checkpoint-N/state.pt
    (the latest N unless `ckpt_num` is given). Parameters come to `device`
    in `cfg.param_dtype`, the leaves of a weight-only quantized tree in their
    own dtypes; the optimizer state is not read into them. A LoRA run's
    factors (`layers/*_lora_a`, `*_lora_b`) come with the rest and serve
    unmerged (`models/decoder.py` `_lora_dense`; `models/lora.py`
    `merge_lora` folds them into a float base).
    Counterpart of llark_tpu/models/utils.py:63-89, which reads Orbax
    directories instead."""
    from llark_tpu_torch.models.decoder import torch_dtype
    from llark_tpu_torch.models.quant import is_quantized, is_quantized_int4
    from llark_tpu_torch.train.checkpoint import CheckpointManager

    if not os.path.exists(os.path.join(checkpoint_dir, "model_config.json")):
        raise NotARunDirectory(
            f"{checkpoint_dir} has no model_config.json: this reads run directories of "
            "the port's train(); import an HF checkpoint directory through train() "
            "(model_name_or_path=<the directory>) and serve its output_dir"
        )
    cfg, bundle = load_model_metadata(checkpoint_dir)
    dev = resolve_device(device)
    mgr = CheckpointManager(checkpoint_dir)
    step = ckpt_num if ckpt_num is not None else mgr.latest_step()
    path = os.path.join(mgr.directory, f"checkpoint-{step}", "state.pt")
    if step is None or not os.path.exists(path):
        orbax_steps = [n for n in os.listdir(checkpoint_dir)
                       if n.isdigit() and os.path.isdir(os.path.join(checkpoint_dir, n))]
        if not orbax_steps:
            # as the reference raises (llark_tpu/models/utils.py:74-75)
            raise FileNotFoundError(
                f"no checkpoints in {checkpoint_dir}" if step is None
                else f"no checkpoint-{step} in {checkpoint_dir}")
        raise NotImplementedError(
            f"{checkpoint_dir} holds no checkpoint-N/state.pt of the port's train(): "
            "an Orbax run directory of the JAX package needs JAX to read, which the "
            "port does not import (a divergence kept on purpose, ROADMAP.md Queue C); "
            "export it with the JAX package's save_hf_checkpoint and import that "
            "directory through train()"
        )
    saved = torch.load(path, map_location="cpu", weights_only=True)["params"]
    pdt = torch_dtype(cfg.param_dtype)

    def put(tree):
        # a quantized leaf keeps its own dtypes: an int8 payload, fp32 scales
        quantized = is_quantized(tree) or is_quantized_int4(tree)
        return {k: put(v) if isinstance(v, dict)
                else v.to(device=dev, dtype=None if quantized else pdt)
                for k, v in tree.items()}

    params = put(saved)
    want = (cfg.vocab_size, cfg.hidden_size)
    n_layers = params["layers"]["attn_norm_scale"].shape[0]  # never quantized
    if tuple(params["embed"].shape) != want or n_layers != cfg.num_layers:
        raise ValueError(f"checkpoint-{step} does not hold the model of {checkpoint_dir}'s config")
    return cfg, params, bundle
