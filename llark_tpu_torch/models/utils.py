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
    """Write model_config.json next to the checkpoints. The port's only
    tokenizer is the word-level one (HF tokenizers come with checkpoint
    import), written in the JAX package's "word" format."""
    os.makedirs(output_dir, exist_ok=True)
    payload = {
        "model_config": dataclasses.asdict(cfg),
        "tokenizer": {"type": "word", **bundle.tokenizer.to_dict()},
    }
    with open(os.path.join(output_dir, "model_config.json"), "w") as f:
        json.dump(payload, f, indent=2)


def load_model_metadata(checkpoint_dir: str) -> Tuple[ModelConfig, TokenizerBundle]:
    """(ModelConfig, TokenizerBundle) of a run directory. Fields of a
    configuration written by the JAX package that the port's ModelConfig
    does not have are left out; the decoder raises on the features they
    describe (LoRA factors, MoE) when it meets their weights."""
    with open(os.path.join(checkpoint_dir, "model_config.json")) as f:
        payload = json.load(f)
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in payload["model_config"].items() if k in known})
    tok_meta = payload["tokenizer"]
    if tok_meta["type"] != "word":
        raise NotImplementedError(
            "HF tokenizers come with the checkpoint-import slice of the port"
        )
    tok = WordTokenizer.from_dict(tok_meta)
    return cfg, TokenizerBundle.from_tokenizer(tok, tok_meta["model_max_length"])


def load_pretrained_model(
    checkpoint_dir: str,
    ckpt_num: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[ModelConfig, Dict[str, Any], TokenizerBundle]:
    """(cfg, params, tokenizer bundle) for inference from a run directory
    of the port's `train()`: model_config.json and checkpoint-N/state.pt
    (the latest N unless `ckpt_num` is given). Parameters come to `device`
    in `cfg.param_dtype`; the optimizer state is not read into them.
    Counterpart of llark_tpu/models/utils.py:63-89, which reads Orbax
    directories instead."""
    from llark_tpu_torch.models.decoder import torch_dtype
    from llark_tpu_torch.train.checkpoint import CheckpointManager

    if not os.path.exists(os.path.join(checkpoint_dir, "model_config.json")):
        raise NotImplementedError(
            f"{checkpoint_dir} has no model_config.json: HF checkpoint directories "
            "come with the checkpoint-import slice of the port (ROADMAP.md Queue A "
            "item 6)"
        )
    cfg, bundle = load_model_metadata(checkpoint_dir)
    dev = resolve_device(device)
    mgr = CheckpointManager(checkpoint_dir)
    step = ckpt_num if ckpt_num is not None else mgr.latest_step()
    path = os.path.join(mgr.directory, f"checkpoint-{step}", "state.pt")
    if step is None or not os.path.exists(path):
        raise NotImplementedError(
            f"{checkpoint_dir} holds no checkpoint-N/state.pt of the port's train(): "
            "Orbax run directories of the JAX package come with the checkpoint-"
            "import slice of the port (ROADMAP.md Queue A item 6)"
        )
    saved = torch.load(path, map_location="cpu", weights_only=True)["params"]
    pdt = torch_dtype(cfg.param_dtype)

    def put(tree):
        return {k: put(v) if isinstance(v, dict) else v.to(device=dev, dtype=pdt)
                for k, v in tree.items()}

    params = put(saved)
    want = (cfg.vocab_size, cfg.hidden_size)
    if tuple(params["embed"].shape) != want or params["layers"]["wq"].shape[0] != cfg.num_layers:
        raise ValueError(f"checkpoint-{step} does not hold the model of {checkpoint_dir}'s config")
    return cfg, params, bundle
