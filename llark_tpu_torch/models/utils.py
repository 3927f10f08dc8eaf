"""Self-describing run directories: `model_config.json` beside the
checkpoints (counterpart of llark_tpu/models/utils.py:25-60).

The file holds the model configuration and the tokenizer, so a trained
directory rebuilds its architecture and vocabulary without the flags it
was trained with.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

from llark_tpu_torch.config import ModelConfig
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
