"""LoRA: low-rank adapters on the decoder's linear layers (counterpart of
llark_tpu/models/lora.py, with its names and file formats).

Parity target: the reference's bitsandbytes/PEFT path (m2t/train.py:79-106,
m2t/arguments.py:96-108; LoRA targets = every linear except the multimodal
projector and lm_head, m2t/llava/train/train.py:145-155; the non-LoRA
trainables -- projector and embeddings -- are saved separately,
m2t/train.py:264-273).

The factors live inside ``params["layers"]`` as stacked [L, in, r] /
[L, r, out] tensors beside the base weights, so the decoder's layer loop
slices them with the rest (`models/decoder.py` `_lora_dense`).
``merge_lora`` folds the deltas into a float base for serving with no
extra products. The adapter files (`adapter.npz`,
`non_lora_trainables.npz`) carry the JAX package's keys, so each package
reads the other's adapters.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from llark_tpu_torch.config import ModelConfig

Params = Dict[str, Any]

# every attention/MLP linear; excludes mm_projector and lm_head/embed
# (reference find_all_linear_names drops ["mm_projector", "lm_head"])
LORA_TARGETS: Tuple[str, ...] = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def lora_scale(cfg: ModelConfig) -> float:
    return float(cfg.lora_alpha) / float(max(cfg.lora_rank, 1))


def lora_keys(params: Params) -> List[str]:
    return sorted(k for k in params.get("layers", {}) if "_lora_" in k)


def init_lora_params(cfg: ModelConfig, generator: torch.Generator, params: Params) -> Params:
    """Return params with zero-delta LoRA factors added for each target
    present in the layer tree: A ~ N(0, 1/in) drawn from `generator` on its
    device, B = 0, both in cfg.param_dtype, so training starts from the base
    model exactly. The numbers of A differ from the JAX package's, since
    the two frameworks' generators do."""
    if cfg.lora_rank <= 0:
        raise ValueError("cfg.lora_rank must be > 0 to add LoRA params")
    if cfg.moe_num_experts > 0:
        logging.getLogger(__name__).warning(
            "MoE model: LoRA factors are added to the attention projections "
            "only -- the expert FFN stacks (moe_w_*) are not LoRA targets "
            "and stay frozen under a frozen-base run"
        )
    pdt = getattr(torch, cfg.param_dtype)
    r = cfg.lora_rank
    layers = dict(params["layers"])
    for name in (t for t in LORA_TARGETS if t in layers):
        L, fan_in, fan_out = layers[name].shape  # [L, in, out]
        a = torch.randn((L, fan_in, r), generator=generator, device=generator.device,
                        dtype=torch.float32)
        layers[f"{name}_lora_a"] = a.div_(math.sqrt(fan_in)).to(pdt)
        layers[f"{name}_lora_b"] = torch.zeros((L, r, fan_out), dtype=pdt, device=generator.device)
    out = dict(params)
    out["layers"] = layers
    return out


def merge_lora(cfg: ModelConfig, params: Params) -> Params:
    """Fold LoRA deltas into the base weights and drop the factors (the
    serving path with no adapter products). The delta is computed in fp32
    and the sum cast back to the weight's dtype."""
    scale = lora_scale(cfg)
    layers = dict(params["layers"])
    for name in LORA_TARGETS:
        a = layers.pop(f"{name}_lora_a", None)
        b = layers.pop(f"{name}_lora_b", None)
        if a is None or b is None:
            continue
        w = layers[name]
        delta = torch.bmm(a.float(), b.float()) * scale
        layers[name] = (w.float() + delta).to(w.dtype)
    out = dict(params)
    out["layers"] = layers
    return out


def strip_lora(params: Params) -> Params:
    """Base params with LoRA factors removed (NOT merged)."""
    out = dict(params)
    out["layers"] = {k: v for k, v in params["layers"].items() if "_lora_" not in k}
    return out


# ---------------------------------------------------------------------------
# Adapter export / import (reference: adapter + non_lora_trainables.bin,
# m2t/train.py:264-273)
# ---------------------------------------------------------------------------


def lora_layer_specs(cfg: ModelConfig, base_layer_specs: Dict[str, Any]) -> Dict[str, Any]:
    """Partition specs of the stacked LoRA factors, derived from the base
    weight's (llark_tpu/models/lora.py:103-118): A takes the input-dim
    split, B the output-dim split; the rank dim is whole (r is small)."""
    from llark_tpu_torch.parallel.mesh import P

    specs: Dict[str, Any] = {}
    for name in LORA_TARGETS:
        base = base_layer_specs.get(name)
        if base is None:
            continue
        _, in_axis, out_axis = tuple(base) + (None,) * (3 - len(tuple(base)))
        specs[f"{name}_lora_a"] = P(None, in_axis, None)
        specs[f"{name}_lora_b"] = P(None, None, out_axis)
    return specs


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy; bfloat16, which numpy lacks, as float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _flatten(tree: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "."))
        else:
            flat[key] = _host(v)
    return flat


def save_lora_adapter(
    path: str, cfg: ModelConfig, params: Params, extra_non_lora: Optional[Params] = None
) -> str:
    """Write `adapter.npz` (LoRA factors) and `non_lora_trainables.npz`
    (projector + any extra trainables) under `path`. Returns the dir."""
    os.makedirs(path, exist_ok=True)
    adapter = {f"layers.{k}": _host(v) for k, v in params["layers"].items() if "_lora_" in k}
    adapter["__lora_rank__"] = np.asarray(cfg.lora_rank)
    adapter["__lora_alpha__"] = np.asarray(cfg.lora_alpha)
    np.savez(os.path.join(path, "adapter.npz"), **adapter)

    non_lora: Dict[str, np.ndarray] = {}
    if "mm_projector" in params:
        non_lora.update(_flatten({"mm_projector": params["mm_projector"]}))
    if extra_non_lora:
        non_lora.update(_flatten(extra_non_lora))
    np.savez(os.path.join(path, "non_lora_trainables.npz"), **non_lora)
    return path


def load_lora_adapter(path: str, params: Params) -> Tuple[Params, Dict[str, int]]:
    """Apply a saved adapter onto a base param tree. Returns (params, meta).
    Each loaded tensor goes to the device of the tree's embedding table, in
    the dtype of the leaf it replaces (cfg.param_dtype for new factors, as
    the embedding table holds)."""
    device, pdt = params["embed"].device, params["embed"].dtype
    data = np.load(os.path.join(path, "adapter.npz"))
    meta = {
        "lora_rank": int(data["__lora_rank__"]),
        "lora_alpha": int(data["__lora_alpha__"]),
    }

    def put(arr: np.ndarray, like) -> torch.Tensor:
        dtype = like.dtype if isinstance(like, torch.Tensor) else pdt
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=dtype)

    layers = dict(params["layers"])
    for k in data.files:
        if k.startswith("layers."):
            name = k[len("layers."):]
            layers[name] = put(data[k], layers.get(name))
    out = dict(params)
    out["layers"] = layers

    nl_path = os.path.join(path, "non_lora_trainables.npz")
    if os.path.exists(nl_path):
        nl = np.load(nl_path)
        for k in nl.files:
            parts = k.split(".")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = put(nl[k], node.get(parts[-1]))
    return out, meta
