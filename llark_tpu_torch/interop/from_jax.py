"""Parameters from the JAX package's layout.

`params_from_numpy` takes the JAX package's parameter tree with its leaves
as numpy arrays -- for example `jax.tree.map(np.asarray,
init_llark_params(cfg, key))`, layer weights stacked [L, ...] -- and
returns the port's parameters: the same nested dicts of torch tensors. A
weight-only quantized tree (`quantize_params_int8`, `..._int4_incremental`
of either package) carries over as it is: integer payloads keep int8 and
their scales fp32. The tree is plain dicts of numpy arrays, so nothing of the JAX package is
imported here.

`htsat_params_from_numpy` does the same for the CLAP encoder's HTSAT tree
(`llark_tpu/encoders/clap/htsat.py` `init_htsat_params`, or
`clap_params_from_hf` of either package): `stages` is a list of dicts,
each with its `blocks` (a list) and its `downsample` (None in the last).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.encoders.clap.htsat import HTSATConfig
from llark_tpu_torch.models.decoder import Params, torch_dtype
from llark_tpu_torch.models.quant import is_quantized, is_quantized_int4


def _to_tensor(x: Any, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)  # torch cannot read ml_dtypes' bfloat16
    if arr.dtype.kind in "iu":
        dtype = None  # a quantized payload keeps its integer dtype
    # a copy: arrays that come from JAX are read-only
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def _convert(tree: Mapping, device, dtype) -> Params:
    # the scale of a quantized leaf ({'q' | 'q4' | 'q4c', 'scale'}) stays fp32
    quantized = is_quantized(tree) or is_quantized_int4(tree)
    out: Params = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[name] = _convert(leaf, device, dtype)
        elif quantized and name == "scale":
            out[name] = _to_tensor(leaf, device, torch.float32)
        else:
            out[name] = _to_tensor(leaf, device, dtype)
    return out


def params_from_numpy(
    tree: Mapping,
    cfg: ModelConfig,
    device: Union[str, torch.device] = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """JAX-layout numpy tree -> port parameters on `device` (the GPU unless
    the caller asks for the CPU), in `dtype` (default: cfg.param_dtype)."""
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.param_dtype)
    embed = np.shape(tree["embed"])
    if embed != (cfg.vocab_size, cfg.hidden_size):
        raise ValueError(f"embed {embed} does not fit the config's vocab x hidden")
    for name, leaf in tree["layers"].items():
        parts = leaf.values() if isinstance(leaf, Mapping) else (leaf,)
        if any(np.shape(part)[:1] != (cfg.num_layers,) for part in parts):
            raise ValueError(
                f"layers/{name} is not a [num_layers={cfg.num_layers}, ...] stacked array"
            )
    return _convert(tree, dev, dtype)


def _htsat_tree(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _htsat_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_htsat_tree(v, device) for v in tree]
    if tree is None:
        return None
    return _to_tensor(tree, device, torch.float32)


def htsat_params_from_numpy(
    tree: Mapping,
    cfg: HTSATConfig,
    device: Union[str, torch.device] = "cuda",
) -> Params:
    """JAX-layout HTSAT tree (numpy leaves) -> the port's fp32 tensors on
    `device` (the GPU unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    stages = tree["stages"]
    if [len(s["blocks"]) for s in stages] != list(cfg.depths):
        raise ValueError(f"stages of {[len(s['blocks']) for s in stages]} blocks do not fit "
                         f"the config's depths {tuple(cfg.depths)}")
    pe = np.shape(tree["patch_embed"]["w"])
    if pe != (cfg.embed_dim, 1, cfg.patch_size, cfg.patch_size):
        raise ValueError(f"patch_embed/w {pe} does not fit the config's embed_dim and patch")
    return _htsat_tree(tree, dev)
