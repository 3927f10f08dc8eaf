"""Parameters from the JAX package's layout.

`params_from_numpy` takes the JAX package's parameter tree with its leaves
as numpy arrays -- for example `jax.tree.map(np.asarray,
init_llark_params(cfg, key))`, layer weights stacked [L, ...] -- and
returns the port's parameters: the same nested dicts of torch tensors.
The tree is plain dicts of numpy arrays, so nothing of the JAX package is
imported here.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.models.decoder import Params, torch_dtype


def _to_tensor(x: Any, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)  # torch cannot read ml_dtypes' bfloat16
    # a copy: arrays that come from JAX are read-only
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def _convert(tree: Mapping, device, dtype) -> Params:
    out: Params = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[name] = _convert(leaf, device, dtype)
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
        if isinstance(leaf, Mapping) or np.shape(leaf)[0] != cfg.num_layers:
            raise ValueError(
                f"layers/{name} is not a [num_layers={cfg.num_layers}, ...] stacked array"
            )
    return _convert(tree, dev, dtype)
