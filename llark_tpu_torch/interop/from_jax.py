"""Parameters from the JAX package's layout.

`params_from_numpy` takes the JAX package's parameter tree with its leaves
as numpy arrays -- for example `jax.tree.map(np.asarray,
init_llark_params(cfg, key))`, layer weights stacked [L, ...] -- and
returns the port's parameters: the same nested dicts of torch tensors. A
weight-only quantized tree (`quantize_params_int8`, `..._int4_incremental`
of either package) carries over as it is: integer payloads keep int8 and
their scales fp32. A MoE tree's `moe_router` [L, h, E] and expert stacks
`moe_w_{gate,up,down}` [L, E, in, out] (quantized: payloads [L, E, ...],
scales [L, E, 1 or G, out]) carry over the same way. The tree is plain
dicts of numpy arrays, so nothing of the JAX package is imported here.

`htsat_params_from_numpy` does the same for the CLAP encoder's HTSAT tree
(`llark_tpu/encoders/clap/htsat.py` `init_htsat_params`, or
`clap_params_from_hf` of either package): `stages` is a list of dicts,
each with its `blocks` (a list) and its `downsample` (None in the last).

`jukebox_params_from_numpy` takes the Jukebox encoder's two trees
(`llark_tpu/encoders/jukebox/vqvae.py` `init_vqvae_params`, `prior.py`
`init_prior_params`, or `import_torch`'s of either package): the VQ-VAE's
`levels` (a list of dicts with `stages`, each with its `res` list) and
`codebooks`, and the prior's `x_emb`, `pos_emb` and `layers` stacked
[depth // 3, 3, ...].

`annotator_params_from_numpy` takes the neural annotators' flat tree
(`llark_tpu/audio/neural.py` `load_params`: "beat/conv0_w" [k, c_in, c_out],
"beat/head_w" [in, out], ...) and returns the state dicts of the port's
`BeatNet` and `KeyNet`: a convolution as `Conv1d`'s [c_out, c_in, k], a
dense weight as `Linear`'s [out, in].
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.encoders.clap.htsat import HTSATConfig
from llark_tpu_torch.encoders.jukebox.config import JukeboxPriorConfig
from llark_tpu_torch.encoders.jukebox.prior import _layer_param_shapes
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
    router = tree["layers"].get("moe_router")
    experts = 0 if router is None else np.shape(router)[-1]
    if experts != cfg.moe_num_experts:
        raise ValueError(f"the tree has {experts} experts, the config "
                         f"moe_num_experts={cfg.moe_num_experts}")
    return _convert(tree, dev, dtype)


def _float_tree(tree: Any, device: torch.device, dtype: torch.dtype = torch.float32) -> Any:
    """Nested dicts / lists of numpy leaves -> the same of `dtype` tensors."""
    if isinstance(tree, Mapping):
        return {k: _float_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_float_tree(v, device, dtype) for v in tree]
    if tree is None:
        return None
    return _to_tensor(tree, device, dtype)


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
    return _float_tree(tree, dev)


def _shape_error(where: str, got, want) -> ValueError:
    return ValueError(f"{where} is {tuple(got)}, expected {tuple(want)}")


def _check_vq_tree(tree: Mapping) -> None:
    levels, codebooks = tree["levels"], tree["codebooks"]
    if len(levels) != len(codebooks):
        raise ValueError(f"{len(levels)} levels but {len(codebooks)} codebooks")
    channels = 1  # the raw audio
    for l, level in enumerate(levels):
        for s, stage in enumerate(level["stages"]):
            where = f"levels/{l}/stages/{s}"
            down = np.shape(stage["down_w"])
            if len(down) != 3 or down[1] != channels:
                raise _shape_error(f"{where}/down_w", down, ("C_out", channels, "K"))
            width = down[0]
            if np.shape(stage["down_b"]) != (width,):
                raise _shape_error(f"{where}/down_b", np.shape(stage["down_b"]), (width,))
            for d, res in enumerate(stage["res"]):
                inner = np.shape(res["w1"])[0]
                for name, want in (("w1", (inner, width, 3)), ("b1", (inner,)),
                                   ("w2", (width, inner, 1)), ("b2", (width,))):
                    if np.shape(res[name]) != want:
                        raise _shape_error(f"{where}/res/{d}/{name}", np.shape(res[name]), want)
            channels = width
        proj = np.shape(level["proj_w"])
        if len(proj) != 3 or proj[1:] != (channels, 3):
            raise _shape_error(f"levels/{l}/proj_w", proj, ("emb", channels, 3))
        channels = proj[0]
        book = np.shape(codebooks[l])
        if len(book) != 2 or book[1] != channels:
            raise _shape_error(f"codebooks/{l}", book, ("bins", channels))


def _check_prior_tree(tree: Mapping) -> None:
    bins, width = np.shape(tree["x_emb"])
    n_ctx = np.shape(tree["pos_emb"])[0]
    if np.shape(tree["pos_emb"]) != (n_ctx, width):
        raise _shape_error("pos_emb", np.shape(tree["pos_emb"]), (n_ctx, width))
    layers = tree["layers"]
    aw3, mw = np.shape(layers["attn_w"])[-1], np.shape(layers["fc_w"])[-1]
    cycles = np.shape(layers["ln0_g"])[0]
    cfg = JukeboxPriorConfig(width=width, m_attn=(aw3 // 3) / width, m_mlp=mw / width)
    want = _layer_param_shapes(cfg)
    if set(layers) != set(want):
        raise ValueError(f"layers hold {sorted(layers)}, expected {sorted(want)}")
    for name, shape in want.items():
        if np.shape(layers[name]) != (cycles, 3) + shape:
            raise _shape_error(f"layers/{name}", np.shape(layers[name]), (cycles, 3) + shape)


def jukebox_params_from_numpy(
    vq_tree: Mapping,
    prior_tree: Mapping,
    device: Union[str, torch.device] = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> tuple:
    """JAX-layout Jukebox trees (numpy leaves) -> the port's (vq_params,
    prior_params) on `device` (the GPU unless the caller asks for the CPU):
    the VQ-VAE in fp32, the prior in `dtype` (default fp32; the encoder
    computes in its config's dtype either way)."""
    dev = resolve_device(device)
    _check_vq_tree(vq_tree)
    _check_prior_tree(prior_tree)
    return (_float_tree(vq_tree, dev), _float_tree(prior_tree, dev, dtype or torch.float32))


def annotator_params_from_numpy(
    tree: Mapping,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Dict[str, torch.Tensor]]:
    """The neural annotators' numpy tree -> {"beat": state dict, "key":
    state dict} of fp32 tensors on `device` (the GPU unless the caller asks
    for the CPU), in the layout of `audio.neural.BeatNet` / `KeyNet`."""
    dev = resolve_device(device)
    out: Dict[str, Dict[str, torch.Tensor]] = {"beat": {}, "key": {}}
    for name, leaf in tree.items():
        net, param = name.split("/")
        layer, kind = param.rsplit("_", 1)  # "conv0", "w"
        arr = np.asarray(leaf, np.float32)
        if kind == "w":
            # [k, c_in, c_out] -> [c_out, c_in, k]; [in, out] -> [out, in]
            arr = arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T
        module = f"convs.{layer[len('conv'):]}" if layer.startswith("conv") else layer
        out[net][f"{module}.{'weight' if kind == 'w' else 'bias'}"] = _to_tensor(
            arr, dev, torch.float32)
    return out
