"""Int8 and int4 weight-only quantization for serving.

Counterpart of llark_tpu/models/quant.py, with the same names and tree
layouts, so a tree quantized by either package loads into the other
(`interop/from_jax.py`). Decode reads every weight once per step and is
bound by those bytes: int8 halves them against bf16, int4 quarters them.

int8: symmetric per-output-channel. For W[in, out] with
scale s[out] = max|W[:, out]| / 127,

    y = (x @ W_q) * s      (exact rearrangement: the scale depends only on
                            the output channel, so it commutes out of the
                            contraction)

int4: symmetric group-wise along the contraction (scale[in // group, out]),
two nibbles per int8 byte, in one of two layouts: "rows" packs original
rows 2r, 2r + 1 into packed row r (the layout of the int4 kernel), "cols"
packs columns 2d, 2d + 1 into packed column d.

Dispatch of the products (`quantized_dense`, `quantized_dense_int4`): a 2-D
leaf inside a kernel's contract (`ops/int8_matmul.py` `int8_kernel_takes`,
`ops/int4_matmul.py` `int4_kernel_takes`) goes to the kernel's wrapper,
which launches the CUDA kernel for CUDA tensors (or raises) and runs its
plain version for CPU tensors. What lies outside the contract (a stacked
leaf, the cols layout, a scale group that is not a multiple of 16 rows)
takes the same plain expression the JAX package uses there. The contracts
are about shape alone: the kernels compute in bfloat16, and another compute
dtype on the card with a leaf inside a contract raises. There is no
environment switch.
The quantized products carry no gradient in this slice of the port.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.ops.int4_matmul import (
    dequantize_int4,
    int4_kernel_takes,
    int4_matmul,
    scale_groups,
    split_nibbles,
)
from llark_tpu_torch.ops.int4_matmul import unpack_int4 as _unpack_int4  # noqa: F401
from llark_tpu_torch.ops.int8_matmul import int8_kernel_takes, matmul_f32, quantized_dense_kernel

Params = Dict[str, Any]

# weights worth quantizing: the large 2D projections; for MoE models the
# expert FFN stacks [L, E, in, out] are the bulk of the params and are
# quantized too (the router stays fp32)
QUANT_TARGETS = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "moe_w_gate", "moe_w_up", "moe_w_down",
)


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., in, out] -> {'q': int8, 'scale': f32[..., 1, out]}.
    torch.round, like jnp.round, rounds half to even."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)  # [..., 1, out]
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale).clamp_(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_weight(wq: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    return (wq["q"].float() * wq["scale"]).to(dtype)


def is_quantized(w: Any) -> bool:
    return isinstance(w, Mapping) and "q" in w and "scale" in w


def quantize_params_int8(cfg: ModelConfig, params: Params) -> Params:
    """Quantize the decoder's large projections (and lm_head) to int8.
    Embeddings, norms, biases, the projector, and any LoRA factors stay in
    their original dtype."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in QUANT_TARGETS:
        if name in layers and "_lora_" not in name:
            layers[name] = quantize_weight(layers[name])
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"])
    return out


# ---------------------------------------------------------------------------
# int4 (group-wise, packed two nibbles per int8)
# ---------------------------------------------------------------------------


def _quantize_groups_int4(w: torch.Tensor, group: int):
    """[..., in, out] -> (int8 values in [-7, 7] [..., in, out], f32 scales
    [..., in/group, out]): symmetric, one scale per `group` rows."""
    *lead, fan_in, fan_out = w.shape
    wf = w.float().reshape(*lead, fan_in // group, group, fan_out)
    amax = wf.abs().amax(dim=-2, keepdim=True)  # [..., G, 1, out]
    scale = amax.clamp_min(1e-8) / 7.0
    q = torch.round(wf / scale).clamp_(-7, 7).to(torch.int8)
    return q.reshape(*lead, fan_in, fan_out), scale[..., 0, :]


def _pack_nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int8 tensors of 4-bit values -> one int8 tensor, `lo` in the low
    nibble (unsigned bytes, so the shift of the high nibble wraps cleanly)."""
    lo = (lo & 0x0F).view(torch.uint8)
    hi = (hi & 0x0F).view(torch.uint8)
    return (lo | (hi << 4)).view(torch.int8)


def quantize_weight_int4(w: torch.Tensor, group: int = 128) -> Dict[str, torch.Tensor]:
    """[..., in, out] -> {'q4': int8 [..., in/2, out] (two nibbles),
    'scale': f32 [..., in/group, out]}: symmetric group-wise int4, pair
    layout (packed row r = original rows 2r in the low nibble, 2r + 1 in
    the high one), which is what one register of the int4 kernel's B
    operand holds."""
    fan_in = w.shape[-2]
    if fan_in % group or fan_in % 2:
        raise ValueError(f"fan_in {fan_in} must divide group {group} and 2")
    q, scale = _quantize_groups_int4(w, group)
    return {"q4": _pack_nibbles(q[..., 0::2, :], q[..., 1::2, :]), "scale": scale}


def dequantize_weight_int4(wq: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    """Nibble times scale, both in `dtype` (the compute dtype, not fp32): in
    bf16 the scaled weight is rounded to bf16."""
    return dequantize_int4(wq["q4"], wq["scale"], dtype)


def is_quantized_int4(w: Any) -> bool:
    return isinstance(w, Mapping) and ("q4" in w or "q4c" in w) and "scale" in w


def quantize_weight_int4_cols(w: torch.Tensor, group: int = 128) -> Dict[str, torch.Tensor]:
    """[..., in, out] -> {'q4c': int8 [..., in, out/2], 'scale': f32
    [..., in/group, out]}: the numerics of quantize_weight_int4 with the
    nibbles packed along the out (minor) axis: byte [h, d] = column 2d in
    the low nibble, column 2d + 1 in the high one."""
    fan_in, fan_out = w.shape[-2:]
    if fan_in % group or fan_out % 2:
        raise ValueError(f"fan_in {fan_in} must divide group {group}; fan_out even")
    q, scale = _quantize_groups_int4(w, group)
    return {"q4c": _pack_nibbles(q[..., :, 0::2], q[..., :, 1::2]), "scale": scale}


def _unpack_int4_cols(q4c: torch.Tensor) -> torch.Tensor:
    """int8 [..., in, out/2] -> int8 [..., in, out], sign-extended nibbles,
    low nibble first. torch has no int4 dtype to bitcast to: shifts."""
    return torch.stack(split_nibbles(q4c), dim=-1).reshape(*q4c.shape[:-1], q4c.shape[-1] * 2)


def dequantize_weight_int4_cols(wq: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    return scale_groups(_unpack_int4_cols(wq["q4c"]), wq["scale"], dtype)


def _dense_int4_cols(x: torch.Tensor, wq: Dict[str, torch.Tensor], b, dtype) -> torch.Tensor:
    """y = x @ dequant(q4c) with the scale applied to the per-group partial
    sums, in fp32, not to the weights: y[m, d] = sum_g s[g, d] *
    (x_g @ w4_g)[m, d] (llark_tpu/models/quant.py:163-190)."""
    q4c, scale = wq["q4c"], wq["scale"]
    n_groups = scale.shape[-2]
    group = q4c.shape[-2] // n_groups
    w4 = _unpack_int4_cols(q4c)  # [in, out]
    fan_out = w4.shape[-1]
    lead = x.shape[:-1]
    xg = x.reshape(-1, n_groups, group).to(dtype).transpose(0, 1)  # [G, M, group]
    wg = w4.reshape(n_groups, group, fan_out).to(dtype)
    partial = matmul_f32(xg.contiguous(), wg)  # [G, M, out] fp32
    y = torch.einsum("gmd,gd->md", partial, scale.float()).to(dtype)
    y = y.reshape(*lead, fan_out)
    if b is not None:
        y = y + b.to(dtype)
    return y


def quantized_dense_int4(
    x: torch.Tensor, wq: Dict[str, torch.Tensor], b: Optional[torch.Tensor], dtype: torch.dtype
) -> torch.Tensor:
    """y = x @ dequant(q4) [+ b] (llark_tpu/models/quant.py:193-237). The
    cols layout runs `_dense_int4_cols`; a rows-layout leaf inside
    `int4_kernel_takes` goes through `int4_matmul` (the CUDA kernel on the
    card, its plain version on the CPU); any other rows-layout leaf is
    dequantized in `dtype` and multiplied with an fp32 accumulator."""
    if "q4c" in wq:
        return _dense_int4_cols(x, wq, b, dtype)
    q4, scale = wq["q4"], wq["scale"]
    if int4_kernel_takes(q4, scale):
        fan_in = q4.shape[0] * 2
        lead = x.shape[:-1]
        xm = x.reshape(-1, fan_in).to(dtype)
        y = int4_matmul(xm, q4, scale, group=fan_in // scale.shape[0])
        y = y.reshape(*lead, q4.shape[1])
    else:
        y = matmul_f32(x.to(dtype), dequantize_weight_int4(wq, dtype)).to(dtype)
    if b is not None:
        y = y + b.to(dtype)
    return y


def _quantize_leaf(w: torch.Tensor, quantize) -> Dict[str, torch.Tensor]:
    """Quantize one leaf; a stacked [L, ...] leaf (also [L, E, in, out] MoE
    experts) layer by layer, so the fp32 intermediates are 1/L-sized."""
    if w.dim() < 3:
        return quantize(w)
    per_layer = [quantize(w[l]) for l in range(w.shape[0])]
    return {key: torch.stack([p[key] for p in per_layer]) for key in per_layer[0]}


def quantize_params_int4_incremental(
    cfg: ModelConfig, params: Params, group: int = 128, layout: str = "cols"
) -> Params:
    """int4 counterpart of quantize_params_int8_incremental (takes ownership
    of `params`). layout="cols" (default) packs nibbles along the out axis
    for `_dense_int4_cols`; "rows" packs along the contraction for the int4
    kernel."""
    def q_one(w):
        if layout == "cols":
            return quantize_weight_int4_cols(w, group)
        return quantize_weight_int4(w, group)

    layers = params["layers"]
    for name in QUANT_TARGETS:
        if name in layers and "_lora_" not in name:
            layers[name] = _quantize_leaf(layers.pop(name), q_one)
    if "lm_head" in params:
        w = params.pop("lm_head")
        if layout != "cols" and w.shape[-1] % 128:
            # rows layout and a fan_out that does not tile (vocab 32004): as
            # in the JAX package the head goes int8, whose product needs no
            # dequantized group copy
            params["lm_head"] = quantize_weight(w)
        else:
            params["lm_head"] = _quantize_leaf(w, q_one)
    return params


def quantize_params_int8_incremental(cfg: ModelConfig, params: Params) -> Params:
    """Like quantize_params_int8, but the source leaf is dropped as each one
    converts, layer by layer for a stacked leaf: peak device memory is the
    params plus one leaf's int8 copy and one layer's fp32 intermediates,
    not the source and its copy together. TAKES OWNERSHIP: `params` is
    mutated and must not be used afterwards."""
    layers = params["layers"]  # mutate in place so old leaves free eagerly
    for name in QUANT_TARGETS:
        if name in layers and "_lora_" not in name:
            layers[name] = _quantize_leaf(layers.pop(name), quantize_weight)
    if "lm_head" in params:
        params["lm_head"] = quantize_weight(params.pop("lm_head"))
    return params


def quantized_dense(
    x: torch.Tensor, wq: Dict[str, torch.Tensor], b: Optional[torch.Tensor], dtype: torch.dtype
) -> torch.Tensor:
    """y = (x @ W_q) * scale [+ b] (llark_tpu/models/quant.py:302-336). A
    2-D leaf inside `int8_kernel_takes` goes through `int8_matmul` (the CUDA
    kernel on the card, its plain version on the CPU); any other leaf runs
    the plain expression: the int8 weight converted to `dtype`, an fp32
    accumulator, the fp32 scale, one rounding."""
    q = wq["q"]
    if int8_kernel_takes(q):
        return quantized_dense_kernel(x, wq, b, dtype)
    y = matmul_f32(x.to(dtype), q.to(dtype))
    # per-layer-stacked weights carry scale [..., 1, out]; take the out row
    scale = wq["scale"]
    scale = scale.reshape(scale.shape[:-2] + (scale.shape[-1],))  # [..., out]
    y = (y * scale.float()).to(dtype)
    if b is not None:
        y = y + b.to(dtype)
    return y
