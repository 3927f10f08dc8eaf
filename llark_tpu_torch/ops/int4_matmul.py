"""Int4 weight-only matmul: unpack the nibbles inside the product.

Counterpart of llark_tpu/ops/int4_matmul.py. `int4_matmul` wraps the
hand-written CUDA kernel `csrc/int4_matmul.cu`, which replaces the TPU
kernel `_int4_matmul_kernel`: only the packed bytes (and the group scales)
cross device memory; nibbles are sign-extended and turned into bf16 in
registers on the way into the tensor cores (wgmma). bf16 and fp32
activations both launch it; fp32 ones are rounded to bf16 as the kernel
stages them and the output is written in fp32.

Packing contract (pair layout, `models/quant.py` `quantize_weight_int4`):
packed row r holds original row 2r in the low nibble and 2r + 1 in the high
nibble; group scales run along the contraction, scale[h // group, d].

For CPU tensors the wrapper runs the plain PyTorch version, which follows
`dequantize_weight_int4` in the compute dtype (the scaled weight is rounded
to that dtype before the product, as in the TPU kernel); on CUDA tensors it
launches the kernel or raises. The kernel keeps one fp32 accumulator per
scale group and applies the fp32 scale to it at the group's end instead, so
it differs from the plain version by the rounding of the scaled weights.

With grad mode on, the product goes through the operator
`torch.ops.llark.int4_matmul` (see `ops/int8_matmul.py`): the same forward,
and dx = g dequant(q4, scale)^T in the backward, dequantized in g's dtype
one layer's weight at a time (llark_tpu/models/quant.py:193-237).
"""

from __future__ import annotations

import torch

from llark_tpu_torch.ops.int8_matmul import (
    _check_operands,
    _launch,
    _save_weight,
    matmul_f32,
)


def split_nibbles(packed: torch.Tensor):
    """int8 bytes -> (low, high) nibbles as sign-extended int8 in [-8, 7]."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    return torch.where(lo > 7, lo - 16, lo), torch.where(hi > 7, hi - 16, hi)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """int8 [..., in/2, out] -> int8 [..., in, out], sign-extended nibbles
    (pair layout: packed row r -> original rows 2r, 2r + 1)."""
    *lead, half, out = packed.shape
    return torch.stack(split_nibbles(packed), dim=-2).reshape(*lead, half * 2, out)


def scale_groups(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Unpacked values [..., in, out] times their group scales [..., G, out],
    both in `dtype` (the compute dtype, not fp32: in bf16 the scaled weight
    is rounded to bf16), as llark_tpu/models/quant.py:113-119."""
    *lead, fan_in, out = q.shape
    g = scale.shape[-2]
    scaled = q.to(dtype).reshape(*lead, g, fan_in // g, out) * scale[..., :, None, :].to(dtype)
    return scaled.reshape(*lead, fan_in, out)


def dequantize_int4(q4: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Packed [..., in/2, out] + scale [..., G, out] -> [..., in, out] in
    `dtype`."""
    return scale_groups(unpack_int4(q4), scale, dtype)


def _int4_matmul_plain(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the int4 kernel: dequantize in x's dtype,
    an fp32-accumulated product, one rounding to x's dtype."""
    return matmul_f32(x, dequantize_int4(q4, scale, x.dtype)).to(x.dtype)


def int4_kernel_takes(q4: torch.Tensor, scale: torch.Tensor) -> bool:
    """The kernel route's contract, the one predicate the dispatcher
    (`models/quant.py` `quantized_dense_int4`) asks, about the leaf's shapes
    alone: a 2-D packed weight [H/2, D] in the pair layout whose scale group
    (H over the scale's rows) is a multiple of 16 rows (a group ends on a
    tensor-core step) and divides H, and D % 8 == 0 (the packed rows are
    copied in 8-byte pieces; M, and D up to that, are masked). Wider than the TPU gate (group >= 128,
    H % 256 == 0, D % 128 == 0); all seven Llama-2-7B projections are
    inside. Such a leaf goes to the wrapper on either device: it runs the
    plain version for CPU tensors, and for CUDA tensors it launches the
    kernel (bfloat16 or float32 activations) or raises, never stepping down
    to the plain expression."""
    if q4.dim() != 2 or scale.dim() != 2 or scale.shape[0] == 0:
        return False
    h, d = q4.shape[0] * 2, q4.shape[1]
    return h % scale.shape[0] == 0 and (h // scale.shape[0]) % 16 == 0 and d % 8 == 0


def int4_matmul(
    x: torch.Tensor,  # [M, H] activations (compute dtype)
    q4: torch.Tensor,  # [H/2, D] packed int8 (pair layout)
    scale: torch.Tensor,  # [H/group, D] f32 group scales
    group: int = 128,
) -> torch.Tensor:
    """y[M, D] = x @ dequant(q4, scale) in x's dtype; only packed bytes and
    scales are read from device memory. Counterpart of
    llark_tpu/ops/int4_matmul.py:77-118 (the even/odd split of x there
    avoids an interleave on the TPU; this kernel reads x as it is). `group`
    must divide H and agree with the scale's rows; the group the product
    uses is read off the scale's shape. CUDA tensors launch
    `csrc/int4_matmul.cu` (bfloat16 or float32 x, the product in bf16 with
    fp32 group sums; group % 16 == 0 and D % 8 == 0, see
    `int4_kernel_takes`; a contiguous weight, never copied) or raise; CPU
    tensors run the plain version. `int4_matmul.launches` counts kernel
    launches."""
    h = x.shape[1]
    hp, d = q4.shape
    if hp * 2 != h:
        raise ValueError(f"packed rows {hp} != H/2 ({h}/2)")
    if group < 1 or h % group:
        raise ValueError(f"group {group} does not divide H ({h})")
    n_groups = h // group
    if tuple(scale.shape) != (n_groups, d):
        raise ValueError(f"scale shape {tuple(scale.shape)} != {(n_groups, d)}")
    if x.device.type != "cpu":
        if not int4_kernel_takes(q4, scale):
            raise ValueError(
                f"int4_matmul: the CUDA kernel takes a packed [H/2, D] weight with "
                f"group % 16 == 0 and D % 8 == 0, got {tuple(q4.shape)}, group {group}"
            )
        _check_operands("int4_matmul", x, q4, scale)
    # the operator with grad mode on, else a direct call: see int8_matmul
    if torch.is_grad_enabled():
        return torch.ops.llark.int4_matmul(x, q4, scale)
    return _int4_product(x, q4, scale)


int4_matmul.launches = 0


def _int4_product(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The product of checked operands, its group read off the scale's
    rows: the plain version for CPU tensors, the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return _int4_matmul_plain(x, q4, scale)
    m, h = x.shape
    d = q4.shape[1]
    group = h // scale.shape[0]
    out = _launch("int4_matmul.cu", "llark_int4_matmul", x, q4, scale, m, h, d, group, (group,))
    int4_matmul.launches += 1
    return out


@torch.library.custom_op("llark::int4_matmul", mutates_args=())
def _int4_matmul_op(x: torch.Tensor, q4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return _int4_product(x, q4, scale)


def _int4_matmul_dx(ctx, g):
    """dx = g dequant(q4, scale)^T in g's dtype, with an fp32 accumulator;
    the packed weight and its scales get no gradient."""
    q4, scale = ctx.saved_tensors
    return matmul_f32(g, dequantize_int4(q4, scale, g.dtype).t()).to(g.dtype), None, None


_int4_matmul_op.register_autograd(_int4_matmul_dx, setup_context=_save_weight)
