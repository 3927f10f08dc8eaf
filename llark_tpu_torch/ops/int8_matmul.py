"""Int8 weight-only matmul: dequantize inside the product.

Counterpart of llark_tpu/ops/int8_matmul.py. `int8_matmul` wraps the
hand-written CUDA kernel `csrc/int8_matmul.cu`, which replaces the TPU
kernel `_int8_matmul_kernel`: the int8 bytes are the only weight bytes that
cross device memory, the convert to bf16 happens in registers on the way
into the tensor cores (wgmma), and the per-output-channel fp32 scale
multiplies the fp32 accumulator before the one rounding to the activations'
dtype. bf16 and fp32 activations both launch it; fp32 ones are rounded to
bf16 as the kernel stages them and the output is written in fp32.
PyTorch has no fused convert-in-the-dot: `x @ q.to(bf16)` writes a bf16
copy of the weight at every use, so the kernel is the serving route for
every 2-D int8 projection on the card.

For CPU tensors the wrapper runs the plain PyTorch version; on CUDA
tensors it launches the kernel or raises. Where autograd may record the
call (grad mode on: QLoRA training, where x carries a gradient and the
frozen weight does not), the product goes through the operator
`torch.ops.llark.int8_matmul`, whose forward is the same kernel (or plain
version) and whose backward returns dx alone, dx = (g * scale) q^T, the
derivative of the JAX package's XLA expression
(llark_tpu/models/quant.py:302-336). The JAX package computes
that derivative in XLA, in no Pallas kernel, so dx is a plain product on
a converted copy of one layer's weight. Being an operator, the product is
visible to selective activation checkpointing (`models/decoder.py`
`_remat_context`), which can keep its output instead of launching it again.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from llark_tpu_torch.ops import _build


class _MatmulF32(torch.autograd.Function):
    """[M, K] x [K, N] in bf16/fp16 with an fp32 result: one tensor-core
    GEMM that keeps its fp32 accumulator (`torch.mm(..., out_dtype=)`, which
    has no derivative of its own). The backward rounds the fp32 cotangent to
    the operands' dtype and runs two GEMMs there."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return torch.mm(g, b.t()), torch.mm(a.t(), g)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] x b [(G,) K, N] -> fp32, from operands in their own
    dtype with an fp32 accumulator that is never rounded to it (the JAX
    package's preferred_element_type=float32). Differentiable, but for a
    batched b in bf16 on the card."""
    if a.dtype == torch.float32 or a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    if b.dim() == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b).reshape(*a.shape[:-1], b.shape[-1])


def _int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel: the int8 weight converted to
    x's dtype (exact), an fp32-accumulated product, the fp32 scale on the
    accumulator, one rounding to x's dtype."""
    y = matmul_f32(x, q.to(x.dtype))
    return (y * scale.reshape(-1).float()).to(x.dtype)


def int8_kernel_takes(q: torch.Tensor) -> bool:
    """The kernel route's contract, the one predicate the dispatcher
    (`models/quant.py` `quantized_dense`) asks, about the weight's shape
    alone: a 2-D weight [K, N] with K % 16 == 0 (the tensor-core step) and
    N % 8 == 0 (the weight rows are copied in 8-byte pieces; M, and N up to
    that, are masked).
    Wider than the TPU gate (K % 128 == 0 and N % 128 == 0); all seven
    Llama-2-7B projections are inside. Such a leaf goes to the wrapper on
    either device: it runs the plain version for CPU tensors, and for CUDA
    tensors it launches the kernel (bfloat16 or float32 activations) or
    raises, never stepping down to the plain expression."""
    return q.dim() == 2 and q.shape[0] % 16 == 0 and q.shape[1] % 8 == 0


def _check_operands(name: str, x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> None:
    """What both quantized-product kernels ask of their CUDA operands."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(
            f"{name}: the CUDA kernel takes bfloat16 or float32 activations, got {x.dtype}"
        )
    if w.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(
            f"{name}: the CUDA kernel takes int8 weights and float32 scales, got "
            f"{w.dtype} and {scale.dtype}"
        )
    if w.device != x.device or scale.device != x.device:
        raise ValueError(f"{name}: operands on {x.device}, {w.device} and {scale.device}")
    # the kernel copies weight rows in 8-byte (16-byte) pieces and reads
    # scales as 16-byte vectors; a weight is never copied here
    if not w.is_contiguous() or w.data_ptr() % 8:
        raise ValueError(
            f"{name}: the CUDA kernel takes a contiguous, 8-byte aligned weight, got "
            f"strides {w.stride()}"
        )
    if not scale.is_contiguous() or scale.data_ptr() % 16:
        raise ValueError(f"{name}: the CUDA kernel takes contiguous, 16-byte aligned scales")


@functools.lru_cache(maxsize=None)
def _entry_points(source: str, entry: str, n_extra: int):
    """(launch, splits) of one kernel library, their ctypes signatures set
    once and the split of each shape remembered: the wrappers run 224 times
    per decode step, so what they do on the host per call is kept small."""
    lib = _build.load(source)
    splits = getattr(lib, entry + "_splits")
    splits.argtypes, splits.restype = [ctypes.c_int] * 4, ctypes.c_int
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * (6 + n_extra) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, functools.lru_cache(maxsize=1024)(splits)


# The arrival counters of a split contraction (one per output tile; the
# kernel's MAX_COUNTERS) and the fp32 partial sums, kept per (device,
# stream): the kernel allocates nothing, the wrapper allocates them once and
# again only when a larger split needs more room. The counters are zeroed
# once; every launch leaves them zero. Two streams never share them, so two
# products in flight at once never meet in one counter.
_COUNTERS = 4096
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, floats: int):
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < floats:
        counters = ws[1] if ws is not None else torch.zeros(
            _COUNTERS, dtype=torch.int32, device=device)
        ws = _workspaces[key] = (torch.empty(floats, dtype=torch.float32, device=device), counters)
    return ws


def _launch(source: str, entry: str, x, w, scale, m, k, n, unit, extra=()):
    """Shared launch of the two quantized-product kernels: x [M, K] bf16 or
    fp32, w the packed weight, out [M, N] in x's dtype. The library picks the
    split of the contraction for this shape, in whole `unit`s of rows; the
    partial sums of a split go through the workspace and are combined in a
    fixed order inside the same launch."""
    if not x.is_contiguous():
        x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel reads x rows as 16-byte vectors
        x = x.clone()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    fn, splits = _entry_points(source, entry, len(extra))
    n_splits = splits(m, k, n, unit)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    part = counters = None
    if n_splits > 1:
        part, counters = _workspace(x.device, stream, n_splits * m * n)
    err = fn(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), m, k, n, *extra, n_splits,
        int(x.dtype == torch.float32), int(n % 16 == 0 and w.data_ptr() % 16 == 0), stream,
    )
    _build.check(err, entry)
    return out


def int8_matmul(
    x: torch.Tensor,  # [M, K] activations (compute dtype)
    q: torch.Tensor,  # [K, N] int8 weights
    scale: torch.Tensor,  # [N] or [1, N] f32 per-output-channel scales
) -> torch.Tensor:
    """y[M, N] = (x @ q) * scale in x's dtype; only int8 weight bytes are
    read from device memory. Counterpart of llark_tpu/ops/int8_matmul.py:58-99
    (the TPU wrapper's row and scale padding are TPU tile artefacts: this
    kernel masks its M tail). CUDA tensors launch `csrc/int8_matmul.cu`
    (bfloat16 or float32 x, the product in bf16 with an fp32 accumulator;
    K % 16 == 0 and N % 8 == 0, see `int8_kernel_takes`; a contiguous
    weight, never copied) or raise; CPU tensors run the plain version.
    `int8_matmul.launches` counts kernel launches, one per product."""
    k = x.shape[1]
    kq, n = q.shape
    if kq != k:
        raise ValueError(f"weight rows {kq} != activation cols {k}")
    scale = scale.reshape(-1)
    if tuple(scale.shape) != (n,):
        raise ValueError(f"scale size {tuple(scale.shape)} != out dim {n}")
    if x.device.type != "cpu":
        if not int8_kernel_takes(q):
            raise ValueError(
                f"int8_matmul: the CUDA kernel takes a [K, N] weight with K % 16 == 0 and "
                f"N % 8 == 0, got {tuple(q.shape)}"
            )
        _check_operands("int8_matmul", x, q, scale)
    # Autograd may record the call only with grad mode on: the operator then
    # carries dx. Serving calls the kernel directly, because the operator's
    # dispatch costs the host 21-46 us a product, 4.8-10.2 ms of a decode
    # step of 224 products that takes 67-92 ms called directly, on an H100
    # 80GB HBM3 at 700 W (chip_smoke.py phase 18 (e), three runs).
    if torch.is_grad_enabled():
        return torch.ops.llark.int8_matmul(x, q, scale)
    return _int8_product(x, q, scale)


int8_matmul.launches = 0


def _int8_product(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The product of checked operands (scale [N]): the plain version for
    CPU tensors, the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return _int8_matmul_plain(x, q, scale)
    m, k = x.shape
    n = q.shape[1]
    out = _launch("int8_matmul.cu", "llark_int8_matmul", x, q, scale, m, k, n, 16)
    int8_matmul.launches += 1
    return out


@torch.library.custom_op("llark::int8_matmul", mutates_args=())
def _int8_matmul_op(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return _int8_product(x, q, scale)


def _int8_matmul_dx(ctx, g):
    """dx = (g * scale) q^T in g's dtype, with an fp32 accumulator; q and
    the scales are frozen integer payloads and get no gradient."""
    q, scale = ctx.saved_tensors
    gs = (g.float() * scale).to(g.dtype)
    return matmul_f32(gs, q.to(g.dtype).t()).to(g.dtype), None, None


def _save_weight(ctx, inputs, output):
    ctx.save_for_backward(*inputs[1:])


_int8_matmul_op.register_autograd(_int8_matmul_dx, setup_context=_save_weight)


def quantized_dense_kernel(
    x: torch.Tensor, wq: Dict[str, torch.Tensor], b: Optional[torch.Tensor], dtype: torch.dtype
) -> torch.Tensor:
    """`quantized_dense` on a 2-D weight leaf through `int8_matmul`
    (llark_tpu/ops/int8_matmul.py:102-120): leading dims flattened, the bias
    added after, in `dtype`. Callers gate on `int8_kernel_takes`."""
    q, scale = wq["q"], wq["scale"]
    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1]).to(dtype)
    y = int8_matmul(xm, q, scale).reshape(*lead, q.shape[-1])
    if b is not None:
        y = y + b.to(dtype)
    return y
