"""Int8 weight-only matmul: dequantize inside the product.

Counterpart of llark_tpu/ops/int8_matmul.py. `int8_matmul` wraps the
hand-written CUDA kernel `csrc/int8_matmul.cu`, which replaces the TPU
kernel `_int8_matmul_kernel`: the int8 bytes are the only weight bytes that
cross device memory, the convert to bf16 happens in registers on the way
into the tensor cores, and the per-output-channel fp32 scale multiplies the
fp32 accumulator before the one rounding to the activations' dtype.
PyTorch has no fused convert-in-the-dot: `x @ q.to(bf16)` writes a bf16
copy of the weight at every use, so the kernel is the serving route for
every 2-D int8 projection on the card.

For CPU tensors the wrapper runs the plain PyTorch version; on CUDA
tensors it launches the kernel or raises. The products carry no gradient in
this slice of the port: the wrapper raises when autograd would record one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from llark_tpu_torch.ops import _build


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] x b [(G,) K, N] -> fp32, from operands in their own
    dtype with an fp32 accumulator that is never rounded to it (the JAX
    package's preferred_element_type=float32)."""
    if a.dtype == torch.float32 or a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    if b.dim() == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32).reshape(
        *a.shape[:-1], b.shape[-1])


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
    N % 8 == 0 (16-byte output stores; M, and N up to that, are masked).
    Wider than the TPU gate (K % 128 == 0 and N % 128 == 0); all seven
    Llama-2-7B projections are inside. Such a leaf goes to the wrapper on
    either device: it runs the plain version for CPU tensors, and for CUDA
    tensors it launches the kernel or raises (the kernel computes in
    bfloat16 only, so another compute dtype on the card is an error there,
    not a step down to the plain expression)."""
    return q.dim() == 2 and q.shape[0] % 16 == 0 and q.shape[1] % 8 == 0


def _refuse_gradient(name: str, x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            f"{name}: the quantized products carry no gradient yet (training on "
            "int8/int4 weights, --bits 8/4 with LoRA, comes with the next slice of "
            "the port); call under torch.no_grad() or detach x"
        )


def _check_operands(name: str, x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> None:
    """What both quantized-product kernels ask of their CUDA operands."""
    if x.dtype != torch.bfloat16:
        raise ValueError(
            f"{name}: the CUDA kernel takes bfloat16 activations (the only compute dtype "
            f"of the quantized products on the card), got {x.dtype}"
        )
    if w.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(
            f"{name}: the CUDA kernel takes int8 weights and float32 scales, got "
            f"{w.dtype} and {scale.dtype}"
        )
    if w.device != x.device or scale.device != x.device:
        raise ValueError(f"{name}: operands on {x.device}, {w.device} and {scale.device}")
    # the kernel reads weight rows as 8-byte and scales as 16-byte vectors;
    # a weight is never copied here
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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (4 + n_extra) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, functools.lru_cache(maxsize=1024)(splits)


def _launch(source: str, entry: str, x, w, scale, m, k, n, unit, extra=()):
    """Shared launch of the two quantized-product kernels: x [M, K] bf16,
    w the packed weight, out [M, N] bf16. The library picks the split of the
    contraction for this shape, in whole `unit`s of rows; partial sums of a
    split go through an fp32 scratch tensor and are combined in a fixed
    order."""
    if not x.is_contiguous():
        x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel reads x rows as 16-byte vectors
        x = x.clone()
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return out
    fn, splits = _entry_points(source, entry, len(extra))
    n_splits = splits(m, k, n, unit)
    part = None
    if n_splits > 1:
        part = torch.empty((n_splits, m, n), dtype=torch.float32, device=x.device)
    err = fn(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), m, k, n, *extra, n_splits,
        torch._C._cuda_getCurrentRawStream(x.device.index),
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
    (bfloat16 x; K % 16 == 0 and N % 8 == 0, see `int8_kernel_takes`; a
    contiguous weight, never copied) or raise; CPU tensors run the plain
    version. `int8_matmul.launches` counts kernel launches."""
    m, k = x.shape
    kq, n = q.shape
    if kq != k:
        raise ValueError(f"weight rows {kq} != activation cols {k}")
    scale = scale.reshape(-1)
    if tuple(scale.shape) != (n,):
        raise ValueError(f"scale size {tuple(scale.shape)} != out dim {n}")
    _refuse_gradient("int8_matmul", x)
    if x.device.type == "cpu":
        return _int8_matmul_plain(x, q, scale)
    if not int8_kernel_takes(q):
        raise ValueError(
            f"int8_matmul: the CUDA kernel takes a [K, N] weight with K % 16 == 0 and "
            f"N % 8 == 0, got {tuple(q.shape)}"
        )
    _check_operands("int8_matmul", x, q, scale)
    out = _launch("int8_matmul.cu", "llark_int8_matmul", x, q, scale, m, k, n, 16)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


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
