"""Attention ops: the plain PyTorch reference path and the Hopper
flash-attention kernels, forward and backward.

Counterparts of llark_tpu/ops/attention.py. `xla_attention` keeps its name
so the two packages read side by side; in the port it is the plain PyTorch
path (fp32 softmax, products accumulated in fp32). Two wrappers launch
hand-written CUDA kernels:

  flash_attention_fwd      csrc/flash_fwd.cu   replaces `_flash_fwd_kernel`
  flash_attention_bwd      csrc/flash_bwd.cu   replaces `_flash_bwd_dq_kernel`
                                               and `_flash_bwd_dkv_kernel`

For CPU tensors each runs its plain PyTorch version instead; for CUDA
tensors it launches its kernel or raises. `_FlashAttention`, the
counterpart of the JAX package's `_flash_mha` custom VJP, ties the forward
(with its log-sum-exp) to the backward for autograd.

Slope convention everywhere: `slopes` are positive magnitudes; the additive
bias is `slope * (k_pos - q_pos)` (<= 0 on the causal triangle).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from llark_tpu_torch.ops import _build

# finite "minus infinity" of the plain path, as in the JAX package, so a
# fully masked row softmaxes to uniform weights there instead of NaN
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """Per-head ALiBi slope magnitudes, MPT-compatible: computed on the next
    power of two and interleave-subsampled (reference:
    m2t/llava/model/mpt/attention.py:462-470)."""
    ceil_p2 = 2 ** math.ceil(math.log2(num_heads))
    base = torch.arange(1, ceil_p2 + 1, dtype=torch.float32, device=device)
    slopes = 1.0 / torch.pow(2.0, base * (8.0 / ceil_p2))
    if ceil_p2 != num_heads:
        slopes = torch.cat([slopes[1::2], slopes[0::2]])[:num_heads]
    return slopes


def _broadcast_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """[B, Hkv, ...] -> [B, H, ...] by repetition along the head axis (GQA/MQA)."""
    hkv = k.shape[1]
    if hkv == num_q_heads:
        return k
    return k.repeat_interleave(num_q_heads // hkv, dim=1)


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
    q_offset: Union[int, torch.Tensor] = 0,
    prefix_lengths: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain reference attention, the counterpart of llark_tpu/ops/
    attention.py:63-130 `xla_attention`. q:[B,H,Sq,D] k,v:[B,Hkv,Sk,D].

    `q_offset` (scalar or [B]) is the absolute position of q[..., 0, :].
    `prefix_lengths` [B] enables prefix-LM masking: keys < prefix_lengths[b]
    are visible to every query. `k_scale`/`v_scale` [B, Hkv, Sk] dequantize
    an int8 cache inside the dots (the K scale multiplies the logits, the V
    scale the probabilities). A fully masked row gets uniform weights.
    """
    b, h, sq, d = q.shape
    k = _broadcast_kv(k, h)
    v = _broadcast_kv(v, h)
    sk = k.shape[2]
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    logits = torch.matmul(q.float(), k.to(q.dtype).float().transpose(-1, -2)) * scale
    if k_scale is not None:
        logits = logits * _broadcast_kv(k_scale.float(), h)[:, :, None, :]

    # a host offset stays a Python int (a tensor made from it would be a
    # host-to-device copy, which a CUDA graph capture refuses)
    q_off = q_offset.to(dev, torch.int64).reshape(-1, 1, 1) if torch.is_tensor(q_offset) else q_offset
    q_pos = torch.arange(sq, device=dev)[None, :, None] + q_off  # [1|B, Sq, 1]
    k_pos = torch.arange(sk, device=dev)[None, None, :]  # [1, 1, Sk]
    rel = (k_pos - q_pos).float()  # [1|B, Sq, Sk]
    mask = torch.ones(rel.shape, dtype=torch.bool, device=dev)
    if causal:
        mask = k_pos <= q_pos
        if prefix_lengths is not None:
            mask = mask | (k_pos < prefix_lengths.to(dev)[:, None, None])
    if slopes is not None:
        logits = logits + slopes.float()[None, :, None, None] * rel[:, None, :, :]
    mask = mask[:, None]  # [1|B, 1, Sq, Sk]
    if kv_lengths is not None:
        mask = mask & (k_pos[:, None] < kv_lengths.to(dev)[:, None, None, None])
    logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * _broadcast_kv(v_scale.float(), h)[:, :, None, :]
    pdtype = q.dtype if v_scale is not None else v.dtype
    out = torch.matmul(probs.to(pdtype).float(), v.to(pdtype).float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Flash-attention forward: Hopper kernel + its plain PyTorch version
# ---------------------------------------------------------------------------


def _scores_and_mask(q, k, *, causal, kv_lengths, slopes):
    """The flash kernels' scaled, ALiBi-biased scores [B, H, Sq, Sk] in fp32
    and their mask (True where a query sees a key)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dev = q.device
    s = torch.matmul(
        q.float() * (1.0 / math.sqrt(d)), _broadcast_kv(k, h).float().transpose(-1, -2)
    )
    q_pos = torch.arange(sq, device=dev)[:, None]
    k_pos = torch.arange(sk, device=dev)[None, :]
    if slopes is not None:
        s = s + slopes.abs().float()[None, :, None, None] * (k_pos - q_pos).float()
    if kv_lengths is None:
        kv_lengths = torch.full((b,), sk, device=dev)
    mask = k_pos < kv_lengths.to(dev).reshape(b, 1, 1, 1)  # [B, 1, 1, Sk]
    if causal:
        mask = mask & (k_pos <= q_pos)
    return s, mask


def _flash_attention_fwd_plain(q, k, v, *, causal, kv_lengths, slopes, return_lse=False):
    """Plain PyTorch version of `csrc/flash_fwd.cu` (and of the TPU kernel
    `_flash_fwd_kernel`): the same masking, ALiBi and GQA, fp32 softmax,
    and zeros for a row that sees no key. With `return_lse`, also the
    per-row log-sum-exp [B, H, Sq] fp32, -DEFAULT_MASK_VALUE for a row that
    sees no key."""
    s, mask = _scores_and_mask(q, k, causal=causal, kv_lengths=kv_lengths, slopes=slopes)
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)  # masked entries: exp(-inf) = 0
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    out = torch.matmul(p, _broadcast_kv(v, q.shape[1]).float()) / l_safe
    out = out.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0, -DEFAULT_MASK_VALUE, m + torch.log(l_safe))[..., 0]
    return out, lse


_FWD_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """The kernels read rows as 16-byte vectors: unit stride in D, 16-byte
    aligned base and (batch, head, seq) strides that are multiples of 8."""
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        t = t.contiguous()
    return t


def _check_kernel_inputs(name, q, k, v, *rest):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: the CUDA kernel takes bfloat16 or float32, got {q.dtype}")
    for t in (q, k, v, *rest):
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: the CUDA kernel takes one dtype, got {q.dtype} and {t.dtype}")
        if t.device != q.device or t.dim() != 4:
            raise ValueError(f"{name}: q, k, v must be 4-D tensors on one device")
    d = q.shape[3]
    if d not in (64, 128):
        raise ValueError(f"{name}: the CUDA kernel takes head_dim 64 or 128, got {d}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[3] != d:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"{name}: {q.shape[1]} q heads not a multiple of {k.shape[1]} kv heads")


def _kernel_lengths_slopes(q, k, kv_lengths, slopes):
    """kv_lengths as contiguous int32 [B] and slopes as fp32 [H] (or None) on
    q's device, as the kernels read them."""
    b, h = q.shape[:2]
    dev = q.device
    if kv_lengths is None:
        kv_lengths = torch.full((b,), k.shape[2], dtype=torch.int32, device=dev)
    kvl = kv_lengths.to(device=dev, dtype=torch.int32).reshape(b).contiguous()
    sl = None if slopes is None else slopes.to(device=dev, dtype=torch.float32).reshape(h).contiguous()
    return kvl, sl


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _flash_attention_fwd_cuda(q, k, v, *, causal, kv_lengths, slopes, return_lse):
    _check_kernel_inputs("flash_attention_fwd", q, k, v)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    dev = q.device
    kvl, sl = _kernel_lengths_slopes(q, k, kv_lengths, slopes)
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) if return_lse else None
    if o.numel() == 0:
        return (o, lse) if return_lse else o
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3]
    )
    fn = _build.load("flash_fwd.cu").llark_flash_fwd
    fn.argtypes, fn.restype = _FWD_ARGTYPES, ctypes.c_int
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _ptr(lse), kvl.data_ptr(),
        _ptr(sl), b, h, hkv, sq, sk, d, strides, int(causal), 1.0 / math.sqrt(d),
        int(q.dtype == torch.float32), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "llark_flash_fwd")
    flash_attention_fwd.launches += 1
    return (o, lse) if return_lse else o


def flash_fwd_kernel_takes(head_dim: int) -> bool:
    """Whether the flash kernels (`csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`)
    take a query of this head_dim: 64 or 128. Like the reference's routing
    condition (llark_tpu/ops/attention.py:720-723) it looks at the shape
    alone: `multihead_attention` sends a CUDA query outside it to
    `xla_attention`, and one inside it to the kernels, which take bfloat16
    and float32 (rounded to bf16 for the products) and raise on any other
    dtype."""
    return head_dim in (64, 128)


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
    return_lse: bool = False,
):
    """Flash-attention forward. q:[B,H,Sq,D], k/v:[B,Hkv,Sk,D] -> [B,H,Sq,D],
    and with `return_lse` also the per-row log-sum-exp [B,H,Sq] fp32 that
    the backward reads (the TPU kernel's 128-lane copies of it are a layout
    artifact the port drops).

    Counterpart of llark_tpu/ops/attention.py:227-332. CUDA tensors launch
    `csrc/flash_fwd.cu` (bf16 or fp32, head_dim 64 or 128; anything else
    raises; fp32 q, k, v are rounded to bf16 for the products and the
    output is fp32);
    CPU tensors run the plain version. Unlike the TPU kernel, no length has
    to divide a block size: the kernel masks ragged edges itself.
    `flash_attention_fwd.launches` counts kernel launches."""
    impl = _flash_attention_fwd_plain if q.device.type == "cpu" else _flash_attention_fwd_cuda
    return impl(q, k, v, causal=causal, kv_lengths=kv_lengths, slopes=slopes,
                return_lse=return_lse)


flash_attention_fwd.launches = 0


# ---------------------------------------------------------------------------
# Flash-attention backward: Hopper kernels + their plain PyTorch version
# ---------------------------------------------------------------------------


def _flash_bwd_delta(out, g):
    """delta = rowsum(g * out) [B, H, Sq] fp32, the plain version of
    `flash_bwd_pre` in `csrc/flash_bwd.cu` (and of llark_tpu/ops/
    attention.py:522-527)."""
    return (g.float() * out.float()).sum(dim=-1)


def _flash_bwd_plain(q, k, v, g, lse, delta, *, causal, kv_lengths, slopes):
    """Plain PyTorch version of the backward kernels (`csrc/flash_bwd.cu`,
    the TPU kernels `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`):
    p rebuilt from the log-sum-exp, ds = p (dO v^T - delta) scale, then
    dq = ds k, dk = ds^T q, dv = p^T dO, all in fp32; dk/dv summed over
    the q heads that share a kv head. Returns (dq, dk, dv) in q's dtype."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    s, mask = _scores_and_mask(q, k, causal=causal, kv_lengths=kv_lengths, slopes=slopes)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    gf = g.float()
    kb, vb = _broadcast_kv(k, h).float(), _broadcast_kv(v, h).float()
    ds = p * (torch.matmul(gf, vb.transpose(-1, -2)) - delta.float()[..., None]) / math.sqrt(d)
    dq = torch.matmul(ds, kb)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), gf)
    if h != hkv:
        dk = dk.reshape(b, hkv, h // hkv, sk, d).sum(dim=2)
        dv = dv.reshape(b, hkv, h // hkv, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check_bwd_args(q, k, out, lse, g):
    """Shapes the backward takes, on either device: out and g like q, lse
    [B, H, Sq]."""
    for name, t in (("out", out), ("g", g)):
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)} is not q's {tuple(q.shape)}")
    if tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} is not [B, H, Sq] "
                         f"{tuple(q.shape[:3])}")
    if k.dim() != 4 or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention_bwd: k {tuple(k.shape)} does not fit q {tuple(q.shape)}")


_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


def _flash_attention_bwd_cuda(q, k, v, out, lse, g, *, causal, kv_lengths, slopes):
    _check_kernel_inputs("flash_attention_bwd", q, k, v, out, g)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous fp32 [B, H, Sq]")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dev = q.device
    f32 = q.dtype == torch.float32
    if q.numel() == 0 or k.numel() == 0:  # no pair: zero gradients
        return tuple(torch.zeros(t.shape, dtype=q.dtype, device=dev) for t in (q, k, v))
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dk = torch.empty(k.shape, dtype=q.dtype, device=dev)
    dv = torch.empty(v.shape, dtype=q.dtype, device=dev)
    q, k, v, out, g = (_kernel_operand(t) for t in (q, k, v, out, g))
    kvl, sl = _kernel_lengths_slopes(q, k, kv_lengths, slopes)
    # scratch: delta and the fp32 dq accumulator, both filled by the kernels
    # (for fp32 inputs the accumulator is dq itself)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    dq_acc = dq if f32 else torch.empty((b, h, sq, d), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 15)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], *g.stride()[:3]
    )
    fn = _build.load("flash_bwd.cu").llark_flash_bwd
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        kvl.data_ptr(), _ptr(sl), b, h, hkv, sq, sk, d, strides, int(causal),
        1.0 / math.sqrt(d), int(f32), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "llark_flash_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(
    q, k, v, out, lse, g, *, causal=True, kv_lengths=None, slopes=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention from q [B,H,Sq,D], k, v [B,Hkv,Sk,D],
    the forward's output and log-sum-exp [B,H,Sq] fp32, and the output
    cotangent g; dk/dv at the kv head count, summed over each GQA group.
    Counterpart of llark_tpu/ops/attention.py:491-596 (the TPU kernels
    `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`, the delta reduction
    and the group-sum of `_flash_mha_bwd`).

    CUDA tensors launch `csrc/flash_bwd.cu` (bf16 or fp32, head_dim 64 or
    128; anything else raises; fp32 inputs are rounded to bf16 for the
    products and the gradients are fp32): delta and the zeroing of an fp32
    dq accumulator, one pass of wgmma products over the visible tile pairs,
    and dq's rounding to bf16 (for fp32 the accumulator is dq). dq's fp32 sums come in an order that varies from run
    to run. Strided q, k, v, g with unit stride in D and 16-byte aligned
    rows are read in place. CPU tensors run the plain version.
    `flash_attention_bwd.launches` counts one per backward on the card."""
    _check_bwd_args(q, k, out, lse, g)
    kw = dict(causal=causal, kv_lengths=kv_lengths, slopes=slopes)
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, g, lse, _flash_bwd_delta(out, g), **kw)
    return _flash_attention_bwd_cuda(q, k, v, out, lse, g, **kw)


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its flash backward: the counterpart of the JAX
    package's `_flash_mha` custom VJP (llark_tpu/ops/attention.py:599-648).
    The forward keeps (q, k, v, out, lse); the backward recomputes the
    probabilities in `flash_attention_bwd`. kv_lengths and slopes get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_lengths, slopes):
        out, lse = flash_attention_fwd(
            q, k, v, causal=causal, kv_lengths=kv_lengths, slopes=slopes, return_lse=True
        )
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse, kv_lengths, slopes)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, kv_lengths, slopes = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, g, causal=ctx.causal, kv_lengths=kv_lengths, slopes=slopes
        )
        return dq, dk, dv, None, None, None


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
    use_pallas: bool = True,
    prefix_lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dispatching attention entry point (llark_tpu/ops/attention.py:693-735).

    With `use_pallas`, a multi-token query without prefix-LM masking goes
    to the flash kernels: through `_FlashAttention` (forward with its
    log-sum-exp, flash backward) when autograd records and an input needs a
    gradient, else straight to `flash_attention_fwd` (serving, eval). A
    single-token query, prefix-LM masking and a CUDA query of a head_dim
    outside the kernels' contract (`flash_fwd_kernel_takes`) take the plain
    `xla_attention` path, as on the TPU. CPU tensors take the flash route's
    plain versions at any head_dim and dtype."""
    takes = q.device.type == "cpu" or flash_fwd_kernel_takes(q.shape[3])
    if use_pallas and q.shape[2] > 1 and prefix_lengths is None and takes:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return _FlashAttention.apply(q, k, v, causal, kv_lengths, slopes)
        return flash_attention_fwd(
            q, k, v, causal=causal, kv_lengths=kv_lengths, slopes=slopes
        )
    return xla_attention(
        q, k, v, causal=causal, kv_lengths=kv_lengths, slopes=slopes,
        prefix_lengths=prefix_lengths,
    )
