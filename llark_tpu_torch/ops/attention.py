"""Attention ops: the plain PyTorch reference path and the Hopper
flash-attention forward kernel.

Counterparts of llark_tpu/ops/attention.py. `xla_attention` keeps its name
so the two packages read side by side; in the port it is the plain PyTorch
path (fp32 softmax, products accumulated in fp32). `flash_attention_fwd`
wraps the hand-written CUDA kernel `csrc/flash_fwd.cu`, which replaces the
TPU kernel `_flash_fwd_kernel`; for CPU tensors it runs the kernel's plain
PyTorch version instead, and for CUDA tensors it launches the kernel or
raises.

Slope convention everywhere: `slopes` are positive magnitudes; the additive
bias is `slope * (k_pos - q_pos)` (<= 0 on the causal triangle).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

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

    q_off = torch.as_tensor(q_offset, dtype=torch.int64, device=dev).reshape(-1, 1, 1)
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


def _flash_attention_fwd_plain(q, k, v, *, causal, kv_lengths, slopes):
    """Plain PyTorch version of `csrc/flash_fwd.cu` (and of the TPU kernel
    `_flash_fwd_kernel`): the same masking, ALiBi and GQA, fp32 softmax,
    and zeros for a row that sees no key."""
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
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)  # masked entries: exp(-inf) = 0
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, _broadcast_kv(v, h).float()) / torch.where(l == 0, 1.0, l)
    return out.to(q.dtype)


_FWD_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
)


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """The kernels read rows as 16-byte vectors: unit stride in D, 16-byte
    aligned base and (batch, head, seq) strides that are multiples of 8."""
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        t = t.contiguous()
    return t


def _check_kernel_inputs(name, q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got {q.device}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")
        if t.device != q.device or t.dim() != 4:
            raise ValueError(f"{name}: q, k, v must be 4-D tensors on one device")
    d = q.shape[3]
    if d not in (64, 128):
        raise ValueError(f"{name}: the CUDA kernel takes head_dim 64 or 128, got {d}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[3] != d:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"{name}: {q.shape[1]} q heads not a multiple of {k.shape[1]} kv heads")


def _flash_attention_fwd_cuda(q, k, v, *, causal, kv_lengths, slopes):
    _check_kernel_inputs("flash_attention_fwd", q, k, v)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    dev = q.device
    if kv_lengths is None:
        kv_lengths = torch.full((b,), sk, dtype=torch.int32, device=dev)
    kvl = kv_lengths.to(device=dev, dtype=torch.int32).reshape(b).contiguous()
    sl = None if slopes is None else slopes.to(device=dev, dtype=torch.float32).reshape(h).contiguous()
    o = torch.empty((b, h, sq, d), dtype=torch.bfloat16, device=dev)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3]
    )
    fn = _build.load("flash_fwd.cu").llark_flash_fwd
    fn.argtypes, fn.restype = _FWD_ARGTYPES, ctypes.c_int
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), kvl.data_ptr(),
        None if sl is None else sl.data_ptr(), b, h, hkv, sq, sk, d, strides,
        int(causal), 1.0 / math.sqrt(d), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "llark_flash_fwd")
    flash_attention_fwd.launches += 1
    return o


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash-attention forward. q:[B,H,Sq,D], k/v:[B,Hkv,Sk,D] -> [B,H,Sq,D].

    Counterpart of llark_tpu/ops/attention.py:227-332. CUDA tensors launch
    `csrc/flash_fwd.cu` (bf16, head_dim 64 or 128; anything else raises);
    CPU tensors run the plain version. Unlike the TPU kernel, no length has
    to divide a block size: the kernel masks ragged edges itself. The
    per-row log-sum-exp (training) is not produced here.
    `flash_attention_fwd.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return _flash_attention_fwd_plain(
            q, k, v, causal=causal, kv_lengths=kv_lengths, slopes=slopes
        )
    return _flash_attention_fwd_cuda(
        q, k, v, causal=causal, kv_lengths=kv_lengths, slopes=slopes
    )


flash_attention_fwd.launches = 0


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
    to `flash_attention_fwd`; a single-token query and prefix-LM masking
    take the plain `xla_attention` path, as on the TPU."""
    if use_pallas and q.shape[2] > 1 and prefix_lengths is None:
        return flash_attention_fwd(
            q, k, v, causal=causal, kv_lengths=kv_lengths, slopes=slopes
        )
    return xla_attention(
        q, k, v, causal=causal, kv_lengths=kv_lengths, slopes=slopes,
        prefix_lengths=prefix_lengths,
    )
