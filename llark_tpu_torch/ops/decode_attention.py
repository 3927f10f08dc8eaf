"""Flash-decode attention: short-query steps against a KV cache.

Counterpart of llark_tpu/ops/decode_attention.py. `flash_decode_attention`
wraps the hand-written CUDA kernel `csrc/flash_decode.cu`, which replaces
both TPU kernels (`_decode_kernel_all_heads`, the default, and
`_decode_kernel`, `all_heads=False`): they compute one function and differ
only in TPU grid layout. The kernel reads only each row's live cache
positions, so the bytes a step moves scale with the context, not with the
padded cache.

For CPU tensors the wrapper runs the plain PyTorch version, which covers
every mode of the JAX function: dense caches, int8 caches with
per-position scales, paged block-table pools, and Sq <= 32 query windows
with per-row first-query positions. The CUDA kernel covers the dense bf16
mode; on CUDA tensors the int8 and paged modes raise NotImplementedError.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from llark_tpu_torch.ops import _build
from llark_tpu_torch.ops.attention import (
    _broadcast_kv,
    _check_kernel_inputs,
    _kernel_operand,
    xla_attention,
)


def _dense_view(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Paged pool [N, Hkv, bs(, D)] + tables [B, max_blocks] -> the rows'
    dense view [B, Hkv, max_blocks * bs(, D)]."""
    b, max_blocks = block_tables.shape
    g = pool[block_tables.reshape(-1).long()]  # [B*max_blocks, Hkv, bs(, D)]
    g = g.reshape((b, max_blocks) + tuple(pool.shape[1:]))
    g = g.transpose(1, 2)  # [B, Hkv, max_blocks, bs(, D)]
    return g.reshape((b, pool.shape[1], max_blocks * pool.shape[2]) + tuple(pool.shape[3:]))


def _flash_decode_plain(
    q, k_cache, v_cache, *, kv_lengths, q_positions, k_scale, v_scale, slopes,
    block_tables,
):
    """Plain PyTorch version of the flash-decode kernel: fp32 scores, V's
    int8 scale folded into the probabilities, a row that sees no key
    writes zeros, and cache rows past a row's live length never reach the
    accumulator (so 0 x non-finite cannot poison it)."""
    b, h, sq, d = q.shape
    if block_tables is not None:
        k_cache, v_cache = _dense_view(k_cache, block_tables), _dense_view(v_cache, block_tables)
        if k_scale is not None:
            k_scale = _dense_view(k_scale, block_tables)
            v_scale = _dense_view(v_scale, block_tables)
    s_len = k_cache.shape[2]
    dev = q.device
    kvl = kv_lengths.to(dev).long().reshape(b)
    if q_positions is None:
        q_positions = kvl - 1
    qpos = torch.as_tensor(q_positions, device=dev).long().reshape(-1).expand(b)
    s = torch.matmul(
        q.float() * (1.0 / math.sqrt(d)), _broadcast_kv(k_cache, h).float().transpose(-1, -2)
    )  # [B, H, Sq, S]
    if k_scale is not None:
        s = s * _broadcast_kv(k_scale.float(), h)[:, :, None, :]
    k_pos = torch.arange(s_len, device=dev)
    q_pos_row = qpos[:, None] + torch.arange(sq, device=dev)  # [B, Sq]
    if slopes is not None:
        rel = (k_pos[None, None, :] - q_pos_row[:, :, None]).float()  # [B, Sq, S]
        s = s + slopes.abs().float()[None, :, None, None] * rel[:, None]
    live = k_pos[None, :] < kvl[:, None]  # [B, S]
    mask = live[:, None, None, :]
    if sq > 1:
        mask = mask & (k_pos[None, None, :] <= q_pos_row[:, :, None])[:, None]
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * _broadcast_kv(v_scale.float(), h)[:, :, None, :]
    vf = _broadcast_kv(v_cache, h).float().masked_fill(~live[:, None, :, None], 0.0)
    out = torch.matmul(p, vf) / torch.where(l == 0, 1.0, l)
    return out.to(q.dtype)


_DECODE_ARGTYPES = (
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
    + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
)


def _flash_decode_cuda(q, k_cache, v_cache, *, kv_lengths, q_positions, slopes):
    _check_kernel_inputs("flash_decode_attention", q, k_cache, v_cache)
    b, h, sq, d = q.shape
    hkv, s_len = k_cache.shape[1], k_cache.shape[2]
    q, k_cache, v_cache = (_kernel_operand(t) for t in (q, k_cache, v_cache))
    dev = q.device
    kvl = kv_lengths.to(device=dev, dtype=torch.int32).reshape(b).contiguous()
    if q_positions is None:
        q_positions = kvl - 1
    qpos = torch.as_tensor(q_positions, device=dev).to(torch.int32).reshape(-1).expand(b).contiguous()
    sl = None if slopes is None else slopes.to(device=dev, dtype=torch.float32).reshape(h).contiguous()
    out = torch.empty((b, h, sq, d), dtype=torch.bfloat16, device=dev)
    if out.numel() == 0 or s_len == 0:
        return out.zero_()
    lib = _build.load("flash_decode.cu")
    splits = lib.llark_flash_decode_splits
    splits.argtypes, splits.restype = [ctypes.c_int], ctypes.c_int
    n_splits = splits(s_len)
    part_acc = torch.empty((b, h, sq, n_splits, d), dtype=torch.float32, device=dev)
    part_m = torch.empty((b, h, sq, n_splits), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k_cache.stride()[:3], *v_cache.stride()[:3])
    fn = lib.llark_flash_decode
    fn.argtypes, fn.restype = _DECODE_ARGTYPES, ctypes.c_int
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kvl.data_ptr(),
        qpos.data_ptr(), None if sl is None else sl.data_ptr(), part_acc.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), out.data_ptr(), b, h, hkv, sq, s_len, d,
        strides, 1.0 / math.sqrt(d), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "llark_flash_decode")
    flash_decode_attention.launches += 1
    return out


def flash_decode_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D] (or a paged pool [N, Hkv, bs, D])
    v_cache: torch.Tensor,
    *,
    kv_lengths: torch.Tensor,  # [B] live length (newest token included)
    q_positions: Optional[torch.Tensor] = None,  # [B] first-query positions
    k_scale: Optional[torch.Tensor] = None,  # [B, Hkv, S] f32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,  # [H] alibi slope magnitudes
    block_tables: Optional[torch.Tensor] = None,  # [B, max_blocks] (paged)
) -> torch.Tensor:
    """Short-query decode attention against a KV cache -> [B, H, Sq, D].

    Counterpart of llark_tpu/ops/decode_attention.py:289-505. Equivalent
    to `xla_attention(q, cache, ..., q_offset=q_positions)` for small Sq,
    except that `q_positions` defaults to `kv_lengths - 1` and a row that
    sees no key gives zeros. Queries of a row sit at consecutive positions
    from its `q_positions` entry; for Sq > 1 each sees keys up to its own
    position. CUDA tensors launch `csrc/flash_decode.cu` (dense bf16 cache,
    head_dim 64 or 128); CPU tensors run the plain version.
    `flash_decode_attention.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return _flash_decode_plain(
            q, k_cache, v_cache, kv_lengths=kv_lengths, q_positions=q_positions,
            k_scale=k_scale, v_scale=v_scale, slopes=slopes, block_tables=block_tables,
        )
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 KV caches on the GPU come with the serving-engine slice of "
            "the port; this kernel reads a dense bf16 cache"
        )
    if block_tables is not None:
        raise NotImplementedError(
            "paged KV caches on the GPU come with the serving-engine slice of "
            "the port; this kernel reads a dense bf16 cache"
        )
    return _flash_decode_cuda(
        q, k_cache, v_cache, kv_lengths=kv_lengths, q_positions=q_positions,
        slopes=slopes,
    )


flash_decode_attention.launches = 0


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    kv_lengths: torch.Tensor,
    q_positions: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
    use_pallas: bool = True,
    block_tables: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dispatching decode-attention entry point
    (llark_tpu/ops/decode_attention.py:508-572): with `use_pallas`, a query
    window of at most 32 tokens goes to `flash_decode_attention`; otherwise
    the plain `xla_attention` path runs, after gathering a dense view of a
    paged pool."""
    b, h, sq, d = q.shape
    if use_pallas and sq <= 32:
        return flash_decode_attention(
            q, k_cache, v_cache, kv_lengths=kv_lengths, q_positions=q_positions,
            k_scale=k_scale, v_scale=v_scale, slopes=slopes, block_tables=block_tables,
        )
    if block_tables is not None:
        k_cache, v_cache = _dense_view(k_cache, block_tables), _dense_view(v_cache, block_tables)
        if k_scale is not None:
            k_scale = _dense_view(k_scale, block_tables)
            v_scale = _dense_view(v_scale, block_tables)
    return xla_attention(
        q, k_cache, v_cache, causal=True, kv_lengths=kv_lengths, slopes=slopes,
        q_offset=0 if q_positions is None else q_positions,
        k_scale=k_scale, v_scale=v_scale,
    )
