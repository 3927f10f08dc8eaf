"""Flash-decode attention: short-query steps against a KV cache.

Counterpart of llark_tpu/ops/decode_attention.py. `flash_decode_attention`
wraps the hand-written CUDA kernel `csrc/flash_decode.cu`, which replaces
both TPU kernels (`_decode_kernel_all_heads`, the default, and
`_decode_kernel`, `all_heads=False`): they compute one function and differ
only in TPU grid layout. The kernel reads only each row's live cache
positions, so the bytes a step moves scale with the context, not with the
padded cache. It takes every cache mode of the JAX function: dense or
paged (block tables over a pool), bf16 or int8 with per-position scales.

For CPU tensors the wrapper runs the plain PyTorch version, which covers
the same modes with Sq <= 32 query windows and per-row first-query
positions; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from collections.abc import Mapping
from typing import Optional

import torch

from llark_tpu_torch.ops import _build
from llark_tpu_torch.ops.attention import _broadcast_kv, _ptr, xla_attention


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


# The kernel addresses a position inside one pool block with a 32-bit
# byte offset; that is its only limit on the block size (it resolves the
# table per staged row, so a split may cross blocks or cover part of one).
_BLOCK_OFFSET_LIMIT = 2**31 - 1


def max_paged_block_size(num_kv_heads: int, head_dim: int, itemsize: int) -> int:
    """Largest paged KV block size the flash-decode kernel takes: a block
    [Hkv, bs, D] of `itemsize`-byte values must be addressable with 32-bit
    byte offsets; rounded down to the server's multiple of 8. The
    counterpart of llark_tpu/ops/decode_attention.py:281-286, whose limit
    is the TPU's VMEM budget instead."""
    cap = _BLOCK_OFFSET_LIMIT // (num_kv_heads * head_dim * itemsize)
    return max(8, (cap // 8) * 8)


def _byte_strides(t: torch.Tensor):
    return [s * t.element_size() for s in t.stride()[:3]]


def _check_decode_inputs(q, k_cache, v_cache, k_scale, v_scale, block_tables):
    name = "flash_decode_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32) or q.dim() != 4:
        raise ValueError(f"{name}: the CUDA kernel takes a 4-D bfloat16 or float32 q, got {q.dtype}")
    quant = k_scale is not None
    if (v_scale is not None) != quant:
        raise ValueError(f"{name}: an int8 cache needs both k_scale and v_scale")
    want = torch.int8 if quant else q.dtype
    for t in (k_cache, v_cache):
        if t.dtype != want or t.dim() != 4 or t.device != q.device:
            raise ValueError(
                f"{name}: the CUDA kernel takes a 4-D {want} cache on q's device "
                f"({'int8 with scales' if quant else 'in q dtype'}), got {t.dtype}"
            )
    d = q.shape[3]
    if d not in (64, 128):
        raise ValueError(f"{name}: the CUDA kernel takes head_dim 64 or 128, got {d}")
    if k_cache.shape != v_cache.shape or k_cache.shape[3] != d:
        raise ValueError(f"{name}: k/v shape {tuple(k_cache.shape)} does not fit q {tuple(q.shape)}")
    for t in (k_cache, v_cache):
        # the kernel loads each cache row as 16-byte vectors
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(b % 16 for b in _byte_strides(t)):
            raise ValueError(
                f"{name}: the CUDA kernel takes k/v with unit stride in head_dim and "
                f"16-byte aligned rows, got strides {t.stride()}"
            )
    if q.shape[1] % k_cache.shape[1]:
        raise ValueError(f"{name}: {q.shape[1]} q heads not a multiple of {k_cache.shape[1]} kv heads")
    if block_tables is None and k_cache.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: a dense cache holds {k_cache.shape[0]} rows, q {q.shape[0]}")
    if quant:
        for t in (k_scale, v_scale):
            if (tuple(t.shape) != tuple(k_cache.shape[:3]) or t.device != q.device
                    or t.dtype != torch.float32):
                raise ValueError(
                    f"{name}: scales must be float32 {tuple(k_cache.shape[:3])} on q's "
                    f"device, got {t.dtype} {tuple(t.shape)}"
                )
    if block_tables is not None:
        cap = max_paged_block_size(k_cache.shape[1], d, k_cache.element_size())
        if k_cache.shape[2] > cap:
            raise ValueError(
                f"{name}: paged block size {k_cache.shape[2]} exceeds the kernel's "
                f"limit {cap} for {k_cache.shape[1]} kv heads x head_dim {d}"
            )
        if (block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0]
                or block_tables.dtype not in (torch.int32, torch.int64)):
            raise ValueError(
                f"{name}: block tables must be int32 or int64 [B, max_blocks] for q "
                f"{tuple(q.shape)}, got {block_tables.dtype} {tuple(block_tables.shape)}"
            )


_DECODE_ARGTYPES = (
    [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
    + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
_entry_points = {}  # loaded library -> its two C entry points, typed once


def _decode_entry_points():
    lib = _build.load("flash_decode.cu")
    fns = _entry_points.get(lib)
    if fns is None:
        splits, fn = lib.llark_flash_decode_splits, lib.llark_flash_decode
        splits.argtypes, splits.restype = [ctypes.c_int], ctypes.c_int
        fn.argtypes, fn.restype = _DECODE_ARGTYPES, ctypes.c_int
        fns = _entry_points[lib] = (splits, fn)
    return fns


def _flash_decode_cuda(q, k_cache, v_cache, *, kv_lengths, q_positions, k_scale, v_scale,
                       slopes, block_tables):
    _check_decode_inputs(q, k_cache, v_cache, k_scale, v_scale, block_tables)
    b, h, sq, d = q.shape
    hkv = k_cache.shape[1]
    if (q.stride(-1) != 1 or q.data_ptr() % 16
            or any(st * q.element_size() % 16 for st in q.stride()[:3])):
        q = q.contiguous()  # the kernel copies whole 16-byte chunks of q's rows
    dev = q.device
    kvl = kv_lengths.to(device=dev, dtype=torch.int32).reshape(b).contiguous()
    if q_positions is None:
        q_positions = kvl - 1
    qpos = torch.as_tensor(q_positions, device=dev).to(torch.int32).reshape(-1).expand(b).contiguous()
    sl = None if slopes is None else slopes.to(device=dev, dtype=torch.float32).reshape(h).contiguous()
    tables = None
    bs, max_blocks, n_pool = 0, 0, 0
    s_len = k_cache.shape[2]
    if block_tables is not None:
        tables = block_tables.to(device=dev, dtype=torch.int32).contiguous()
        bs, max_blocks, n_pool = k_cache.shape[2], tables.shape[1], k_cache.shape[0]
        s_len = bs * max_blocks  # the logical cache length the splits cover
    strides = _byte_strides(k_cache) + _byte_strides(v_cache)
    if k_scale is not None:
        strides += _byte_strides(k_scale) + _byte_strides(v_scale)
    else:
        strides += [0] * 6
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=dev)
    if out.numel() == 0 or s_len == 0:
        return out.zero_()
    splits, fn = _decode_entry_points()
    n_splits = splits(s_len)
    part_acc = torch.empty((b, h, sq, n_splits, d), dtype=torch.float32, device=dev)
    part_m = torch.empty((b, h, sq, n_splits), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        _ptr(tables), kvl.data_ptr(), qpos.data_ptr(), _ptr(sl), part_acc.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), out.data_ptr(), b, h, hkv, sq, s_len, d, bs,
        max_blocks, n_pool, (ctypes.c_longlong * 15)(*q.stride()[:3], *strides),
        1.0 / math.sqrt(d), int(q.dtype == torch.float32), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "llark_flash_decode")
    flash_decode_attention.launches += 1
    cache = "int8" if k_scale is not None else ("fp32" if q.dtype == torch.float32 else "bf16")
    mode = ("paged_" if tables is not None else "dense_") + cache
    window = flash_decode_attention.launches_by_window
    window[(mode, sq)] = window.get((mode, sq), 0) + 1
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
    position. CUDA tensors launch `csrc/flash_decode.cu` (bf16 or fp32 q,
    head_dim 64 or 128; a cache in q's dtype, or an int8 one with scales;
    dense, or a pool with block tables; unit stride in head_dim and 16-byte
    aligned cache rows; the output in q's dtype); CPU tensors run the plain
    version. The kernel clamps live
    lengths to the cache length and clips block ids into the pool, as the
    JAX gather clips; the plain version raises on an id outside the pool.
    `flash_decode_attention.launches` counts kernel launches and
    `.launches_by_mode` splits them by cache mode ("dense_bf16",
    "dense_int8", "paged_bf16", "paged_int8", and "dense_fp32",
    "paged_fp32" for an fp32 cache), summed from `.launches_by_window`,
    which splits them by (cache mode, Sq), so that a speculative verify
    window's launches count apart from single-query steps'."""
    if q.device.type == "cpu":
        return _flash_decode_plain(
            q, k_cache, v_cache, kv_lengths=kv_lengths, q_positions=q_positions,
            k_scale=k_scale, v_scale=v_scale, slopes=slopes, block_tables=block_tables,
        )
    return _flash_decode_cuda(
        q, k_cache, v_cache, kv_lengths=kv_lengths, q_positions=q_positions,
        k_scale=k_scale, v_scale=v_scale, slopes=slopes, block_tables=block_tables,
    )


_CACHE_MODES = ("dense_bf16", "dense_int8", "paged_bf16", "paged_int8", "dense_fp32", "paged_fp32")


class _LaunchesByMode(Mapping):
    """Cache mode -> launches, read from the (cache mode, Sq) counts."""

    def __getitem__(self, mode: str) -> int:
        if mode not in _CACHE_MODES:
            raise KeyError(mode)
        return sum(n for (m, _), n in flash_decode_attention.launches_by_window.items() if m == mode)

    def __iter__(self):
        return iter(_CACHE_MODES)

    def __len__(self) -> int:
        return len(_CACHE_MODES)


flash_decode_attention.launches = 0
flash_decode_attention.launches_by_window = {}  # (cache mode, Sq) -> launches
flash_decode_attention.launches_by_mode = _LaunchesByMode()


def reset_launch_counts() -> None:
    """Set the flash-decode kernel's launch counts (total, and by cache
    mode and Sq) to 0."""
    flash_decode_attention.launches = 0
    flash_decode_attention.launches_by_window.clear()


def flash_decode_kernel_takes(head_dim: int) -> bool:
    """Whether `csrc/flash_decode.cu` takes a query of this head_dim: 64 or
    128. Like the reference's routing condition
    (llark_tpu/ops/decode_attention.py:531) it looks at the shape alone:
    `decode_attention` sends a CUDA query outside it to `xla_attention`, and
    one inside it to the kernel, whose wrapper raises on a query other than
    bfloat16 or float32 or a cache other than in q's dtype or int8 with
    scales."""
    return head_dim in (64, 128)


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
    window of at most 32 tokens goes to `flash_decode_attention` if the
    query lies on the CPU or the kernel takes its head_dim
    (`flash_decode_kernel_takes`); otherwise the plain `xla_attention` path runs, after gathering a dense
    view of a paged pool."""
    b, h, sq, d = q.shape
    takes = q.device.type == "cpu" or flash_decode_kernel_takes(d)
    if use_pallas and sq <= 32 and takes:
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
