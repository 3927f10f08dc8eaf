"""Paged KV-cache management for the continuous-batching server
(counterpart of llark_tpu/inference/paged.py).

vLLM-style block paging: the caches are physical block POOLS
([L, N, Hkv, bs, D], models/decoder.py `init_paged_kv_cache`) shared by
every slot, a host-side allocator hands logical->physical block lists to
requests, and the per-row tables ride to the device inside the cache dict,
where the flash-decode kernel resolves them per cache position
(ops/decode_attention.py).

The dense server provisions max_batch x max_cache_len of cache memory
whether or not rows use it; paging sizes it to the live token budget, so
the same memory admits more concurrent slots. Allocation happens once per
admission (the block count covers prompt + max_new + headroom, known up
front) and freeing once per retirement; there is no copy-on-write or
swapping. Physical blocks 0..max_batch-1 are per-slot parking blocks
(never allocated): a slot's table resets there so parked writes stay
unique per row.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from llark_tpu_torch.models.decoder import CACHE_TENSORS, Params


class BlockAllocator:
    """Host-side free-list over physical block ids.

    Ids [0, num_reserved) are parking blocks and never handed out."""

    def __init__(self, num_blocks: int, num_reserved: int):
        if num_blocks <= num_reserved:
            raise ValueError(
                f"pool of {num_blocks} blocks leaves nothing to allocate "
                f"after {num_reserved} reserved parking blocks"
            )
        self.num_blocks = num_blocks
        self.num_reserved = num_reserved
        self._free: List[int] = list(range(num_reserved, num_blocks))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n physical blocks, or None if the pool can't serve it (the
        caller leaves the request queued until retirements free blocks)."""
        if n > len(self._free):
            return None
        out = self._free[:n]
        del self._free[:n]
        return out

    def free(self, ids: List[int]) -> None:
        self._free.extend(ids)


@torch.no_grad()
def insert_blocks(paged_cache: Params, row_cache: Params, src_row: int,
                  block_ids: Sequence[int]) -> None:
    """Copy row `src_row` of a freshly prefilled dense cache
    ([L, B, Hkv, S(, D)] leaves) into the pool blocks `block_ids`, in place
    (llark_tpu/inference/paged.py:66-105, the paged counterpart of
    BatchedServer._insert_row). The row's S positions are padded up to
    whole blocks; positions past the prompt hold pad values that are never
    read (reads stop at each row's live length) and decode overwrites them
    in order."""
    for key in CACHE_TENSORS:
        if key not in paged_cache or key not in row_cache:
            continue
        pool = paged_cache[key]  # [L, N, Hkv, bs(, D)]
        row = row_cache[key][:, src_row]  # [L, Hkv, S(, D)]
        bs, n = pool.shape[3], len(block_ids)
        pad = n * bs - row.shape[2]
        if pad > 0:
            row = torch.cat([row, row.new_zeros(row.shape[:2] + (pad,) + row.shape[3:])], dim=2)
        row = row[:, :, : n * bs].reshape(row.shape[:2] + (n, bs) + row.shape[3:])
        ids = torch.as_tensor(list(block_ids), dtype=torch.long, device=pool.device)
        pool[:, ids] = row.transpose(1, 2).to(pool.dtype)
