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

from typing import List, Optional, Sequence, Union

import torch

from llark_tpu_torch.graphs import GraphPool, Program, as_index, cache_tensors
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
def insert_blocks(paged_cache: Params, row_cache: Params, src_row: Union[int, torch.Tensor],
                  block_ids: Union[Sequence[int], torch.Tensor]) -> None:
    """Copy row `src_row` of a freshly prefilled dense cache
    ([L, B, Hkv, S(, D)] leaves) into the pool blocks `block_ids`, in place
    (llark_tpu/inference/paged.py:66-105, the paged counterpart of
    inference/server.py `insert_row`). The row's S positions are padded up to
    whole blocks; positions past the prompt hold pad values that are never
    read (reads stop at each row's live length) and decode overwrites them
    in order. The row and the block ids are ints or int64 device tensors (a
    program's static buffers, `graphs.as_index`)."""
    for key in CACHE_TENSORS:
        if key not in paged_cache or key not in row_cache:
            continue
        pool = paged_cache[key]  # [L, N, Hkv, bs(, D)]
        ids = as_index(block_ids, pool.device)
        row = row_cache[key].index_select(1, as_index(src_row, pool.device))[:, 0]
        bs, n = pool.shape[3], ids.shape[0]  # row: [L, Hkv, S(, D)]
        pad = n * bs - row.shape[2]
        if pad > 0:
            row = torch.cat([row, row.new_zeros(row.shape[:2] + (pad,) + row.shape[3:])], dim=2)
        row = row[:, :, : n * bs].reshape(row.shape[:2] + (n, bs) + row.shape[3:])
        pool.index_copy_(1, ids, row.transpose(1, 2).to(pool.dtype))


class BlockInsertProgram(Program):
    """`insert_blocks` as one program (llark_tpu/inference/paged.py:66-105,
    jitted with the pool donated at llark_tpu/inference/server.py:1033):
    (paged_cache, row_cache, src_row, block_ids [n_blocks]) -> paged_cache.
    Bound to the pool's tensors and the dense admission cache's; the source
    row and the block ids go into static device buffers, so one program
    serves every admitted row and slot."""

    what = "block insert"

    def __init__(self, block_size: int, n_blocks: int, pool: Optional[GraphPool] = None):
        super().__init__(pool)
        self.block_size, self.n_blocks = int(block_size), int(n_blocks)

    def plain(self, paged_cache: Params, row_cache: Params, src_row, block_ids) -> Params:
        insert_blocks(paged_cache, row_cache, src_row, block_ids)
        return paged_cache

    @torch.inference_mode()
    def __call__(self, paged_cache: Params, row_cache: Params, src_row: int,
                 block_ids: Union[Sequence[int], torch.Tensor]) -> Params:
        if len(block_ids) != self.n_blocks:
            raise ValueError(f"this block insert writes {self.n_blocks} blocks, got "
                             f"{len(block_ids)}")
        self.bind(cache=cache_tensors(paged_cache), rows=cache_tensors(row_cache))
        dev = paged_cache["k"].device
        x = self.stage(row=as_index(int(src_row), dev), blocks=as_index(block_ids, dev))

        def body():
            self.plain(self._bound["cache"], self._bound["rows"], x["row"], x["blocks"])
            return ()

        self.run(body, dev)
        return paged_cache


def make_block_insert_fn(block_size: int, n_blocks: int,
                         pool: Optional[GraphPool] = None) -> BlockInsertProgram:
    """The splice of one prefilled row into its pool blocks as one program
    (llark_tpu/inference/paged.py:66-105): see `BlockInsertProgram`."""
    return BlockInsertProgram(block_size, n_blocks, pool)
