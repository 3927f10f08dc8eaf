"""Ring attention: exact attention over a sequence split across ranks
(sequence/context parallelism; counterpart of
llark_tpu/parallel/ring_attention.py).

LLark mean-pools Jukebox activations to 10 Hz because 345 Hz frames (~8200
audio tokens per 25 s clip) exceed one device's attention budget. With ring
attention the un-pooled sequence splits over a mesh axis: each rank holds
S/n queries and one K/V block, the blocks rotate around the ring
(`comm.ring_shift`, a batch of isend/irecv), and the partial results merge
with the running max / log-sum-exp rule: O(S/n) memory a rank, exact over
the whole sequence.

The block product is plain `torch.matmul` in fp32, as the JAX package's is
an XLA einsum outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from llark_tpu_torch.parallel import comm
from llark_tpu_torch.parallel.mesh import axis_group, axis_size

NEG = -1e30


def _block_attend(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H, Sk, D]
    v: torch.Tensor,
    q_pos: torch.Tensor,  # [Sq] global positions
    k_pos: torch.Tensor,  # [Sk]
    causal: bool,
    kv_lengths: Optional[torch.Tensor],  # [B] global valid length
    slopes: Optional[torch.Tensor],  # [H]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One (query block, kv block) pair -> (numerator, row max, row sum),
    fp32 (ring_attention.py:29-65)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if slopes is not None:
        rel = (k_pos[None, :] - q_pos[:, None]).float()
        logits = logits + slopes.float()[None, :, None, None] * rel[None, None]
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q.device)
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
    mask = mask[None, None].expand(logits.shape)
    if kv_lengths is not None:
        valid = k_pos[None, None, None, :] < kv_lengths.to(q.device)[:, None, None, None]
        mask = mask & valid
    logits = torch.where(mask, logits, NEG)
    row_max = logits.amax(dim=-1)  # [B, H, Sq]
    p = torch.where(mask, torch.exp(logits - row_max[..., None]), 0.0)
    return torch.matmul(p, v.float()), row_max, p.sum(dim=-1)


def ring_attention_local(
    q: torch.Tensor,  # [B, H, S_local, D] this rank's queries
    k: torch.Tensor,  # [B, H, S_local, D] this rank's K block
    v: torch.Tensor,
    group,
    *,
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,  # [B] global
    slopes: Optional[torch.Tensor] = None,  # [H]
) -> torch.Tensor:
    """This rank's block of the output, its queries attending every K/V
    block as the blocks rotate around `group` (ring_attention.py:68-110)."""
    n, idx = comm.group_size(group), comm.group_rank(group)
    s_local = q.shape[2]
    ar = torch.arange(s_local, device=q.device)
    q_pos = idx * s_local + ar
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:3], -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for step in range(n):
        owner = (idx - step) % n  # whose block this rank holds now
        num, bm, bs = _block_attend(q, k_blk, v_blk, q_pos, owner * s_local + ar, causal,
                                    kv_lengths, slopes)
        new_m = torch.maximum(m, bm)
        # guard -inf - -inf (rows with nothing to attend yet)
        scale_old = torch.where(torch.isfinite(m), torch.exp(m - new_m), 0.0)
        scale_new = torch.where(torch.isfinite(bm), torch.exp(bm - new_m), 0.0)
        acc = acc * scale_old[..., None] + num * scale_new[..., None]
        l = l * scale_old + bs * scale_new
        m = new_m
        if step < n - 1:
            k_blk, v_blk = comm.ring_shift([k_blk, v_blk], group)
    return (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)


def ring_attention(
    q: torch.Tensor,  # [B, H, S, D] (global shapes, the same on every rank)
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis: str = "tensor",
    *,
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact attention with the sequence split over `axis` of the mesh
    (ring_attention.py:113-159): every rank passes the global q/k/v, keeps
    its S/n block, runs the ring, and gets the global output back (an
    all-gather over the axis). Equivalent to xla_attention(causal,
    kv_lengths, slopes) up to the order of fp32 accumulation."""
    n = axis_size(mesh, axis)
    if q.shape[2] % n:
        raise ValueError(f"sequence {q.shape[2]} must divide axis size {n}")
    group = axis_group(mesh, axis)
    s_local = q.shape[2] // n
    lo = comm.group_rank(group) * s_local
    out = ring_attention_local(
        *(t[:, :, lo:lo + s_local] for t in (q, k, v)), group,
        causal=causal, kv_lengths=kv_lengths, slopes=slopes,
    )
    return comm.all_gather_cat(out, 2, group)
