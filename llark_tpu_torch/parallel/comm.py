"""The collectives of the mesh paths, explicit and autograd-aware.

JAX inserts collectives from PartitionSpecs (GSPMD); the port runs one
process per rank and calls them itself. Every call here takes a process
group (one axis of the mesh, `parallel/mesh.py`) and is a no-op on a group
of one rank, so a mesh of one runs exactly the single-device code.

The autograd pairs (Megatron's names in brackets):

  * `reduce_sum`      [g]: forward all-reduce, backward identity: after a
    row-parallel product (wo, w_down) whose output is replicated;
  * `copy_to`         [f]: forward identity, backward all-reduce: before
    a column-parallel product whose input is replicated;
  * `gather(dim, backward="sum")`: forward all-gather, backward reduce-
    scatter: FSDP's weight gather, whose ranks hold different batch rows;
  * `gather(dim, backward="split")`: forward all-gather, backward this
    rank's slice: the tensor-parallel logits gather, whose ranks compute
    the same loss.

Reductions run in fp32 and are cast back after ("the TP all-reduce of
bf16 partial products rounds differently from a single matmul").

Transport. NCCL takes CUDA tensors for every collective. Gloo takes CUDA
tensors for all-reduce and broadcast only; here only the fp32 all-reduce
goes to it directly, and every other collective and point-to-point call
(integer sums, broadcast, all-gather, send/recv) gets its CUDA tensors
staged through host memory (`staged`): a copy to the host, the
collective, a copy back. The compute stays on the card; a collective that
fails raises. Two ranks share the one card of a one-GPU host only over
gloo, since NCCL refuses two ranks on one device.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]

# the collectives gloo runs on CUDA tensors itself (the fp32 sums); the
# others are staged
GLOO_CUDA_DIRECT = ("all_reduce",)


def world() -> Group:
    """The default group (every rank), None when no group is up."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def group_size(group: Group) -> int:
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group: Group) -> int:
    if group is None or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def backend(group: Group = None) -> str:
    return dist.get_backend(group) if dist.is_initialized() else "none"


def staged(op: str, x: torch.Tensor, group: Group) -> bool:
    """Whether `op` on `x` goes through host memory: a CUDA tensor on a
    gloo group, for the collectives gloo does not take on CUDA."""
    return x.is_cuda and backend(group) == "gloo" and op not in GLOO_CUDA_DIRECT


def transport(group: Group = None) -> str:
    """How CUDA tensors travel on `group`, for the logs: 'nccl', or gloo
    with the staged collectives named."""
    b = backend(group)
    if b != "gloo":
        return b
    return ("gloo (CUDA direct: fp32 all_reduce; host-staged: integer all_reduce, "
            "broadcast, all_gather, send, recv)")


# ---------------------------------------------------------------------------
# Plain collectives (no autograd)
# ---------------------------------------------------------------------------


def all_reduce_fp32(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum of x over `group` in fp32, cast back to x's dtype; a new tensor."""
    if group_size(group) == 1:
        return x
    buf = torch.empty(x.shape, dtype=torch.float32, device=x.device).copy_(x)
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


def all_reduce_int(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum of an integer tensor over `group` in int64, cast back (staged
    through the host on gloo + CUDA)."""
    if group_size(group) == 1:
        return x
    buf = x.detach().to(torch.int64).clone()
    if staged("all_reduce_int", x, group):
        host = buf.cpu()
        dist.all_reduce(host, group=group)
        buf = host.to(x.device)
    else:
        dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


def all_gather_cat(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """The ranks' x concatenated along `dim`, in rank order."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    wire = _wire(x)
    src = wire.cpu() if staged("all_gather", x, group) else wire
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim).to(x.device)
    return out.view(x.dtype)


def broadcast(x: torch.Tensor, src: int, group: Group = None) -> torch.Tensor:
    """x from global rank `src` on every rank of `group` (a new tensor)."""
    if group_size(group) == 1:
        return x
    wire = _wire(x.contiguous())
    buf = wire.cpu() if staged("broadcast", x, group) else wire.clone()
    dist.broadcast(buf, src=src, group=group)
    return buf.to(x.device).view(x.dtype)


def broadcast_object(obj, src: int = 0, group: Group = None):
    """A picklable object from global rank `src` on every rank."""
    if group_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def all_gather_object(obj, group: Group = None) -> List:
    if group_size(group) == 1:
        return [obj]
    out = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def send(x: torch.Tensor, dst: int, group: Group = None) -> None:
    """Point-to-point send to global rank `dst` (staged on gloo + CUDA)."""
    wire = _wire(x.contiguous())
    dist.send(wire.cpu() if staged("send", x, group) else wire, dst=dst, group=group)


def recv(like: torch.Tensor, src: int, group: Group = None) -> torch.Tensor:
    """Receive a tensor shaped and typed like `like` from global rank `src`."""
    buf = _wire(torch.empty_like(like).contiguous())
    if staged("recv", like, group):
        host = buf.cpu()
        dist.recv(host, src=src, group=group)
        buf = host.to(like.device)
    else:
        dist.recv(buf, src=src, group=group)
    return buf.view(like.dtype)


def ring_shift(tensors: List[torch.Tensor], group: Group) -> List[torch.Tensor]:
    """Each rank's tensors to the next rank of `group` (in group order, the
    last to the first); returns the previous rank's. One batch of
    isend/irecv pairs (staged on gloo + CUDA)."""
    n = group_size(group)
    if n == 1:
        return tensors
    r = group_rank(group)
    nxt, prv = dist.get_global_rank(group, (r + 1) % n), dist.get_global_rank(group, (r - 1) % n)
    host = any(staged("send", t, group) for t in tensors)
    sends = [_wire(t.contiguous()) for t in tensors]
    sends = [t.cpu() for t in sends] if host else sends
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [b.to(t.device).view(t.dtype) for b, t in zip(recvs, tensors)]


def _wire(x: torch.Tensor) -> torch.Tensor:
    """x as the backends carry it: bool as uint8, the rest as it is (gloo
    and NCCL move float32/16, bfloat16 and the integer types bit for bit;
    gloo has no int16)."""
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _slice(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    n, r = group_size(group), group_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


# ---------------------------------------------------------------------------
# Autograd pairs
# ---------------------------------------------------------------------------


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_fp32(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, split_backward):
        ctx.dim, ctx.group, ctx.split = dim, group, split_backward
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if not ctx.split:
            g = all_reduce_fp32(g.contiguous(), ctx.group)
        return _slice(g, ctx.dim, ctx.group), None, None, None


def reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """[g] Sum of the ranks' partial x (fp32 reduce); gradient passes as is."""
    if group_size(group) == 1:
        return x
    return _ReduceSum.apply(x, group)


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    """[f] x unchanged; its gradient is summed over the group."""
    if group_size(group) == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyTo.apply(x, group)


def gather(x: torch.Tensor, dim: int, group: Group, backward: str = "sum") -> torch.Tensor:
    """All-gather along `dim`. backward "sum": reduce-scatter (the ranks
    hold different terms of the loss: FSDP); "split": this rank's slice of
    the gradient (the ranks compute the same loss: tensor parallelism)."""
    if group_size(group) == 1:
        return x
    if backward not in ("sum", "split"):
        raise ValueError(f"backward must be 'sum' or 'split', got {backward!r}")
    return _Gather.apply(x, dim, group, backward == "split")
