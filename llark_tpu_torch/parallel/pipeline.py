"""Pipeline parallelism: the decoder's stacked layers over a "pipe" mesh axis
(counterpart of llark_tpu/parallel/pipeline.py).

The stacked [L, ...] layer params split DIRECTLY over "pipe": stage s holds
layers [s*L/P, (s+1)*L/P) and runs them through the decoder's
`_layer_forward` (the flash forward kernel on the card, the flash backward
under autograd). Composes with data parallelism on a ("data", "pipe")
mesh: the batch splits over "data", and every (data, pipe) rank is one
process.

Schedule (GPipe): M microbatches through P stages take M + P - 1 ticks
(bubble (P-1)/(M+P-1)). At tick t stage s runs microbatch t - s: stage 0
on its embedded rows, the others on the activation received from the left
neighbour, and each sends its result to the right by point-to-point
send/recv. The last stage's outputs are the result, broadcast over "pipe"
(the JAX package's masked psum, :160-167).

The backward is an autograd pair across the ranks: a send's backward
receives the activation gradient from the right and a recv's backward
sends it back to the left. The train step runs it one microbatch at a time,
M-1 first, on every stage (`_pipeline` backward), so the point-to-point
calls of neighbouring stages meet in one order whatever the autograd
engine's own order within a call.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.models.decoder import (
    _layer_forward,
    _layer_slice,
    _norm,
    _rope_tables,
    compute_logits,
    torch_dtype,
)
from llark_tpu_torch.models.fusion import build_inputs_embeds, causal_lm_loss
from llark_tpu_torch.ops.attention import alibi_slopes
from llark_tpu_torch.parallel import comm
from llark_tpu_torch.parallel.mesh import P, _device_mesh, _layer_specs, axis_group, axis_rank, axis_size
from llark_tpu_torch.train.state import TrainState, iter_leaves, trainable_leaves

DATA_AXIS = "data"
PIPE_AXIS = "pipe"


def make_pp_mesh(n_data: int, n_pipe: int, device: str = "cuda"):
    """A ("data", "pipe") DeviceMesh over the default group's ranks, "pipe"
    the minor axis (neighbouring stages are neighbouring ranks)."""
    from llark_tpu_torch.parallel.mesh import init_process_group

    init_process_group(device, world_size=n_data * n_pipe)
    world = torch.distributed.get_world_size()
    if n_data * n_pipe != world:
        raise ValueError(f"mesh {n_data}x{n_pipe} does not match {world} devices")
    return _device_mesh((n_data, n_pipe), (DATA_AXIS, PIPE_AXIS))


def pp_param_specs(cfg: ModelConfig, multimodal: bool = True) -> Dict[str, Any]:
    """Specs: stacked layer arrays over "pipe" (dim 0 = L); embed, head,
    norms and projector whole on every rank."""
    specs: Dict[str, Any] = {
        "embed": P(),
        "layers": {name: P(PIPE_AXIS) for name in _layer_specs(cfg)},
        "final_norm_scale": P(),
    }
    if cfg.norm_type == "layernorm":
        specs["final_norm_bias"] = P()
    if not cfg.tie_embeddings:
        specs["lm_head"] = P()
    if multimodal:
        specs["mm_projector"] = {"kernel": P(), "bias": P()}
    return specs


def _peer(mesh, offset: int) -> int:
    """Global rank of the stage `offset` to the right of this one, in this
    rank's data row."""
    d, p = axis_rank(mesh, DATA_AXIS), axis_rank(mesh, PIPE_AXIS)
    return int(mesh.mesh[d, p + offset])


class _Send(torch.autograd.Function):
    """Forward: send x to `dst`; returns a scalar, the root of this
    microbatch's backward. Backward: receive x's gradient from `dst`."""

    @staticmethod
    def forward(ctx, x, dst, group):
        comm.send(x, dst, group)
        ctx.dst, ctx.group = dst, group
        ctx.like = (x.shape, x.dtype, x.device)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.like
        like = torch.empty(shape, dtype=dtype, device=device)
        return comm.recv(like, ctx.dst, ctx.group), None, None


class _Recv(torch.autograd.Function):
    """Forward: receive a tensor like `like` from `src` (`anchor`, a scalar
    that requires grad, puts the call in the graph). Backward: send the
    gradient back to `src`."""

    @staticmethod
    def forward(ctx, anchor, like, src, group):
        ctx.src, ctx.group = src, group
        return comm.recv(like, src, group)

    @staticmethod
    def backward(ctx, g):
        comm.send(g, ctx.src, ctx.group)
        return torch.zeros((), device=g.device), None, None, None


class _Run:
    """One pipelined forward on this stage: per microbatch the root of its
    backward (the send's scalar, or on the last stage its output) and the
    anchor its recv hangs on."""

    def __init__(self):
        self.roots, self.anchors, self.outs = [], [], []


def _pipeline(cfg: ModelConfig, mesh, n_microbatches: int):
    n_pipe = axis_size(mesh, PIPE_AXIS)
    M = n_microbatches
    if cfg.num_layers % n_pipe:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by pipe={n_pipe}")
    stage = axis_rank(mesh, PIPE_AXIS)
    group = axis_group(mesh, PIPE_AXIS)
    last = stage == n_pipe - 1

    def stage_stack(layers, h, pos, lens):
        rope = None if cfg.use_alibi else _rope_tables(pos, cfg.head_dim, cfg.rope_theta)
        slopes = alibi_slopes(cfg.num_heads, device=h.device) if cfg.use_alibi else None
        for l in range(cfg.num_layers // n_pipe):
            lp = {name: _layer_slice(w, l) for name, w in layers.items()}
            args = (cfg, lp, h, rope, lens, slopes, None, None)
            if cfg.remat and torch.is_grad_enabled():
                h, _ = torch.utils.checkpoint.checkpoint(_layer_forward, *args,
                                                         use_reentrant=False)
            else:
                h, _ = _layer_forward(*args)
        return h

    def forward(layers, x, positions, seq_lengths) -> Tuple[torch.Tensor, _Run]:
        """x [B, S, H] this rank's rows -> (hidden [B, S, H], the same on
        every stage, detached; the run for `backward`)."""
        bl, s, hdim = x.shape
        if bl % M:
            raise ValueError(f"per-data-shard batch {bl} not divisible by {M} microbatches")
        mb = bl // M
        like = torch.empty((mb, s, hdim), dtype=x.dtype, device=x.device)
        run = _Run()
        for t in range(M + n_pipe - 1):
            m = t - stage  # this stage's microbatch this tick
            if not 0 <= m < M:
                continue
            rows = slice(m * mb, (m + 1) * mb)
            if stage == 0:
                inp = x[rows]
            else:
                anchor = torch.zeros((), device=x.device, requires_grad=torch.is_grad_enabled())
                run.anchors.append(anchor)
                inp = _Recv.apply(anchor, like, _peer(mesh, -1), group)
            h = stage_stack(layers, inp, positions[rows], seq_lengths[rows])
            if last:
                run.outs.append(h)
                run.roots.append(h)
            else:
                run.roots.append(_Send.apply(h, _peer(mesh, 1), group))
        out = torch.cat(run.outs).detach() if last else torch.empty_like(x)
        src = int(mesh.mesh[axis_rank(mesh, DATA_AXIS), n_pipe - 1])
        return comm.broadcast(out, src, group), run

    def backward(run: _Run, d_hidden: torch.Tensor, leaves, x: Optional[torch.Tensor]):
        """The GPipe backward, microbatch M-1 first on every stage: each
        microbatch's root is differentiated (the last stage's with its rows
        of d_hidden); the recv's and send's backwards carry the activation
        gradients between the stages. -> (gradients of `leaves`, of x)."""
        mb = d_hidden.shape[0] // M
        grads = [torch.zeros_like(p) for p in leaves]
        wrt = list(leaves) + ([x] if x is not None else [])
        for m in reversed(range(M)):
            seed = (d_hidden[m * mb:(m + 1) * mb] if last
                    else torch.zeros((), device=d_hidden.device))
            inputs = wrt + ([run.anchors[m]] if stage > 0 else [])
            got = torch.autograd.grad(run.roots[m], inputs, grad_outputs=seed,
                                      allow_unused=True, materialize_grads=True)
            grads = [a + b for a, b in zip(grads, got[:len(leaves)])]
            if x is not None:
                dx = got[len(leaves)] if m == M - 1 else dx + got[len(leaves)]
        return grads, (dx if x is not None else None)

    return forward, backward, group


def make_pipeline_layers_fn(
    cfg: ModelConfig,
    mesh,
    n_microbatches: int,
) -> Callable[[Any, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """(this stage's stacked layers [L/P, ...], x [B, S, H], positions
    [B, S], seq_lengths [B]) -> hidden [B, S, H] on every stage: the
    decoder's layer stack pipelined over "pipe" (forward only; the
    gradients come through make_pp_train_step). x, positions and
    seq_lengths are this rank's rows (the batch splits over "data")."""
    forward, _, _ = _pipeline(cfg, mesh, n_microbatches)

    def pipelined(layers, x, positions, seq_lengths):
        with torch.no_grad():
            return forward(layers, x, positions, seq_lengths)[0]

    return pipelined


def make_pp_train_step(
    cfg: ModelConfig,
    optimizer,
    mesh,
    *,
    n_microbatches: int,
    audio_patch_id: int,
    trainable_token_start: Optional[int] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, Any]]]:
    """The multimodal train step with the layer stack pipelined
    (llark_tpu/parallel/pipeline.py:183-243). Embedding, splice, final norm
    and LM head run on every rank of the pipe (a sliver of the FLOPs); the
    batch contract is train/step.py's, this rank's rows of it (batch split
    over "data"). The state's params are this rank's: its stage's layers
    (`pp_param_specs`) and the rest whole.

    Backward: the head's on every stage from the same hidden, then the
    GPipe backward of the layer stack, then stage 0's input gradient,
    summed over the pipe (the other stages' are zero), through the
    embedding on every rank, so the replicated leaves' gradients are whole
    and equal on every stage. The loss is the mean over the global batch's
    tokens, the gradients are summed over "data", and the norm that clips
    them counts each stage's layers once."""
    forward, backward, pipe = _pipeline(cfg, mesh, n_microbatches)
    data = axis_group(mesh, DATA_AXIS)
    sizes = {DATA_AXIS: axis_size(mesh, DATA_AXIS), PIPE_AXIS: axis_size(mesh, PIPE_AXIS)}
    first = axis_rank(mesh, PIPE_AXIS) == 0

    def train_step(state: TrainState, batch):
        leaves = trainable_leaves(state.params)
        paths = [p for p, t in iter_leaves(state.params) if t.requires_grad]
        embeds = build_inputs_embeds(
            cfg, state.params, batch["input_ids"], batch.get("audio_encodings"), audio_patch_id,
            batch.get("audio_frame_counts"), trainable_token_start,
        )
        x = embeds.to(torch_dtype(cfg.dtype))
        b, s, _ = x.shape
        x_in = x.detach().requires_grad_(x.requires_grad)
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        hidden, run = forward(state.params["layers"], x_in, positions, batch["seq_lengths"])
        hidden = hidden.requires_grad_()
        normed = _norm(cfg, hidden, state.params["final_norm_scale"],
                       state.params.get("final_norm_bias"))
        logits = compute_logits(cfg, state.params, normed, trainable_token_start)
        loss, n_tok = causal_lm_loss(logits, batch["labels"])
        n_glob = comm.all_reduce_int(n_tok, data)
        share = loss * n_tok / n_glob.clamp_min(1)
        *grads, d_hidden = torch.autograd.grad(share, leaves + [hidden], allow_unused=True,
                                               materialize_grads=True)
        layer_grads, dx = backward(run, d_hidden, leaves, x_in if first and x.requires_grad else None)
        grads = [a + b for a, b in zip(grads, layer_grads)]
        if x.requires_grad:
            dx = comm.all_reduce_fp32(dx if dx is not None else torch.zeros_like(x), pipe)
            emb = torch.autograd.grad(x, leaves, grad_outputs=dx, allow_unused=True,
                                      materialize_grads=True)
            grads = [a + b for a, b in zip(grads, emb)]
        grads = [comm.all_reduce_fp32(g, data) for g in grads]
        sq = None
        for path, g in zip(paths, grads):
            copies = sizes[DATA_AXIS] * (1 if path.startswith("layers/") else sizes[PIPE_AXIS])
            term = g.float().square().sum() / copies
            sq = term if sq is None else sq + term
        norm = torch.sqrt(comm.all_reduce_fp32(sq, comm.world()))
        grad_norm = optimizer.update(grads, state.opt_state, leaves, norm)
        state.step += 1
        metrics = {"loss": comm.all_reduce_fp32(share.detach(), data), "num_tokens": n_glob,
                   "grad_norm": grad_norm}
        return state, metrics

    return train_step


def pp_shard_params(mesh, cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's params under pp_param_specs: its stage's layers."""
    from llark_tpu_torch.parallel.mesh import shard_params

    return shard_params(mesh, params, pp_param_specs(cfg, "mm_projector" in params))

