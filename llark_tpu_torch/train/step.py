"""Optimizer, learning-rate schedule and train/eval steps (counterpart of
llark_tpu/train/step.py).

  * lr_schedule: HF lr_scheduler_type semantics with optax's formulas
    (warmup to peak, then cosine or linear decay to 0, or constant);
  * trainable_mask / ParamPartition: which tensors train (reference
    m2t/train.py:79-106,143-164); the port marks them with requires_grad;
  * AdamW (make_optimizer): optax.chain(clip_by_global_norm(1.0),
    adamw(schedule, 0.9, 0.999, 1e-8, weight_decay)) with optax's
    arithmetic, on the trainable tensors only, in place;
  * make_train_step: gradient accumulation as the mean of the micro-batch
    gradients, then one optimizer update, LoRA dropout seeded per step and
    micro-batch; a MoE config adds moe_aux_loss_weight x the load-balancing
    loss to the loss and reports it and the dropped fraction; make_eval_step:
    loss sums.

On a sharded config (`parallel/mesh.py` `local_config`) the step runs on
this rank's rows and shards: the loss is normalised by the global token
count, the gradients summed over the batch shards, and the norm that clips
them taken over every shard, so loss, norm and update equal the
single-device step's.
"""

from __future__ import annotations

import contextvars
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from llark_tpu_torch.config import ModelConfig, TrainingArguments
from llark_tpu_torch.graphs import (
    Counts,
    GraphPool,
    add_launch_counts,
    capture,
    count_difference,
    launch_counts,
    launches_by_name,
)
from llark_tpu_torch.models.decoder import DropoutDraws, fold_seed
from llark_tpu_torch.models.fusion import causal_lm_loss, chunked_causal_lm_loss, llark_forward
from llark_tpu_torch.parallel import comm
from llark_tpu_torch.train.state import TrainState, iter_leaves, trainable_leaves

Batch = Dict[str, torch.Tensor]


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over `steps`, then held."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with alpha 0."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        return init * 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))

    return schedule


def _join(first: Callable, second: Callable, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules with one boundary."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def lr_schedule(args: TrainingArguments) -> Callable[[int], float]:
    """Learning rate at optimizer step `count` (0 for the first update):
    cosine/linear warm up to the peak and decay to 0; 'constant' and
    'constant_with_warmup' hold the peak (llark_tpu/train/step.py:29-62)."""
    lr = args.learning_rate
    warmup = max(1, int(args.max_steps * args.warmup_ratio))
    decay = max(args.max_steps - warmup, 1)
    kind = args.lr_scheduler_type
    if kind == "cosine":
        # optax.warmup_cosine_decay_schedule(0, lr, warmup, max(max_steps, warmup + 1))
        total = max(args.max_steps, warmup + 1)
        return _join(_linear(0.0, lr, warmup), _cosine(lr, total - warmup), warmup)
    if kind == "linear":
        return _join(_linear(0.0, lr, warmup), _linear(lr, 0.0, decay), warmup)
    if kind in ("constant", "constant_with_warmup"):
        w = warmup if kind == "constant_with_warmup" else 1
        return _join(_linear(0.0, lr, w), lambda count: lr, w)
    raise ValueError(
        f"unknown lr_scheduler_type {kind!r}; "
        "use cosine | linear | constant | constant_with_warmup"
    )


def trainable_mask(
    params: Dict[str, Any],
    *,
    freeze_backbone: bool = False,
    tune_mm_mlp_adapter: bool = False,
    lora: bool = False,
    freeze_mm_mlp_adapter: bool = False,
) -> Dict[str, Any]:
    """True = trainable, in the params' nested-dict shape
    (llark_tpu/train/step.py:65-103). Adapter stage (frozen backbone + tune
    flag): the projector and the embedding table (new-token rows gated in
    the model by trainable_token_start). LoRA stage: the low-rank factors
    of the layer tree, the projector and the embedding table (the
    reference's adapter + non_lora_trainables split, m2t/train.py:264-273).
    freeze_backbone alone: the projector only. None of these: everything.
    freeze_mm_mlp_adapter pins the projector."""

    def mark(value, trainable):
        if isinstance(value, dict):
            return {k: mark(v, trainable) for k, v in value.items()}
        return trainable

    def entry(name, value):
        if name == "mm_projector":
            return mark(value, not freeze_mm_mlp_adapter)
        if lora:
            if name == "layers":
                return {k: mark(v, "_lora_" in k) for k, v in value.items()}
            return mark(value, name == "embed")
        if tune_mm_mlp_adapter:
            return mark(value, name == "embed")
        return mark(value, not freeze_backbone)

    return {name: entry(name, value) for name, value in params.items()}


class ParamPartition:
    """The split of a params tree into the tensors that train and those
    that stay frozen (llark_tpu/train/step.py:106-131). The port keeps it on
    the tensors themselves: `requires_grad` is set from the mask, so
    autograd computes gradients only for the trainable ones, and the train
    step and optimizer state cover them alone (`state.trainable_leaves`)."""

    def __init__(self, params: Dict[str, Any], mask: Dict[str, Any]):
        flags = dict(iter_leaves(mask))
        leaves = dict(iter_leaves(params))
        if flags.keys() != leaves.keys():
            raise ValueError("mask structure does not match params")
        for path, t in leaves.items():
            t.requires_grad_(bool(flags[path]))


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares, in fp32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class AdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, weight_decay)) on a list of tensors, updated in place:

      g   <- g                  if |g| < max_norm, else g / |g| * max_norm
      mu  <- b1 mu + (1 - b1) g;   nu <- b2 nu + (1 - b2) g^2;   t <- t + 1
      u   <- (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd * p
      p   <- p - lr(t - 1) u

    |g| is the global norm over all trainable tensors; eps is outside the
    square root; weight decay is decoupled (not scaled by the moments).

    The host values of an update, lr(t - 1) and the bias corrections, reach
    it as one fp32 device tensor (`scalars`) that the caller fills before
    the step, so a captured step replays with each step's values."""

    def __init__(self, schedule: Callable[[int], float], weight_decay: float = 0.0,
                 max_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, leaves: List[torch.Tensor]) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": [torch.zeros_like(p, requires_grad=False) for p in leaves],
            "nu": [torch.zeros_like(p, requires_grad=False) for p in leaves],
        }

    def scalars(self, count: int, device: Union[str, torch.device, None] = None) -> torch.Tensor:
        """[lr, bc1, bc2] of the update that follows `count` updates, fp32:
        lr(count) and the bias corrections 1 - b^(count + 1), computed in
        fp32 as optax computes them (1 - b2^t loses ~1e-5 of its value
        there at small t)."""
        t = count + 1
        bc1, bc2 = (float(1 - np.float32(b) ** t) for b in (self.b1, self.b2))
        return torch.tensor([self.schedule(count), bc1, bc2], dtype=torch.float32, device=device)

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               leaves: List[torch.Tensor], norm: Optional[torch.Tensor] = None,
               scalars: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply one step to `leaves` and `state` in place; returns the
        global norm of `grads` before clipping. `scalars` are this update's
        (`self.scalars(state["count"])`, on the leaves' device; made here
        when not given). On a mesh the caller passes the norm over every
        shard (`sharded_grad_norm`): the leaves and grads are this rank's
        shards, clipped and updated where they lie."""
        if norm is None:
            norm = global_norm(grads)
        if scalars is None:
            scalars = self.scalars(state["count"], leaves[0].device)
        lr, bc1, bc2 = scalars.unbind()
        keep = norm < self.max_norm
        for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
            g = torch.where(keep, g, g / norm.to(g.dtype) * self.max_norm)
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * g.square())
            # in fp32 (the scalars' dtype), rounded once to the leaf's
            u = (mu.float() / bc1) / (torch.sqrt(nu.float() / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.sub_((lr * u).to(p.dtype))
        state["count"] += 1
        return norm


def sharded_loss_share(shard, loss: torch.Tensor, n_tok: torch.Tensor, moe: Dict[str, torch.Tensor]):
    """This rank's share of a micro-batch's loss on a mesh: its token-loss
    sum over the GLOBAL token count (an all-reduce over the batch shards),
    and its MoE metrics over the number of batch shards (they are means over
    rows). The shares' sum over the batch shards, and the sum of their
    gradients, are the single-device step's."""
    n_glob = shard.batch_sum(n_tok)
    share = loss * n_tok / n_glob.clamp_min(1)
    nb = shard.batch_shards()
    return share, n_glob, {k: v / nb for k, v in moe.items()}


def sync_grads(shard, paths: List[str], grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum each gradient over the batch shards that computed terms of it:
    over "data" always, and over "fsdp" for a leaf the "fsdp" axis does not
    split (a split leaf got its sum from the reduce-scatter of its gather).
    Over "tensor" and "expert" the replicated leaves' gradients are whole
    and equal already (`parallel/comm.py` copy_to / reduce_sum)."""
    out = []
    for path, g in zip(paths, grads):
        axes = set(shard.flat_specs[path])
        g = comm.all_reduce_fp32(g, shard.group("data"))
        if "fsdp" not in axes:
            g = comm.all_reduce_fp32(g, shard.group("fsdp"))
        out.append(g)
    return out


def sharded_grad_norm(shard, paths: List[str], grads: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm over the whole of every leaf: each rank's square
    sums, a replicated leaf's divided by its number of copies, summed over
    every rank."""
    sizes = {axis: shard.size(axis) for axis in ("data", "fsdp", "tensor", "expert")}
    total = None
    for path, g in zip(paths, grads):
        axes = set(shard.flat_specs[path])
        copies = int(np.prod([n for axis, n in sizes.items() if axis not in axes]))
        sq = g.float().square().sum() / copies
        total = sq if total is None else total + sq
    return torch.sqrt(comm.all_reduce_fp32(total, comm.world()))


def make_optimizer(args: TrainingArguments) -> AdamW:
    """The JAX package's optimizer (llark_tpu/train/step.py:134-166). It
    needs no params tree: the trainable set is carried by the tensors'
    requires_grad flags."""
    return AdamW(lr_schedule(args), weight_decay=args.weight_decay)


def _split(batch: Batch, n: int) -> List[Batch]:
    """n micro-batches of consecutive rows (the JAX package's reshape to
    [n, B/n, ...])."""
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"batch of {rows} rows does not split into {n} micro-batches")
    m = rows // n
    return [{k: v[i * m : (i + 1) * m] for k, v in batch.items()} for i in range(n)]


def make_loss_fn(
    cfg: ModelConfig,
    *,
    audio_patch_id: int,
    trainable_token_start: Optional[int] = None,
    loss_chunk: Optional[int] = None,
) -> Callable[[Dict[str, Any], Batch], Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]]:
    """(params, batch[, dropout_seed]) -> (loss, number of valid tokens, MoE
    metrics); a dropout seed turns LoRA dropout on. The loss is the mean
    token loss. For a MoE config the metrics are {"moe_aux_loss" (the
    layers' summed load-balancing loss, still in the graph),
    "moe_dropped_frac"}, and the train step adds moe_aux_loss_weight x
    moe_aux_loss (`train_loss`); {} otherwise."""

    def loss_fn(params, micro, dropout_seed=None):
        out, extras = llark_forward(
            cfg, params, micro["input_ids"],
            audio_encodings=micro.get("audio_encodings"),
            audio_patch_id=audio_patch_id,
            audio_frame_counts=micro.get("audio_frame_counts"),
            seq_lengths=micro.get("seq_lengths"),
            trainable_token_start=trainable_token_start,
            return_hidden=loss_chunk is not None,
            dropout_seed=dropout_seed,
        )
        if loss_chunk is not None:
            loss, n_tok = chunked_causal_lm_loss(
                cfg, params, out, micro["labels"], loss_chunk,
                trainable_token_start=trainable_token_start,
            )
        else:
            loss, n_tok = causal_lm_loss(out, micro["labels"])
        metrics = {}
        if cfg.moe_num_experts > 0:
            metrics = {k: extras[k] for k in ("moe_aux_loss", "moe_dropped_frac")}
        return loss, n_tok, metrics

    return loss_fn


def train_loss(cfg: ModelConfig, loss: torch.Tensor, moe: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The train step's loss (llark_tpu/train/step.py:214-221): the token
    loss plus moe_aux_loss_weight x the load-balancing loss of a MoE config."""
    if not moe:
        return loss
    return loss + cfg.moe_aux_loss_weight * moe["moe_aux_loss"]


def make_train_step(
    cfg: ModelConfig,
    optimizer: AdamW,
    *,
    audio_patch_id: int,
    grad_accum_steps: int = 1,
    trainable_token_start: Optional[int] = None,
    loss_chunk: Optional[int] = None,
    dropout_seed: Optional[int] = None,  # enables LoRA dropout when set
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the train step (llark_tpu/train/step.py:169-308).

    Batch contract (tensors on the params' device):
      input_ids          int   [B, S]
      labels             int   [B, S]
      seq_lengths        int   [B]
      audio_encodings    float [B, T, mm_hidden]
      audio_frame_counts int   [B]
    with B = grad_accum_steps * micro_batch. Gradients are taken for the
    params with requires_grad only; the step updates them and the optimizer
    state in place and returns the state with its step advanced, plus
    device-side metrics (loss, num_tokens, grad_norm before clipping; for a
    MoE config also moe_aux_loss and moe_dropped_frac, meaned over the
    micro-batches as the loss is).
    With `dropout_seed` and cfg.lora_dropout > 0, micro-batch i of the
    step at `state.step` draws its LoRA-dropout masks from `DropoutDraws`
    seeded with fold_seed(fold_seed(dropout_seed, step), i), as the JAX
    package folds its key (llark_tpu/train/step.py:224-268; the masks differ
    from JAX's).

    The step is two halves (`StepParts`):
      prepare(state) -> [lr, bc1, bc2] on the CPU (the update's
        `AdamW.scalars`), having seeded the micro-batches' dropout draws
        for state.step: the host's part;
      compute(state, batch, scalars) -> (state, metrics): the device's
        part, which reads nothing back to the host; it advances state.step
        and the optimizer's count on the host;
    and `generators(device)` lists the dropout generators compute draws
    from there. Called by itself the step runs both; called inside a
    `TrainProgram` (`jit_train_step`), even through a wrapper, it hands
    them to the program, which runs them apart."""
    loss_fn = make_loss_fn(
        cfg, audio_patch_id=audio_patch_id, trainable_token_start=trainable_token_start,
        loss_chunk=loss_chunk,
    )
    n_micro = max(grad_accum_steps, 1)
    use_dropout = dropout_seed is not None and cfg.lora_dropout > 0.0
    shard = getattr(cfg, "shard", None)
    draws_by_device: Dict[str, List[DropoutDraws]] = {}

    def draws(device) -> List[Optional[DropoutDraws]]:
        if not use_dropout:
            return [None] * n_micro
        key = str(torch.device(device))
        if key not in draws_by_device:
            draws_by_device[key] = [DropoutDraws(cfg.num_layers, device) for _ in range(n_micro)]
        return draws_by_device[key]

    def generators(device) -> List[torch.Generator]:
        return [gen for d in draws(device) if d is not None for gen in d.generators]

    def device_of(state: TrainState) -> torch.device:
        return next(iter_leaves(state.params))[1].device

    def prepare(state: TrainState) -> torch.Tensor:
        if use_dropout:
            step_seed = fold_seed(dropout_seed, state.step)
            for i, d in enumerate(draws(device_of(state))):
                d.seed(fold_seed(step_seed, i))
        return optimizer.scalars(state.opt_state["count"])

    def compute(state: TrainState, batch: Batch, scalars: torch.Tensor):
        leaves = trainable_leaves(state.params)
        micro_draws = draws(scalars.device)
        grads, loss_sum, tokens, moe_sums = None, 0.0, 0, {}
        for i, micro in enumerate(_split(batch, n_micro)):
            loss, n_tok, moe = loss_fn(state.params, micro, micro_draws[i])
            if shard is not None:
                loss, n_tok, moe = sharded_loss_share(shard, loss, n_tok, moe)
            loss = train_loss(cfg, loss, moe)
            # a leaf the loss does not reach (no audio in the batch) gets zeros
            g = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            grads = list(g) if grads is None else [a.add_(b) for a, b in zip(grads, g)]
            loss_sum = loss_sum + loss.detach()
            tokens = tokens + n_tok
            moe_sums = {k: moe_sums.get(k, 0.0) + v.detach() for k, v in moe.items()}
        if n_micro > 1:
            grads = [g / n_micro for g in grads]
        norm = None
        if shard is not None:
            paths = [p for p, t in iter_leaves(state.params) if t.requires_grad]
            grads = sync_grads(shard, paths, grads)
            norm = sharded_grad_norm(shard, paths, grads)
            loss_sum = shard.batch_sum(loss_sum)
            moe_sums = {k: shard.batch_sum(v) for k, v in moe_sums.items()}
        grad_norm = optimizer.update(grads, state.opt_state, leaves, norm, scalars)
        state.step += 1
        metrics = {"loss": loss_sum / n_micro, "num_tokens": tokens, "grad_norm": grad_norm,
                   **{k: v / n_micro for k, v in moe_sums.items()}}
        return state, metrics

    parts = StepParts(prepare, compute, generators, shard is not None)

    def train_step(state: TrainState, batch: Batch):
        program = _RUNNING.get()
        if program is not None:
            return program.run(parts, state, batch)
        return compute(state, batch, prepare(state).to(device_of(state)))

    train_step.sharded = shard is not None
    return train_step


class StepParts(NamedTuple):
    """A train step's host part, device part and dropout generators (see
    `make_train_step`)."""

    prepare: Callable
    compute: Callable
    generators: Callable
    sharded: bool


# the TrainProgram whose call is running: a train step called inside it
# hands its parts to it instead of running them
_RUNNING: contextvars.ContextVar = contextvars.ContextVar("train_program", default=None)


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a step reads or writes in place: the parameters and the
    optimizer's moments."""
    return ([t for _, t in iter_leaves(state.params)]
            + list(state.opt_state["mu"]) + list(state.opt_state["nu"]))


class TrainProgram:
    """A train step as one program (the reference's `jax.jit(train_step,
    donate_argnums=(0,))`, llark_tpu/train/train.py:368): called as
    (state, batch) -> (state, metrics), like the step it wraps, which may be
    a wrapper of `make_train_step`'s step that passes its arguments on.

    The program binds at its first call to the state's parameter and
    optimizer tensors and to the batch's keys, shapes and dtypes (batches
    are fixed-shape, `data/pipeline.py` `collate`); a later call with other
    tensors or shapes raises. The state is updated in place and returned
    with its step advanced. A call copies the batch into the program's
    static buffers and fills the step's scalars from the host: the
    update's lr and bias corrections (`AdamW.scalars`) and the dropout
    draws' seeds (`StepParts.prepare`). The metrics are the program's own
    buffers, valid until its next call.

    On the card the first call is step 1, run eagerly on the pool's stream
    (a real update: it also builds the kernels and the quantized products'
    split workspace outside the graph); then the step is captured, which
    runs no kernel: the capture's advance of the step, the optimizer's
    count and the launch counters is taken back. Every later call replays
    the graph, adds the launches it captured to the counters (`launches`)
    and advances the step and the count on the host. A capture that fails,
    that launches otherwise than the eager step or that allocates a
    workspace raises; nothing falls back to the eager step. The dropout
    generators are registered with the graph, so a replay draws the masks
    of the seeds set before it.

    On CPU tensors a call runs the eager step through the same buffers:
    the CPU tests exercise the binding, the buffers and the scalars."""

    def __init__(self, train_step: Callable):
        self.train_step = train_step
        self.pool: Optional[GraphPool] = None  # made at the first call on the card
        self._parts: Optional[StepParts] = None
        self._tensors: Optional[List[torch.Tensor]] = None
        self._batch: Optional[Batch] = None  # static inputs
        self._scalars: Optional[torch.Tensor] = None  # static [lr, bc1, bc2]
        self._stage = self._copied = None  # the card: pinned staging of the scalars
        self.metrics: Optional[Dict[str, torch.Tensor]] = None
        self._graph = None
        self._workspace = None  # the products' split workspace the graph writes
        self._captured: Optional[Counts] = None  # launches a replay adds
        self.calls = 0

    @property
    def launches(self) -> Dict[str, int]:
        """The launches one replay adds, by kernel wrapper; empty before
        the capture and on the CPU."""
        return {} if self._captured is None else launches_by_name(self._captured)

    def _bind(self, state: TrainState, batch: Batch) -> None:
        tensors = _state_tensors(state)
        if self._tensors is None:
            self._tensors = tensors
            self._batch = {k: torch.empty_like(v) for k, v in batch.items()}
            self._scalars = torch.zeros(3, dtype=torch.float32, device=tensors[0].device)
            return
        if len(tensors) != len(self._tensors) or any(
                a is not b for a, b in zip(tensors, self._tensors)):
            raise ValueError(
                "this train program was bound to another train state; a step updates the "
                "state's tensors in place, so pass the state it returned"
            )
        want = {k: (tuple(v.shape), v.dtype) for k, v in self._batch.items()}
        got = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
        if got != want:
            raise ValueError(f"this train program runs batches of {want}, got {got}")

    def __call__(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        self._bind(state, batch)
        for k, v in batch.items():
            self._batch[k].copy_(v)
        calls = self.calls
        token = _RUNNING.set(self)
        try:
            out = self.train_step(state, self._batch)
        finally:
            _RUNNING.reset(token)
        if self.calls == calls:
            raise TypeError("jit_train_step wraps a step of make_train_step (or a wrapper that "
                            "calls one)")
        return out

    def run(self, parts: StepParts, state: TrainState, batch: Batch):
        """A call's step, handed over by the step it wraps."""
        if parts.sharded:
            _refuse_sharded()
        if self._parts is None:
            self._parts = parts
        elif parts is not self._parts:
            raise ValueError("this train program was bound to another train step")
        if any(batch.get(k) is not v for k, v in self._batch.items()):
            raise ValueError("a wrapper of the train step must pass the batch it is given on")
        dev = self._scalars.device
        if self.calls == 0 and dev.type == "cuda":
            metrics = self._first_step(state, dev)
        elif self.calls == 0:
            state, metrics = parts.compute(state, batch, parts.prepare(state))
        elif dev.type == "cpu":
            self._fill(state)
            state, self.metrics = parts.compute(state, batch, self._scalars)
            metrics = self.metrics
        else:
            self._fill(state)
            self._graph.replay()
            add_launch_counts(self._captured)
            state.step += 1
            state.opt_state["count"] += 1
            metrics = self.metrics
        self.calls += 1
        return state, metrics

    def _fill(self, state: TrainState) -> None:
        host = self._parts.prepare(state)
        if self._scalars.device.type == "cpu":
            self._scalars.copy_(host)
            return
        if self._stage is None:
            self._stage = torch.empty(3, dtype=torch.float32, pin_memory=True)
            self._copied = torch.cuda.Event()
        self._copied.synchronize()  # the last copy out of the staging buffer ended
        self._stage.copy_(host)
        self._scalars.copy_(self._stage, non_blocking=True)
        self._copied.record()

    def _first_step(self, state: TrainState, dev: torch.device) -> Dict[str, torch.Tensor]:
        """Step 1 eagerly on the pool's stream, then the capture."""
        parts = self._parts
        pool = self.pool = GraphPool(dev)
        counts = launch_counts()
        pool.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(pool.stream):
            state, metrics = parts.compute(state, self._batch, parts.prepare(state).to(dev))
        torch.cuda.current_stream(dev).wait_stream(pool.stream)
        warm = count_difference(launch_counts(), counts)
        # kept: a later warm-up on this stream may replace a workspace it
        # outgrows, and the graph writes this one
        self._workspace = pool.workspace(dev)
        graph = torch.cuda.CUDAGraph()
        for gen in parts.generators(dev):
            graph.register_generator_state(gen)
        self._fill(state)
        step, count = state.step, state.opt_state["count"]
        try:
            self.metrics, self._captured = capture(
                pool, graph, dev, lambda: parts.compute(state, self._batch, self._scalars)[1],
                warm)
        finally:
            state.step, state.opt_state["count"] = step, count
        self._graph = graph
        return metrics


def jit_train_step(train_step: Callable, mesh=None, state_shardings=None,
                   batch_shardings=None) -> TrainProgram:
    """The train step as one program (llark_tpu/train/step.py:311-323): on
    the card a CUDA graph replayed at every step after the first
    (`TrainProgram`), as the reference jits it with its state donated. A
    sharded step stays eager: its gradient sums and norm
    (`sync_grads`, `sharded_grad_norm`) are gloo collectives, staged through
    the host, which a graph cannot hold; given a mesh or shardings, or a
    step of a sharded config, this raises."""
    if (mesh is not None or state_shardings is not None or batch_shardings is not None
            or getattr(train_step, "sharded", False)):
        _refuse_sharded()
    return TrainProgram(train_step)


def _refuse_sharded():
    raise ValueError(
        "a sharded train step runs eagerly: the gloo collectives of sync_grads and "
        "sharded_grad_norm cannot be captured in a CUDA graph; call the step itself"
    )


def make_eval_step(
    cfg: ModelConfig,
    *,
    audio_patch_id: int,
    loss_chunk: Optional[int] = None,
) -> Callable[[Dict[str, Any], Batch], Dict[str, torch.Tensor]]:
    """Loss-only forward over one batch (llark_tpu/train/step.py:326-357):
    summed loss * tokens and the token count, so a caller averages over
    batches exactly."""
    loss_fn = make_loss_fn(cfg, audio_patch_id=audio_patch_id, loss_chunk=loss_chunk)
    shard = getattr(cfg, "shard", None)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, n_tok, _ = loss_fn(params, batch)
        out = {"loss_sum": loss * n_tok, "num_tokens": n_tok}
        if shard is not None:  # summed over the batch shards
            out = {k: shard.batch_sum(v) for k, v in out.items()}
        return out

    return eval_step
