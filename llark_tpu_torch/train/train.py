"""Training entry point: `python -m llark_tpu_torch.train.train --flags...`
(counterpart of llark_tpu/train/train.py, the same flags).

Reference-parity orchestration (m2t/train.py:53-284):
  model select by name (mpt -> MPT else Llama) .......... :62-75
  freeze / adapter-tuning flags ......................... :79-106, 143-164
  tokenizer + audio special tokens ...................... :108-126, 176-182
  adapter (projector) init, optional pretrained load .... :128-137
  LoRA / QLoRA (a frozen int8 or int4 base) ............. :79-106
  sample-batch smoke test before training ............... :240-253
  auto-resume from existing checkpoints ................. :255-260
  periodic + final save (projector side-save) ........... trainer.py:35-65

One process a rank (the GPU unless the caller passes device="cpu"). A
`mesh_shape` larger than one device, or a run under `torchrun` (RANK,
WORLD_SIZE, MASTER_ADDR in the environment; `multihost` across nodes),
trains over a ("data", "fsdp", "tensor"[, "expert"]) mesh
(`parallel/mesh.py`): every rank builds the same full tree from the seed
and keeps its shards; each batch-shard rank reads its own split of the
data shards, a batch of per_device_train_batch_size x
gradient_accumulation_steps rows, so the global batch is that times
data x fsdp (`compute_global_batch`); the step normalises by the global
token count and clips by the norm over every shard (`train/step.py`).
Logging at INFO and metrics tracking happen on rank 0 only. Checkpoints
are gathered whole to rank 0 and written in the one-process format, so a
run saved on one mesh restores on another or on none.
A local HF checkpoint directory as `model_name_or_path` gives the
architecture (its config.json), the tokenizer (where `transformers` is
installed and the directory holds one) and the backbone weights
(`interop/hf.py`). With `lora_enable` the decoder's projections get
rank-`lora_r` factors that train with the projector and the embedding
table, and the run ends by writing `<output_dir>/adapter/` in the JAX
package's adapter format; `bits` 8 or 4 quantizes the frozen base on the
card (int8, or int4 in the rows layout of the int4 kernel, group
min(128, hidden)). A Mixtral directory, or `moe_num_experts` > 0, trains a
Mixture-of-Experts decoder (`models/moe.py`), its load-balancing loss
added to the loss and logged with the dropped fraction.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import signal
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from llark_tpu_torch.config import (
    DataArguments,
    ModelArguments,
    ModelConfig,
    TrainingArguments,
    parse_args,
    write_args_to_file,
)
from llark_tpu_torch.data.pipeline import make_data_module
from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.interop.hf import load_pretrained_backbone
from llark_tpu_torch.models.fusion import init_llark_params
from llark_tpu_torch.models.lora import init_lora_params, load_lora_adapter, save_lora_adapter
from llark_tpu_torch.models.quant import (
    quantize_params_int4_incremental,
    quantize_params_int8_incremental,
)
from llark_tpu_torch.models.utils import save_model_metadata
from llark_tpu_torch.parallel import comm
from llark_tpu_torch.parallel.mesh import (
    Shard,
    Sharding,
    batch_shard_index,
    batch_sharding,
    gather_param,
    gather_params,
    init_process_group,
    make_mesh,
    shard_model,
)
from llark_tpu_torch.special_tokens import IGNORE_INDEX
from llark_tpu_torch.tokenization import TokenizerBundle, WordTokenizer
from llark_tpu_torch.train.checkpoint import (
    CheckpointManager,
    apply_pretrained_projector,
    load_projector_weights,
)
from llark_tpu_torch.train.state import TrainState, iter_leaves
from llark_tpu_torch.train.step import (
    ParamPartition,
    jit_train_step,
    lr_schedule,
    make_eval_step,
    make_optimizer,
    make_train_step,
    trainable_mask,
)
from llark_tpu_torch.train.tracking import MetricsWriter

log = logging.getLogger("llark_tpu_torch.train")


def model_config_from_name(name: str, model_args: ModelArguments) -> ModelConfig:
    """Select the architecture by model name (reference: m2t/train.py:62-75).
    A local directory with a config.json takes its dims from that file, a
    Mixtral one its experts too (llark_tpu/train/train.py:57-113);
    `model_args.moe_*` make any of them MoE."""
    kw: Dict[str, Any] = {"mm_hidden_size": model_args.mm_hidden_size}
    if model_args.moe_num_experts:
        kw.update(moe_num_experts=model_args.moe_num_experts, moe_top_k=model_args.moe_top_k,
                  moe_capacity_factor=model_args.moe_capacity_factor)
    cfg_path = os.path.join(name, "config.json")
    if os.path.isdir(name) and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            hf = json.load(f)
        # Mixtral-style MoE dims from the checkpoint config
        if hf.get("num_local_experts") and "moe_num_experts" not in kw:
            kw.update(moe_num_experts=hf["num_local_experts"],
                      moe_top_k=hf.get("num_experts_per_tok", 2))
        if hf.get("model_type") == "mpt":
            return ModelConfig.mpt_1b(
                vocab_size=hf.get("vocab_size", 50368),
                hidden_size=hf.get("d_model", 2048),
                intermediate_size=hf.get("d_model", 2048) * hf.get("expansion_ratio", 4),
                num_layers=hf.get("n_layers", 24),
                num_heads=hf.get("n_heads", 16),
                num_kv_heads=hf.get("n_heads", 16),
                max_seq_len=hf.get("max_seq_len", 2048),
                **kw,
            )
        return ModelConfig(
            vocab_size=hf.get("vocab_size", 32000),
            hidden_size=hf.get("hidden_size", 4096),
            intermediate_size=hf.get("intermediate_size", 11008),
            num_layers=hf.get("num_hidden_layers", 32),
            num_heads=hf.get("num_attention_heads", 32),
            num_kv_heads=hf.get("num_key_value_heads", hf.get("num_attention_heads", 32)),
            max_seq_len=hf.get("max_position_embeddings", 2048),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            rope_theta=hf.get("rope_theta", 10000.0),
            **kw,
        )
    lname = name.lower()
    if "mpt" in lname:
        if "tiny" in lname:  # test-scale MPT: same arch family, tiny dims
            return ModelConfig.tiny(arch="mpt", **kw)
        return ModelConfig.mpt_1b(**kw)
    if "tiny" in lname:
        return ModelConfig.tiny(**kw)
    return ModelConfig.llama2_7b(**kw)


# files one of which a directory holding an HF tokenizer has
_TOKENIZER_FILES = ("tokenizer_config.json", "tokenizer.json", "tokenizer.model",
                    "spiece.model", "vocab.json", "vocab.txt")


def build_tokenizer(model_args: ModelArguments, training_args: TrainingArguments) -> TokenizerBundle:
    """Local-path HF tokenizer if available, WordTokenizer otherwise (no
    downloads; the reference used AutoTokenizer downloads,
    m2t/tokenizer.py:22-38). `transformers` is imported only here, and only
    for a directory that holds tokenizer files: from a directory without
    them, newer `transformers` releases build an empty tokenizer instead of
    raising. Without one, the word-level tokenizer, with a warning."""
    path = model_args.model_name_or_path
    if os.path.isdir(path):
        if any(os.path.exists(os.path.join(path, name)) for name in _TOKENIZER_FILES):
            try:
                from transformers import AutoTokenizer

                tok = AutoTokenizer.from_pretrained(path, use_fast=False, padding_side="right")
                return TokenizerBundle.from_tokenizer(tok, training_args.model_max_length)
            except Exception as e:  # noqa: BLE001 -- the reference's fallback
                log.warning("failed to load HF tokenizer from %s: %s", path, e)
        else:
            log.warning("no tokenizer files under %s: the word-level tokenizer", path)
    return TokenizerBundle.from_tokenizer(WordTokenizer(training_args.model_max_length))


def _check_slice(model_args: ModelArguments, training_args: TrainingArguments) -> None:
    """Raise, before any work, on the settings the JAX package refuses
    (llark_tpu/train/train.py:259-302)."""
    if training_args.lora_enable and training_args.lora_bias not in ("", "none"):
        raise NotImplementedError(
            "lora_bias != 'none' is not supported (our LoRA has no bias terms)"
        )
    if training_args.bits in (4, 8):
        # the quantized base is frozen (reference: bnb 4/8-bit,
        # m2t/arguments.py:112-133)
        if not (training_args.lora_enable or model_args.freeze_backbone
                or model_args.tune_mm_mlp_adapter):
            raise ValueError(f"--bits {training_args.bits} requires lora_enable"
                             " / freeze_backbone / tune_mm_mlp_adapter "
                             "(the quantized base is frozen)")
    elif training_args.bits != 16:
        raise ValueError(f"--bits {training_args.bits} unsupported (16/8/4)")


class PreemptionGuard:
    """SIGTERM/SIGINT -> finish the in-flight step, checkpoint, exit cleanly.
    Signal handlers run on the main thread between steps, so `triggered` is
    checked once per step."""

    def __init__(self, enabled: bool = True):
        self.triggered = False
        self._prev = {}
        if not enabled:
            return
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handler)
        except ValueError:  # not on the main thread (tests, notebooks)
            self._prev = {}

    def _handler(self, signum, frame):  # noqa: ARG002
        log.warning("received signal %d; will checkpoint and exit", signum)
        self.triggered = True

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


def smoke_test_batch(batch: Dict[str, np.ndarray]) -> None:
    """Log shapes/dtypes of one batch before training
    (reference: m2t/train.py:240-253)."""
    for k, v in batch.items():
        if hasattr(v, "shape"):
            log.info("smoke batch %s: shape=%s dtype=%s", k, v.shape, v.dtype)
    assert batch["input_ids"].ndim == 2
    assert batch["audio_encodings"].ndim == 3


def _pad_eval_batch(b: Dict[str, np.ndarray], target: int) -> Dict[str, np.ndarray]:
    """Pad a partial final eval batch to the fixed micro-batch shape. Pad
    rows carry labels=IGNORE_INDEX everywhere, so they add exactly 0 to both
    loss_sum and num_tokens."""
    n = next(iter(b.values())).shape[0]
    if n == target:
        return b
    return {
        k: np.pad(v, [(0, target - n)] + [(0, 0)] * (v.ndim - 1),
                  constant_values=(IGNORE_INDEX if k == "labels" else 0))
        for k, v in b.items()
    }


def compute_global_batch(training_args: TrainingArguments, mesh) -> int:
    """Rows per optimizer step (llark_tpu/train/train.py:182-191). The
    batch rides only the (data, fsdp) axes; counting "tensor" would inflate
    the effective batch by the TP factor."""
    n_batch_shards = 1 if mesh is None else batch_shard_index(mesh)[1]
    return (training_args.per_device_train_batch_size
            * max(training_args.gradient_accumulation_steps, 1) * n_batch_shards)


def _train_mesh(training_args: TrainingArguments, cfg: ModelConfig, dev: torch.device):
    """The run's mesh, or None for one process. The default shape puts every
    rank on "fsdp" (llark_tpu/train/train.py:230-232); a MoE config gets a
    trailing expert axis of 1 (:233-237)."""
    shape = tuple(training_args.mesh_shape)
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1 or (
        torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1)
    if not (training_args.multihost or launched or int(np.prod(shape)) > 1):
        return None
    if training_args.multihost and "WORLD_SIZE" not in os.environ \
            and not torch.distributed.is_initialized():
        # JAX: jax.distributed.initialize() from the TPU runtime
        raise ValueError("multihost training needs the torchrun environment (RANK, "
                         "WORLD_SIZE, MASTER_ADDR, MASTER_PORT) on every node")
    init_process_group(dev.type, world_size=max(int(np.prod(shape)), 1))
    if int(np.prod(shape)) <= 1:
        shape = (1, torch.distributed.get_world_size(), 1)
    if cfg.moe_num_experts > 0 and len(shape) == 3:
        shape = shape + (1,)
    mesh = make_mesh(shape, device=dev.type)
    if torch.distributed.get_rank() != 0:  # INFO on rank 0 only
        logging.getLogger("llark_tpu_torch").setLevel(logging.WARNING)
    log.info("mesh %s over %d ranks (%s)", dict(zip(mesh.mesh_dim_names, mesh.shape)),
             torch.distributed.get_world_size(), comm.transport())
    return mesh


def _gathered_state(shard: Shard, state: TrainState) -> TrainState:
    """The whole train state from every rank's shards (a collective)."""
    trained = [p for p, t in iter_leaves(state.params) if t.requires_grad]
    moments = {key: [gather_param(shard.mesh, m, shard.flat_specs[p])
                     for p, m in zip(trained, state.opt_state[key])] for key in ("mu", "nu")}
    return TrainState(gather_params(shard.mesh, state.params, shard.specs),
                      {"count": state.opt_state["count"], **moments}, state.step)


def train(
    model_args: ModelArguments,
    data_args: DataArguments,
    training_args: TrainingArguments,
    *,
    model_cfg: Optional[ModelConfig] = None,
    max_steps_override: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """Run training; returns a summary dict (for tests and callers)."""
    _check_slice(model_args, training_args)
    dev = resolve_device(device)
    write_args_to_file([model_args, data_args, training_args], training_args.output_dir)

    cfg = model_cfg or model_config_from_name(model_args.model_name_or_path, model_args)
    bundle = build_tokenizer(model_args, training_args)
    if cfg.vocab_size < len(bundle.tokenizer):
        cfg = dataclasses.replace(cfg, vocab_size=int(math.ceil(len(bundle.tokenizer) / 128) * 128))

    mesh = _train_mesh(training_args, cfg, dev)
    rank0 = mesh is None or torch.distributed.get_rank() == 0

    params = init_llark_params(cfg, seed=training_args.seed, device=dev)
    if os.path.isdir(model_args.model_name_or_path):
        # local HF checkpoint dir: import the backbone weights before the
        # optimizer sees them (reference: from_pretrained, m2t/train.py:62-75)
        try:
            params.update(load_pretrained_backbone(model_args.model_name_or_path, cfg, dev))
            log.info("imported HF backbone from %s", model_args.model_name_or_path)
        except FileNotFoundError:
            log.warning("no HF weights under %s; training from random init",
                        model_args.model_name_or_path)
    if model_args.pretrain_mm_mlp_adapter:
        apply_pretrained_projector(params, load_projector_weights(model_args.pretrain_mm_mlp_adapter))
    if training_args.lora_enable:
        cfg = dataclasses.replace(
            cfg, lora_rank=training_args.lora_r, lora_alpha=float(training_args.lora_alpha),
            lora_dropout=float(training_args.lora_dropout))
        gen = torch.Generator(device=dev)
        gen.manual_seed(training_args.seed + 1)
        params = init_lora_params(cfg, gen, params)
        if training_args.lora_weight_path:
            # warm-start factors from a saved adapter
            # (reference: m2t/llava/train/train.py:90)
            params, meta = load_lora_adapter(training_args.lora_weight_path, params)
            log.info("warm-started LoRA from %s (%s)", training_args.lora_weight_path, meta)
    if training_args.bits in (4, 8):
        if training_args.bits == 8:
            params = quantize_params_int8_incremental(cfg, params)
        else:
            # the rows layout, which the int4 kernel takes (the JAX trainer
            # packs cols, its XLA layout; ROADMAP.md Queue C); the group
            # divides every fan-in: 128 at production widths, the hidden
            # size below
            params = quantize_params_int4_incremental(
                cfg, params, group=min(128, cfg.hidden_size), layout="rows")
        log.info("quantized frozen base weights to int%d", training_args.bits)
    # written after every change of cfg (lora_*), so load_pretrained_model
    # rebuilds the architecture the run trains
    if rank0:
        save_model_metadata(training_args.output_dir, cfg, bundle)

    # Reference flag semantics (m2t/train.py:143-164): tune_mm_mlp_adapter
    # alone does NOT freeze the backbone -- the run of record sets tune=True
    # freeze=False and trains the full model, with the projector side-saved
    # and original embedding rows detached (trainable_token_start below).
    # Freezing comes from freeze_backbone, LoRA or a quantized base.
    if model_args.freeze_backbone or training_args.lora_enable or training_args.bits in (4, 8):
        mask = trainable_mask(
            params,
            freeze_backbone=model_args.freeze_backbone,
            tune_mm_mlp_adapter=model_args.tune_mm_mlp_adapter,
            lora=training_args.lora_enable,
            freeze_mm_mlp_adapter=training_args.freeze_mm_mlp_adapter,
        )
    else:
        mask = trainable_mask(params)  # every tensor trains
    global_cfg, shard = cfg, None
    if mesh is not None:
        # every rank built the same full tree: keep this rank's shards
        cfg, params = shard_model(mesh, cfg, params)
        shard = cfg.shard
    ParamPartition(params, mask)
    optimizer = make_optimizer(training_args)
    state = TrainState.create(params, optimizer)

    # trainable_token_start: only the 3 appended audio tokens' embedding rows
    # receive gradients during adapter tuning (reference llamav2.py:176-198)
    trainable_start = len(bundle.tokenizer) - 3 if model_args.tune_mm_mlp_adapter else None
    max_steps = max_steps_override or training_args.max_steps
    loss_chunk = training_args.loss_chunk or None
    train_step = make_train_step(
        cfg, optimizer, audio_patch_id=bundle.audio_patch_id,
        grad_accum_steps=training_args.gradient_accumulation_steps,
        trainable_token_start=trainable_start, loss_chunk=loss_chunk,
        dropout_seed=training_args.seed if training_args.lora_enable else None,
    )

    ckpt = CheckpointManager(
        training_args.output_dir,
        save_total_limit=training_args.save_total_limit,
        save_projector=model_args.tune_mm_mlp_adapter,
    )
    start_step = 0
    local = None
    if shard is not None:
        def local(path, t):
            return Sharding(mesh, shard.flat_specs[path]).local(t.to(dev), path)
    if training_args.resume:
        restored = ckpt.restore(state, local=local)
        if restored is not None:
            state, _ = restored
            start_step = state.step
            log.info("resumed from checkpoint at step %d", start_step)

    accum = max(training_args.gradient_accumulation_steps, 1)
    global_batch = compute_global_batch(training_args, mesh)
    # each batch shard reads its own split of the data shards
    # (data/shards.py split_by_host), a local batch of these rows
    local_batch = training_args.per_device_train_batch_size * accum
    data_module = make_data_module(
        bundle, data_args, batch_size=local_batch,
        max_seq_len=training_args.model_max_length, mm_hidden_size=cfg.mm_hidden_size,
        seed=training_args.seed,
    )
    # on resume, fast-forward the (deterministic, same-seed) stream so the
    # first start_step batches are not trained on again
    iterator = data_module["train_iterator"](skip_batches=start_step)
    # off a mesh the step is one program (the reference's jax.jit of it):
    # on the card step 1 runs eagerly and every later step replays one CUDA
    # graph; a mesh's gloo collectives keep the sharded step eager. Built
    # after the restore: it binds to the state's tensors at its first call
    step_fn = train_step if shard is not None else jit_train_step(train_step)

    def put(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
                if isinstance(v, np.ndarray)}

    eval_every = training_args.eval_steps if "eval_iterator" in data_module else 0
    if training_args.eval_steps and "eval_iterator" not in data_module:
        log.warning("--eval_steps %d set but no --eval_data_path given: no eval pass "
                    "will run", training_args.eval_steps)
    elif "eval_iterator" in data_module and not training_args.eval_steps:
        log.warning("--eval_data_path given but --eval_steps is 0: no eval pass will run")
    eval_fn = make_eval_step(cfg, audio_patch_id=bundle.audio_patch_id, loss_chunk=loss_chunk)
    # eval holds the micro-batch a training micro-step holds, no more; on a
    # mesh every rank reads the whole eval stream and takes its rows of each
    # global micro-batch
    eval_micro = max(global_batch // accum, 1)
    eval_rows = batch_sharding(mesh) if mesh is not None else (lambda x: x)

    def run_eval(params) -> float:
        total, tokens = 0.0, 0
        for eb in data_module["eval_iterator"]():
            arrays = {k: v for k, v in eb.items() if isinstance(v, np.ndarray)}
            n = next(iter(arrays.values())).shape[0]
            for lo in range(0, n, eval_micro):
                mb = {k: v[lo:lo + eval_micro] for k, v in arrays.items()}
                padded = _pad_eval_batch(mb, eval_micro)
                m = eval_fn(params, put({k: eval_rows(v) for k, v in padded.items()}))
                total += float(m["loss_sum"])
                tokens += int(m["num_tokens"])
        return total / max(tokens, 1)

    history, eval_history = [], []
    t_start = time.time()
    t_prev = t_start
    profiler = None
    guard = PreemptionGuard(training_args.checkpoint_on_preemption)
    preempted = False
    schedule = lr_schedule(training_args)
    tracker = MetricsWriter(training_args.output_dir,
                            training_args.report_to if rank0 else "none")

    def save(step: int) -> None:
        data_state = {"seed": training_args.seed, "batches_seen": step}
        if shard is None:
            ckpt.save(step, state, data_state)
            return
        whole = _gathered_state(shard, state)
        if rank0:
            ckpt.save(step, whole, data_state)
        torch.distributed.barrier()

    try:
        for i, batch in enumerate(iterator):
            step_i = start_step + i
            if step_i >= max_steps:
                break
            if i == 0:
                smoke_test_batch(batch)
            if training_args.profile_dir and step_i == training_args.profile_start_step:
                profiler = _start_profiler(dev)
            state, metrics = step_fn(state, put(batch))
            if profiler is not None and step_i >= (
                training_args.profile_start_step + training_args.profile_num_steps - 1
            ):
                _stop_profiler(profiler, training_args.profile_dir, dev)
                profiler = None
            if step_i % training_args.logging_steps == 0:
                loss = float(metrics["loss"])  # device sync
                history.append(loss)
                if not np.isfinite(loss):
                    # stop rather than burn steps on a diverged model
                    log.error("non-finite loss %.3f at step %d; aborting", loss, step_i)
                    break
                now = time.time()
                dt = max(now - t_prev, 1e-9) / max(training_args.logging_steps, 1)
                t_prev = now
                grad_norm = float(metrics["grad_norm"])
                n_tok = float(metrics["num_tokens"])
                log.info("step %d loss %.4f grad_norm %.3f | %.3f s/step %.0f tok/s",
                         step_i, loss, grad_norm, dt, n_tok / dt)
                moe_metrics = {k: float(metrics[k]) for k in ("moe_aux_loss", "moe_dropped_frac")
                               if k in metrics}
                tracker.log(step_i, loss=loss, grad_norm=grad_norm,
                            learning_rate=schedule(step_i), step_time_s=dt,
                            tokens_per_s=n_tok / dt, **moe_metrics)
            if eval_every and (step_i + 1) % eval_every == 0:
                ev = run_eval(state.params)
                eval_history.append((step_i + 1, ev))
                log.info("step %d eval_loss %.4f", step_i + 1, ev)
                tracker.log(step_i + 1, eval_loss=ev)
            if (step_i + 1) % training_args.save_steps == 0:
                save(step_i + 1)
            if guard.triggered:
                log.warning("preemption: checkpointing at step %d and exiting", step_i + 1)
                preempted = True
                break
        if profiler is not None:
            _stop_profiler(profiler, training_args.profile_dir, dev)
    finally:
        guard.restore()
        tracker.close()

    final_step = state.step
    if final_step > start_step and final_step not in ckpt.steps():
        save(final_step)
    # re-save metadata now that the tokenizer has seen the data: the lazy
    # WordTokenizer interns word ids during training
    if rank0:
        save_model_metadata(training_args.output_dir, global_cfg, bundle)
    if training_args.lora_enable:
        whole = state.params if shard is None else gather_params(mesh, state.params, shard.specs)
        if rank0:
            save_lora_adapter(os.path.join(training_args.output_dir, "adapter"), global_cfg,
                              whole, extra_non_lora={"embed": whole["embed"]})
            log.info("saved LoRA adapter to %s/adapter", training_args.output_dir)
    return {
        "final_step": final_step,
        "losses": history,
        "eval_losses": eval_history,
        "wall_s": time.time() - t_start,
        "state": state,  # this rank's shards on a mesh
        "cfg": cfg,  # with this rank's widths on a mesh
        "bundle": bundle,
        "preempted": preempted,
        "mesh": mesh,
    }


def _start_profiler(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, profile_dir: str, dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("wrote profiler trace to %s", path)


def main(argv=None):
    pkg_log = logging.getLogger("llark_tpu_torch")
    pkg_log.setLevel(logging.INFO)
    if not pkg_log.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(asctime)s %(name)s] %(message)s"))
        pkg_log.addHandler(h)
    import argparse

    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda",
                     help="device of every rank: the GPU (default), or 'cpu' (gloo)")
    device = dev.parse_known_args(argv)[0].device
    model_args, data_args, training_args = parse_args(argv)
    train(model_args, data_args, training_args, device=device)


if __name__ == "__main__":
    main()
