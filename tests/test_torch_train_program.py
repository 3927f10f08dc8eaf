"""The port's train step as one program (`train/step.py` `jit_train_step`,
`TrainProgram`) against the JAX package's jitted train step, on the CPU.

On CPU tensors the program runs the eager step through its own buffers:
the batch copied into its static inputs, the update's lr and bias
corrections filled into its scalars, the dropout draws seeded before the
step. The same numpy tree and three steps' batches go into both packages;
the JAX side is `jax.jit(make_train_step(...), donate_argnums=(0,))`, as
llark_tpu/train/train.py:368 runs it, computed once per configuration in a
module fixture. The schedule warms up for one step and then decays by a
cosine, so lr differs at every step. Tolerances:
  * each step's loss and grad norm 1e-5 relative, token counts exact;
  * the trained tensors as tests/test_torch_train.py::test_train_step_matches_jax
    holds them: steps 1 and 2 take the same batch, so the second step (the
    first at lr > 0) moves each tensor by -lr (g / (|g| + eps) + wd p),
    held within 1e-5 relative to its max where |g| >= 1e-5. Below that
    Adam's per-element normalisation turns fp32 summation-order noise into
    visible changes (up to lr where |g| is near eps), and step 3, on
    another batch, would start from parameters that differ there by that
    much: the JAX package's step 3 therefore starts from the port's
    parameters after step 2;
  * the program's CPU route against the eager step, and train() through
    it against train() on the eager step: equal.
LoRA dropout masks come from each package's own generators, so parity runs
at lora_dropout 0; the dropout contract is held inside the port.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu.config import ModelConfig as JaxConfig
from llark_tpu.config import TrainingArguments as JTrainingArguments
from llark_tpu.models import quant as jquant
from llark_tpu.train import step as jstep
from llark_tpu.train.state import TrainState as JTrainState
from llark_tpu_torch.config import DataArguments, ModelArguments, ModelConfig, TrainingArguments
from llark_tpu_torch.data.webdataset import TarShardWriter
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models import decoder as tdecoder
from llark_tpu_torch.models import fusion as tfusion
from llark_tpu_torch.models import lora as tlora
from llark_tpu_torch.special_tokens import IGNORE_INDEX
from llark_tpu_torch.train import step as tstep
from llark_tpu_torch.train import train as ttrain
from llark_tpu_torch.train.state import TrainState, iter_leaves

TOL = 1e-5
PATCH_ID = 7
STEPS = 3
# head_dim 64 (hidden 128 over 2 heads), 2 layers, fp32
WIDTHS = dict(hidden_size=128, num_heads=2, num_kv_heads=2, intermediate_size=256,
              mm_hidden_size=8, dtype="float32", param_dtype="float32")
LORA = dict(lora_rank=4, lora_alpha=8.0)
ARGS = dict(learning_rate=1e-1, max_steps=10, warmup_ratio=0.1, weight_decay=0.01,
            lr_scheduler_type="cosine")
# name: (config fields, trainable-mask flags, base, train-step options)
CASES = {
    "adapter": (dict(), dict(freeze_backbone=True, tune_mm_mlp_adapter=True), "float",
                dict(trainable_token_start=200)),
    "full": (dict(), dict(), "float", dict()),
    "accum2": (dict(), dict(), "float", dict(grad_accum_steps=2)),
    "loss_chunk": (dict(), dict(), "float", dict(loss_chunk=8)),
    "remat_mpt": (dict(arch="mpt", remat=True), dict(), "float", dict(grad_accum_steps=2)),
    "lora": (dict(LORA, remat=True), dict(lora=True), "float",
             dict(grad_accum_steps=2, dropout_seed=0)),
    "qlora_int8": (dict(LORA), dict(lora=True), "int8", dict(dropout_seed=0)),
    "qlora_int4_rows": (dict(LORA), dict(lora=True), "int4", dict(dropout_seed=0)),
    "moe": (dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=1.0,
                 moe_aux_loss_weight=0.1, remat=True), dict(), "float", dict(grad_accum_steps=2)),
}
GROUP = 64  # int4 scale group


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny tensors: one intra-op thread per process, as tests/test_torch_train.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name):
    fields = dict(WIDTHS, **CASES[name][0])
    arch = fields.pop("arch", "llama")
    return JaxConfig.tiny(arch, **fields), ModelConfig.tiny(arch, **fields)


@functools.lru_cache(maxsize=None)
def _tree(name):
    """The case's numpy tree: a seeded init (with non-zero LoRA factors),
    its base quantized by the JAX package where the case says so."""
    jcfg, tcfg = _configs(name)
    tree = jax.tree.map(lambda t: t.numpy(), tfusion.init_llark_params(tcfg, seed=0, device="cpu"))
    if tcfg.lora_rank:
        rng = np.random.RandomState(1)
        for target in tlora.LORA_TARGETS:
            if target in tree["layers"]:
                L, fan_in, fan_out = tree["layers"][target].shape
                r = tcfg.lora_rank
                tree["layers"][f"{target}_lora_a"] = (
                    rng.randn(L, fan_in, r) / np.sqrt(fan_in)).astype(np.float32)
                tree["layers"][f"{target}_lora_b"] = (
                    rng.randn(L, r, fan_out) * 0.05).astype(np.float32)
    base = CASES[name][2]
    if base != "float":
        jp = jax.tree.map(jnp.asarray, tree)
        jp = dict(jp, layers=dict(jp["layers"]))  # the calls take ownership
        if base == "int8":
            jp = jquant.quantize_params_int8_incremental(jcfg, jp)
        else:
            jp = jquant.quantize_params_int4_incremental(jcfg, jp, group=GROUP, layout="rows")
        tree = jax.tree.map(np.asarray, jp)
    return tree


def _batch(seed, b=4, s=16, frames=3, vocab=256, mm=8):
    rng = np.random.RandomState(seed)
    ids = rng.randint(8, vocab, (b, s)).astype(np.int32)
    ids[:, 2:2 + frames] = PATCH_ID
    labels = ids.copy()
    labels[:, :6] = IGNORE_INDEX
    lengths = np.array([s, s - 4, s, s - 7][:b], np.int32)
    for i, n in enumerate(lengths):
        labels[i, n:] = IGNORE_INDEX
    return dict(input_ids=ids, labels=labels, seq_lengths=lengths,
                audio_encodings=rng.randn(b, frames, mm).astype(np.float32),
                audio_frame_counts=np.array([frames, frames - 1, frames, 1][:b], np.int32))


BATCHES = [_batch(10), _batch(10), _batch(11)]


def _with_leaves(tree, leaves):
    """A copy of the nested numpy `tree` with the leaves at `leaves`' paths
    replaced."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = {p[len(k) + 1:]: t for p, t in leaves.items() if p.startswith(k + "/")}
            out[k] = _with_leaves(v, sub)
        else:
            out[k] = leaves.get(k, v)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: the JAX package's jitted step over the first two batches,
    then from the port's parameters after its second step over the third
    (each step's metrics), and its params after the second step."""
    out = {}
    for name, (_, flags, _, options) in CASES.items():
        jcfg, _ = _configs(name)
        jp = jax.tree.map(jnp.asarray, _tree(name))
        opt = jstep.make_optimizer(JTrainingArguments(**ARGS), jp)
        partition = jstep.ParamPartition(jp, jstep.trainable_mask(jp, **flags)) if flags else None
        state = JTrainState.create(jp, opt, partition)
        fn = jax.jit(jstep.make_train_step(jcfg, opt, audio_patch_id=PATCH_ID, partition=partition,
                                           **options), donate_argnums=(0,))
        metrics = []
        for i, batch in enumerate(BATCHES):
            if i == 2:
                trained = {p: t.numpy() for p, t in _port_run(name)[2].items()}
                state = state.replace(params=jax.tree.map(
                    jnp.asarray, _with_leaves(jax.tree.map(np.asarray, _tree(name)), trained)))
            state, m = fn(state, {k: jnp.asarray(v) for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 1:
                second = dict(iter_leaves(jax.tree.map(np.asarray, state.params)))
        out[name] = (metrics, second)
    return out


def _port_state(name):
    _, tcfg = _configs(name)
    params = params_from_numpy(_tree(name), tcfg, "cpu")
    flags = CASES[name][1]
    tstep.ParamPartition(params, tstep.trainable_mask(params, **flags))
    opt = tstep.make_optimizer(TrainingArguments(**ARGS))
    return tcfg, opt, TrainState.create(params, opt)


@functools.lru_cache(maxsize=None)
def _port_run(name):
    """The port's program over the three batches: each step's metrics, the
    tree before the first step and after the second, the first step's
    gradient (after it, mu = (1 - b1) g), the final state, the program."""
    tcfg, opt, state = _port_state(name)
    before = {p: t.detach().clone() for p, t in iter_leaves(state.params)}
    program = tstep.jit_train_step(tstep.make_train_step(
        tcfg, opt, audio_patch_id=PATCH_ID, **CASES[name][3]))
    metrics = []
    for i, batch in enumerate(BATCHES):
        state, m = program(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = [mu / (1 - opt.b1) for mu in state.opt_state["mu"]]
        if i == 1:
            second = {p: t.detach().clone() for p, t in iter_leaves(state.params)}
    return metrics, before, second, grads, state, program


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_program_step_metrics_match_jax(jax_runs, name, step):
    got = _port_run(name)[0][step]
    want = jax_runs[name][0][step]
    assert set(got) == set(want)
    assert int(got["num_tokens"]) == int(want["num_tokens"])
    for k in set(want) - {"num_tokens"}:
        assert abs(got[k] - want[k]) <= TOL * max(abs(want[k]), 1e-6), (k, got[k], want[k])


@pytest.mark.parametrize("name", sorted(CASES))
def test_program_trained_tensors_match_jax(jax_runs, name):
    _, before, second, grads, state, program = _port_run(name)
    assert state.step == STEPS == program.calls and state.opt_state["count"] == STEPS
    jsecond = jax_runs[name][1]
    trained = iter(grads)
    for path, t in iter_leaves(state.params):
        want = jsecond[path] - before[path].numpy()
        got = second[path].numpy() - before[path].numpy()
        if not t.requires_grad:  # frozen in both
            assert np.abs(got).max() == 0.0 == np.abs(want).max(), path
            continue
        g = next(trained).abs().numpy()
        resolved = g >= 1e-5
        assert resolved.sum() > 0.5 * (g > 0).sum(), path
        # untouched embedding rows (g == 0) move by the decay alone
        checked = resolved | (g == 0)
        assert np.abs(got - want)[checked].max() <= TOL * np.abs(want).max(), path


@pytest.mark.parametrize("name", ["adapter", "lora", "moe"])
def test_program_on_the_cpu_equals_the_eager_step(name):
    tcfg, opt, state = _port_state(name)
    step = tstep.make_train_step(tcfg, opt, audio_patch_id=PATCH_ID, **CASES[name][3])
    for batch in BATCHES:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    got = _port_run(name)[4]
    for (path, a), (_, b) in zip(iter_leaves(state.params), iter_leaves(got.params)):
        assert torch.equal(a, b), path
    assert float(m["loss"]) == _port_run(name)[0][-1]["loss"]


def _dropout_case(**over):
    _, tcfg = _configs("lora")
    cfg = dataclasses.replace(tcfg, lora_dropout=0.5, **over)
    params = params_from_numpy(_tree("lora"), cfg, "cpu")
    tstep.ParamPartition(params, tstep.trainable_mask(params, lora=True))
    return cfg, params


def _record_masks(monkeypatch):
    """Every dropout mask drawn, in order, as a bool tensor."""
    masks = []
    dropout = tdecoder._dropout

    def recording(x, rate, gen):
        out = dropout(x, rate, gen)
        masks.append((out != 0).clone())
        return out

    monkeypatch.setattr(tdecoder, "_dropout", recording)
    return masks


def test_dropout_recompute_draws_the_forward_masks():
    # remat's recompute of a layer draws from the layer's second generator,
    # seeded as the first: the gradients equal those without remat
    batch = {k: torch.from_numpy(v) for k, v in BATCHES[0].items()}
    grads = []
    for remat in (False, True):
        cfg, params = _dropout_case(remat=remat)
        leaves = tstep.trainable_leaves(params)
        draws = tdecoder.DropoutDraws(cfg.num_layers, "cpu").seed(123)
        loss, _, _ = tstep.make_loss_fn(cfg, audio_patch_id=PATCH_ID)(params, batch, draws)
        grads.append(torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True))
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=0, atol=1e-6 * max(float(b.abs().max()), 1e-6))
    assert any(float(g.abs().max()) > 0 for g in grads[0])


def test_dropout_masks_differ_between_steps_and_micro_batches(monkeypatch):
    masks = _record_masks(monkeypatch)
    cfg, params = _dropout_case(remat=True)
    opt = tstep.make_optimizer(TrainingArguments(**ARGS))
    state = TrainState.create(params, opt)
    program = tstep.jit_train_step(tstep.make_train_step(
        cfg, opt, audio_patch_id=PATCH_ID, grad_accum_steps=2, dropout_seed=3))
    for batch in BATCHES[:2]:
        state, _ = program(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    # per step: 2 micro-batches x (forward 2 layers x 7 targets, then the
    # recompute of the same layers in the backward, last layer first)
    per_pass = cfg.num_layers * 7
    assert len(masks) == 2 * 2 * 2 * per_pass
    steps = [masks[i * 4 * per_pass:(i + 1) * 4 * per_pass] for i in range(2)]
    for s in steps:
        fwd0, rec0, fwd1 = s[:per_pass], s[per_pass:2 * per_pass], s[2 * per_pass:3 * per_pass]
        # the recompute runs layer 1, then layer 0
        rec0 = rec0[7:] + rec0[:7]
        assert all(torch.equal(a, b) for a, b in zip(fwd0, rec0))
        assert not any(torch.equal(a, b) for a, b in zip(fwd0, fwd1) if a.shape == b.shape)
    assert not any(torch.equal(a, b) for a, b in zip(steps[0], steps[1]))
    # the same step from the same seed draws the same masks (eager)
    masks.clear()
    cfg, params = _dropout_case(remat=True)
    step = tstep.make_train_step(cfg, opt, audio_patch_id=PATCH_ID, grad_accum_steps=2,
                                 dropout_seed=3)
    step(TrainState.create(params, opt), {k: torch.from_numpy(v) for k, v in BATCHES[0].items()})
    assert all(torch.equal(a, b) for a, b in zip(masks, steps[0]))


def test_a_call_with_another_batch_shape_or_state_raises():
    tcfg, opt, state = _port_state("full")
    program = tstep.jit_train_step(tstep.make_train_step(tcfg, opt, audio_patch_id=PATCH_ID))
    batch = {k: torch.from_numpy(v) for k, v in BATCHES[0].items()}
    state, _ = program(state, batch)
    longer = {k: torch.from_numpy(v) for k, v in _batch(3, s=32).items()}
    with pytest.raises(ValueError, match="runs batches of"):
        program(state, longer)
    with pytest.raises(ValueError, match="another train state"):
        program(_port_state("full")[2], batch)
    assert program.calls == 1 and state.step == 1


def test_jit_train_step_with_a_mesh_raises_naming_the_collectives():
    tcfg, opt, _ = _port_state("full")
    step = tstep.make_train_step(tcfg, opt, audio_patch_id=PATCH_ID)
    with pytest.raises(ValueError, match="sync_grads and sharded_grad_norm"):
        tstep.jit_train_step(step, mesh=object())


def test_program_runs_a_wrapped_step_and_refuses_one_that_does_not_call_it():
    tcfg, opt, state = _port_state("full")
    step = tstep.make_train_step(tcfg, opt, audio_patch_id=PATCH_ID)
    seen = []

    def watched(s, b):
        seen.append(s.step)
        return step(s, b)

    program = tstep.jit_train_step(watched)
    for batch in BATCHES[:2]:
        state, _ = program(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert seen == [0, 1] and state.step == 2
    with pytest.raises(TypeError, match="make_train_step"):
        tstep.jit_train_step(lambda s, b: (s, {}))(state, {k: torch.from_numpy(v)
                                                          for k, v in BATCHES[0].items()})


def _write_shards(directory, n=5, mm=8, frames=6):
    writer = TarShardWriter(str(directory / "mir-train-%05d.tar"), max_count=3)
    rng = np.random.RandomState(11)
    for i in range(n):
        writer.write({
            "__key__": f"t{i:03d}",
            "json": {"response": [{"question": f"what genre is clip {i} ?",
                                   "answer": "ambient jazz ."}]},
            "audio_encoding.pyd": rng.randn(frames, mm).astype(np.float32),
        })
    writer.close()
    return writer.written_paths[0]


def _train(tmp_path, shard, steps, out="out", lora=False):
    cfg = ModelConfig.tiny(**dict(WIDTHS, mm_hidden_size=8, remat=True))
    model_args = ModelArguments(model_name_or_path="llama2-7b", freeze_backbone=not lora,
                                tune_mm_mlp_adapter=not lora)
    data_args = DataArguments(train_data_path=shard, max_audio_frames=6,
                              task_sample_probs={"mir": 1.0})
    training_args = TrainingArguments(
        output_dir=str(tmp_path / out), per_device_train_batch_size=2,
        gradient_accumulation_steps=2, model_max_length=64, learning_rate=1e-2,
        max_steps=steps, save_steps=2, logging_steps=1, seed=0, lr_scheduler_type="cosine",
        warmup_ratio=0.1, checkpoint_on_preemption=False, lora_enable=lora, lora_r=4,
        lora_dropout=0.5 if lora else 0.05)
    return ttrain.train(model_args, data_args, training_args, model_cfg=cfg, device="cpu")


@pytest.mark.parametrize("lora", [False, True], ids=["adapter", "lora_dropout"])
def test_train_through_the_program_equals_train_on_the_eager_step(tmp_path, monkeypatch, lora):
    shard = _write_shards(tmp_path)
    made = []
    jit = ttrain.jit_train_step

    def counted(step):
        made.append(jit(step))
        return made[-1]

    monkeypatch.setattr(ttrain, "jit_train_step", counted)
    through = _train(tmp_path, shard, 4, "program", lora)
    assert made and made[0].calls == 4
    monkeypatch.setattr(ttrain, "jit_train_step", lambda step: step)
    eager = _train(tmp_path, shard, 4, "eager", lora)
    assert through["losses"] == eager["losses"] and len(eager["losses"]) == 4
    for (path, a), (_, b) in zip(iter_leaves(through["state"].params),
                                 iter_leaves(eager["state"].params)):
        assert torch.equal(a, b), path


def test_a_resumed_program_run_equals_an_uninterrupted_one(tmp_path):
    shard = _write_shards(tmp_path)
    whole = _train(tmp_path, shard, 4, "whole", lora=True)
    _train(tmp_path, shard, 2, "parts", lora=True)
    resumed = _train(tmp_path, shard, 4, "parts", lora=True)
    assert resumed["final_step"] == 4 and len(resumed["losses"]) == 2
    assert resumed["losses"] == whole["losses"][2:]
    for (path, a), (_, b) in zip(iter_leaves(resumed["state"].params),
                                 iter_leaves(whole["state"].params)):
        assert torch.equal(a, b), path
