"""The port's pipeline parallelism against the JAX package's, fp32 on the
CPU: GPipe over a ("data", "pipe") mesh, llama and mpt.

The port runs in a world of 4 gloo ranks (`parallel/launch.py` LocalWorld,
one module-scoped world); the JAX side runs its pipelined step on 4 of the 8
virtual CPU devices and its plain loss on one. Both get the same numpy
weights (a seeded init of the port's, in the JAX layout) and the same numpy
batch. Tolerance: 1e-5 relative (to max |JAX|) for the loss and every
gradient, both sides in fp32, differing only in summation order; exact
equality for token counts. The worker functions import no JAX: the ranks
import this module by name.
"""

import functools
import types

import numpy as np
import pytest
import torch

from llark_tpu_torch.config import ModelConfig, TrainingArguments
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models.fusion import init_llark_params
from llark_tpu_torch.parallel import mesh as tmesh
from llark_tpu_torch.parallel import pipeline as tpipe
from llark_tpu_torch.parallel.launch import LocalWorld
from llark_tpu_torch.special_tokens import IGNORE_INDEX
from llark_tpu_torch.train import step as tstep
from llark_tpu_torch.train.state import TrainState, iter_leaves

TOL = 1e-5
PATCH_ID = 250
WORLD = 4


@functools.lru_cache(maxsize=None)
def _jax():
    import jax
    import jax.numpy as jnp

    from llark_tpu.config import ModelConfig as JaxConfig
    from llark_tpu.models import fusion as jfusion
    from llark_tpu.parallel import pipeline as jpipe

    return types.SimpleNamespace(**locals())


@pytest.fixture(scope="module")
def world():
    with LocalWorld(WORLD) as w:
        yield w


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(arch):
    return dict(num_layers=4, dtype="float32", param_dtype="float32", remat=arch == "llama")


@functools.lru_cache(maxsize=None)
def _tree(arch):
    params = init_llark_params(ModelConfig.tiny(arch, **_kw(arch)), seed=0, device="cpu")
    return {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v.numpy())
            for k, v in params.items()}


def _batch(b=8, s=16, frames=4, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, 200, (b, s)).astype(np.int32)
    ids[:, 2:2 + frames] = PATCH_ID
    labels = ids.copy()
    labels[:, :2 + frames] = IGNORE_INDEX
    lengths = np.array([s, s - 3, s, s - 6] * (b // 4), np.int32)
    return dict(input_ids=ids, labels=labels, seq_lengths=lengths,
                audio_encodings=rng.randn(b, frames, 48).astype(np.float32),
                audio_frame_counts=np.full((b,), frames, np.int32))


def _w_pp_step(shape, arch, micro, tree, batch):
    """One pipelined step at lr 0: the loss, the token count, the gradients
    (the first moment over 1 - b1, times the clipping factor), gathered
    whole over "pipe"."""
    cfg = ModelConfig.tiny(arch, **_kw(arch))
    mesh = tpipe.make_pp_mesh(*shape, device="cpu")
    specs = tpipe.pp_param_specs(cfg)
    params = tmesh.shard_params(mesh, params_from_numpy(tree, cfg, "cpu"), specs)
    tstep.ParamPartition(params, tstep.trainable_mask(params))
    opt = tstep.make_optimizer(TrainingArguments(learning_rate=1e-3, max_steps=10,
                                                 warmup_ratio=0.1,
                                                 lr_scheduler_type="constant_with_warmup"))
    state = TrainState.create(params, opt)
    step = tpipe.make_pp_train_step(cfg, opt, mesh, n_microbatches=micro, audio_patch_id=PATCH_ID)
    rows = tmesh.batch_sharding(mesh)
    state, m = step(state, {k: torch.from_numpy(rows(v)) for k, v in batch.items()})
    unclip = max(float(m["grad_norm"]), 1.0) / 0.1
    flat = dict(iter_leaves(specs))
    trained = [p for p, t in iter_leaves(state.params) if t.requires_grad]
    grads = {p: tmesh.gather_param(mesh, mu, flat[p]).numpy() * unclip
             for p, mu in zip(trained, state.opt_state["mu"])}
    return float(m["loss"]), int(m["num_tokens"]), float(m["grad_norm"]), grads


def _jax_loss_grads(arch, batch, shape=None, micro=1):
    """The JAX package's loss and gradients: its plain forward on one
    device, or its pipelined layer stack on a ("data", "pipe") mesh of 4
    (tests/test_pipeline.py's _pp_loss)."""
    J = _jax()
    jcfg = J.JaxConfig.tiny(arch, **_kw(arch))
    params = J.jax.tree.map(J.jnp.asarray, _tree(arch))
    b = {k: J.jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        if shape is None:
            logits, _ = J.jfusion.llark_forward(
                jcfg, p, b["input_ids"], audio_encodings=b["audio_encodings"],
                audio_patch_id=PATCH_ID, audio_frame_counts=b["audio_frame_counts"],
                seq_lengths=b["seq_lengths"])
        else:
            from llark_tpu.models.decoder import _norm, compute_logits

            mesh = J.jpipe.make_pp_mesh(*shape, devices=J.jax.devices()[:WORLD])
            pipeline = J.jpipe.make_pipeline_layers_fn(jcfg, mesh, micro)
            embeds = J.jfusion.build_inputs_embeds(jcfg, p, b["input_ids"], b["audio_encodings"],
                                                   PATCH_ID, b["audio_frame_counts"], None)
            n, s, _ = embeds.shape
            pos = J.jnp.broadcast_to(J.jnp.arange(s, dtype=J.jnp.int32)[None, :], (n, s))
            hidden = pipeline(p["layers"], embeds.astype(J.jnp.float32), pos, b["seq_lengths"])
            hidden = _norm(jcfg, hidden, p["final_norm_scale"], p.get("final_norm_bias"))
            logits = compute_logits(jcfg, p, hidden, None)
        return J.jfusion.causal_lm_loss(logits, b["labels"])[0]

    value, grads = J.jax.jit(J.jax.value_and_grad(loss))(params)
    return float(value), {p: np.asarray(g) for p, g in iter_leaves(grads)}


@functools.lru_cache(maxsize=None)
def _single_device(arch):
    return _jax_loss_grads(arch, _batch())


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("arch,shape,micro", [
    ("llama", (2, 2), 2), ("llama", (1, 4), 4), ("mpt", (2, 2), 1), ("mpt", (1, 4), 2),
])
def test_pp_loss_and_grads_match_jax(world, arch, shape, micro):
    batch = _batch()
    results = world.run(_w_pp_step, shape, arch, micro, _tree(arch), batch)
    loss, n_tok, norm, grads = results[0]
    assert all(r[:3] == (loss, n_tok, norm) for r in results)
    assert n_tok == int((batch["labels"][:, 1:] != IGNORE_INDEX).sum())
    for ref_loss, ref_grads in (_single_device(arch),
                                _jax_loss_grads(arch, batch, shape, micro)):
        assert abs(loss - ref_loss) <= TOL * abs(ref_loss)
        assert grads.keys() == ref_grads.keys()
        for path, g in grads.items():
            assert _rel_err(g, ref_grads[path]) <= TOL, (arch, shape, path)
    want_norm = float(np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                                  for g in _single_device(arch)[1].values())))
    assert abs(norm - want_norm) <= TOL * want_norm


def _w_errors(shape):
    mesh = tpipe.make_pp_mesh(*shape, device="cpu")
    out = []
    try:
        tpipe.make_pipeline_layers_fn(ModelConfig.tiny(num_layers=3), mesh, 1)
    except ValueError as e:
        out.append(str(e))
    fn = tpipe.make_pipeline_layers_fn(ModelConfig.tiny(num_layers=4, dtype="float32"), mesh, 3)
    try:
        fn({}, torch.zeros(4, 2, 64), torch.zeros(4, 2, dtype=torch.long), torch.zeros(4))
    except ValueError as e:
        out.append(str(e))
    return out


def test_pp_rejects_indivisible_layers_and_batches(world):
    # the JAX package's errors (llark_tpu/parallel/pipeline.py:112-116, 126-129)
    out = world.run(_w_errors, (1, 4))[0]
    assert out == ["num_layers 3 not divisible by pipe=4",
                   "per-data-shard batch 4 not divisible by 3 microbatches"]
