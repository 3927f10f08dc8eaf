"""The port's mesh paths against the JAX package's, fp32 on the CPU: the
partition rules, the sharded train step (FSDP / TP / DP), expert
parallelism, checkpoints across meshes, the data split and data-parallel
CLAP extraction.

The port runs in a world of 4 gloo ranks (`parallel/launch.py` LocalWorld,
one module-scoped world); the JAX side runs on 4 of the 8 virtual CPU
devices, under a mesh and on one device. Both get the same numpy weights (a
seeded init of the port's, in the JAX layout) and the same numpy batch.
Tolerances, stated per case:
  * 1e-5 relative (to max |JAX|) for losses, gradient norms, gradients and
    logits: both sides compute in fp32 and differ only in summation order
    (and the port's fp32 all-reduces of partial sums);
  * exact equality for token counts, partition specs, the data split and
    checkpointed tensors; 1e-6 absolute for CLAP embeddings.
The worker functions import no JAX: the ranks import this module by name.
"""

import functools
import os
import types

import numpy as np
import pytest
import torch

from llark_tpu_torch.audio.io import write_wav
from llark_tpu_torch.config import DataArguments, ModelArguments, ModelConfig, TrainingArguments
from llark_tpu_torch.data.shards import split_by_host
from llark_tpu_torch.data.webdataset import TarShardWriter
from llark_tpu_torch.encoders import extract_cli as tcli
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models.fusion import init_llark_params, llark_forward
from llark_tpu_torch.parallel import mesh as tmesh
from llark_tpu_torch.parallel.launch import LocalWorld
from llark_tpu_torch.special_tokens import IGNORE_INDEX
from llark_tpu_torch.train import step as tstep
from llark_tpu_torch.train.checkpoint import CheckpointManager
from llark_tpu_torch.train.state import TrainState, iter_leaves

TOL = 1e-5
PATCH_ID = 7
WORLD = 4
LLAMA = dict(arch="llama", num_kv_heads=4, dtype="float32", param_dtype="float32",
             mm_hidden_size=16)
MOE = dict(LLAMA, moe_num_experts=4, moe_top_k=2, moe_capacity_factor=1.0)


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX package's pieces, imported in the test process only."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from llark_tpu.config import ModelConfig as JaxConfig
    from llark_tpu.models import fusion as jfusion
    from llark_tpu.models import lora as jlora
    from llark_tpu.models import quant as jquant
    from llark_tpu.parallel import mesh as jmesh
    from llark_tpu.parallel import pipeline as jpipe

    return types.SimpleNamespace(jax=jax, jnp=jnp, NamedSharding=NamedSharding, P=PartitionSpec,
                                 JaxConfig=JaxConfig, jfusion=jfusion, jlora=jlora,
                                 jquant=jquant, jmesh=jmesh, jpipe=jpipe)


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


def _rel_err(got, want):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6))


@functools.lru_cache(maxsize=None)
def _tree(kind):
    """The seeded numpy weights of a configuration, in the JAX layout."""
    kw = dict(MOE if kind == "moe" else LLAMA)
    cfg = ModelConfig.tiny(kw.pop("arch"), **kw)
    params = init_llark_params(cfg, seed=0, device="cpu")
    return {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v.numpy())
            for k, v in params.items()}


def _tcfg(kind):
    kw = dict(MOE if kind == "moe" else LLAMA)
    return ModelConfig.tiny(kw.pop("arch"), **kw)


def _batch(b=8, s=12, frames=3, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(8, 256, (b, s)).astype(np.int32)
    ids[:, 1:1 + frames] = PATCH_ID
    labels = ids.copy()
    labels[:, :4] = IGNORE_INDEX
    lengths = np.array([s, s - 2, s - 5, s] * (b // 4), np.int32)
    for i, n in enumerate(lengths):
        labels[i, n:] = IGNORE_INDEX
    labels[min(5, b - 1)] = IGNORE_INDEX  # a row with no tokens
    return dict(input_ids=ids, labels=labels, seq_lengths=lengths,
                audio_encodings=rng.randn(b, frames, 16).astype(np.float32),
                audio_frame_counts=np.array([frames, frames - 1, frames, 1] * (b // 4), np.int32))


def _flat(tree):
    return {p: np.asarray(v) for p, v in iter_leaves(tree)}


# ---------------------------------------------------------------------------
# worker functions (run on every rank)
# ---------------------------------------------------------------------------


def _w_train(shape, tree, batch, accum):
    """Two sharded train steps at lr 0 then 1e-1; returns the metrics, the
    gradients (the first moment after step 1, over 1 - b1 and times the
    clipping factor) and the params after, gathered whole."""
    cfg = _tcfg("llama")
    mesh = tmesh.make_mesh(shape, device="cpu")
    lcfg, params = tmesh.shard_model(mesh, cfg, params_from_numpy(tree, cfg, "cpu"))
    tstep.ParamPartition(params, tstep.trainable_mask(params))
    opt = tstep.make_optimizer(TrainingArguments(
        learning_rate=1e-1, max_steps=10, warmup_ratio=0.1, weight_decay=0.01,
        lr_scheduler_type="constant_with_warmup"))
    state = TrainState.create(params, opt)
    fn = tstep.make_train_step(lcfg, opt, audio_patch_id=PATCH_ID, grad_accum_steps=accum)
    rows = tmesh.batch_sharding(mesh, accum)
    local = {k: torch.from_numpy(rows(v)) for k, v in batch.items()}
    metrics, grads = [], None
    paths = [p for p, t in iter_leaves(state.params) if t.requires_grad]
    for i in range(2):
        state, m = fn(state, local)
        metrics.append((float(m["loss"]), float(m["grad_norm"]), int(m["num_tokens"])))
        if i == 0:
            unclip = max(metrics[0][1], 1.0) / 0.1  # clip_by_global_norm(1.0), then 1 - b1
            grads = {p: tmesh.gather_param(mesh, mu, lcfg.shard.flat_specs[p]).numpy() * unclip
                     for p, mu in zip(paths, state.opt_state["mu"])}
    after = tmesh.gather_params(mesh, state.params, lcfg.shard.specs)
    return metrics, grads, {p: t.numpy() for p, t in iter_leaves(after)}


def _w_moe_forward(shape, tree, ids, lengths):
    cfg = _tcfg("moe")
    mesh = tmesh.make_mesh(shape, device="cpu")
    lcfg, params = tmesh.shard_model(mesh, cfg, params_from_numpy(tree, cfg, "cpu"))
    rows = tmesh.batch_sharding(mesh)
    with torch.no_grad():
        logits, extras = llark_forward(lcfg, params, torch.from_numpy(rows(ids)),
                                       audio_patch_id=3,
                                       seq_lengths=torch.from_numpy(rows(lengths)))
    return tmesh.batch_shard_index(mesh)[0], logits.numpy(), float(extras["moe_aux_loss"])


def _w_split(shape, urls):
    tmesh.make_mesh(shape, device="cpu")
    return split_by_host(urls)


def _w_train_run(shape, root, url, max_steps):
    from llark_tpu_torch.train.train import train

    model_args = ModelArguments(model_name_or_path="tiny", mm_hidden_size=16)
    data_args = DataArguments(train_data_path=url, max_audio_frames=6,
                              task_sample_probs={"mir": 1.0})
    training_args = TrainingArguments(
        output_dir=os.path.join(root, "out"), per_device_train_batch_size=1,
        gradient_accumulation_steps=1, model_max_length=64, learning_rate=1e-3,
        max_steps=max_steps, save_steps=100, logging_steps=1, seed=0, mesh_shape=shape,
        report_to="none")
    cfg = ModelConfig.tiny(mm_hidden_size=16, dtype="float32")
    out = train(model_args, data_args, training_args, model_cfg=cfg, device="cpu")
    whole = tmesh.gather_params(out["mesh"], out["state"].params, out["cfg"].shard.specs)
    return out["final_step"], out["losses"], {p: t.numpy() for p, t in iter_leaves(whole)}


def _w_clap(wavs, out):
    tcli.main(["clap", "--input-dir", wavs, "--output-dir", out, "--device", "cpu", "--tiny",
               "--batch-size", "3", "--data-parallel"])
    return sorted(os.listdir(out)) if os.path.isdir(out) else []


# ---------------------------------------------------------------------------
# partition rules
# ---------------------------------------------------------------------------


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("kind", ["llama", "mpt", "moe", "lora"])
def test_partition_specs_match_jax(kind):
    J = _jax()
    kw = dict(MOE) if kind == "moe" else dict(LLAMA, arch="mpt" if kind == "mpt" else "llama")
    if kind == "lora":
        kw["lora_rank"] = 4
    arch = kw.pop("arch")
    jcfg, tcfg = J.JaxConfig.tiny(arch, **kw), ModelConfig.tiny(arch, **kw)
    for multimodal in (True, False):
        assert _as_tuples(tmesh.param_partition_specs(tcfg, multimodal)) == \
            _as_tuples(J.jmesh.param_partition_specs(jcfg, multimodal))
    assert _as_tuples(tmesh.param_partition_specs(tcfg)["layers"]) == \
        _as_tuples(J.jmesh._layer_specs(jcfg))
    from llark_tpu_torch.parallel.pipeline import pp_param_specs

    # the JAX package's pipeline specs mirror the base layer tree; the
    # port's also split LoRA factors over "pipe"
    want = J.jpipe.pp_param_specs(jcfg)
    got = pp_param_specs(tcfg)
    assert {k for k in got["layers"] if "_lora_" not in k} == set(want["layers"])
    assert all(tuple(s) == ("pipe",) for s in got["layers"].values())


def test_quantized_specs_keep_groups_whole():
    # int8: the JAX package's specs (the scale on the out axis); int4 rows:
    # a row-parallel weight's scale groups split with its rows, and a split
    # that would cut a group is refused in the JAX package's message style
    J = _jax()
    cfg = _tcfg("llama")
    jcfg = J.JaxConfig.tiny("llama", **{k: v for k, v in LLAMA.items() if k != "arch"})
    tree = _tree("llama")
    from llark_tpu_torch.models import quant as tquant

    t8 = tquant.quantize_params_int8(cfg, params_from_numpy(tree, cfg, "cpu"))
    j8 = J.jquant.quantize_params_int8(jcfg, J.jax.tree.map(J.jnp.asarray, tree))
    assert _as_tuples(tmesh.adapt_specs_to_params(tmesh.param_partition_specs(cfg), t8)) == \
        _as_tuples(J.jmesh.adapt_specs_to_params(J.jmesh.param_partition_specs(jcfg), j8))
    t4 = tquant.quantize_params_int4_incremental(cfg, params_from_numpy(tree, cfg, "cpu"),
                                                 group=32, layout="rows")
    specs = tmesh.adapt_specs_to_params(tmesh.param_partition_specs(cfg), t4)
    assert tuple(specs["layers"]["wo"]["scale"]) == (None, "tensor", "fsdp")
    assert tuple(specs["layers"]["wq"]["scale"]) == (None, None, "tensor")

    class FakeMesh:  # a (1, 1, 4) mesh's shape, for the check alone
        mesh_dim_names, shape = ("data", "fsdp", "tensor"), (1, 1, 4)

    with pytest.raises(ValueError, match="not a multiple of its 32-row scale group"):
        tmesh._check_int4_groups(FakeMesh, "layers/wo", t4["layers"]["wo"],
                                 specs["layers"]["wo"])


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------


def _jax_grads(batch, accum, shape=None):
    """(loss, gradients) of the JAX package's train-step loss (the mean of
    the micro-batch losses), on one device or under a mesh of 4."""
    J = _jax()
    jcfg = J.JaxConfig.tiny("llama", **{k: v for k, v in LLAMA.items() if k != "arch"})
    params = J.jax.tree.map(J.jnp.asarray, _tree("llama"))
    b = {k: J.jnp.asarray(v) for k, v in batch.items()}

    def loss(p, b):
        m = b["input_ids"].shape[0] // accum
        total = 0.0
        for i in range(accum):
            mb = {k: v[i * m:(i + 1) * m] for k, v in b.items()}
            logits, _ = J.jfusion.llark_forward(
                jcfg, p, mb["input_ids"], audio_encodings=mb["audio_encodings"],
                audio_patch_id=PATCH_ID, audio_frame_counts=mb["audio_frame_counts"],
                seq_lengths=mb["seq_lengths"])
            total = total + J.jfusion.causal_lm_loss(logits, mb["labels"])[0]
        return total / accum

    fn = J.jax.jit(J.jax.value_and_grad(loss))
    if shape is None:
        value, grads = fn(params, b)
    else:
        mesh = J.jmesh.make_mesh(shape, devices=J.jax.devices()[:WORLD])
        params = J.jmesh.shard_params(mesh, params, J.jmesh.param_partition_specs(jcfg))
        b = {k: J.jax.device_put(v, J.NamedSharding(
            mesh, J.P(J.jmesh.AXES.batch, *([None] * (v.ndim - 1))))) for k, v in b.items()}
        with mesh:
            value, grads = fn(params, b)
    return float(value), _flat(J.jax.tree.map(np.asarray, grads))


@functools.lru_cache(maxsize=None)
def _single_device():
    return _jax_grads(_batch(), 2)


@pytest.mark.parametrize("shape", [(4, 1, 1), (2, 2, 1), (1, 2, 2), (1, 4, 1)])
def test_sharded_train_step_matches_jax(world, shape):
    batch = _batch()
    results = world.run(_w_train, shape, _tree("llama"), batch, 2)
    metrics, grads, after = results[0]
    assert all(r[0] == metrics for r in results)  # every rank reports the global step
    want_loss, want_grads = _single_device()
    mesh_loss, mesh_grads = _jax_grads(batch, 2, shape)
    n_tok = int((batch["labels"][:, 1:] != IGNORE_INDEX).sum())
    want_norm = float(np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                                  for g in want_grads.values())))
    for ref_loss, ref_grads in ((want_loss, want_grads), (mesh_loss, mesh_grads)):
        assert abs(metrics[0][0] - ref_loss) <= TOL * abs(ref_loss)
        assert metrics[0][2] == n_tok
        assert abs(metrics[0][1] - want_norm) <= TOL * want_norm
        assert grads.keys() == ref_grads.keys()
        for path, g in grads.items():
            assert _rel_err(g, ref_grads[path]) <= TOL, (shape, path)
    # the first step ran at lr 0, so the second saw the same loss; it moved
    # every leaf's every shard
    assert abs(metrics[1][0] - metrics[0][0]) <= 1e-6 * metrics[0][0]
    before = _flat(_tree("llama"))
    for path, value in after.items():
        assert np.isfinite(value).all() and value.shape == before[path].shape
        rows = value.reshape(value.shape[0], -1) != before[path].reshape(value.shape[0], -1)
        assert rows.any(axis=-1).mean() > 0.5 or path == "embed", path


@pytest.mark.parametrize("shape", [(1, 1, 1, 4), (2, 1, 1, 2)])
def test_expert_parallel_matches_jax(world, shape):
    J = _jax()
    jcfg = J.JaxConfig.tiny("llama", **{k: v for k, v in MOE.items() if k != "arch"})
    rng = np.random.RandomState(1)
    ids = rng.randint(4, 250, (8, 16)).astype(np.int32)
    lengths = np.full((8,), 16, np.int32)
    params = J.jax.tree.map(J.jnp.asarray, _tree("moe"))
    fwd = J.jax.jit(lambda p, i, sl: J.jfusion.llark_forward(
        jcfg, p, i, audio_patch_id=3, seq_lengths=sl))
    want, want_x = fwd(params, J.jnp.asarray(ids), J.jnp.asarray(lengths))
    mesh = J.jmesh.make_mesh(shape, devices=J.jax.devices()[:WORLD])
    sp = J.jmesh.shard_params(mesh, params, J.jmesh.param_partition_specs(jcfg))
    with mesh:
        mesh_out, mesh_x = fwd(sp, J.jnp.asarray(ids), J.jnp.asarray(lengths))
    results = world.run(_w_moe_forward, shape, _tree("moe"), ids, lengths)
    logits = {r[0]: r[1] for r in results}
    got = np.concatenate([logits[i] for i in sorted(logits)])
    # the load-balancing loss is a mean over rows: the mean of the batch
    # shards' (equal row counts)
    aux = np.mean([r[2] for r in {r[0]: r for r in results}.values()])
    for ref, ref_x in ((want, want_x), (mesh_out, mesh_x)):
        assert _rel_err(got, ref) <= TOL
        assert abs(aux - float(ref_x["moe_aux_loss"])) <= 1e-6


@functools.lru_cache(maxsize=None)
def _lora_tree():
    """The llama tree with rank-4 LoRA factors on every target (B drawn
    from N(0, 0.05^2), so that both factors get gradients), in the JAX
    layout."""
    from llark_tpu_torch.models.lora import init_lora_params

    cfg = ModelConfig.tiny("llama", **{**{k: v for k, v in LLAMA.items() if k != "arch"},
                                       "lora_rank": 4, "lora_alpha": 8.0})
    params = init_lora_params(cfg, torch.Generator().manual_seed(1),
                              params_from_numpy(_tree("llama"), cfg, "cpu"))
    gen = torch.Generator().manual_seed(2)
    for name, t in params["layers"].items():
        if name.endswith("_lora_b"):
            t.normal_(std=0.05, generator=gen)
    return cfg, {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v.numpy())
                 for k, v in params.items()}


def _w_lora_grads(shape, batch):
    """LoRA stage on a mesh: the loss and the factors' and embedding's
    gradients through the sharded step's loss share and gradient sum."""
    cfg, tree = _lora_tree()
    mesh = tmesh.make_mesh(shape, device="cpu")
    lcfg, params = tmesh.shard_model(mesh, cfg, params_from_numpy(tree, cfg, "cpu"))
    tstep.ParamPartition(params, tstep.trainable_mask(params, lora=True))
    paths = [p for p, t in iter_leaves(params) if t.requires_grad]
    leaves = [t for _, t in iter_leaves(params) if t.requires_grad]
    rows = tmesh.batch_sharding(mesh)
    loss, n_tok, moe = tstep.make_loss_fn(lcfg, audio_patch_id=PATCH_ID)(
        params, {k: torch.from_numpy(rows(v)) for k, v in batch.items()})
    share, _, _ = tstep.sharded_loss_share(lcfg.shard, loss, n_tok, moe)
    grads = torch.autograd.grad(share, leaves, allow_unused=True, materialize_grads=True)
    grads = tstep.sync_grads(lcfg.shard, paths, list(grads))
    return float(lcfg.shard.batch_sum(share.detach())), {
        p: tmesh.gather_param(mesh, g, lcfg.shard.flat_specs[p]).numpy()
        for p, g in zip(paths, grads)}


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 1, 2)])
def test_lora_under_tensor_parallelism_matches_jax(world, shape):
    # column-parallel targets' A carries the tensor axis's gradient sum,
    # row-parallel ones sum x A over it before B
    J = _jax()
    cfg, tree = _lora_tree()
    jcfg = J.JaxConfig.tiny("llama", **{**{k: v for k, v in LLAMA.items() if k != "arch"},
                                        "lora_rank": 4, "lora_alpha": 8.0})
    batch = _batch(b=4)
    loss, grads = world.run(_w_lora_grads, shape, batch)[0]
    names = set(grads)

    def jloss(p):
        logits, _ = J.jfusion.llark_forward(
            jcfg, p, J.jnp.asarray(batch["input_ids"]),
            audio_encodings=J.jnp.asarray(batch["audio_encodings"]), audio_patch_id=PATCH_ID,
            audio_frame_counts=J.jnp.asarray(batch["audio_frame_counts"]),
            seq_lengths=J.jnp.asarray(batch["seq_lengths"]))
        return J.jfusion.causal_lm_loss(logits, J.jnp.asarray(batch["labels"]))[0]

    want, jgrads = J.jax.jit(J.jax.value_and_grad(jloss))(J.jax.tree.map(J.jnp.asarray, tree))
    jgrads = _flat(J.jax.tree.map(np.asarray, jgrads))
    assert abs(loss - float(want)) <= TOL * abs(float(want))
    assert names == {p for p in jgrads if "_lora_" in p} | {"embed", "mm_projector/kernel",
                                                            "mm_projector/bias"}
    for path in names:
        assert _rel_err(grads[path], jgrads[path]) <= TOL, path


# ---------------------------------------------------------------------------
# data split, checkpoints across meshes, data-parallel extraction
# ---------------------------------------------------------------------------


def test_split_by_host_keys_off_the_batch_shard(world):
    # tensor-parallel ranks read the same shards (a split by global rank
    # would train them on different rows); batch shards read disjoint,
    # covering sets
    urls = [f"s{i:02d}.tar" for i in range(10)]
    tp = world.run(_w_split, (1, 1, 4), urls)
    assert all(r == urls for r in tp)
    dp = world.run(_w_split, (4, 1, 1), urls)
    assert sorted(u for r in dp for u in r) == urls and all(len(r) < len(urls) for r in dp)
    mixed = world.run(_w_split, (2, 1, 2), urls)  # ranks 0,1 one shard; 2,3 the other
    assert mixed[0] == mixed[1] and mixed[2] == mixed[3]
    assert sorted(mixed[0] + mixed[2]) == urls
    assert split_by_host(urls, 1, 3) == urls[1::3]


def _write_shards(directory, n=6):
    writer = TarShardWriter(os.path.join(directory, "mir-train-%05d.tar"), max_count=3)
    rng = np.random.RandomState(11)
    for i in range(n):
        writer.write({
            "__key__": f"t{i:03d}",
            "json": {"response": [{"question": f"what genre is clip {i} ?",
                                   "answer": "ambient jazz ."}]},
            "audio_encoding.pyd": rng.randn(6, 16).astype(np.float32),
        })
    writer.close()


def test_checkpoint_saved_on_a_mesh_restores_on_another_and_on_none(world, tmp_path):
    # train() on a (1, 2, 2) mesh (fsdp and tensor both split) writes whole
    # tensors from rank 0; a (2, 1, 2) run resumes from it, and a single
    # process restores it exactly
    _write_shards(str(tmp_path))
    url = str(tmp_path / "mir-train-{00000..00001}.tar")
    first = world.run(_w_train_run, (1, 2, 2), str(tmp_path), url, 2)
    step, losses, whole = first[0]
    assert step == 2 and len(losses) == 2 and all(np.isfinite(losses))
    assert (tmp_path / "out" / "checkpoint-2").is_dir()
    cfg = ModelConfig.tiny(mm_hidden_size=16, dtype="float32",
                           vocab_size=whole["embed"].shape[0])
    params = init_llark_params(cfg, seed=5, device="cpu")
    tstep.ParamPartition(params, tstep.trainable_mask(params))
    state = TrainState.create(params, tstep.make_optimizer(TrainingArguments()))
    state, data_state = CheckpointManager(str(tmp_path / "out")).restore(state)
    assert state.step == 2 and data_state["batches_seen"] == 2
    for path, t in iter_leaves(state.params):
        np.testing.assert_array_equal(t.detach().numpy(), whole[path], err_msg=path)
    again = world.run(_w_train_run, (2, 1, 2), str(tmp_path), url, 3)
    assert again[0][0] == 3 and len(again[0][1]) == 1  # resumed at step 2


def test_data_parallel_clap_matches_one_process(world, tmp_path):
    # 3 clips in a batch of 3 over 4 ranks: padded, split, gathered, trimmed;
    # rank 0 writes what a one-process run writes
    wavs = str(tmp_path / "wavs")
    os.makedirs(wavs)
    rng = np.random.RandomState(0)
    for name, seconds in (("a", 3.0), ("b", 1.5), ("c", 12.0)):
        write_wav(os.path.join(wavs, f"{name}.wav"), 0.3 * rng.randn(int(48000 * seconds)), 48000)
    listed = world.run(_w_clap, wavs, str(tmp_path / "dp"))
    assert listed[0] == ["a.npy", "b.npy", "c.npy"]
    tcli.main(["clap", "--input-dir", wavs, "--output-dir", str(tmp_path / "one"), "--device",
               "cpu", "--tiny", "--batch-size", "3"])
    for name in listed[0]:
        got, want = np.load(tmp_path / "dp" / name), np.load(tmp_path / "one" / name)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
