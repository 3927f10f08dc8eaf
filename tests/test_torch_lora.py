"""The port's LoRA and QLoRA (models/lora.py, the decoder's `_lora_dense`,
training on a float, int8 or int4 base) against the JAX package, fp32 on
the CPU.

The same numpy tree -- a seeded init in the JAX package's layout with
non-zero LoRA factors -- goes into both packages (`params_from_numpy`);
quantized bases are quantized by the JAX package and carried across.
Tolerances, stated per case:
  * 1e-5 relative (to max |JAX|) where both sides compute in fp32 and
    differ only in summation order: projections, logits, merged weights,
    losses, gradient norms and train-step parameter changes;
  * exact equality for adapter files read across packages, trainable
    masks, flop counts and greedy tokens;
  * gradients of one model with and without activation recomputation, and
    under the three remat policies: 1e-6 relative (the recompute runs the
    same ops on the same inputs).
LoRA dropout masks come from each package's own generator, so parity runs
at lora_dropout 0; dropout is held inside the port (remat against none).
Every JAX result is computed once, in a module fixture.
"""

import dataclasses
import functools
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu import generate as jgen
from llark_tpu.config import ModelConfig as JaxConfig
from llark_tpu.config import TrainingArguments as JTrainingArguments
from llark_tpu.models import decoder as jdecoder
from llark_tpu.models import fusion as jfusion
from llark_tpu.models import lora as jlora
from llark_tpu.models import quant as jquant
from llark_tpu.models.utils import load_model_metadata as jload_model_metadata
from llark_tpu.models.utils import save_model_metadata as jsave_model_metadata
from llark_tpu.tokenization import TokenizerBundle as JBundle
from llark_tpu.tokenization import WordTokenizer as JWordTokenizer
from llark_tpu.train import flops as jflops
from llark_tpu.train import step as jstep
from llark_tpu.train.state import TrainState as JTrainState
from llark_tpu_torch import generate as tgen
from llark_tpu_torch.config import DataArguments, ModelArguments, ModelConfig, TrainingArguments
from llark_tpu_torch.data.webdataset import TarShardWriter
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models import decoder as tdecoder
from llark_tpu_torch.models import fusion as tfusion
from llark_tpu_torch.models import lora as tlora
from llark_tpu_torch.models import quant as tquant
from llark_tpu_torch.models.utils import (
    load_model_metadata,
    load_pretrained_model,
    save_model_metadata,
)
from llark_tpu_torch.ops import int8_matmul as tint8
from llark_tpu_torch.special_tokens import IGNORE_INDEX
from llark_tpu_torch.tokenization import TokenizerBundle, WordTokenizer
from llark_tpu_torch.train import flops as tflops
from llark_tpu_torch.train import step as tstep
from llark_tpu_torch.train.state import TrainState, iter_leaves
from llark_tpu_torch.train.tracking import MetricsWriter
from llark_tpu_torch.train.train import train

TOL = 1e-5
PATCH_ID = 7
GROUP = 32  # int4 scale group of the tiny models (hidden 64)
CONFIGS = {"llama": dict(arch="llama", num_kv_heads=2), "mpt": dict(arch="mpt")}
LORA = dict(lora_rank=4, lora_alpha=8.0, dtype="float32", param_dtype="float32", mm_hidden_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny tensors: one intra-op thread per process, as tests/test_torch_train.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6))


def _np(tree):
    return jax.tree.map(lambda t: np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else t),
                        tree)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(jcfg, tcfg, numpy tree with non-zero LoRA factors) of one config."""
    over = dict(CONFIGS[name])
    arch = over.pop("arch")
    tcfg = ModelConfig.tiny(arch, **over, **LORA)
    jcfg = JaxConfig.tiny(arch, **over, **LORA)
    tree = _np(tfusion.init_llark_params(tcfg, seed=0, device="cpu"))
    rng = np.random.RandomState(1)
    for target in tlora.LORA_TARGETS:
        if target in tree["layers"]:
            L, fan_in, fan_out = tree["layers"][target].shape
            r = tcfg.lora_rank
            tree["layers"][f"{target}_lora_a"] = (
                rng.randn(L, fan_in, r) / np.sqrt(fan_in)).astype(np.float32)
            tree["layers"][f"{target}_lora_b"] = (rng.randn(L, r, fan_out) * 0.05).astype(np.float32)
    return jcfg, tcfg, tree


@functools.lru_cache(maxsize=None)
def _tree(name, base):
    """The numpy tree on a float base, or its base quantized by the JAX
    package (int8; int4 in the rows layout, group 32)."""
    jcfg, _, tree = _setup(name)
    if base == "float":
        return tree
    jp = jax.tree.map(jnp.asarray, tree)
    jp = dict(jp, layers=dict(jp["layers"]))  # the calls take ownership
    if base == "int8":
        q = jquant.quantize_params_int8_incremental(jcfg, jp)
    else:
        q = jquant.quantize_params_int4_incremental(jcfg, jp, group=GROUP, layout="rows")
    return jax.tree.map(np.asarray, q)


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


def _forward_args(batch, to):
    return dict(audio_encodings=to(batch["audio_encodings"]), audio_patch_id=PATCH_ID,
                audio_frame_counts=to(batch["audio_frame_counts"]),
                seq_lengths=to(batch["seq_lengths"]))


# cases of the train-step parity: every base on Llama, the float base on MPT
STEP_CASES = [("llama", "float"), ("llama", "int8"), ("llama", "int4"), ("mpt", "float")]
STEP_ARGS = dict(learning_rate=1e-1, max_steps=10, warmup_ratio=0.1, weight_decay=0.01,
                 lr_scheduler_type="constant_with_warmup")
GEN_CASES = [("llama", "float"), ("llama", "int8")]
MAX_NEW = 6


def _gen_cfg(module):
    return module.GenerationConfig(max_new_tokens=MAX_NEW, temperature=0.0, stop_text="",
                                   decode_chunk=5)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's results on the shared trees: each projection of
    layer 0 through `_lora_dense`, the forward's logits, two LoRA train
    steps per STEP_CASES entry and greedy tokens per GEN_CASES entry."""
    out = {}
    batch = _batch(10)
    for name in CONFIGS:
        jcfg, _, tree = _setup(name)
        jp = jax.tree.map(jnp.asarray, tree)
        x = np.random.RandomState(2).randn(2, 5, jcfg.hidden_size).astype(np.float32)
        lp = {k: v[0] for k, v in jp["layers"].items()}
        for target in tlora.LORA_TARGETS:
            if target in lp:
                xin = x if lp[target].shape[0] == x.shape[-1] else np.random.RandomState(3).randn(
                    2, 5, lp[target].shape[0]).astype(np.float32)
                out["dense", name, target] = (xin, np.asarray(jdecoder._lora_dense(
                    jcfg, lp, target, jnp.asarray(xin), jnp.float32, None)))
        logits, _ = jfusion.llark_forward(jcfg, jp, jnp.asarray(batch["input_ids"]),
                                          **_forward_args(batch, jnp.asarray))
        out["logits", name] = np.asarray(logits)
        out["merged", name] = jax.tree.map(np.asarray, jlora.merge_lora(jcfg, jp))
    for name, base in STEP_CASES:
        jcfg = _setup(name)[0]
        jp = jax.tree.map(jnp.asarray, _tree(name, base))
        opt = jstep.make_optimizer(JTrainingArguments(**STEP_ARGS), jp)
        partition = jstep.ParamPartition(jp, jstep.trainable_mask(jp, lora=True))
        state = JTrainState.create(jp, opt, partition)
        fn = jax.jit(jstep.make_train_step(jcfg, opt, audio_patch_id=PATCH_ID, grad_accum_steps=2,
                                           dropout_seed=0, partition=partition))
        metrics = []
        for _ in range(2):
            state, m = fn(state, {k: jnp.asarray(v) for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        out["steps", name, base] = (metrics, jax.tree.map(np.asarray, state.params))
    gb = _batch(20, s=24)
    for name, base in GEN_CASES:
        jcfg = _setup(name)[0]
        gen = jgen.Generator(jcfg, jax.tree.map(jnp.asarray, _tree(name, base)), PATCH_ID,
                             _gen_cfg(jgen), max_cache_len=64)
        toks = gen.generate(gb["input_ids"], gb["seq_lengths"], gb["audio_encodings"],
                            gb["audio_frame_counts"])
        out["tokens", name, base] = [list(map(int, t)) for t in toks]
    return out


# ---------------------------------------------------------------------------
# the forward: _lora_dense, the decoder, merge and strip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lora_dense_and_forward_match_jax(jax_ref, name):
    _, tcfg, tree = _setup(name)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    assert len(tlora.lora_keys(tparams)) == 2 * sum(t in tree["layers"] for t in tlora.LORA_TARGETS)
    lp = {k: v[0] for k, v in tparams["layers"].items()}
    for target in tlora.LORA_TARGETS:
        if target in lp:
            x, want = jax_ref["dense", name, target]
            got = tdecoder._lora_dense(tcfg, lp, target, torch.from_numpy(x), torch.float32, None)
            assert _rel(got.numpy(), want) < TOL, target
    batch = _batch(10)
    with torch.no_grad():
        logits, _ = tfusion.llark_forward(tcfg, tparams, torch.from_numpy(batch["input_ids"]),
                                          **_forward_args(batch, torch.from_numpy))
    live = np.arange(16)[None, :] < batch["seq_lengths"][:, None]
    want = jax_ref["logits", name]
    assert _rel(logits.numpy()[live], want[live]) < TOL
    # the delta is active: the stripped base computes other logits
    with torch.no_grad():
        base, _ = tfusion.llark_forward(tcfg, tlora.strip_lora(tparams),
                                        torch.from_numpy(batch["input_ids"]),
                                        **_forward_args(batch, torch.from_numpy))
    assert _rel(base.numpy()[live], want[live]) > 1e-3


@pytest.mark.parametrize("name", list(CONFIGS))
def test_merge_and_strip_match_jax(jax_ref, name):
    _, tcfg, tree = _setup(name)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    merged = tlora.merge_lora(tcfg, tparams)
    want = jax_ref["merged", name]
    assert not tlora.lora_keys(merged) and merged["layers"].keys() == want["layers"].keys()
    for path, t in iter_leaves(merged):
        w = dict(iter_leaves(want))[path]
        assert t.dtype == torch.float32 and _rel(t.numpy(), w) < TOL, path
    stripped = tlora.strip_lora(tparams)
    assert sorted(stripped["layers"]) == sorted(k for k in tree["layers"] if "_lora_" not in k)
    assert stripped["layers"]["wq"] is tparams["layers"]["wq"]
    # merged weights serve the unmerged model's logits
    batch = _batch(10)
    with torch.no_grad():
        a, _ = tfusion.llark_forward(tcfg, merged, torch.from_numpy(batch["input_ids"]),
                                     **_forward_args(batch, torch.from_numpy))
    assert _rel(a.numpy(), jax_ref["logits", name]) < TOL


@pytest.mark.parametrize("base", ["int8", "int4"])
def test_quantize_skips_lora_factors(base):
    _, tcfg, tree = _setup("llama")
    tparams = params_from_numpy(tree, tcfg, "cpu")
    factors = {k: v for k, v in tparams["layers"].items() if "_lora_" in k}
    if base == "int8":
        q = tquant.quantize_params_int8_incremental(tcfg, tparams)
    else:
        q = tquant.quantize_params_int4_incremental(tcfg, tparams, group=GROUP, layout="rows")
    for k, v in factors.items():
        assert q["layers"][k] is v
    assert tquant.is_quantized(q["layers"]["wq"]) or tquant.is_quantized_int4(q["layers"]["wq"])
    jq = _tree("llama", base)
    assert sorted(q["layers"]) == sorted(jq["layers"])


# ---------------------------------------------------------------------------
# adapters, masks and flops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adapter_files_load_in_the_other_package(writer, tmp_path):
    jcfg, tcfg, tree = _setup("llama")
    path = str(tmp_path / "adapter")
    if writer == "jax":
        jp = jax.tree.map(jnp.asarray, tree)
        jlora.save_lora_adapter(path, jcfg, jp, extra_non_lora={"embed": jp["embed"]})
        base = params_from_numpy(jax.tree.map(np.zeros_like, tree), tcfg, "cpu")
        loaded, meta = tlora.load_lora_adapter(path, base)
        got = _np(loaded)
    else:
        tp = params_from_numpy(tree, tcfg, "cpu")
        tlora.save_lora_adapter(path, tcfg, tp, extra_non_lora={"embed": tp["embed"]})
        loaded, meta = jlora.load_lora_adapter(path, jax.tree.map(np.zeros_like, tree))
        got = jax.tree.map(np.asarray, loaded)
    assert meta == {"lora_rank": 4, "lora_alpha": 8}
    assert sorted(np.load(os.path.join(path, "adapter.npz")).files) == sorted(
        ["__lora_rank__", "__lora_alpha__"] + [f"layers.{k}" for k in tlora.lora_keys(tree)])
    for k in tlora.lora_keys(tree):
        np.testing.assert_array_equal(got["layers"][k], tree["layers"][k])
    np.testing.assert_array_equal(got["embed"], tree["embed"])
    np.testing.assert_array_equal(got["mm_projector"]["kernel"], tree["mm_projector"]["kernel"])
    assert not got["layers"]["wq"].any()  # the base is not in the adapter


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_model_metadata_carries_lora_across_packages(writer, tmp_path):
    # a run directory of either package's train() rebuilds the adapted
    # architecture in the other: the lora_* fields round-trip
    over = dict(lora_rank=64, lora_alpha=16.0, lora_dropout=0.05)
    if writer == "jax":
        jsave_model_metadata(str(tmp_path), JaxConfig.tiny(**over),
                             JBundle.from_tokenizer(JWordTokenizer(32)))
        cfg, _ = load_model_metadata(str(tmp_path))
    else:
        save_model_metadata(str(tmp_path), ModelConfig.tiny(**over),
                            TokenizerBundle.from_tokenizer(WordTokenizer(32)))
        cfg, _ = jload_model_metadata(str(tmp_path))
    assert (cfg.lora_rank, cfg.lora_alpha, cfg.lora_dropout) == (64, 16.0, 0.05)


@pytest.mark.parametrize("flags", [
    dict(lora=True), dict(lora=True, freeze_mm_mlp_adapter=True),
    dict(lora=True, tune_mm_mlp_adapter=True), dict(tune_mm_mlp_adapter=True)])
@pytest.mark.parametrize("base", ["float", "int8"])
def test_trainable_mask_matches_jax(flags, base):
    tree = _tree("llama", base)
    want = jax.tree.map(bool, jstep.trainable_mask(tree, **flags))
    got = tstep.trainable_mask(params_from_numpy(tree, _setup("llama")[1], "cpu"), **flags)
    assert got == want


def test_flops_with_the_lora_term_match_jax():
    for rank in (4, 64):
        for arch in ("llama", "mpt"):
            jcfg, tcfg = JaxConfig.tiny(arch, lora_rank=rank), ModelConfig.tiny(arch, lora_rank=rank)
            assert tflops.train_flops_per_token(tcfg, 512, frozen_base=True) == \
                jflops.train_flops_per_token(jcfg, 512, frozen_base=True)
        big_t, big_j = ModelConfig.llama2_7b(lora_rank=rank), JaxConfig(lora_rank=rank)
        got = tflops.train_flops_per_token(big_t, 512, frozen_base=True)
        assert got == jflops.train_flops_per_token(big_j, 512, frozen_base=True)
        assert got > tflops.train_flops_per_token(dataclasses.replace(big_t, lora_rank=0), 512,
                                                  frozen_base=True)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,base", STEP_CASES)
def test_lora_train_steps_match_jax(jax_ref, name, base):
    # Two steps on one batch, 2 micro-batches, at lora_dropout 0, as
    # tests/test_torch_train.py::test_train_step_matches_jax holds them: the
    # first runs at the warmup's lr of 0, so both see the same gradient g
    # and the second moves each trainable leaf by -lr (g / (|g| + eps) + wd
    # p); checked where |g| >= 1e-5 (or g == 0: decay alone)
    _, tcfg, _ = _setup(name)
    tparams = params_from_numpy(_tree(name, base), tcfg, "cpu")
    tstep.ParamPartition(tparams, tstep.trainable_mask(tparams, lora=True))
    opt = tstep.make_optimizer(TrainingArguments(**STEP_ARGS))
    state = TrainState.create(tparams, opt)
    fn = tstep.make_train_step(tcfg, opt, audio_patch_id=PATCH_ID, grad_accum_steps=2,
                               dropout_seed=0)
    before = {p: t.detach().clone() for p, t in iter_leaves(tparams)}
    batch = {k: torch.from_numpy(v) for k, v in _batch(10).items()}
    jmetrics, jparams = jax_ref["steps", name, base]
    for i in range(2):
        state, m = fn(state, batch)
        want = jmetrics[i]
        assert abs(float(m["loss"]) - want["loss"]) <= TOL * abs(want["loss"])
        assert int(m["num_tokens"]) == int(want["num_tokens"])
        assert abs(float(m["grad_norm"]) - want["grad_norm"]) <= TOL * want["grad_norm"]
        if i == 0:
            grads = [mu / 0.1 for mu in state.opt_state["mu"]]
    jafter = dict(iter_leaves(jparams))
    trained = iter(grads)
    n_trained = 0
    for path, t in iter_leaves(state.params):
        if not t.requires_grad:  # frozen in both: the base, norms, the head
            assert torch.equal(t, before[path]), path
            assert np.array_equal(jafter[path], before[path].numpy()), path
            continue
        n_trained += 1
        want = jafter[path] - before[path].numpy()
        got = t.detach().numpy() - before[path].numpy()
        g = next(trained).abs().numpy()
        resolved = g >= 1e-5
        assert resolved.sum() > 0.5 * (g > 0).sum(), path
        checked = resolved | (g == 0)
        assert np.abs(got - want)[checked].max() <= TOL * np.abs(want).max(), path
    assert n_trained == len(tlora.lora_keys(tparams)) + 3  # + embed, projector kernel, bias


def _remat_grads(cfg, params, dropout_seed):
    leaves = [params["layers"][k].requires_grad_() for k in tlora.lora_keys(params)]
    batch = _batch(10)
    logits, _ = tfusion.llark_forward(cfg, params, torch.from_numpy(batch["input_ids"]),
                                      **_forward_args(batch, torch.from_numpy),
                                      dropout_seed=dropout_seed)
    return torch.autograd.grad(logits.square().mean(), leaves)


def test_dropout_masks_survive_the_remat_recompute():
    # each mask is drawn from a generator seeded by (seed, layer, target):
    # the recompute of a checkpointed layer draws the same one, so the
    # gradient with remat equals the gradient without
    _, tcfg, tree = _setup("llama")
    cfg = dataclasses.replace(tcfg, lora_dropout=0.05)
    tparams = params_from_numpy(tree, cfg, "cpu")
    plain = _remat_grads(cfg, tparams, 123)
    remat = _remat_grads(dataclasses.replace(cfg, remat=True), tparams, 123)
    for a, b in zip(remat, plain):
        assert _rel(a.numpy(), b.numpy()) <= 1e-6
    undropped = _remat_grads(cfg, tparams, None)
    assert max(_rel(a.numpy(), b.numpy()) for a, b in zip(plain, undropped)) > 1e-3


@pytest.mark.parametrize("policy", ["dots", "dots_narrow"])
def test_dots_policies_match_full(policy, monkeypatch):
    # intermediate 256 > 3 x hidden 64: "dots_narrow" recomputes the gate
    # and up projections, "dots" recomputes no product; the int8 operator's
    # runs count what each policy saves
    jcfg, tcfg, tree = _setup("llama")
    cfg = dataclasses.replace(tcfg, intermediate_size=256, lora_dropout=0.05, remat=True)
    tparams = tfusion.init_llark_params(cfg, seed=0, device="cpu")
    tparams = tlora.init_lora_params(cfg, torch.Generator().manual_seed(1), tparams)
    for k in tlora.lora_keys(tparams):
        if k.endswith("_lora_b"):
            tparams["layers"][k].normal_(0.0, 0.05, generator=torch.Generator().manual_seed(2))
    tparams = tquant.quantize_params_int8_incremental(cfg, tparams)
    runs = []
    product = tint8._int8_product
    monkeypatch.setattr(tint8, "_int8_product", lambda *a: runs.append(1) or product(*a))
    want = _remat_grads(cfg, tparams, 5)
    n_full = len(runs)
    runs.clear()
    got = _remat_grads(dataclasses.replace(cfg, remat_policy=policy), tparams, 5)
    per_forward = 7 * cfg.num_layers
    assert n_full == 2 * per_forward
    assert len(runs) == per_forward + (2 * cfg.num_layers if policy == "dots_narrow" else 0)
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b.numpy()) <= 1e-6


def _write_shard(directory, mm=16, frames=6):
    writer = TarShardWriter(os.path.join(directory, "mir-train-%05d.tar"), max_count=10)
    rng = np.random.RandomState(11)
    for i in range(4):
        writer.write({
            "__key__": f"t{i:03d}",
            "json": {"response": [{"question": f"what genre is clip {i} ?",
                                   "answer": "ambient jazz ."}]},
            "audio_encoding.pyd": rng.randn(frames, mm).astype(np.float32),
        })
    writer.close()
    return writer.written_paths[0]


def test_train_qlora_int8_on_cpu_writes_an_adapter_jax_reads(tmp_path):
    shard = _write_shard(str(tmp_path))
    model_args = ModelArguments(model_name_or_path="tiny", mm_hidden_size=16)
    data_args = DataArguments(train_data_path=shard, max_audio_frames=6,
                              task_sample_probs={"mir": 1.0})
    training_args = TrainingArguments(
        output_dir=str(tmp_path / "out"), per_device_train_batch_size=2,
        gradient_accumulation_steps=2, model_max_length=64, learning_rate=1e-2, max_steps=2,
        save_steps=100, logging_steps=1, seed=0, lora_enable=True, lora_r=4, lora_alpha=8,
        bits=8)
    cfg = ModelConfig.tiny(mm_hidden_size=16, dtype="float32", remat=True)
    result = train(model_args, data_args, training_args, model_cfg=cfg, device="cpu")
    assert result["final_step"] == 2 and all(np.isfinite(result["losses"]))
    params, rcfg = result["state"].params, result["cfg"]
    assert (rcfg.lora_rank, rcfg.lora_alpha, rcfg.lora_dropout) == (4, 8.0, 0.05)
    # the base stays int8, exactly the quantized init
    fresh = tquant.quantize_params_int8_incremental(
        rcfg, tfusion.init_llark_params(rcfg, seed=0, device="cpu"))
    for name in ("wq", "w_down"):
        assert params["layers"][name]["q"].dtype == torch.int8
        assert torch.equal(params["layers"][name]["q"], fresh["layers"][name]["q"])
    assert all(params["layers"][k].abs().max() > 0 for k in tlora.lora_keys(params)
               if k.endswith("_lora_b"))
    # the JAX package reads the adapter
    adapter = str(tmp_path / "out" / "adapter")
    assert sorted(os.listdir(adapter)) == ["adapter.npz", "non_lora_trainables.npz"]
    jtree = jax.tree.map(np.zeros_like, _np(params))
    loaded, meta = jlora.load_lora_adapter(adapter, jtree)
    assert meta == {"lora_rank": 4, "lora_alpha": 8}
    for k in tlora.lora_keys(params):
        np.testing.assert_array_equal(np.asarray(loaded["layers"][k]), _np(params["layers"][k]))
    np.testing.assert_array_equal(np.asarray(loaded["embed"]), _np(params["embed"]))
    # the run directory serves with its factors unmerged
    scfg, sparams, bundle = load_pretrained_model(str(tmp_path / "out"), device="cpu")
    assert scfg == rcfg and sparams["layers"]["wq"]["q"].dtype == torch.int8
    assert tlora.lora_keys(sparams) == tlora.lora_keys(params)
    gb = _batch(20, s=24, vocab=64, mm=16)
    gen = tgen.Generator(scfg, sparams, bundle.audio_patch_id, _gen_cfg(tgen), max_cache_len=64,
                         device="cpu")
    ref = tgen.Generator(rcfg, params, bundle.audio_patch_id, _gen_cfg(tgen), max_cache_len=64,
                         device="cpu")
    args = (gb["input_ids"], gb["seq_lengths"], gb["audio_encodings"], gb["audio_frame_counts"])
    assert gen.generate(*args) == ref.generate(*args)


@pytest.mark.parametrize("name,base", GEN_CASES)
def test_greedy_tokens_from_unmerged_lora_match_jax(jax_ref, name, base):
    _, tcfg, _ = _setup(name)
    gen = tgen.Generator(tcfg, params_from_numpy(_tree(name, base), tcfg, "cpu"), PATCH_ID,
                         _gen_cfg(tgen), max_cache_len=64, device="cpu")
    gb = _batch(20, s=24)
    got = gen.generate(gb["input_ids"], gb["seq_lengths"], gb["audio_encodings"],
                       gb["audio_frame_counts"])
    assert got == jax_ref["tokens", name, base]


# ---------------------------------------------------------------------------
# tracking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("installed", [True, False], ids=["tensorboardX", "missing"])
def test_tensorboard_events_or_the_warning(installed, tmp_path, monkeypatch, caplog):
    if not installed:
        monkeypatch.setitem(sys.modules, "tensorboardX", None)  # import raises ImportError
    with caplog.at_level(logging.WARNING, logger="llark_tpu_torch.tracking"):
        writer = MetricsWriter(str(tmp_path), "tensorboard")
        writer.log(3, loss=1.5, grad_norm=0.25)
        writer.close()
    assert (tmp_path / "metrics.jsonl").read_text().count('"loss": 1.5') == 1
    events = [n for n in os.listdir(tmp_path / "tb") if "tfevents" in n] if installed else []
    if installed:
        assert events and os.path.getsize(tmp_path / "tb" / events[0]) > 0
        assert "tensorboardX unavailable" not in caplog.text
    else:
        assert not (tmp_path / "tb").exists()
        assert "tensorboardX unavailable" in caplog.text
