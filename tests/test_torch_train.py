"""The port's training path against the JAX package's, on the CPU.

Both packages get the same numpy inputs and the same weights (a seeded init
in the JAX package's layout, handed to the port through
`params_from_numpy`). Tolerances, stated per case:
  * 1e-5 relative (to max |JAX|) where both sides compute in fp32 and
    differ only in summation order: logits, losses, gradients, one
    optimizer step, train steps (loss and parameter change);
  * 1e-6 relative for learning rates (optax computes them in fp32, the
    port in double);
  * exact equality for data batches and integer token counts.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llark_tpu import conversation as jconv
from llark_tpu import tokenization as jtok
from llark_tpu.config import (
    DataArguments as JDataArguments,
    ModelConfig as JaxConfig,
    TrainingArguments as JTrainingArguments,
)
from llark_tpu.data.pipeline import make_data_module as jmake_data_module
from llark_tpu.models import decoder as jdecoder
from llark_tpu.models import fusion as jfusion
from llark_tpu.models.utils import load_model_metadata as jload_model_metadata
from llark_tpu.tokenization import TokenizerBundle as JBundle
from llark_tpu.tokenization import WordTokenizer as JWordTokenizer
from llark_tpu.tokenization import preprocess_conversation as jpreprocess
from llark_tpu.train import checkpoint as jcheckpoint
from llark_tpu.train import flops as jflops
from llark_tpu.train import step as jstep
from llark_tpu.train.state import TrainState as JTrainState
from llark_tpu_torch import conversation as tconv
from llark_tpu_torch import storage
from llark_tpu_torch import tokenization as ttok
from llark_tpu_torch.config import DataArguments, ModelArguments, ModelConfig, TrainingArguments
from llark_tpu_torch.data.pipeline import make_data_module
from llark_tpu_torch.data.webdataset import TarShardWriter
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models import decoder as tdecoder
from llark_tpu_torch.models import fusion as tfusion
from llark_tpu_torch.models.utils import load_model_metadata, save_model_metadata
from llark_tpu_torch.special_tokens import IGNORE_INDEX
from llark_tpu_torch.tokenization import TokenizerBundle, WordTokenizer, preprocess_conversation
from llark_tpu_torch.train import flops as tflops
from llark_tpu_torch.train import step as tstep
from llark_tpu_torch.train.state import TrainState, iter_leaves
from llark_tpu_torch.train.train import train

TOL = 1e-5
PATCH_ID = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tensors here are tiny: with several test processes sharing the
    # cores, torch's default of one intra-op thread per core makes each op
    # wait on the others
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_err(got, want):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6))


def _np(t):
    return t.detach().float().numpy()


@functools.lru_cache(maxsize=None)
def _numpy_tree(arch, num_kv_heads):
    cfg = ModelConfig.tiny(arch, num_kv_heads=num_kv_heads, dtype="float32", param_dtype="float32")
    params = tfusion.init_llark_params(cfg, seed=3, device="cpu")
    return jax.tree.map(lambda t: t.numpy(), params)


def _models(arch, num_kv_heads=4, **kw):
    over = dict(num_kv_heads=num_kv_heads, dtype="float32", param_dtype="float32", **kw)
    jcfg, tcfg = JaxConfig.tiny(arch, **over), ModelConfig.tiny(arch, **over)
    tree = _numpy_tree(arch, num_kv_heads)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tree, tcfg, "cpu")


def _batch(seed, b=4, s=16, frames=3, vocab=256, mm=48):
    """input ids with audio patch slots, labels with IGNORE_INDEX on the
    prompt, ragged lengths: the data pipeline's batch contract."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(8, vocab, (b, s)).astype(np.int32)
    ids[:, 2:2 + frames] = PATCH_ID
    labels = ids.copy()
    labels[:, :6] = IGNORE_INDEX
    lengths = np.array([s, s - 4, s, s - 7][:b], np.int32)
    for i, n in enumerate(lengths):
        labels[i, n:] = IGNORE_INDEX
    return dict(
        input_ids=ids, labels=labels, seq_lengths=lengths,
        audio_encodings=rng.randn(b, frames, mm).astype(np.float32),
        audio_frame_counts=np.array([frames, frames - 1, frames, 1][:b], np.int32),
    )


# ---------------------------------------------------------------------------
# model-side pieces: logits (the fp32-accumulator repair) and the losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama", "mpt"])
def test_compute_logits_bf16_keeps_the_fp32_accumulator(arch):
    # bf16 hidden states and bf16-rounded weights, as the model runs in
    # bf16: the JAX package's logits are the fp32 accumulator of that
    # product. A product rounded to bf16 and widened (the port before this
    # change) is ~4e-3 off; tolerance 1e-5 relative.
    jcfg, jparams, tcfg, tparams = _models(arch)
    jcfg = JaxConfig.tiny(arch, param_dtype="float32")  # bf16 compute
    tcfg = ModelConfig.tiny(arch, param_dtype="float32")
    hidden = np.random.RandomState(5).randn(2, 7, tcfg.hidden_size).astype(np.float32)
    jh = jnp.asarray(hidden).astype(jnp.bfloat16)
    th = torch.from_numpy(hidden).to(torch.bfloat16)
    want = jdecoder.compute_logits(jcfg, jparams, jh)
    got = tdecoder.compute_logits(tcfg, tparams, th)
    assert got.dtype == torch.float32
    assert _rel_err(got, want) < TOL


def test_tied_head_freezes_rows_below_trainable_token_start():
    _, _, tcfg, tparams = _models("mpt")
    embed = tparams["embed"].requires_grad_()
    hidden = torch.from_numpy(np.random.RandomState(6).randn(2, 3, tcfg.hidden_size).astype(np.float32))
    tdecoder.compute_logits(tcfg, tparams, hidden, trainable_token_start=250).sum().backward()
    assert float(embed.grad[:250].abs().max()) == 0.0
    assert float(embed.grad[250:].abs().min()) > 0.0


def test_causal_lm_loss_matches_jax():
    rng = np.random.RandomState(7)
    logits = rng.randn(3, 9, 50).astype(np.float32) * 3
    labels = rng.randint(0, 50, (3, 9)).astype(np.int32)
    labels[0, :4] = IGNORE_INDEX
    labels[2] = IGNORE_INDEX  # a row with nothing to predict
    jl, jn = jfusion.causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    tl, tn = tfusion.causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert int(tn) == int(jn)
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))


@pytest.mark.parametrize("arch,start", [("llama", None), ("mpt", 250)])
def test_chunked_causal_lm_loss_matches_jax(arch, start):
    # the loss and its gradient with respect to the hidden states, 3 chunks
    jcfg, jparams, tcfg, tparams = _models(arch)
    rng = np.random.RandomState(8)
    hidden = rng.randn(2, 12, tcfg.hidden_size).astype(np.float32)
    labels = rng.randint(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    labels[1, 7:] = IGNORE_INDEX

    def jloss(h):
        return jfusion.chunked_causal_lm_loss(jcfg, jparams, h, jnp.asarray(labels), 4, start)[0]

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(hidden))
    th = torch.from_numpy(hidden).requires_grad_()
    tl, tn = tfusion.chunked_causal_lm_loss(tcfg, tparams, th, torch.from_numpy(labels), 4, start)
    tl.backward()
    tl = float(tl.detach())
    assert int(tn) == int((labels[:, 1:] != IGNORE_INDEX).sum())
    assert abs(tl - float(jl)) <= TOL * abs(float(jl))
    assert _rel_err(th.grad, jg) < TOL
    # and the unchunked loss of the same hidden states
    full, _ = tfusion.causal_lm_loss(tdecoder.compute_logits(tcfg, tparams, th), torch.from_numpy(labels))
    assert abs(float(full.detach()) - tl) <= TOL * abs(tl)


# ---------------------------------------------------------------------------
# optimizer and schedule against optax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant", "constant_with_warmup"])
def test_lr_schedule_matches_optax(kind):
    kw = dict(learning_rate=3e-4, max_steps=40, warmup_ratio=0.1, lr_scheduler_type=kind)
    jsched = jstep.lr_schedule(JTrainingArguments(**kw))
    tsched = tstep.lr_schedule(TrainingArguments(**kw))
    for count in range(0, 45):
        want = float(jsched(count))
        assert abs(tsched(count) - want) <= 1e-6 * 3e-4, (count, tsched(count), want)


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0], ids=["unclipped", "clipped"])
def test_optimizer_steps_match_optax(grad_scale):
    # two updates of optax.chain(clip_by_global_norm(1), adamw(...)) on the
    # same params and grads; the first runs at the warmup's lr of 0
    # lr 0.1: each change is ~0.1, so the fp32 rounding of the parameters
    # themselves (~1e-7 at magnitude 1) stays ~1e-6 of it
    kw = dict(learning_rate=1e-1, max_steps=10, warmup_ratio=0.1,
              lr_scheduler_type="constant_with_warmup", weight_decay=0.1)
    rng = np.random.RandomState(9)
    shapes = [(5, 3), (7,), (2, 4, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * grad_scale for s in shapes] for _ in range(2)]
    jopt = jstep.make_optimizer(JTrainingArguments(**kw), params)
    jp, jstate = [jnp.asarray(p) for p in params], None
    jstate = jopt.init(jp)
    topt = tstep.make_optimizer(TrainingArguments(**kw))
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = topt.init(tp)
    for g in grads:
        updates, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        norm = topt.update([torch.from_numpy(x) for x in g], tstate, tp)
        assert abs(float(norm) - float(optax.global_norm(g))) <= TOL * float(norm)
    assert tstate["count"] == 2
    for got, want, start in zip(tp, jp, params):
        assert _rel_err(got.numpy() - start, np.asarray(want) - start) < TOL


# ---------------------------------------------------------------------------
# train step against the JAX package's, fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "stage,accum", [("full", 1), ("adapter", 1), ("full", 2)], ids=["full", "adapter", "accum2"]
)
def test_train_step_matches_jax(stage, accum):
    # Two steps on one batch. The first runs at the warmup's lr of 0, so
    # both see the same gradient g and the second moves each trainable
    # parameter by -lr (g / (|g| + eps) + wd p). Loss, token count and
    # gradient norm agree within 1e-5 relative, and so does the parameter
    # change (relative to its max) wherever |g| >= 1e-5: below that, Adam's
    # per-element normalisation (eps 1e-8) turns the fp32 summation-order
    # differences of a gradient (~1e-8 here) into visible changes. lr 0.1
    # keeps each change large against the parameters' own fp32 rounding.
    wd = 0.0 if stage == "adapter" else 0.01  # no decay: frozen rows stay exactly
    args = dict(learning_rate=1e-1, max_steps=10, warmup_ratio=0.1, weight_decay=wd,
                lr_scheduler_type="constant_with_warmup")
    jcfg, jparams, tcfg, tparams = _models("llama", num_kv_heads=2)
    start = 200 if stage == "adapter" else None
    flags = dict(freeze_backbone=True, tune_mm_mlp_adapter=True) if stage == "adapter" else {}
    jopt = jstep.make_optimizer(JTrainingArguments(**args), jparams)
    partition = None
    if flags:
        partition = jstep.ParamPartition(jparams, jstep.trainable_mask(jparams, **flags))
    tstep.ParamPartition(tparams, tstep.trainable_mask(tparams, **flags))
    jstate = JTrainState.create(jparams, jopt, partition)
    jfn = jax.jit(jstep.make_train_step(
        jcfg, jopt, audio_patch_id=PATCH_ID, grad_accum_steps=accum,
        trainable_token_start=start, partition=partition))
    topt = tstep.make_optimizer(TrainingArguments(**args))
    tstate = TrainState.create(tparams, topt)
    tfn = tstep.make_train_step(tcfg, topt, audio_patch_id=PATCH_ID, grad_accum_steps=accum,
                                trainable_token_start=start)
    before = {p: t.detach().clone() for p, t in iter_leaves(tparams)}
    batch = _batch(10)
    for i in range(2):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tfn(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
        assert int(tm["num_tokens"]) == int(jm["num_tokens"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= TOL * float(jm["grad_norm"])
        if i == 0:  # after the first step, mu = (1 - b1) g
            grads = [mu / 0.1 for mu in tstate.opt_state["mu"]]
    assert tstate.step == int(jstate.step) == 2
    jafter = dict(iter_leaves(jax.tree.map(np.asarray, jstate.params)))
    trained = iter(grads)
    for path, t in iter_leaves(tstate.params):
        want = jafter[path] - before[path].numpy()
        got = _np(t) - before[path].numpy()
        if not t.requires_grad:
            assert np.abs(got).max() == 0.0 == np.abs(want).max(), path  # frozen in both
            continue
        g = next(trained).abs().numpy()
        resolved = g >= 1e-5
        assert resolved.sum() > 0.5 * (g > 0).sum(), path
        # untouched embedding rows (g == 0) move by the decay alone
        checked = resolved | (g == 0)
        assert np.abs(got - want)[checked].max() <= TOL * np.abs(want).max(), path
    if stage == "adapter":
        # embedding rows below trainable_token_start do not move
        assert torch.equal(tstate.params["embed"][:start], before["embed"][:start])
        assert not torch.equal(tstate.params["embed"][start:], before["embed"][start:])


# ---------------------------------------------------------------------------
# data: the same batches as the JAX package's pipeline
# ---------------------------------------------------------------------------


def _write_shards(directory, n=5, mm=16, frames=6):
    writer = TarShardWriter(os.path.join(directory, "mir-train-%05d.tar"), max_count=3)
    rng = np.random.RandomState(11)
    for i in range(n):
        writer.write({
            "__key__": f"t{i:03d}",
            "json": {"response": [
                {"question": f"what genre is clip {i} ?", "answer": "ambient jazz ."},
                {"question": "tempo ?", "answer": f"{100 + i} bpm ."},
            ]},
            "audio_encoding.pyd": rng.randn(frames + i % 2, mm).astype(np.float32),
        })
    writer.close()
    return writer.written_paths


def test_data_module_batches_equal_jax(tmp_path):
    paths = _write_shards(str(tmp_path))
    assert len(paths) == 2
    url = str(tmp_path / "mir-train-{00000..00001}.tar")
    kw = dict(batch_size=3, max_seq_len=64, mm_hidden_size=16, seed=4)
    jdm = jmake_data_module(JBundle.from_tokenizer(JWordTokenizer(64)),
                            JDataArguments(train_data_path=url, max_audio_frames=6), **kw)
    tdm = make_data_module(TokenizerBundle.from_tokenizer(WordTokenizer(64)),
                           DataArguments(train_data_path=url, max_audio_frames=6), **kw)
    jit, tit = jdm["train_iterator"](skip_batches=1), tdm["train_iterator"](skip_batches=1)
    for _ in range(4):
        jb, tb = next(jit), next(tit)
        assert jb.keys() == tb.keys()
        for k in jb:
            if isinstance(jb[k], np.ndarray):
                assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k]), k
            else:
                assert jb[k] == tb[k], k


def test_preprocess_conversation_matches_jax():
    turns = [{"from": "human", "value": "<audio_start> <audio_patch> <audio_end> what key ?"},
             {"from": "gpt", "value": "d minor ."},
             {"from": "human", "value": "and the tempo ?"},
             {"from": "gpt", "value": "slow ."}]
    want = jpreprocess(turns, JBundle.from_tokenizer(JWordTokenizer(128)))
    got = preprocess_conversation(turns, TokenizerBundle.from_tokenizer(WordTokenizer(128)))
    for k in ("input_ids", "labels"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    assert (got["labels"] == IGNORE_INDEX).sum() > 0


# ---------------------------------------------------------------------------
# the trainer on the CPU
# ---------------------------------------------------------------------------


def _train_args(tmp_path, shard_url, max_steps, **model_kw):
    model_args = ModelArguments(model_name_or_path="tiny", mm_hidden_size=16, **model_kw)
    data_args = DataArguments(train_data_path=shard_url, eval_data_path=shard_url,
                              max_audio_frames=6, task_sample_probs={"mir": 1.0})
    training_args = TrainingArguments(
        output_dir=str(tmp_path / "out"), per_device_train_batch_size=2,
        gradient_accumulation_steps=2, model_max_length=64, learning_rate=1e-3,
        max_steps=max_steps, save_steps=2, eval_steps=2, logging_steps=1, seed=0,
    )
    return model_args, data_args, training_args


def test_train_on_cpu_checkpoints_resumes_and_side_saves(tmp_path):
    _write_shards(str(tmp_path))
    url = str(tmp_path / "mir-train-00000.tar")
    cfg = ModelConfig.tiny(mm_hidden_size=16, dtype="float32", remat=True)
    args = _train_args(tmp_path, url, 4, freeze_backbone=True, tune_mm_mlp_adapter=True)
    r1 = train(*args, model_cfg=cfg, device="cpu")
    out = tmp_path / "out"
    assert r1["final_step"] == 4 and all(np.isfinite(r1["losses"]))
    assert len(r1["eval_losses"]) == 2 and all(np.isfinite(v) for _, v in r1["eval_losses"])
    assert sorted(p for p in os.listdir(out) if p.startswith("checkpoint-")) == ["checkpoint-4"]
    with open(out / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records if "loss" in r] == [0, 1, 2, 3]
    # the projector side-save reads with the JAX package's loader
    side = jcheckpoint.load_projector_weights(str(out / "mm_projector" / "checkpoint-4.npz"))
    params = r1["state"].params
    np.testing.assert_array_equal(side["mm_projector.kernel"], _np(params["mm_projector"]["kernel"]))
    np.testing.assert_array_equal(side["embed"], _np(params["embed"]))
    # frozen backbone: layer weights did not move; the JAX package reads the metadata
    fresh = tfusion.init_llark_params(r1["cfg"], seed=0, device="cpu")
    assert torch.equal(params["layers"]["wq"], fresh["layers"]["wq"])
    jcfg, jbundle = jload_model_metadata(str(out))
    assert jcfg.hidden_size == cfg.hidden_size and len(jbundle.tokenizer) == len(r1["bundle"].tokenizer)

    # resume: the second run restores step 4 and goes on to 6
    args = _train_args(tmp_path, url, 6, freeze_backbone=True, tune_mm_mlp_adapter=True)
    r2 = train(*args, model_cfg=cfg, device="cpu")
    assert r2["final_step"] == 6 and len(r2["losses"]) == 2
    assert sorted(p for p in os.listdir(out) if p.startswith("checkpoint-")) == ["checkpoint-6"]
    assert not torch.equal(r2["state"].params["mm_projector"]["kernel"], params["mm_projector"]["kernel"])


def test_model_metadata_round_trip(tmp_path):
    cfg = ModelConfig.tiny("mpt", remat=True)
    bundle = TokenizerBundle.from_tokenizer(WordTokenizer(77))
    bundle.encode("a few new words")
    save_model_metadata(str(tmp_path), cfg, bundle)
    cfg2, bundle2 = load_model_metadata(str(tmp_path))
    assert cfg2 == cfg
    assert bundle2.tokenizer.get_vocab() == bundle.tokenizer.get_vocab()
    assert bundle2.model_max_length == 77 and bundle2.audio_patch_id == bundle.audio_patch_id


@pytest.mark.parametrize(
    "option",
    ["lora", "bits8", "bits4", "moe", "multihost", "mesh", "hf_dir", "tensorboard"],
)
def test_out_of_slice_options_raise(tmp_path, option):
    # each option the port has no slice for, or whose setting the JAX
    # package refuses (llark_tpu/train/train.py:259-302), raises before any
    # work; report_to="tensorboard" came into the port with LoRA and writes
    # TensorBoard events beside the JSONL stream; MoE, and a Mixtral
    # directory, came into the port with MoE layers and train
    model_args, data_args, training_args = _train_args(tmp_path, "unused.tar", 1)
    error, match = NotImplementedError, "later slice|checkpoint-I/O slice"
    if option == "lora":
        training_args.lora_enable, training_args.lora_bias = True, "all"
        match = "lora_bias"
    elif option in ("bits8", "bits4"):
        # a quantized base is frozen: it needs LoRA or a frozen backbone
        training_args.bits = int(option[-1])
        error, match = ValueError, "requires lora_enable"
    elif option in ("moe", "hf_dir"):
        _write_shards(str(tmp_path))
        model_args, data_args, training_args = _train_args(
            tmp_path, str(tmp_path / "mir-train-00000.tar"), 1, freeze_backbone=True)
        training_args.eval_steps = 0
        if option == "moe":
            model_args.moe_num_experts = 4
        else:
            # a Mixtral directory (config.json alone: random init) gives
            # the architecture and its experts
            (tmp_path / "config.json").write_text(json.dumps(
                {"model_type": "mixtral", "num_local_experts": 4, "hidden_size": 64,
                 "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
                 "num_key_value_heads": 2, "vocab_size": 256}))
            model_args.model_name_or_path = str(tmp_path)
        result = train(model_args, data_args, training_args, device="cpu")
        assert result["final_step"] == 1 and np.isfinite(result["losses"][0])
        assert result["cfg"].moe_num_experts == 4
        with open(tmp_path / "out" / "metrics.jsonl") as f:
            record = json.loads(f.readline())
        assert 0.0 <= record["moe_dropped_frac"] < 1.0 and record["moe_aux_loss"] > 0
        return
    elif option == "multihost":
        # mesh training came into the port with parallelism: multihost
        # needs a launcher's environment, a mesh of two a world of two
        # (tests/test_torch_parallel.py trains on one)
        training_args.multihost = True
        error, match = ValueError, "torchrun"
    elif option == "mesh":
        training_args.mesh_shape = (1, 2, 1)
        error, match = ValueError, "process group of 2 ranks"
    else:
        _write_shards(str(tmp_path))
        model_args, data_args, training_args = _train_args(
            tmp_path, str(tmp_path / "mir-train-00000.tar"), 1, freeze_backbone=True)
        training_args.report_to, training_args.eval_steps = "tensorboard", 0
        cfg = ModelConfig.tiny(mm_hidden_size=16, dtype="float32")
        assert train(model_args, data_args, training_args, model_cfg=cfg,
                     device="cpu")["final_step"] == 1
        assert [n for n in os.listdir(tmp_path / "out" / "tb") if "tfevents" in n]
        return
    with pytest.raises(error, match=match):
        train(model_args, data_args, training_args, device="cpu")
    assert not (tmp_path / "out" / "checkpoint-1").exists()


def test_out_of_slice_settings_raise():
    # the "dots" remat policies and the LoRA mask came into the port with
    # LoRA; an unknown policy still raises. Remote storage goes through
    # fsspec as in the JAX package: a scheme it does not know raises there
    for policy in ("dots", "dots_narrow"):
        assert ModelConfig.tiny(remat_policy=policy).remat_policy == policy
    with pytest.raises(ValueError, match="remat_policy"):
        ModelConfig.tiny(remat_policy="everything")
    with pytest.raises(ValueError, match="Protocol not known"):
        storage.fopen("nosuch://bucket/shard-00000.tar")
    tree = {"embed": torch.zeros(1), "lm_head": torch.zeros(1), "mm_projector": {"kernel": torch.zeros(1)},
            "layers": {"wq": torch.zeros(1), "wq_lora_a": torch.zeros(1), "wq_lora_b": torch.zeros(1)}}
    assert tstep.trainable_mask(tree, lora=True) == {
        "embed": True, "lm_head": False, "mm_projector": {"kernel": True},
        "layers": {"wq": False, "wq_lora_a": True, "wq_lora_b": True}}


def test_flops_match_jax():
    for arch in ("llama", "mpt"):
        jcfg, tcfg = JaxConfig.tiny(arch), ModelConfig.tiny(arch)
        assert tflops.matmul_param_count(tcfg) == jflops.matmul_param_count(jcfg)
        for frozen in (False, True):
            assert tflops.train_flops_per_token(tcfg, 64, frozen_base=frozen) == \
                jflops.train_flops_per_token(jcfg, 64, frozen_base=frozen)
    big = ModelConfig.llama2_7b()
    assert tflops.train_mfu(big, 1024, 1000.0, peak=1e15) == pytest.approx(
        tflops.train_flops_per_token(big, 1024) * 1000.0 / 1e15)
    if not torch.cuda.is_available():
        assert tflops.train_mfu(big, 1024, 1000.0) is None  # no card, no peak


@pytest.mark.parametrize("arch", ["llama", "mpt"])
def test_infer_flops_per_token_matches_jax(arch):
    for seq, mm in ((1, True), (64, True), (2048, False)):
        assert tflops.infer_flops_per_token(ModelConfig.tiny(arch), seq, mm) == \
            jflops.infer_flops_per_token(JaxConfig.tiny(arch), seq, mm)
    big = ModelConfig.llama2_7b()
    assert tflops.infer_flops_per_token(big, 1024) == jflops.infer_flops_per_token(
        JaxConfig.llama2_7b(), 1024)


CONV_TURNS = [{"from": "human", "value": "<audio>\nWhat is the tempo?"},
              {"from": "gpt", "value": "About 120 BPM."}, {"from": "other", "value": "x"}]


@pytest.mark.parametrize("name", ["v1_2", "vicuna_v1", "mpt"])
def test_conversation_templates_match_jax(name):
    conv, jc = tconv.CONVERSATION_TEMPLATES[name], jconv.CONVERSATION_TEMPLATES[name]
    assert sorted(tconv.CONVERSATION_TEMPLATES) == sorted(jconv.CONVERSATION_TEMPLATES)
    assert conv.sep_style.name == jc.sep_style.name
    assert [s.name for s in tconv.SeparatorStyle] == [s.name for s in jconv.SeparatorStyle]
    assert (conv.system, conv.roles, conv.sep, conv.sep2, conv.header) == \
        (jc.system, jc.roles, jc.sep, jc.sep2, jc.header)
    for speaker in ("human", "GPT", "narrator"):
        assert conv.role_for(speaker) == jc.role_for(speaker)
    messages = [(conv.roles[0], "hi"), (conv.roles[1], "hello"), (conv.roles[0], "tempo?"),
                (conv.roles[1], None)]
    assert conv.get_prompt(messages) == jc.get_prompt(messages)
    assert tconv.format_turn("gpt", "ok", conv) == jconv.format_turn("gpt", "ok", jc)
    assert tconv.format_conversation(CONV_TURNS, conv=conv) == \
        jconv.format_conversation(CONV_TURNS, conv=jc)
    assert tconv.format_conversation(CONV_TURNS, header=conv.header, conv=conv) == \
        jconv.format_conversation(CONV_TURNS, header=jc.header, conv=jc)
    assert tconv.default_conversation == tconv.CONVERSATION_TEMPLATES["v1_2"]
    assert (tconv.conv_vicuna_v1, tconv.conv_mpt) == (
        tconv.CONVERSATION_TEMPLATES["vicuna_v1"], tconv.CONVERSATION_TEMPLATES["mpt"])
    bad = tconv.Conversation(sep_style=None)
    with pytest.raises(ValueError, match="separator style"):
        bad.get_prompt(messages)


def test_denoising_sentinels_and_response_tokens_match_jax():
    tok = ttok.adapt_tokenizer_for_denoising(WordTokenizer(64), num_sentinels=10)
    jt = jtok.adapt_tokenizer_for_denoising(JWordTokenizer(64), num_sentinels=10)
    assert tok.sentinel_token_ids == jt.sentinel_token_ids and len(set(tok.sentinel_token_ids)) == 10
    assert tok.convert_tokens_to_ids("<extra_id_0>") == tok.sentinel_token_ids[0]
    assert tok.pad_token == jt.pad_token
    ids, end = [5, 6, 7, 8, 9, 10], [7, 8]
    for seq in (end, [9], [42], []):
        assert ttok.extract_response_tokens(ids, seq) == jtok.extract_response_tokens(ids, seq)
    assert ttok.extract_response_tokens(ids, end) == [9, 10]


def test_cli_parses_flags_and_runs_on_the_card_by_default(tmp_path):
    # `python -m llark_tpu_torch.train.train` takes the JAX package's flags;
    # with no GPU it refuses to run rather than training on the host
    from llark_tpu_torch.train.train import main

    argv = ["--model_name_or_path", "tiny", "--output_dir", str(tmp_path / "out"),
            "--max_steps", "1", "--freeze_backbone", "true", "--mesh_shape", "1,1,1"]
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CLI would train for real")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
