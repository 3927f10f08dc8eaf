"""The port's Mixture-of-Experts path against the JAX package's, fp32 on the
CPU.

Both packages run the same weights: a seeded init of the port's as numpy
arrays in the JAX layout, handed to JAX as they are and to the port through
`params_from_numpy`. Inputs come from a numpy seed. Tolerances, stated per
case:
  * 1e-5 relative (to max |JAX|) for MoE outputs, logits, losses and
    gradients: both sides compute in fp32 and differ only in the summation
    order of their contractions;
  * 1e-6 absolute for the load-balancing loss and the dropped fraction;
  * exact equality for the dispatched expert-major token buffers (the same
    tokens in the same capacity slots, drops included), quantized payloads,
    greedy tokens, imports, exports and configurations;
  * atol 2e-4 / rtol 1e-3 for the port's decoder on imported Mixtral
    weights against `transformers`' MixtralForCausalLM, as
    tests/test_interop.py holds the JAX package's Llama import.
The JAX side of each comparison runs once per configuration in a module
fixture, so each test's own call stays short.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu import generate as jgen
from llark_tpu.config import ModelArguments as JModelArguments
from llark_tpu.config import ModelConfig as JaxConfig
from llark_tpu.interop import hf as jhf
from llark_tpu.models import decoder as jdecoder
from llark_tpu.models import fusion as jfusion
from llark_tpu.models import moe as jmoe
from llark_tpu.models import quant as jquant
from llark_tpu.models.utils import save_model_metadata as jsave_model_metadata
from llark_tpu.tokenization import TokenizerBundle as JBundle
from llark_tpu.tokenization import WordTokenizer as JWordTokenizer
from llark_tpu.train import flops as jflops
from llark_tpu.train import step as jstep
from llark_tpu.train import train as jtrain
from llark_tpu.train.state import TrainState as JTrainState
from llark_tpu_torch import generate as tgen
from llark_tpu_torch.config import ModelArguments, ModelConfig, TrainingArguments
from llark_tpu_torch.inference.server import BatchedServer, Request
from llark_tpu_torch.interop import hf as thf
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models import decoder as tdecoder
from llark_tpu_torch.models import moe as tmoe
from llark_tpu_torch.models import quant as tquant
from llark_tpu_torch.models.fusion import init_llark_params
from llark_tpu_torch.models.utils import load_model_metadata, save_model_metadata
from llark_tpu_torch.tokenization import TokenizerBundle, WordTokenizer
from llark_tpu_torch.train import flops as tflops
from llark_tpu_torch.train import step as tstep
from llark_tpu_torch.train import train as ttrain
from llark_tpu_torch.train.state import TrainState

TOL = 1e-5
AUX_TOL = 1e-6
PATCH_ID = 7
E = 4
# head_dim 64 (the kernels' width) in both; llama: GQA group 4; MPT: gelu,
# ALiBi, biases, no moe_w_gate
CONFIGS = {
    "llama_gqa": dict(arch="llama", hidden_size=256, num_heads=4, num_kv_heads=1),
    "mpt": dict(arch="mpt", hidden_size=128, num_heads=2, num_kv_heads=2, use_bias=True),
}
# drop-free routing, as a Mixtral import sets it: C = S, so a bucket's
# padding, a chunk and a decode step route each token alike
MIXTRAL = dict(moe_routing="mixtral", moe_capacity_factor=E / 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def _kw(name, **over):
    kw = dict(CONFIGS[name], intermediate_size=128, moe_num_experts=E, moe_top_k=2,
              dtype="float32", param_dtype="float32", mm_hidden_size=8)
    kw.update(over)
    return kw


@functools.lru_cache(maxsize=None)
def _numpy_tree(name):
    kw = _kw(name)
    tcfg = ModelConfig.tiny(kw.pop("arch"), **kw)
    params = init_llark_params(tcfg, seed=0, device="cpu")
    return jax.tree.map(lambda t: t.numpy(), params)


def _models(name, **over):
    kw = _kw(name, **over)
    arch = kw.pop("arch")
    jcfg, tcfg = JaxConfig.tiny(arch, **kw), ModelConfig.tiny(arch, **kw)
    tree = _numpy_tree(name)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tree, tcfg, "cpu")


# ---------------------------------------------------------------------------
# moe_ffn: routing, capacity drops, the Switch loss, the dispatched buffer
# ---------------------------------------------------------------------------

ROUTINGS = {
    "switch_k1": dict(moe_routing="switch", moe_top_k=1, moe_capacity_factor=1.0),
    "switch_k2": dict(moe_routing="switch", moe_top_k=2, moe_capacity_factor=1.0),
    "mixtral_k1": dict(moe_routing="mixtral", moe_top_k=1, moe_capacity_factor=E / 1),
    "mixtral_k2": dict(moe_routing="mixtral", moe_top_k=2, moe_capacity_factor=E / 2),
}


def _block_inputs():
    rng = np.random.RandomState(3)
    lp = {k: np.asarray(v[0]) for k, v in _numpy_tree("llama_gqa")["layers"].items()
          if k.startswith("moe_")}
    # a sharper router than the init's, so that the top choices pile up on
    # few experts and capacity drops happen under "switch" at cf 1
    lp["moe_router"] = lp["moe_router"] * 4.0
    y = rng.randn(2, 24, 256).astype(np.float32)
    return lp, y


def _spy(module, box):
    """module.expert_mlp wrapped to keep the dispatched buffer it is given."""
    orig = module.expert_mlp

    def expert_mlp(cfg, lp, ein, dtype):
        box["ein"] = ein
        return orig(cfg, lp, ein, dtype)

    return expert_mlp


@pytest.fixture(scope="module")
def jax_blocks():
    """JAX moe_ffn per routing case: (out, metrics, dispatched [E, B, C, h])."""
    lp, y = _block_inputs()
    out = {}
    for case, over in ROUTINGS.items():
        jcfg = JaxConfig.tiny(**_kw("llama_gqa", **over))
        box = {}

        def run(lp_, y_):
            o, m = jmoe.moe_ffn(jcfg, lp_, y_)
            return o, m, box["ein"]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmoe, "expert_mlp", _spy(jmoe, box))
            o, m, ein = jax.jit(run)({k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(y))
        out[case] = (np.asarray(o), {k: float(v) for k, v in m.items()}, np.asarray(ein))
    return out


@pytest.mark.parametrize("case", list(ROUTINGS))
def test_moe_ffn_matches_jax(jax_blocks, monkeypatch, case):
    lp, y = _block_inputs()
    tcfg = ModelConfig.tiny(**_kw("llama_gqa", **ROUTINGS[case]))
    box = {}
    monkeypatch.setattr(tmoe, "expert_mlp", _spy(tmoe, box))
    out, metrics = tmoe.moe_ffn(tcfg, {k: torch.from_numpy(v) for k, v in lp.items()},
                                torch.from_numpy(y))
    want, want_metrics, want_ein = jax_blocks[case]
    assert _rel_err(_np(out), want) < TOL
    for k in ("aux_loss", "dropped_frac"):
        assert abs(float(metrics[k]) - want_metrics[k]) <= AUX_TOL, k
    # the same tokens in the same capacity slots: [E, B * C, h] against JAX's
    # [E, B, C, h]
    np.testing.assert_array_equal(_np(box["ein"]), want_ein.reshape(box["ein"].shape))
    c = tmoe.expert_capacity(24, tcfg)
    assert box["ein"].shape == (E, 2 * c, 256)
    if case.startswith("switch"):
        assert want_metrics["dropped_frac"] > 0.1  # the case drops tokens
    else:
        # nothing drops (JAX's XLA divides by multiplying by 1 / (B S K))
        assert float(metrics["dropped_frac"]) == 0.0 and c == 24


# ---------------------------------------------------------------------------
# quantized expert stacks
# ---------------------------------------------------------------------------

QUANT = {
    "int8": (jquant.quantize_weight, tquant.quantize_weight),
    "int4_rows": (functools.partial(jquant.quantize_weight_int4, group=32),
                  functools.partial(tquant.quantize_weight_int4, group=32)),
    "int4_cols": (functools.partial(jquant.quantize_weight_int4_cols, group=32),
                  functools.partial(tquant.quantize_weight_int4_cols, group=32)),
}


@functools.lru_cache(maxsize=None)
def _quantized_layers(fmt):
    """Layer 0's MoE leaves with the expert stacks quantized by each
    package: (JAX numpy dicts, port tensors)."""
    jq, tq = QUANT[fmt]
    lp, _ = _block_inputs()
    jlp, tlp = {"moe_router": lp["moe_router"]}, {"moe_router": torch.from_numpy(lp["moe_router"])}
    for name in ("moe_w_gate", "moe_w_up", "moe_w_down"):
        jlp[name] = {k: np.asarray(v) for k, v in jq(jnp.asarray(lp[name])).items()}
        tlp[name] = tq(torch.from_numpy(lp[name]))
    return jlp, tlp


@pytest.fixture(scope="module")
def jax_quantized():
    _, y = _block_inputs()
    jcfg = JaxConfig.tiny(**_kw("llama_gqa", **MIXTRAL))
    fn = jax.jit(functools.partial(jmoe.moe_ffn, jcfg))
    out = {}
    for fmt in QUANT:
        jlp, _ = _quantized_layers(fmt)
        o, _ = fn(jax.tree.map(jnp.asarray, jlp), jnp.asarray(y))
        out[fmt] = np.asarray(o)
    return out


@pytest.mark.parametrize("fmt", list(QUANT))
def test_quantized_experts_match_jax(jax_quantized, fmt):
    jlp, tlp = _quantized_layers(fmt)
    for name in ("moe_w_gate", "moe_w_up", "moe_w_down"):  # the same payloads
        for k, v in jlp[name].items():
            np.testing.assert_array_equal(tlp[name][k].numpy(), v, err_msg=f"{name}/{k}")
    _, y = _block_inputs()
    tcfg = ModelConfig.tiny(**_kw("llama_gqa", **MIXTRAL))
    out, _ = tmoe.moe_ffn(tcfg, tlp, torch.from_numpy(y))
    assert _rel_err(_np(out), jax_quantized[fmt]) < TOL
    # the incremental quantizers take a stacked [L, E, in, out] tree layer
    # by layer into the layout the per-layer calls give
    _, _, tcfg, tparams = _models("llama_gqa")
    if fmt == "int8":
        qparams = tquant.quantize_params_int8_incremental(tcfg, tparams)
    else:
        qparams = tquant.quantize_params_int4_incremental(
            tcfg, tparams, group=32, layout=fmt.split("_")[1])
    _, tq = QUANT[fmt]
    stack = torch.from_numpy(_numpy_tree("llama_gqa")["layers"]["moe_w_up"])
    for k, v in tq(stack[1]).items():
        assert torch.equal(qparams["layers"]["moe_w_up"][k][1], v), k
    assert qparams["layers"]["moe_router"].dtype == torch.float32  # the router stays fp32


# ---------------------------------------------------------------------------
# the decoder: logits, metrics, decode, generation, serving
# ---------------------------------------------------------------------------


def _ids(vocab, b=2, s=12, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_forward(name):
    jcfg, jparams, _, _ = _models(name, moe_capacity_factor=1.0)
    ids = _ids(jcfg.vocab_size)
    lengths = np.array([12, 7], np.int32)
    logits, metrics = jax.jit(functools.partial(jdecoder.decoder_forward, jcfg))(
        jparams, input_ids=jnp.asarray(ids), seq_lengths=jnp.asarray(lengths))
    return np.asarray(logits), {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_moe_decoder_logits_match_jax(name):
    want, want_metrics = _jax_forward(name)
    _, _, tcfg, tparams = _models(name, moe_capacity_factor=1.0)
    ids = torch.from_numpy(_ids(tcfg.vocab_size))
    got, metrics = tdecoder.decoder_forward(tcfg, tparams, input_ids=ids,
                                            seq_lengths=torch.tensor([12, 7]))
    assert _rel_err(got[0], want[0]) < TOL
    assert _rel_err(got[1, :7], want[1, :7]) < TOL
    assert set(metrics) == {"moe_aux_loss", "moe_dropped_frac"} == set(want_metrics)
    for k, v in want_metrics.items():
        assert abs(float(metrics[k]) - v) <= AUX_TOL, k
    # no dense MLP weights or biases under MoE
    layers = tparams["layers"]
    assert not {"w_up", "w_down", "w_gate", "b_up", "b_down", "b_gate"} & set(layers)
    assert ("moe_w_gate" in layers) == (tcfg.mlp_activation == "silu")
    assert layers["moe_w_up"].shape == (2, E, tcfg.hidden_size, 128)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_moe_decode_matches_full_forward(name):
    # prefill through the flash-prefill wrapper, then three single-token
    # steps through the flash-decode wrapper (their plain versions here),
    # against one forward over the whole sequence
    _, _, tcfg, tparams = _models(name, use_flash_decode=True, use_pallas_attention=True,
                                  **MIXTRAL)
    ids = torch.from_numpy(_ids(tcfg.vocab_size, b=1, s=10, seed=2)).long()
    full, _ = tdecoder.decoder_forward(tcfg, tparams, input_ids=ids)
    cache = tdecoder.init_kv_cache(tcfg, 1, 16)
    got, cache = tdecoder.decoder_forward(tcfg, tparams, input_ids=ids[:, :7], kv_cache=cache,
                                          prefill_from_empty=True)
    assert _rel_err(got, full[:, :7]) < TOL
    for t in range(7, 10):
        step, cache = tdecoder.decoder_forward(tcfg, tparams, input_ids=ids[:, t:t + 1],
                                               kv_cache=cache,
                                               cache_positions=torch.tensor([t]))
        assert _rel_err(step[:, 0], full[:, t]) < TOL


GEN_IDS = np.array([[9, 1, PATCH_ID, PATCH_ID, PATCH_ID, 4, 5, 0],
                    [9, PATCH_ID, PATCH_ID, PATCH_ID, 11, 0, 0, 0]], np.int32)
GEN_LENGTHS = np.array([7, 5], np.int32)
GEN_CFG = dict(max_new_tokens=7, stop_text="", decode_chunk=3)


def _gen_audio():
    return np.random.RandomState(0).randn(2, 3, 8).astype(np.float32), np.array([3, 3], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_tokens(name):
    jcfg, jparams, _, _ = _models(name, **MIXTRAL)
    return jgen.Generator(jcfg, jparams, PATCH_ID, jgen.GenerationConfig(**GEN_CFG),
                          max_cache_len=32).generate(GEN_IDS, GEN_LENGTHS, *_gen_audio())


@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_tokens(request):
    return request.param, _jax_tokens(request.param)


def test_moe_generator_greedy_matches_jax(jax_tokens):
    name, want = jax_tokens
    _, _, tcfg, tparams = _models(name, use_flash_decode=True, use_pallas_attention=True,
                                  **MIXTRAL)
    got = tgen.Generator(tcfg, tparams, PATCH_ID, tgen.GenerationConfig(**GEN_CFG),
                         max_cache_len=32, device="cpu").generate(GEN_IDS, GEN_LENGTHS,
                                                                  *_gen_audio())
    assert got == want and all(len(row) == 7 for row in got)


SERVER_MODES = {
    "dense": {},
    "chunked_paged": dict(prefill_chunk=8, kv_block_size=8, kv_pool_blocks=2 + 8),
    "spec_ngram": dict(spec_mode="ngram", gamma=3),
}


@pytest.mark.parametrize("mode", list(SERVER_MODES))
def test_moe_server_matches_jax_generator(jax_tokens, mode):
    # one-shot, chunked-paged and speculative admission and decode rounds
    # pass through the MoE layers: the same greedy tokens as the JAX
    # Generator's on the same requests
    name, want = jax_tokens
    _, _, tcfg, tparams = _models(name, **MIXTRAL)
    audio, _ = _gen_audio()
    server = BatchedServer(tcfg, tparams, PATCH_ID, tgen.GenerationConfig(**GEN_CFG),
                           max_batch=2, max_cache_len=32, prompt_buckets=(8, 16),
                           max_audio_frames=3, device="cpu", **SERVER_MODES[mode])
    out = server.serve([Request(GEN_IDS[i, :n], audio[i]) for i, n in enumerate(GEN_LENGTHS)])
    assert [r.tokens for r in out] == want


# ---------------------------------------------------------------------------
# training: the loss with the load-balancing term, its metrics, gradients
# ---------------------------------------------------------------------------


def _batch(vocab, rows=4, s=16, frames=3, mm=8):
    rng = np.random.RandomState(5)
    ids = rng.randint(10, vocab, (rows, s)).astype(np.int32)
    ids[:, 1:1 + frames] = PATCH_ID
    lengths = np.array([s, s - 3, s - 5, s][:rows], np.int32)
    labels = ids.copy()
    labels[:, : 1 + frames] = -100
    for i, n in enumerate(lengths):
        labels[i, n:] = -100
        ids[i, n:] = 0
    return {"input_ids": ids, "labels": labels, "seq_lengths": lengths,
            "audio_encodings": rng.randn(rows, frames, mm).astype(np.float32),
            "audio_frame_counts": np.full((rows,), frames, np.int32)}


TRAIN = dict(moe_capacity_factor=1.0, remat=True, moe_aux_loss_weight=0.1)
TRAIN_ARGS = dict(learning_rate=1e-2, max_steps=10, warmup_ratio=0.1)


@pytest.fixture(scope="module")
def jax_train():
    """JAX: the train loss and its gradient on one micro-batch, then one
    train step of 2 micro-batches (its metrics)."""
    jcfg, jparams, _, _ = _models("llama_gqa", **TRAIN)
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab_size).items()}

    def loss(p, micro):  # the train step's loss (llark_tpu/train/step.py:192-221)
        out, extras = jfusion.llark_forward(
            jcfg, p, micro["input_ids"], audio_encodings=micro["audio_encodings"],
            audio_patch_id=PATCH_ID, audio_frame_counts=micro["audio_frame_counts"],
            seq_lengths=micro["seq_lengths"])
        lm, _ = jfusion.causal_lm_loss(out, micro["labels"])
        return lm + jcfg.moe_aux_loss_weight * extras["moe_aux_loss"], extras

    micro = {k: v[:2] for k, v in batch.items()}
    (value, extras), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams, micro)
    jopt = jstep.make_optimizer(jtrain.TrainingArguments(**TRAIN_ARGS), jparams)
    step = jax.jit(jstep.make_train_step(jcfg, jopt, audio_patch_id=PATCH_ID,
                                         grad_accum_steps=2))
    _, metrics = step(JTrainState.create(jparams, jopt), batch)
    return (float(value), {k: float(v) for k, v in extras.items()},
            jax.tree.map(np.asarray, grads["layers"]), {k: float(v) for k, v in metrics.items()})


def test_moe_train_step_matches_jax(jax_train):
    value, extras, grads, metrics = jax_train
    _, _, tcfg, tparams = _models("llama_gqa", **TRAIN)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab_size).items()}
    loss_fn = tstep.make_loss_fn(tcfg, audio_patch_id=PATCH_ID)
    names = ("moe_router", "moe_w_gate", "wq")
    leaves = [tparams["layers"][n].requires_grad_() for n in names]
    loss, _, moe = loss_fn(tparams, {k: v[:2] for k, v in batch.items()})
    loss = tstep.train_loss(tcfg, loss, moe)
    assert abs(loss.item() - value) <= TOL * abs(value)
    for k, v in extras.items():
        assert abs(float(moe[k].detach()) - v) <= AUX_TOL, k
    assert extras["moe_dropped_frac"] > 0  # cf 1: drops
    for name, g in zip(names, torch.autograd.grad(loss, leaves)):
        assert _rel_err(_np(g), grads[name]) < TOL, name
    # the train step: 2 micro-batches, the metrics meaned over them
    for t in leaves:
        t.requires_grad_(False)
    tstep.ParamPartition(tparams, tstep.trainable_mask(tparams))
    topt = tstep.make_optimizer(TrainingArguments(**TRAIN_ARGS))
    fn = tstep.make_train_step(tcfg, topt, audio_patch_id=PATCH_ID, grad_accum_steps=2)
    _, tm = fn(TrainState.create(tparams, topt), batch)
    assert set(tm) == set(metrics)
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - metrics[k]) <= TOL * abs(metrics[k]), k
    for k in ("moe_aux_loss", "moe_dropped_frac"):
        assert abs(float(tm[k]) - metrics[k]) <= AUX_TOL, k


def test_moe_flops_match_jax():
    # the active experts and the router, as the JAX package counts them
    for name in CONFIGS:
        jcfg, _, tcfg, _ = _models(name)
        assert tflops.matmul_param_count(tcfg) == jflops.matmul_param_count(jcfg)
        for frozen in (False, True):
            assert tflops.train_flops_per_token(tcfg, 64, frozen_base=frozen) == \
                jflops.train_flops_per_token(jcfg, 64, frozen_base=frozen)


# ---------------------------------------------------------------------------
# Mixtral checkpoints: import, export, configuration, run directories
# ---------------------------------------------------------------------------

MIXTRAL_HF = dict(vocab_size=96, hidden_size=256, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=1, max_position_embeddings=128,
                  rms_norm_eps=1e-5, rope_theta=1e6, num_local_experts=E, num_experts_per_tok=2,
                  tie_word_embeddings=False, sliding_window=None)


def _mixtral_cfgs():
    kw = dict(vocab_size=96, hidden_size=256, intermediate_size=128, num_layers=2, num_heads=4,
              num_kv_heads=1, rope_theta=1e6, moe_num_experts=E, moe_top_k=2,
              dtype="float32", param_dtype="float32", use_pallas_attention=False, remat=False,
              mm_hidden_size=8, **MIXTRAL)
    return ModelConfig.tiny(**kw), JaxConfig.tiny(**kw)


@pytest.fixture(scope="module")
def mixtral():
    """A tiny MixtralForCausalLM that `transformers` builds offline from its
    config, and its state dict as numpy arrays."""
    import transformers

    torch.manual_seed(0)
    model = transformers.MixtralForCausalLM(transformers.MixtralConfig(**MIXTRAL_HF))
    model = model.eval().float()
    with torch.no_grad():  # the first forward initialises lazily
        model(torch.zeros((1, 4), dtype=torch.long))
    return model, {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def test_mixtral_import_matches_transformers(mixtral):
    model, _ = mixtral
    tcfg, _ = _mixtral_cfgs()
    params = thf.llama_params_from_hf({k: v.detach() for k, v in model.state_dict().items()},
                                      tcfg, device="cpu")
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 96, size=(2, 12)))
    with torch.no_grad():
        want = model(ids.long()).logits
        got, _ = tdecoder.decoder_forward(tcfg, params, input_ids=ids.int())
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def jax_mixtral(mixtral):
    _, sd = mixtral
    _, jcfg = _mixtral_cfgs()
    params = jhf.llama_params_from_hf(sd, jcfg)
    ids = np.random.RandomState(1).randint(0, 96, size=(2, 12)).astype(np.int32)
    logits, _ = jax.jit(functools.partial(jdecoder.decoder_forward, jcfg))(
        jax.tree.map(jnp.asarray, params), input_ids=jnp.asarray(ids))
    return params, np.asarray(logits)


def test_mixtral_import_matches_jax(mixtral, jax_mixtral):
    _, sd = mixtral
    want_params, want = jax_mixtral
    tcfg, _ = _mixtral_cfgs()
    params = thf.llama_params_from_hf({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg,
                                      device="cpu")
    assert sorted(params["layers"]) == sorted(want_params["layers"])
    for k, v in want_params["layers"].items():
        np.testing.assert_array_equal(params["layers"][k].numpy(), v, err_msg=k)
    assert params["layers"]["moe_w_up"].shape == (2, E, 256, 128)
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 96, size=(2, 12)).astype(np.int32))
    got, _ = tdecoder.decoder_forward(tcfg, params, input_ids=ids)
    assert _rel_err(got, want) < TOL


def test_mixtral_export_round_trip(tmp_path, mixtral):
    # the port's export reads back bit for bit through both packages'
    # load_pretrained_backbone, whose MoE configs both turn to "mixtral"
    # routing with the drop-free capacity factor E / K; its config.json is
    # the JAX package's
    _, sd = mixtral
    tcfg, jcfg = _mixtral_cfgs()
    params = thf.llama_params_from_hf({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg,
                                      device="cpu")
    thf.save_hf_checkpoint(str(tmp_path / "port"), tcfg, params)
    jhf.save_hf_checkpoint(str(tmp_path / "jax"), jcfg, jax.tree.map(lambda t: t.numpy(), params))
    configs = [json.loads((tmp_path / d / "config.json").read_text()) for d in ("port", "jax")]
    assert configs[0] == configs[1] and configs[0]["architectures"] == ["MixtralForCausalLM"]
    tswitch = dataclasses.replace(tcfg, moe_routing="switch", moe_capacity_factor=1.25)
    jswitch = dataclasses.replace(jcfg, moe_routing="switch", moe_capacity_factor=1.25)
    got = thf.load_pretrained_backbone(str(tmp_path / "port"), tswitch, device="cpu")
    want = jhf.load_pretrained_backbone(str(tmp_path / "port"), jswitch)
    assert (tswitch.moe_routing, tswitch.moe_capacity_factor) == ("mixtral", 2.0)
    assert (jswitch.moe_routing, jswitch.moe_capacity_factor) == ("mixtral", 2.0)
    for k, v in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][k].numpy(), np.asarray(v), err_msg=k)
        assert torch.equal(got["layers"][k], params["layers"][k]), k
    assert thf.hf_state_dict_from_params(tcfg, params).keys() == sd.keys()


def test_mixtral_model_config_and_metadata_match_jax(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(dict(MIXTRAL_HF, model_type="mixtral")))
    args = dict(mm_hidden_size=8)
    tcfg = ttrain.model_config_from_name(str(tmp_path), ModelArguments(**args))
    jcfg = jtrain.model_config_from_name(str(tmp_path), JModelArguments(**args))
    want = dataclasses.asdict(jcfg)
    assert {k: want[k] for k in dataclasses.asdict(tcfg)} == dataclasses.asdict(tcfg)
    assert (tcfg.moe_num_experts, tcfg.moe_top_k, tcfg.num_kv_heads) == (E, 2, 1)
    # flags make any named model MoE
    flags = ModelArguments(moe_num_experts=8, moe_top_k=1, moe_capacity_factor=2.0, **args)
    cfg = ttrain.model_config_from_name("tiny", flags)
    assert (cfg.moe_num_experts, cfg.moe_top_k, cfg.moe_capacity_factor) == (8, 1, 2.0)
    # run directories: the MoE fields round-trip, and the port reads the
    # JAX package's
    moe = dataclasses.replace(tcfg, moe_routing="mixtral", moe_capacity_factor=4.0,
                              moe_aux_loss_weight=0.02)
    save_model_metadata(str(tmp_path / "port"), moe, TokenizerBundle.from_tokenizer(
        WordTokenizer(64)))
    assert load_model_metadata(str(tmp_path / "port"))[0] == moe
    jmoe_cfg = dataclasses.replace(jcfg, moe_routing="mixtral", moe_capacity_factor=4.0,
                                   moe_aux_loss_weight=0.02)
    jsave_model_metadata(str(tmp_path / "jax"), jmoe_cfg,
                         JBundle.from_tokenizer(JWordTokenizer(64)))
    assert load_model_metadata(str(tmp_path / "jax"))[0] == moe
