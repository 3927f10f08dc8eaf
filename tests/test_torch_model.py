"""Port decoder and fusion against the JAX package's, fp32 on the CPU.

Both packages run the same weights: a seeded init as numpy arrays in the
JAX package's layout, handed to JAX as they are and to the port through
`params_from_numpy`. (The port's init makes them: JAX's init would add a
compile to every config, and `test_init_matches_jax_layout` holds the two
layouts equal.) Inputs come from a numpy seed. Tolerance: 1e-5 relative to
max |JAX| -- both sides compute in fp32 and differ only in summation order.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu.config import ModelConfig as JaxConfig
from llark_tpu.models import decoder as jdecoder
from llark_tpu.models import fusion as jfusion
from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models import decoder as tdecoder
from llark_tpu_torch.models import fusion as tfusion

TOL = 1e-5
PATCH_ID = 7

CONFIGS = {
    "llama_gqa": dict(arch="llama", num_kv_heads=2),
    "mpt": dict(arch="mpt"),
}


def _rel_err(got, want):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6))


@functools.lru_cache(maxsize=None)
def _numpy_tree(name, seed):
    # the weights depend on the architecture and the seed only, so the
    # parametrised cases of a config share one init
    over = dict(CONFIGS[name], dtype="float32", param_dtype="float32")
    tcfg = ModelConfig.tiny(over.pop("arch"), **over)
    params = tfusion.init_llark_params(tcfg, seed=seed, device="cpu")
    return jax.tree.map(lambda t: t.numpy(), params)


def _models(name, seed=0, **kw):
    over = dict(CONFIGS[name], dtype="float32", param_dtype="float32", **kw)
    arch = over.pop("arch")
    jcfg = JaxConfig.tiny(arch, **over)
    tcfg = ModelConfig.tiny(arch, **over)
    tree = _numpy_tree(name, seed)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tree, tcfg, "cpu")


def _jforward(jcfg):
    # jitted: eager op-by-op dispatch would triple the multi-step test's time
    return jax.jit(functools.partial(jdecoder.decoder_forward, jcfg),
                   static_argnames=("prefill_from_empty",))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decoder_forward_logits_match_jax(name):
    jcfg, jparams, tcfg, tparams = _models(name)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    lengths = np.array([12, 7], np.int32)
    want, _ = jdecoder.decoder_forward(
        jcfg, jparams, input_ids=jnp.asarray(ids), seq_lengths=jnp.asarray(lengths)
    )
    got, cache = tdecoder.decoder_forward(
        tcfg, tparams, input_ids=torch.from_numpy(ids), seq_lengths=torch.from_numpy(lengths)
    )
    assert cache is None
    assert got.dtype == torch.float32
    assert _rel_err(got[0], np.asarray(want)[0]) < TOL
    assert _rel_err(got[1, :7], np.asarray(want)[1, :7]) < TOL


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("flash_decode", [None, True], ids=["xla", "flash"])
def test_prefill_then_decode_cache_matches_jax(name, flash_decode):
    # prefill into an empty cache, then 3 ragged single-token decode steps;
    # "flash" sends the port through both kernel wrappers (their plain
    # versions on the CPU) and JAX through its XLA paths
    jcfg, jparams, tcfg, tparams = _models(
        name, use_flash_decode=flash_decode, use_pallas_attention=bool(flash_decode)
    )
    b, s, max_len = 2, 10, 24
    rng = np.random.RandomState(1)
    embeds = rng.randn(b, s, jcfg.hidden_size).astype(np.float32)
    lengths = np.array([10, 6], np.int32)
    jcache = jdecoder.init_kv_cache(jcfg, b, max_len)
    tcache = tdecoder.init_kv_cache(tcfg, b, max_len)
    jforward = _jforward(jcfg)
    jl, jcache = jforward(
        jparams, inputs_embeds=jnp.asarray(embeds), seq_lengths=jnp.asarray(lengths),
        kv_cache=jcache, prefill_from_empty=True,
    )
    tl, tcache = tdecoder.decoder_forward(
        tcfg, tparams, inputs_embeds=torch.from_numpy(embeds),
        seq_lengths=torch.from_numpy(lengths), kv_cache=tcache, prefill_from_empty=True,
    )
    assert _rel_err(tl[0], np.asarray(jl)[0]) < TOL
    assert _rel_err(tl[1, :6], np.asarray(jl)[1, :6]) < TOL
    pos = lengths.copy()
    for step in range(3):
        tok = rng.randint(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
        jl, jcache = jforward(
            jparams, input_ids=jnp.asarray(tok), kv_cache=jcache,
            cache_positions=jnp.asarray(pos),
        )
        tl, tcache = tdecoder.decoder_forward(
            tcfg, tparams, input_ids=torch.from_numpy(tok), kv_cache=tcache,
            cache_positions=torch.from_numpy(pos),
        )
        assert _rel_err(tl, jl) < TOL, f"decode step {step}"
        pos = pos + 1
    assert tcache["index"] == int(jcache["index"]) == s + 3
    for key in ("k", "v"):
        assert _rel_err(tcache[key], jcache[key]) < TOL


def test_decode_updates_cache_in_place():
    _, _, tcfg, tparams = _models("llama_gqa")
    cache = tdecoder.init_kv_cache(tcfg, 1, 8)
    k_before = cache["k"]
    _, new = tdecoder.decoder_forward(
        tcfg, tparams, input_ids=torch.tensor([[3, 4]]), kv_cache=cache
    )
    assert new["k"] is k_before and new["index"] == 2
    assert float(k_before[:, :, :, :2].abs().sum()) > 0
    assert float(k_before[:, :, :, 2:].abs().sum()) == 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_llark_forward_with_audio_matches_jax(name):
    jcfg, jparams, tcfg, tparams = _models(name, seed=2)
    rng = np.random.RandomState(2)
    ids = np.array([[9, PATCH_ID, PATCH_ID, PATCH_ID, 5, 6], [PATCH_ID, PATCH_ID, 4, 3, 2, 1]],
                   np.int32)
    audio = rng.randn(2, 3, jcfg.mm_hidden_size).astype(np.float32)
    counts = np.array([3, 1], np.int32)
    want, _ = jfusion.llark_forward(
        jcfg, jparams, jnp.asarray(ids), audio_encodings=jnp.asarray(audio),
        audio_patch_id=PATCH_ID, audio_frame_counts=jnp.asarray(counts),
    )
    got, _ = tfusion.llark_forward(
        tcfg, tparams, torch.from_numpy(ids), audio_encodings=torch.from_numpy(audio),
        audio_patch_id=PATCH_ID, audio_frame_counts=torch.from_numpy(counts),
    )
    assert _rel_err(got, want) < TOL


def test_norms_and_rope_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 5, 16).astype(np.float32)
    scale = rng.rand(16).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    pos = np.array([[0, 4, 9, 100, 2047], [3, 3, 1, 0, 7]], np.int32)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(
        tdecoder.rms_norm(tx, torch.from_numpy(scale), 1e-5).numpy(),
        np.asarray(jdecoder.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        tdecoder.layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias), 1e-5).numpy(),
        np.asarray(jdecoder.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                       jnp.asarray(bias), 1e-5)),
        rtol=1e-5, atol=1e-6,
    )
    got = tdecoder.apply_rope(tx, torch.from_numpy(pos), 10000.0)
    want = jdecoder.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    assert _rel_err(got, want) < TOL


def test_splice_matches_jax():
    rng = np.random.RandomState(4)
    tok = rng.randn(2, 7, 8).astype(np.float32)
    aud = rng.randn(2, 3, 8).astype(np.float32)
    ids = np.array([[1, 7, 7, 7, 7, 2, 3], [7, 4, 7, 5, 6, 8, 9]], np.int32)
    counts = np.array([2, 3], np.int32)
    want = jfusion.splice_audio_embeddings(
        jnp.asarray(tok), jnp.asarray(aud), jnp.asarray(ids), 7, jnp.asarray(counts)
    )
    got = tfusion.splice_audio_embeddings(
        torch.from_numpy(tok), torch.from_numpy(aud), torch.from_numpy(ids), 7,
        torch.from_numpy(counts),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_matches_jax_layout(name):
    jcfg, _, tcfg, _ = _models(name)
    tparams = tfusion.init_llark_params(tcfg, seed=0, device="cpu")
    jlayout = jax.eval_shape(lambda key: jfusion.init_llark_params(jcfg, key),
                             jax.random.PRNGKey(0))
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jlayout)
    tshapes = jax.tree.map(lambda t: tuple(t.shape), tparams)
    assert tshapes == jshapes
    # the same init scheme: kaiming N(0, 1/fan_in) dense weights
    wq = tparams["layers"]["wq"]
    assert abs(float(wq.std()) * np.sqrt(tcfg.hidden_size) - 1.0) < 0.05
    again = tfusion.init_llark_params(tcfg, seed=0, device="cpu")
    assert torch.equal(again["layers"]["wq"], wq)


def test_params_from_numpy_checks_layout():
    jcfg, jparams, tcfg, _ = _models("llama_gqa")
    tree = jax.tree.map(np.asarray, jparams)
    bf16 = params_from_numpy(tree, tcfg, "cpu", torch.bfloat16)
    assert bf16["layers"]["wq"].dtype == torch.bfloat16
    # a JAX tree kept in bfloat16 (ml_dtypes arrays) converts too
    jbf16 = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jparams)
    back = params_from_numpy(jbf16, tcfg, "cpu", torch.bfloat16)
    assert torch.equal(back["layers"]["wq"], bf16["layers"]["wq"])
    other = ModelConfig.tiny(num_layers=3)
    with pytest.raises(ValueError, match="num_layers"):
        params_from_numpy(tree, other, "cpu")


def test_out_of_slice_features_raise():
    from llark_tpu_torch.inference.server import BatchedServer

    _, _, tcfg, tparams = _models("llama_gqa")
    # MoE layers came into the port: the router and expert stacks replace
    # the dense MLP, and a forward without a cache returns the layers'
    # metrics in the cache's place (tests/test_torch_moe.py holds the values)
    moe = ModelConfig.tiny(moe_num_experts=2)
    mparams = tdecoder.init_decoder_params(moe, torch.Generator().manual_seed(0), "cpu")
    assert {"moe_router", "moe_w_gate", "moe_w_up", "moe_w_down"} <= set(mparams["layers"])
    assert "w_up" not in mparams["layers"]
    logits, metrics = tdecoder.decoder_forward(moe, mparams, input_ids=torch.tensor([[1, 2]]))
    assert tuple(logits.shape) == (1, 2, moe.vocab_size)
    assert set(metrics) == {"moe_aux_loss", "moe_dropped_frac"}
    # LoRA factors came into the port: zero-delta factors (B = 0) serve the
    # base model's logits (tests/test_torch_lora.py holds the values)
    from llark_tpu_torch.models.lora import init_lora_params

    lcfg = dataclasses.replace(tcfg, lora_rank=4)
    lora = init_lora_params(lcfg, torch.Generator().manual_seed(0), tparams)
    ids = torch.tensor([[1, 2]])
    torch.testing.assert_close(tdecoder.decoder_forward(lcfg, lora, input_ids=ids)[0],
                               tdecoder.decoder_forward(tcfg, tparams, input_ids=ids)[0],
                               rtol=0, atol=0)
    # quantized weights came into the slice: a quantized leaf is served, and
    # carries dx since LoRA (tests/test_torch_quant.py holds the values)
    from llark_tpu_torch.models.quant import quantize_weight

    wq = quantize_weight(tparams["lm_head"])
    hidden = torch.ones(1, 1, 64)
    assert tuple(tdecoder._dense(hidden, wq, None, torch.float32).shape) == (1, 1, tcfg.vocab_size)
    assert tdecoder.compute_logits(tcfg, {"lm_head": wq}, hidden).dtype == torch.float32
    out = tdecoder._dense(hidden.requires_grad_(), wq, None, torch.float32)
    assert tuple(torch.autograd.grad(out.sum(), [hidden])[0].shape) == (1, 1, 64)
    # the serving engine's mesh argument takes a DeviceMesh (mesh serving is
    # held in tests/test_torch_sharded_serving.py)
    with pytest.raises(TypeError, match="DeviceMesh"):
        BatchedServer(tcfg, tparams, audio_patch_id=PATCH_ID, device="cpu", mesh=object())


# ---------------------------------------------------------------------------
# int8 and paged KV caches
# ---------------------------------------------------------------------------


def _jforward_paged(jcfg):
    return jax.jit(functools.partial(jdecoder.decoder_forward, jcfg),
                   static_argnames=("prefill_from_empty", "paged_chunk", "return_hidden"))


def _check_int8(got, want):
    """int8 cache values equal except +-1 where a rounding tie (x / scale
    at .5) falls differently in the two packages' fp32 sums."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def _check_cache(tcache, jcache, quant):
    for key in ("k", "v"):
        if quant:
            _check_int8(tcache[key], jcache[key])
        else:
            assert _rel_err(tcache[key], jcache[key]) < TOL
    if quant:
        for key in ("k_scale", "v_scale"):
            assert _rel_err(tcache[key], jcache[key]) < 1e-6


def test_quantize_kv_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 7, 16).astype(np.float32)
    # exact ties: with absmax 127 the scale is 1, and half-integers round
    # to even in both packages
    x[0, 0, 0, :5] = [127.0, 0.5, 1.5, 2.5, -0.5]
    x[0, 0, 0, 5:] = 0.0
    q, sc = tdecoder._quantize_kv(torch.from_numpy(x))
    jq, jsc = jdecoder._quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    assert q[0, 0, 0, :5].tolist() == [127, 0, 2, 2, 0]


@pytest.mark.parametrize("quant", [False, True], ids=["bf", "int8"])
def test_cache_layouts_match_jax(quant):
    jcfg, _, tcfg, _ = _models("llama_gqa", kv_cache_quant=quant)
    for jc, tc in ((jdecoder.init_kv_cache(jcfg, 3, 16), tdecoder.init_kv_cache(tcfg, 3, 16)),
                   (jdecoder.init_paged_kv_cache(jcfg, 3, 9, 8, 4),
                    tdecoder.init_paged_kv_cache(tcfg, 3, 9, 8, 4))):
        assert set(tc) == set(jc)
        for key, t in tc.items():
            if key == "index":
                assert t == int(jc[key]) == 0
                continue
            want = np.asarray(jc[key])
            assert tuple(t.shape) == want.shape and str(t.dtype).split(".")[-1] == str(want.dtype)
            np.testing.assert_array_equal(t.numpy(), want)  # zeros; parking tables


def _decode_refs(jforward, jparams, jcache, rng, vocab, pos, steps=3):
    """Token ids, JAX logits and the JAX cache of `steps` single-token
    decode steps from positions `pos`."""
    toks, logits = [], []
    for _ in range(steps):
        tok = rng.randint(0, vocab, (len(pos), 1)).astype(np.int32)
        jl, jcache = jforward(jparams, input_ids=jnp.asarray(tok), kv_cache=jcache,
                              cache_positions=jnp.asarray(pos))
        toks.append(tok)
        logits.append(np.asarray(jl))
        pos = pos + 1
    return toks, logits, jcache


@pytest.fixture(scope="module")
def int8_refs():
    """The JAX side of test_int8_cache_prefill_then_decode_matches_jax for
    every config, run once at module setup: prefill into an empty int8
    cache, then 3 ragged decode steps."""
    refs = {}
    for name in CONFIGS:
        jcfg, jparams, _, _ = _models(name, kv_cache_quant=True, use_flash_decode=True)
        rng = np.random.RandomState(11)
        embeds = rng.randn(2, 10, jcfg.hidden_size).astype(np.float32)
        lengths = np.array([10, 6], np.int32)
        jforward = _jforward(jcfg)
        jl, jcache = jforward(jparams, inputs_embeds=jnp.asarray(embeds),
                              seq_lengths=jnp.asarray(lengths),
                              kv_cache=jdecoder.init_kv_cache(jcfg, 2, 24),
                              prefill_from_empty=True)
        toks, logits, jcache = _decode_refs(jforward, jparams, jcache, rng, jcfg.vocab_size,
                                            lengths.copy())
        refs[name] = dict(embeds=embeds, lengths=lengths, prefill=np.asarray(jl), toks=toks,
                          logits=logits, cache=jax.tree.map(np.asarray, jcache))
    return refs


@pytest.mark.parametrize("name", list(CONFIGS))
def test_int8_cache_prefill_then_decode_matches_jax(name, int8_refs):
    # prefill into an empty int8 cache, then 3 ragged decode steps through
    # the flash-decode route (its plain version here; JAX's XLA path)
    ref = int8_refs[name]
    _, _, tcfg, tparams = _models(name, kv_cache_quant=True, use_flash_decode=True)
    lengths = ref["lengths"]
    tcache = tdecoder.init_kv_cache(tcfg, 2, 24)
    tl, tcache = tdecoder.decoder_forward(
        tcfg, tparams, inputs_embeds=torch.from_numpy(ref["embeds"]),
        seq_lengths=torch.from_numpy(lengths), kv_cache=tcache, prefill_from_empty=True)
    assert _rel_err(tl[0], ref["prefill"][0]) < TOL
    pos = lengths.copy()
    for step, (tok, jl) in enumerate(zip(ref["toks"], ref["logits"])):
        tl, tcache = tdecoder.decoder_forward(
            tcfg, tparams, input_ids=torch.from_numpy(tok), kv_cache=tcache,
            cache_positions=torch.from_numpy(pos))
        assert _rel_err(tl, jl) < TOL, f"decode step {step}"
        pos = pos + 1
    assert tcache["k"].dtype == torch.int8 and tcache["index"] == 10 + 3
    _check_cache(tcache, ref["cache"], quant=True)


PAGED_TABLES = np.array([[3, 7, 2, 9], [5, 4, 8, 6]], np.int32)


@pytest.fixture(scope="module")
def paged_refs():
    """The JAX side of test_paged_cache_chunks_and_decode_match_jax for
    every (config, cache type), run once at module setup: two block-aligned
    paged_chunk writes into scattered pool blocks, then 3 paged decode
    steps."""
    refs = {}
    for name in CONFIGS:
        for quant in (False, True):
            jcfg, jparams, _, _ = _models(name, kv_cache_quant=quant, use_flash_decode=True)
            jcache = jdecoder.init_paged_kv_cache(jcfg, 2, 10, 8, 4)
            jcache["block_tables"] = jnp.asarray(PAGED_TABLES)
            rng = np.random.RandomState(12)
            embeds = rng.randn(2, 16, jcfg.hidden_size).astype(np.float32)
            plens = np.array([16, 11], np.int32)
            jforward = _jforward_paged(jcfg)
            hidden = []
            for c in (0, 8):
                jh, jcache = jforward(jparams, inputs_embeds=jnp.asarray(embeds[:, c:c + 8]),
                                      seq_lengths=jnp.asarray(plens), kv_cache=jcache,
                                      cache_positions=jnp.full((2,), c, jnp.int32),
                                      return_hidden=True, paged_chunk=True)
                hidden.append(np.asarray(jh))
            toks, logits, jcache = _decode_refs(jforward, jparams, jcache, rng,
                                                jcfg.vocab_size, plens.copy())
            refs[name, quant] = dict(embeds=embeds, plens=plens, hidden=hidden, toks=toks,
                                     logits=logits, cache=jax.tree.map(np.asarray, jcache))
    return refs


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("quant", [False, True], ids=["bf", "int8"])
def test_paged_cache_chunks_and_decode_match_jax(name, quant, paged_refs):
    # two block-aligned paged_chunk writes straight into scattered pool
    # blocks, then 3 paged decode steps that read through the tables
    ref = paged_refs[name, quant]
    _, _, tcfg, tparams = _models(name, kv_cache_quant=quant, use_flash_decode=True)
    tcache = tdecoder.init_paged_kv_cache(tcfg, 2, 10, 8, 4)
    tcache["block_tables"] = torch.from_numpy(PAGED_TABLES)
    embeds, plens = ref["embeds"], ref["plens"]
    for c, jh in zip((0, 8), ref["hidden"]):
        th, tcache = tdecoder.decoder_forward(
            tcfg, tparams, inputs_embeds=torch.from_numpy(embeds[:, c:c + 8]),
            seq_lengths=torch.from_numpy(plens), kv_cache=tcache,
            cache_positions=torch.full((2,), c, dtype=torch.int32), return_hidden=True,
            paged_chunk=True)
        assert _rel_err(th, jh) < TOL, f"chunk at {c}"
    pos = plens.copy()
    for step, (tok, jl) in enumerate(zip(ref["toks"], ref["logits"])):
        tl, tcache = tdecoder.decoder_forward(
            tcfg, tparams, input_ids=torch.from_numpy(tok), kv_cache=tcache,
            cache_positions=torch.from_numpy(pos))
        assert _rel_err(tl, jl) < TOL, f"decode step {step}"
        pos = pos + 1
    assert tcache["index"] == 16 + 3 and tcache["block_tables"] is not None
    _check_cache(tcache, ref["cache"], quant)
    # parking blocks 0 and 1 were never written
    assert float(tcache["k"][:, :2].abs().sum()) == 0.0


def test_audio_encoder_config_matches_jax():
    import dataclasses as dc

    from llark_tpu.models import AudioEncoderConfig as JAudioEncoderConfig
    from llark_tpu_torch.models import AudioEncoderConfig

    assert dc.asdict(AudioEncoderConfig()) == dc.asdict(JAudioEncoderConfig())
    kw = dict(use_audio_start_end=False, audio_patch_token="<p>")
    assert dc.asdict(AudioEncoderConfig(**kw)) == dc.asdict(JAudioEncoderConfig(**kw))
