"""Port decoder and fusion against the JAX package's, fp32 on the CPU.

Both packages run the same weights: a seeded init as numpy arrays in the
JAX package's layout, handed to JAX as they are and to the port through
`params_from_numpy`. (The port's init makes them: JAX's init would add a
compile to every config, and `test_init_matches_jax_layout` holds the two
layouts equal.) Inputs come from a numpy seed. Tolerance: 1e-5 relative to
max |JAX| -- both sides compute in fp32 and differ only in summation order.
"""

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
    _, _, tcfg, tparams = _models("llama_gqa")
    with pytest.raises(NotImplementedError, match="int8 KV cache"):
        tdecoder.init_kv_cache(ModelConfig.tiny(kv_cache_quant=True), 1, 8)
    moe = ModelConfig.tiny(moe_num_experts=2)
    with pytest.raises(NotImplementedError, match="MoE"):
        tdecoder.init_decoder_params(moe, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        tdecoder.decoder_forward(moe, tparams, input_ids=torch.tensor([[1, 2]]))
    lora = dict(tparams, layers=dict(tparams["layers"], wq_lora_a=tparams["layers"]["wq"]))
    with pytest.raises(NotImplementedError, match="LoRA"):
        tdecoder.decoder_forward(tcfg, lora, input_ids=torch.tensor([[1, 2]]))
    cache = dict(tdecoder.init_kv_cache(tcfg, 1, 8), block_tables=torch.zeros((1, 2)))
    with pytest.raises(NotImplementedError, match="paged"):
        tdecoder.decoder_forward(tcfg, tparams, input_ids=torch.tensor([[1]]), kv_cache=cache)
    with pytest.raises(NotImplementedError, match="quantized"):
        tdecoder._dense(torch.zeros(1, 1, 4), {"q": None}, None, torch.float32)
