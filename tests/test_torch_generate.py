"""Port generation and inference against the JAX package's, fp32 on the CPU.

Greedy tokens and completion texts must be EQUAL: both packages run the
same weights in fp32 (a seeded init of the port's as numpy arrays in the
JAX layout, handed to JAX as they are and to the port through
`params_from_numpy`; JAX's init would add a compile per config), so only
summation order differs, far below the gaps between the tiny model's top
logits. Sampling cannot share random numbers across frameworks, so the
top-k/top-p masking is held to JAX's by feeding both the same Gumbel noise
(jax.random.categorical is argmax(logits + gumbel)).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu import generate as jgen
from llark_tpu import infer as jinfer
from llark_tpu.config import ModelConfig as JaxConfig
from llark_tpu.tokenization import TokenizerBundle as JBundle
from llark_tpu.tokenization import WordTokenizer as JWordTokenizer
from llark_tpu_torch import generate as tgen
from llark_tpu_torch import infer as tinfer
from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models.fusion import init_llark_params as tinit
from llark_tpu_torch.tokenization import TokenizerBundle, WordTokenizer

PATCH_ID = 7


@functools.lru_cache(maxsize=None)
def _numpy_tree(arch, seed, num_kv_heads):
    # the weights depend on these only, so cases that differ in kernel
    # switches share one init
    tcfg = ModelConfig.tiny(arch, num_kv_heads=num_kv_heads, dtype="float32",
                            param_dtype="float32")
    params = tinit(tcfg, seed=seed, device="cpu")
    return jax.tree.map(lambda t: t.numpy(), params)


def _models(arch="llama", seed=0, **kw):
    over = dict(dtype="float32", param_dtype="float32", **kw)
    jcfg = JaxConfig.tiny(arch, **over)
    tcfg = ModelConfig.tiny(arch, **over)
    tree = _numpy_tree(arch, seed, tcfg.num_kv_heads)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tree, tcfg, "cpu")


def _bundles():
    return (JBundle.from_tokenizer(JWordTokenizer(512)),
            TokenizerBundle.from_tokenizer(WordTokenizer(512)))


@pytest.mark.parametrize("arch", ["llama", "mpt"])
@pytest.mark.parametrize("flash_decode", [None, True], ids=["xla", "flash"])
def test_generator_greedy_matches_jax(arch, flash_decode):
    # "flash": the port takes both kernel wrappers (plain versions on the CPU)
    jcfg, jparams, tcfg, tparams = _models(
        arch, num_kv_heads=2, use_flash_decode=flash_decode,
        use_pallas_attention=bool(flash_decode),
    )
    rng = np.random.RandomState(0)
    ids = np.array([[9, 1, PATCH_ID, PATCH_ID, PATCH_ID, 4, 5, 0],
                    [9, PATCH_ID, PATCH_ID, PATCH_ID, 11, 0, 0, 0]], np.int32)
    lengths = np.array([7, 5], np.int32)
    audio = rng.randn(2, 3, jcfg.mm_hidden_size).astype(np.float32)
    counts = np.array([3, 3], np.int32)
    # 1 token from prefill, then two chunks of 3: one JAX chunk program
    gcfg = dict(max_new_tokens=7, stop_text="", decode_chunk=3)
    want = jgen.Generator(
        jcfg, jparams, PATCH_ID, jgen.GenerationConfig(**gcfg), max_cache_len=32
    ).generate(ids, lengths, audio, counts)
    got = tgen.Generator(
        tcfg, tparams, PATCH_ID, tgen.GenerationConfig(**gcfg), max_cache_len=32, device="cpu"
    ).generate(ids, lengths, audio, counts)
    assert got == want
    assert all(len(row) == 7 for row in got)


def test_infer_with_prompt_text_matches_jax():
    jcfg, jparams, tcfg, tparams = _models(seed=1)
    jb, tb = _bundles()
    enc = np.random.RandomState(1).randn(4, jcfg.mm_hidden_size).astype(np.float32)
    gcfg = dict(max_new_tokens=6)
    jg = jgen.Generator(jcfg, jparams, jb.audio_patch_id, jgen.GenerationConfig(**gcfg),
                        max_cache_len=256)
    tg = tgen.Generator(tcfg, tparams, tb.audio_patch_id, tgen.GenerationConfig(**gcfg),
                        max_cache_len=256, device="cpu")
    want = jinfer.infer_with_prompt("What is the tempo?", enc, jg, jb)
    got = tinfer.infer_with_prompt("What is the tempo?", enc, tg, tb)
    assert got == want
    assert tinfer.build_prompt_ids("What is the tempo?", 4, tb) == \
        jinfer.build_prompt_ids("What is the tempo?", 4, jb)


def test_batch_infer_greedy_matches_jax():
    jcfg, jparams, tcfg, tparams = _models(seed=2)
    jb, tb = _bundles()
    rng = np.random.RandomState(2)
    rows = [
        {"example_id": "a", "prompt": "Describe the drums.",
         "audio_encoding": rng.randn(1, 3, jcfg.mm_hidden_size).astype(np.float32)},
        {"example_id": "b", "response": "slow",
         "audio_encoding": rng.randn(5, jcfg.mm_hidden_size).astype(np.float32)},
    ]
    gcfg = dict(max_new_tokens=4)
    jg = jgen.Generator(jcfg, jparams, jb.audio_patch_id, jgen.GenerationConfig(**gcfg),
                        max_cache_len=256)
    tg = tgen.Generator(tcfg, tparams, tb.audio_patch_id, tgen.GenerationConfig(**gcfg),
                        max_cache_len=256, device="cpu")
    want = jinfer.batch_infer(rows, jg, jb, max_audio_frames=4)
    got = tinfer.batch_infer(rows, tg, tb, max_audio_frames=4)
    assert got == want


@pytest.mark.parametrize(
    "temperature,top_k,top_p",
    [(1.0, 0, 1.0), (0.7, 5, 1.0), (1.0, 0, 0.9), (1.3, 8, 0.6), (1.0, 100, 0.3)],
)
def test_sample_masking_matches_jax(temperature, top_k, top_p):
    cfg = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    logits = np.random.RandomState(3).randn(16, 50).astype(np.float32) * 3
    masked = tgen._filter_logits(torch.from_numpy(logits), tgen.GenerationConfig(**cfg))
    for i in range(8):
        key = jax.random.PRNGKey(i)
        want = np.asarray(jgen._sample(jnp.asarray(logits), jgen.GenerationConfig(**cfg), key))
        noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
        got = torch.argmax(masked + torch.from_numpy(np.array(noise)), dim=-1).numpy()
        np.testing.assert_array_equal(got, want)


def test_sample_greedy_and_support():
    logits = torch.tensor([[0.0, 5.0, 4.0, -1.0, 3.0]])
    assert int(tgen._sample(logits, tgen.GenerationConfig(), None)[0]) == 1
    cfg = tgen.GenerationConfig(temperature=1.0, top_k=2)
    gen = torch.Generator().manual_seed(0)
    seen = {int(tgen._sample(logits, cfg, gen)[0]) for _ in range(50)}
    assert seen == {1, 2}


@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["greedy", "sampled"])
def test_decode_chunking_does_not_change_tokens(temperature):
    _, _, tcfg, tparams = _models(seed=4)
    ids = np.array([[5, 6, 8, 9, 10, 0]], np.int32)
    lengths = np.array([5], np.int32)
    outs = []
    for chunk in (1, 3, 8):
        gcfg = tgen.GenerationConfig(max_new_tokens=9, stop_text="", decode_chunk=chunk,
                                     temperature=temperature)
        gen = tgen.Generator(tcfg, tparams, PATCH_ID, gcfg, max_cache_len=32, device="cpu")
        outs.append(gen.generate(ids, lengths, rng=torch.Generator().manual_seed(5)))
    assert outs[0] == outs[1] == outs[2]


def test_batch_infer_seeds_one_generator_per_row():
    _, _, tcfg, tparams = _models(seed=5)
    _, tb = _bundles()
    enc = np.random.RandomState(5).randn(2, tcfg.mm_hidden_size).astype(np.float32)
    gcfg = tgen.GenerationConfig(max_new_tokens=6, temperature=1.0)
    tg = tgen.Generator(tcfg, tparams, tb.audio_patch_id, gcfg, max_cache_len=256, device="cpu")
    rows = [{"audio_encoding": enc}, {"audio_encoding": enc}]
    got = tinfer.batch_infer(rows, tg, tb, seed=11)
    for i, row in enumerate(got):
        want = tinfer.infer_with_prompt(
            "Describe the audio.", enc, tg, tb, rng=torch.Generator().manual_seed(11 + i)
        )
        assert row["model_completion"] == want


def test_generator_eos_and_cache_bound():
    _, _, tcfg, tparams = _models(seed=6)
    ids = np.array([[5, 6, 7, 8]], np.int32)
    first = tgen.Generator(
        tcfg, tparams, PATCH_ID, tgen.GenerationConfig(max_new_tokens=3, stop_text=""),
        max_cache_len=32, device="cpu",
    ).generate(ids, np.array([4], np.int32))[0][0]
    gen = tgen.Generator(
        tcfg, tparams, PATCH_ID,
        tgen.GenerationConfig(max_new_tokens=5, eos_token_id=first, stop_text=""),
        max_cache_len=32, device="cpu",
    )
    assert gen.generate(ids, np.array([4], np.int32)) == [[]]
    with pytest.raises(ValueError, match="cache length"):
        gen.max_cache_len = 8
        gen.generate(ids, np.array([4], np.int32))
