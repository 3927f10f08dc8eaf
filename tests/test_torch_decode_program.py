"""The port's decode program (`DecodeProgram`, `make_multistep_decode_fn`)
against the JAX package's jitted `make_multistep_decode_fn` and
`make_decode_fn`, fp32 on the CPU.

On the CPU a program runs `decode_n` on its own static buffers, so these
tests hold the plumbing the card's CUDA graph shares: the binding to one
params tree, one batch size and one set of cache tensors, the copies into
the static buffers, the host-side cache index, the Generator's cache kept
per batch size and prefilled in place, and the server's chunk and drain
programs with their block tables refreshed in place. The replay itself is
held against eager `decode_n` on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 26).

Both packages get the same numpy weights, caches and inputs. The caches
are random everywhere, also past each row's live length: what lies there
must never be read. Greedy tokens must be EQUAL and the last logits within
LOGITS_TOL of the JAX package's relative to their largest magnitude: both
sides compute in fp32 and differ only in summation order. The JAX side is
computed once, in a module fixture.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu import generate as jgen
from llark_tpu.config import ModelConfig as JaxConfig
from llark_tpu.inference import server as jserver
from llark_tpu_torch import generate as tgen
from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.inference.server import BatchedServer, Request
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models.fusion import init_llark_params

LOGITS_TOL = 1e-5
# head_dim 64 (128 / 2 heads), the narrowest width the card's kernels take
WIDTHS = dict(hidden_size=128, intermediate_size=128, num_heads=2, num_layers=2,
              vocab_size=256, mm_hidden_size=16, dtype="float32", param_dtype="float32")
ARCHS = {"llama": dict(num_kv_heads=1), "mpt": dict(num_kv_heads=2)}  # llama: GQA
B, S, BS = 3, 64, 8  # rows, cache positions, paged block size
LENGTHS = np.array([5, 17, 30])  # each row's live length = its next write position
MODES = {  # cache mode -> (int8 values and scales, paged)
    "dense": (False, False), "int8": (True, False),
    "paged": (False, True), "paged_int8": (True, True),
}
CHUNKS = {"full": 4, "tail": 3}  # decode_chunk, and a shorter last chunk
CHUNK_CASES = [(a, m, c) for a in ARCHS for m in MODES for c in CHUNKS
               if a == "llama" or m in ("dense", "paged_int8")]
STEP_CASES = [(a, m) for a in ARCHS for m in MODES if a == "llama" or m in ("dense", "paged")]
GREEDY = dict(temperature=0.0, stop_text="")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, int8=False):
    over = dict(WIDTHS, kv_cache_quant=int8, **ARCHS[arch])
    return JaxConfig.tiny(arch, **over), ModelConfig.tiny(arch, **over)


@functools.lru_cache(maxsize=None)
def _tree(arch):
    tcfg = _configs(arch)[1]
    return jax.tree.map(lambda t: t.numpy(), init_llark_params(tcfg, seed=0, device="cpu"))


def _cache(arch, mode, seed=0):
    """A numpy cache of B rows in `mode`, random everywhere (paged: the
    rows' tables a shuffle of the pool's real blocks)."""
    int8, paged = MODES[mode]
    cfg = _configs(arch)[1]
    rng = np.random.RandomState(seed)
    lead = (cfg.num_layers, B + B * (S // BS), cfg.num_kv_heads, BS) if paged else \
        (cfg.num_layers, B, cfg.num_kv_heads, S)
    shape = lead + (cfg.head_dim,)
    if int8:
        out = {k: rng.randint(-127, 128, shape).astype(np.int8) for k in ("k", "v")}
        out.update({k: (rng.rand(*lead) * 0.02).astype(np.float32) for k in ("k_scale", "v_scale")})
    else:
        out = {k: rng.randn(*shape).astype(np.float32) for k in ("k", "v")}
    if paged:
        real = B + rng.permutation(B * (S // BS)).astype(np.int32)
        out["block_tables"] = real.reshape(B, S // BS)
    return out


def _inputs(seed=0):
    rng = np.random.RandomState(seed + 100)
    return rng.randint(4, 250, B).astype(np.int64), LENGTHS.astype(np.int64)


def _jax_cache(np_cache):
    return dict({k: jnp.asarray(v) for k, v in np_cache.items()}, index=jnp.zeros((), jnp.int32))


def _port(arch, mode, seed=0):
    """(cfg, params, cache) of the port for one case."""
    tcfg = _configs(arch, MODES[mode][0])[1]
    cache = {k: torch.from_numpy(v.copy()) for k, v in _cache(arch, mode, seed).items()}
    cache["index"] = 0
    return tcfg, _params(arch), cache


@functools.lru_cache(maxsize=None)
def _params(arch):
    return params_from_numpy(_tree(arch), _configs(arch)[1], "cpu")


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's outputs for every case: jitted
    make_multistep_decode_fn per (arch, mode, chunk) and jitted
    make_decode_fn per (arch, mode), as numpy."""
    out = {}
    token, pos = _inputs()
    for arch, mode, chunk in CHUNK_CASES:
        jcfg = _configs(arch, MODES[mode][0])[0]
        fn = jax.jit(jgen.make_multistep_decode_fn(jcfg, jgen.GenerationConfig(**GREEDY),
                                                   CHUNKS[chunk]))
        toks, logits, cache = fn(jax.tree.map(jnp.asarray, _tree(arch)),
                                 jnp.asarray(token, jnp.int32), _jax_cache(_cache(arch, mode)),
                                 jnp.asarray(pos, jnp.int32), jax.random.PRNGKey(0))
        out[arch, mode, chunk] = (np.asarray(toks), np.asarray(logits),
                                  {k: np.asarray(v) for k, v in cache.items()})
    for arch, mode in STEP_CASES:
        jcfg = _configs(arch, MODES[mode][0])[0]
        logits, _ = jax.jit(jgen.make_decode_fn(jcfg))(
            jax.tree.map(jnp.asarray, _tree(arch)), jnp.asarray(token, jnp.int32),
            _jax_cache(_cache(arch, mode)), jnp.asarray(pos, jnp.int32))
        out[arch, mode] = np.asarray(logits)
    return out


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch,mode,chunk", CHUNK_CASES)
def test_chunk_program_matches_jax(jax_side, arch, mode, chunk):
    want_toks, want_logits, want_cache = jax_side[arch, mode, chunk]
    tcfg, params, cache = _port(arch, mode)
    steps = CHUNKS[chunk]
    program = tgen.make_multistep_decode_fn(tcfg, tgen.GenerationConfig(**GREEDY), steps)
    token, pos = _inputs()
    toks, logits, out = program(params, torch.from_numpy(token), cache, torch.from_numpy(pos),
                                None)
    assert toks.shape == (B, steps) and toks.dtype == torch.int64
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    assert _rel(logits.numpy(), want_logits) <= LOGITS_TOL
    # the cache was written in place and its host-side index advanced
    assert out["k"] is cache["k"] and out["index"] == steps
    if not MODES[mode][0]:
        for key in ("k", "v"):
            assert _rel(out[key].numpy(), want_cache[key]) <= LOGITS_TOL


@pytest.mark.parametrize("arch,mode", STEP_CASES)
def test_decode_fn_matches_jax(jax_side, arch, mode):
    tcfg, params, cache = _port(arch, mode)
    token, pos = _inputs()
    logits, out = tgen.make_decode_fn(tcfg)(params, torch.from_numpy(token), cache,
                                            torch.from_numpy(pos))
    assert _rel(logits.numpy(), jax_side[arch, mode]) <= LOGITS_TOL
    assert out["index"] == 1


@pytest.mark.parametrize("mode", list(MODES))
def test_program_calls_equal_decode_n(mode):
    # three chunks in a row through one program, the tokens fed back as the
    # Generator feeds them, against decode_n on a copy of the same cache
    tcfg, params, cache = _port("llama", mode)
    _, _, ref = _port("llama", mode)
    gcfg = tgen.GenerationConfig(**GREEDY)
    program = tgen.make_multistep_decode_fn(tcfg, gcfg, 2)
    token, pos = (torch.from_numpy(x) for x in _inputs())
    tok_r = token
    for i in range(3):
        toks, _, cache = program(params, token, cache, pos + 2 * i, None)
        want, _, ref = tgen.decode_n(tcfg, gcfg, params, tok_r, ref, pos + 2 * i, 2, None)
        assert torch.equal(toks, want)
        token, tok_r = toks[:, -1], want[:, -1]
    assert program.calls == 3 and cache["index"] == 6
    for key in ref:
        if key != "index":
            assert torch.equal(cache[key], ref[key])


@pytest.mark.parametrize("what", ["params", "cache", "tables", "batch"])
def test_program_binds_params_batch_and_cache(what):
    tcfg, params, cache = _port("llama", "paged")
    program = tgen.make_multistep_decode_fn(tcfg, tgen.GenerationConfig(**GREEDY), 2)
    token, pos = (torch.from_numpy(x) for x in _inputs())
    program(params, token, cache, pos, None)
    if what == "params":
        params = dict(params)
    elif what == "cache":
        cache = dict(cache, k=cache["k"].clone())
    elif what == "tables":  # replaced, not copied in place
        cache = dict(cache, block_tables=cache["block_tables"].clone())
    else:
        token, pos = token[:2], pos[:2]
    match = {"params": "params tree", "batch": "batch"}.get(what, "cache tensors")
    with pytest.raises(ValueError, match=match):
        program(params, token, cache, pos, None)


@pytest.mark.parametrize("mode", ["dense", "paged_int8"])
def test_sampled_program_draws_new_noise_and_advances_the_generator(mode):
    tcfg, params, cache = _port("llama", mode)
    gcfg = tgen.GenerationConfig(temperature=1.5, top_k=50, stop_text="")
    program = tgen.make_multistep_decode_fn(tcfg, gcfg, 4)
    token, pos = (torch.from_numpy(x) for x in _inputs())
    rng = torch.Generator().manual_seed(3)
    first = program(params, token, cache, pos, rng)[0].clone()
    state = rng.get_state()
    second = program(params, token, cache, pos, rng)[0].clone()
    assert not torch.equal(first, second)
    assert not torch.equal(rng.get_state(), state)
    # the same seed gives decode_n's draws
    _, _, ref = _port("llama", mode)
    want = tgen.decode_n(tcfg, gcfg, params, token, ref, pos, 4, torch.Generator().manual_seed(3))[0]
    assert torch.equal(first, want)


# -- Generator: one cache per batch size, prefilled in place ---------------

PROMPTS = [  # (ids, live length); the second call's prompts are shorter
    (np.array([[9, 1, 7, 7, 7, 4, 5, 8, 3, 2], [9, 7, 7, 7, 11, 12, 13, 14, 0, 0]], np.int32),
     np.array([10, 8], np.int32)),
    (np.array([[9, 3, 7, 7, 7, 6, 0, 0, 0, 0], [9, 7, 7, 7, 12, 0, 0, 0, 0, 0]], np.int32),
     np.array([6, 5], np.int32)),
]


def _generator(arch, int8):
    tcfg = _configs(arch, int8)[1]
    gcfg = tgen.GenerationConfig(max_new_tokens=7, stop_text="", decode_chunk=4)
    return tgen.Generator(tcfg, _params(arch), 7, gcfg, max_cache_len=32, device="cpu")


def _audio(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(2, 3, WIDTHS["mm_hidden_size"]).astype(np.float32), np.array([3, 3], np.int32)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_generator_second_prompt_matches_a_fresh_generator(arch, int8):
    gen = _generator(arch, int8)
    outs = [gen.generate(ids, lens, *_audio(i)) for i, (ids, lens) in enumerate(PROMPTS)]
    for i, (ids, lens) in enumerate(PROMPTS):
        assert outs[i] == _generator(arch, int8).generate(ids, lens, *_audio(i))
        assert all(len(row) == 7 for row in outs[i])
    # one cache for batch 2; one program per chunk length: 6 steps = 4 + 2
    assert list(gen._caches) == [2]
    assert sorted(gen._programs) == [(2, 2), (2, 4)]
    assert all(p.calls == 2 for p in gen._programs.values())


def test_generator_keeps_a_cache_per_batch_size():
    gen = _generator("llama", False)
    ids, lens = PROMPTS[0]
    two = gen.generate(ids, lens)
    one = gen.generate(ids[1:], lens[1:])
    again = gen.generate(ids, lens)
    assert one == two[1:] and again == two
    assert sorted(gen._caches) == [1, 2]
    assert sorted(gen._programs) == [(1, 2), (1, 4), (2, 2), (2, 4)]
    # prefill returns the generator's own cache, written in place
    _, cache = gen.prefill(ids, lens)
    assert cache["k"] is gen._caches[2]["k"] and cache["index"] == ids.shape[1]


def test_prefill_refuses_a_cache_of_another_shape():
    tcfg, params, _ = _port("llama", "dense")
    cache = tgen.init_kv_cache(tcfg, 1, 16)
    ids = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="cannot take 2 rows"):
        tgen.prefill(tcfg, params, ids, torch.tensor([4, 4]), torch.zeros(2, 1, 16),
                     torch.zeros(2, dtype=torch.int32), 7, 16, cache)


# -- the serving engine's chunk and drain programs ---------------------------

SERVE_MODES = {
    "paged": dict(kv_block_size=8, kv_pool_blocks=2 + 8),
    "paged_int8": dict(int8=True, kv_block_size=8, kv_pool_blocks=2 + 8, prefill_chunk=8),
    "dense": {},
}
SERVE = dict(max_batch=2, max_cache_len=64, prompt_buckets=(16, 32), max_audio_frames=4,
             decode_chunk=4, decode_chunk_drain=1)


def _requests():
    rng = np.random.RandomState(7)
    return [(rng.randint(4, 200, n).astype(np.int32),
             rng.randn(3, WIDTHS["mm_hidden_size"]).astype(np.float32) if i % 2 else None)
            for i, n in enumerate([9, 14, 6, 11, 20])]


def _serve_kw(mode):
    kw = dict(SERVE, **SERVE_MODES[mode])
    return kw.pop("int8", False), kw


@pytest.fixture(scope="module")
def jax_streams():
    out = {}
    for mode in SERVE_MODES:
        int8, kw = _serve_kw(mode)
        jcfg = _configs("llama", int8)[0]
        server = jserver.BatchedServer(
            jcfg, jax.tree.map(jnp.asarray, _tree("llama")), 7,
            jgen.GenerationConfig(max_new_tokens=6, stop_text=""), **kw)
        out[mode] = [r.tokens for r in server.serve([jserver.Request(i, a) for i, a in _requests()])]
    return out


@pytest.mark.parametrize("mode", list(SERVE_MODES))
def test_server_chunk_and_drain_programs_match_jax(jax_streams, mode):
    int8, kw = _serve_kw(mode)
    server = BatchedServer(_configs("llama", int8)[1], _params("llama"), 7,
                           tgen.GenerationConfig(max_new_tokens=6, stop_text=""), device="cpu",
                           **kw)
    tables = []
    refresh = server._refresh_tables

    def spy():  # the table tensor each round decodes with
        refresh()
        tables.append(server._cache["block_tables"] if server.paged else None)

    server._refresh_tables = spy
    out = server.serve([Request(i, a) for i, a in _requests()])
    assert [r.tokens for r in out] == jax_streams[mode]
    # one program for the full chunk, one for the drain, both called
    assert sorted(server._programs) == [1, 4]
    assert all(p.calls > 0 for p in server._programs.values())
    if server.paged:  # refreshed in place between rounds: always one tensor
        assert len(tables) > 2 and all(t is tables[0] for t in tables)
        refresh()  # the last retirements' tables
        np.testing.assert_array_equal(server._cache["block_tables"].numpy(), server._host_tables)

