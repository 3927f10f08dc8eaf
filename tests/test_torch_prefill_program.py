"""The port's prefill and admission programs (`generate.make_prefill_fn`,
`make_prefill_chunk_fn`, `make_paged_prefill_chunk_fn`,
`make_prefill_last_fn`, `make_prefix_cache_fn`, `make_suffix_prefill_fn`,
`inference.paged.make_block_insert_fn`) against the JAX package's jitted
factories of the same names, fp32 on the CPU, and the serving engine's
admission through them against the JAX `BatchedServer`.

On the CPU a program runs its plain function on its own static buffers
and bound tensors, so these tests hold the plumbing the card's CUDA graph
shares: the binding to one params tree and one set of cache tensors, the
copies into the static buffers, the chunk offset a dense chunk program
reads from a device buffer (one program serves every chunk of a bucket),
the admission caches and block tables the engine allocates once and
rewrites in place. The replays themselves are held against the eager
route on the card (tests/test_torch_cuda.py, chip_smoke.py phase 26).

Both packages get the same numpy weights and inputs. The port's caches
start random, also where a program writes: what lies past each row's live
length must never be read. Logits must lie within LOGITS_TOL of the JAX
package's relative to their largest magnitude (both compute in fp32 and
differ only in summation order); fp32 caches within the same at every live
position. An int8 cache quantizes fp32 K/V whose last bits differ between
the packages, so a value may land one step away: its scales must lie
within LOGITS_TOL and its dequantized values within one quantization step.
Where later chunks attend the int8 history earlier chunks wrote, one such
value moves the logits by ~1e-4 of their largest magnitude: those cases
hold the logits within CHUNKED_INT8_TOL, set from the largest reading of
this file's cases (8.65e-5, dense and paged llama with one value of v a
step away; 5.4e-7 paged mpt) with room for 2.3 times it, and the chunk
program's writes equal the eager route's bit for bit. The engine's greedy tokens must be EQUAL. The JAX side runs
once, in module fixtures.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu import generate as jgen
from llark_tpu.config import ModelConfig as JaxConfig
from llark_tpu.inference import paged as jpaged
from llark_tpu.inference import server as jserver
from llark_tpu_torch import generate as tgen
from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.inference import paged as tpaged
from llark_tpu_torch.inference.server import BatchedServer, Request, RowInsertProgram
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models.fusion import init_llark_params

LOGITS_TOL = 1e-5
CHUNKED_INT8_TOL = 2e-4
WIDTHS = dict(hidden_size=128, intermediate_size=128, num_heads=2, num_layers=2,
              vocab_size=256, mm_hidden_size=16, dtype="float32", param_dtype="float32")
ARCHS = {"llama": dict(num_kv_heads=1), "mpt": dict(num_kv_heads=2)}  # llama: GQA
PATCH = 7
B, S, T = 3, 24, 3  # rows, padded prompt, audio frames
LENGTHS = np.array([24, 13, 5])  # live prompt lengths
CACHE_LEN = 32  # the prefill's max_cache_len
C, BS = 8, 8  # prefill chunk, paged block size
P = 8  # shared prefix length
CASES = [("llama", False), ("llama", True), ("mpt", False)]  # (arch, int8 KV cache)
PAGED_CASES = [("llama", False, 0), ("llama", True, 0), ("llama", False, BS), ("mpt", True, 0)]


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
    return jax.tree.map(lambda t: t.numpy(),
                        init_llark_params(_configs(arch)[1], seed=0, device="cpu"))


@functools.lru_cache(maxsize=None)
def _params(arch):
    return params_from_numpy(_tree(arch), _configs(arch)[1], "cpu")


def _jtree(arch):
    return jax.tree.map(jnp.asarray, _tree(arch))


def _prompts(seed):
    """ids [B, S] with audio patches, prompt lengths, audio [B, T, mm] and
    frame counts of one call."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(8, 250, (B, S)).astype(np.int32)
    ids[:, 2:2 + T] = PATCH
    ids[np.arange(S)[None, :] >= LENGTHS[:, None]] = 0
    audio = rng.randn(B, T, WIDTHS["mm_hidden_size"]).astype(np.float32)
    return ids, LENGTHS.astype(np.int32), audio, np.array([3, 2, 0], np.int32)


def _embeds(seed, s=S):
    return np.random.RandomState(seed + 50).randn(B, s, WIDTHS["hidden_size"]).astype(np.float32)


def _random_cache(cfg, lead, seed):
    """Numpy cache tensors of shape lead + (D,), random everywhere."""
    rng = np.random.RandomState(seed + 200)
    shape = lead + (cfg.head_dim,)
    if cfg.kv_cache_quant:
        out = {k: rng.randint(-127, 128, shape).astype(np.int8) for k in ("k", "v")}
        out.update({k: (rng.rand(*lead) * 0.02).astype(np.float32) for k in ("k_scale", "v_scale")})
    else:
        out = {k: rng.randn(*shape).astype(np.float32) for k in ("k", "v")}
    return out


def _dense(cfg, rows, length, seed):
    return _random_cache(cfg, (cfg.num_layers, rows, cfg.num_kv_heads, length), seed)


def _paged(cfg, span, seed):
    """A pool of B parking blocks and B * span real ones, and tables [B, span]
    naming the real ones in a random order."""
    out = _random_cache(cfg, (cfg.num_layers, B + B * span, cfg.num_kv_heads, BS), seed)
    real = B + np.random.RandomState(seed + 300).permutation(B * span).astype(np.int32)
    out["block_tables"] = real.reshape(B, span)
    return out


def _torch(np_cache, index=0):
    return dict({k: torch.from_numpy(v.copy()) for k, v in np_cache.items()}, index=index)


def _jax(np_cache, index=0):
    return dict({k: jnp.asarray(v) for k, v in np_cache.items()},
                index=jnp.asarray(index, jnp.int32))


def _numpy(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _dense_view(cache):
    """A paged cache's rows as [L, B, Hkv, span * bs(, D)], by its tables."""
    out = {}
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in cache:
            pool = np.asarray(cache[key])
            g = pool[:, np.asarray(cache["block_tables"])]  # [L, B, span, Hkv, bs(, D)]
            g = np.swapaxes(g, 2, 3)
            out[key] = g.reshape(g.shape[:3] + (-1,) + g.shape[5:])
    return out


def _check_cache(got, want, lengths, offset=0):
    """Every live position [offset, offset + length) of each row: fp32
    values within LOGITS_TOL; int8 scales within LOGITS_TOL and dequantized
    values within one step."""
    for b, n in enumerate(lengths):
        live = slice(offset, offset + int(n))
        if "k_scale" not in want:
            for key in ("k", "v"):
                assert _rel(got[key][:, b, :, live], want[key][:, b, :, live]) <= LOGITS_TOL, key
            continue
        for key in ("k", "v"):
            gs, ws = got[key + "_scale"][:, b, :, live], want[key + "_scale"][:, b, :, live]
            assert _rel(gs, ws) <= LOGITS_TOL, key
            gq, wq = got[key][:, b, :, live].astype(np.float32), want[key][:, b, :, live]
            deq = np.abs(gq * gs[..., None] - wq.astype(np.float32) * ws[..., None])
            step = (ws + 127 * np.abs(gs - ws))[..., None]
            assert float((deq - step).max()) <= 0.0, key


# -- the programs against the JAX package's jitted factories ---------------

@pytest.fixture(scope="module")
def jax_side():
    out = {}
    for arch, int8 in CASES:
        jcfg, tcfg = _configs(arch, int8)
        tree = _jtree(arch)
        # two prefills in a row, each of its own inputs
        fn = jax.jit(jgen.make_prefill_fn(jcfg, PATCH, CACHE_LEN))
        for seed in (0, 1):
            logits, cache = fn(tree, *map(jnp.asarray, _prompts(seed)))
            out["prefill", arch, int8, seed] = np.asarray(logits), _numpy(cache)
        # a dense chunked prefill: chunks at 0, 8, 16, then the tail
        chunk = jax.jit(jgen.make_prefill_chunk_fn(jcfg))
        last = jax.jit(jgen.make_prefill_last_fn(jcfg))
        cache, embeds = _jax(_dense(tcfg, B, S, 0)), jnp.asarray(_embeds(0))
        lengths = jnp.asarray(LENGTHS, jnp.int32)
        for c in range(0, S, C):
            cache = chunk(tree, embeds[:, c:c + C], lengths, cache)
        logits, cache = last(tree, embeds, lengths, cache)
        out["chunk", arch, int8] = np.asarray(logits), _numpy(cache)
        # suffixes over a seeded prefix cache, twice
        prefix = jax.jit(jgen.make_prefix_cache_fn(jcfg))(tree, jnp.asarray(_prefix_ids()))
        out["prefix", arch, int8] = _numpy(prefix)
        suffix = jax.jit(jgen.make_suffix_prefill_fn(jcfg, PATCH))
        for seed in (0, 1):
            logits, cache = suffix(tree, *map(jnp.asarray, _prompts(seed)), _seeded_jax(prefix))
            out["suffix", arch, int8, seed] = np.asarray(logits), _numpy(cache)
    for arch, int8, offset in PAGED_CASES:
        jcfg, tcfg = _configs(arch, int8)
        tree = _jtree(arch)
        chunk = jax.jit(jgen.make_paged_prefill_chunk_fn(jcfg))
        last = jax.jit(jgen.make_prefill_last_fn(jcfg, pos_offset=offset))
        cache, embeds = _jax(_paged(tcfg, (offset + S) // BS, 0)), jnp.asarray(_embeds(0))
        lengths = jnp.asarray(LENGTHS + offset, jnp.int32)
        for c in range(0, S, C):
            cache = chunk(tree, embeds[:, c:c + C], lengths, cache, jnp.int32(offset + c))
        logits, cache = last(tree, embeds, jnp.asarray(LENGTHS, jnp.int32), cache)
        out["paged", arch, int8, offset] = np.asarray(logits), _numpy(cache)
    for int8 in (False, True):
        tcfg = _configs("llama", int8)[1]
        insert = jax.jit(jpaged.make_block_insert_fn(BS, 3))
        got = insert(_jax(_paged(tcfg, 4, 1)), _jax(_dense(tcfg, B, 20, 2)), 1,
                     jnp.asarray([9, 4, 12], jnp.int32))
        out["block_insert", int8] = _numpy(got)
    return out


def _prefix_ids():
    return np.random.RandomState(9).randint(8, 250, (1, P)).astype(np.int32)


def _seeded_jax(prefix):
    """The JAX server's seeding: the prefix broadcast into B rows of a
    P + S cache at index P (llark_tpu/inference/server.py:652-664)."""
    out = {}
    for key, p in prefix.items():
        if key == "index":
            out[key] = jnp.asarray(P, jnp.int32)
            continue
        z = jnp.zeros(p.shape[:1] + (B,) + p.shape[2:3] + (P + S,) + p.shape[4:], p.dtype)
        out[key] = jax.lax.dynamic_update_slice(z, jnp.broadcast_to(p, (p.shape[0], B) + p.shape[2:]),
                                                (0,) * z.ndim)
    return out


def _seeded_port(tcfg, prefix):
    cache = _torch(_dense(tcfg, B, P + S, 3), index=P)
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in cache:
            cache[key][:, :, :, :P] = prefix[key]
    return cache


def _prompt_tensors(seed):
    ids, lengths, audio, frames = _prompts(seed)
    return (torch.from_numpy(ids).long(), torch.from_numpy(lengths), torch.from_numpy(audio),
            torch.from_numpy(frames))


@pytest.mark.parametrize("arch,int8", CASES)
def test_prefill_program_matches_jax(jax_side, arch, int8):
    tcfg = _configs(arch, int8)[1]
    program = tgen.make_prefill_fn(tcfg, PATCH, CACHE_LEN)
    cache = _torch(_dense(tcfg, B, CACHE_LEN, 5))
    for seed in (0, 1):  # one program, one cache, two prompts
        logits, out = program(_params(arch), *_prompt_tensors(seed), cache)
        want_logits, want_cache = jax_side["prefill", arch, int8, seed]
        assert logits.shape == (B, tcfg.vocab_size)
        assert _rel(logits.numpy(), want_logits) <= LOGITS_TOL
        assert out["k"] is cache["k"] and out["index"] == S
        _check_cache({k: v.numpy() for k, v in cache.items() if k != "index"}, want_cache, LENGTHS)
    assert program.calls == 2


@pytest.mark.parametrize("arch,int8", CASES)
def test_one_chunk_program_serves_every_offset_and_matches_jax(jax_side, arch, int8):
    tcfg = _configs(arch, int8)[1]
    want_logits, want_cache = jax_side["chunk", arch, int8]
    chunk, last = tgen.make_prefill_chunk_fn(tcfg), tgen.make_prefill_last_fn(tcfg)
    cache, embeds = _torch(_dense(tcfg, B, S, 0)), torch.from_numpy(_embeds(0))
    lengths = torch.from_numpy(LENGTHS.astype(np.int32))
    out = cache
    for c in range(0, S, C):
        out = chunk(_params(arch), embeds[:, c:c + C], lengths, out)
        assert out["index"] == c + C
    # the offsets went through one static device buffer
    assert chunk.calls == S // C and chunk._inputs["offset"].tolist() == [S - C] * B
    # the eager route's chunks write the same cache
    ref = _torch(_dense(tcfg, B, S, 0))
    for c in range(0, S, C):
        ref = chunk.plain(_params(arch), embeds[:, c:c + C], lengths, ref)
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in ref:
            assert torch.equal(ref[key], cache[key]), key
    logits, out = last(_params(arch), embeds, lengths, out)
    assert _rel(logits.numpy(), want_logits) <= (CHUNKED_INT8_TOL if int8 else LOGITS_TOL)
    _check_cache({k: v.numpy() for k, v in cache.items() if k != "index"}, want_cache, LENGTHS)


@pytest.mark.parametrize("arch,int8,offset", PAGED_CASES)
def test_paged_chunk_and_tail_programs_match_jax(jax_side, arch, int8, offset):
    tcfg = _configs(arch, int8)[1]
    want_logits, want_cache = jax_side["paged", arch, int8, offset]
    chunk = tgen.make_paged_prefill_chunk_fn(tcfg)
    last = tgen.make_prefill_last_fn(tcfg, pos_offset=offset)
    cache, embeds = _torch(_paged(tcfg, (offset + S) // BS, 0)), torch.from_numpy(_embeds(0))
    lengths = torch.from_numpy(LENGTHS.astype(np.int32))
    for c in range(0, S, C):
        chunk(_params(arch), embeds[:, c:c + C], lengths + offset, cache, offset + c)
    assert chunk._inputs["start"].tolist() == [offset + S - C] * B
    logits, _ = last(_params(arch), embeds, lengths, cache)
    assert _rel(logits.numpy(), want_logits) <= (CHUNKED_INT8_TOL if int8 else LOGITS_TOL)
    got = _dense_view({k: v.numpy() for k, v in cache.items() if k != "index"})
    _check_cache(got, _dense_view(want_cache), LENGTHS, offset)


@pytest.mark.parametrize("arch,int8", CASES)
def test_seeded_suffix_cache_keeps_its_prefix_and_matches_jax(jax_side, arch, int8):
    tcfg = _configs(arch, int8)[1]
    prefix = tgen.make_prefix_cache_fn(tcfg)(_params(arch), torch.from_numpy(_prefix_ids()).long())
    want_prefix = jax_side["prefix", arch, int8]
    assert prefix["index"] == P and prefix["k"].shape[3] == P
    _check_cache({k: v.numpy() for k, v in prefix.items() if k != "index"}, want_prefix, [P])
    cache = _seeded_port(tcfg, prefix)
    seed_values = {k: v[:, :, :, :P].clone() for k, v in cache.items() if k != "index"}
    program = tgen.make_suffix_prefill_fn(tcfg, PATCH)
    for seed in (0, 1):  # two admissions over the one seeded cache
        logits, out = program(_params(arch), *_prompt_tensors(seed), cache)
        want_logits, want_cache = jax_side["suffix", arch, int8, seed]
        assert _rel(logits.numpy(), want_logits) <= LOGITS_TOL
        assert out["index"] == P + S and out["k"] is cache["k"]
        _check_cache({k: v.numpy() for k, v in cache.items() if k != "index"}, want_cache,
                     LENGTHS, P)
        for key, v in seed_values.items():
            assert torch.equal(cache[key][:, :, :, :P], v), key
    # bound to the prefix length it was first called with
    with pytest.raises(ValueError, match="index"):
        program(_params(arch), *_prompt_tensors(0), dict(cache, index=P - 1))


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_block_insert_program_matches_jax(jax_side, int8):
    tcfg = _configs("llama", int8)[1]
    paged, rows = _torch(_paged(tcfg, 4, 1)), _torch(_dense(tcfg, B, 20, 2))
    program = tpaged.make_block_insert_fn(BS, 3)
    assert program(paged, rows, 1, [9, 4, 12]) is paged
    for key, want in jax_side["block_insert", int8].items():
        if key != "index":
            np.testing.assert_array_equal(paged[key].numpy(), want)
    # another row into other blocks through the same program, against the
    # eager insert
    ref = {k: v.clone() if torch.is_tensor(v) else v for k, v in paged.items()}
    program(paged, rows, 2, torch.tensor([5, 6, 7]))
    tpaged.insert_blocks(ref, rows, 2, [5, 6, 7])
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in ref:
            assert torch.equal(paged[key], ref[key]), key
    with pytest.raises(ValueError, match="3 blocks"):
        program(paged, rows, 0, [5, 6])


def test_row_insert_program_equals_the_eager_insert():
    tcfg = _configs("llama", True)[1]
    batch, rows = _torch(_dense(tcfg, 4, 40, 1)), _torch(_dense(tcfg, B, 24, 2))
    ref = {k: v.clone() if torch.is_tensor(v) else v for k, v in batch.items()}
    program = RowInsertProgram()
    for src, dst in ((0, 3), (2, 1)):
        program(batch, rows, src, dst)
        program.plain(ref, rows, src, dst)
    assert program.calls == 2
    for key in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(batch[key], ref[key]), key


# -- binding -----------------------------------------------------------------

def _bound_call(what):
    """(program, its call's arguments, the same with one cache tensor
    replaced by a copy)."""
    tcfg = _configs("llama")[1]
    params = _params("llama")
    embeds, lengths = torch.from_numpy(_embeds(0)), torch.from_numpy(LENGTHS.astype(np.int32))
    if what == "prefill":
        cache = _torch(_dense(tcfg, B, CACHE_LEN, 0))
        program, args = tgen.make_prefill_fn(tcfg, PATCH, CACHE_LEN), (params, *_prompt_tensors(0))
    elif what == "chunk":
        cache = _torch(_dense(tcfg, B, S, 0))
        program, args = tgen.make_prefill_chunk_fn(tcfg), (params, embeds[:, :C], lengths)
    elif what == "paged_chunk":
        cache = _torch(_paged(tcfg, S // BS, 0))
        program, args = tgen.make_paged_prefill_chunk_fn(tcfg), (params, embeds[:, :C], lengths)
    elif what == "last":
        cache = _torch(_paged(tcfg, S // BS, 0))
        program, args = tgen.make_prefill_last_fn(tcfg), (params, embeds, lengths)
    elif what == "suffix":
        cache = _torch(_dense(tcfg, B, P + S, 0), index=P)
        program, args = tgen.make_suffix_prefill_fn(tcfg, PATCH), (params, *_prompt_tensors(0))
    elif what == "block_insert":
        rows = _torch(_dense(tcfg, B, 16, 2))
        cache = _torch(_paged(tcfg, 4, 1))
        program = tpaged.make_block_insert_fn(BS, 2)
        return program, (cache, rows, 0, [4, 5]), (dict(cache, v=cache["v"].clone()), rows, 0,
                                                   [4, 5])
    else:  # "insert"
        rows = _torch(_dense(tcfg, B, 16, 2))
        cache = _torch(_dense(tcfg, 4, 32, 1))
        program = RowInsertProgram()
        return program, (cache, rows, 0, 1), (cache, dict(rows, k=rows["k"].clone()), 0, 1)
    tail = (C,) if what == "paged_chunk" else ()
    other = dict(cache, k=cache["k"].clone())
    if what in ("paged_chunk", "last"):  # the tables, replaced instead of copied in place
        other = dict(cache, block_tables=cache["block_tables"].clone())
    return program, args + (cache,) + tail, args + (other,) + tail


@pytest.mark.parametrize("what", ["prefill", "chunk", "paged_chunk", "last", "suffix",
                                  "block_insert", "insert"])
def test_a_call_with_other_cache_tensors_raises(what):
    program, args, other = _bound_call(what)
    program(*args)
    program(*args)  # the same tensors: no error
    with pytest.raises(ValueError, match="cache tensors"):
        program(*other)
    if what not in ("block_insert", "insert"):
        with pytest.raises(ValueError, match="params tree"):
            program(*((dict(args[0]),) + args[1:]))
    assert program.calls == 2


def test_a_program_serves_one_shape():
    tcfg = _configs("llama")[1]
    program = tgen.make_prefill_chunk_fn(tcfg)
    cache, embeds = _torch(_dense(tcfg, B, S, 0)), torch.from_numpy(_embeds(0))
    lengths = torch.from_numpy(LENGTHS.astype(np.int32))
    program(_params("llama"), embeds[:, :C], lengths, cache)
    with pytest.raises(ValueError, match="one batch and shape"):
        program(_params("llama"), embeds[:, :2 * C], lengths, cache)


# -- the engine's admission through its programs ------------------------------

ENGINE = {  # mode -> (int8 KV cache, server keywords, the admission steps it runs)
    "a": (True, dict(kv_block_size=8, prefill_chunk=8), {"embed", "paged_chunk", "last"}),
    "b": (False, {}, {"prefill", "insert"}),
    "c": (False, dict(kv_block_size=8, prefill_chunk=8, prefix=True),
          {"embed", "paged_chunk", "last"}),
    "d": (True, {}, {"prefill", "insert"}),
    "dense_chunked": (False, dict(prefill_chunk=8), {"embed", "chunk", "last", "insert"}),
    "dense_prefix": (True, dict(prefix=True), {"suffix", "insert"}),
    "paged_one_shot": (False, dict(kv_block_size=8), {"prefill", "block_insert"}),
}
SERVE = dict(max_batch=2, max_cache_len=64, prompt_buckets=(16, 32), max_audio_frames=4,
             decode_chunk=4)
SHARED = np.random.RandomState(11).randint(8, 200, 10).astype(np.int32)


def _requests():
    """Five prompts opening with SHARED, across both buckets; two slots, so
    later groups are admitted while earlier rows decode (and, chunked,
    decode between their chunks)."""
    rng = np.random.RandomState(7)
    return [(np.concatenate([SHARED, rng.randint(8, 200, n).astype(np.int32)]),
             rng.randn(3, WIDTHS["mm_hidden_size"]).astype(np.float32) if i % 2 else None)
            for i, n in enumerate([3, 12, 20, 6, 15])]


def _engine_kw(mode):
    int8, kw, _ = ENGINE[mode]
    kw = dict(SERVE, **kw)
    if kw.pop("prefix", False):
        kw["shared_prefix_ids"] = SHARED
    return int8, kw


@pytest.fixture(scope="module")
def jax_streams():
    out = {}
    for mode in ENGINE:
        int8, kw = _engine_kw(mode)
        server = jserver.BatchedServer(_configs("llama", int8)[0], _jtree("llama"), PATCH,
                                       jgen.GenerationConfig(max_new_tokens=6, stop_text=""), **kw)
        out[mode] = [r.tokens for r in server.serve([jserver.Request(i, a) for i, a in _requests()])]
    return out


@pytest.mark.parametrize("mode", list(ENGINE))
def test_engine_admission_programs_match_jax(jax_streams, mode):
    int8, kw = _engine_kw(mode)
    server = BatchedServer(_configs("llama", int8)[1], _params("llama"), PATCH,
                           tgen.GenerationConfig(max_new_tokens=6, stop_text=""), device="cpu",
                           **kw)
    out = server.serve([Request(i, a) for i, a in _requests()])
    assert [r.tokens for r in out] == jax_streams[mode]
    # every admission went through the mode's programs, one per step and
    # bucket, each called and bound to tensors allocated once
    assert {kind for kind, _ in server._admission} == ENGINE[mode][2]
    assert {bucket for _, bucket in server._admission} == {16, 32}
    assert all(p.calls > 0 for p in server._admission.values())
    for (kind, bucket), program in server._admission.items():
        if kind in ("prefill", "suffix", "chunk"):
            cache = program._bound["cache"]
            assert any(cache["k"] is c["k"] for c in server._admit_caches.values())
        if kind in ("paged_chunk", "last") and server.paged:
            tables = program._bound["cache"]["block_tables"]
            assert any(tables is t for t in server._admit_tables.values())
    if mode == "dense_prefix":  # seeded once per bucket, the prefix still there
        assert sorted(server._admit_caches) == [10 + 16, 10 + 32]
        for cache in server._admit_caches.values():
            for key in ("k", "v", "k_scale", "v_scale"):
                want = server._prefix_cache[key].expand(-1, cache[key].shape[1], -1, -1,
                                                        *cache[key].shape[4:])
                assert torch.equal(cache[key][:, :, :, :10], want), key
