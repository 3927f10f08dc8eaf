"""The port's mesh serving against the JAX package's, fp32 on the CPU:
`ShardedGenerator`, `BatchedServer(mesh=)` and the online engine whose rank 0
broadcasts each round to the others.

The port runs in a world of 4 gloo ranks (`parallel/launch.py` LocalWorld,
one module-scoped world); the JAX side runs its ShardedGenerator on 4 of
the 8 virtual CPU devices and its Generator on one. Both get the same numpy
weights (a seeded init of the port's, in the JAX layout), prompts and audio.
Greedy tokens are held EQUAL in every case: to the JAX mesh run and the
JAX single-device run for the generator, to the JAX single-device
Generator on the same prompts for the serving engine (whose per-request
tokens are greedy generation's; the JAX package's own mesh server is
tested against its single-device server in tests/test_sharded_serving.py).
The worker functions import no JAX: the ranks import this module by name.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.generate import GenerationConfig
from llark_tpu_torch.inference.http_server import OnlineEngine, follow
from llark_tpu_torch.inference.server import BatchedServer, Request
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models import quant as tquant
from llark_tpu_torch.models.fusion import init_llark_params
from llark_tpu_torch.parallel import mesh as tmesh
from llark_tpu_torch.parallel.launch import LocalWorld
from llark_tpu_torch.parallel.serving import ShardedGenerator, kv_cache_spec
from llark_tpu_torch.tokenization import TokenizerBundle, WordTokenizer

WORLD = 4
KW = dict(dtype="float32", param_dtype="float32", mm_hidden_size=8)


@functools.lru_cache(maxsize=None)
def _jax():
    import jax
    import jax.numpy as jnp

    from llark_tpu.config import ModelConfig as JaxConfig
    from llark_tpu.generate import GenerationConfig as JGenerationConfig
    from llark_tpu.generate import Generator as JGenerator
    from llark_tpu.models import quant as jquant
    from llark_tpu.parallel import mesh as jmesh
    from llark_tpu.parallel import serving as jserving
    from llark_tpu.tokenization import TokenizerBundle as JBundle
    from llark_tpu.tokenization import WordTokenizer as JWordTokenizer

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


def _bundle():
    return TokenizerBundle.from_tokenizer(WordTokenizer(128))


def _cfg(arch):
    b = _bundle()
    return ModelConfig.tiny(arch, vocab_size=int(np.ceil(len(b.tokenizer) / 128) * 128), **KW)


@functools.lru_cache(maxsize=None)
def _tree(arch, seed=0):
    params = init_llark_params(_cfg(arch), seed=seed, device="cpu")
    return {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v.numpy())
            for k, v in params.items()}


def _inputs(header=0):
    """Right-padded prompts with a bos, ragged lengths, audio frames; with
    `header`, every prompt opens with the same `header` tokens."""
    b = _bundle()
    rng = np.random.RandomState(0)
    plens = np.array([5, 9, 7, 6], np.int32) + header
    ids = np.full((4, 32), b.pad_token_id, np.int32)
    head = rng.randint(4, 40, header)
    for i, n in enumerate(plens):
        ids[i, :n] = rng.randint(4, 40, n)
        ids[i, :header] = head
        ids[i, 0] = b.tokenizer.bos_token_id
    audio = rng.randn(4, 3, 8).astype(np.float32)
    fcnt = np.array([3, 2, 3, 1], np.int32)
    return ids, plens, audio, fcnt


def _quantized(cfg, tree, quant, torch_side=True):
    """The tree of a quant mode, in the port's (torch) or JAX's hands."""
    if quant is None:
        if torch_side:
            return params_from_numpy(tree, cfg, "cpu")
        J = _jax()
        return J.jax.tree.map(J.jnp.asarray, tree)
    if torch_side:
        params = params_from_numpy(tree, cfg, "cpu")
        if quant == "int8":
            return tquant.quantize_params_int8_incremental(cfg, params)
        return tquant.quantize_params_int4_incremental(cfg, params, group=32)
    J = _jax()
    jcfg = _jcfg(cfg.arch)
    params = J.jax.tree.map(J.jnp.asarray, tree)
    if quant == "int8":
        return J.jquant.quantize_params_int8_incremental(jcfg, params)
    return J.jquant.quantize_params_int4_incremental(jcfg, params, group=32)


def _jcfg(arch, **over):
    J = _jax()
    cfg = J.JaxConfig.tiny(arch, **KW, **over)
    cfg.vocab_size = _cfg(arch).vocab_size
    return cfg


def _jax_generate(arch, gen, inputs, quant=None, shape=None, stop=False, **over):
    """The JAX package's greedy tokens: its Generator on one device, or its
    ShardedGenerator on a mesh of 4. Greedy tokens do not depend on the
    decode chunk, so the JAX side decodes in one chunk and its result is
    reused across tests."""
    header = int(inputs[1][0]) - 5
    return _jax_tokens(arch, gen["max_new_tokens"], gen["stop_text"], header, quant, shape,
                       stop, tuple(sorted(over.items())))


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch, max_new, stop_text, header, quant, shape, stop, over):
    J = _jax()
    jcfg = _jcfg(arch, **dict(over))
    params = _quantized(_cfg(arch), _tree(arch), quant, torch_side=False)
    gcfg = J.JGenerationConfig(max_new_tokens=max_new, temperature=0.0, stop_text=stop_text,
                               decode_chunk=max_new)
    inputs = _inputs(header)
    bundle = J.JBundle.from_tokenizer(J.JWordTokenizer(128))
    if shape is None:
        g = J.JGenerator(jcfg, params, bundle.audio_patch_id, gcfg, max_cache_len=64)
    else:
        mesh = J.jmesh.make_mesh(shape, devices=J.jax.devices()[:WORLD])
        g = J.jserving.ShardedGenerator(mesh, jcfg, params, bundle.audio_patch_id, gcfg,
                                        max_cache_len=64)
    return g.generate(*inputs, tokenizer=bundle.tokenizer if stop else None)


# ---------------------------------------------------------------------------
# worker functions (run on every rank)
# ---------------------------------------------------------------------------


def _w_generate(shape, arch, tree, gen, inputs, quant, stop):
    cfg = _cfg(arch)
    mesh = tmesh.make_mesh(shape, device="cpu")
    b = _bundle()
    g = ShardedGenerator(mesh, cfg, _quantized(cfg, tree, quant), b.audio_patch_id,
                         GenerationConfig(**gen), max_cache_len=64, device="cpu")
    local = (g.local_cfg.num_heads, g.local_cfg.num_kv_heads)
    return g.generate(*inputs, tokenizer=b.tokenizer if stop else None), local


def _requests(inputs):
    ids, plens, audio, fcnt = inputs
    return [Request(ids[i, :plens[i]].copy(), audio[i, :fcnt[i]].copy())
            for i in range(len(plens))]


def _server(shape, arch, tree, gen, mode, draft_tree):
    cfg = _cfg(arch)
    quant = mode if mode in ("int8", "int4") else None
    params = _quantized(cfg, tree, quant)
    kw = {}
    if mode == "draft":
        kw = dict(draft_cfg=cfg, draft_params=params_from_numpy(draft_tree, cfg, "cpu"),
                  gamma=2, spec_rounds=1)
    elif mode == "int8":
        cfg = dataclasses.replace(cfg, kv_cache_quant=True)
    mesh = tmesh.make_mesh(shape, device="cpu")
    b = _bundle()
    return BatchedServer(cfg, params, b.audio_patch_id, GenerationConfig(**gen), max_batch=2,
                         max_cache_len=64, prompt_buckets=(32,), max_audio_frames=4,
                         tokenizer=b.tokenizer, mesh=mesh, device="cpu", **kw)


def _w_serve(shape, arch, tree, gen, mode, inputs, draft_tree):
    srv = _server(shape, arch, tree, gen, mode, draft_tree)
    return [r.tokens for r in srv.serve(_requests(inputs))]


def _w_serve_paged(shape, arch, tree, gen, inputs, header):
    cfg = _cfg(arch)
    mesh = tmesh.make_mesh(shape, device="cpu")
    b = _bundle()
    srv = BatchedServer(cfg, params_from_numpy(tree, cfg, "cpu"), b.audio_patch_id,
                        GenerationConfig(**gen), max_batch=2, max_cache_len=64,
                        prompt_buckets=(32,), max_audio_frames=4, tokenizer=b.tokenizer,
                        mesh=mesh, device="cpu", shared_prefix_ids=inputs[0][0, :header],
                        kv_block_size=8, prefill_chunk=8)
    return [r.tokens for r in srv.serve(_requests(inputs))]


def _w_online(shape, arch, tree, gen, inputs):
    srv = _server(shape, arch, tree, gen, "plain", None)
    if torch.distributed.get_rank() != 0:
        follow(srv)
        return None
    engine = OnlineEngine(srv).start()
    try:
        reqs = [engine.generate(r, timeout=120) for r in _requests(inputs)]
    finally:
        engine.stop()
    return [r.tokens for r in reqs]


GEN = dict(max_new_tokens=6, temperature=0.0, stop_text="", decode_chunk=3)


# ---------------------------------------------------------------------------
# ShardedGenerator
# ---------------------------------------------------------------------------


def test_kv_cache_spec_matches_jax():
    J = _jax()
    for quant in (False, True):
        cfg = _cfg("llama")
        cfg.kv_cache_quant = quant
        jcfg = _jcfg("llama", kv_cache_quant=quant)
        want = {k: tuple(v) for k, v in J.jserving.kv_cache_spec(jcfg).items()}
        assert {k: tuple(v) for k, v in kv_cache_spec(cfg).items()} == want


@pytest.mark.parametrize("arch,shape", [("llama", (2, 1, 2)), ("llama", (1, 1, 4)),
                                        ("mpt", (1, 1, 4))])
def test_sharded_generator_matches_jax(world, arch, shape):
    inputs = _inputs()
    results = world.run(_w_generate, shape, arch, _tree(arch), GEN, inputs, None, False)
    got = results[0][0]
    assert all(r[0] == got for r in results)
    # each rank holds num_heads / t query and KV heads (mpt: ALiBi slopes
    # sliced to them)
    assert results[0][1][:2] == (4 // shape[2], 4 // shape[2])
    assert got == _jax_generate(arch, GEN, inputs) == _jax_generate(arch, GEN, inputs,
                                                                    shape=shape)


@pytest.mark.parametrize("quant,shape", [("int8", (1, 1, 4)), ("int4", (2, 1, 2))])
def test_sharded_quantized_generator_matches_jax(world, quant, shape):
    # int4 (cols layout, 32-row groups): at tensor=2 each rank holds one
    # whole group of wo's 64 rows
    inputs = _inputs()
    results = world.run(_w_generate, shape, "llama", _tree("llama"), GEN, inputs, quant, False)
    got = results[0][0]
    assert all(r[0] == got for r in results)
    assert got == _jax_generate("llama", GEN, inputs, quant=quant)
    assert got == _jax_generate("llama", GEN, inputs, quant=quant, shape=shape)


def test_sharded_keyword_stopping_matches_jax(world):
    gen = dict(GEN, max_new_tokens=8, stop_text="###", decode_chunk=4)
    inputs = _inputs()
    results = world.run(_w_generate, (2, 1, 2), "llama", _tree("llama"), gen, inputs, None, True)
    got = results[0][0]
    assert all(len(o) <= 8 for o in got)
    assert got == _jax_generate("llama", gen, inputs, stop=True)


# ---------------------------------------------------------------------------
# BatchedServer(mesh=) and the online engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,shape", [
    ("plain", (2, 1, 2)), ("plain", (1, 1, 4)), ("draft", (1, 1, 4)), ("int8", (1, 1, 4)),
    ("int4", (2, 1, 2)),
])
def test_sharded_server_matches_jax(world, mode, shape):
    gen = dict(GEN, decode_chunk=2)
    inputs = _inputs()
    draft = _tree("llama", seed=7) if mode == "draft" else None
    results = world.run(_w_serve, shape, "llama", _tree("llama"), gen, mode, inputs, draft)
    assert all(r == results[0] for r in results)  # every rank served the same tokens
    over = {"kv_cache_quant": True} if mode == "int8" else {}
    quant = mode if mode in ("int8", "int4") else None
    assert results[0] == _jax_generate("llama", gen, inputs, quant=quant, **over)


def test_sharded_server_paged_prefix_matches_jax(world):
    gen = dict(GEN, decode_chunk=2)
    inputs = _inputs(header=9)
    results = world.run(_w_serve_paged, (2, 1, 2), "llama", _tree("llama"), gen, inputs, 9)
    assert all(r == results[0] for r in results)
    assert results[0] == _jax_generate("llama", gen, inputs)


def test_online_engine_on_a_mesh_matches_jax(world):
    # rank 0's engine broadcasts each round's admissions; the other ranks
    # follow the same rounds until the stop
    gen = dict(GEN, decode_chunk=2)
    inputs = _inputs()
    results = world.run(_w_online, (1, 1, 4), "llama", _tree("llama"), gen, inputs)
    assert results[1:] == [None] * (WORLD - 1)
    assert results[0] == _jax_generate("llama", gen, inputs)
