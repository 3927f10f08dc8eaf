"""The port's continuous-batching server against the JAX package, fp32 on
the CPU.

Both packages run the same weights: a seeded init as numpy arrays in the
JAX layout, handed to JAX as they are and to the port through
`params_from_numpy`. Greedy tokens must be EQUAL: both sides compute in
fp32 and differ only in summation order, far below the gaps between the
tiny models' top logits. The oracle is the JAX `Generator` (the JAX suite
holds its server equal to it, tests/test_server.py:50), run once per
configuration in a module fixture. Where the JAX docs allow an int8 cache
to differ by quantization noise between one-shot and chunked admission
(llark_tpu/inference/server.py:1060-1063), or between a speculative verify
window's write and single-token steps', the oracle is one JAX
`BatchedServer` run in that same mode, speculation included. Speculative
modes (n-gram, or a draft with other weights) hold against the same
oracles: at fp32 speculative greedy tokens are plain greedy decode's.

On the CPU the port's kernel wrappers run their plain versions; every mode
still takes the flash-decode route (`use_flash_decode` is on in serving).
"""

import csv
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu import generate as jgen
from llark_tpu import infer as jinfer
from llark_tpu.config import ModelConfig as JaxConfig
from llark_tpu.inference import paged as jpaged
from llark_tpu.inference import server as jserver
from llark_tpu.tokenization import TokenizerBundle as JBundle
from llark_tpu.tokenization import WordTokenizer as JWordTokenizer
from llark_tpu_torch import generate as tgen
from llark_tpu_torch import infer as tinfer
from llark_tpu_torch.config import DataArguments, ModelArguments, ModelConfig, TrainingArguments
from llark_tpu_torch.data.webdataset import TarShardWriter
from llark_tpu_torch.inference import from_encodings
from llark_tpu_torch.inference.paged import BlockAllocator, insert_blocks
from llark_tpu_torch.inference.server import BatchedServer, Request
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models import decoder as tdecoder
from llark_tpu_torch.models.fusion import init_llark_params
from llark_tpu_torch.models.utils import load_pretrained_model
from llark_tpu_torch.tokenization import TokenizerBundle, WordTokenizer
from llark_tpu_torch.train.train import train

MAX_NEW = 6
CONFIGS = {
    "llama_gqa": dict(arch="llama", num_kv_heads=2),
    "mpt": dict(arch="mpt"),
}
SERVER = dict(max_batch=2, max_cache_len=64, prompt_buckets=(16, 32), max_audio_frames=4,
              decode_chunk=2)
# server keyword overrides per mode; "int8" switches the cache to int8
MODES = {
    "dense": {},
    "paged": dict(kv_block_size=8, kv_pool_blocks=2 + 8),
    "dense_int8": dict(int8=True),
    "paged_int8": dict(int8=True, kv_block_size=16, kv_pool_blocks=2 + 4),
    "chunked_dense": dict(prefill_chunk=8),
    "chunked_paged": dict(prefill_chunk=8, kv_block_size=8, kv_pool_blocks=2 + 8),
    "prefix_dense": dict(prefix=True),
    "prefix_paged": dict(prefix=True, prefill_chunk=8, kv_block_size=8, kv_pool_blocks=2 + 8),
    "admit_batch_1": dict(max_batch=3, admit_batch=1, kv_block_size=8, kv_pool_blocks=3 + 12),
    "admit_reorder": dict(admit_reorder=True, prompt_buckets=(20, 32)),
    "drain": dict(decode_chunk=4, decode_chunk_drain=1),
    # the run-of-record mode: paged int8 with direct-to-pool chunks
    "chunked_paged_int8": dict(int8=True, prefill_chunk=8, kv_block_size=8,
                               kv_pool_blocks=2 + 8),
    # speculative serving: host n-gram rounds, or fused draft rounds with
    # a draft of other weights (gamma 3, 2 rounds a pass)
    "spec_ngram": dict(spec_mode="ngram", gamma=3),
    "spec_ngram_paged": dict(spec_mode="ngram", gamma=3, kv_block_size=8,
                             kv_pool_blocks=2 + 10),
    "spec_ngram_paged_int8": dict(int8=True, spec_mode="ngram", gamma=3, prefill_chunk=8,
                                  kv_block_size=8, kv_pool_blocks=2 + 10),
    "spec_draft": dict(draft=True, gamma=3, spec_rounds=2),
    "spec_draft_prefix": dict(draft=True, gamma=3, spec_rounds=2, prefix=True),
    "spec_draft_paged_prefix": dict(draft=True, gamma=3, spec_rounds=2, prefix=True,
                                    prefill_chunk=8, kv_block_size=8, kv_pool_blocks=2 + 14),
    "spec_draft_int8": dict(int8=True, draft=True, gamma=3, spec_rounds=2),
}
# modes whose oracle is a JAX BatchedServer run in the same mode
SERVER_ORACLE = ("chunked_paged_int8", "spec_ngram_paged_int8", "spec_draft_int8")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny tensors: one intra-op thread per core in each of several test
    # processes would make every op wait on the others
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vocab(bundle):
    return int(np.ceil(len(bundle.tokenizer) / 128) * 128)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(jcfg, jparams, tcfg, tparams, bundles, requests) of one config:
    6 requests sharing a 12-token header, ragged suffixes, audio on every
    other one."""
    jb = JBundle.from_tokenizer(JWordTokenizer(128))
    tb = TokenizerBundle.from_tokenizer(WordTokenizer(128))
    over = dict(CONFIGS[name])
    arch = over.pop("arch")
    over.update(dtype="float32", param_dtype="float32", mm_hidden_size=8, vocab_size=_vocab(tb))
    tcfg = ModelConfig.tiny(arch, **over)
    jcfg = JaxConfig.tiny(arch, **over)
    tree = jax.tree.map(lambda t: t.numpy(), init_llark_params(tcfg, seed=0, device="cpu"))
    rng = np.random.RandomState(7)
    header = rng.randint(4, 40, 12).astype(np.int32)
    header[0] = tb.tokenizer.bos_token_id
    reqs = []
    for i, n in enumerate([5, 9, 7, 6, 11, 4]):
        ids = np.concatenate([header, rng.randint(4, 40, n).astype(np.int32)])
        audio = rng.randn(3, 8).astype(np.float32) if i % 2 == 0 else None
        reqs.append((ids, audio))
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tree, tcfg, "cpu"),
            (jb, tb), header, reqs)


@functools.lru_cache(maxsize=None)
def _draft(name):
    """(JAX params, port params) of a draft of the config's shape with
    other weights (seed 9)."""
    tcfg = _setup(name)[2]
    tree = jax.tree.map(lambda t: t.numpy(), init_llark_params(tcfg, seed=9, device="cpu"))
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, tcfg, "cpu")


def _gen_cfg(module, **kw):
    return module.GenerationConfig(max_new_tokens=MAX_NEW, temperature=0.0, stop_text="",
                                   decode_chunk=5, **kw)


@functools.lru_cache(maxsize=None)
def _jax_generator_tokens(name, int8):
    """The JAX Generator's greedy tokens for the 6 requests, one batch."""
    jcfg, jparams, _, _, _, _, reqs = _setup(name)
    jcfg = dataclasses.replace(jcfg, kv_cache_quant=int8)
    ids = np.zeros((len(reqs), 32), np.int32)
    lengths = np.array([len(r) for r, _ in reqs], np.int32)
    audio = np.zeros((len(reqs), 3, 8), np.float32)
    counts = np.zeros((len(reqs),), np.int32)
    for i, (r, a) in enumerate(reqs):
        ids[i, : len(r)] = r
        if a is not None:
            audio[i], counts[i] = a, 3
    gen = jgen.Generator(jcfg, jparams, _patch_id(name), _gen_cfg(jgen), max_cache_len=64)
    return [list(map(int, t)) for t in gen.generate(ids, lengths, audio, counts)]


def _patch_id(name):
    return _setup(name)[4][1].audio_patch_id


def _server_kw(name, mode, jax_side=False):
    kw = dict(SERVER, **MODES[mode])
    int8 = kw.pop("int8", False)
    if kw.pop("prefix", False):
        kw["shared_prefix_ids"] = _setup(name)[5]
    if kw.pop("draft", False):
        cfg = _setup(name)[0 if jax_side else 2]
        kw.update(draft_cfg=cfg, draft_params=_draft(name)[0 if jax_side else 1])
    return int8, kw


@functools.lru_cache(maxsize=None)
def _jax_server_tokens(name, mode):
    jcfg, jparams, _, _, _, _, reqs = _setup(name)
    int8, kw = _server_kw(name, mode, jax_side=True)
    server = jserver.BatchedServer(
        dataclasses.replace(jcfg, kv_cache_quant=int8), jparams, _patch_id(name),
        _gen_cfg(jgen), **kw)
    return [r.tokens for r in server.serve([jserver.Request(i, a) for i, a in reqs])]


def _port_server(name, mode, **extra):
    _, _, tcfg, tparams, _, _, _ = _setup(name)
    int8, kw = _server_kw(name, mode)
    kw.update(extra)
    return BatchedServer(dataclasses.replace(tcfg, kv_cache_quant=int8), tparams,
                         _patch_id(name), _gen_cfg(tgen), device="cpu", **kw)


@pytest.fixture(scope="module", params=list(CONFIGS))
def oracle(request):
    """Per config, the JAX references, computed once: the Generator's
    tokens with a bf16-free fp32 cache and with an int8 cache, and the JAX
    server's tokens in the SERVER_ORACLE modes."""
    name = request.param
    refs = {"fp": _jax_generator_tokens(name, False), "int8": _jax_generator_tokens(name, True)}
    for mode in SERVER_ORACLE:
        refs[mode] = _jax_server_tokens(name, mode)
    return name, refs


@pytest.mark.parametrize("mode", list(MODES))
def test_server_tokens_match_jax(oracle, mode):
    name, refs = oracle
    _, _, _, _, _, _, reqs = _setup(name)
    server = _port_server(name, mode)
    out = server.serve([Request(ids, audio) for ids, audio in reqs])
    got = [r.tokens for r in out]
    if mode in SERVER_ORACLE:
        want = refs[mode]
    else:
        want = refs["int8" if MODES[mode].get("int8") else "fp"]
    assert got == want
    assert all(r.done and len(r.tokens) == MAX_NEW for r in out)
    if server.paged:  # every private block went back to the pool
        shared = len(server._shared_block_ids or [])
        assert server._allocator.free_blocks == server.kv_pool_blocks - server.max_batch - shared
    stats = server.stats(out)
    assert stats["requests"] == 6 and stats["tokens"] == 6 * MAX_NEW


def test_int8_cache_moves_the_logits():
    # the int8 cases test something: quantization moves the logits, though
    # the greedy tokens may still agree with a full-precision cache
    _, _, tcfg, tparams, _, _, reqs = _setup("llama_gqa")
    qcfg = dataclasses.replace(tcfg, kv_cache_quant=True)
    ids = torch.from_numpy(reqs[0][0][None].astype(np.int64))
    lengths = torch.tensor([len(reqs[0][0])], dtype=torch.int32)
    logits = []
    for cfg in (tcfg, qcfg):
        cache = tdecoder.init_kv_cache(cfg, 1, 32)
        tdecoder.decoder_forward(cfg, tparams, input_ids=ids, seq_lengths=lengths,
                                 kv_cache=cache, prefill_from_empty=True)
        step, _ = tdecoder.decoder_forward(
            cfg, tparams, input_ids=torch.tensor([[5]]), kv_cache=cache,
            cache_positions=lengths)
        logits.append(step)
    assert float((logits[0] - logits[1]).abs().max()) > 1e-6


def test_pool_exhaustion_queues_requests():
    # a pool that holds one request's blocks serialises admission by
    # capacity, not slots, and still finishes every request exactly
    name = "llama_gqa"
    want = _jax_generator_tokens(name, False)
    server = _port_server(name, "paged", kv_pool_blocks=2 + 4)
    out = server.serve([Request(ids, audio) for ids, audio in _setup(name)[6]])
    assert [r.tokens for r in out] == want
    assert server._allocator.free_blocks == 4


def test_server_refuses_oversized_prompt():
    server = _port_server("llama_gqa", "dense")
    with pytest.raises(ValueError, match="exceeds capacity"):
        server.serve([Request(np.arange(4, 40, dtype=np.int32))])


def test_stop_text_frees_slot():
    class StopEverything:
        def decode(self, toks):
            return "###"  # every decode looks like a stop

    name = "mpt"
    _, _, tcfg, tparams, _, _, reqs = _setup(name)
    server = BatchedServer(
        tcfg, tparams, _patch_id(name),
        tgen.GenerationConfig(max_new_tokens=8, stop_text="###"), device="cpu",
        tokenizer=StopEverything(), **SERVER)
    out = server.serve([Request(ids, audio) for ids, audio in reqs])
    # each request stops at its first token, trimmed away as the keyword
    assert all(r.done and r.tokens == [] for r in out)


@pytest.mark.parametrize("arg", ["draft", "spec_mode", "mesh"])
def test_speculation_and_mesh_raise(arg):
    # speculation below fp32 is refused without the opt-in, as the JAX
    # package refuses it, and taken with it; mesh serving takes a DeviceMesh
    # (held in tests/test_torch_sharded_serving.py)
    jcfg, jparams, tcfg, tparams, _, _, _ = _setup("llama_gqa")
    if arg == "mesh":
        with pytest.raises(TypeError, match="DeviceMesh"):
            BatchedServer(tcfg, tparams, _patch_id("llama_gqa"), device="cpu", mesh=object())
        return
    tcfg, jcfg = (dataclasses.replace(c, dtype="bfloat16") for c in (tcfg, jcfg))
    kw = {"draft": dict(draft_cfg=tcfg, draft_params=tparams),
          "spec_mode": dict(spec_mode="ngram")}[arg]
    jkw = dict(kw, draft_cfg=jcfg, draft_params=jparams) if arg == "draft" else kw
    with pytest.raises(ValueError, match="allow-divergent-spec"):
        jserver.BatchedServer(jcfg, jparams, _patch_id("llama_gqa"), **jkw)
    with pytest.raises(ValueError, match="allow-divergent-spec"):
        BatchedServer(tcfg, tparams, _patch_id("llama_gqa"), device="cpu", **kw)
    server = BatchedServer(tcfg, tparams, _patch_id("llama_gqa"), device="cpu",
                           allow_divergent_spec=True, **kw)
    assert server._headroom() == (2 * 2 * 5 + 5 if arg == "draft" else 2 * 5)


def test_block_allocator_matches_jax():
    mine, theirs = BlockAllocator(10, 3), jpaged.BlockAllocator(10, 3)
    held = []
    for n in (4, 2, 3, 5, 1, 6):
        got, want = mine.alloc(n), theirs.alloc(n)
        assert got == want
        if got is not None:
            held.append(got)
        if len(held) == 2:  # free the older allocation
            old = held.pop(0)
            mine.free(old)
            theirs.free(list(old))
        assert mine.free_blocks == theirs.free_blocks
    with pytest.raises(ValueError, match="parking"):
        BlockAllocator(2, 2)


def test_block_insert_matches_jax():
    # a dense bucket cache's row copied into pool blocks, int8 leaves and
    # scales included; a 20-position row pads to 3 blocks of 8
    rng = np.random.RandomState(3)
    row = {"k": rng.randint(-127, 128, (2, 3, 2, 20, 16)).astype(np.int8),
           "v": rng.randint(-127, 128, (2, 3, 2, 20, 16)).astype(np.int8),
           "k_scale": rng.rand(2, 3, 2, 20).astype(np.float32),
           "v_scale": rng.rand(2, 3, 2, 20).astype(np.float32)}
    pool = {"k": rng.randint(-127, 128, (2, 9, 2, 8, 16)).astype(np.int8),
            "v": rng.randint(-127, 128, (2, 9, 2, 8, 16)).astype(np.int8),
            "k_scale": rng.rand(2, 9, 2, 8).astype(np.float32),
            "v_scale": rng.rand(2, 9, 2, 8).astype(np.float32)}
    blocks = [7, 2, 5]
    want = jpaged.make_block_insert_fn(8, 3)(
        {k: jnp.asarray(v) for k, v in pool.items()}, {k: jnp.asarray(v) for k, v in row.items()},
        1, jnp.asarray(blocks, jnp.int32))
    got = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    insert_blocks(got, {k: torch.from_numpy(v) for k, v in row.items()}, 1, blocks)
    for key in pool:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_common_prompt_prefix_matches_jax():
    rng = np.random.RandomState(4)
    head = rng.randint(10, 50, 20).astype(np.int32)
    lists = [np.concatenate([head, rng.randint(10, 50, n).astype(np.int32)]) for n in (3, 7, 1)]
    with_audio = [np.concatenate([head[:12], [7, 7], head[12:]]).astype(np.int32)] * 2
    for ids, patch, min_len in ((lists, 7, 8), (lists, 7, 32), (with_audio, 7, 8),
                                ([head, head], 7, 8)):
        got = tinfer._common_prompt_prefix(ids, patch, min_len)
        want = jinfer._common_prompt_prefix(ids, patch, min_len)
        assert (got is None and want is None) or np.array_equal(got, want)


def _rows(mm, n=4):
    rng = np.random.RandomState(5)
    prompts = ["Describe the drums.", "What is the tempo?", None, "What is the key?"]
    return [{"example_id": f"r{i}", "prompt": p, "response": "slow" if i == 1 else "",
             "audio_encoding": rng.randn(3 + i % 2, mm).astype(np.float32)}
            for i, p in zip(range(n), prompts)]


CONTINUOUS = {
    "dense": dict(max_batch=2),
    "paged_prefix": dict(max_batch=3, kv_block_size=16, prefill_chunk=16, prefix_cache=True),
}


@pytest.fixture(scope="module")
def continuous_reference():
    """JAX batch_infer_continuous rows per variant (one server run each)."""
    jcfg, jparams, tcfg, tparams, _, _, _ = _setup("llama_gqa")
    jb = JBundle.from_tokenizer(JWordTokenizer(128))
    kw = dict(max_cache_len=256, prompt_buckets=(64, 128), max_audio_frames=4)
    out = {}
    for variant, extra in CONTINUOUS.items():
        out[variant] = jinfer.batch_infer_continuous(
            _rows(8), jcfg, jparams, jb, gen_cfg=jgen.GenerationConfig(max_new_tokens=5),
            **kw, **extra)
    return kw, out


@pytest.mark.parametrize("variant", list(CONTINUOUS))
def test_batch_infer_continuous_rows_match_jax(continuous_reference, variant):
    kw, want = continuous_reference
    _, _, tcfg, tparams, _, _, _ = _setup("llama_gqa")
    tb = TokenizerBundle.from_tokenizer(WordTokenizer(128))
    got = tinfer.batch_infer_continuous(
        _rows(8), tcfg, tparams, tb, gen_cfg=tgen.GenerationConfig(max_new_tokens=5),
        device="cpu", **kw, **CONTINUOUS[variant])
    assert got == want[variant]
    assert {r["prompt"] for r in got} >= {"Describe the audio.", "What is the tempo?"}


def _write_encodings(directory, mm):
    os.makedirs(directory)
    for row in _rows(mm):
        np.save(os.path.join(directory, f"{row['example_id']}.npy"), row["audio_encoding"])


def test_from_encodings_cli_reads_a_trained_checkpoint(tmp_path):
    # a run directory written by the port's train(), read back by the CLI
    # on the CPU; its CSV rows are batch_infer_continuous's on the loaded
    # model
    writer = TarShardWriter(str(tmp_path / "mir-train-%05d.tar"), max_count=10)
    rng = np.random.RandomState(6)
    for i in range(3):
        writer.write({"__key__": f"t{i}", "json": {"response": [
            {"question": "what genre ?", "answer": "ambient jazz ."}]},
            "audio_encoding.pyd": rng.randn(4, 16).astype(np.float32)})
    writer.close()
    run = tmp_path / "run"
    train(ModelArguments(model_name_or_path="tiny", mm_hidden_size=16),
          DataArguments(train_data_path=writer.written_paths[0], max_audio_frames=4,
                        task_sample_probs={"mir": 1.0}),
          TrainingArguments(output_dir=str(run), per_device_train_batch_size=2,
                            model_max_length=64, max_steps=1, save_steps=1, seed=0),
          model_cfg=ModelConfig.tiny(mm_hidden_size=16, dtype="float32"), device="cpu")
    _write_encodings(str(tmp_path / "enc"), 16)
    out_csv = tmp_path / "out.csv"
    from_encodings.main([
        "--checkpoint-dir", str(run), "--encodings-dir", str(tmp_path / "enc"),
        "--output", str(out_csv), "--prompt", "Describe the audio.", "--max-new-tokens", "4",
        "--max-cache-len", "256", "--continuous-batching", "2", "--kv-block-size", "16",
        "--kv-cache-int8", "--prefill-chunk", "64", "--device", "cpu",
    ])
    with open(out_csv) as f:
        got = list(csv.DictReader(f))
    cfg, params, bundle = load_pretrained_model(str(run), device="cpu")
    assert params["embed"].device.type == "cpu"
    rows = [dict(r, prompt="Describe the audio.") for r in _rows(16)]
    want = tinfer.batch_infer_continuous(
        rows, dataclasses.replace(cfg, kv_cache_quant=True), params, bundle,
        gen_cfg=tgen.GenerationConfig(max_new_tokens=4), max_batch=2, max_cache_len=256,
        kv_block_size=16, prefill_chunk=64, device="cpu")
    assert len(got) == 4
    assert [r["model_completion"] for r in got] == [r["model_completion"] for r in want]
    assert [r["example_id"] for r in got] == [r["example_id"] for r in want]
    # an HF directory is refused with a pointer to its import through train()
    with pytest.raises(NotImplementedError, match="through train"):
        load_pretrained_model(str(tmp_path / "enc"), device="cpu")
