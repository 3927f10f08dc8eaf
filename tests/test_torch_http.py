"""The port's online engine and HTTP front end
(`llark_tpu_torch.inference.http_server`) on the CPU, held against the
JAX package.

Requests reach the engine from several threads, directly or over HTTP on
the loopback interface; every answer's tokens must EQUAL the JAX
`Generator`'s greedy tokens for the same prompt ids and audio, computed
once in a module fixture on the same numpy weights (fp32 on both sides).
Speculative engines (n-gram, and a draft with other weights) must give
the same tokens.
"""

import base64
import concurrent.futures
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu import generate as jgen
from llark_tpu.config import ModelConfig as JaxConfig
from llark_tpu_torch import generate as tgen
from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.infer import build_prompt_ids
from llark_tpu_torch.inference.http_server import OnlineEngine, serve_http
from llark_tpu_torch.inference.server import BatchedServer, Request
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models.fusion import init_llark_params
from llark_tpu_torch.tokenization import TokenizerBundle, WordTokenizer

MM = 8
MAX_NEW = 6
PROMPTS = ["describe this sound .", "what genre is it ?", "explain ."] + [
    f"describe sound number {i} ." for i in range(8)]
SERVER = dict(max_batch=2, max_cache_len=128, prompt_buckets=(64,), max_audio_frames=4,
              decode_chunk=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stack():
    """(cfg, params, bundle, requests, want): the tiny fp32 model, the
    prompts' ids and [3, MM] encodings, and the JAX Generator's greedy
    tokens for each."""
    bundle = TokenizerBundle.from_tokenizer(WordTokenizer(128))
    rng = np.random.RandomState(0)
    audio = [rng.randn(3, MM).astype(np.float32) for _ in PROMPTS]
    ids = [np.asarray(build_prompt_ids(p, 3, bundle), np.int32) for p in PROMPTS]
    over = dict(dtype="float32", param_dtype="float32", mm_hidden_size=MM, num_kv_heads=2)
    cfg, jcfg = ModelConfig.tiny(**over), JaxConfig.tiny(**over)
    tree = jax.tree.map(lambda t: t.numpy(), init_llark_params(cfg, seed=0, device="cpu"))
    batch = np.zeros((len(ids), 64), np.int32)
    for i, row in enumerate(ids):
        batch[i, : len(row)] = row
    gen = jgen.Generator(jcfg, jax.tree.map(jnp.asarray, tree), bundle.audio_patch_id,
                         jgen.GenerationConfig(max_new_tokens=MAX_NEW, stop_text="",
                                               decode_chunk=MAX_NEW - 1), max_cache_len=128)
    want = gen.generate(batch, np.array([len(r) for r in ids], np.int32), np.stack(audio),
                        np.full((len(ids),), 3, np.int32))
    params = params_from_numpy(tree, cfg, "cpu")
    draft = params_from_numpy(
        jax.tree.map(lambda t: t.numpy(), init_llark_params(cfg, seed=9, device="cpu")), cfg, "cpu")
    return cfg, params, draft, bundle, list(zip(ids, audio)), [list(map(int, w)) for w in want]


def _server(stack, **kw):
    cfg, params, _, bundle, _, _ = stack
    return BatchedServer(cfg, params, bundle.audio_patch_id,
                         tgen.GenerationConfig(max_new_tokens=MAX_NEW, stop_text=""),
                         tokenizer=bundle.tokenizer, device="cpu", **dict(SERVER, **kw))


def _post(port, payload, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def _npy_b64(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture
def http(stack):
    """A listener on the loopback interface over a fresh engine; stopped,
    its engine thread joined, after the test."""
    httpd, engine = serve_http(_server(stack), stack[3], host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd.server_address[1], engine
    httpd.shutdown()
    httpd.server_close()
    engine.stop()
    t.join(timeout=30)
    assert not engine._thread.is_alive()


def test_online_engine_answers_from_threads_match_jax(stack):
    *_, reqs, want = stack
    engine = OnlineEngine(_server(stack)).start()
    try:
        got = [None] * 3

        def work(i):
            got[i] = engine.generate(Request(*reqs[i]), timeout=120)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [r.tokens for r in got] == want[:3]
        assert all(r.error is None and r.first_token_at >= r.submitted_at for r in got)
    finally:
        engine.stop()
    assert engine.server.driver is None and not engine._thread.is_alive()


def test_http_round_trip(stack, http):
    port, _ = http
    _, _, _, bundle, reqs, want = stack
    assert _get(port, "/health") == {"status": "ok", "slots_free": 2, "queued": 0}
    # a JSON list and a base64 .npy encoding of the same frames
    for enc in (reqs[0][1].tolist(), _npy_b64(reqs[0][1])):
        code, out = _post(port, {"prompt": PROMPTS[0], "audio_encoding": enc})
        assert code == 200 and out["tokens"] == want[0]
        assert out["completion"] == bundle.tokenizer.decode(want[0])
        assert 0 <= out["ttft_s"] <= out["latency_s"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, {"prompt": "word " * 200})
    assert e.value.code == 413
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nothing")
    assert e.value.code == 404


def test_http_concurrent_requests(stack, http):
    port, _ = http
    *_, reqs, want = stack

    def one(i):
        return _post(port, {"prompt": PROMPTS[i], "audio_encoding": _npy_b64(reqs[i][1])})

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        got = list(ex.map(one, range(len(PROMPTS))))
    assert [code for code, _ in got] == [200] * len(PROMPTS)
    assert [out["tokens"] for _, out in got] == want
    assert _get(port, "/health") == {"status": "ok", "slots_free": 2, "queued": 0}


def test_engine_survives_a_malformed_request(stack, http):
    port, engine = http
    *_, reqs, want = stack
    # the wrong encoding width: 400 at the HTTP layer, the engine untouched
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, {"prompt": PROMPTS[1], "audio_encoding": np.ones((3, MM + 2)).tolist()})
    assert e.value.code == 400
    # a bad request past the HTTP checks (1-D encoding): the engine fails
    # it with an error and keeps serving
    failed = engine.generate(Request(np.asarray([5, 6], np.int32),
                                     np.ones((3,), np.float32)), timeout=60)
    assert failed.error is not None
    code, out = _post(port, {"prompt": PROMPTS[1], "audio_encoding": reqs[1][1].tolist()})
    assert code == 200 and out["tokens"] == want[1]


def test_engine_failure_returns_the_paged_blocks(stack):
    server = _server(stack, kv_block_size=8)
    baseline = server._allocator.free_blocks
    *_, reqs, want = stack
    real_decode = server._decode_round
    armed = [True]

    def exploding_decode():
        if armed[0] and server._active():
            armed[0] = False
            raise RuntimeError("injected decode failure")
        return real_decode()

    server._decode_round = exploding_decode
    engine = OnlineEngine(server).start()
    try:
        failed = engine.generate(Request(*reqs[2]), timeout=120)
        assert failed.error is not None and "injected" in failed.error
        assert server._allocator.free_blocks == baseline
        assert all(not b for b in server._slot_blocks)
        ok = engine.generate(Request(*reqs[2]), timeout=120)
        assert ok.error is None and ok.tokens == want[2]
    finally:
        engine.stop()


@pytest.mark.parametrize("spec", ["ngram", "draft"])
def test_speculative_engine_matches_jax(stack, spec):
    cfg, _, draft, _, reqs, want = stack
    kw = (dict(spec_mode="ngram", gamma=3) if spec == "ngram"
          else dict(draft_cfg=cfg, draft_params=draft, gamma=3, spec_rounds=2))
    engine = OnlineEngine(_server(stack, kv_block_size=8, **kw)).start()
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            got = list(ex.map(lambda r: engine.generate(Request(*r), timeout=120), reqs[:5]))
    finally:
        engine.stop()
    assert [r.tokens for r in got] == want[:5]
    assert all(r.error is None for r in got)
