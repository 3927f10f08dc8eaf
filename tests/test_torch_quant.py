"""The port's weight-only quantization (int8, int4 rows and cols) against
the JAX package, fp32 on the CPU.

The same numpy arrays go through the JAX function and its counterpart in
the port. Integer payloads must be EQUAL (both round half to even from the
same fp32 quotient); scales, dequantized weights, products and logits agree
to fp32 rounding (1e-6 to 1e-5 relative: only summation order differs).
Greedy tokens through `Generator` and `BatchedServer` must be EQUAL to the
JAX `Generator`'s on the same quantized tree. With an int8 KV cache the JAX
docs allow chunked admission to differ from one-shot prefill by quantization
noise (llark_tpu/inference/server.py:1060-1063), so that one mode is held to
the JAX `BatchedServer` run in the same mode.

The TPU kernels run in Pallas interpret mode. The int8 one computes in the
inputs' dtype (1e-4, as tests/test_int8_matmul.py); the int4 one always
rounds nibble x scale to bf16 before the product, so it is held within 5e-3
relative to max (as tests/test_quant.py). On the CPU the port's kernel
wrappers run their plain versions. Every JAX result is computed once, in a
module fixture.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu import generate as jgen
from llark_tpu.config import ModelConfig as JaxConfig
from llark_tpu.inference import server as jserver
from llark_tpu.models import fusion as jfusion
from llark_tpu.models import quant as jquant
from llark_tpu.ops import int4_matmul as jint4
from llark_tpu.ops import int8_matmul as jint8
from llark_tpu_torch import generate as tgen
from llark_tpu_torch.config import (
    DataArguments,
    ModelArguments,
    ModelConfig,
    TrainingArguments,
)
from llark_tpu_torch.inference.server import BatchedServer, Request
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models import fusion as tfusion
from llark_tpu_torch.models import quant as tquant
from llark_tpu_torch.models.utils import load_pretrained_model, save_model_metadata
from llark_tpu_torch.ops import int4_matmul as tint4
from llark_tpu_torch.ops import int8_matmul as tint8
from llark_tpu_torch.tokenization import TokenizerBundle, WordTokenizer
from llark_tpu_torch.train.checkpoint import CheckpointManager
from llark_tpu_torch.train.state import TrainState
from llark_tpu_torch.train.train import train

GROUP = 32  # int4 scale group of the tiny models (hidden 64, intermediate 128)
FORMATS = ("int8", "int4_rows", "int4_cols")
PAYLOAD = {"int8": "q", "int4_rows": "q4", "int4_cols": "q4c"}
MAX_NEW = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny tensors: one intra-op thread per core in each of several test
    # processes would make every op wait on the others
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(tree):
    """numpy / JAX leaves -> torch tensors (a quantized leaf stays a dict)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


JAX_QUANTIZE = {
    "int8": jquant.quantize_weight,
    "int4_rows": lambda w: jquant.quantize_weight_int4(w, GROUP),
    "int4_cols": lambda w: jquant.quantize_weight_int4_cols(w, GROUP),
}
JAX_DEQUANTIZE = {
    "int8": jquant.dequantize_weight,
    "int4_rows": jquant.dequantize_weight_int4,
    "int4_cols": jquant.dequantize_weight_int4_cols,
}
PORT_QUANTIZE = {
    "int8": tquant.quantize_weight,
    "int4_rows": lambda w: tquant.quantize_weight_int4(w, GROUP),
    "int4_cols": lambda w: tquant.quantize_weight_int4_cols(w, GROUP),
}
PORT_DEQUANTIZE = {
    "int8": tquant.dequantize_weight,
    "int4_rows": tquant.dequantize_weight_int4,
    "int4_cols": tquant.dequantize_weight_int4_cols,
}


def _weight(stacked):
    rng = np.random.RandomState(3)
    shape = (3, 128, 48) if stacked else (128, 48)
    w = (rng.randn(*shape) * 0.05).astype(np.float32)
    w[..., 5] = 0.0  # an all-zero channel: the scale floor
    w[..., 0, 7] = 0.5  # exact halves after scaling meet the tie rule
    return w


@pytest.fixture(scope="module")
def jax_weights():
    """{(format, stacked): (quantized, dequantized)} from the JAX package."""
    out = {}
    for fmt in FORMATS:
        for stacked in (False, True):
            wq = JAX_QUANTIZE[fmt](jnp.asarray(_weight(stacked)))
            out[fmt, stacked] = _np(wq), np.asarray(JAX_DEQUANTIZE[fmt](wq))
    return out


@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_weight_matches_jax(jax_weights, fmt, stacked):
    want, want_deq = jax_weights[fmt, stacked]
    got = PORT_QUANTIZE[fmt](torch.from_numpy(_weight(stacked)))
    key = PAYLOAD[fmt]
    assert set(got) == set(want)
    assert got[key].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got[key].numpy(), want[key])
    np.testing.assert_allclose(got["scale"].numpy(), want["scale"], rtol=1e-6, atol=0)
    deq = PORT_DEQUANTIZE[fmt](got)
    np.testing.assert_allclose(deq.numpy(), want_deq, rtol=1e-6, atol=1e-9)
    # and the port dequantizes JAX's tree to the same values
    np.testing.assert_allclose(PORT_DEQUANTIZE[fmt](_t(want)).numpy(), want_deq, rtol=1e-6,
                               atol=1e-9)


def test_rows_and_cols_dequantize_alike():
    w = torch.from_numpy(_weight(False))
    a = tquant.dequantize_weight_int4(tquant.quantize_weight_int4(w, GROUP))
    b = tquant.dequantize_weight_int4_cols(tquant.quantize_weight_int4_cols(w, GROUP))
    assert torch.equal(a, b)
    assert torch.equal(tquant._unpack_int4(tquant.quantize_weight_int4(w, GROUP)["q4"]),
                       tquant._unpack_int4_cols(tquant.quantize_weight_int4_cols(w, GROUP)["q4c"]))
    with pytest.raises(ValueError, match="must divide group"):
        tquant.quantize_weight_int4(w, 48)
    with pytest.raises(ValueError, match="fan_out even"):
        tquant.quantize_weight_int4_cols(w[:, :47], GROUP)


# ---------------------------------------------------------------------------
# the two products: plain versions against the TPU kernels (interpret mode)
# ---------------------------------------------------------------------------

INT8_SHAPES = [(16, 256, 128), (32, 128, 384)]
INT4_SHAPES = [(8, 256, 1024, 128), (1, 512, 1536, 128), (8, 512, 1024, 256)]


def _xw(seed, m, k, n, std):
    rng = np.random.RandomState(seed)
    return rng.randn(m, k).astype(np.float32), (rng.randn(k, n) * std).astype(np.float32)


@pytest.fixture(scope="module")
def jax_products():
    out = {}
    for m, k, n in INT8_SHAPES:
        x, w = _xw(0, m, k, n, 0.05)
        wq = jquant.quantize_weight(jnp.asarray(w))
        out["int8", m, k, n] = (
            _np(wq),
            np.asarray(jint8.int8_matmul(jnp.asarray(x), wq["q"], wq["scale"], interpret=True)),
            np.asarray(jquant.quantized_dense(jnp.asarray(x)[None], wq, None, jnp.float32)[0]),
        )
    for m, h, d, g in INT4_SHAPES:
        x, w = _xw(1, m, h, d, 0.1)
        wq = jquant.quantize_weight_int4(jnp.asarray(w), group=g)
        out["int4", m, h, d, g] = (
            _np(wq),
            np.asarray(jint4.int4_matmul(jnp.asarray(x), wq["q4"], wq["scale"], group=g,
                                         interpret=True)),
            np.asarray(jnp.asarray(x) @ jquant.dequantize_weight_int4(wq)),
        )
    return out


@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_matmul_matches_pallas_and_dense(jax_products, m, k, n):
    wq, pallas, dense = jax_products["int8", m, k, n]
    x, _ = _xw(0, m, k, n, 0.05)
    wq = _t(wq)
    assert tint8.int8_kernel_takes(wq["q"])
    got = tint8.int8_matmul(torch.from_numpy(x), wq["q"], wq["scale"])
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), dense, atol=1e-4, rtol=1e-4)
    # a [N] scale is taken like the tree's [1, N]
    again = tint8.int8_matmul(torch.from_numpy(x), wq["q"], wq["scale"].reshape(-1))
    assert torch.equal(got, again)


@pytest.mark.parametrize("which", ["rows", "scale"])
def test_int8_matmul_rejects_bad_shapes(which):
    x = torch.zeros(8, 128)
    if which == "rows":
        with pytest.raises(ValueError, match="weight rows"):
            tint8.int8_matmul(x, torch.zeros(256, 128, dtype=torch.int8), torch.ones(128))
    else:
        with pytest.raises(ValueError, match="scale size"):
            tint8.int8_matmul(x, torch.zeros(128, 128, dtype=torch.int8), torch.ones(64))


@pytest.mark.parametrize("m,h,d,g", INT4_SHAPES)
def test_int4_matmul_matches_pallas(jax_products, m, h, d, g):
    wq, pallas, dense = jax_products["int4", m, h, d, g]
    x, _ = _xw(1, m, h, d, 0.1)
    wq = _t(wq)
    assert tint4.int4_kernel_takes(wq["q4"], wq["scale"])
    got = tint4.int4_matmul(torch.from_numpy(x), wq["q4"], wq["scale"], group=g)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, d)
    assert _rel(got.numpy(), dense) < 1e-5  # dequantize + product, fp32
    assert _rel(got.numpy(), pallas) < 5e-3  # the TPU kernel computes in bf16
    with pytest.raises(ValueError, match="packed rows"):
        tint4.int4_matmul(torch.from_numpy(x)[:, :-2], wq["q4"], wq["scale"], group=g)
    with pytest.raises(ValueError, match="scale shape"):
        tint4.int4_matmul(torch.from_numpy(x), wq["q4"], wq["scale"][:-1], group=g)
    # a group that disagrees with the scale's rows, though h // group matches
    with pytest.raises(ValueError, match="does not divide"):
        tint4.int4_matmul(torch.from_numpy(x), wq["q4"], wq["scale"], group=g - g // 4)


@pytest.mark.parametrize("fmt", ["int8", "int4_rows"])
def test_plain_products_in_bf16(fmt):
    # bf16 activations against the fp32 product of the dequantized weight:
    # the rounding of x, of nibble x scale (int4) and of the output
    x, w = _xw(2, 8, 256, 128, 0.05)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    if fmt == "int8":
        wq = tquant.quantize_weight(torch.from_numpy(w))
        got = tint8.int8_matmul(xb, wq["q"], wq["scale"])
        want = xb.float() @ tquant.dequantize_weight(wq)
    else:
        wq = tquant.quantize_weight_int4(torch.from_numpy(w), 128)
        got = tint4.int4_matmul(xb, wq["q4"], wq["scale"], group=128)
        want = xb.float() @ tquant.dequantize_weight_int4(wq)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want.numpy()) < 2e-2


# ---------------------------------------------------------------------------
# the dispatchers
# ---------------------------------------------------------------------------

# (fan_in, fan_out, int4 group, bias): the first two lie inside the kernels'
# contracts (on the CPU: the wrappers' plain versions), the last one outside
# (fan_in % 16 != 0: the plain expression of the JAX package)
DENSE_CASES = {"plain": (64, 48, 32, False), "bias": (128, 64, 32, True), "odd": (40, 30, 8, True)}


@pytest.fixture(scope="module")
def jax_dense():
    out = {}
    for case, (k, n, g, bias) in DENSE_CASES.items():
        rng = np.random.RandomState(5)
        x = rng.randn(2, 3, k).astype(np.float32)
        w = (rng.randn(k, n) * 0.05).astype(np.float32)
        b = rng.randn(n).astype(np.float32) if bias else None
        jb = None if b is None else jnp.asarray(b)
        trees = {
            "int8": jquant.quantize_weight(jnp.asarray(w)),
            "int4_rows": jquant.quantize_weight_int4(jnp.asarray(w), g),
            "int4_cols": jquant.quantize_weight_int4_cols(jnp.asarray(w), g),
        }
        for fmt, wq in trees.items():
            fn = jquant.quantized_dense if fmt == "int8" else jquant.quantized_dense_int4
            out[fmt, case] = (x, b, _np(wq), np.asarray(fn(jnp.asarray(x), wq, jb, jnp.float32)))
    return out


@pytest.mark.parametrize("case", list(DENSE_CASES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantized_dense_matches_jax(jax_dense, fmt, case):
    x, b, wq, want = jax_dense[fmt, case]
    wq = _t(wq)
    fn = tquant.quantized_dense if fmt == "int8" else tquant.quantized_dense_int4
    tb = None if b is None else torch.from_numpy(b)
    before = tint8.int8_matmul.launches, tint4.int4_matmul.launches
    got = fn(torch.from_numpy(x), wq, tb, torch.float32)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-5
    # nothing on the CPU counts as a kernel launch
    assert (tint8.int8_matmul.launches, tint4.int4_matmul.launches) == before
    inside = case != "odd"
    if fmt == "int8":
        assert tint8.int8_kernel_takes(wq["q"]) == inside
    elif fmt == "int4_rows":
        assert tint4.int4_kernel_takes(wq["q4"], wq["scale"]) == inside


@pytest.mark.parametrize("case", [
    "stacked", "k_tail", "n_tail", "fp32_on_card", "bf16_on_card", "group_tail"])
def test_kernel_contracts(case):
    # the predicates decide by shape alone
    q = torch.zeros(64, 48, dtype=torch.int8)
    q4, s4 = torch.zeros(32, 48, dtype=torch.int8), torch.zeros(2, 48)
    if case == "stacked":
        assert not tint8.int8_kernel_takes(q[None])
        assert not tint4.int4_kernel_takes(q4[None], s4[None])
    elif case == "k_tail":
        assert not tint8.int8_kernel_takes(q[:40])
        assert not tint4.int4_kernel_takes(q4[:20], s4)
    elif case == "n_tail":
        assert not tint8.int8_kernel_takes(q[:, :44])
        assert not tint4.int4_kernel_takes(q4[:, :44], s4[:, :44])
    elif case == "fp32_on_card":
        # a leaf inside the contract with an fp32 compute dtype off the CPU:
        # the dispatchers go to the wrappers (which launch the kernels on
        # fp32 activations on the card), never to the plain expression; meta
        # tensors stand for the card's, and the wrappers refuse them as
        # non-CUDA tensors before any launch
        assert tint8.int8_kernel_takes(q) and tint4.int4_kernel_takes(q4, s4)
        x = torch.zeros(2, 3, 64, device="meta")
        w8 = {"q": q.to("meta"), "scale": torch.zeros(1, 48, device="meta")}
        w4 = {"q4": q4.to("meta"), "scale": s4.to("meta")}
        before = tint8.int8_matmul.launches, tint4.int4_matmul.launches
        with pytest.raises(ValueError, match="CUDA tensors"):
            tquant.quantized_dense(x, w8, None, torch.float32)
        with pytest.raises(ValueError, match="CUDA tensors"):
            tquant.quantized_dense_int4(x, w4, None, torch.float32)
        assert (tint8.int8_matmul.launches, tint4.int4_matmul.launches) == before
    elif case == "bf16_on_card":
        assert tint8.int8_kernel_takes(q)
        assert tint4.int4_kernel_takes(q4, s4)
        # the seven Llama-2-7B projections
        for k, n in ((4096, 4096), (4096, 11008), (11008, 4096)):
            assert tint8.int8_kernel_takes(torch.empty(k, n, dtype=torch.int8, device="meta"))
            assert tint4.int4_kernel_takes(
                torch.empty(k // 2, n, dtype=torch.int8, device="meta"),
                torch.empty(k // 128, n, device="meta"))
    else:  # a scale group that is no multiple of the 16-row tensor-core step
        assert not tint4.int4_kernel_takes(q4, torch.zeros(8, 48))


@pytest.mark.parametrize("fmt", ["int8", "int4_rows"])
def test_wrappers_refuse_gradient(fmt):
    # the wrappers once refused autograd; they now carry dx through their
    # operators (QLoRA): dx equals autograd through the plain expression,
    # the frozen payloads get none, and without a recorded gradient the
    # wrapper runs its product directly
    x = torch.from_numpy(np.random.RandomState(4).randn(4, 64).astype(np.float32))
    w = torch.from_numpy(_weight(False)[:64])
    if fmt == "int8":
        wq = tquant.quantize_weight(w)
        call = lambda x: tint8.int8_matmul(x, wq["q"], wq["scale"])  # noqa: E731
        plain = lambda x: tint8._int8_matmul_plain(x, wq["q"], wq["scale"])  # noqa: E731
    else:
        wq = tquant.quantize_weight_int4(w, GROUP)
        call = lambda x: tint4.int4_matmul(x, wq["q4"], wq["scale"], group=GROUP)  # noqa: E731
        plain = lambda x: tint4._int4_matmul_plain(x, wq["q4"], wq["scale"])  # noqa: E731
    g = torch.from_numpy(np.random.RandomState(5).randn(4, 48).astype(np.float32))
    (got,) = torch.autograd.grad(call(x.requires_grad_()), [x], g)
    (want,) = torch.autograd.grad(plain(x), [x], g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5 * want.abs().max().item())
    assert not any(t.requires_grad for t in wq.values())
    with torch.no_grad():
        assert tuple(call(x).shape) == (4, 48)
    assert tuple(call(x.detach()).shape) == (4, 48)


@pytest.mark.parametrize("fault", ["x_dtype", "weight_dtype", "weight_strided", "scale_dtype"])
def test_cuda_operand_checks_raise(fault):
    # what the launch path asks of its operands, checked before any launch
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    q, scale = torch.zeros(64, 48, dtype=torch.int8), torch.ones(48)
    if fault == "x_dtype":
        x = x.float()
    elif fault == "weight_dtype":
        q = q.to(torch.int16)
    elif fault == "weight_strided":
        q = torch.zeros(64, 96, dtype=torch.int8)[:, ::2]
    else:
        scale = scale.double()
    with pytest.raises(ValueError, match="the CUDA kernel takes"):
        tint8._check_operands("int8_matmul", x, q, scale)


# ---------------------------------------------------------------------------
# whole trees and the slice as a whole
# ---------------------------------------------------------------------------

CONFIGS = {"llama_gqa": dict(arch="llama", num_kv_heads=2), "mpt": dict(arch="mpt")}
TREES = ("int8", "int8_incremental", "int4_rows", "int4_cols")


def _jax_quantize_tree(kind, jcfg, jparams):
    if kind == "int8":
        return jquant.quantize_params_int8(jcfg, jparams)
    jparams = dict(jparams, layers=dict(jparams["layers"]))  # the call takes ownership
    if kind == "int8_incremental":
        return jquant.quantize_params_int8_incremental(jcfg, jparams)
    layout = "rows" if kind == "int4_rows" else "cols"
    return jquant.quantize_params_int4_incremental(jcfg, jparams, group=GROUP, layout=layout)


def _port_quantize_tree(kind, tcfg, tparams):
    if kind == "int8":
        return tquant.quantize_params_int8(tcfg, tparams)
    tparams = dict(tparams, layers=dict(tparams["layers"]))
    if kind == "int8_incremental":
        return tquant.quantize_params_int8_incremental(tcfg, tparams)
    layout = "rows" if kind == "int4_rows" else "cols"
    return tquant.quantize_params_int4_incremental(tcfg, tparams, group=GROUP, layout=layout)


@functools.lru_cache(maxsize=None)
def _setup(name, vocab=None):
    """(jcfg, tcfg, fp32 numpy tree, bundle) of one tiny config."""
    tb = TokenizerBundle.from_tokenizer(WordTokenizer(128))
    over = dict(CONFIGS[name])
    arch = over.pop("arch")
    over.update(dtype="float32", param_dtype="float32", mm_hidden_size=8,
                vocab_size=vocab or int(np.ceil(len(tb.tokenizer) / 128) * 128))
    tcfg = ModelConfig.tiny(arch, **over)
    jcfg = JaxConfig.tiny(arch, **over)
    tree = jax.tree.map(lambda t: t.numpy(), tfusion.init_llark_params(tcfg, seed=0, device="cpu"))
    return jcfg, tcfg, tree, tb


@functools.lru_cache(maxsize=None)
def _jax_tree(name, kind, vocab=None):
    """The JAX package's quantized tree of one config, as numpy arrays."""
    jcfg, _, tree, _ = _setup(name, vocab)
    return _np(_jax_quantize_tree(kind, jcfg, jax.tree.map(jnp.asarray, tree)))


def _requests(name):
    """4 requests sharing a header, ragged suffixes, audio on every other."""
    tb = _setup(name)[3]
    rng = np.random.RandomState(7)
    header = rng.randint(4, 40, 12).astype(np.int32)
    header[0] = tb.tokenizer.bos_token_id
    reqs = []
    for i, n in enumerate([5, 9, 7, 4]):
        ids = np.concatenate([header, rng.randint(4, 40, n).astype(np.int32)])
        reqs.append((ids, rng.randn(3, 8).astype(np.float32) if i % 2 == 0 else None))
    return reqs


def _batch(name):
    reqs = _requests(name)
    ids = np.zeros((len(reqs), 32), np.int32)
    lengths = np.array([len(r) for r, _ in reqs], np.int32)
    audio = np.zeros((len(reqs), 3, 8), np.float32)
    counts = np.zeros((len(reqs),), np.int32)
    for i, (r, a) in enumerate(reqs):
        ids[i, : len(r)] = r
        if a is not None:
            audio[i], counts[i] = a, 3
    return ids, lengths, audio, counts


def _gen_cfg(module):
    return module.GenerationConfig(max_new_tokens=MAX_NEW, temperature=0.0, stop_text="",
                                   decode_chunk=5)


# (config, tree kind) of the whole-slice cases: every format on the Llama
# config, int8 and the default int4 layout on the tied-head MPT config
SLICE_CASES = [("llama_gqa", "int8"), ("llama_gqa", "int4_rows"), ("llama_gqa", "int4_cols"),
               ("mpt", "int8"), ("mpt", "int4_cols")]


SERVER = dict(max_batch=2, max_cache_len=64, prompt_buckets=(16, 32), max_audio_frames=4,
              decode_chunk=2)
# (tree kind, int8 KV cache, server keywords): int8 weights in the JAX
# package's serving run of record (paged int8 KV, chunked admission) and with
# a dense cache admitted in one shot; both int4 layouts with a dense cache
SERVER_CASES = {
    "int8_chunked_paged_int8kv": ("int8", True, dict(prefill_chunk=8, kv_block_size=8,
                                                      kv_pool_blocks=2 + 8)),
    "int8_dense": ("int8", False, {}),
    "int4_rows_dense": ("int4_rows", False, {}),
    "int4_cols_paged": ("int4_cols", False, dict(kv_block_size=8, kv_pool_blocks=2 + 8)),
}
# the case whose oracle is a JAX BatchedServer run in the same mode
JAX_SERVER_ORACLE = "int8_chunked_paged_int8kv"


@pytest.fixture(scope="module")
def jax_slice():
    """Per (config, kind): the JAX package's logits of one forward and its
    Generator's greedy tokens (bf16-free fp32 cache, and an int8 KV cache
    for the int8-weight trees), on its own quantized tree."""
    out = {}
    for name, kind in SLICE_CASES:
        jcfg, _, _, tb = _setup(name)
        jparams = jax.tree.map(jnp.asarray, _jax_tree(name, kind))
        ids, lengths, audio, counts = _batch(name)
        logits, _ = jfusion.llark_forward(
            jcfg, jparams, jnp.asarray(ids), audio_encodings=jnp.asarray(audio),
            audio_patch_id=tb.audio_patch_id, audio_frame_counts=jnp.asarray(counts),
            seq_lengths=jnp.asarray(lengths))
        refs = {"logits": np.asarray(logits)}
        for int8_kv in ((False, True) if kind == "int8" else (False,)):
            gen = jgen.Generator(dataclasses.replace(jcfg, kv_cache_quant=int8_kv), jparams,
                                 tb.audio_patch_id, _gen_cfg(jgen), max_cache_len=64)
            refs["tokens", int8_kv] = [list(map(int, t))
                                       for t in gen.generate(ids, lengths, audio, counts)]
        if (name, kind) == ("llama_gqa", "int8"):
            _, int8_kv, kw = SERVER_CASES[JAX_SERVER_ORACLE]
            server = jserver.BatchedServer(
                dataclasses.replace(jcfg, kv_cache_quant=int8_kv), jparams, tb.audio_patch_id,
                _gen_cfg(jgen), **dict(SERVER, **kw))
            served = server.serve([jserver.Request(i, a) for i, a in _requests(name)])
            refs[JAX_SERVER_ORACLE] = [r.tokens for r in served]
        out[name, kind] = refs
    return out


@pytest.fixture(scope="module")
def jax_trees():
    """Every JAX-quantized tree the tests below read, made once."""
    for name in CONFIGS:
        for kind in TREES:
            _jax_tree(name, kind)
    _jax_tree("llama_gqa", "int4_rows", 136)


@pytest.mark.parametrize("kind", TREES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_quantize_params_trees_match_jax(jax_trees, name, kind):
    jcfg, tcfg, tree, _ = _setup(name)
    want = _jax_tree(name, kind)
    source = params_from_numpy(tree, tcfg, "cpu")
    got = _port_quantize_tree(kind, tcfg, source)
    assert ("lm_head" in got) == (not tcfg.tie_embeddings)

    def check(g, w, path):
        assert isinstance(g, dict) == isinstance(w, dict), path
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                check(g[k], w[k], f"{path}/{k}")
            return
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
        if w.dtype == np.int8:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0, err_msg=path)

    check(got, want, "")
    assert PAYLOAD[kind.replace("_incremental", "")] in got["layers"]["w_down"]
    if kind != "int8":  # the incremental forms take ownership of the tree they are given
        assert source["layers"]["wq"] is not None and isinstance(got["layers"]["wq"], dict)


def test_rows_layout_gives_an_untileable_head_int8(jax_trees):
    # vocab % 128 != 0 (Llama-2's 32004 on the real model): under the rows
    # layout the head goes int8, under cols it stays int4
    name, vocab = "llama_gqa", 136
    _, tcfg, tree, _ = _setup(name, vocab)
    want = _jax_tree(name, "int4_rows", vocab)
    got = _port_quantize_tree("int4_rows", tcfg, params_from_numpy(tree, tcfg, "cpu"))
    assert set(want["lm_head"]) == {"q", "scale"} == set(got["lm_head"])
    np.testing.assert_array_equal(got["lm_head"]["q"].numpy(), want["lm_head"]["q"])
    assert "q4" in got["layers"]["wq"]
    cols = _port_quantize_tree("int4_cols", tcfg, params_from_numpy(tree, tcfg, "cpu"))
    assert set(cols["lm_head"]) == {"q4c", "scale"}


@pytest.mark.parametrize("kind", ["int8", "int4_rows", "int4_cols"])
def test_params_from_numpy_keeps_quantized_leaves(kind):
    name = "llama_gqa"
    _, tcfg, _, _ = _setup(name)
    tree = _jax_tree(name, kind)
    params = params_from_numpy(tree, tcfg, "cpu", dtype=torch.bfloat16)
    leaf = params["layers"]["w_up"]
    assert leaf[PAYLOAD[kind]].dtype == torch.int8 and leaf["scale"].dtype == torch.float32
    np.testing.assert_array_equal(leaf[PAYLOAD[kind]].numpy(), tree["layers"]["w_up"][PAYLOAD[kind]])
    np.testing.assert_array_equal(leaf["scale"].numpy(), tree["layers"]["w_up"]["scale"])
    assert params["lm_head"]["scale"].dtype == torch.float32
    # everything else goes to the asked dtype as before
    assert params["embed"].dtype == torch.bfloat16
    assert params["layers"]["attn_norm_scale"].dtype == torch.bfloat16
    short = dict(tree, layers=dict(tree["layers"]))
    short["layers"]["w_up"] = {k: v[:1] for k, v in tree["layers"]["w_up"].items()}
    with pytest.raises(ValueError, match="layers/w_up"):
        params_from_numpy(short, tcfg, "cpu")


@pytest.mark.parametrize("kind", ["int8", "int4_rows"])
def test_load_pretrained_model_roundtrips_quantized_tree(kind, tmp_path):
    name = "llama_gqa"
    _, tcfg, tree, tb = _setup(name)
    tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
    params = _port_quantize_tree(kind, tcfg, params_from_numpy(tree, tcfg, "cpu"))
    save_model_metadata(str(tmp_path), tcfg, tb)
    CheckpointManager(str(tmp_path)).save(3, TrainState(params, {}, 3))
    cfg, loaded, bundle = load_pretrained_model(str(tmp_path), device="cpu")
    assert cfg == tcfg and len(bundle.tokenizer) == len(tb.tokenizer)
    leaf, want = loaded["layers"]["wo"], params["layers"]["wo"]
    assert leaf[PAYLOAD[kind]].dtype == torch.int8 and leaf["scale"].dtype == torch.float32
    assert torch.equal(leaf[PAYLOAD[kind]], want[PAYLOAD[kind]])
    assert torch.equal(leaf["scale"], want["scale"])
    assert loaded["embed"].dtype == torch.bfloat16
    # a checkpoint of another depth is refused, quantized or not
    deeper = dataclasses.replace(tcfg, num_layers=3)
    save_model_metadata(str(tmp_path), deeper, tb)
    with pytest.raises(ValueError, match="does not hold the model"):
        load_pretrained_model(str(tmp_path), device="cpu")


@pytest.mark.parametrize("name,kind", SLICE_CASES)
def test_logits_match_jax(jax_slice, name, kind):
    _, tcfg, _, tb = _setup(name)
    tparams = params_from_numpy(_jax_tree(name, kind), tcfg, "cpu")
    ids, lengths, audio, counts = _batch(name)
    with torch.no_grad():
        logits, _ = tfusion.llark_forward(
            tcfg, tparams, torch.from_numpy(ids), audio_encodings=torch.from_numpy(audio),
            audio_patch_id=tb.audio_patch_id, audio_frame_counts=torch.from_numpy(counts),
            seq_lengths=torch.from_numpy(lengths))
    want = jax_slice[name, kind]["logits"]
    assert logits.dtype == torch.float32 and tuple(logits.shape) == want.shape
    live = np.arange(ids.shape[1])[None, :] < lengths[:, None]
    assert _rel(logits.numpy()[live], want[live]) < 1e-5


@pytest.mark.parametrize("name,kind", SLICE_CASES)
def test_generator_tokens_match_jax(jax_slice, name, kind):
    _, tcfg, _, tb = _setup(name)
    tparams = params_from_numpy(_jax_tree(name, kind), tcfg, "cpu")
    gen = tgen.Generator(tcfg, tparams, tb.audio_patch_id, _gen_cfg(tgen), max_cache_len=64,
                         device="cpu")
    got = gen.generate(*_batch(name))
    assert got == jax_slice[name, kind]["tokens", False]
    assert all(len(row) == MAX_NEW for row in got)


@pytest.mark.parametrize("case", list(SERVER_CASES))
def test_server_tokens_match_jax(jax_slice, case):
    name = "llama_gqa"
    kind, int8_kv, kw = SERVER_CASES[case]
    _, tcfg, _, tb = _setup(name)
    tparams = params_from_numpy(_jax_tree(name, kind), tcfg, "cpu")
    server = BatchedServer(dataclasses.replace(tcfg, kv_cache_quant=int8_kv), tparams,
                           tb.audio_patch_id, _gen_cfg(tgen), device="cpu", **dict(SERVER, **kw))
    out = server.serve([Request(ids, audio) for ids, audio in _requests(name)])
    refs = jax_slice[name, kind]
    want = refs[case] if case == JAX_SERVER_ORACLE else refs["tokens", int8_kv]
    assert [r.tokens for r in out] == want
    assert all(r.done and r.error is None and len(r.tokens) == MAX_NEW for r in out)


@pytest.mark.parametrize("bits", [4, 8])
def test_training_on_quantized_weights_still_raises(bits, tmp_path):
    # a quantized base trains only frozen (LoRA, a frozen backbone or the
    # adapter stage): without one the port raises the JAX package's
    # ValueError (llark_tpu/train/train.py:277-282), before any work
    args = TrainingArguments(output_dir=str(tmp_path / "out"), bits=bits)
    with pytest.raises(ValueError, match=f"--bits {bits} requires lora_enable"):
        train(ModelArguments(model_name_or_path="tiny"),
              DataArguments(train_data_path=str(tmp_path / "none.tar")), args, device="cpu")
    assert not (tmp_path / "out" / "model_config.json").exists()
