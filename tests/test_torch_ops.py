"""Port attention ops against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both packages. On the CPU
the port's kernel wrappers run their plain PyTorch versions; the JAX side
runs its Pallas kernels in interpret mode or its XLA reference path.

Tolerances (relative to max |reference|):
  * 1e-5 against `xla_attention`: both sides are fp32 softmax attention,
    differing only in summation order;
  * 2e-5 against interpret-mode Pallas kernels: the blocked online softmax
    rescales partial sums per block, which adds a few fp32 roundings.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu.ops import attention as jattn
from llark_tpu.ops import decode_attention as jdec
from llark_tpu_torch.ops import attention as tattn
from llark_tpu_torch.ops import decode_attention as tdec

XLA_TOL = 1e-5
KERNEL_TOL = 2e-5


def _rel_err(got, want):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-6))


def _qkv(seed, b, h, hkv, sq, sk, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, hkv, sk, d).astype(np.float32)
    v = rng.randn(b, hkv, sk, d).astype(np.float32)
    return q, k, v


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def test_alibi_slopes_match():
    for h in (4, 8, 12, 32):
        np.testing.assert_allclose(
            tattn.alibi_slopes(h).numpy(), np.asarray(jattn.alibi_slopes(h)), rtol=1e-7
        )


# ---------------------------------------------------------------------------
# xla_attention: the plain path, every mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "mode", ["causal", "noncausal", "q_offset_scalar", "q_offset_rows", "prefix",
             "alibi_gqa", "int8_scales"]
)
def test_xla_attention_matches_jax(mode):
    b, h, hkv, sq, sk, d = 2, 4, 4, 8, 24, 16
    if mode == "alibi_gqa":
        hkv = 2
    q, k, v = _qkv(0, b, h, hkv, sq, sk, d)
    kw = dict(kv_lengths=np.array([24, 13], np.int32))
    causal = mode != "noncausal"
    if mode == "q_offset_scalar":
        kw["q_offset"] = 16
    if mode == "q_offset_rows":
        kw["q_offset"] = np.array([5, 16], np.int32)
    if mode == "prefix":
        kw["prefix_lengths"] = np.array([6, 3], np.int32)
    if mode == "alibi_gqa":
        kw["slopes"] = np.asarray(jattn.alibi_slopes(h))
        kw["q_offset"] = 16
    if mode == "int8_scales":
        rng = np.random.RandomState(1)
        k = rng.randint(-127, 128, k.shape).astype(np.int8)
        v = rng.randint(-127, 128, v.shape).astype(np.int8)
        kw["k_scale"] = rng.rand(b, hkv, sk).astype(np.float32) / 127
        kw["v_scale"] = rng.rand(b, hkv, sk).astype(np.float32) / 127
        kw["q_offset"] = 16
    want = jattn.xla_attention(
        _j(q), _j(k), _j(v), causal=causal, **{n: _j(x) if not isinstance(x, int) else x
                                               for n, x in kw.items()}
    )
    got = tattn.xla_attention(
        _t(q), _t(k), _t(v), causal=causal, **{n: _t(x) if not isinstance(x, int) else x
                                              for n, x in kw.items()}
    )
    assert _rel_err(got, want) < XLA_TOL


# ---------------------------------------------------------------------------
# K1: flash_attention_fwd's plain version vs the Pallas kernel (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq", [128, 256])
@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("alibi", [False, True], ids=["noalibi", "alibi"])
def test_flash_fwd_plain_matches_pallas(sq, hkv, alibi):
    b, h, d = 2, 4, 128
    q, k, v = _qkv(2, b, h, hkv, sq, sq, d)
    kv_lengths = np.array([0, sq - 37], np.int32)  # an empty row and a ragged one
    slopes = np.asarray(jattn.alibi_slopes(h)) if alibi else None
    want = jattn.flash_attention_fwd(
        _j(q), _j(k), _j(v), causal=True, kv_lengths=_j(kv_lengths), slopes=_j(slopes),
        block_q=128, block_k=128, interpret=True,
    )
    got = tattn.flash_attention_fwd(
        _t(q), _t(k), _t(v), causal=True, kv_lengths=_t(kv_lengths), slopes=_t(slopes)
    )
    assert _rel_err(got, want) < KERNEL_TOL
    # the row with no live key is zeros, as in the TPU kernel
    assert float(got[0].abs().max()) == 0.0
    # rows that see keys agree with the plain XLA path too
    ref = tattn.xla_attention(
        _t(q), _t(k), _t(v), causal=True, kv_lengths=_t(kv_lengths), slopes=_t(slopes)
    )
    assert _rel_err(got[1], ref[1]) < XLA_TOL


def test_flash_fwd_plain_noncausal_ragged_edges():
    # lengths that divide no block size: the port masks edges itself
    b, h, hkv, sq, sk, d = 2, 4, 2, 37, 50, 64
    q, k, v = _qkv(3, b, h, hkv, sq, sk, d)
    kv_lengths = np.array([50, 21], np.int32)
    got = tattn.flash_attention_fwd(
        _t(q), _t(k), _t(v), causal=False, kv_lengths=_t(kv_lengths)
    )
    want = jattn.xla_attention(
        _j(q), _j(k), _j(v), causal=False, kv_lengths=_j(kv_lengths)
    )
    assert _rel_err(got, want) < XLA_TOL


@pytest.mark.parametrize(
    "case,route",
    [("flash", "flash"), ("single_query", "xla"), ("prefix", "xla"), ("no_pallas", "xla")],
)
def test_multihead_attention_dispatch(case, route):
    # a row with kv_length 0 tells the routes apart: the flash kernel writes
    # zeros, the XLA path softmaxes the masked row to mean(V)
    b, h, d = 2, 4, 16
    sq = 1 if case == "single_query" else 8
    q, k, v = _qkv(4, b, h, h, sq, 8, d)
    kw = dict(kv_lengths=torch.tensor([0, 8]), use_pallas=case != "no_pallas")
    if case == "prefix":
        kw["prefix_lengths"] = torch.tensor([0, 0])
    out = tattn.multihead_attention(_t(q), _t(k), _t(v), causal=True, **kw)
    empty_row_is_zero = float(out[0].abs().max()) == 0.0
    assert empty_row_is_zero == (route == "flash")


# ---------------------------------------------------------------------------
# K2: flash_decode_attention's plain version vs the Pallas kernels
# ---------------------------------------------------------------------------


def _quant(x):
    amax = np.abs(x).max(axis=-1)
    sc = (amax / 127.0).astype(np.float32)
    q8 = np.round(x / np.maximum(sc, 1e-8)[..., None]).astype(np.int8)
    return q8, sc


@pytest.mark.parametrize("all_heads", [True, False], ids=["allheads", "perhead"])
@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("mode", ["dense", "int8", "alibi_gqa"])
def test_flash_decode_plain_matches_pallas(mode, sq, all_heads):
    b, h, hkv, s, d = 2, 4, 4, 256, 128
    if mode == "alibi_gqa":
        hkv = 2
    q, k, v = _qkv(5, b, h, hkv, sq, s, d)
    kv_lengths = np.array([256, 77], np.int32)
    q_positions = kv_lengths - sq
    kw = {}
    if mode == "int8":
        k, kw["k_scale"] = _quant(k)
        v, kw["v_scale"] = _quant(v)
    if mode == "alibi_gqa":
        kw["slopes"] = np.asarray(jattn.alibi_slopes(h))
    want = jdec.flash_decode_attention(
        _j(q), _j(k), _j(v), kv_lengths=_j(kv_lengths), q_positions=_j(q_positions),
        block_k=128, all_heads=all_heads, interpret=True,
        **{n: _j(x) for n, x in kw.items()},
    )
    got = tdec.flash_decode_attention(
        _t(q), _t(k), _t(v), kv_lengths=_t(kv_lengths), q_positions=_t(q_positions),
        **{n: _t(x) for n, x in kw.items()},
    )
    assert _rel_err(got, want) < KERNEL_TOL


@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["bf", "int8"])
def test_flash_decode_plain_matches_pallas_paged(sq, quant):
    b, h, hkv, bs, d, max_blocks = 2, 4, 2, 32, 128, 4
    n_blocks = 10
    rng = np.random.RandomState(6)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(n_blocks, hkv, bs, d).astype(np.float32)
    v = rng.randn(n_blocks, hkv, bs, d).astype(np.float32)
    tables = np.array([[3, 7, 1, 9], [5, 2, 0, 0]], np.int32)
    kv_lengths = np.array([120, 45], np.int32)
    q_positions = kv_lengths - sq
    kw = {}
    if quant:
        k, kw["k_scale"] = _quant(k)
        v, kw["v_scale"] = _quant(v)
    want = jdec.flash_decode_attention(
        _j(q), _j(k), _j(v), kv_lengths=_j(kv_lengths), q_positions=_j(q_positions),
        block_tables=_j(tables), interpret=True, **{n: _j(x) for n, x in kw.items()},
    )
    got = tdec.flash_decode_attention(
        _t(q), _t(k), _t(v), kv_lengths=_t(kv_lengths), q_positions=_t(q_positions),
        block_tables=_t(tables), **{n: _t(x) for n, x in kw.items()},
    )
    assert _rel_err(got, want) < KERNEL_TOL


def test_flash_decode_plain_default_positions_and_empty_row():
    # q_positions defaults to kv_lengths - 1; a row with no live key is zeros
    b, h, s, d = 2, 4, 64, 16
    q, k, v = _qkv(7, b, h, h, 1, s, d)
    kv_lengths = np.array([0, 30], np.int32)
    slopes = np.asarray(jattn.alibi_slopes(h))
    got = tdec.flash_decode_attention(
        _t(q), _t(k), _t(v), kv_lengths=_t(kv_lengths), slopes=_t(slopes)
    )
    assert float(got[0].abs().max()) == 0.0
    want = jattn.xla_attention(
        _j(q), _j(k), _j(v), kv_lengths=_j(kv_lengths), slopes=_j(slopes),
        q_offset=_j(kv_lengths - 1),
    )
    assert _rel_err(got[1], np.asarray(want)[1]) < XLA_TOL


@pytest.mark.parametrize("sq", [4, 40], ids=["flash", "xla"])
def test_decode_attention_dispatch_paged(sq):
    # Sq <= 32 takes the flash route, longer windows the XLA route over a
    # gathered dense view; both match the JAX dispatcher's XLA fallback
    b, h, hkv, bs, d = 2, 4, 2, 16, 16
    rng = np.random.RandomState(8)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(8, hkv, bs, d).astype(np.float32)
    v = rng.randn(8, hkv, bs, d).astype(np.float32)
    tables = np.array([[1, 4, 6, 3], [2, 5, 0, 7]], np.int32)
    kv_lengths = np.array([60, 50], np.int32)
    q_positions = kv_lengths - sq
    want = jdec.decode_attention(
        _j(q), _j(k), _j(v), kv_lengths=_j(kv_lengths), q_positions=_j(q_positions),
        block_tables=_j(tables), use_pallas=False,
    )
    got = tdec.decode_attention(
        _t(q), _t(k), _t(v), kv_lengths=_t(kv_lengths), q_positions=_t(q_positions),
        block_tables=_t(tables),
    )
    assert _rel_err(got, want) < XLA_TOL
