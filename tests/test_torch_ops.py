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


# ---------------------------------------------------------------------------
# K1's log-sum-exp and K3/K4 (flash backward): plain versions vs the Pallas
# kernels (interpret), and the autograd Function vs autograd through the
# plain path
# ---------------------------------------------------------------------------


def _jax_fwd_lse(q, k, v, causal, kv_lengths, slopes):
    out, lse = jattn.flash_attention_fwd(
        _j(q), _j(k), _j(v), causal=causal, kv_lengths=_j(kv_lengths), slopes=_j(slopes),
        block_q=128, block_k=128, interpret=True, return_lse=True,
    )
    return out, lse


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("alibi", [False, True], ids=["noalibi", "alibi"])
def test_flash_fwd_lse_matches_pallas(causal, alibi):
    # the TPU kernel's 128 lane copies of the log-sum-exp are one value;
    # a row with no live key gets -DEFAULT_MASK_VALUE in both
    b, h, hkv, s, d = 2, 4, 2, 128, 64
    q, k, v = _qkv(20, b, h, hkv, s, s, d)
    kv_lengths = np.array([0, 77], np.int32)
    slopes = np.asarray(jattn.alibi_slopes(h)) if alibi else None
    _, want = _jax_fwd_lse(q, k, v, causal, kv_lengths, slopes)
    want = np.asarray(want)[..., 0]
    got_out, got = tattn.flash_attention_fwd(
        _t(q), _t(k), _t(v), causal=causal, kv_lengths=_t(kv_lengths), slopes=_t(slopes),
        return_lse=True,
    )
    assert got.shape == (b, h, s) and got.dtype == torch.float32
    assert np.array_equal(got[0].numpy(), want[0])  # the empty row, exactly
    assert float(got[0, 0, 0]) == float(np.float32(-tattn.DEFAULT_MASK_VALUE))
    assert _rel_err(got[1], want[1]) < KERNEL_TOL
    # with return_lse the output is the plain forward's
    plain = tattn.flash_attention_fwd(
        _t(q), _t(k), _t(v), causal=causal, kv_lengths=_t(kv_lengths), slopes=_t(slopes)
    )
    assert torch.equal(got_out, plain)


@pytest.mark.parametrize(
    "b,h,hkv,s,d,causal,alibi",
    [
        (2, 4, 4, 128, 128, True, False),
        (2, 4, 4, 256, 64, False, False),
        (1, 8, 2, 128, 64, True, True),
        (2, 2, 1, 256, 128, True, False),
    ],
    ids=["causal", "noncausal_s256", "gqa4_alibi", "mqa_s256"],
)
def test_flash_bwd_plain_matches_pallas(b, h, hkv, s, d, causal, alibi):
    q, k, v = _qkv(21, b, h, hkv, s, s, d)
    g = np.random.RandomState(22).randn(b, h, s, d).astype(np.float32)
    kv_lengths = np.array([s, s - 51][:b], np.int32)
    slopes = np.asarray(jattn.alibi_slopes(h)) if alibi else None
    out, lse = _jax_fwd_lse(q, k, v, causal, kv_lengths, slopes)
    jdq, jdk, jdv = jattn.flash_attention_bwd(
        _j(q), jattn._broadcast_kv(_j(k), h), jattn._broadcast_kv(_j(v), h), out, lse, _j(g),
        causal=causal, kv_lengths=_j(kv_lengths), slopes=_j(slopes),
        block_q=128, block_k=128, interpret=True,
    )
    group = h // hkv
    jdk = np.asarray(jdk).reshape(b, hkv, group, s, d).sum(axis=2)  # as _flash_mha_bwd does
    jdv = np.asarray(jdv).reshape(b, hkv, group, s, d).sum(axis=2)
    dq, dk, dv = tattn.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(out), _t(np.asarray(lse)[..., 0]), _t(g),
        causal=causal, kv_lengths=_t(kv_lengths), slopes=_t(slopes),
    )
    assert dk.shape == (b, hkv, s, d)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert _rel_err(got, want) < KERNEL_TOL
    if b > 1:  # keys at or past kv_len get exact zeros
        assert float(dk[1, :, s - 51:].abs().max()) == 0.0
        assert float(dv[1, :, s - 51:].abs().max()) == 0.0


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "decoder_view"])
def test_flash_bwd_delta_is_the_rowsum_of_g_times_out(strided):
    # delta = rowsum(g * out) in fp32 from bf16 inputs, also from the
    # decoder's transposed [B, S, H, D] views
    rng = np.random.RandomState(26)
    shape = (2, 9, 3, 16) if strided else (2, 3, 9, 16)
    out, g = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(torch.bfloat16)
              for _ in range(2))
    if strided:
        out, g = out.transpose(1, 2), g.transpose(1, 2)
    got = tattn._flash_bwd_delta(out, g)
    want = (g.float().numpy().astype(np.float64) * out.float().numpy()).sum(-1)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_flash_bwd_checks_shapes_before_dispatch():
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="g "):
        tattn.flash_attention_bwd(q, k, k, q, lse, q[..., :8])
    with pytest.raises(ValueError, match="out "):
        tattn.flash_attention_bwd(q, k, k, q[:, :2], lse, q)
    with pytest.raises(ValueError, match="lse"):
        tattn.flash_attention_bwd(q, k, k, q, lse[..., :4], q)
    with pytest.raises(ValueError, match="does not fit"):
        k3 = torch.zeros(1, 3, 8, 16)
        tattn.flash_attention_bwd(q, k3, k3, q, lse, q)


@pytest.mark.parametrize("hkv,causal,alibi", [(4, True, False), (2, False, True)],
                         ids=["causal", "gqa_noncausal_alibi"])
def test_flash_attention_function_matches_autograd(hkv, causal, alibi):
    # the counterpart of _flash_mha: forward with its log-sum-exp, backward
    # by the flash backward; held against autograd through xla_attention
    b, h, s, d = 2, 4, 40, 16
    q, k, v = _qkv(23, b, h, hkv, s, s, d)
    g = torch.from_numpy(np.random.RandomState(24).randn(b, h, s, d).astype(np.float32))
    kv_lengths = torch.tensor([40, 29])
    slopes = tattn.alibi_slopes(h) if alibi else None
    grads = []
    for route in ("function", "plain"):
        tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
        if route == "function":
            out = tattn._FlashAttention.apply(tq, tk, tv, causal, kv_lengths, slopes)
        else:
            out = tattn.xla_attention(tq, tk, tv, causal=causal, kv_lengths=kv_lengths,
                                      slopes=slopes)
        grads.append(torch.autograd.grad(out, (tq, tk, tv), g))
    for got, want in zip(*grads):
        assert _rel_err(got, want) < XLA_TOL


def test_multihead_attention_routes_training_through_the_function():
    # with autograd recording, the flash route is the autograd Function
    # (gradients reach q, k and v); without, it is the forward alone
    q, k, v = (_t(x) for x in _qkv(25, 1, 4, 4, 8, 8, 16))
    q.requires_grad_()
    out = tattn.multihead_attention(q, k, v, kv_lengths=torch.tensor([8]), use_pallas=True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    with torch.no_grad():
        out = tattn.multihead_attention(q, k, v, kv_lengths=torch.tensor([8]), use_pallas=True)
    assert out.grad_fn is None


@pytest.mark.parametrize("hkv,d", [(32, 128), (8, 128), (16, 64)], ids=["7b", "gqa8", "d64"])
def test_paged_block_size_limit_takes_every_jax_block_size(hkv, d):
    # the kernel resolves the table per cache position, so its only limit
    # is 32-bit addressing inside a pool block; every block size the JAX
    # server accepts (a multiple of 8 up to its VMEM cap) fits under it
    for itemsize in (1, 2):
        cap = tdec.max_paged_block_size(hkv, d, itemsize)
        assert cap % 8 == 0
        assert cap >= jdec.max_paged_block_size(hkv, d, itemsize)
        assert hkv * cap * d * itemsize < 2**31
