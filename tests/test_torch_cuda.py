"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA GPU and skips without one. The file imports
nothing of JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py pins JAX to the CPU.)

Tolerance, for bf16 inputs with both outputs rounded to bf16: the worst
query row's |kernel - plain| / |plain| (L2 over the head dim) stays within
ROW_TOL, the limits of chip_smoke.py: about one bf16 ulp (2**-8 relative)
above the errors its cases read on an H100 (4.9e-3 prefill, 4.8e-4 decode;
PERF.md). The prefill kernel rounds the
probabilities to bf16 for the P.V product and both kernels sum in another
order than the plain versions, which compute in fp32. A row with no live
key must be zeros.

The flash backward (dq, dk, dv) is held as chip_smoke.py holds it:
per row within 1e-2 with each row's norm floored at 1e-2 of the tensor's
RMS row norm (a dq row can be ~0 by cancellation), and within the JAX
package's 1.6e-2 relative to max (PERFORMANCE.md:130-132). The forward's
log-sum-exp is fp32 and held to 1e-4 absolute.

The two quantized products (int8, int4) are held per output row,
|kernel - plain| / |plain| (L2 over the output channels), within WQ_ROW_TOL,
the limits of chip_smoke.py: the int8 kernel computes the plain version's
exact products in another order and read at most 2.9e-4 on an H100; the
int4 kernel keeps the scales in fp32 where the plain version rounds
nibble x scale to bf16, and read at most 3.7e-3. Each limit is about one
bf16 ulp above its reading.
"""

import numpy as np
import pytest
import torch

from llark_tpu_torch.models.decoder import _quantize_kv
from llark_tpu_torch.ops import attention as tattn
from llark_tpu_torch.ops import decode_attention as tdec

ROW_TOL = {"flash_fwd": 1e-2, "flash_decode": 4e-3, "flash_bwd": 1e-2}
BWD_ROW_FLOOR = 1e-2
BWD_TOL = 1.6e-2
LSE_TOL = 1e-4
WQ_ROW_TOL = {"int8_matmul": 4e-3, "int4_matmul": 8e-3}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _row_err(got, want, floor=0.0):
    g, w = got.float().cpu(), want.float().cpu()
    w_norm = w.norm(dim=-1)
    if floor:
        w_norm = w_norm.clamp_min(floor * float(w_norm.square().mean().sqrt()))
    live = w_norm > 0
    assert bool((g.norm(dim=-1)[~live] == 0).all()), "a row with no live key is not zeros"
    return float(((g - w).norm(dim=-1)[live] / w_norm[live]).max())


def _qkv(dev, seed, b, h, hkv, sq, sk, d):
    rng = np.random.RandomState(seed)
    return tuple(
        torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, torch.bfloat16)
        for shape in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))
    )


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hkv,alibi", [(8, False), (2, True)])
def test_flash_fwd_kernel_matches_plain(dev, d, hkv, alibi):
    b, h, sq = 3, 8, 200
    q, k, v = _qkv(dev, 9, b, h, hkv, sq, sq, d)
    kv_lengths = torch.tensor([0, 200, 77], device=dev)
    slopes = tattn.alibi_slopes(h, dev) if alibi else None
    before = tattn.flash_attention_fwd.launches
    got = tattn.flash_attention_fwd(q, k, v, kv_lengths=kv_lengths, slopes=slopes)
    torch.cuda.synchronize()
    assert tattn.flash_attention_fwd.launches == before + 1
    want = tattn._flash_attention_fwd_plain(
        q, k, v, causal=True, kv_lengths=kv_lengths, slopes=slopes
    )
    assert _row_err(got, want) <= ROW_TOL["flash_fwd"]
    assert float(got[0].abs().max()) == 0.0  # the row with no live key


def test_flash_fwd_kernel_strided_noncausal(dev):
    # q/k/v as transposed views of [B, S, H, D] projections, ragged Sq != Sk
    b, h, sq, sk, d = 2, 4, 70, 130, 128
    rng = np.random.RandomState(11)
    q = torch.from_numpy(rng.randn(b, sq, h, d).astype(np.float32)).to(dev, torch.bfloat16)
    k = torch.from_numpy(rng.randn(b, sk, h, d).astype(np.float32)).to(dev, torch.bfloat16)
    v = torch.from_numpy(rng.randn(b, sk, h, d).astype(np.float32)).to(dev, torch.bfloat16)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kv_lengths = torch.tensor([130, 9], device=dev)
    got = tattn.flash_attention_fwd(q, k, v, causal=False, kv_lengths=kv_lengths)
    want = tattn._flash_attention_fwd_plain(
        q, k, v, causal=False, kv_lengths=kv_lengths, slopes=None
    )
    assert _row_err(got, want) <= ROW_TOL["flash_fwd"]


@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("hkv,alibi", [(8, False), (2, True)])
def test_flash_decode_kernel_matches_plain(dev, sq, hkv, alibi):
    b, h, s, d = 3, 8, 512, 128
    q, k, v = _qkv(dev, 10, b, h, hkv, sq, s, d)
    kv_lengths = torch.tensor([1, 300, 512], device=dev)
    q_positions = kv_lengths - sq
    slopes = tattn.alibi_slopes(h, dev) if alibi else None
    before = tdec.flash_decode_attention.launches
    got = tdec.flash_decode_attention(
        q, k, v, kv_lengths=kv_lengths, q_positions=q_positions, slopes=slopes
    )
    torch.cuda.synchronize()
    assert tdec.flash_decode_attention.launches == before + 1
    want = tdec._flash_decode_plain(
        q, k, v, kv_lengths=kv_lengths, q_positions=q_positions, k_scale=None,
        v_scale=None, slopes=slopes, block_tables=None,
    )
    assert _row_err(got, want) <= ROW_TOL["flash_decode"]


def test_flash_decode_kernel_many_rows(dev):
    # group 8 x Sq 16 = 128 query rows per kv head: several row chunks
    b, h, hkv, sq, s, d = 2, 16, 2, 16, 256, 64
    q, k, v = _qkv(dev, 12, b, h, hkv, sq, s, d)
    kv_lengths = torch.tensor([256, 100], device=dev)
    q_positions = kv_lengths - sq
    got = tdec.flash_decode_attention(q, k, v, kv_lengths=kv_lengths, q_positions=q_positions)
    want = tdec._flash_decode_plain(
        q, k, v, kv_lengths=kv_lengths, q_positions=q_positions, k_scale=None,
        v_scale=None, slopes=None, block_tables=None,
    )
    assert _row_err(got, want) <= ROW_TOL["flash_decode"]


@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("hkv,alibi", [(8, False), (2, True)])
def test_flash_decode_kernel_int8_matches_plain(dev, sq, hkv, alibi):
    # the dense int8 cache: both sides dequantize the same int8 values and
    # scales in fp32
    b, h, s, d = 3, 8, 512, 128
    q, k, v = _qkv(dev, 18, b, h, hkv, sq, s, d)
    (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
    kv_lengths = torch.tensor([1, 300, 512], device=dev)
    q_positions = kv_lengths - sq
    slopes = tattn.alibi_slopes(h, dev) if alibi else None
    before = dict(tdec.flash_decode_attention.launches_by_mode)
    got = tdec.flash_decode_attention(
        q, k8, v8, kv_lengths=kv_lengths, q_positions=q_positions, k_scale=ks, v_scale=vs,
        slopes=slopes)
    torch.cuda.synchronize()
    assert tdec.flash_decode_attention.launches_by_mode["dense_int8"] == before["dense_int8"] + 1
    want = tdec._flash_decode_plain(
        q, k8, v8, kv_lengths=kv_lengths, q_positions=q_positions, k_scale=ks, v_scale=vs,
        slopes=slopes, block_tables=None)
    assert _row_err(got, want) <= ROW_TOL["flash_decode"]


@pytest.mark.parametrize("bs", [16, 64, 128])
@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_flash_decode_kernel_paged_matches_plain(dev, bs, sq, quant):
    # GQA 4 + ALiBi over a pool whose blocks are scattered: each row's
    # table is a random permutation of pool blocks, so a 64-position split
    # spans several blocks (bs 16), one (bs 64) or half of one (bs 128)
    b, h, hkv, d, span = 3, 8, 2, 128, 512
    max_blocks = span // bs
    n_blocks = b + b * max_blocks  # parking blocks first, as the server lays them out
    rng = np.random.RandomState(19 + bs)
    q = torch.from_numpy(rng.randn(b, h, sq, d).astype(np.float32)).to(dev, torch.bfloat16)
    k = torch.from_numpy(rng.randn(n_blocks, hkv, bs, d).astype(np.float32)).to(dev, torch.bfloat16)
    v = torch.from_numpy(rng.randn(n_blocks, hkv, bs, d).astype(np.float32)).to(dev, torch.bfloat16)
    perm = rng.permutation(np.arange(b, n_blocks)).reshape(b, max_blocks).astype(np.int32)
    tables = torch.from_numpy(perm).to(dev)
    kv_lengths = torch.tensor([1, 300, 512], device=dev)
    q_positions = kv_lengths - sq
    kw = dict(kv_lengths=kv_lengths, q_positions=q_positions,
              slopes=tattn.alibi_slopes(h, dev), block_tables=tables)
    if quant:
        (k, kw["k_scale"]), (v, kw["v_scale"]) = _quantize_kv(k), _quantize_kv(v)
    mode = "paged_int8" if quant else "paged_bf16"
    before = tdec.flash_decode_attention.launches_by_mode[mode]
    got = tdec.flash_decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tdec.flash_decode_attention.launches_by_mode[mode] == before + 1
    want = tdec._flash_decode_plain(q, k, v, k_scale=kw.pop("k_scale", None),
                                    v_scale=kw.pop("v_scale", None), **kw)
    assert _row_err(got, want) <= ROW_TOL["flash_decode"]


def test_flash_decode_kernel_clips_bad_tables_and_lengths(dev):
    # block ids outside the pool are clipped into it (as the JAX gather
    # clips) and a live length past the cache counts as the cache: the
    # kernel reads nothing outside its operands
    b, h, d, bs, max_blocks, n_blocks = 2, 4, 128, 16, 4, 6
    rng = np.random.RandomState(20)
    q = torch.from_numpy(rng.randn(b, h, 1, d).astype(np.float32)).to(dev, torch.bfloat16)
    k = torch.from_numpy(rng.randn(n_blocks, h, bs, d).astype(np.float32)).to(dev, torch.bfloat16)
    v = torch.from_numpy(rng.randn(n_blocks, h, bs, d).astype(np.float32)).to(dev, torch.bfloat16)
    tables = torch.tensor([[2, 10**6, -3, 5], [1, 4, 3, 2]], dtype=torch.int32, device=dev)
    kv_lengths = torch.tensor([64, 10**6], device=dev)
    got = tdec.flash_decode_attention(q, k, v, kv_lengths=kv_lengths, block_tables=tables)
    torch.cuda.synchronize()
    want = tdec._flash_decode_plain(
        q, k, v, kv_lengths=kv_lengths.clamp_max(max_blocks * bs), q_positions=None,
        k_scale=None, v_scale=None, slopes=None, block_tables=tables.clamp(0, n_blocks - 1))
    assert _row_err(got, want) <= ROW_TOL["flash_decode"]


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros((1, 4, 1, 128), dtype=torch.bfloat16, device=dev)
    k8 = torch.zeros((1, 4, 64, 128), dtype=torch.int8, device=dev)
    sc = torch.ones((1, 4, 64), device=dev)
    lengths = torch.tensor([10], device=dev)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        tdec.flash_decode_attention(q, k8, k8, kv_lengths=lengths, k_scale=sc)
    with pytest.raises(ValueError, match="int8"):
        tdec.flash_decode_attention(q, k8, k8, kv_lengths=lengths)
    # a strided cache is refused, not copied on every step
    kb = torch.zeros((1, 4, 64, 256), dtype=torch.bfloat16, device=dev)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        tdec.flash_decode_attention(q, kb, kb, kv_lengths=lengths)
    pool = torch.zeros((3, 4, 16, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="block tables"):
        tdec.flash_decode_attention(q, pool, pool, kv_lengths=lengths,
                                    block_tables=torch.zeros((1, 4), device=dev))
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros((1, 4, 8, 16), dtype=torch.bfloat16, device=dev)
        tattn.flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="bfloat16"):
        x = torch.zeros((1, 4, 8, 128), dtype=torch.float32, device=dev)
        tattn.flash_attention_fwd(x, x, x)


def _rel_to_max(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _bwd_against_plain(q, k, v, do, kw):
    """The flash backward on the card (one launch) against its plain
    version on the same inputs; returns the kernel's (dq, dk, dv)."""
    out, lse = tattn.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    _, lse_plain = tattn._flash_attention_fwd_plain(q, k, v, return_lse=True, **kw)
    assert float((lse - lse_plain).abs().max()) <= LSE_TOL
    before = tattn.flash_attention_bwd.launches
    got = tattn.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert tattn.flash_attention_bwd.launches == before + 1
    want = tattn._flash_bwd_plain(q, k, v, do, lse, tattn._flash_bwd_delta(out, do), **kw)
    for a, ref in zip(got, want):
        assert a.is_contiguous() and a.dtype == torch.bfloat16
        assert _row_err(a, ref, BWD_ROW_FLOOR) <= ROW_TOL["flash_bwd"]
        assert _rel_to_max(a, ref) <= BWD_TOL
    return got


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("hkv,alibi", [(8, False), (2, True)])
def test_flash_bwd_kernels_match_plain(dev, d, causal, hkv, alibi):
    b, h, sq = 3, 8, 300
    q, k, v = _qkv(dev, 13, b, h, hkv, sq, sq, d)
    do = _qkv(dev, 14, b, h, h, sq, sq, d)[0]
    kv_lengths = torch.tensor([0, 300, 130], device=dev)
    kw = dict(causal=causal, kv_lengths=kv_lengths,
              slopes=tattn.alibi_slopes(h, dev) if alibi else None)
    dq, dk, dv = _bwd_against_plain(q, k, v, do, kw)
    # the row with no live key: no gradient anywhere; dead keys get zeros
    assert float(dq[0].abs().max()) == 0.0 and float(dk[0].abs().max()) == 0.0
    assert float(dk[2, :, 130:].abs().max()) == 0.0 and float(dv[2, :, 130:].abs().max()) == 0.0


def test_flash_bwd_long_rows(dev):
    # 1024 queries: eight 128-key tiles add into each late dq row
    b, h, s, d = 2, 4, 1024, 128
    q, k, v = _qkv(dev, 30, b, h, h, s, s, d)
    do = _qkv(dev, 31, b, h, h, s, s, d)[0]
    kw = dict(causal=True, kv_lengths=torch.tensor([1024, 700], device=dev), slopes=None)
    _, dk, dv = _bwd_against_plain(q, k, v, do, kw)
    assert float(dk[1, :, 700:].abs().max()) == 0.0 and float(dv[1, :, 700:].abs().max()) == 0.0


def test_flash_bwd_reads_decoder_views_in_place(dev, monkeypatch):
    # the decoder hands over [B, S, H, D] activations transposed to
    # [B, H, S, D]: the backward reads them through their strides, no copy
    b, s, h, hkv, d = 2, 200, 8, 2, 128
    rng = np.random.RandomState(32)

    def view(heads):
        x = rng.randn(b, s, heads, d).astype(np.float32)
        return torch.from_numpy(x).to(dev, torch.bfloat16).transpose(1, 2)

    q, k, v, do = view(h), view(hkv), view(hkv), view(h)
    assert not q.is_contiguous()
    kw = dict(causal=True, kv_lengths=torch.tensor([200, 150], device=dev),
              slopes=tattn.alibi_slopes(h, dev))
    out, lse = tattn.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    copied = []
    real = tattn._kernel_operand

    def operand(t):
        got = real(t)
        copied.append(got.data_ptr() != t.data_ptr())
        return got

    monkeypatch.setattr(tattn, "_kernel_operand", operand)
    got = tattn.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    monkeypatch.undo()
    assert copied == [False] * 5, "an operand was copied"
    want = tattn._flash_bwd_plain(q, k, v, do, lse, tattn._flash_bwd_delta(out, do), **kw)
    contig = tattn.flash_attention_bwd(
        *(t.contiguous() for t in (q, k, v)), out, lse, do.contiguous(), **kw)
    torch.cuda.synchronize()
    for a, ref, c in zip(got, want, contig):
        assert _row_err(a, ref, BWD_ROW_FLOOR) <= ROW_TOL["flash_bwd"]
        assert _rel_to_max(a, c) <= BWD_TOL


@pytest.mark.parametrize("hkv", [8, 2])
def test_flash_attention_gradient_reaches_q_k_v(dev, hkv):
    # through multihead_attention's kernel route, as the decoder trains;
    # held against autograd through the plain path. Before the autograd
    # Function, the kernel route returned a tensor with no gradient.
    b, h, s, d = 2, 8, 256, 128
    q, k, v = (t.requires_grad_() for t in _qkv(dev, 15, b, h, hkv, s, s, d))
    g = _qkv(dev, 16, b, h, h, s, s, d)[0]
    kv_lengths = torch.tensor([256, 100], device=dev)
    out = tattn.multihead_attention(q, k, v, kv_lengths=kv_lengths, use_pallas=True)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = tattn.xla_attention(q, k, v, kv_lengths=kv_lengths)
    want = torch.autograd.grad(ref, (q, k, v), g)
    for a, r in zip(got, want):
        assert _rel_to_max(a, r) <= BWD_TOL


@pytest.mark.parametrize("tied", [False, True], ids=["lm_head", "tied"])
def test_logits_keep_the_fp32_accumulator(dev, tied):
    # bf16 x bf16 on the tensor cores with an fp32 result: within 1e-5 of the
    # exact product of the bf16 operands (a bf16-rounded result is ~4e-3 off)
    from llark_tpu_torch.config import ModelConfig
    from llark_tpu_torch.models.decoder import compute_logits

    cfg = ModelConfig.tiny(vocab_size=512, hidden_size=256, tie_embeddings=tied)
    rng = np.random.RandomState(17)
    hidden = torch.from_numpy(rng.randn(2, 5, 256).astype(np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy(rng.randn(256, 512).astype(np.float32)).to(dev)
    if tied:
        w = w.t().contiguous()
    hidden.requires_grad_()
    w.requires_grad_()
    got = compute_logits(cfg, {"embed" if tied else "lm_head": w}, hidden, 500 if tied else None)
    assert got.dtype == torch.float32
    wb = w.detach().to(torch.bfloat16).double()
    want = hidden.detach().double() @ (wb.t() if tied else wb)
    assert float((got.detach().double() - want).abs().max() / want.abs().max()) <= 1e-5
    got.sum().backward()
    assert hidden.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    assert bool(torch.isfinite(w.grad).all())
    if tied:  # rows below trainable_token_start get no gradient
        assert float(w.grad[:500].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the weight-only quantized products
# ---------------------------------------------------------------------------


def _wq_inputs(dev, seed, m, k, n):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy((rng.randn(k, n) * 0.02).astype(np.float32)).to(dev)
    return x, w


# M: a decode step of one request and of 8 slots, both sides of the switch
# from the split small-M kernel to the 64-row tile kernel, a ragged prefill;
# (K, N): a ragged N (8 * 125), and a Llama-2-7B projection
@pytest.mark.parametrize("m", [1, 8, 16, 17, 293])
@pytest.mark.parametrize("k,n", [(256, 1000), (4096, 4096)])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantized_matmul_kernels_match_plain(dev, fmt, k, n, m):
    from llark_tpu_torch.models import quant
    from llark_tpu_torch.ops import int4_matmul as tint4
    from llark_tpu_torch.ops import int8_matmul as tint8

    x, w = _wq_inputs(dev, 21, m, k, n)
    if fmt == "int8":
        wq = quant.quantize_weight(w)
        fn, before = tint8.int8_matmul, tint8.int8_matmul.launches
        got = fn(x, wq["q"], wq["scale"])
        again = fn(x, wq["q"], wq["scale"])
        want = tint8._int8_matmul_plain(x, wq["q"], wq["scale"])
    else:
        wq = quant.quantize_weight_int4(w, 128)
        fn, before = tint4.int4_matmul, tint4.int4_matmul.launches
        got = fn(x, wq["q4"], wq["scale"], group=128)
        again = fn(x, wq["q4"], wq["scale"], group=128)
        want = tint4._int4_matmul_plain(x, wq["q4"], wq["scale"])
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    assert _row_err(got, want) <= WQ_ROW_TOL[fmt + "_matmul"]
    assert _rel_to_max(got, want) <= 2e-2
    assert torch.equal(got, again)  # split sums are combined in a fixed order


def test_quantized_dispatch_on_the_card(dev):
    # a 2-D leaf inside the contract launches its kernel; a stacked leaf and
    # the cols layout take the plain expression; an fp32 compute dtype and a
    # direct call outside the contract raise; autograd is refused
    from llark_tpu_torch.models import quant
    from llark_tpu_torch.ops.int4_matmul import int4_matmul
    from llark_tpu_torch.ops.int8_matmul import int8_matmul

    x, w = _wq_inputs(dev, 22, 6, 256, 128)
    x3 = x.reshape(2, 3, 256)
    w8, w4 = quant.quantize_weight(w), quant.quantize_weight_int4(w, 64)
    w4c = quant.quantize_weight_int4_cols(w, 64)
    bias = torch.ones(128, device=dev)
    counts = lambda: (int8_matmul.launches, int4_matmul.launches)  # noqa: E731
    n8, n4 = counts()
    y8 = quant.quantized_dense(x3, w8, bias, torch.bfloat16)
    y4 = quant.quantized_dense_int4(x3, w4, bias, torch.bfloat16)
    assert counts() == (n8 + 1, n4 + 1)
    assert tuple(y8.shape) == (2, 3, 128) and y8.dtype == torch.bfloat16
    # the same leaves through the plain versions: no launch, same values
    from llark_tpu_torch.ops.int4_matmul import _int4_matmul_plain
    from llark_tpu_torch.ops.int8_matmul import _int8_matmul_plain

    p8 = (_int8_matmul_plain(x, w8["q"], w8["scale"]) + bias.to(x.dtype)).reshape(2, 3, 128)
    p4 = (_int4_matmul_plain(x, w4["q4"], w4["scale"]) + bias.to(x.dtype)).reshape(2, 3, 128)
    pc = quant.quantized_dense_int4(x3, w4c, bias, torch.bfloat16)
    stacked = {k: t[None] for k, t in w8.items()}
    ps = quant.quantized_dense(x3[:1], stacked, None, torch.bfloat16)
    assert counts() == (n8 + 1, n4 + 1)
    assert _rel_to_max(y8, p8) <= 2e-2 and _rel_to_max(y4, p4) <= 2e-2
    assert _rel_to_max(pc, p4) <= 2e-2
    assert tuple(ps.shape) == (1, 3, 128)
    # a supported shape with another compute dtype is an error at both layers
    with pytest.raises(ValueError, match="bfloat16 activations"):
        quant.quantized_dense(x3.float(), w8, bias, torch.float32)
    with pytest.raises(ValueError, match="bfloat16 activations"):
        quant.quantized_dense_int4(x3.float(), w4, bias, torch.float32)
    with pytest.raises(ValueError, match="the CUDA kernel takes"):
        int8_matmul(x.float(), w8["q"], w8["scale"])
    # the group is read off the scale: a `group` that only matches h // group
    with pytest.raises(ValueError, match="does not divide"):
        int4_matmul(x, w4["q4"], w4["scale"], group=50)
    with pytest.raises(ValueError, match="the CUDA kernel takes"):
        int4_matmul(x, w4["q4"][:, :124], w4["scale"][:, :124], group=64)
    with pytest.raises(ValueError, match="aligned weight"):
        int8_matmul(x, torch.zeros(256 * 128 + 1, dtype=torch.int8, device=dev)[1:].view(256, 128),
                    w8["scale"])
    with pytest.raises(NotImplementedError, match="no gradient"):
        int8_matmul(x.clone().requires_grad_(), w8["q"], w8["scale"])
    assert counts() == (n8 + 1, n4 + 1)


@pytest.mark.parametrize("fmt", ["int8", "int4_rows", "int4_cols"])
def test_quantized_forward_on_the_card(dev, fmt):
    # a tiny bf16 model served from a quantized tree: the kernel route on the
    # card against the plain versions of the same tree on the CPU
    from llark_tpu_torch.config import ModelConfig
    from llark_tpu_torch.models import quant
    from llark_tpu_torch.models.decoder import decoder_forward
    from llark_tpu_torch.models.fusion import init_llark_params
    from llark_tpu_torch.ops.int4_matmul import int4_matmul
    from llark_tpu_torch.ops.int8_matmul import int8_matmul

    cfg = ModelConfig.tiny(dtype="bfloat16", param_dtype="bfloat16")
    params = init_llark_params(cfg, seed=3, device=dev)
    if fmt == "int8":
        params = quant.quantize_params_int8_incremental(cfg, params)
    else:
        params = quant.quantize_params_int4_incremental(cfg, params, group=32, layout=fmt[5:])
    ids = torch.from_numpy(np.random.RandomState(4).randint(4, 200, (2, 12))).to(dev)
    before = int8_matmul.launches, int4_matmul.launches
    with torch.no_grad():
        got, _ = decoder_forward(cfg, params, input_ids=ids)
        torch.cuda.synchronize()
        launched = (int8_matmul.launches - before[0], int4_matmul.launches - before[1])
        cpu = {k: ({n: ({a: b.cpu() for a, b in t.items()} if isinstance(t, dict) else t.cpu())
                    for n, t in v.items()} if isinstance(v, dict) else v.cpu())
               for k, v in params.items()}
        want, _ = decoder_forward(cfg, cpu, input_ids=ids.cpu())
    per_forward = 7 * cfg.num_layers
    assert launched == {"int8": (per_forward, 0), "int4_rows": (0, per_forward),
                        "int4_cols": (0, 0)}[fmt]
    assert bool(torch.isfinite(got).all())
    assert _rel_to_max(got.cpu(), want) <= 5e-2
