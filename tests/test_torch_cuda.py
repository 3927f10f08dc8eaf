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

The backward kernels (dq, dk/dv) are held as chip_smoke.py holds them:
per row within 1e-2 with each row's norm floored at 1e-2 of the tensor's
RMS row norm (a dq row can be ~0 by cancellation), and within the JAX
package's 1.6e-2 relative to max (PERFORMANCE.md:130-132). The forward's
log-sum-exp is fp32 and held to 1e-4 absolute.
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
    out, lse = tattn.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    _, lse_plain = tattn._flash_attention_fwd_plain(q, k, v, return_lse=True, **kw)
    assert float((lse - lse_plain).abs().max()) <= LSE_TOL
    delta = (do.float() * out.float()).sum(-1)
    before = (tattn.flash_attention_bwd_dq.launches, tattn.flash_attention_bwd_dkv.launches)
    dq = tattn.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = tattn.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (tattn.flash_attention_bwd_dq.launches, tattn.flash_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = tattn._flash_bwd_plain(q, k, v, do, lse, delta, **kw)
    for got, ref in zip((dq, dk, dv), want):
        assert _row_err(got, ref, BWD_ROW_FLOOR) <= ROW_TOL["flash_bwd"]
        assert _rel_to_max(got, ref) <= BWD_TOL
    # the row with no live key: no gradient anywhere; dead keys get zeros
    assert float(dq[0].abs().max()) == 0.0 and float(dk[0].abs().max()) == 0.0
    assert float(dk[2, :, 130:].abs().max()) == 0.0 and float(dv[2, :, 130:].abs().max()) == 0.0


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
