"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA GPU and skips without one. The file imports
nothing of JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py pins JAX to the CPU.)

Tolerance, for bf16 inputs with both outputs rounded to bf16: the worst
query row's |kernel - plain| / |plain| (L2 over the head dim) stays within
ROW_TOL, the limits of chip_smoke.py: about one bf16 ulp (2**-8 relative)
above the errors its cases read on an H100 (4.9e-3 prefill, 1.6e-3 decode;
PERF.md). The prefill kernel rounds the probabilities to bf16 for the P.V
product, the decode kernel keeps them to about fp32 precision (a bf16 high
part and the bf16 rest), and both sum in another order than the plain
versions, which compute in fp32. A row with no live key must be zeros.

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

Two cases drive checkpoint I/O on the card: an HF import from bf16
safetensors shards must hold the bits of the import onto the CPU, and the
WebDataset CLI must write the CSV rows of the in-process run, launching
the flash kernels as the path runs them.

The CLAP encoder path (mel frontend, HTSAT) runs no hand-written kernel
(cuFFT and cuBLAS in fp32, no TF32): on the card it is held against the
CPU plain path: the unit-norm embedding within CLAP_TOL absolute
(chip_smoke.py phase 20's gate; fp32 reads 7e-8 to 8e-8 there, TF32
products 1.6e-4), the raw HTSAT-base embedding within HTSAT_TOL relative
to max (fp32 5.0e-7, TF32 8.3e-4; `python -m
llark_tpu_torch.tools.clap_precision` reads both). Each limit sits between
the two readings, and a control case holds TF32 above HTSAT_TOL.

The Mixture-of-Experts path runs the same kernels at Mixtral's attention
shapes (32 query heads over 8 KV heads, head_dim 128), each case beside a
control over rolled KV heads that must fail its gate; its expert products
are cuBLAS GEMMs (float stacks) or one int8 kernel launch a product per
expert (int8 stacks). One fp32 MoE block on the card must lie within
MOE_TOL of the CPU plain path, and with TF32 products outside it.

The Jukebox encoder runs no hand-written kernel either (cuDNN convolutions
and cuBLAS products): the parity fixture's mid-size Jukebox, imported on
the card in fp32, must give the goldens' codes exactly and activations and
pooled embeddings within JUKEBOX_GOLD_ATOL (the JAX package's bar,
chip_smoke.py phase 21 (a)); the same with TF32 products must fail it.
"""

import contextlib

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
WINDOW_TOL = 1e-4
CLAP_TOL = 1e-6
HTSAT_TOL = 5e-6
JUKEBOX_GOLD_ATOL = 1e-6

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


def _qkv(dev, seed, b, h, hkv, sq, sk, d, dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    return tuple(
        torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
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


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("alibi", [False, True], ids=["plain", "alibi"])
@pytest.mark.parametrize("group", [1, 4, 8], ids=["group1", "group4", "group8"])
@pytest.mark.parametrize("h", [8, 64], ids=["one_warpgroup_blocks", "two_warpgroup_blocks"])
def test_flash_fwd_kernel_lengths_groups_and_lse(dev, d, alibi, group, h):
    # Sq = Sk = 200 is no multiple of the 64- or 128-row query block or the
    # 64-key tile; kv_len 0 and 1, and 129 and 200, whose keys span three
    # and four tiles of the two-stage K/V ring. 8 heads give 64 blocks of
    # 128 rows, fewer than the card's SMs, so the kernel runs blocks of one
    # warpgroup; 64 heads give 512 and blocks of two
    b, s = 4, 200
    hkv = h // group
    q, k, v = _qkv(dev, 13, b, h, hkv, s, s, d)
    kw = dict(causal=True, kv_lengths=torch.tensor([0, 1, 129, 200], device=dev),
              slopes=tattn.alibi_slopes(h, dev) if alibi else None)
    got, lse = tattn.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    again, lse_again = tattn.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    want, lse_want = tattn._flash_attention_fwd_plain(q, k, v, return_lse=True, **kw)
    assert _row_err(got, want) <= ROW_TOL["flash_fwd"]
    assert float((lse - lse_want).abs().max()) <= LSE_TOL
    assert float(got[0].abs().max()) == 0.0  # kv_len 0: no key
    # no atomics: two launches on the same inputs agree bit for bit
    assert torch.equal(got, again) and torch.equal(lse, lse_again)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_fwd_kernel_noncausal_strided_lse(dev, d):
    # q/k/v read in place as transposed views of [B, S, H, D]; Sk > Sq,
    # neither a multiple of 64; GQA group 2 with ALiBi
    b, h, hkv, sq, sk = 2, 4, 2, 70, 150
    rng = np.random.RandomState(14)
    q, k, v = (
        torch.from_numpy(rng.randn(b, n, heads, d).astype(np.float32)).to(dev, torch.bfloat16)
        .transpose(1, 2) for n, heads in ((sq, h), (sk, hkv), (sk, hkv))
    )
    kw = dict(causal=False, kv_lengths=torch.tensor([150, 65], device=dev),
              slopes=tattn.alibi_slopes(h, dev))
    got, lse = tattn.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    want, lse_want = tattn._flash_attention_fwd_plain(q, k, v, return_lse=True, **kw)
    assert _row_err(got, want) <= ROW_TOL["flash_fwd"]
    assert float((lse - lse_want).abs().max()) <= LSE_TOL


@pytest.mark.parametrize("grad", [False, True], ids=["serving", "training"])
@pytest.mark.parametrize("d,dtype", [(96, torch.bfloat16), (128, torch.float32)],
                         ids=["d96_bf16", "d128_fp32"])
def test_multihead_attention_routes_by_head_dim(dev, d, dtype, grad):
    # the dispatcher routes by head_dim alone, as the reference does: a query
    # of head_dim 96 answers through xla_attention; an fp32 query of
    # head_dim 128 reaches the kernels (K1, and K3+K4 for its gradients),
    # which round q, k, v (and dO) to bf16 for the products and answer in
    # fp32: held against the fp32 plain path at the bf16 kernels' gates
    b, h, hkv, s = 2, 4, 2, 40
    q, k, v = (t.requires_grad_(grad) for t in _qkv(dev, 15, b, h, hkv, s, s, d, dtype))
    kw = dict(causal=True, kv_lengths=torch.tensor([40, 17], device=dev))
    before = tattn.flash_attention_fwd.launches, tattn.flash_attention_bwd.launches
    got = tattn.multihead_attention(q, k, v, **kw)
    want = tattn.xla_attention(q, k, v, **kw)
    g = torch.from_numpy(np.random.RandomState(16).randn(*got.shape).astype(np.float32)).to(dev, dtype)
    if dtype == torch.float32:
        assert got.dtype == torch.float32
        assert tattn.flash_attention_fwd.launches == before[0] + 1
        assert _row_err(got, want) <= ROW_TOL["flash_fwd"]
        if grad:
            got_grads = torch.autograd.grad(got, (q, k, v), g)
            torch.cuda.synchronize()
            assert tattn.flash_attention_bwd.launches == before[1] + 1
            rounded = _bwd_plain_on_rounded_operands(q, k, v, g, kw)
            for a, w, r in zip(got_grads, torch.autograd.grad(want, (q, k, v), g), rounded):
                assert a.dtype == torch.float32
                assert _row_err(a, r, BWD_ROW_FLOOR) <= ROW_TOL["flash_bwd"]
                assert _rel_to_max(a, w) <= BWD_TOL
        return
    assert tattn.flash_attention_fwd.launches == before[0]
    assert _row_err(got, want) <= ROW_TOL["flash_decode"]
    if grad:
        got_grads = torch.autograd.grad(got, (q, k, v), g)
        want_grads = torch.autograd.grad(want, (q, k, v), g)
        for a, w in zip(got_grads, want_grads):
            assert _rel_to_max(a, w) <= 1e-3


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("d,dtype", [(96, torch.bfloat16), (128, torch.float32)],
                         ids=["d96_bf16", "d128_fp32"])
def test_decode_attention_routes_by_head_dim(dev, d, dtype, paged):
    # head_dim 96 answers through xla_attention; an fp32 query of head_dim
    # 128 with an fp32 cache launches the kernel, which reads both as they
    # are (fp32 dots), in its own cache mode
    b, h, hkv, sq, bs, n_blocks = 2, 4, 2, 3, 16, 4
    q, k, v = _qkv(dev, 16, b, h, hkv, sq, bs * n_blocks, d, dtype)
    kv_lengths = torch.tensor([50, 20], device=dev)
    kw = dict(kv_lengths=kv_lengths, q_positions=kv_lengths - sq)
    before = tdec.flash_decode_attention.launches
    mode = ("paged_" if paged else "dense_") + "fp32"
    by_mode = tdec.flash_decode_attention.launches_by_mode[mode]
    if paged:
        # both rows' blocks shuffled in one pool; the tables point at them
        pool_k = k.reshape(b, hkv, n_blocks, bs, d).permute(0, 2, 1, 3, 4).reshape(-1, hkv, bs, d)
        pool_v = v.reshape(b, hkv, n_blocks, bs, d).permute(0, 2, 1, 3, 4).reshape(-1, hkv, bs, d)
        order = torch.randperm(b * n_blocks, generator=torch.Generator().manual_seed(0))
        inverse = torch.argsort(order).to(dev)
        tables = inverse.reshape(b, n_blocks).to(torch.int32)
        got = tdec.decode_attention(q, pool_k[order.to(dev)], pool_v[order.to(dev)],
                                    block_tables=tables, **kw)
    else:
        got = tdec.decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    fp32 = dtype == torch.float32
    assert got.dtype == dtype
    assert tdec.flash_decode_attention.launches == before + int(fp32)
    assert tdec.flash_decode_attention.launches_by_mode[mode] == by_mode + int(fp32)
    want = tattn.xla_attention(q, k, v, causal=True, kv_lengths=kv_lengths,
                               q_offset=kv_lengths - sq)
    assert _row_err(got, want) <= ROW_TOL["flash_decode"]


# (heads, kv heads, query window): group x window = 1, 5, 8, 17 and 40 query
# rows a kv head, padded to one or two 16-row tiles of the kernel's products
# (40: two blocks of at most 32 rows)
DECODE_ROWS = [(8, 8, 1), (8, 8, 5), (8, 1, 1), (8, 8, 17), (16, 2, 5)]
DECODE_ROW_IDS = ["rows1", "rows5", "rows8", "rows17", "rows40"]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,hkv,sq", DECODE_ROWS, ids=DECODE_ROW_IDS)
@pytest.mark.parametrize("alibi", [False, True], ids=["plain", "alibi"])
@pytest.mark.parametrize("back", [0, 70], ids=["window_at_end", "window_70_back"])
def test_flash_decode_kernel_matches_plain(dev, d, h, hkv, sq, alibi, back):
    # live lengths 0 (a row that sees nothing), 1, 300 (ending mid-tile) and
    # the whole cache; with the window 70 positions back from the live end,
    # a live 64-key split lies wholly past every query of a window (Sq > 1)
    b, s = 4, 512
    q, k, v = _qkv(dev, 10, b, h, hkv, sq, s, d)
    kv_lengths = torch.tensor([0, 1, 300, 512], device=dev)
    q_positions = kv_lengths - sq - back
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


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("hkv,alibi", [(8, False), (2, True)])
@pytest.mark.parametrize("zero_scales", [False, True], ids=["scaled", "zero_scales"])
def test_flash_decode_kernel_int8_matches_plain(dev, d, sq, hkv, alibi, zero_scales):
    # the dense int8 cache: both sides dequantize the same int8 values and
    # scales in fp32; with zero_scales some live positions have K and V
    # scales of 0 (scores of 0, no share in the output)
    b, h, s = 3, 8, 512
    q, k, v = _qkv(dev, 18, b, h, hkv, sq, s, d)
    (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
    if zero_scales:
        ks[:, :, 40:100] = 0.0
        vs[:, :, 90:150] = 0.0
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


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bs", [16, 64, 128])
@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_flash_decode_kernel_paged_matches_plain(dev, d, bs, sq, quant):
    # GQA 4 + ALiBi over a pool whose blocks are scattered: each row's
    # table is a random permutation of pool blocks, so a 64-position split
    # spans several blocks (bs 16), one (bs 64) or half of one (bs 128);
    # live lengths 0, 1, 300 (mid-tile and mid-block) and the whole span
    b, h, hkv, span = 4, 8, 2, 512
    max_blocks = span // bs
    n_blocks = b + b * max_blocks  # parking blocks first, as the server lays them out
    rng = np.random.RandomState(19 + bs)
    q = torch.from_numpy(rng.randn(b, h, sq, d).astype(np.float32)).to(dev, torch.bfloat16)
    k = torch.from_numpy(rng.randn(n_blocks, hkv, bs, d).astype(np.float32)).to(dev, torch.bfloat16)
    v = torch.from_numpy(rng.randn(n_blocks, hkv, bs, d).astype(np.float32)).to(dev, torch.bfloat16)
    perm = rng.permutation(np.arange(b, n_blocks)).reshape(b, max_blocks).astype(np.int32)
    tables = torch.from_numpy(perm).to(dev)
    kv_lengths = torch.tensor([0, 1, 300, 512], device=dev)
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


@pytest.mark.parametrize("mode", ["dense_bf16", "paged_int8"])
def test_flash_decode_replays_in_a_cuda_graph(dev, mode):
    # the kernel's grid and scratch follow from shapes alone, and the
    # wrapper reads nothing back to the host: one call captured on static
    # buffers, then live lengths, query positions and block tables changed
    # in place, must replay bit for bit as an eager call on the same buffers
    b, h, hkv, sq, d, bs, span = 4, 8, 2, 3, 128, 16, 512
    rng = np.random.RandomState(22)

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, torch.bfloat16)

    q = randn(b, h, sq, d)
    kv_lengths = torch.tensor([5, 64, 300, 512], dtype=torch.int32, device=dev)
    q_positions = kv_lengths - sq
    kw = dict(kv_lengths=kv_lengths, q_positions=q_positions, slopes=tattn.alibi_slopes(h, dev))
    n_blocks = b * span // bs
    tables = None
    if mode == "paged_int8":
        (k, kw["k_scale"]), (v, kw["v_scale"]) = (_quantize_kv(randn(n_blocks, hkv, bs, d))
                                                  for _ in range(2))
        tables = torch.from_numpy(rng.permutation(n_blocks).reshape(b, -1).astype(np.int32)).to(dev)
        kw["block_tables"] = tables
    else:
        k, v = randn(b, hkv, span, d), randn(b, hkv, span, d)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # load the library before capture
        tdec.flash_decode_attention(q, k, v, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tdec.flash_decode_attention(q, k, v, **kw)
    for lengths in ([1, 300, 77, 0], [512, 129, 64, 2]):
        kv_lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
        q_positions.copy_(kv_lengths - sq)
        if tables is not None:
            tables.copy_(torch.from_numpy(
                rng.permutation(n_blocks).reshape(b, -1).astype(np.int32)))
        graph.replay()
        want = tdec.flash_decode_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        plain = tdec._flash_decode_plain(
            q, k, v, k_scale=kw.get("k_scale"), v_scale=kw.get("v_scale"),
            **{n: kw.get(n) for n in ("kv_lengths", "q_positions", "slopes", "block_tables")})
        assert _row_err(out, plain) <= ROW_TOL["flash_decode"]


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
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        x = torch.zeros((1, 4, 8, 128), dtype=torch.float16, device=dev)
        tattn.flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="bfloat16 or float32 q"):
        tdec.flash_decode_attention(q.half(), kb, kb, kv_lengths=lengths)


def _rel_to_max(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _bwd_plain_on_rounded_operands(q, k, v, do, kw):
    """The flash backward's plain version (fp32) on fp32 q, k, v, dO rounded
    to bf16 as the kernels round them for their products, with the kernel
    forward's fp32 output and log-sum-exp, as the backward reads them. The
    per-row gate holds fp32 gradients against this: the rounding alone moves
    a dq row near cancellation by up to 8.5e-2 of its norm against the plain
    version on the unrounded operands (PERF.md), so against those the fp32
    path is held relative to max (BWD_TOL)."""
    with torch.no_grad():
        out, lse = tattn.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        qr, kr, vr, dr = (t.detach().to(torch.bfloat16).float() for t in (q, k, v, do))
        return tattn._flash_bwd_plain(qr, kr, vr, dr, lse, tattn._flash_bwd_delta(out, dr),
                                      causal=kw.get("causal", True), kv_lengths=kw.get("kv_lengths"),
                                      slopes=kw.get("slopes"))


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


def _wq_inputs(dev, seed, m, k, n, dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.randn(k, n) * 0.02).astype(np.float32)).to(dev)
    return x, w


# M: a decode step of one request and of 8 slots, both sides of each switch
# of the kernel's tiles (8 | 9: the decode token tile of 8 or 16; 16 | 17:
# decode to admission; 64 | 65: int8's admission token tile of 64 or 128;
# 128 | 129 a token tile's edge), a ragged prefill and chunked admission;
# (K, N, group): a ragged N (8 * 125: no multiple of the 128- or 256-channel
# tile, rows copied in 8-byte pieces), a Llama-2-7B projection, and a K that
# is no multiple of either ring stage depth (64, 128 rows) with int4 groups
# of 80 rows that end inside a stage. fp32 activations launch the same
# kernels (rounded to bf16 as they are staged) and are held against the
# fp32 plain version.
@pytest.mark.parametrize("m", [1, 8, 9, 16, 17, 64, 65, 129, 293, 2048])
@pytest.mark.parametrize("k,n,group", [(256, 1000, 128), (4096, 4096, 128), (1040, 512, 80)])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_quantized_matmul_kernels_match_plain(dev, fmt, k, n, group, m, dtype):
    from llark_tpu_torch.models import quant
    from llark_tpu_torch.ops import int4_matmul as tint4
    from llark_tpu_torch.ops import int8_matmul as tint8

    x, w = _wq_inputs(dev, 21, m, k, n, dtype)
    if fmt == "int8":
        wq = quant.quantize_weight(w)
        fn, before = tint8.int8_matmul, tint8.int8_matmul.launches
        got = fn(x, wq["q"], wq["scale"])
        again = fn(x, wq["q"], wq["scale"])
        want = tint8._int8_matmul_plain(x, wq["q"], wq["scale"])
    else:
        wq = quant.quantize_weight_int4(w, group)
        fn, before = tint4.int4_matmul, tint4.int4_matmul.launches
        got = fn(x, wq["q4"], wq["scale"], group=group)
        again = fn(x, wq["q4"], wq["scale"], group=group)
        want = tint4._int4_matmul_plain(x, wq["q4"], wq["scale"])
    torch.cuda.synchronize()
    assert fn.launches == before + 2  # one launch a product
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    assert _row_err(got, want) <= WQ_ROW_TOL[fmt + "_matmul"]
    assert _rel_to_max(got, want) <= 2e-2
    assert torch.equal(got, again)  # split sums are combined in a fixed order


def test_quantized_dispatch_on_the_card(dev):
    # a 2-D leaf inside the contract launches its kernel, in bf16 or fp32; a
    # stacked leaf and the cols layout take the plain expression; a float16
    # compute dtype and a direct call outside the contract raise; under
    # autograd the forward launches the kernel once and dx comes back
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
    # an fp32 compute dtype launches the same kernels and answers in fp32,
    # against the fp32 plain versions; float16 is an error at both layers
    y8f = quant.quantized_dense(x3.float(), w8, bias, torch.float32)
    y4f = quant.quantized_dense_int4(x3.float(), w4, bias, torch.float32)
    assert counts() == (n8 + 2, n4 + 2)
    assert y8f.dtype == torch.float32 and y4f.dtype == torch.float32
    p8f = (_int8_matmul_plain(x.float(), w8["q"], w8["scale"]) + bias).reshape(2, 3, 128)
    p4f = (_int4_matmul_plain(x.float(), w4["q4"], w4["scale"]) + bias).reshape(2, 3, 128)
    assert _rel_to_max(y8f, p8f) <= 2e-2 and _rel_to_max(y4f, p4f) <= 2e-2
    with pytest.raises(ValueError, match="bfloat16 or float32 activations"):
        quant.quantized_dense(x3.half(), w8, bias, torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32 activations"):
        quant.quantized_dense_int4(x3.half(), w4, bias, torch.float16)
    with pytest.raises(ValueError, match="the CUDA kernel takes"):
        int8_matmul(x.half(), w8["q"], w8["scale"])
    # the group is read off the scale: a `group` that only matches h // group
    with pytest.raises(ValueError, match="does not divide"):
        int4_matmul(x, w4["q4"], w4["scale"], group=50)
    with pytest.raises(ValueError, match="the CUDA kernel takes"):
        int4_matmul(x, w4["q4"][:, :124], w4["scale"][:, :124], group=64)
    with pytest.raises(ValueError, match="aligned weight"):
        int8_matmul(x, torch.zeros(256 * 128 + 1, dtype=torch.int8, device=dev)[1:].view(256, 128),
                    w8["scale"])
    xg = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(int8_matmul(xg, w8["q"], w8["scale"]).float().sum(), [xg])
    assert counts() == (n8 + 3, n4 + 2)
    assert dx.dtype == torch.bfloat16 and tuple(dx.shape) == tuple(x.shape)


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


# ---------------------------------------------------------------------------
# QLoRA: dx through the quantized products, LoRA on the card, remat policies
# ---------------------------------------------------------------------------


# dx of the quantized products goes through one plain product on a converted
# copy of the weight (as the JAX package's XLA derivative does), the same
# expression autograd takes through the plain version: held per row to the
# int8 product's gate
@pytest.mark.parametrize("m", [8, 1024])
@pytest.mark.parametrize("k,n", [(4096, 11008), (11008, 4096)])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantized_products_dx_match_plain_autograd(dev, fmt, k, n, m):
    from llark_tpu_torch.models import quant
    from llark_tpu_torch.ops import int4_matmul as tint4
    from llark_tpu_torch.ops import int8_matmul as tint8

    x, w = _wq_inputs(dev, 23, m, k, n)
    g = torch.from_numpy(np.random.RandomState(24).randn(m, n).astype(np.float32)).to(dev, torch.bfloat16)
    if fmt == "int8":
        wq = quant.quantize_weight(w)
        fn = tint8.int8_matmul
        call = lambda x: fn(x, wq["q"], wq["scale"])  # noqa: E731
        plain = lambda x: tint8._int8_matmul_plain(x, wq["q"], wq["scale"])  # noqa: E731
    else:
        wq = quant.quantize_weight_int4(w, 128)
        fn = tint4.int4_matmul
        call = lambda x: fn(x, wq["q4"], wq["scale"], group=128)  # noqa: E731
        plain = lambda x: tint4._int4_matmul_plain(x, wq["q4"], wq["scale"])  # noqa: E731
    before = fn.launches
    xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    yk = call(xk)
    (got,) = torch.autograd.grad(yk, [xk], g)
    torch.cuda.synchronize()
    assert fn.launches == before + 1  # the forward's kernel; dx launches none
    (want,) = torch.autograd.grad(plain(xp), [xp], g)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, k)
    assert _row_err(got, want) <= WQ_ROW_TOL["int8_matmul"]
    assert _row_err(yk.detach(), plain(x)) <= WQ_ROW_TOL[fmt + "_matmul"]


@pytest.mark.parametrize("base", ["float", "int8"])
def test_lora_dense_on_the_card_matches_the_cpu(dev, base):
    # one projection with rank-64 factors at Llama-2-7B width, bf16 on the
    # card (the int8 kernel for the base product) against the same call in
    # fp32 on the CPU; dropout masks drawn from the same seed on each device
    # differ, so it runs without dropout
    from llark_tpu_torch.config import ModelConfig
    from llark_tpu_torch.models import quant
    from llark_tpu_torch.models.decoder import _lora_dense

    cfg = ModelConfig.llama2_7b(lora_rank=64, lora_alpha=16.0)
    rng = np.random.RandomState(25)
    lp = {"w_up": torch.from_numpy((rng.randn(4096, 11008) * 0.02).astype(np.float32)),
          "w_up_lora_a": torch.from_numpy((rng.randn(4096, 64) / 64).astype(np.float32)),
          "w_up_lora_b": torch.from_numpy((rng.randn(64, 11008) * 0.02).astype(np.float32))}
    if base == "int8":
        lp["w_up"] = quant.quantize_weight(lp["w_up"])
    x = torch.from_numpy(rng.randn(2, 16, 4096).astype(np.float32))
    on_card = {k: ({a: b.to(dev) for a, b in v.items()} if isinstance(v, dict) else v.to(dev))
               for k, v in lp.items()}
    got = _lora_dense(cfg, on_card, "w_up", x.to(dev, torch.bfloat16), torch.bfloat16, None)
    want = _lora_dense(cfg, lp, "w_up", x, torch.float32, None)
    assert got.dtype == torch.bfloat16
    assert _rel_to_max(got.float().cpu(), want) <= 2e-2
    assert _row_err(got, want) <= 2e-2


@pytest.mark.parametrize("policy", ["full", "dots", "dots_narrow"])
def test_remat_policies_on_an_int8_base(dev, policy):
    # a tiny bf16 model with an int8 base and LoRA factors: under "dots" no
    # K5 launches in the recompute (the operator's output is kept), under
    # "full" each product launches again; "dots_narrow" (intermediate 256 >
    # 3 x hidden 64) recomputes the gate and up projections; the gradients
    # agree with the policy-free reference within bf16 rounding
    import dataclasses

    from llark_tpu_torch.config import ModelConfig
    from llark_tpu_torch.models import lora, quant
    from llark_tpu_torch.models.decoder import decoder_forward
    from llark_tpu_torch.models.fusion import init_llark_params
    from llark_tpu_torch.ops.int8_matmul import int8_matmul

    cfg = ModelConfig.tiny(dtype="bfloat16", intermediate_size=256, lora_rank=8, lora_dropout=0.05)
    params = init_llark_params(cfg, seed=3, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    params = lora.init_lora_params(cfg, gen, params)
    for k in lora.lora_keys(params):
        if k.endswith("_lora_b"):
            params["layers"][k].normal_(0.0, 0.05, generator=gen)
    params = quant.quantize_params_int8_incremental(cfg, params)
    leaves = [params["layers"][k].requires_grad_() for k in lora.lora_keys(params)]
    ids = torch.from_numpy(np.random.RandomState(5).randint(4, 200, (2, 32))).to(dev)

    def grads(c):
        logits, _ = decoder_forward(c, params, input_ids=ids, dropout_seed=9)
        return torch.autograd.grad(logits.float().square().mean(), leaves)

    want = grads(cfg)  # no recompute
    before = int8_matmul.launches
    got = grads(dataclasses.replace(cfg, remat=True, remat_policy=policy))
    torch.cuda.synchronize()
    per_forward = 7 * cfg.num_layers
    recomputed = {"full": per_forward, "dots": 0, "dots_narrow": 2 * cfg.num_layers}[policy]
    assert int8_matmul.launches - before == per_forward + recomputed
    for a, b in zip(got, want):
        assert _rel_to_max(a.float(), b.float()) <= 1e-2


def _write_safetensors(path, tensors):
    # the format itself, as chip_smoke.py writes it (the port needs no
    # package): the header's length as 8 little-endian bytes, a JSON
    # header, then the raw data
    import json
    import struct

    names = {torch.float32: "F32", torch.bfloat16: "BF16"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.uint8).numpy().tobytes())


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
def test_load_pretrained_backbone_onto_the_card(dev, tmp_path, param_dtype):
    # bf16 safetensors shards with an index, imported onto the card: the
    # same bits as the import onto the CPU
    import json

    from llark_tpu_torch.config import ModelConfig
    from llark_tpu_torch.interop import hf
    from llark_tpu_torch.models.fusion import init_llark_params

    cfg = ModelConfig.tiny(num_kv_heads=2, param_dtype=param_dtype)
    sd = hf.hf_state_dict_from_params(cfg, init_llark_params(cfg, seed=5, device="cpu"))
    keys = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": keys[::2],
              "model-00002-of-00002.safetensors": keys[1::2]}
    for fname, part in shards.items():
        _write_safetensors(tmp_path / fname, {k: sd[k].to(torch.bfloat16) for k in part})
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"weight_map": {k: fn for fn, ks in shards.items() for k in ks}}))
    got = hf.load_pretrained_backbone(str(tmp_path), cfg, device=dev)
    want = hf.load_pretrained_backbone(str(tmp_path), cfg, device="cpu")
    flat = [(k, v) for k, v in want.items() if k != "layers"] + [
        (f"layers/{k}", v) for k, v in want["layers"].items()]
    for name, w in flat:
        g = got["layers"][name[7:]] if name.startswith("layers/") else got[name]
        assert g.device.type == "cuda" and g.dtype == w.dtype, name
        assert torch.equal(g.cpu(), w), name


@pytest.mark.parametrize("mode", ["one_at_a_time", "engine_paged_int8"])
def test_from_webdataset_on_the_card(dev, tmp_path, mode):
    # a 2-layer model of head_dim 128 trained one step on the card, served
    # by the WebDataset CLI: the flash-prefill kernel once per layer per
    # request one at a time, flash decode in the run's cache mode, and the
    # CSV rows those of the in-process run
    import csv
    import dataclasses
    import json

    from llark_tpu_torch.config import DataArguments, ModelArguments, ModelConfig
    from llark_tpu_torch.config import TrainingArguments
    from llark_tpu_torch.data.webdataset import TarShardWriter
    from llark_tpu_torch.generate import GenerationConfig, Generator
    from llark_tpu_torch.infer import batch_infer, batch_infer_continuous
    from llark_tpu_torch.inference import from_webdataset
    from llark_tpu_torch.models.utils import load_pretrained_model
    from llark_tpu_torch.train.train import train

    cfg = ModelConfig.tiny(hidden_size=256, intermediate_size=512, num_heads=2, num_kv_heads=2,
                           mm_hidden_size=16, use_pallas_attention=True)
    rng = np.random.RandomState(8)
    writer = TarShardWriter(str(tmp_path / "mir-train-%05d.tar"), max_count=10)
    for i in range(2):
        writer.write({"__key__": f"t{i}", "json": {"response": [
            {"question": "what is the tempo ?", "answer": "slow ."}]},
            "audio_encoding.pyd": rng.randn(4, 16).astype(np.float32)})
    writer.close()
    run = tmp_path / "run"
    train(ModelArguments(model_name_or_path="tiny", mm_hidden_size=16),
          DataArguments(train_data_path=writer.written_paths[0], max_audio_frames=4,
                        task_sample_probs={"mir": 1.0}),
          TrainingArguments(output_dir=str(run), per_device_train_batch_size=2,
                            model_max_length=64, max_steps=1, save_steps=1, seed=0),
          model_cfg=cfg, device=dev)
    meta = json.loads((run / "model_config.json").read_text())
    meta["model_config"]["use_flash_decode"] = True  # the serving configuration's switch
    (run / "model_config.json").write_text(json.dumps(meta))
    writer = TarShardWriter(str(tmp_path / "eval-%05d.tar"), max_count=10)
    for i in range(3):
        writer.write({"__key__": f"clip{i}-start30_000-end60_000", "json": {"response": [
            {"question": "what is the tempo ?"}]},
            "audio_encoding.npy": rng.randn(4 + i, 16).astype(np.float32)})
    writer.close()
    flags = [] if mode == "one_at_a_time" else [
        "--continuous-batching", "2", "--kv-block-size", "16", "--kv-cache-int8",
        "--prefill-chunk", "64"]
    tattn.flash_attention_fwd.launches = 0
    tdec.reset_launch_counts()
    out = tmp_path / "out.csv"
    from_webdataset.main(["--checkpoint-dir", str(run), "--input", writer.written_paths[0],
                          "--output", str(out), "--max-new-tokens", "6", "--max-cache-len",
                          "256", *flags])
    torch.cuda.synchronize()
    k1 = tattn.flash_attention_fwd.launches
    k2 = {k: v for k, v in tdec.flash_decode_attention.launches_by_mode.items() if v}
    with open(out, newline="") as f:
        got = list(csv.DictReader(f))
    assert [r["example_id"] for r in got] == [f"clip{i}-start30.000-end60.000" for i in range(3)]
    run_cfg, params, bundle = load_pretrained_model(str(run), device=dev)
    rows = list(from_webdataset.iter_eval_rows(writer.written_paths))
    gen_cfg = GenerationConfig(max_new_tokens=6, temperature=0.0, stop_text="###")
    if mode == "one_at_a_time":
        assert k1 == cfg.num_layers * 3 and set(k2) == {"dense_bf16"}, (k1, k2)
        want = batch_infer(rows, Generator(run_cfg, params, bundle.audio_patch_id, gen_cfg,
                                           max_cache_len=256, device=dev), bundle)
    else:
        assert set(k2) == {"paged_int8"}, k2
        want = batch_infer_continuous(
            rows, dataclasses.replace(run_cfg, kv_cache_quant=True), params, bundle,
            gen_cfg=gen_cfg, max_batch=2, max_cache_len=256, kv_block_size=16,
            prefill_chunk=64, device=dev)
    assert got == [{k: str(v) for k, v in r.items()} for r in want]


# ---------------------------------------------------------------------------
# speculative verify windows and beam reorders on the card
# ---------------------------------------------------------------------------


def _window_model(dev, quant):
    """A 2-layer bf16 Llama at the flash-decode kernel's head_dim (128),
    GQA 2:1, flash decode on, and a batch of 3 rows' KV history: a dense
    bf16 cache, or (quant) a paged int8 pool of 16-position blocks whose
    tables are scattered over the pool."""
    from llark_tpu_torch.config import ModelConfig
    from llark_tpu_torch.models.decoder import init_kv_cache, init_paged_kv_cache
    from llark_tpu_torch.models.fusion import init_llark_params

    cfg = ModelConfig.tiny(dtype="bfloat16", param_dtype="bfloat16", hidden_size=256,
                           intermediate_size=512, num_heads=2, num_kv_heads=1,
                           use_flash_decode=True, kv_cache_quant=quant)
    params = init_llark_params(cfg, seed=5, device=dev)
    rng = np.random.RandomState(6)
    if quant:
        n_blocks, max_blocks = 3 * 4 + 3, 4
        cache = init_paged_kv_cache(cfg, 3, n_blocks, 16, max_blocks, device=dev)
        perm = rng.permutation(np.arange(3, n_blocks))[: 3 * max_blocks]
        cache["block_tables"] = torch.from_numpy(
            perm.reshape(3, max_blocks).astype(np.int32)).to(dev)
    else:
        cache = init_kv_cache(cfg, 3, 64, device=dev)
    for name in ("k", "v"):
        x = torch.from_numpy(rng.randn(*cache[name].shape).astype(np.float32)).to(dev)
        if quant:
            cache[name], cache[name + "_scale"] = _quantize_kv(x)
        else:
            cache[name] = x.to(torch.bfloat16)
    return cfg, params, cache


def _clone_cache(cache):
    return {k: v.clone() if torch.is_tensor(v) else v for k, v in cache.items()}


@pytest.mark.parametrize("quant", [False, True], ids=["dense_bf16", "paged_int8"])
def test_verify_window_through_k2_matches_sequential_steps(dev, quant):
    # a gamma = 4 verify window over [last, d_1..d_4] launches K2 once a
    # layer at Sq = 5 and must give the logits of five single-token steps
    # through K2; then a second window at pos + 2 (one proposal accepted)
    # overwrites the rejected positions before any query attends them, so
    # it must give the logits of steps that never saw d_2..d_4. Row 1's
    # windows cross a 16-position block boundary. Held within WINDOW_TOL
    # relative to max.
    from llark_tpu_torch.generate import decode_step
    from llark_tpu_torch.models.decoder import decoder_forward

    cfg, params, cache = _window_model(dev, quant)
    mode = "paged_int8" if quant else "dense_bf16"
    rng = np.random.RandomState(7)
    first = torch.from_numpy(rng.randint(4, 200, (3, 5))).to(dev)
    second = torch.from_numpy(rng.randint(4, 200, (3, 5))).to(dev)
    pos = torch.tensor([5, 14, 30], dtype=torch.int32, device=dev)
    windows, steps = _clone_cache(cache), _clone_cache(cache)
    with torch.inference_mode():
        tdec.reset_launch_counts()
        w1 = decoder_forward(cfg, params, input_ids=first, kv_cache=windows,
                             cache_positions=pos)[0]
        w2 = decoder_forward(cfg, params, input_ids=second, kv_cache=windows,
                             cache_positions=pos + 2)[0]
        assert tdec.flash_decode_attention.launches_by_window == {(mode, 5): 2 * cfg.num_layers}
        tdec.reset_launch_counts()
        s1 = [decode_step(cfg, params, first[:, j], steps, pos + j)[0] for j in range(5)]
        s2 = [decode_step(cfg, params, tok, steps, pos + 2 + j)[0]
              for j, tok in enumerate(second.t())]
        assert tdec.flash_decode_attention.launches_by_window == {(mode, 1): 10 * cfg.num_layers}
    torch.cuda.synchronize()
    for window, seq in ((w1, s1), (w2, s2)):
        assert bool(torch.isfinite(window).all())
        assert _rel_to_max(window, torch.stack(seq, dim=1)) <= WINDOW_TOL


def test_beam_gather_of_int8_cache_leaves_matches_the_cpu(dev):
    # the beam reorder on the card: every leaf of an int8 cache, scales
    # included, gathered by parent along the row axis, bit for bit as on
    # the CPU
    from llark_tpu_torch.inference.beam import gather_beams

    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(2, 6, 2, 40, 128).astype(np.float32))
    cache = {"index": 4}
    (cache["k"], cache["k_scale"]), (cache["v"], cache["v_scale"]) = (_quantize_kv(x),
                                                                      _quantize_kv(-x))
    gidx = torch.tensor([3, 3, 0, 5, 1, 1])
    want = gather_beams(cache, gidx)
    got = gather_beams({k: v.to(dev) if torch.is_tensor(v) else v for k, v in cache.items()},
                       gidx.to(dev))
    assert got["index"] == 4
    for name in ("k", "v", "k_scale", "v_scale"):
        assert got[name].device.type == "cuda" and torch.equal(got[name].cpu(), want[name])


def _htsat_base_on(dev, tf32=False):
    """HTSAT-base on 2 seeded mel clips on `dev` (with TF32 products if
    asked), and the CPU plain path's result."""
    from llark_tpu_torch.encoders.clap.htsat import HTSATConfig, htsat_embed, init_htsat_params

    cfg = HTSATConfig.base()
    mel = torch.from_numpy(
        (10 * np.random.RandomState(9).randn(2, cfg.n_frames, cfg.n_mels) - 40).astype(np.float32))
    want = htsat_embed(cfg, init_htsat_params(cfg, 0, "cpu"), mel)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        got = htsat_embed(cfg, init_htsat_params(cfg, 0, dev), mel.to(dev))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return got, want


def test_htsat_base_on_the_card_matches_the_cpu(dev):
    got, want = _htsat_base_on(dev)
    assert got.shape == (2, 512) and got.device.type == "cuda"
    assert bool(torch.isfinite(got).all())
    assert _rel_to_max(got.cpu(), want) <= HTSAT_TOL


def test_htsat_base_with_tf32_products_falls_outside_htsat_tol(dev):
    # the control of the case above: TF32 products must fail HTSAT_TOL, or
    # the limit could not tell them from fp32
    got, want = _htsat_base_on(dev, tf32=True)
    assert bool(torch.isfinite(got).all())
    assert _rel_to_max(got.cpu(), want) > HTSAT_TOL


def test_read_wav_then_embed_clip_on_the_card(dev, tmp_path):
    # a 12 s stereo clip at 44.1 kHz: read_wav resamples it to 48 kHz and
    # embed_clip draws a 10 s window from the RandomState
    from llark_tpu_torch.audio.io import read_wav, write_wav
    from llark_tpu_torch.encoders.clap.encode import CLAP_SAMPLE_RATE, ClapEncoder

    rng = np.random.RandomState(10)
    path = str(tmp_path / "clip.wav")
    write_wav(path, 0.3 * rng.randn(12 * 44100, 2), 44100)
    samples, sr = read_wav(path, CLAP_SAMPLE_RATE)
    assert sr == CLAP_SAMPLE_RATE and len(samples) == 12 * CLAP_SAMPLE_RATE
    got = ClapEncoder.random_init(seed=1, device=dev).embed_clip(samples, np.random.RandomState(0))
    want = ClapEncoder.random_init(seed=1, device="cpu").embed_clip(samples,
                                                                     np.random.RandomState(0))
    assert got.shape == want.shape == (1, 512) and got.dtype == np.float32
    assert abs(float(np.linalg.norm(got)) - 1.0) < 1e-5
    assert float(np.abs(got - want).max()) <= CLAP_TOL


def _jukebox_fixture_on(dev, tmp_path, tf32=False):
    """The parity fixture through the port's importer onto `dev` (fp32),
    with TF32 products if asked: per clip, the codes and the pooled
    embedding, and the prior's activations on the goldens' codes; and the
    goldens."""
    import json
    import os

    from llark_tpu_torch.encoders.jukebox import import_torch
    from llark_tpu_torch.encoders.jukebox.encode import JukeboxEncoder, pad_or_crop, prepare_audio
    from llark_tpu_torch.encoders.jukebox.prior import prior_encode
    from llark_tpu_torch.encoders.jukebox.vqvae import encode_top

    fix = os.path.join(os.path.dirname(__file__), "fixtures", "jukebox_parity")
    meta = json.load(open(os.path.join(fix, "meta.json")))
    npz = str(tmp_path / "mid.npz")
    import_torch.main(["--vqvae", os.path.join(fix, "vqvae_sd.pt"), "--prior",
                       os.path.join(fix, "prior_sd.pt"), "--output", npz, *meta["import_args"]])
    gold, clips = np.load(os.path.join(fix, "goldens.npz")), np.load(os.path.join(fix, "audio.npz"))
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        enc = JukeboxEncoder.from_npz(npz, pool_frames_per_second=meta["fps"], device=dev)
        got = {}
        for name in ("full", "short", "stereo"):
            audio = pad_or_crop(prepare_audio(clips[name]), enc.samples_per_ctx)
            codes = encode_top(enc.vq_cfg, enc.vq_params, torch.from_numpy(audio[None]).to(dev))
            got[f"{name}.codes"] = codes[0, : meta["n_ctx"]].cpu().numpy()
            got[f"{name}.pooled"] = enc.get_acts_from_audio(clips[name])
        got["full.acts"] = prior_encode(
            enc.prior_cfg, enc.prior_params, torch.from_numpy(gold["full.codes"][None]).to(dev),
            *(torch.from_numpy(gold[k]).to(dev) for k in ("x_cond", "y_cond")))[0].cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return got, gold


def test_jukebox_fixture_on_the_card_equals_the_goldens(dev, tmp_path):
    got, gold = _jukebox_fixture_on(dev, tmp_path)
    for name in ("full", "short", "stereo"):
        np.testing.assert_array_equal(got[f"{name}.codes"], gold[f"{name}.codes"], err_msg=name)
        assert got[f"{name}.pooled"].shape == gold[f"{name}.pooled"].shape, name
        assert np.abs(got[f"{name}.pooled"] - gold[f"{name}.pooled"]).max() <= JUKEBOX_GOLD_ATOL
    assert np.abs(got["full.acts"] - gold["full.acts"]).max() <= JUKEBOX_GOLD_ATOL


def test_jukebox_fixture_with_tf32_products_falls_outside_the_gate(dev, tmp_path):
    # the control of the case above: TF32 products must flip a code or read
    # above JUKEBOX_GOLD_ATOL, or the gate could not tell them from fp32
    got, gold = _jukebox_fixture_on(dev, tmp_path, tf32=True)
    worst = max(np.abs(got[k] - gold[k]).max() for k in ("full.acts", "full.pooled"))
    flipped = sum(int((got[f"{n}.codes"] != gold[f"{n}.codes"]).sum())
                  for n in ("full", "short", "stereo"))
    assert flipped or worst > JUKEBOX_GOLD_ATOL


def test_jukebox_encode_stream_on_the_card_equals_encode_batch_and_the_cpu(dev):
    # the stream enqueues batch k + 1 before it waits for batch k, whose
    # readback runs on a copy stream into pinned memory
    from llark_tpu_torch.encoders.jukebox.config import JukeboxPriorConfig, JukeboxVQVAEConfig
    from llark_tpu_torch.encoders.jukebox.encode import JukeboxEncoder

    vq_cfg, pr_cfg = JukeboxVQVAEConfig.tiny(), JukeboxPriorConfig.tiny()
    card = JukeboxEncoder.random_init(vq_cfg, pr_cfg, device=dev, pool_frames_per_second=None,
                                      transfer_dtype="int16")
    cpu = JukeboxEncoder(vq_cfg, pr_cfg, card.vq_params, card.prior_params, device="cpu",
                         pool_frames_per_second=None, transfer_dtype="int16")
    rng = np.random.RandomState(12)
    batches = [((0.3 * rng.randn(2, 512)).astype(np.float32), np.array([512, 64 * i]))
               for i in range(4)]
    streamed = list(card.encode_stream(iter(batches)))
    assert len(streamed) == 4
    for (audio, lengths), (acts, counts) in zip(batches, streamed):
        want, want_counts = card.encode_batch(audio, lengths)
        np.testing.assert_array_equal(acts, want)
        np.testing.assert_array_equal(counts, want_counts)
        ref, _ = cpu.encode_batch(audio, lengths)
        assert _rel_to_max(torch.from_numpy(acts), torch.from_numpy(ref)) <= 1e-5


# ---------------------------------------------------------------------------
# Mixture-of-Experts at Mixtral's attention shapes: 32 query heads over 8 KV
# heads (GQA group 4), head_dim 128
# ---------------------------------------------------------------------------

MOE_TOL = 1e-4  # chip_smoke.py phase 22 (b): fp32 moe_ffn, card vs CPU
# bf16 moe_ffn from int8 expert stacks, the int8 kernel against the plain
# products, relative to max: three products each rounded to bf16 and the
# gated activation between them (chip_smoke.py's KERNEL_TOL)
MOE_INT8_TOL = 2e-2


def _rolled(t):
    """KV heads rolled by one: each query group reads its neighbour's head."""
    return torch.roll(t, 1, dims=1)


def test_mixtral_flash_fwd_matches_plain(dev):
    q, k, v = _qkv(dev, 40, 2, 32, 8, 384, 384, 128)
    kw = dict(causal=True, kv_lengths=torch.tensor([297, 384], device=dev), slopes=None)
    got = tattn.flash_attention_fwd(q, k, v, kv_lengths=kw["kv_lengths"])
    torch.cuda.synchronize()
    assert _row_err(got, tattn._flash_attention_fwd_plain(q, k, v, **kw)) <= ROW_TOL["flash_fwd"]
    # the control: the plain version over rolled KV heads must fail the gate
    wrong = tattn._flash_attention_fwd_plain(q, _rolled(k), _rolled(v), **kw)
    assert _row_err(got, wrong) > ROW_TOL["flash_fwd"]


@pytest.mark.parametrize("mode", ["dense_bf16", "paged_int8"])
def test_mixtral_flash_decode_matches_plain(dev, mode):
    b, h, hkv, s, d, bs = 8, 32, 8, 2048, 128, 128
    rng = np.random.RandomState(41)
    q = torch.from_numpy(rng.randn(b, h, 1, d).astype(np.float32)).to(dev, torch.bfloat16)
    lengths = torch.tensor([300, 305, 311, 318, 322, 329, 334, 340], dtype=torch.int32,
                           device=dev)
    kw = dict(kv_lengths=lengths, q_positions=lengths - 1)
    rows = b if mode == "dense_bf16" else b + b * (s // bs)
    k, v = (torch.from_numpy(rng.randn(rows, hkv, s if mode == "dense_bf16" else bs, d)
                             .astype(np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    if mode == "paged_int8":
        perm = torch.from_numpy(rng.permutation(rows - b) + b).to(dev, torch.int32)
        kw["block_tables"] = perm.reshape(b, s // bs)
        (k, kw["k_scale"]), (v, kw["v_scale"]) = _quantize_kv(k), _quantize_kv(v)

    def plain(k_, v_, **over):
        return tdec._flash_decode_plain(
            q, k_, v_, kv_lengths=lengths, q_positions=lengths - 1,
            k_scale=over.get("k_scale", kw.get("k_scale")),
            v_scale=over.get("v_scale", kw.get("v_scale")), slopes=None,
            block_tables=kw.get("block_tables"))

    got = tdec.flash_decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _row_err(got, plain(k, v)) <= ROW_TOL["flash_decode"]
    scales = {n: _rolled(kw[n]) for n in ("k_scale", "v_scale") if n in kw}
    assert _row_err(got, plain(_rolled(k), _rolled(v), **scales)) > ROW_TOL["flash_decode"]


def test_flash_bwd_sums_dk_dv_over_a_group_of_four(dev):
    # GQA group 4: dk and dv of a KV head are the sums over its 4 query
    # heads, against the plain version and against the same backward on K/V
    # repeated to one head per query head, summed group by group
    b, h, hkv, s, d = 2, 32, 8, 512, 128
    q, k, v = _qkv(dev, 42, b, h, hkv, s, s, d)
    do = _qkv(dev, 43, b, h, h, s, s, d)[0]
    kw = dict(causal=True, kv_lengths=torch.tensor([512, 300], device=dev), slopes=None)
    _, dk, dv = _bwd_against_plain(q, k, v, do, kw)
    kr, vr = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
    out, lse = tattn.flash_attention_fwd(q, kr, vr, return_lse=True, **kw)
    _, dk_r, dv_r = tattn.flash_attention_bwd(q, kr, vr, out, lse, do, **kw)
    for got, per_head in ((dk, dk_r), (dv, dv_r)):
        summed = per_head.float().reshape(b, hkv, h // hkv, s, d).sum(2)
        assert _row_err(got, summed, BWD_ROW_FLOOR) <= ROW_TOL["flash_bwd"]
        assert _rel_to_max(got, summed) <= BWD_TOL
        # the control: a group summed over the wrong KV head fails the gate
        assert _row_err(got, _rolled(summed), BWD_ROW_FLOOR) > ROW_TOL["flash_bwd"]


def _moe_block(tf32=False, routing="switch"):
    """moe_ffn at a reduced width (hidden 1024, 8 experts of 2048, top-2) in
    fp32 on the card and the CPU, the same weights drawn on the CPU."""
    from llark_tpu_torch.config import ModelConfig
    from llark_tpu_torch.models import moe

    cfg = ModelConfig(hidden_size=1024, intermediate_size=2048, num_layers=1, num_heads=8,
                      num_kv_heads=2, moe_num_experts=8, moe_top_k=2, dtype="float32",
                      param_dtype="float32", moe_routing=routing,
                      moe_capacity_factor=1.0 if routing == "switch" else 4.0)
    g = torch.Generator().manual_seed(44)
    lp = {k: w[0] for k, w in moe.init_moe_layer_params(
        cfg, lambda shape, fan_in: torch.randn(shape, generator=g).div_(fan_in ** 0.5)).items()}
    y = torch.randn((2, 48, 1024), generator=g)
    with torch.inference_mode():
        want, wm = moe.moe_ffn(cfg, lp, y)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            got, gm = moe.moe_ffn(cfg, {k: w.to("cuda") for k, w in lp.items()}, y.to("cuda"))
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    return got.cpu(), want, gm, wm


@pytest.mark.parametrize("routing", ["switch", "mixtral"])
def test_moe_block_on_the_card_matches_the_cpu(dev, routing):
    got, want, gm, wm = _moe_block(routing=routing)
    assert bool(torch.isfinite(got).all())
    assert _rel_to_max(got, want) <= MOE_TOL
    for k in ("aux_loss", "dropped_frac"):
        assert abs(float(gm[k]) - float(wm[k])) <= 1e-6, k
    assert (float(wm["dropped_frac"]) > 0) == (routing == "switch")


def test_moe_block_with_tf32_products_falls_outside_moe_tol(dev):
    got, want, _, _ = _moe_block(tf32=True)
    assert _rel_to_max(got, want) > MOE_TOL


def test_moe_int8_experts_launch_the_int8_kernel_per_expert(dev):
    # int8 expert stacks: one int8 kernel launch a product per expert,
    # against the plain products on the same int8 stacks on the card
    from llark_tpu_torch.config import ModelConfig
    from llark_tpu_torch.models import moe
    from llark_tpu_torch.models.quant import quantize_weight
    from llark_tpu_torch.ops import int8_matmul as i8

    cfg = ModelConfig(hidden_size=512, intermediate_size=1024, num_layers=1, num_heads=4,
                      num_kv_heads=1, moe_num_experts=4, moe_top_k=2, moe_routing="mixtral",
                      moe_capacity_factor=2.0)
    g = torch.Generator(device=dev).manual_seed(45)
    lp = {k: w[0] for k, w in moe.init_moe_layer_params(
        cfg, lambda shape, fan_in: torch.randn(shape, generator=g, device=dev) / fan_in ** 0.5
    ).items()}
    lp.update({k: quantize_weight(w) for k, w in lp.items() if k != "moe_router"})
    y = torch.randn((2, 40, 512), generator=g, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        before = i8.int8_matmul.launches
        got, _ = moe.moe_ffn(cfg, lp, y)
        torch.cuda.synchronize()
        assert i8.int8_matmul.launches - before == 3 * 4
        saved = i8.int8_matmul
        i8.int8_matmul = lambda x, q, scale: i8._int8_matmul_plain(x, q, scale)
        try:
            want, _ = moe.moe_ffn(cfg, lp, y)
        finally:
            i8.int8_matmul = saved
    assert _rel_to_max(got, want) <= MOE_INT8_TOL


# ---------------------------------------------------------------------------
# the CLAP text tower and the annotator trainer: no hand-written kernel
# (cuBLAS products, cuDNN convolutions), fp32 with TF32 off; held against
# the CPU within TEXT_TOL / TRAIN_* as chip_smoke.py phase 24 holds them,
# each beside a TF32 control that must fail its gate
# ---------------------------------------------------------------------------

TEXT_TOL = 1e-5
# the first step against float64: its loss (relative) and each gradient (L2,
# relative); then each of 5 Adam steps' losses against the CPU in fp32
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_STEPS_TOL = 1e-5, 1e-3, 1.5e-4


def _text_tower_on(dev, tf32=False):
    from llark_tpu_torch.encoders.clap import text

    cfg = text.ClapTextConfig.base()
    state = text.random_init(cfg, torch.Generator().manual_seed(0))
    ids = text.hashed_token_ids(["a calm jazz tune with saxophone", "metal", "pop with synths",
                                 "a slow blues in E"], 24, cfg.vocab_size, cfg.pad_token_id)
    want = text.clap_text_embed(text.build_text_model(cfg, state, "cpu"), ids)
    model = text.build_text_model(cfg, state, dev)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.no_grad():
            ids_dev = torch.from_numpy(ids).to(dev)
            got = model.compute(ids_dev) if tf32 else text.clap_text_embed(model, ids_dev)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return got.cpu(), want


def test_clap_text_base_on_the_card_matches_the_cpu(dev):
    got, want = _text_tower_on(dev)
    assert got.shape == (4, 512) and bool(torch.isfinite(got).all())
    assert _rel_to_max(got, want) <= TEXT_TOL


def test_clap_text_base_with_tf32_products_falls_outside_text_tol(dev):
    got, want = _text_tower_on(dev, tf32=True)
    assert _rel_to_max(got, want) > TEXT_TOL


def _trainer_data():
    from llark_tpu_torch.audio import neural
    from llark_tpu_torch.audio import train_annotators as ta

    rng = np.random.RandomState(0)
    beat = ([rng.randn(600, neural.BEAT_N_MELS).astype(np.float32) for _ in range(3)],
            [(rng.rand(600, 2) < 0.05).astype(np.float32) for _ in range(3)])
    key = rng.rand(6, 120, 12).astype(np.float32), rng.randint(24, size=6).astype(np.int32)
    init = {**ta.init_tree(neural.beat_param_shapes(), torch.Generator().manual_seed(0)),
            **ta.init_tree(neural.key_param_shapes(), torch.Generator().manual_seed(1))}
    return beat, key, init


def _first_step(net, device, tf32=False, dtype=torch.float32):
    # the trainer's first step before Adam: (loss, {parameter: gradient})
    from llark_tpu_torch.audio import train_annotators as ta
    from llark_tpu_torch.device import full_fp32

    beat, key, init = _trainer_data()
    rng = np.random.RandomState(1)
    draw = ta.beat_batches(*beat, 4, 400, rng) if net == "beat" else ta.key_batches(*key, 4, rng)
    model = ta.trainable_net(net, init, device).to(dtype)
    xb, yb = (torch.from_numpy(a).to(device) for a in draw())
    xb, yb = xb.to(dtype), yb.to(dtype) if yb.is_floating_point() else yb
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        with contextlib.ExitStack() as stack:
            if tf32:
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            else:
                stack.enter_context(full_fp32())
            loss = (ta.beat_loss if net == "beat" else ta.key_loss)(model, xb, yb)
            loss.backward()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return loss.item(), {k: p.grad.cpu().numpy() for k, p in model.named_parameters()}


def _first_step_gaps(got, want):
    grads = max(np.linalg.norm(got[1][k] - g) / np.linalg.norm(g) for k, g in want[1].items())
    return abs(got[0] - want[0]) / abs(want[0]), grads


def _steps(net, device):
    from llark_tpu_torch.audio import train_annotators as ta

    beat, key, init = _trainer_data()
    if net == "beat":
        return ta.train_beat(*beat, 5, 4, 400, 1e-3, np.random.RandomState(1), init, device)
    return ta.train_key(*key, 5, 4, 1e-3, np.random.RandomState(1), init, device)


@pytest.mark.parametrize("net", ["beat", "key"])
def test_trainer_steps_on_the_card_match_the_cpu(dev, net):
    # chip_smoke.py phase 24 (a)'s gate: the first step's loss and gradients
    # before Adam against float64, then the losses of 5 Adam steps against
    # the CPU in fp32 (Adam turns rounding-level gradients of near-zero
    # elements into lr-sized steps of either sign, so the weights after a
    # step read the summation order, not the trainer)
    exact = _first_step(net, "cpu", dtype=torch.float64)
    loss, grad = _first_step_gaps(_first_step(net, dev), exact)
    assert loss <= TRAIN_LOSS_TOL and grad <= TRAIN_GRAD_TOL
    card, cpu = _steps(net, dev), _steps(net, "cpu")
    assert next(card.net.parameters()).device.type == "cuda"
    assert max(abs(a - b) / abs(b) for a, b in zip(card.losses, cpu.losses)) <= TRAIN_STEPS_TOL


def test_trainer_steps_with_tf32_products_fall_outside_the_first_step_gate(dev):
    for net in ("beat", "key"):
        loss, grad = _first_step_gaps(_first_step(net, dev, tf32=True),
                                      _first_step(net, "cpu", dtype=torch.float64))
        assert loss > TRAIN_LOSS_TOL or grad > TRAIN_GRAD_TOL, net


# -- the captured decode chunk (generate.DecodeProgram) ----------------------
#
# A replay runs the kernels its capture recorded on the buffers it captured,
# so on the same inputs it must give eager `decode_n`'s tokens, logits and
# cache writes bit for bit, in every cache mode and from bf16, int8 and int4
# weights; each call must add its captured launches to the counters.

PROGRAM_WIDTHS = dict(hidden_size=256, intermediate_size=512, num_heads=2, num_kv_heads=2,
                      num_layers=2, vocab_size=512, mm_hidden_size=16, dtype="bfloat16",
                      param_dtype="bfloat16", use_flash_decode=True)
PROGRAM_ROWS, PROGRAM_LEN, PROGRAM_BLOCK = 4, 256, 16


def _program_case(dev, mode, weights="bf16"):
    """(cfg, params, cache, token, positions): a 2-layer bf16 decoder of
    head_dim 128, its weights bf16 or quantized, and a random cache of 4
    rows in `mode` (dense or paged, bf16 or int8) with live lengths 9-200."""
    from llark_tpu_torch.config import ModelConfig
    from llark_tpu_torch.models.fusion import init_llark_params
    from llark_tpu_torch.models.quant import (quantize_params_int4_incremental,
                                              quantize_params_int8_incremental)

    cfg = ModelConfig.tiny("llama", kv_cache_quant="int8" in mode, **PROGRAM_WIDTHS)
    params = init_llark_params(cfg, seed=0, device=dev)
    if weights == "int8":
        params = quantize_params_int8_incremental(cfg, params)
    elif weights == "int4":
        params = quantize_params_int4_incremental(cfg, params, group=128, layout="rows")
    rng = np.random.RandomState(5)
    paged = mode.startswith("paged")
    n_blocks = PROGRAM_ROWS * (1 + PROGRAM_LEN // PROGRAM_BLOCK)
    lead = ((cfg.num_layers, n_blocks, cfg.num_kv_heads, PROGRAM_BLOCK) if paged
            else (cfg.num_layers, PROGRAM_ROWS, cfg.num_kv_heads, PROGRAM_LEN))
    cache = {"index": 0}
    for key in ("k", "v"):
        x = torch.from_numpy(rng.randn(*lead, cfg.head_dim).astype(np.float32)).to(dev)
        if cfg.kv_cache_quant:
            cache[key], cache[key + "_scale"] = _quantize_kv(x)
        else:
            cache[key] = x.to(torch.bfloat16)
    if paged:
        real = PROGRAM_ROWS + rng.permutation(n_blocks - PROGRAM_ROWS)
        cache["block_tables"] = torch.from_numpy(
            real.reshape(PROGRAM_ROWS, -1).astype(np.int32)).to(dev)
    token = torch.from_numpy(rng.randint(4, 500, PROGRAM_ROWS)).to(dev)
    positions = torch.tensor([9, 40, 128, 200], device=dev)
    return cfg, params, cache, token, positions


def _cache_copy(cache):
    return {k: v.clone() if torch.is_tensor(v) else v for k, v in cache.items()}


@pytest.mark.parametrize("mode,weights", [
    ("dense_bf16", "bf16"), ("dense_int8", "bf16"), ("paged_bf16", "bf16"), ("paged_int8", "bf16"),
    ("dense_bf16", "int8"), ("paged_int8", "int8"), ("paged_int8", "int4")])
def test_decode_program_replays_equal_eager_decode_n(dev, mode, weights):
    from llark_tpu_torch.generate import GenerationConfig, decode_n, make_multistep_decode_fn

    cfg, params, cache, token, pos = _program_case(dev, mode, weights)
    ref = _cache_copy(cache)
    gcfg = GenerationConfig(stop_text="")
    program = make_multistep_decode_fn(cfg, gcfg, 4)
    tok_ref = token
    with torch.inference_mode():
        for i in range(3):  # the first call captures and replays
            toks, logits, cache = program(params, token, cache, pos + 4 * i, None)
            want, want_logits, ref = decode_n(cfg, gcfg, params, tok_ref, ref, pos + 4 * i, 4, None)
            assert torch.equal(toks, want) and torch.equal(logits, want_logits), i
            token, tok_ref = toks[:, -1], want[:, -1]
    torch.cuda.synchronize()
    assert program.calls == 3 and cache["index"] == 12
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in ref:
            assert torch.equal(cache[key], ref[key]), key


def _counts():
    from llark_tpu_torch.ops.int4_matmul import int4_matmul
    from llark_tpu_torch.ops.int8_matmul import int8_matmul

    return (tattn.flash_attention_fwd.launches, int8_matmul.launches, int4_matmul.launches,
            dict(tdec.flash_decode_attention.launches_by_window))


def test_decode_program_counts_its_captured_launches_per_call(dev):
    from llark_tpu_torch.generate import GenerationConfig, make_multistep_decode_fn

    cfg, params, cache, token, pos = _program_case(dev, "paged_int8", "int8")
    program = make_multistep_decode_fn(cfg, GenerationConfig(stop_text=""), 4)
    layers, steps = cfg.num_layers, 4
    per_call = (0, 7 * layers * steps, 0, {("paged_int8", 1): layers * steps})
    with torch.inference_mode():
        for _ in range(3):
            before = _counts()
            program(params, token, cache, pos, None)
            after = _counts()
            got = tuple(a - b for a, b in zip(after[:3], before[:3])) + (
                {k: n - before[3].get(k, 0) for k, n in after[3].items()
                 if n != before[3].get(k, 0)},)
            assert got == per_call
    # what one call adds, as the program recorded it at its capture
    assert program.launches_by_window == {("paged_int8", 1): layers * steps}
    assert program.launches == {"flash_decode_attention": layers * steps,
                                "int8_matmul": 7 * layers * steps}


def test_sampled_replays_draw_new_noise_and_advance_the_generator(dev):
    from llark_tpu_torch.generate import GenerationConfig, decode_n, make_multistep_decode_fn

    cfg, params, cache, token, pos = _program_case(dev, "paged_bf16")
    ref = _cache_copy(cache)
    gcfg = GenerationConfig(temperature=1.0, top_k=100, stop_text="")
    program = make_multistep_decode_fn(cfg, gcfg, 4)
    rng = torch.Generator(device=dev).manual_seed(5)
    states = [rng.get_state()]
    with torch.inference_mode():
        first = program(params, token, cache, pos, rng)[0].clone()
        states.append(rng.get_state())
        second = program(params, token, cache, pos, rng)[0].clone()
        states.append(rng.get_state())
        want = decode_n(cfg, gcfg, params, token, ref, pos, 4,
                        torch.Generator(device=dev).manual_seed(5))[0]
    assert not torch.equal(first, second)
    assert not torch.equal(states[0], states[1]) and not torch.equal(states[1], states[2])
    # the replay draws what decode_n draws from the same state
    assert torch.equal(first, want)


def test_decode_program_replays_allocate_nothing(dev):
    from llark_tpu_torch.generate import GenerationConfig, make_multistep_decode_fn
    from llark_tpu_torch.ops import int8_matmul as int8_ops

    cfg, params, cache, token, pos = _program_case(dev, "dense_int8", "int8")
    program = make_multistep_decode_fn(cfg, GenerationConfig(stop_text=""), 4)
    with torch.inference_mode():
        program(params, token, cache, pos, None)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        for _ in range(3):
            program(params, token, cache, pos, None)
        torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == held
    # the products' split workspace was made by the warm-up on the capture
    # stream, outside the graph, and the program keeps it
    key = (torch.device(dev).index or 0, program.pool.stream.cuda_stream)
    assert program._workspace is not None and int8_ops._workspaces[key] is program._workspace


def test_server_rounds_replay_equal_eager_rounds_with_tables_copied_in_place(dev):
    from llark_tpu_torch.config import ModelConfig
    from llark_tpu_torch.generate import GenerationConfig, decode_n
    from llark_tpu_torch.inference.server import BatchedServer, Request
    from llark_tpu_torch.models.fusion import init_llark_params

    cfg = ModelConfig.tiny("llama", kv_cache_quant=True, **PROGRAM_WIDTHS)
    params = init_llark_params(cfg, seed=0, device=dev)
    rng = np.random.RandomState(9)
    reqs = [(rng.randint(4, 500, n).astype(np.int32), rng.randn(3, 16).astype(np.float32))
            for n in (20, 37, 12, 50, 25)]
    gcfg = GenerationConfig(max_new_tokens=12, stop_text="")
    kw = dict(max_batch=2, max_cache_len=256, prompt_buckets=(64,), max_audio_frames=4,
              decode_chunk=4, decode_chunk_drain=1, kv_block_size=16, prefill_chunk=32)
    streams = []
    for eager in (False, True):
        server = BatchedServer(cfg, params, 7, gcfg, device=dev, **kw)
        if eager:  # the same rounds through decode_n
            server._programs = {
                n: (lambda n: lambda p, tok, c, pos, g: decode_n(cfg, gcfg, p, tok, c, pos, n, g))(n)
                for n in (4, 1)}
        out = server.serve([Request(i, a) for i, a in reqs])
        streams.append([r.tokens for r in out])
        if not eager:
            tables = server._cache["block_tables"]
            assert sorted(server._programs) == [1, 4]
            assert all(p._cache["block_tables"] is tables and p.calls > 0
                       for p in server._programs.values())
    assert streams[0] == streams[1]
    assert all(len(s) == 12 for s in streams[0])


def test_a_failed_capture_raises(dev, monkeypatch):
    from llark_tpu_torch import generate as tgen

    cfg, params, cache, token, pos = _program_case(dev, "dense_bf16")
    sample = tgen._sample

    def reads_back(logits, gen_cfg, generator):  # a host read inside the chunk
        if int(logits[0, 0].float() > 1e30):
            pass
        return sample(logits, gen_cfg, generator)

    monkeypatch.setattr(tgen, "_sample", reads_back)
    program = tgen.make_multistep_decode_fn(cfg, tgen.GenerationConfig(stop_text=""), 2)
    before = _counts()
    with torch.inference_mode(), pytest.raises(RuntimeError):
        program(params, token, cache, pos, None)
    assert program._graph is None and _counts() == before


# -- the captured prefill and admission programs (generate.py
# make_prefill_fn & co., inference/paged.py make_block_insert_fn) -----------
#
# A replay runs what its capture recorded on its static buffers and bound
# caches, so on the same inputs it must equal the eager route bit for bit:
# the prefill (K1), the dense and paged chunks and the tail (K2 over a
# paged pool), in every cache mode and from bf16, int8 and int4 weights.

PREFILL_ROWS, PREFILL_LEN, PREFILL_CHUNK = 4, 64, 16


def _prefill_inputs(dev, cfg, seed=0):
    """ids [4, 64] with 3 audio patches, prompt lengths 9-64, audio
    [4, 3, 16] and frame counts, and fused embeddings of the same rows."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(10, 500, (PREFILL_ROWS, PREFILL_LEN))
    ids[:, 1:4] = 7
    lengths = np.array([64, 40, 9, 33], np.int32)
    audio = rng.randn(PREFILL_ROWS, 3, 16).astype(np.float32)
    embeds = rng.randn(PREFILL_ROWS, PREFILL_LEN, cfg.hidden_size).astype(np.float32)
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(lengths).to(dev),
            torch.from_numpy(audio).to(dev), torch.full((PREFILL_ROWS,), 3, device=dev),
            torch.from_numpy(embeds).to(dev, torch.bfloat16))


def _equal_caches(got, want):
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in want:
            assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("mode,weights", [
    ("dense_bf16", "bf16"), ("dense_int8", "bf16"), ("paged_bf16", "bf16"), ("paged_int8", "bf16"),
    ("dense_bf16", "int8"), ("paged_int8", "int8"), ("paged_int8", "int4")])
def test_prefill_and_chunk_replays_equal_eager(dev, mode, weights):
    import dataclasses

    from llark_tpu_torch import generate as tgen

    cfg, params, cache, _, _ = _program_case(dev, mode, weights)
    cfg = dataclasses.replace(cfg, use_pallas_attention=True)  # the prefill on K1
    ids, lengths, audio, frames, embeds = _prefill_inputs(dev, cfg)
    c = PREFILL_CHUNK
    with torch.inference_mode():
        if mode.startswith("dense"):
            # the one-shot prefill into a random cache of 4 rows x 256
            program = tgen.make_prefill_fn(cfg, 7, PROGRAM_LEN)
            ref = _cache_copy(cache)
            for seed in (0, 1):
                ids, lengths, audio, frames, embeds = _prefill_inputs(dev, cfg, seed)
                got, _ = program(params, ids, lengths, audio, frames, cache)
                want, _ = program.plain(params, ids, lengths, audio, frames, ref)
                assert torch.equal(got, want), seed
                _equal_caches(cache, ref)
            assert program.launches.get("flash_attention_fwd") == cfg.num_layers
            chunk, tail = tgen.make_prefill_chunk_fn(cfg), tgen.make_prefill_last_fn(cfg)
            work, ref = dict(cache, index=0), dict(ref, index=0)
            for start in range(0, PREFILL_LEN, c):  # one program, every offset
                work = chunk(params, embeds[:, start:start + c], lengths, work)
                ref = chunk.plain(params, embeds[:, start:start + c], lengths, ref)
                _equal_caches(cache, ref)
        else:
            # chunks straight into the pool through each row's first blocks
            chunk, tail = tgen.make_paged_prefill_chunk_fn(cfg), tgen.make_prefill_last_fn(cfg)
            cache = dict(cache, block_tables=cache["block_tables"][:, :PREFILL_LEN // PROGRAM_BLOCK]
                         .contiguous())
            ref = _cache_copy(cache)
            for start in range(0, PREFILL_LEN, c):
                chunk(params, embeds[:, start:start + c], lengths, cache, start)
                chunk.plain(params, embeds[:, start:start + c], lengths, ref, start)
                _equal_caches(cache, ref)
            work = cache
        got, _ = tail(params, embeds, lengths, work)
        want, _ = tail.plain(params, embeds, lengths, ref)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _equal_caches(cache, ref)
    assert chunk.calls == PREFILL_LEN // c and tail.calls == 1
    if weights != "bf16":
        assert chunk.launches[f"{weights}_matmul"] == 7 * cfg.num_layers


def test_prefill_replays_allocate_nothing(dev):
    import gc

    from llark_tpu_torch import generate as tgen

    cfg, params, cache, _, _ = _program_case(dev, "dense_int8", "int8")
    ids, lengths, audio, frames, embeds = _prefill_inputs(dev, cfg)
    prefill = tgen.make_prefill_fn(cfg, 7, PROGRAM_LEN)
    chunk = tgen.make_prefill_chunk_fn(cfg, prefill.pool)
    with torch.inference_mode():
        for _ in range(2):  # the captures, then one replay each
            prefill(params, ids, lengths, audio, frames, cache)
            chunk(params, embeds[:, :PREFILL_CHUNK], lengths, cache)
        torch.cuda.synchronize()
        gc.collect()  # what the first calls left for the collector
        held = torch.cuda.memory_allocated(dev)
        for _ in range(3):
            prefill(params, ids, lengths, audio, frames, cache)
            chunk(params, embeds[:, :PREFILL_CHUNK], lengths, dict(cache, index=PREFILL_CHUNK))
        torch.cuda.synchronize()
        gc.collect()
    assert torch.cuda.memory_allocated(dev) == held
    assert prefill.capture_ms is not None and prefill.warm_ms is not None


@pytest.mark.parametrize("mode", ["paged_int8_chunked", "dense_chunked", "dense_prefix",
                                  "dense_one_shot", "paged_one_shot"])
def test_admission_replays_equal_eager_admission(dev, mode):
    """The engine, its admission and decode rounds replayed, against the
    same engine with every program's eager route: equal streams. Two slots
    and five requests, so later groups are admitted while rows decode; in
    the chunked modes a decode round runs between chunks, replaying the
    decode program of the pool the admission programs share: the fused
    embeddings and the logits the chunks and the tail leave must survive
    it."""
    from llark_tpu_torch.config import ModelConfig
    from llark_tpu_torch.generate import GenerationConfig, decode_n
    from llark_tpu_torch.inference.server import BatchedServer, Request
    from llark_tpu_torch.models.fusion import init_llark_params

    cfg = ModelConfig.tiny("llama", kv_cache_quant="int8" in mode, use_pallas_attention=True,
                           **PROGRAM_WIDTHS)
    params = init_llark_params(cfg, seed=0, device=dev)
    rng = np.random.RandomState(9)
    shared = rng.randint(10, 500, 20).astype(np.int32)
    reqs = [(np.concatenate([shared, rng.randint(10, 500, n).astype(np.int32)]),
             rng.randn(3, 16).astype(np.float32)) for n in (20, 37, 12, 44, 25)]
    gcfg = GenerationConfig(max_new_tokens=12, stop_text="")
    kw = dict(max_batch=2, max_cache_len=256, prompt_buckets=(32, 64), max_audio_frames=4,
              decode_chunk=4)
    kw.update({"paged_int8_chunked": dict(kv_block_size=16, prefill_chunk=16),
               "dense_chunked": dict(prefill_chunk=16),
               "dense_prefix": dict(shared_prefix_ids=shared),
               "dense_one_shot": {}, "paged_one_shot": dict(kv_block_size=16)}[mode])
    streams = []
    for eager in (False, True):
        server = BatchedServer(cfg, params, 7, gcfg, device=dev, **kw)
        if eager:
            server._programs = {4: lambda p, tok, c, pos, g: decode_n(cfg, gcfg, p, tok, c, pos, 4, g)}
            server._program = lambda kind, bucket: BatchedServer._program(server, kind, bucket).plain
        out = server.serve([Request(i, a) for i, a in reqs])
        streams.append([r.tokens for r in out])
        if not eager:
            assert server._admission and all(p._graph is not None and p.calls > 0
                                             for p in server._admission.values())
    assert streams[0] == streams[1]
    assert all(len(s) == 12 for s in streams[0])


def test_a_failed_prefill_capture_raises(dev, monkeypatch):
    from llark_tpu_torch import generate as tgen

    cfg, params, cache, _, _ = _program_case(dev, "dense_bf16")
    ids, lengths, audio, frames, _ = _prefill_inputs(dev, cfg)
    embed = tgen.build_inputs_embeds

    def reads_back(*args):  # a host read inside the prefill
        out = embed(*args)
        if float(out.float().abs().max()) > 1e30:
            pass
        return out

    monkeypatch.setattr(tgen, "build_inputs_embeds", reads_back)
    program = tgen.make_prefill_fn(cfg, 7, PROGRAM_LEN)
    before = _counts()
    with torch.inference_mode(), pytest.raises(RuntimeError):
        program(params, ids, lengths, audio, frames, cache)
    assert program._graph is None and _counts() == before


# ---------------------------------------------------------------------------
# the captured train step (train/step.py TrainProgram): step 1 eager, then
# one CUDA graph replayed a step. dq's fp32 atomics make no two runs of a
# step bitwise equal, so each case is held to the spread of two eager runs:
# within the larger of twice that spread and TRAIN_PROGRAM_REL of the value
# ---------------------------------------------------------------------------

TRAIN_PROGRAM_REL = 1e-5
TRAIN_PROGRAM_CASES = {
    # name: (config fields, trainable flags, base, loss_chunk)
    "adapter": (dict(), dict(freeze_backbone=True, tune_mm_mlp_adapter=True), "bf16", None),
    "full_loss_chunk": (dict(), dict(), "bf16", 32),
    "lora_dropout": (dict(lora_rank=8, lora_dropout=0.1), dict(lora=True), "bf16", None),
    "qlora_int8_full": (dict(lora_rank=8, lora_dropout=0.1), dict(lora=True), "int8", None),
    "qlora_int8_dots": (dict(lora_rank=8, lora_dropout=0.1, remat_policy="dots"),
                        dict(lora=True), "int8", None),
    "qlora_int8_dots_narrow": (dict(lora_rank=8, lora_dropout=0.1, remat_policy="dots_narrow"),
                               dict(lora=True), "int8", None),
    "qlora_int4_rows": (dict(lora_rank=8, lora_dropout=0.1), dict(lora=True), "int4", None),
    "moe": (dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=1.0,
                 moe_aux_loss_weight=0.1), dict(), "bf16", None),
}


def _train_batches(dev, n, rows=4, s=64, frames=3, vocab=512, mm=16):
    out = []
    for i in range(n):
        rng = np.random.RandomState(20 + i)
        ids = rng.randint(10, vocab, (rows, s)).astype(np.int64)
        ids[:, 1:1 + frames] = 7
        labels = ids.copy()
        labels[:, :1 + frames] = -100
        lengths = np.array([s, s - 9, s - 20, s])
        for r, n_r in enumerate(lengths):
            labels[r, n_r:] = -100
        arrays = {"input_ids": ids, "labels": labels, "seq_lengths": lengths.astype(np.int32),
                  "audio_encodings": rng.randn(rows, frames, mm).astype(np.float32),
                  "audio_frame_counts": np.full((rows,), frames, np.int32)}
        out.append({k: torch.from_numpy(v).to(dev) for k, v in arrays.items()})
    return out


def _train_run(dev, case, program, steps=3, reuse_seed_at=None):
    """`steps` steps of `case` from the seeded init, through a TrainProgram
    or the eager step: ([(loss, grad_norm)], the trained tensors, the
    launches of each call, the step, the state, the batches). With `reuse_seed_at` (eager), that step draws
    its dropout masks from the seeds of the step before it."""
    from llark_tpu_torch.config import ModelConfig, TrainingArguments
    from llark_tpu_torch.graphs import count_difference, launch_counts
    from llark_tpu_torch.models import lora, quant
    from llark_tpu_torch.models.fusion import init_llark_params
    from llark_tpu_torch.train import step as tstep
    from llark_tpu_torch.train.state import TrainState, iter_leaves

    fields, flags, base, chunk = TRAIN_PROGRAM_CASES[case]
    widths = dict(PROGRAM_WIDTHS, param_dtype="float32", remat=True, use_pallas_attention=True)
    cfg = ModelConfig.tiny("llama", **dict(widths, **fields))
    params = init_llark_params(cfg, seed=0, device=dev)
    if cfg.lora_rank:
        gen = torch.Generator(device=dev).manual_seed(1)
        params = lora.init_lora_params(cfg, gen, params)
        for k in lora.lora_keys(params):
            if k.endswith("_lora_b"):
                params["layers"][k].normal_(0.0, 0.05, generator=gen)
    if base == "int8":
        params = quant.quantize_params_int8_incremental(cfg, params)
    elif base == "int4":
        params = quant.quantize_params_int4_incremental(cfg, params, group=128, layout="rows")
    tstep.ParamPartition(params, tstep.trainable_mask(params, **flags))
    opt = tstep.make_optimizer(TrainingArguments(learning_rate=1e-2, max_steps=10,
                                                 warmup_ratio=0.1, weight_decay=0.01))
    state = TrainState.create(params, opt)
    start = 500 if flags.get("tune_mm_mlp_adapter") else None
    fn = tstep.make_train_step(cfg, opt, audio_patch_id=7, grad_accum_steps=2, loss_chunk=chunk,
                               trainable_token_start=start, dropout_seed=5)
    if program:
        fn = tstep.jit_train_step(fn)
    metrics, launches = [], []
    batches = _train_batches(dev, steps)
    for i, batch in enumerate(batches):
        before = launch_counts()
        if i == reuse_seed_at:
            state.step -= 1
        state, m = fn(state, batch)
        if i == reuse_seed_at:
            state.step += 1
        torch.cuda.synchronize()
        launches.append(count_difference(launch_counts(), before))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    trained = {p: t.detach().float().clone() for p, t in iter_leaves(params) if t.requires_grad}
    return metrics, trained, launches, fn, state, batches


def _within_spread(got, want, again, what):
    """got against want, within max(2 |want - again|, TRAIN_PROGRAM_REL
    |want|) (tensors: max-abs, relative to max)."""
    spread = float((want - again).abs().max()) if torch.is_tensor(want) else abs(want - again)
    scale = float(want.abs().max()) if torch.is_tensor(want) else abs(want)
    err = float((got - want).abs().max()) if torch.is_tensor(want) else abs(got - want)
    assert err <= max(2 * spread, TRAIN_PROGRAM_REL * scale), (what, err, spread, scale)


@pytest.mark.parametrize("case", sorted(TRAIN_PROGRAM_CASES))
def test_train_program_replays_match_eager_steps(dev, case):
    eager, trained_e, launches_e = _train_run(dev, case, program=False)[:3]
    again, trained_a = _train_run(dev, case, program=False)[:2]
    got, trained_p, launches_p, program = _train_run(dev, case, program=True)[:4]
    for i, (g, w, a) in enumerate(zip(got, eager, again)):
        for j, name in enumerate(("loss", "grad_norm")):
            _within_spread(g[j], w[j], a[j], f"step {i + 1} {name}")
    for path in trained_e:
        _within_spread(trained_p[path], trained_e[path], trained_a[path], path)
    # the graph launches what an eager step launches, and each replay adds it
    assert program._graph is not None and program.calls == 3
    assert launches_p == launches_e
    assert launches_p[1] == launches_p[2] == program._captured
    assert program.launches["flash_attention_bwd"] == 2 * 2  # layers x micro-batches


def test_train_program_replays_draw_fresh_dropout_masks(dev):
    case = "qlora_int8_full"
    trained_e = _train_run(dev, case, program=False)[1]
    trained_a = _train_run(dev, case, program=False)[1]
    trained_p = _train_run(dev, case, program=True)[1]
    # control: step 3 on step 2's masks moves the factors outside the spread
    trained_s = _train_run(dev, case, program=False, reuse_seed_at=2)[1]
    for path in trained_e:
        _within_spread(trained_p[path], trained_e[path], trained_a[path], path)
    with pytest.raises(AssertionError):
        for path in trained_e:
            _within_spread(trained_s[path], trained_e[path], trained_a[path], path)


def test_train_program_replays_allocate_nothing(dev):
    from llark_tpu_torch.ops import int8_matmul as int8_ops

    _, _, _, program, state, batches = _train_run(dev, "qlora_int8_full", program=True)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    for batch in batches:
        state, _ = program(state, batch)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == held and state.step == 6
    key = (torch.device(dev).index or 0, program.pool.stream.cuda_stream)
    assert program._workspace is not None and int8_ops._workspaces[key] is program._workspace


def test_a_failed_train_capture_raises(dev, monkeypatch):
    from llark_tpu_torch.train import step as tstep

    train_loss = tstep.train_loss

    def reads_back(cfg, loss, moe):  # a host read inside the step
        if float(loss.detach()) > 1e30:
            pass
        return train_loss(cfg, loss, moe)

    monkeypatch.setattr(tstep, "train_loss", reads_back)
    with pytest.raises(RuntimeError):
        _train_run(dev, "adapter", program=True, steps=1)
