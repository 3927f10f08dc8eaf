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
"""

import numpy as np
import pytest
import torch

from llark_tpu_torch.ops import attention as tattn
from llark_tpu_torch.ops import decode_attention as tdec

ROW_TOL = {"flash_fwd": 1e-2, "flash_decode": 4e-3}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _row_err(got, want):
    g, w = got.float().cpu(), want.float().cpu()
    w_norm = w.norm(dim=-1)
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


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros((1, 4, 1, 128), dtype=torch.bfloat16, device=dev)
    k8 = torch.zeros((1, 4, 64, 128), dtype=torch.int8, device=dev)
    sc = torch.ones((1, 4, 64), device=dev)
    lengths = torch.tensor([10], device=dev)
    with pytest.raises(NotImplementedError, match="serving-engine slice"):
        tdec.flash_decode_attention(q, k8, k8, kv_lengths=lengths, k_scale=sc, v_scale=sc)
    pool = torch.zeros((4, 4, 16, 128), dtype=torch.bfloat16, device=dev)
    tables = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="serving-engine slice"):
        tdec.flash_decode_attention(q, pool, pool, kv_lengths=lengths, block_tables=tables)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros((1, 4, 8, 16), dtype=torch.bfloat16, device=dev)
        tattn.flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="bfloat16"):
        x = torch.zeros((1, 4, 8, 128), dtype=torch.float32, device=dev)
        tattn.flash_attention_fwd(x, x, x)
