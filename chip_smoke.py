#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llark_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final line:
  1. the card's name and power limit; build every CUDA kernel from
     llark_tpu_torch/csrc/ (nvcc, one process per source, in parallel);
  2. flash-prefill kernel vs its plain PyTorch version (bf16, seeded), at
     the shape batch_infer gives it (batch 1) and at batch 4, held per
     query row: |kernel - plain| / |plain| over the head dim (L2);
  3. flash-decode kernel vs its plain PyTorch version, likewise;
  4. the serving path at full Llama-2-7B width (32 layers, random bf16
     weights made on the card from a seed): 4 requests through
     `batch_infer`, greedy, 32 new tokens each, with both kernels' launch
     counts read around that run; then the same requests with the plain
     attention path, comparing prefill logits and greedy tokens, and a
     torch.profiler split of one request into device and idle time;
  5. per-kernel timings at batch 1, the shape batch_infer gives the
     kernels and the one the {"kernels": ...} line reports, and at batch 4
     (printed only): medians of CUDA-event device
     times, L2 flushed before each launch) beside the plain version, PyTorch's
     scaled_dot_product_attention as the library yardstick, and the bound
     from bytes and FLOPs at 3.35 TB/s and 989 TFLOP/s (H100 SXM, bf16);
  6. (A) the flash-decode kernel in every cache mode against its plain
     version at 7B serving shapes: q [8,32,1,128], 2048-position caches,
     live lengths 300-340; dense bf16, dense int8, paged bf16 with 16- and
     128-token blocks, paged int8 with 128-token blocks, Sq=5 with GQA
     Hkv=8 and ALiBi; paged tables scattered over the pool; and the
     flash-prefill kernel at the serving engine's one-shot admission shape,
     q [8,32,512,128] causal with the admitted prompts' lengths (and a wave
     padded with one-token rows); each held per query row;
  7. (B) the serving engine (`BatchedServer`) at full Llama-2-7B width (32
     layers, random bf16 weights from the seed): 16 requests (the four
     prompts of requests() four times, random [256, 4800] encodings),
     greedy, 32 new tokens, 8 slots, cache 2048, decode_chunk 8, in four
     modes: (a) the run of record, paged 128-token blocks + int8 KV +
     prefill_chunk 256; (b) dense bf16, one-shot admission; (c) paged bf16,
     16-token blocks, prefill_chunk 256, prefix caching; (d) dense int8,
     one-shot admission. Each mode: wall time, tokens/s, mean TTFT, the
     flash-decode launches by cache mode (all in its own), the
     flash-prefill launches (one-shot admission runs it: (b) and (d)),
     peak memory, and a decode round's device idle share (torch.profiler);
     one decode step from an admitted state through the kernel route and
     the plain route, logits within LOGITS_TOL;
  8. the training kernels against their plain versions at the training
     path's shape ([2, 32, 1024, 128] bf16, causal, kv_lengths [1024, 700])
     and with GQA + ALiBi and head_dim 64: the forward's log-sum-exp, the
     dq kernel and the dk/dv kernel;
  9. one training step's loss and projector gradient at 7B width, 2 layers,
     through the flash kernels and through the plain attention path;
 10. the adapter stage at full Llama-2-7B (32 layers, fp32 parameters,
     frozen backbone, remat) through `train()` on shards written to a temp
     dir: batch 2 x 2 accumulation steps, 1024 tokens, 256 x 4800 audio
     frames; the loss must fall;
 11. the run-of-record flags (the whole model trains) at 7B width, 4
     layers, likewise; for both: median step ms, tokens/s, MFU, peak
     memory, launches of the three flash kernels per step and the card's
     idle share in a torch.profiler trace of one step;
 12. the training kernels' timings at the phase-8 shape beside their plain
     versions and PyTorch's scaled_dot_product_attention backward; and the
     flash-decode kernel's int8 and paged modes at the phase-6 shape beside
     their plain version (no single PyTorch call reads an int8 or paged
     cache: SDPA over a dense bf16 view is printed beside them).

Prints a {"kernels": [...]} JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Imports nothing of JAX or llark_tpu.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import shutil
import tempfile
import time

import numpy as np
import torch

from llark_tpu_torch.config import DataArguments, ModelArguments, ModelConfig, TrainingArguments
from llark_tpu_torch.data.pipeline import make_data_module
from llark_tpu_torch.data.webdataset import TarShardWriter
from llark_tpu_torch.generate import GenerationConfig, Generator, decode_step
from llark_tpu_torch.infer import _common_prompt_prefix, batch_infer, build_prompt_ids
from llark_tpu_torch.inference.server import BatchedServer, Request
from llark_tpu_torch.models.decoder import _quantize_kv
from llark_tpu_torch.models.fusion import init_llark_params
from llark_tpu_torch.ops import _build
from llark_tpu_torch.ops import attention as attn_ops
from llark_tpu_torch.ops import decode_attention as dec_ops
from llark_tpu_torch.tokenization import TokenizerBundle, WordTokenizer
from llark_tpu_torch.train import flops
from llark_tpu_torch.train.step import make_loss_fn
from llark_tpu_torch.train.train import train

SEED = 0
# Kernel vs plain, both rounded to bf16 on output. ROW_TOL bounds the worst
# query row's |kernel - plain| / |plain| (L2 over the head dim). On an H100
# 80GB HBM3 at 700 W the cases below read at most 4.9e-3 for the prefill
# kernel, which rounds the probabilities to bf16 for the P.V product, and
# 4.8e-4 for the decode kernel, which keeps them in fp32 (PERF.md); each
# limit is about one bf16 ulp (2**-8 = 3.9e-3 relative) above its reading.
# KERNEL_TOL bounds max |kernel - plain| / max |plain| over the output.
ROW_TOL = {"flash_fwd": 1e-2, "flash_decode": 4e-3, "flash_bwd_dq": 1e-2, "flash_bwd_dkv": 1e-2}
KERNEL_TOL = 2e-2
# The backward kernels are held to the JAX package's bound for its flash
# backward, 1.6e-2 relative to max (PERFORMANCE.md:130-132). Their per-row
# measure floors each row's norm at 1e-2 of the tensor's RMS row norm: a
# dq row can be ~0 by cancellation (the first query sees one key, so its
# ds is p (dp - delta) = 0 up to rounding), and a relative error there says
# nothing. On the cases below an H100 80GB HBM3 at 700 W read at most
# 5.4e-3 per row and 6.1e-3 relative to max (PERF.md): the row limit is
# about one bf16 ulp (3.9e-3 relative) above that.
BWD_TOL = 1.6e-2
ROW_FLOOR = {"flash_bwd_dq": 1e-2, "flash_bwd_dkv": 1e-2}
# log-sum-exp of the forward, kernel vs plain, absolute (fp32): read at
# most 3.1e-5 on the cases below
LSE_TOL = 1e-4
LOGITS_TOL = 5e-2  # prefill logits, kernel path vs plain attention path
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
N_TIMED = 30


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def rel_err(got: torch.Tensor, want: torch.Tensor):
    diff = (got.float() - want.float()).abs().max().item()
    return diff / max(want.float().abs().max().item(), 1e-6), diff


def row_err(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """Worst |got - want| / |want| over the rows of the last axis (L2).
    Without a floor, a row of zeros in want (a query with no live key) must
    be zeros in got; with one, each row's norm counts as at least `floor`
    times the RMS row norm of want."""
    g, w = got.float(), want.float()
    w_norm = w.norm(dim=-1)
    if floor:
        w_norm = w_norm.clamp_min(floor * w_norm.square().mean().sqrt().item())
    live = w_norm > 0
    check(bool((g.norm(dim=-1)[~live] == 0).all()), "a row with no live key is not zeros")
    return ((g - w).norm(dim=-1)[live] / w_norm[live]).max().item()


def check_close(kernel: str, name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Hold a kernel's output against its plain version; the max |diff|."""
    row = row_err(got, want, ROW_FLOOR.get(kernel, 0.0))
    rel, diff = rel_err(got, want)
    limit = BWD_TOL if kernel in ROW_FLOOR else KERNEL_TOL
    print(f"{kernel} {name}: worst row {row:.3e}, max|d| {diff:.3e}, rel-to-max {rel:.3e}")
    check(row <= ROW_TOL[kernel], f"{kernel} {name}: row error {row:.3e} > {ROW_TOL[kernel]}")
    check(rel <= limit, f"{kernel} {name}: rel-to-max {rel:.3e} > {limit}")
    return diff


def bf16_randn(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_FLUSH = None


def median_ms(fn, n: int = N_TIMED) -> float:
    """Median device time of fn over n runs, from CUDA events. Before each
    run a 256 MB write leaves the L2 cache cold (as a layer of the model
    finds it), and a sleep kernel keeps the card busy while the host
    enqueues fn, so the events time the device work and not the Python
    around the launch."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        _FLUSH.zero_()
        torch.cuda._sleep(4_000_000)  # ~2 ms at 1.98 GHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_flops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


# ---------------------------------------------------------------------------
# phases 2 and 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash_fwd(gen: torch.Generator, plen: int) -> float:
    # (name, batch, heads, kv heads, head_dim, ALiBi, kv_lengths): first the
    # shape batch_infer gives the kernel (one request, prompt padded to 384)
    ragged = [384, 0, 301, 129]
    cases = [
        (f"main path [1,32,384,128] causal, kv_len {plen}", 1, 32, 32, 128, False, [plen]),
        ("[4,32,384,128] causal", 4, 32, 32, 128, False, ragged),
        ("GQA Hkv=8 + ALiBi", 4, 32, 8, 128, True, ragged),
        ("head_dim 64", 4, 32, 32, 64, False, ragged),
    ]
    worst_abs = 0.0
    for name, b, h, hkv, d, alibi, lengths in cases:
        q = bf16_randn(gen, b, h, 384, d)
        k = bf16_randn(gen, b, hkv, 384, d)
        v = bf16_randn(gen, b, hkv, 384, d)
        kv_lengths = torch.tensor(lengths, device="cuda")
        slopes = attn_ops.alibi_slopes(h, "cuda") if alibi else None
        got = attn_ops.flash_attention_fwd(q, k, v, kv_lengths=kv_lengths, slopes=slopes)
        torch.cuda.synchronize()
        want = attn_ops._flash_attention_fwd_plain(
            q, k, v, causal=True, kv_lengths=kv_lengths, slopes=slopes
        )
        worst_abs = max(worst_abs, check_close("flash_fwd", name, got, want))
    return worst_abs


def check_flash_decode(gen: torch.Generator, plen: int) -> float:
    # (batch, heads, kv heads, ALiBi, kv_lengths, query lengths): first the
    # shape batch_infer gives the kernel (one request, cache 2048)
    ragged = [1, 77, 1000, 2048]
    cases = [
        (1, 32, 32, False, [plen + 16], (1,)),
        (4, 32, 32, False, ragged, (1, 5)),
        (4, 32, 8, True, ragged, (1, 5)),
    ]
    worst_abs = 0.0
    for b, h, hkv, alibi, lengths, sqs in cases:
        kv_lengths = torch.tensor(lengths, device="cuda")
        k = bf16_randn(gen, b, hkv, 2048, 128)
        v = bf16_randn(gen, b, hkv, 2048, 128)
        slopes = attn_ops.alibi_slopes(h, "cuda") if alibi else None
        for sq in sqs:
            q = bf16_randn(gen, b, h, sq, 128)
            q_positions = (kv_lengths - sq).clamp_min(0)
            got = dec_ops.flash_decode_attention(
                q, k, v, kv_lengths=kv_lengths, q_positions=q_positions, slopes=slopes
            )
            torch.cuda.synchronize()
            want = dec_ops._flash_decode_plain(
                q, k, v, kv_lengths=kv_lengths, q_positions=q_positions, k_scale=None,
                v_scale=None, slopes=slopes, block_tables=None,
            )
            name = f"cache [{b},{hkv},2048,128] kv_len {lengths} Sq={sq}{' ALiBi' if alibi else ''}"
            worst_abs = max(worst_abs, check_close("flash_decode", name, got, want))
    return worst_abs


# ---------------------------------------------------------------------------
# phase 4: the serving path at Llama-2-7B width
# ---------------------------------------------------------------------------


def requests(cfg: ModelConfig):
    """The main path's 4 requests: a question and a random [256, 4800]
    encoding each, made from the seed; and their longest prompt, in tokens."""
    bundle = TokenizerBundle.from_tokenizer(WordTokenizer(2048))
    rng = np.random.RandomState(SEED)
    prompts = ["Describe the audio.", "What is the tempo?", "Which instruments play?",
               "What is the key of this piece?"]
    rows = [
        {"example_id": str(i), "prompt": p,
         "audio_encoding": rng.randn(256, cfg.mm_hidden_size).astype(np.float32)}
        for i, p in enumerate(prompts)
    ]
    plen = max(len(build_prompt_ids(p, 256, bundle)) for p in prompts)
    return bundle, rows, plen


def run_main_path(cfg: ModelConfig, bundle: TokenizerBundle, rows):
    t0 = time.perf_counter()
    params = init_llark_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"7B-width params: {n_params / 1e9:.3f} B in bf16 on the card, "
          f"init {time.perf_counter() - t0:.2f} s")
    gen_cfg = GenerationConfig(max_new_tokens=32)
    generator = Generator(cfg, params, bundle.audio_patch_id, gen_cfg, max_cache_len=2048)

    attn_ops.flash_attention_fwd.launches = 0
    dec_ops.flash_decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = batch_infer(rows, generator, bundle)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {
        "flash_fwd": attn_ops.flash_attention_fwd.launches,
        "flash_decode": dec_ops.flash_decode_attention.launches,
    }
    print(f"batch_infer: {len(results)} requests in {wall:.3f} s; launches {launches}")
    check(len(results) == len(rows), "batch_infer lost a row")
    check(all(isinstance(r["model_completion"], str) for r in results), "no completion")
    check(launches["flash_fwd"] > 0, "the main path never launched the flash-prefill kernel")
    check(launches["flash_decode"] > 0, "the main path never launched the flash-decode kernel")
    print("completion 0:", repr(results[0]["model_completion"][:120]))

    # the same requests through the plain attention path
    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False, use_flash_decode=False)
    exact = GenerationConfig(max_new_tokens=32, stop_text="")
    gen_k = Generator(cfg, params, bundle.audio_patch_id, exact, max_cache_len=2048)
    gen_p = Generator(plain_cfg, params, bundle.audio_patch_id, exact, max_cache_len=2048)
    agree, total, prefill_ms, decode_ms = 0, 0, [], []
    for row in rows:
        ids = build_prompt_ids(row["prompt"], 256, bundle)
        plen = len(ids)
        s = int(np.ceil(plen / 128) * 128)
        input_ids = np.full((1, s), bundle.pad_token_id, np.int32)
        input_ids[0, :plen] = ids
        args = (input_ids, np.array([plen], np.int32), row["audio_encoding"][None],
                np.array([256], np.int32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_k, _ = gen_k.prefill(*args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks_k = gen_k.generate(*args)[0]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        logits_p, _ = gen_p.prefill(*args)
        toks_p = gen_p.generate(*args)[0]
        check(tuple(logits_k.shape) == (1, cfg.vocab_size), f"logits shape {logits_k.shape}")
        check(bool(torch.isfinite(logits_k).all()), "non-finite prefill logits")
        rel, diff = rel_err(logits_k, logits_p)
        print(f"prompt {plen} tokens (padded {s}): prefill logits vs plain path "
              f"max|d| {diff:.3e}, rel-to-max {rel:.3e}")
        check(rel <= LOGITS_TOL, f"prefill logits rel err {rel:.3e} > {LOGITS_TOL}")
        agree += sum(a == b for a, b in zip(toks_k, toks_p))
        total += len(toks_p)
        prefill_ms.append((t1 - t0) * 1e3)
        decode_ms.append(((t2 - t1) - (t1 - t0)) * 1e3 / (len(toks_k) - 1))
    print(f"greedy tokens equal to the plain path: {agree}/{total}")
    p_ms, d_ms = statistics.median(prefill_ms), statistics.median(decode_ms)
    print(f"7B serving, batch 1, prompt {plen} (padded to {s}): prefill {p_ms:.2f} ms, "
          f"decode {d_ms:.2f} ms/token, {1e3 / d_ms:.1f} tok/s (medians of 4 requests)")
    profile_device(lambda: gen_k.generate(*args), (t2 - t1) * 1e3)
    del params, generator, gen_k, gen_p
    torch.cuda.empty_cache()
    return launches


def profile_device(fn, wall_ms: float, top: int = 8) -> None:
    """Device kernel time of one fn() run from torch.profiler, beside the
    same run's unprofiled wall time: the card's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        print("device busy time: not measured (the profiler saw no device time)")
        return
    print(f"one generate (prefill + 31 decode steps): wall {wall_ms:.1f} ms unprofiled, "
          f"device kernels {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<6d} {e.key[:90]}")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# phase 5: timings
# ---------------------------------------------------------------------------


def sdpa(q, k, v, mask):
    # library yardstick only: the port never calls it
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def time_flash_fwd(gen, plen, b):
    h, s, d = 32, 384, 128
    q, k, v = (bf16_randn(gen, b, h, s, d) for _ in range(3))
    # int32 lengths, as the decoder passes them: the wrapper converts nothing
    kv = torch.full((b,), plen, dtype=torch.int32, device="cuda")
    ms = median_ms(lambda: attn_ops.flash_attention_fwd(q, k, v, kv_lengths=kv))
    plain_ms = median_ms(lambda: attn_ops._flash_attention_fwd_plain(
        q, k, v, causal=True, kv_lengths=kv, slopes=None))
    pos = torch.arange(s, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < kv[:, None, None])
    lib_ms = median_ms(lambda: sdpa(q, k, v, mask[:, None]))
    # bytes: q and o whole, k and v live rows only; FLOPs: 4*D per visible
    # (query, key) pair
    live = min(plen, s)
    nbytes = 2 * (2 * b * h * s * d) + 2 * (2 * b * h * live * d) + 4 * b
    qi = np.arange(s)[:, None]
    ki = np.arange(s)[None, :]
    pairs = int(((ki <= qi) & (ki < live)).sum())
    flops = 4.0 * d * b * h * pairs
    return ms, plain_ms, lib_ms, bound(nbytes, flops), f"[{b},{h},{s},{d}] causal, kv_len {plen}"


def time_flash_decode(gen, kv_len, b):
    h, s, d = 32, 2048, 128
    q = bf16_randn(gen, b, h, 1, d)
    k, v = bf16_randn(gen, b, h, s, d), bf16_randn(gen, b, h, s, d)
    kv = torch.full((b,), kv_len, dtype=torch.int32, device="cuda")
    qpos = kv - 1
    ms = median_ms(lambda: dec_ops.flash_decode_attention(
        q, k, v, kv_lengths=kv, q_positions=qpos))
    plain_ms = median_ms(lambda: dec_ops._flash_decode_plain(
        q, k, v, kv_lengths=kv, q_positions=qpos, k_scale=None, v_scale=None,
        slopes=None, block_tables=None))
    mask = (torch.arange(s, device="cuda")[None, :] < kv[:, None])[:, None, None, :]
    lib_ms = median_ms(lambda: sdpa(q, k, v, mask))
    nbytes = 2 * (2 * b * h * d) + 2 * (2 * b * h * kv_len * d) + 8 * b
    flops = 4.0 * d * b * h * kv_len
    return ms, plain_ms, lib_ms, bound(nbytes, flops), f"q [{b},{h},1,{d}], cache S={s}, kv_len {kv_len}"


# ---------------------------------------------------------------------------
# phase 6 (A): the flash-decode kernel's int8 and paged modes (K2')
# ---------------------------------------------------------------------------

SERVE_LENGTHS = [300, 305, 311, 318, 322, 329, 334, 340]  # ragged live lengths, batch 8


def k2_inputs(gen, mode: str, hkv: int = 32, sq: int = 1, bs: int = 128, s: int = 2048):
    """q [8, 32, sq, 128] bf16 and a cache of `s` positions per row in one
    of the modes "bf16" or "int8" (dense), "paged" or "paged_int8". Paged
    tables are random permutations of the pool's blocks (scattered, not
    consecutive), with the 8 parking blocks first as the server lays the
    pool out."""
    b, h, d = len(SERVE_LENGTHS), 32, 128
    q = bf16_randn(gen, b, h, sq, d)
    kw = dict(kv_lengths=torch.tensor(SERVE_LENGTHS, device="cuda"))
    kw["q_positions"] = kw["kv_lengths"] - sq
    if mode.startswith("paged"):
        max_blocks = s // bs
        n_blocks = b + b * max_blocks
        k, v = bf16_randn(gen, n_blocks, hkv, bs, d), bf16_randn(gen, n_blocks, hkv, bs, d)
        perm = torch.randperm(n_blocks - b, generator=gen, device="cuda") + b
        kw["block_tables"] = perm.reshape(b, max_blocks).to(torch.int32)
    else:
        k, v = bf16_randn(gen, b, hkv, s, d), bf16_randn(gen, b, hkv, s, d)
    if mode.endswith("int8"):
        (k, kw["k_scale"]), (v, kw["v_scale"]) = _quantize_kv(k), _quantize_kv(v)
    return q, k, v, kw


def k2_plain(q, k, v, kw):
    return dec_ops._flash_decode_plain(
        q, k, v, kv_lengths=kw["kv_lengths"], q_positions=kw["q_positions"],
        k_scale=kw.get("k_scale"), v_scale=kw.get("v_scale"), slopes=kw.get("slopes"),
        block_tables=kw.get("block_tables"))


# K2' rows of the kernels line: (name, input mode of k2_inputs, block size,
# the serving mode of phase 7 whose run gives its launches, that run's
# cache mode); paged int8 is the run-of-record mode (a)
K2_ROWS = (("flash_decode_int8", "int8", 0, "d", "dense_int8"),
           ("flash_decode_paged", "paged", 16, "c", "paged_bf16"),
           ("flash_decode_paged_int8", "paged_int8", 128, "a", "paged_int8"))


def check_flash_decode_modes(gen: torch.Generator):
    """The flash-decode kernel in every cache mode against its plain
    version at 7B serving shapes: q [8,32,1,128], 2048-position caches,
    live lengths 300-340. Both sides compute in fp32 from the same int8
    values and scales. The worst max |diff| per row of the kernels line."""
    cases = [
        ("flash_decode", "dense bf16", dict(mode="bf16")),
        ("flash_decode_int8", "dense int8", dict(mode="int8")),
        ("flash_decode_paged", "paged bf16, 16-token blocks", dict(mode="paged", bs=16)),
        ("flash_decode_paged", "paged bf16, 128-token blocks", dict(mode="paged", bs=128)),
        ("flash_decode_paged_int8", "paged int8, 128-token blocks",
         dict(mode="paged_int8", bs=128)),
        ("flash_decode_paged_int8", "paged int8, 128-token blocks, Sq=5, GQA Hkv=8 + ALiBi",
         dict(mode="paged_int8", bs=128, sq=5, hkv=8, alibi=True)),
        ("flash_decode_int8", "dense int8, Sq=5, GQA Hkv=8 + ALiBi",
         dict(mode="int8", sq=5, hkv=8, alibi=True)),
    ]
    worst = {}
    for row, name, case in cases:
        alibi = case.pop("alibi", False)
        q, k, v, kw = k2_inputs(gen, **case)
        if alibi:
            kw["slopes"] = attn_ops.alibi_slopes(32, "cuda")
        got = dec_ops.flash_decode_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if "paged" in name:
            name += ", scattered tables"
        err = check_close("flash_decode", f"{name}, kv_len 300-340", got, k2_plain(q, k, v, kw))
        worst[row] = max(worst.get(row, 0.0), err)
    return worst


def check_flash_fwd_admission(gen: torch.Generator, lengths) -> float:
    """The flash-prefill kernel at the shape one-shot admission gives it in
    phase 7 (modes (b) and (d)): 8 admitted prompts padded to the 512-token
    bucket, causal, each row's own length; and a wave of 5 prompts padded
    with 3 one-token rows, as the server pads a short wave. The worst max
    |diff|."""
    worst = 0.0
    for name, lens in ((f"kv_len {lengths}", lengths),
                       ("5 prompts + 3 one-token rows", lengths[:5] + [1, 1, 1])):
        q, k, v = (bf16_randn(gen, 8, 32, 512, 128) for _ in range(3))
        kv_lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = attn_ops.flash_attention_fwd(q, k, v, kv_lengths=kv_lengths)
        torch.cuda.synchronize()
        want = attn_ops._flash_attention_fwd_plain(
            q, k, v, causal=True, kv_lengths=kv_lengths, slopes=None)
        worst = max(worst, check_close(
            "flash_fwd", f"serving admission [8,32,512,128] causal, {name}", got, want))
    return worst


def time_flash_decode_mode(gen, mode: str, bs: int):
    """(ms, plain_ms, sdpa_ms, (bound_ms, bound_by), shape) of one K2' mode
    at the phase-6 shape. The bound counts the live bytes: K and V up to
    each row's length (int8 or bf16), their fp32 scales, the live table
    entries, q and out."""
    q, k, v, kw = k2_inputs(gen, mode, bs=bs)
    ms = median_ms(lambda: dec_ops.flash_decode_attention(q, k, v, **kw))
    plain_ms = median_ms(lambda: k2_plain(q, k, v, kw))
    # printed beside it only: SDPA over a dense bf16 view of the same cache
    # (no single PyTorch call reads an int8 or paged cache)
    kd, vd = k, v
    if "block_tables" in kw:
        kd, vd = dec_ops._dense_view(k, kw["block_tables"]), dec_ops._dense_view(v, kw["block_tables"])
    if "k_scale" in kw:
        ks, vs = kw["k_scale"], kw["v_scale"]
        if "block_tables" in kw:
            ks, vs = dec_ops._dense_view(ks, kw["block_tables"]), dec_ops._dense_view(vs, kw["block_tables"])
        kd = (kd.float() * ks[..., None]).to(torch.bfloat16)
        vd = (vd.float() * vs[..., None]).to(torch.bfloat16)
    s = kd.shape[2]
    mask = (torch.arange(s, device="cuda")[None, :] < kw["kv_lengths"][:, None])[:, None, None, :]
    sdpa_ms = median_ms(lambda: sdpa(q, kd, vd, mask))
    b, h, sq, d = q.shape
    hkv, live = k.shape[1], sum(SERVE_LENGTHS)
    elem = 1 if mode.endswith("int8") else 2
    nbytes = 2 * hkv * live * d * elem + 2 * 2 * b * h * sq * d + 8 * b
    if mode.endswith("int8"):
        nbytes += 2 * hkv * live * 4
    if mode.startswith("paged"):
        nbytes += 4 * sum(-(-n // bs) for n in SERVE_LENGTHS)
    flops = 4.0 * d * h * sq * live
    return ms, plain_ms, sdpa_ms, bound(nbytes, flops), (
        f"{mode}{f' bs {bs}' if bs else ''}, q [{b},{h},{sq},{d}], 2048-position caches, "
        f"kv_len 300-340")


# ---------------------------------------------------------------------------
# phase 7 (B): the serving engine at Llama-2-7B width
# ---------------------------------------------------------------------------

# server modes: (label, description, its flash-decode cache mode,
# kv_cache_quant, server keywords); the modes without prefill_chunk admit in
# one shot, through the flash-prefill kernel (chunked admission attends the
# cache through the plain route, as on the TPU)
SERVER_MODES = (
    ("a", "run-of-record: paged 128-token blocks, int8 KV, prefill_chunk 256", "paged_int8",
     True, dict(kv_block_size=128, prefill_chunk=256)),
    ("b", "dense bf16 cache, one-shot admission", "dense_bf16", False, {}),
    ("c", "paged bf16, 16-token blocks, prefill_chunk 256, prefix caching", "paged_bf16",
     False, dict(kv_block_size=16, prefill_chunk=256, prefix=True)),
    ("d", "dense int8 cache, one-shot admission", "dense_int8", True, {}),
)


def serving_requests(cfg: ModelConfig, bundle: TokenizerBundle, n: int, seed: int):
    """n requests: the four prompts of requests() in turn, each with a
    random [256, 4800] encoding made from `seed`."""
    rng = np.random.RandomState(seed)
    prompts = ["Describe the audio.", "What is the tempo?", "Which instruments play?",
               "What is the key of this piece?"]
    out = []
    for i in range(n):
        ids = np.asarray(build_prompt_ids(prompts[i % 4], 256, bundle), np.int32)
        out.append(Request(ids, rng.randn(256, cfg.mm_hidden_size).astype(np.float32)))
    return out


def profile_round(server: BatchedServer):
    """Wall time of one decode round over the live slots, unprofiled, and
    the device kernel time of the next one from torch.profiler: the card's
    idle share in a round."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server._decode_round()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server._decode_round()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        return wall_ms, None, "not measured (the profiler saw no device time)"
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    return wall_ms, busy_ms, "; ".join(
        f"{e.self_device_time_total / 1e3:.2f} ms x{e.count} {e.key[:60]}" for e in top)


@torch.inference_mode()
def run_serving_engine(cfg: ModelConfig, bundle: TokenizerBundle):
    """Drive BatchedServer at full 7B width in each cache mode; check and
    print what each did. Returns the flash-decode launches by cache mode of
    each mode's serve() run."""
    params = init_llark_params(cfg, seed=SEED, device="cuda")
    gen_cfg = GenerationConfig(max_new_tokens=32, stop_text="")
    base = dict(max_batch=8, max_cache_len=2048, prompt_buckets=(512,), max_audio_frames=256,
                decode_chunk=8, tokenizer=bundle.tokenizer)
    launches = {}
    for label, name, own_mode, quant, extra in SERVER_MODES:
        mcfg = dataclasses.replace(cfg, kv_cache_quant=quant)
        kw = dict(base, **extra)
        reqs = serving_requests(cfg, bundle, 16, SEED)
        if kw.pop("prefix", False):
            kw["shared_prefix_ids"] = _common_prompt_prefix(
                [r.input_ids for r in reqs], bundle.audio_patch_id,
                min_len=max(8, kw["kv_block_size"]))
        server = BatchedServer(mcfg, params, bundle.audio_patch_id, gen_cfg, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dec_ops.reset_launch_counts()
        attn_ops.flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        server.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_mode = dict(dec_ops.flash_decode_attention.launches_by_mode)
        fwd_launches = attn_ops.flash_attention_fwd.launches
        launches[label] = by_mode
        stats = server.stats(reqs)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        print(f"serving ({label}) {name}: 16 requests x 32 tokens in {wall:.2f} s, "
              f"{stats['tokens_per_sec']:.1f} tokens/s, mean TTFT {stats['mean_ttft_s']:.3f} s, "
              f"peak memory {peak_gb:.2f} GiB; flash-decode launches by cache mode {by_mode}, "
              f"flash-prefill launches {fwd_launches}")
        check(all(r.done and r.error is None and len(r.tokens) == 32 for r in reqs),
              f"serving ({label}): a request did not finish with 32 tokens")
        check(by_mode[own_mode] > 0, f"serving ({label}): no flash-decode launch in {own_mode}")
        check(sum(by_mode.values()) == by_mode[own_mode],
              f"serving ({label}): flash-decode launched in another cache mode: {by_mode}")
        if "prefill_chunk" not in extra:
            check(fwd_launches > 0, f"serving ({label}): one-shot admission never launched "
                                    "the flash-prefill kernel")

        # one cache state after admission: 8 live slots
        server._queue = serving_requests(cfg, bundle, 8, SEED + 1)
        for r in server._queue:
            r.submitted_at = time.time()
        server._admit()
        server._refresh_tables()
        # one decode step from that state through the kernel route and
        # through the plain route (it rewrites the same K/V at the same
        # positions, so the second step sees the first one's cache)
        token = torch.as_tensor(server._tokens_in_flight, dtype=torch.int64, device="cuda")
        pos = torch.as_tensor(server._write_pos, dtype=torch.int64, device="cuda")
        plain_cfg = dataclasses.replace(server.cfg, use_flash_decode=False)
        # (the returned cache is the server's own: bind only the logits, so
        # that the cache goes with the server at the end of the mode)
        lk = decode_step(server.cfg, params, token, server._cache, pos)[0]
        lp = decode_step(plain_cfg, params, token, server._cache, pos)[0]
        check(bool(torch.isfinite(lk).all()), f"serving ({label}): non-finite decode logits")
        rel, diff = rel_err(lk, lp)
        print(f"  one decode step from the admitted state, kernel vs plain route: "
              f"max|d| {diff:.3e}, rel-to-max {rel:.3e}")
        check(rel <= LOGITS_TOL, f"serving ({label}): decode logits rel err {rel:.3e}")
        wall_ms, busy_ms, top = profile_round(server)
        if busy_ms is None:
            print(f"  one decode round (8 slots x 8 tokens): wall {wall_ms:.1f} ms; device {top}")
        else:
            print(f"  one decode round (8 slots x 8 tokens): wall {wall_ms:.1f} ms unprofiled, "
                  f"device kernels {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.1%}; {top}")
        del server
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 8: training kernels against their plain versions
# ---------------------------------------------------------------------------

TRAIN_SHAPE = (2, 32, 1024, 128)  # the training path's q/k/v: batch 2, 1024 tokens
TRAIN_LENGTHS = [1024, 700]


def check_flash_bwd(gen: torch.Generator):
    """LSE, dq and dk/dv against their plain versions; the worst max |diff|
    of each kernel."""
    b, h, s, d = TRAIN_SHAPE
    cases = [
        (f"main path [{b},{h},{s},{d}] causal, kv_len {TRAIN_LENGTHS}", h, d, False),
        ("GQA Hkv=8 + ALiBi", 8, d, True),
        ("head_dim 64", h, 64, False),
    ]
    worst = {"flash_fwd_lse": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for name, hkv, dd, alibi in cases:
        q, do = bf16_randn(gen, b, h, s, dd), bf16_randn(gen, b, h, s, dd)
        k, v = bf16_randn(gen, b, hkv, s, dd), bf16_randn(gen, b, hkv, s, dd)
        kv = torch.tensor(TRAIN_LENGTHS, device="cuda")
        kw = dict(causal=True, kv_lengths=kv, slopes=attn_ops.alibi_slopes(h, "cuda") if alibi else None)
        out, lse = attn_ops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        _, lse_p = attn_ops._flash_attention_fwd_plain(q, k, v, return_lse=True, **kw)
        lse_err = (lse - lse_p).abs().max().item()
        print(f"flash_fwd log-sum-exp {name}: max|d| {lse_err:.3e}")
        check(lse_err <= LSE_TOL, f"log-sum-exp {name}: {lse_err:.3e} > {LSE_TOL}")
        worst["flash_fwd_lse"] = max(worst["flash_fwd_lse"], lse_err)
        delta = (do.float() * out.float()).sum(-1)
        dq = attn_ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = attn_ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        pdq, pdk, pdv = attn_ops._flash_bwd_plain(q, k, v, do, lse, delta, **kw)
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], check_close("flash_bwd_dq", name, dq, pdq))
        for part, got, want in (("dk", dk, pdk), ("dv", dv, pdv)):
            err = check_close("flash_bwd_dkv", f"{part} {name}", got, want)
            worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], err)
            # keys at or past kv_len get exact zeros
            check(bool((got[1, :, TRAIN_LENGTHS[1]:] == 0).all()), f"{part}: a dead key is not zeros")
    return worst


# ---------------------------------------------------------------------------
# phases 9-11: the training path
# ---------------------------------------------------------------------------

# one step at 7B width, kernel path vs plain attention path (both bf16): the
# loss read 3.2e-3 apart and the projector gradient 1.15e-2 relative to max
# on an H100 80GB HBM3 at 700 W; the limits sit a few bf16 ulps above
TRAIN_ABS_LOSS_TOL = 1e-2
TRAIN_GRAD_TOL = 3e-2


def write_shards(directory: str, cfg: ModelConfig) -> str:
    """4 identical samples (one question, one answer, a [256, 4800] random
    encoding made from the seed): every training batch holds the same
    example, so the loss of a few steps must fall."""
    enc = np.random.RandomState(SEED).randn(256, cfg.mm_hidden_size).astype(np.float32)
    writer = TarShardWriter(os.path.join(directory, "mir-train-%05d.tar"), max_count=100)
    for i in range(4):
        writer.write({
            "__key__": f"clip{i:03d}",
            "json": {"response": [{"question": "What is the tempo of this piece ?",
                                   "answer": "It is a slow ballad at 70 beats per minute ."}]},
            "audio_encoding.pyd": enc,
        })
    writer.close()
    return writer.written_paths[0]


def train_args(directory: str, shard: str, steps: int, lr: float = 1e-3, **flags):
    model_args = ModelArguments(model_name_or_path="llama2-7b", **flags)
    data_args = DataArguments(train_data_path=shard, max_audio_frames=256,
                              task_sample_probs={"mir": 1.0})
    training_args = TrainingArguments(
        output_dir=os.path.join(directory, "out"), per_device_train_batch_size=2,
        gradient_accumulation_steps=2, model_max_length=1024, learning_rate=lr,
        max_steps=steps, save_steps=10**6, logging_steps=1, seed=SEED,
        profile_dir=os.path.join(directory, "profile"), profile_start_step=steps - 1,
        profile_num_steps=1, checkpoint_on_preemption=False,
    )
    return model_args, data_args, training_args


def check_gradient_through_kernels(cfg: ModelConfig, directory: str, shard: str) -> None:
    """One training step's loss and projector gradient at 7B width and 2
    layers, with the flash kernels and with the plain attention path: the
    kernels' backward reaches q, k and v."""
    small = dataclasses.replace(cfg, num_layers=2)
    model_args, data_args, training_args = train_args(directory, shard, 1)
    bundle = TokenizerBundle.from_tokenizer(WordTokenizer(1024))
    batch = next(iter(make_data_module(
        bundle, data_args, batch_size=2, max_seq_len=1024, mm_hidden_size=cfg.mm_hidden_size,
        seed=SEED)["train_iterator"]()))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items() if isinstance(v, np.ndarray)}
    params = init_llark_params(small, seed=SEED, device="cuda")
    proj = params["mm_projector"]["kernel"].requires_grad_()
    results = {}
    for use_kernels in (True, False):
        c = dataclasses.replace(small, use_pallas_attention=use_kernels)
        attn_ops.flash_attention_bwd_dq.launches = 0
        loss, _ = make_loss_fn(c, audio_patch_id=bundle.audio_patch_id)(params, batch)
        (grad,) = torch.autograd.grad(loss, [proj])
        results[use_kernels] = (loss.item(), grad, attn_ops.flash_attention_bwd_dq.launches)
    (lk, gk, nk), (lp, gp, _) = results[True], results[False]
    rel, _ = rel_err(gk, gp)
    print(f"7B width, 2 layers, one step: loss {lk:.5f} (kernels) vs {lp:.5f} (plain), "
          f"projector gradient rel-to-max {rel:.3e}, |grad| {gk.norm().item():.4e} vs "
          f"{gp.norm().item():.4e}; dq launches {nk}")
    check(nk == small.num_layers, "the kernel path did not run the flash backward")
    check(abs(lk - lp) <= TRAIN_ABS_LOSS_TOL, f"loss differs by {abs(lk - lp):.3e}")
    check(rel <= TRAIN_GRAD_TOL, f"projector gradient rel err {rel:.3e} > {TRAIN_GRAD_TOL}")
    del params, proj, batch
    torch.cuda.empty_cache()


def device_split(trace_path: str, wall_ms: float, top: int = 6) -> None:
    """Device kernel time of one profiled train step (its chrome trace)
    beside the unprofiled median step time: the card's idle share."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels.setdefault(e["name"], [0.0, 0])
            kernels[e["name"]][0] += e.get("dur", 0.0) / 1e3
            kernels[e["name"]][1] += 1
    busy = sum(ms for ms, _ in kernels.values())
    if busy <= 0:
        print("device busy time: not measured (the trace holds no device kernels)")
        return
    print(f"  one step: device kernels {busy:.1f} ms against a median step of {wall_ms:.1f} ms, "
          f"idle share {1 - busy / wall_ms:.1%}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:8.2f} ms  x{n:<5d} {name[:90]}")


def run_training(label: str, cfg: ModelConfig, directory: str, shard: str, steps: int,
                 frozen_base: bool, lr: float, **flags):
    """Drive `train()` on the card; check and print what the path did.
    Returns the launches of the three training kernels in the run."""
    model_args, data_args, training_args = train_args(directory, shard, steps, lr, **flags)
    torch.cuda.reset_peak_memory_stats()
    counters = (attn_ops.flash_attention_fwd, attn_ops.flash_attention_bwd_dq,
                attn_ops.flash_attention_bwd_dkv)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    result = train(model_args, data_args, training_args, model_cfg=cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    losses = result["losses"]
    with open(os.path.join(training_args.output_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    # the first step warms up, the last one is profiled
    step_ms = statistics.median(r["step_time_s"] for r in records[1:-1]) * 1e3
    tokens = (training_args.per_device_train_batch_size * training_args.gradient_accumulation_steps
              * training_args.model_max_length)
    tok_s = tokens / (step_ms / 1e3)
    mfu = flops.train_mfu(cfg, training_args.model_max_length, tok_s, frozen_base=frozen_base)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label}: {steps} steps in {wall:.1f} s; losses {[round(x, 4) for x in losses]}; "
          f"grad norms {[round(r['grad_norm'], 4) for r in records]}")
    print(f"  median step {step_ms:.1f} ms, {tok_s:.0f} tokens/s (batch 2 x 2 x 1024 positions), "
          f"MFU {mfu:.1%}, peak memory {peak_gb:.2f} GiB, launches per step "
          f"{ {k: v / steps for k, v in launches.items()} }")
    device_split(os.path.join(training_args.profile_dir, "trace.json"), step_ms)
    check(result["final_step"] == steps, f"{label}: stopped at step {result['final_step']}")
    check(all(np.isfinite(r["grad_norm"]) for r in records), f"{label}: a non-finite grad norm")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall ({losses[0]:.4f} -> {losses[-1]:.4f})")
    check(all(n > 0 for n in launches.values()), f"{label}: a training kernel never launched: {launches}")
    del result
    shutil.rmtree(directory)  # the checkpoint: 27 GB at 32 layers
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 12: training kernels' timings
# ---------------------------------------------------------------------------


def time_flash_bwd(gen):
    """(dq row, dkv row) timings at the training shape: (ms, plain_ms,
    library_ms, (bound_ms, bound_by), shape)."""
    b, h, s, d = TRAIN_SHAPE
    q, k, v, do = (bf16_randn(gen, b, h, s, d) for _ in range(4))
    kv = torch.tensor(TRAIN_LENGTHS, dtype=torch.int32, device="cuda")
    out, lse = attn_ops.flash_attention_fwd(q, k, v, kv_lengths=kv, return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    kw = dict(causal=True, kv_lengths=kv, slopes=None)
    # library yardstick: SDPA forward and backward (dq, dk and dv together)
    # at the same mask; no query row here is without a visible key, which
    # would make SDPA's softmax NaN
    pos = torch.arange(s, device="cuda")
    mask = ((pos[None, :] <= pos[:, None]) & (pos[None, :] < kv[:, None, None]))[:, None]
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = sdpa(ql, kl, vl, mask)
    # visible (query, key) pairs; the forward does 2 products of 2*D FLOPs
    # per pair, dq 3, dk/dv 4; bytes: inputs read once (bf16 q and dO whole,
    # k and v up to each row's kv_len only; fp32 lse, delta), outputs
    # written once (dk, dv whole: dead keys get zeros)
    qi, ki = np.arange(s)[:, None], np.arange(s)[None, :]
    pairs = sum(int(((ki <= qi) & (ki < n)).sum()) for n in TRAIN_LENGTHS) * h
    tensor = 2 * b * h * s * d  # one bf16 [B, H, S, D]
    live_kv = 2 * h * d * sum(TRAIN_LENGTHS)  # one bf16 k or v, live rows
    fwd_ms = median_ms(lambda: attn_ops.flash_attention_fwd(q, k, v, return_lse=True, **kw))
    fwd_plain = median_ms(lambda: attn_ops._flash_attention_fwd_plain(q, k, v, return_lse=True, **kw))
    fwd_lib = median_ms(lambda: sdpa(q, k, v, mask))
    fwd_bound, fwd_by = bound(2 * tensor + 2 * live_kv + 4 * b * h * s, 4.0 * d * pairs)
    print(f"flash_fwd with log-sum-exp at [{b},{h},{s},{d}] causal, kv_len {TRAIN_LENGTHS}: "
          f"kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, SDPA {fwd_lib:.4f} ms, "
          f"bound {fwd_bound:.4f} ms ({fwd_by}), {fwd_bound / fwd_ms:.1%} of bound")
    dq_ms = median_ms(lambda: attn_ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw))
    dkv_ms = median_ms(lambda: attn_ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
    plain_ms = median_ms(lambda: attn_ops._flash_bwd_plain(q, k, v, do, lse, delta, **kw))
    lib_ms = median_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True))
    io_in = 2 * tensor + 2 * live_kv + 2 * 4 * b * h * s
    dq_bound = bound(io_in + tensor, 6.0 * d * pairs)
    dkv_bound = bound(io_in + 2 * tensor, 8.0 * d * pairs)
    shape = f"[{b},{h},{s},{d}] causal, kv_len {TRAIN_LENGTHS}"
    return ((dq_ms, plain_ms, lib_ms, dq_bound, shape), (dkv_ms, plain_ms, lib_ms, dkv_bound, shape))


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for src, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = ModelConfig.llama2_7b(use_flash_decode=True, param_dtype="bfloat16")
    bundle, rows, plen = requests(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    fwd_err = check_flash_fwd(gen, plen)
    dec_err = check_flash_decode(gen, plen)
    launches = run_main_path(cfg, bundle, rows)
    k2_err = check_flash_decode_modes(gen)
    dec_err = max(dec_err, k2_err["flash_decode"])
    admitted = [len(r.input_ids) for r in serving_requests(cfg, bundle, 8, SEED)]
    fwd_err = max(fwd_err, check_flash_fwd_admission(gen, admitted))
    serving = run_serving_engine(cfg, bundle)

    bwd_err = check_flash_bwd(gen)
    train_cfg = ModelConfig.llama2_7b()  # fp32 parameters, bf16 compute, remat
    with tempfile.TemporaryDirectory() as tmp:
        shard = write_shards(tmp, train_cfg)
        check_gradient_through_kernels(train_cfg, os.path.join(tmp, "grad"), shard)
        adapter = run_training(
            "adapter stage, Llama-2-7B, 32 layers", train_cfg, os.path.join(tmp, "adapter"),
            shard, 6, frozen_base=True, lr=1e-3, freeze_backbone=True, tune_mm_mlp_adapter=True)
        run_training(
            "run-of-record flags, 7B width, 4 layers", dataclasses.replace(train_cfg, num_layers=4),
            os.path.join(tmp, "full"), shard, 6, frozen_base=False, lr=1e-4,
            tune_mm_mlp_adapter=True)
    launches.update(flash_bwd_dq=adapter["flash_attention_bwd_dq"],
                    flash_bwd_dkv=adapter["flash_attention_bwd_dkv"])

    kernels = []
    for name, src, replaces, err, time_fn, length in (
        ("flash_fwd", "llark_tpu_torch/csrc/flash_fwd.cu",
         "llark_tpu/ops/attention.py:319", fwd_err, time_flash_fwd, plen),
        # the decode steps' live length runs from plen to plen + 31: the middle
        ("flash_decode", "llark_tpu_torch/csrc/flash_decode.cu",
         "llark_tpu/ops/decode_attention.py:495", dec_err, time_flash_decode, plen + 16),
    ):
        # batch 1 is what batch_infer gives the kernel: the JSON line reports
        # it; batch 4 is printed beside it
        for b in (4, 1):
            ms, plain_ms, lib_ms, (bound_ms, bound_by), shape = time_fn(gen, length, b)
            print(f"{name} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"SDPA {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{bound_ms / ms:.1%} of bound")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms,
        })
    # K2': each cache mode at the phase-6 shape, launches from the serving
    # mode that runs it
    for name, mode, bs, label, cache_mode in K2_ROWS:
        ms, plain_ms, sdpa_ms, (bound_ms, bound_by), shape = time_flash_decode_mode(gen, mode, bs)
        print(f"{name} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA over a "
              f"dense bf16 view {sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of bound")
        kernels.append({
            "name": name, "route": "cuda", "source": "llark_tpu_torch/csrc/flash_decode.cu",
            "replaces": "llark_tpu/ops/decode_attention.py:495",
            "launches": serving[label][cache_mode], "max_abs_err": k2_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    # the training kernels, at the training path's shape; their launches are
    # the adapter stage's (32 layers x 2 micro-batches x 6 steps)
    bwd_rows = time_flash_bwd(gen)
    for name, replaces, (ms, plain_ms, lib_ms, (bound_ms, bound_by), shape) in zip(
        ("flash_bwd_dq", "flash_bwd_dkv"),
        ("llark_tpu/ops/attention.py:536", "llark_tpu/ops/attention.py:570"), bwd_rows,
    ):
        print(f"{name} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (dq, dk and dv), "
              f"SDPA backward {lib_ms:.4f} ms (dq, dk and dv), bound {bound_ms:.4f} ms "
              f"({bound_by}), {bound_ms / ms:.1%} of bound")
        kernels.append({
            "name": name, "route": "cuda", "source": "llark_tpu_torch/csrc/flash_bwd.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": bwd_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms,
        })
    print(f"flash_fwd log-sum-exp, worst |d| {bwd_err['flash_fwd_lse']:.3e}")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
