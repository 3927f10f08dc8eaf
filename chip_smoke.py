#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llark_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final line:
  1. the card's name and power limit; build every CUDA kernel from
     llark_tpu_torch/csrc/ (nvcc, one process per source, in parallel);
     how the device time of the two quantized products at the reported
     shape divides between the product and the combine kernel;
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
     and with GQA + ALiBi and head_dim 64: the forward's log-sum-exp and
     the flash backward's dq, dk and dv (one call: delta, the products,
     dq's rounding);
  9. one training step's loss and projector gradient at 7B width, 2 layers,
     through the flash kernels and through the plain attention path (2
     flash backward launches);
 10. the adapter stage at full Llama-2-7B (32 layers, fp32 parameters,
     frozen backbone, remat) through `train()` on shards written to a temp
     dir: batch 2 x 2 accumulation steps, 1024 tokens, 256 x 4800 audio
     frames; the loss must fall;
 11. the run-of-record flags (the whole model trains) at 7B width, 4
     layers, likewise; for both: median step ms, tokens/s, MFU, peak
     memory, launches of the flash forward and backward per step (the
     backward exactly one per layer per micro-batch: 64 in the adapter
     stage) and the card's idle share in a torch.profiler trace of one step;
 12. the training kernels' timings at the phase-8 shape beside their plain
     versions and PyTorch's scaled_dot_product_attention (the whole
     backward, delta included, against SDPA's backward with the same mask;
     the old wrapper's PyTorch delta alone; at kv_len [1024, 1024] against
     SDPA is_causal=True as a second reference); and the
     flash-decode kernel's int8 and paged modes at the phase-6 shape beside
     their plain version (no single PyTorch call reads an int8 or paged
     cache: SDPA over a dense bf16 view is printed beside them);
 13. the two weight-only quantized products (int8, int4 with 128-row groups)
     against their plain versions, bf16, weights quantized from seeded
     randn * 0.02: (K, N) in (4096, 4096), (4096, 11008), (11008, 4096) x
     M in 1, 8, 293, 384, 2048 (chunked admission, 8 x 256), 4096, and a
     ragged case (M 5, K 256, N 1000);
     each held per output row, |kernel - plain| / |plain| (L2 over N);
 14. serving from quantized weights at full Llama-2-7B width, 32 layers:
     bf16 params from the seed, quantized on the card
     (`quantize_params_int8_incremental`), then `batch_infer` (the 4 requests
     of phase 4) and `BatchedServer` in modes (a) and (b) of phase 7; then
     the same with `quantize_params_int4_incremental(layout="rows")` for
     `batch_infer` and mode (a). Gates: 224 launches (7 projections x 32
     layers) of the format's kernel around one decode step, a positive
     multiple of 224 over each run and none of the other format's; every
     request ends with 32 tokens; prefill logits and one decode step's
     logits, kernel route vs the plain products on the same quantized tree,
     within LOGITS_TOL; in mode (a) also chunked admission replayed on the
     admitted state (`paged_prefill_chunk` at [8, 256], M = 2048, 224
     launches a chunk, then `prefill_last`), its next-token logits held the
     same way. Per run: wall, tokens/s, mean TTFT, peak memory,
     parameter bytes and a decode round's device time and idle share, beside
     the bf16 figures of phases 4 and 7;
 15. the int4 cols layout (no kernel) at 7B width, 2 layers: one forward
     against the same tree dequantized to bf16 weights;
 16. timings of the two quantized products at the three (K, N) and M in 1,
     8, 384, 2048, 4096 beside their plain versions, their bounds, and two
     yardsticks that are not the same function: `torch.matmul` on a bf16
     copy of the weight, and dequantize-then-matmul; what one quantized
     projection costs the host to enqueue; and, where the installed torch
     runs them on CUDA, `torch._weight_int8pack_mm` and
     `torch._weight_int4pack_mm` at the reported shape, held against the
     kernels' outputs (the kernels line's library_ms when they agree).

Prints a {"kernels": [...]} JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Imports nothing of JAX or llark_tpu.
"""

from __future__ import annotations

import contextlib
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
from llark_tpu_torch.generate import (
    GenerationConfig,
    Generator,
    decode_step,
    paged_prefill_chunk,
    prefill_last,
)
from llark_tpu_torch.infer import _common_prompt_prefix, batch_infer, build_prompt_ids
from llark_tpu_torch.inference.server import BatchedServer, Request
from llark_tpu_torch.models import quant
from llark_tpu_torch.models.decoder import _quantize_kv, decoder_forward
from llark_tpu_torch.models.fusion import build_inputs_embeds, init_llark_params
from llark_tpu_torch.ops import _build
from llark_tpu_torch.ops import attention as attn_ops
from llark_tpu_torch.ops import decode_attention as dec_ops
from llark_tpu_torch.ops import int4_matmul as int4_ops
from llark_tpu_torch.ops import int8_matmul as int8_ops
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
# The quantized products are held per output row (L2 over the output
# channels). The int8 kernel computes the plain version's exact products in
# another order and rounds once: at most 2.9e-4 read. The int4 kernel keeps
# the group scales in fp32 and applies them to fp32 group sums, where the
# plain version rounds nibble x scale to bf16 before the product: at most
# 3.7e-3 read. Each limit is about one bf16 ulp above its reading.
ROW_TOL = {"flash_fwd": 1e-2, "flash_decode": 4e-3, "flash_bwd": 1e-2,
           "int8_matmul": 4e-3, "int4_matmul": 8e-3}
KERNEL_TOL = 2e-2
# The flash backward (dq, dk, dv) is held to the JAX package's bound for
# its flash backward, 1.6e-2 relative to max (PERFORMANCE.md:130-132). Its per-row
# measure floors each row's norm at 1e-2 of the tensor's RMS row norm: a
# dq row can be ~0 by cancellation (the first query sees one key, so its
# ds is p (dp - delta) = 0 up to rounding), and a relative error there says
# nothing. On the cases below an H100 80GB HBM3 at 700 W read at most
# 5.4e-3 per row and 6.1e-3 relative to max (PERF.md): the row limit is
# about one bf16 ulp (3.9e-3 relative) above that.
BWD_TOL = 1.6e-2
ROW_FLOOR = {"flash_bwd": 1e-2}
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


def flush_l2() -> None:
    """A 256 MB write: the next kernel finds the 50 MB L2 cache cold."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    _FLUSH.zero_()


def median_ms(fn, n: int = N_TIMED) -> float:
    """Median device time of fn over n runs, from CUDA events. Before each
    run a 256 MB write leaves the L2 cache cold (as a layer of the model
    finds it), and a sleep kernel keeps the card busy while the host
    enqueues fn, so the events time the device work and not the Python
    around the launch."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush_l2()
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


# the launch counters of the two quantized products, by weight format
WQ_KERNELS = {"int8": int8_ops.int8_matmul, "int4": int4_ops.int4_matmul}
PRODUCTS_PER_FORWARD = 7 * 32  # 7 projections x 32 layers


@contextlib.contextmanager
def plain_products():
    """Inside, the quantized products of CUDA tensors run their plain
    versions: the gates that hold the kernel route against the plain one on
    the same quantized tree use it. The package itself has no such switch.
    No kernel may launch inside: a patch that missed the name the package
    calls would hold the kernel against itself."""
    saved = int8_ops.int8_matmul, quant.int4_matmul
    before = {name: fn.launches for name, fn in WQ_KERNELS.items()}
    int8_ops.int8_matmul = lambda x, q, scale: int8_ops._int8_matmul_plain(x, q, scale)
    quant.int4_matmul = lambda x, q4, scale, group=128: int4_ops._int4_matmul_plain(x, q4, scale)
    try:
        yield
    finally:
        int8_ops.int8_matmul, quant.int4_matmul = saved
    after = {name: fn.launches for name, fn in WQ_KERNELS.items()}
    check(after == before, f"a quantized kernel launched on the plain route: {before} -> {after}")


def reset_wq_counts() -> None:
    for fn in WQ_KERNELS.values():
        fn.launches = 0


def check_wq_counts(where: str, wq: str) -> int:
    """The format's kernel ran a positive multiple of 224 times (every
    forward is 7 projections x 32 layers) and the other format's never."""
    own = WQ_KERNELS[wq].launches
    others = sum(fn.launches for name, fn in WQ_KERNELS.items() if name != wq)
    check(own > 0 and own % PRODUCTS_PER_FORWARD == 0,
          f"{where}: {own} {wq} launches is no positive multiple of {PRODUCTS_PER_FORWARD}")
    check(others == 0, f"{where}: the other format's kernel launched {others} times")
    return own


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def run_main_path(cfg: ModelConfig, bundle: TokenizerBundle, rows, params=None, wq=None):
    """`batch_infer` over the 4 requests, then per request the kernel route
    against a plain route: for bf16 weights (`wq` None) the plain attention
    path; for a quantized tree (`wq` "int8" or "int4") the plain products.
    Returns the launch counts of the batch_infer run and the run's figures."""
    label = "bf16 weights" if wq is None else f"{wq} weights"
    if params is None:
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
    reset_wq_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = batch_infer(rows, generator, bundle)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {
        "flash_fwd": attn_ops.flash_attention_fwd.launches,
        "flash_decode": dec_ops.flash_decode_attention.launches,
        "int8_matmul": int8_ops.int8_matmul.launches,
        "int4_matmul": int4_ops.int4_matmul.launches,
    }
    print(f"batch_infer ({label}): {len(results)} requests in {wall:.3f} s; launches {launches}")
    check(len(results) == len(rows), "batch_infer lost a row")
    check(all(isinstance(r["model_completion"], str) for r in results), "no completion")
    check(launches["flash_fwd"] > 0, "the main path never launched the flash-prefill kernel")
    check(launches["flash_decode"] > 0, "the main path never launched the flash-decode kernel")
    if wq is None:
        check(launches["int8_matmul"] == 0 and launches["int4_matmul"] == 0,
              "bf16 weights launched a quantized product")
    else:
        check_wq_counts(f"batch_infer ({label})", wq)
    print("completion 0:", repr(results[0]["model_completion"][:120]))

    # the same requests through the plain route
    exact = GenerationConfig(max_new_tokens=32, stop_text="")
    gen_k = Generator(cfg, params, bundle.audio_patch_id, exact, max_cache_len=2048)
    if wq is None:
        plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False, use_flash_decode=False)
        gen_p, plain, plain_name = (
            Generator(plain_cfg, params, bundle.audio_patch_id, exact, max_cache_len=2048),
            contextlib.nullcontext, "plain attention path")
    else:
        gen_p, plain, plain_name, rows = gen_k, plain_products, "plain products", rows[:2]
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
        logits_k, cache = gen_k.prefill(*args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if wq is not None:
            # one decode step from the prefilled cache: 224 launches, and its
            # logits against the plain products (the second step rewrites the
            # same K/V at the same position)
            token = logits_k.argmax(-1)
            pos = torch.tensor([plen], device="cuda")
            reset_wq_counts()
            with torch.inference_mode():
                step_k = decode_step(cfg, params, token, cache, pos)[0]
            own = check_wq_counts(f"one decode step ({label})", wq)
            check(own == PRODUCTS_PER_FORWARD, f"one decode step launched {own} {wq} products")
            with torch.inference_mode(), plain_products():
                step_p = decode_step(cfg, params, token, cache, pos)[0]
            rel, diff = rel_err(step_k, step_p)
            print(f"prompt {plen} tokens: one decode step, {own} {wq} launches; logits vs "
                  f"{plain_name} max|d| {diff:.3e}, rel-to-max {rel:.3e}")
            check(rel <= LOGITS_TOL, f"decode logits rel err {rel:.3e} > {LOGITS_TOL}")
        del cache
        torch.cuda.synchronize()
        t1b = time.perf_counter()
        toks_k = gen_k.generate(*args)[0]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with plain():
            logits_p, _ = gen_p.prefill(*args)
            toks_p = gen_p.generate(*args)[0]
        check(tuple(logits_k.shape) == (1, cfg.vocab_size), f"logits shape {logits_k.shape}")
        check(bool(torch.isfinite(logits_k).all()), "non-finite prefill logits")
        rel, diff = rel_err(logits_k, logits_p)
        print(f"prompt {plen} tokens (padded {s}): prefill logits vs {plain_name} "
              f"max|d| {diff:.3e}, rel-to-max {rel:.3e}")
        check(rel <= LOGITS_TOL, f"prefill logits rel err {rel:.3e} > {LOGITS_TOL}")
        agree += sum(a == b for a, b in zip(toks_k, toks_p))
        total += len(toks_p)
        prefill_ms.append((t1 - t0) * 1e3)
        decode_ms.append(((t2 - t1b) - (t1 - t0)) * 1e3 / (len(toks_k) - 1))
    print(f"greedy tokens equal to the {plain_name}: {agree}/{total}")
    p_ms, d_ms = statistics.median(prefill_ms), statistics.median(decode_ms)
    print(f"7B serving ({label}), batch 1, prompt {plen} (padded to {s}): prefill {p_ms:.2f} ms, "
          f"decode {d_ms:.2f} ms/token, {1e3 / d_ms:.1f} tok/s (medians of {len(rows)} requests)")
    busy_ms = profile_device(lambda: gen_k.generate(*args), (t2 - t1b) * 1e3)
    figures = dict(batch_wall_s=wall, prefill_ms=p_ms, decode_ms=d_ms, generate_wall_ms=(t2 - t1b) * 1e3,
                   generate_device_ms=busy_ms, param_gb=param_bytes(params) / 1e9)
    del params, generator, gen_k, gen_p
    torch.cuda.empty_cache()
    return launches, figures


def profile_device(fn, wall_ms: float, top: int = 8):
    """Device kernel time of one fn() run from torch.profiler, beside the
    same run's unprofiled wall time: the card's idle share. Returns the
    device ms (None if the profiler saw none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        print("device busy time: not measured (the profiler saw no device time)")
        return None
    print(f"one generate (prefill + 31 decode steps): wall {wall_ms:.1f} ms unprofiled, "
          f"device kernels {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<6d} {e.key[:90]}")
    return busy_ms


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


def check_chunked_admission(server: BatchedServer, wq: str, label: str) -> None:
    """Chunked admission of the 8 live requests once more, as the server's
    `_admit` drives it: `paged_prefill_chunk` over each [8, 256] chunk of
    the fused prompt embeddings (M = 8 x 256 = 2048 in every product) into
    the slots' own pool blocks, then `prefill_last`; first through the
    kernels, which rewrites what admission wrote, then through the plain
    products. Each chunk must launch 224 products, and the next-token
    logits of the two routes are held within LOGITS_TOL."""
    k, bucket, chunk = server.max_batch, server.prompt_buckets[-1], server.prefill_chunk
    reqs = list(server._slot_req)
    check(all(r is not None for r in reqs) and server._prefix_len == 0 and bucket % chunk == 0,
          f"serving ({label}): no full admitted state to replay")
    ids = np.zeros((k, bucket), np.int32)
    for j, r in enumerate(reqs):
        ids[j, : len(r.input_ids)] = r.input_ids
    plens = server._tensor(np.array([len(r.input_ids) for r in reqs], np.int32), torch.int32)
    audio = server._tensor(np.stack([r.audio_encoding for r in reqs]), torch.float32)
    fcnt = server._tensor(np.full((k,), audio.shape[1], np.int32), torch.int32)
    embeds = build_inputs_embeds(server.cfg, server.params, server._tensor(ids, torch.int64),
                                 audio, server.audio_patch_id, fcnt)
    view = server._pool_view(server._host_tables[:, : bucket // server.kv_block_size])
    logits = {}
    for route, ctx in (("kernel", contextlib.nullcontext), ("plain", plain_products)):
        with ctx():
            for c in range(0, bucket, chunk):
                done = WQ_KERNELS[wq].launches
                paged_prefill_chunk(server.cfg, server.params, embeds[:, c : c + chunk], plens,
                                    view, c)
                own = WQ_KERNELS[wq].launches - done
                check(own == (PRODUCTS_PER_FORWARD if route == "kernel" else 0),
                      f"serving ({label}): one admission chunk on the {route} route launched "
                      f"{own} {wq} products")
            logits[route] = prefill_last(server.cfg, server.params, embeds, plens, view, 0)[0]
    check(bool(torch.isfinite(logits["kernel"]).all()),
          f"serving ({label}): non-finite admission logits")
    firsts = logits["kernel"].argmax(-1).tolist()
    same = sum(a == int(b) for a, b in zip(firsts, server._tokens_in_flight))
    rel, diff = rel_err(logits["kernel"], logits["plain"])
    print(f"  chunked admission replayed, {bucket // chunk} chunks of [{k}, {chunk}] (M = {k * chunk}, "
          f"{PRODUCTS_PER_FORWARD} {wq} launches each): next-token logits vs the plain products "
          f"max|d| {diff:.3e}, rel-to-max {rel:.3e}; first tokens equal to the admitted ones "
          f"{same}/{k}")
    check(rel <= LOGITS_TOL, f"serving ({label}): {wq} admission logits rel err {rel:.3e}")


@torch.inference_mode()
def run_serving_engine(cfg: ModelConfig, bundle: TokenizerBundle, params=None, modes="abcd",
                       wq=None):
    """Drive BatchedServer at full 7B width in each cache mode of `modes`;
    check and print what each did. `params` may be a quantized tree of
    format `wq` ("int8" or "int4"; default: bf16 weights made here).
    Returns the flash-decode launches by cache mode of each mode's serve()
    run (plus that run's launches of the format's product under its name),
    and each mode's figures."""
    weights = "bf16 weights" if wq is None else f"{wq} weights"
    if params is None:
        params = init_llark_params(cfg, seed=SEED, device="cuda")
    gen_cfg = GenerationConfig(max_new_tokens=32, stop_text="")
    base = dict(max_batch=8, max_cache_len=2048, prompt_buckets=(512,), max_audio_frames=256,
                decode_chunk=8, tokenizer=bundle.tokenizer)
    launches, figures = {}, {}
    for label, name, own_mode, quant_kv, extra in SERVER_MODES:
        if label not in modes:
            continue
        mcfg = dataclasses.replace(cfg, kv_cache_quant=quant_kv)
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
        reset_wq_counts()
        t0 = time.perf_counter()
        server.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_mode = dict(dec_ops.flash_decode_attention.launches_by_mode)
        fwd_launches = attn_ops.flash_attention_fwd.launches
        launches[label] = by_mode
        stats = server.stats(reqs)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        print(f"serving ({label}, {weights}) {name}: 16 requests x 32 tokens in {wall:.2f} s, "
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
        if wq is None:
            check(all(fn.launches == 0 for fn in WQ_KERNELS.values()),
                  f"serving ({label}): bf16 weights launched a quantized product")
        else:
            by_mode[f"{wq}_matmul"] = check_wq_counts(f"serving ({label}, {weights})", wq)
            print(f"  {wq} product launches in the run: {by_mode[f'{wq}_matmul']} "
                  f"({by_mode[f'{wq}_matmul'] // PRODUCTS_PER_FORWARD} forwards x "
                  f"{PRODUCTS_PER_FORWARD})")

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
        reset_wq_counts()
        lk = decode_step(server.cfg, params, token, server._cache, pos)[0]
        if wq is not None:
            own = check_wq_counts(f"serving ({label}): one decode step", wq)
            check(own == PRODUCTS_PER_FORWARD,
                  f"serving ({label}): one decode step launched {own} {wq} products")
        lp = decode_step(plain_cfg, params, token, server._cache, pos)[0]
        check(bool(torch.isfinite(lk).all()), f"serving ({label}): non-finite decode logits")
        rel, diff = rel_err(lk, lp)
        print(f"  one decode step from the admitted state, kernel vs plain route: "
              f"max|d| {diff:.3e}, rel-to-max {rel:.3e}")
        check(rel <= LOGITS_TOL, f"serving ({label}): decode logits rel err {rel:.3e}")
        if wq is not None:
            with plain_products():
                lq = decode_step(server.cfg, params, token, server._cache, pos)[0]
            rel, diff = rel_err(lk, lq)
            print(f"  the same step, {PRODUCTS_PER_FORWARD} {wq} kernel launches vs the plain "
                  f"products: max|d| {diff:.3e}, rel-to-max {rel:.3e}")
            check(rel <= LOGITS_TOL, f"serving ({label}): {wq} decode logits rel err {rel:.3e}")
            if "prefill_chunk" in extra:
                check_chunked_admission(server, wq, label)
        wall_ms, busy_ms, top = profile_round(server)
        if busy_ms is None:
            print(f"  one decode round (8 slots x 8 tokens): wall {wall_ms:.1f} ms; device {top}")
        else:
            print(f"  one decode round (8 slots x 8 tokens): wall {wall_ms:.1f} ms unprofiled, "
                  f"device kernels {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.1%}; {top}")
        figures[label] = dict(wall_s=wall, tokens_per_sec=stats["tokens_per_sec"],
                              mean_ttft_s=stats["mean_ttft_s"], peak_gib=peak_gb,
                              round_wall_ms=wall_ms, round_device_ms=busy_ms)
        del server
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return launches, figures


# ---------------------------------------------------------------------------
# phases 13-16: the weight-only quantized products and serving from them
# ---------------------------------------------------------------------------

WQ_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))  # Llama-2-7B projections (K, N)
WQ_GROUP = 128
WQ_REPORT = (8, 4096, 11008)  # the serving engine's decode shape (M, K, N) of the kernels line


def wq_case(gen: torch.Generator, k: int, n: int):
    """A seeded randn * 0.02 weight [k, n] as its int8 and int4 (rows, group
    128) quantized forms and its bf16 copy."""
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
    return quant.quantize_weight(w), quant.quantize_weight_int4(w, WQ_GROUP), w.to(torch.bfloat16)


def wq_run(fmt: str, x, wq, plain: bool = False):
    if fmt == "int8":
        fn = int8_ops._int8_matmul_plain if plain else int8_ops.int8_matmul
        return fn(x, wq["q"], wq["scale"])
    if plain:
        return int4_ops._int4_matmul_plain(x, wq["q4"], wq["scale"])
    return int4_ops.int4_matmul(x, wq["q4"], wq["scale"], group=WQ_GROUP)


def check_wq_matmul(gen: torch.Generator):
    """Both quantized products against their plain versions at the shapes
    the quantized serving path gives them (decode of one request and of 8
    slots, prefill of one request ragged and padded, chunked admission of
    8 x 256, one-shot admission of 8 x 512) and at a ragged shape. The worst max |diff| per kernel."""
    worst = {"int8_matmul": 0.0, "int4_matmul": 0.0}
    cases = [(k, n, (1, 8, 293, 384, 2048, 4096)) for k, n in WQ_SHAPES] + [(256, 1000, (5,))]
    for k, n, ms in cases:
        w8, w4, _ = wq_case(gen, k, n)
        for m in ms:
            x = bf16_randn(gen, m, k)
            for fmt, wq in (("int8", w8), ("int4", w4)):
                got = wq_run(fmt, x, wq)
                torch.cuda.synchronize()
                err = check_close(f"{fmt}_matmul", f"M={m} (K,N)=({k},{n})", got,
                                  wq_run(fmt, x, wq, plain=True))
                worst[f"{fmt}_matmul"] = max(worst[f"{fmt}_matmul"], err)
    return worst


def wq_bound(fmt: str, m: int, k: int, n: int):
    """The bound of one quantized product: x, the stored weight bytes and
    their scales read once, the output written once; 2 M K N operations."""
    stored = k * n + 4 * n if fmt == "int8" else k * n // 2 + 4 * (k // WQ_GROUP) * n
    return bound(2 * m * k + stored + 2 * m * n, 2.0 * m * k * n)


def host_us(fn, n: int = 500) -> float:
    """Host time to enqueue one fn() call: n calls back to back (fewer than
    the launch queue holds), the clock read before the card has drained."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def time_wq_matmul(gen: torch.Generator):
    """Timings of both products at the three (K, N) and M in 1, 8, 384,
    2048, 4096. Returns {format: (ms, plain_ms, (bound_ms, bound_by))} at
    WQ_REPORT."""
    report = {}
    for k, n in WQ_SHAPES:
        w8, w4, wb = wq_case(gen, k, n)
        if (k, n) == WQ_SHAPES[0]:
            # what one projection of a decode step costs the host, which sets
            # the step's wall time: the dispatcher the decoder calls, beside
            # the one call an unquantized projection makes
            x = bf16_randn(gen, 8, 1, k)
            with torch.inference_mode():
                print(f"host enqueue per projection at M=8 (K,N)=({k},{n}): "
                      f"int8 {host_us(lambda: quant.quantized_dense(x, w8, None, x.dtype)):.1f} us, "
                      f"int4 {host_us(lambda: quant.quantized_dense_int4(x, w4, None, x.dtype)):.1f} us, "
                      f"torch.matmul on bf16 weights {host_us(lambda: torch.matmul(x, wb)):.1f} us")
        for m in (1, 8, 384, 2048, 4096):
            x = bf16_randn(gen, m, k)
            # printed beside them, neither computes the same function: the
            # product an unquantized model pays, and a dequantized copy
            # written to memory before the product
            bf16_ms = median_ms(lambda: torch.matmul(x, wb))
            deq_ms = median_ms(lambda: torch.matmul(x, quant.dequantize_weight(w8, torch.bfloat16)))
            for fmt, wq in (("int8", w8), ("int4", w4)):
                ms = median_ms(lambda: wq_run(fmt, x, wq))
                plain_ms = median_ms(lambda: wq_run(fmt, x, wq, plain=True))
                bound_ms, bound_by = wq_bound(fmt, m, k, n)
                print(f"{fmt}_matmul at M={m} (K,N)=({k},{n}): kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                      f"{bound_ms / ms:.1%} of bound; not the same function: torch.matmul on a "
                      f"bf16 copy of the weight {bf16_ms:.4f} ms, int8 dequantize-then-matmul "
                      f"{deq_ms:.4f} ms")
                if (m, k, n) == WQ_REPORT:
                    report[fmt] = (ms, plain_ms, (bound_ms, bound_by))
    return report


def time_wq_library(gen: torch.Generator):
    """PyTorch's own weight-only quantized products at WQ_REPORT, where the
    installed torch runs them on CUDA tensors (the port never calls them):
    `torch._weight_int8pack_mm` (int8 [N, K], one bf16 scale per output
    channel) and `torch._weight_int4pack_mm` (tinygemm's packed int4, bf16
    scale and zero point per 128-row group; zero 0 here, the symmetric
    scheme of K6). The weights are converted before the timed window. Each
    is held against the kernel's output on the same inputs; it counts as
    the kernel's library yardstick (same function up to its bf16 scales)
    when it agrees within KERNEL_TOL. Returns {format: ms or None}."""
    m, k, n = WQ_REPORT
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
    x = bf16_randn(gen, m, k)
    w8 = quant.quantize_weight(w)
    w4 = quant.quantize_weight_int4(w, WQ_GROUP)

    def int8_call():
        wt = w8["q"].t().contiguous()
        sc = w8["scale"].reshape(n).to(torch.bfloat16)
        return lambda: torch._weight_int8pack_mm(x, wt, sc)

    def int4_call():
        q, scale = quant._quantize_groups_int4(w, WQ_GROUP)
        qu = (q.to(torch.int32) + 8).t().contiguous()  # [N, K], 1..15, 8 = zero
        packed = (qu[:, 0::2] << 4 | qu[:, 1::2]).to(torch.uint8)
        wp = torch._convert_weight_to_int4pack(packed, 8)
        sz = torch.stack([scale, torch.zeros_like(scale)], dim=-1).to(torch.bfloat16).contiguous()
        return lambda: torch._weight_int4pack_mm(x, wp, WQ_GROUP, sz)

    out = {}
    for fmt, name, make, wq in (("int8", "torch._weight_int8pack_mm", int8_call, w8),
                                ("int4", "torch._weight_int4pack_mm", int4_call, w4)):
        out[fmt] = None
        try:
            fn = make()
            got = fn()
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, AttributeError) as e:
            print(f"{name} does not run on CUDA tensors in torch {torch.__version__}: "
                  f"{str(e).splitlines()[0][:160]}")
            continue
        rel, _ = rel_err(got, wq_run(fmt, x, wq))
        ms = median_ms(fn)
        same = rel <= KERNEL_TOL
        print(f"{name} at M={m} (K,N)=({k},{n}): {ms:.4f} ms, rel-to-max against the {fmt} kernel "
              f"{rel:.3e} ({'the same function up to its bf16 scales' if same else 'another function'})")
        if same:
            out[fmt] = ms
    return out


def print_wq_kernel_split(n: int = 10) -> None:
    """How each quantized product's device time at WQ_REPORT divides between
    its launches (the product and the combine of a split contraction): the
    mean device time of each kernel over n runs, L2 flushed, by name, from
    torch.profiler. Runs first, on inputs from a seed of its own: late in
    the script the profiler returned no device events for a window this
    short."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    m, k, n_out = WQ_REPORT
    w8, w4, _ = wq_case(gen, k, n_out)
    x = bf16_randn(gen, m, k)
    for fmt, wq in (("int8", w8), ("int4", w4)):
        wq_run(fmt, x, wq)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush_l2()
                wq_run(fmt, x, wq)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "wq::" in e.key]
        split = "; ".join(
            f"{e.key.split('(')[0].removeprefix('void ')} "
            f"{e.self_device_time_total / e.count:.1f} us x{e.count}" for e in kernels)
        print(f"{fmt}_matmul at M={m} (K,N)=({k},{n_out}), device time by kernel: "
              f"{split or 'not measured (the profiler saw no device time)'}")


def beside(name: str, got: dict, ref: dict) -> None:
    """One run's figures beside the bf16-weight run's of this script."""
    def fmt(v):
        return "not measured" if v is None else f"{v:.4g}"
    print(f"  {name} | " + "; ".join(f"{k} {fmt(got[k])} (bf16: {fmt(ref[k])})" for k in got))


def run_quantized_serving(cfg: ModelConfig, bundle: TokenizerBundle, rows, wq: str, modes: str,
                          bf16_main: dict, bf16_serving: dict):
    """Serve from a tree quantized on the card at full 7B width, 32 layers:
    `batch_infer`, then `BatchedServer` in `modes`. Returns the serving
    runs' launch counts."""
    t0 = time.perf_counter()
    params = init_llark_params(cfg, seed=SEED, device="cuda")
    before = param_bytes(params)
    if wq == "int8":
        params = quant.quantize_params_int8_incremental(cfg, params)
    else:
        params = quant.quantize_params_int4_incremental(cfg, params, group=WQ_GROUP, layout="rows")
    torch.cuda.synchronize()
    head = params["lm_head"]
    print(f"{wq} weights: {before / 1e9:.3f} GB of bf16 params quantized on the card to "
          f"{param_bytes(params) / 1e9:.3f} GB in {time.perf_counter() - t0:.2f} s (init included); "
          f"lm_head leaves {sorted(head)}")
    check(all(isinstance(params["layers"][name], dict) for name in
              ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")), "a projection is not quantized")
    _, main = run_main_path(cfg, bundle, rows, params=params, wq=wq)
    beside(f"batch_infer and one request, {wq} weights", main, bf16_main)
    launches, figures = run_serving_engine(cfg, bundle, params=params, modes=modes, wq=wq)
    for label, got in figures.items():
        beside(f"serving ({label}), {wq} weights", got, bf16_serving[label])
    return launches


@torch.inference_mode()
def check_int4_cols(cfg: ModelConfig) -> None:
    """The default layout of `quantize_params_int4_incremental` (cols: no
    kernel, plain PyTorch) on the card at 7B width, 2 layers: one forward
    against the same tree dequantized to bf16 weights."""
    small = dataclasses.replace(cfg, num_layers=2)
    params = quant.quantize_params_int4_incremental(
        small, init_llark_params(small, seed=SEED, device="cuda"))
    check("q4c" in params["layers"]["w_down"] and "q4c" in params["lm_head"],
          "the default int4 layout is not cols")
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(4, 2000, (2, 64))).cuda()
    reset_wq_counts()
    got, _ = decoder_forward(small, params, input_ids=ids)
    torch.cuda.synchronize()
    check(all(fn.launches == 0 for fn in WQ_KERNELS.values()), "the cols layout launched a kernel")
    dense = dict(params, lm_head=quant.dequantize_weight_int4_cols(params["lm_head"], torch.bfloat16))
    dense["layers"] = {
        name: quant.dequantize_weight_int4_cols(w, torch.bfloat16) if isinstance(w, dict) else w
        for name, w in params["layers"].items()}
    want, _ = decoder_forward(small, dense, input_ids=ids)
    check(bool(torch.isfinite(got).all()), "int4 cols: non-finite logits")
    rel, diff = rel_err(got, want)
    print(f"int4 cols layout, 7B width, 2 layers, [2, 64] tokens: logits vs the dequantized "
          f"tree max|d| {diff:.3e}, rel-to-max {rel:.3e}")
    check(rel <= LOGITS_TOL, f"int4 cols logits rel err {rel:.3e} > {LOGITS_TOL}")
    del params, dense
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: training kernels against their plain versions
# ---------------------------------------------------------------------------

TRAIN_SHAPE = (2, 32, 1024, 128)  # the training path's q/k/v: batch 2, 1024 tokens
TRAIN_LENGTHS = [1024, 700]


def check_flash_bwd(gen: torch.Generator):
    """The forward's LSE and the backward's dq, dk and dv against their
    plain versions; the worst max |diff| of each."""
    b, h, s, d = TRAIN_SHAPE
    cases = [
        (f"main path [{b},{h},{s},{d}] causal, kv_len {TRAIN_LENGTHS}", h, d, False),
        ("GQA Hkv=8 + ALiBi", 8, d, True),
        ("head_dim 64", h, 64, False),
    ]
    worst = {"flash_fwd_lse": 0.0, "flash_bwd": 0.0}
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
        grads = attn_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        delta = attn_ops._flash_bwd_delta(out, do)
        plain = attn_ops._flash_bwd_plain(q, k, v, do, lse, delta, **kw)
        for part, got, want in zip(("dq", "dk", "dv"), grads, plain):
            err = check_close("flash_bwd", f"{part} {name}", got, want)
            worst["flash_bwd"] = max(worst["flash_bwd"], err)
            if part != "dq":  # keys at or past kv_len get exact zeros
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
        attn_ops.flash_attention_bwd.launches = 0
        loss, _ = make_loss_fn(c, audio_patch_id=bundle.audio_patch_id)(params, batch)
        (grad,) = torch.autograd.grad(loss, [proj])
        results[use_kernels] = (loss.item(), grad, attn_ops.flash_attention_bwd.launches)
    (lk, gk, nk), (lp, gp, _) = results[True], results[False]
    rel, _ = rel_err(gk, gp)
    print(f"7B width, 2 layers, one step: loss {lk:.5f} (kernels) vs {lp:.5f} (plain), "
          f"projector gradient rel-to-max {rel:.3e}, |grad| {gk.norm().item():.4e} vs "
          f"{gp.norm().item():.4e}; flash backward launches {nk}")
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
    Returns the launches of the two training kernel wrappers in the run."""
    model_args, data_args, training_args = train_args(directory, shard, steps, lr, **flags)
    torch.cuda.reset_peak_memory_stats()
    counters = (attn_ops.flash_attention_fwd, attn_ops.flash_attention_bwd)
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
    # one backward per layer per micro-batch
    per_step = training_args.gradient_accumulation_steps * cfg.num_layers
    check(launches["flash_attention_bwd"] == steps * per_step,
          f"{label}: {launches['flash_attention_bwd']} flash backward launches, not {steps} x {per_step}")
    del result
    shutil.rmtree(directory)  # the checkpoint: 27 GB at 32 layers
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 12: training kernels' timings
# ---------------------------------------------------------------------------


def time_flash_bwd(gen):
    """Timings at the training shape: the forward with its log-sum-exp
    (printed) and the whole flash backward (delta, the products, dq's
    rounding): (ms, plain_ms, library_ms, (bound_ms, bound_by), shape)."""
    b, h, s, d = TRAIN_SHAPE
    q, k, v, do = (bf16_randn(gen, b, h, s, d) for _ in range(4))
    kv = torch.tensor(TRAIN_LENGTHS, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, kv_lengths=kv, slopes=None)
    out, lse = attn_ops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    # library yardstick: SDPA forward and backward (dq, dk and dv together)
    # at the same mask; no query row here is without a visible key, which
    # would make SDPA's softmax NaN
    pos = torch.arange(s, device="cuda")
    mask = ((pos[None, :] <= pos[:, None]) & (pos[None, :] < kv[:, None, None]))[:, None]
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = sdpa(ql, kl, vl, mask)
    # visible (query, key) pairs; the forward does 2 products of 2*D FLOPs
    # per pair, the backward 5; bytes: inputs read once (bf16 q, dO and O
    # whole, k and v up to each row's kv_len only; fp32 lse), outputs
    # written once (dq, dk, dv whole: dead keys get zeros)
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

    def plain_bwd():
        delta = attn_ops._flash_bwd_delta(out, do)
        return attn_ops._flash_bwd_plain(q, k, v, do, lse, delta, **kw)

    bwd_ms = median_ms(lambda: attn_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw))
    plain_ms = median_ms(plain_bwd)
    lib_ms = median_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True))
    delta_ms = median_ms(lambda: attn_ops._flash_bwd_delta(out, do))
    bwd_bound = bound(3 * tensor + 2 * live_kv + 4 * b * h * s + 3 * tensor, 10.0 * d * pairs)
    shape = f"[{b},{h},{s},{d}] causal, kv_len {TRAIN_LENGTHS}"
    print(f"  the PyTorch delta the two-kernel backward computed beforehand, "
          f"(g.float() * out.float()).sum(-1), alone: {delta_ms:.4f} ms")
    # second reference, not the yardstick: SDPA is_causal=True (PyTorch's
    # flash backend) with every key live, beside the kernels at kv_len [s, s]
    full = torch.full((b,), s, dtype=torch.int32, device="cuda")
    out_f, lse_f = attn_ops.flash_attention_fwd(q, k, v, causal=True, kv_lengths=full, return_lse=True)
    full_ms = median_ms(lambda: attn_ops.flash_attention_bwd(
        q, k, v, out_f, lse_f, do, causal=True, kv_lengths=full))
    lib_c = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_c_ms = median_ms(lambda: torch.autograd.grad(lib_c, (ql, kl, vl), do, retain_graph=True))
    print(f"  at kv_len [{s}, {s}]: flash backward {full_ms:.4f} ms, SDPA is_causal=True backward "
          f"{lib_c_ms:.4f} ms (dq, dk and dv)")
    return bwd_ms, plain_ms, lib_ms, bwd_bound, shape


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
    print_wq_kernel_split()

    cfg = ModelConfig.llama2_7b(use_flash_decode=True, param_dtype="bfloat16")
    bundle, rows, plen = requests(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    fwd_err = check_flash_fwd(gen, plen)
    dec_err = check_flash_decode(gen, plen)
    launches, bf16_main = run_main_path(cfg, bundle, rows)
    k2_err = check_flash_decode_modes(gen)
    dec_err = max(dec_err, k2_err["flash_decode"])
    admitted = [len(r.input_ids) for r in serving_requests(cfg, bundle, 8, SEED)]
    fwd_err = max(fwd_err, check_flash_fwd_admission(gen, admitted))
    serving, bf16_serving = run_serving_engine(cfg, bundle)

    wq_err = check_wq_matmul(gen)
    wq_serving = {
        "int8": run_quantized_serving(cfg, bundle, rows, "int8", "ab", bf16_main, bf16_serving),
        "int4": run_quantized_serving(cfg, bundle, rows, "int4", "a", bf16_main, bf16_serving),
    }
    check_int4_cols(cfg)

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
    launches["flash_bwd"] = adapter["flash_attention_bwd"]

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
    # the flash backward at the training path's shape; its launches are the
    # adapter stage's (32 layers x 2 micro-batches x 6 steps)
    ms, plain_ms, lib_ms, (bound_ms, bound_by), shape = time_flash_bwd(gen)
    print(f"flash_bwd at {shape}: delta + products + dq rounding {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA backward {lib_ms:.4f} ms (dq, dk and dv; same mask), bound {bound_ms:.4f} ms "
          f"({bound_by}), {bound_ms / ms:.1%} of bound")
    kernels.append({
        "name": "flash_bwd", "route": "cuda", "source": "llark_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "llark_tpu/ops/attention.py:536, llark_tpu/ops/attention.py:570",
        "launches": launches["flash_bwd"], "max_abs_err": bwd_err["flash_bwd"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms,
    })
    print(f"flash_fwd log-sum-exp, worst |d| {bwd_err['flash_fwd_lse']:.3e}")
    # the quantized products at the serving engine's decode shape; their
    # launches are those of the run-of-record mode (a) served from each format
    wq_times = time_wq_matmul(gen)
    wq_library = time_wq_library(gen)
    for fmt, (ms, plain_ms, (bound_ms, bound_by)) in wq_times.items():
        kernels.append({
            "name": f"{fmt}_matmul", "route": "cuda",
            "source": f"llark_tpu_torch/csrc/{fmt}_matmul.cu",
            "replaces": f"llark_tpu/ops/{fmt}_matmul.py:{88 if fmt == 'int8' else 106}",
            "launches": wq_serving[fmt]["a"][f"{fmt}_matmul"],
            "max_abs_err": wq_err[f"{fmt}_matmul"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": wq_library[fmt],
        })

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
