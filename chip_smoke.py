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
     from bytes and FLOPs at 3.35 TB/s and 989 TFLOP/s (H100 SXM, bf16).

Prints a {"kernels": [...]} JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Imports nothing of JAX or llark_tpu.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.generate import GenerationConfig, Generator
from llark_tpu_torch.infer import batch_infer, build_prompt_ids
from llark_tpu_torch.models.fusion import init_llark_params
from llark_tpu_torch.ops import _build
from llark_tpu_torch.ops import attention as attn_ops
from llark_tpu_torch.ops import decode_attention as dec_ops
from llark_tpu_torch.tokenization import TokenizerBundle, WordTokenizer

SEED = 0
# Kernel vs plain, both rounded to bf16 on output. ROW_TOL bounds the worst
# query row's |kernel - plain| / |plain| (L2 over the head dim). On an H100
# 80GB HBM3 at 700 W the cases below read at most 4.9e-3 for the prefill
# kernel, which rounds the probabilities to bf16 for the P.V product, and
# 4.8e-4 for the decode kernel, which keeps them in fp32 (PERF.md); each
# limit is about one bf16 ulp (2**-8 = 3.9e-3 relative) above its reading.
# KERNEL_TOL bounds max |kernel - plain| / max |plain| over the output.
ROW_TOL = {"flash_fwd": 1e-2, "flash_decode": 4e-3}
KERNEL_TOL = 2e-2
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


def row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst |got - want| / |want| over the rows of the last axis (L2). A
    row of zeros in want (a query with no live key) must be zeros in got."""
    g, w = got.float(), want.float()
    w_norm = w.norm(dim=-1)
    live = w_norm > 0
    check(bool((g.norm(dim=-1)[~live] == 0).all()), "a row with no live key is not zeros")
    return ((g - w).norm(dim=-1)[live] / w_norm[live]).max().item()


def check_close(kernel: str, name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Hold a kernel's output against its plain version; the max |diff|."""
    row = row_err(got, want)
    rel, diff = rel_err(got, want)
    print(f"{kernel} {name}: worst row {row:.3e}, max|d| {diff:.3e}, rel-to-max {rel:.3e}")
    check(row <= ROW_TOL[kernel], f"{kernel} {name}: row error {row:.3e} > {ROW_TOL[kernel]}")
    check(rel <= KERNEL_TOL, f"{kernel} {name}: rel-to-max {rel:.3e} > {KERNEL_TOL}")
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

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
