"""Time the flash-decode kernel (`csrc/flash_decode.cu`) beside builds of it
that differ in one design choice, and beside another checkout's kernel, on
one CUDA card.

    python -m llark_tpu_torch.tools.decode_variants [--only NAME ...] [--parent DIR] [--ablations]
        [--serving]

Each variant is the kernel's source with the textual substitutions listed in
VARIANTS; `--parent DIR` adds the variant "parent", the source of the
checkout at DIR (e.g. the parent commit unpacked by `git archive` into a
git-ignored directory) as it stands. All are compiled with the package's
nvcc flags (one process per variant, all started together) into
`llark_tpu_torch/_build/variants/`. Each build is first held against the
plain version in every cache mode (worst query row within
`chip_smoke.ROW_TOL`); the builds that pass (and, with `--ablations`, the
builds of ABLATIONS: a part of the kernel compiled out, wrong by
construction, so not checked) are then timed in turns, in
forward and then in reverse order, at chip_smoke.py's K2 shapes: q
[1,32,1,128] over a 2048-position bf16 cache (313 live) and q [8,32,1,128]
over 2048-position caches (300-340 live) in the four cache modes, and once
with every live length 0 (the cost of the grid's blocks alone). Per shape
and variant it prints both medians of `chip_smoke.median_ms` (L2 flushed
before each launch, the host enqueue hidden), the same with a clean flush
(`clean=True`), and the split and combine kernels' own device times from
torch.profiler; with `--serving`, the flash-decode kernels' part of a
serving decode round per cache mode (`serving_rounds`); then each variant's host enqueue time per call (the least
of five `chip_smoke.host_us`). Starts with the card's name and power limit and each
build's ptxas report.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

from llark_tpu_torch.ops import _build
from llark_tpu_torch.ops import attention as attn_ops
from llark_tpu_torch.ops import decode_attention as dec_ops

SOURCE = "flash_decode.cu"
OUT_DIR = os.path.join(_build.BUILD_DIR, "variants")

# name -> [(text of the kernel's source, its replacement)]; "shipped" is
# the source as it stands
VARIANTS = {
    "shipped": [],
    # the scores wait for V as well as Q and K (one commit group)
    "one_commit_group": [("  cp_async_wait<1>();\n  __syncthreads();",
                          "  cp_async_wait<0>();\n  __syncthreads();")],
    # paged: every 16-byte copy reads its own table entry
    "tables_per_chunk": [("      return (long long)sBlk[p / bs - blk0] * st.outer +",
                          "      return (long long)min(max(tables[(long long)b * max_blocks + p / bs], "
                          "0), n_pool - 1) * st.outer +")],
    # the parent's shared memory a block (fp32 Q rows and scores, at most 32 rows)
    "smem_as_parent": [("{ return q_off + size_t(rows_pad) * ROW_BYTES; }",
                        "{ return 2 * size_t(TK) * D * sizeof(T) + size_t(MAX_ROWS) * (D + TK) * 4; }")],
    # P V from P rounded to bf16 alone (no low part)
    "bf16_p": [("      for (int part = 0; part < 2; ++part) {", "      for (int part = 0; part < 1; ++part) {")],
    # blocks in launch order take split 0 of every (kv head, row chunk, batch
    # row), then split 1, ...: the live splits start first, the dead ones
    # (past every row's live length) after them, not beside them
    "live_splits_first": [(
        "  constexpr int NT = D / 32;  // n8 tiles of output columns a warp\n"
        "  const int split = blockIdx.x;\n"
        "  const int hk = blockIdx.y / row_chunks;\n"
        "  const int row0 = (blockIdx.y % row_chunks) * MAX_ROWS;\n"
        "  const int b = blockIdx.z;\n",
        "  constexpr int NT = D / 32;\n"
        "  const int tiles = gridDim.y * gridDim.z;\n"
        "  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
        "  const int split = lin / tiles;\n"
        "  const int hk = lin % tiles % gridDim.y / row_chunks;\n"
        "  const int row0 = (lin % tiles % gridDim.y % row_chunks) * MAX_ROWS;\n"
        "  const int b = lin % tiles / gridDim.y;\n")],
    # the combine launched after the split kernel has drained, as a plain launch
    "no_pdl": [("  pdl[0].val.programmaticStreamSerializationAllowed = 1;",
                "  pdl[0].val.programmaticStreamSerializationAllowed = 0;")],
}

# builds with one part of the split kernel compiled out: their times say what
# the copies and the products cost (their outputs are wrong)
ABLATIONS = {
    "ablate_no_products": [
        ("        mma_bf16(s[mt][0], a, bk[0]);\n        mma_bf16(s[mt][1], a, bk[1]);\n", ""),
        ("#pragma unroll\n        for (int i = 0; i < NT; ++i) mma_bf16(o[mt][i], a, bv[i]);\n", "")],
    "ablate_no_copies": [
        ("    cp_async16(sK + r * Plan::K_PITCH + c * 16, ok ? k + offset(k_st, k0 + r) + c * 16 : k, ok);\n", ""),
        ("    cp_async16(sV + r * Plan::V_PITCH + c * 16, ok ? v + offset(v_st, k0 + r) + c * 16 : v, ok);\n", "")],
}

# (label, input mode of chip_smoke.k2_inputs or "b1", paged block size)
SHAPES = (
    ("dense bf16 q [1,32,1,128] kv 313", "b1", 0),
    ("dense bf16 q [8,32,1,128]", "bf16", 0),
    ("dense int8 q [8,32,1,128]", "int8", 0),
    ("paged bf16 bs 16 q [8,32,1,128]", "paged", 16),
    ("paged int8 bs 128 q [8,32,1,128]", "paged_int8", 128),
    # every split past the live length: what the grid's dead blocks cost
    ("dense bf16 q [8,32,1,128] kv 0", "empty", 0),
)


def variant_source(name: str, parent: str = "") -> str:
    path = os.path.join(parent or _build.CSRC_DIR, SOURCE)
    with open(path) as f:
        src = f.read()
    for old, new in {**VARIANTS, **ABLATIONS}.get(name, []):
        if old not in src:
            raise ValueError(f"variant {name}: {old!r} is not in {SOURCE}")
        src = src.replace(old, new)
    return src


def build(names, parent_csrc: str) -> list:
    """Compile every variant at once; print each ptxas report. Returns the
    names that built."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name in names:
        csrc = parent_csrc if name == "parent" else _build.CSRC_DIR
        cu = os.path.join(OUT_DIR, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(name, parent_csrc if name == "parent" else ""))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc,
               "-o", os.path.join(OUT_DIR, f"{name}.so"), cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    built = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        print(f"== build {name}: rc {proc.returncode}")
        for line in log.splitlines():
            if proc.returncode or any(w in line for w in ("registers", "spill", "error", "C75")):
                print("   ", line.strip()[:200])
        if proc.returncode == 0:
            built.append(name)
    return built


def use(name: str) -> None:
    # the wrapper looks its library up at every launch
    _build._libs[SOURCE] = ctypes.CDLL(os.path.join(OUT_DIR, f"{name}.so"))


def inputs(smoke, gen, mode: str, bs: int):
    if mode == "b1":
        q = smoke.bf16_randn(gen, 1, 32, 1, 128)
        k, v = (smoke.bf16_randn(gen, 1, 32, 2048, 128) for _ in range(2))
        kv = torch.tensor([313], dtype=torch.int32, device="cuda")
        return q, k, v, dict(kv_lengths=kv, q_positions=kv - 1)
    if mode == "empty":
        q, k, v, kw = smoke.k2_inputs(gen, "bf16")
        kw["kv_lengths"] = torch.zeros_like(kw["kv_lengths"])
        return q, k, v, kw
    return smoke.k2_inputs(gen, mode, bs=bs)


def holds(name: str, smoke) -> bool:
    use(name)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(smoke.SEED)
    worst = 0.0
    for _, mode, bs in SHAPES:
        if mode == "empty":
            continue  # zeros, and plain zeros: nothing to hold
        for sq, hkv, alibi in ((1, 32, False), (5, 8, True)):
            if mode == "b1" and sq > 1:
                continue
            q, k, v, kw = (inputs(smoke, gen, mode, bs) if sq == 1
                           else smoke.k2_inputs(gen, mode, hkv=hkv, sq=sq, bs=bs))
            if alibi:
                kw["slopes"] = attn_ops.alibi_slopes(32, "cuda")
            got = dec_ops.flash_decode_attention(q, k, v, **kw)
            worst = max(worst, smoke.row_err(got, smoke.k2_plain(q, k, v, kw)))
    ok = worst <= smoke.ROW_TOL["flash_decode"]
    print(f"== check {name}: worst row {worst:.3e}: {'holds' if ok else 'FAILS'}")
    return ok


def kernel_split_ms(smoke, fn, n: int = 20) -> dict:
    """Device ms per call of each flash-decode kernel in fn, from
    torch.profiler, L2 flushed before each call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            smoke.flush_l2()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "decode_" in e.key:
            name = "split" if "split" in e.key else "combine"
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / n
    return out


def serving_rounds(smoke, names) -> None:
    """Chip_smoke.py's serving engine (phase 7: 7B width, 32 layers, random
    bf16 weights, 8 slots, cache 2048, decode_chunk 8) in its four cache
    modes, 8 requests admitted; per mode and variant, in turns, one decode
    round's device time and the flash-decode kernels' part of it, from
    torch.profiler."""
    import dataclasses
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llark_tpu_torch.config import ModelConfig
    from llark_tpu_torch.generate import GenerationConfig
    from llark_tpu_torch.inference.server import BatchedServer
    from llark_tpu_torch.models.fusion import init_llark_params

    cfg = ModelConfig.llama2_7b(use_flash_decode=True, param_dtype="bfloat16")
    bundle, _, _ = smoke.requests(cfg)
    params = init_llark_params(cfg, seed=smoke.SEED, device="cuda")
    gen_cfg = GenerationConfig(max_new_tokens=1000, stop_text="")
    for label, desc, _, quant_kv, extra in smoke.SERVER_MODES:
        kw = dict(max_batch=8, max_cache_len=2048, prompt_buckets=(512,), max_audio_frames=256,
                  decode_chunk=8, tokenizer=bundle.tokenizer, **extra)
        reqs = smoke.serving_requests(cfg, bundle, 8, smoke.SEED)
        if kw.pop("prefix", False):
            kw["shared_prefix_ids"] = smoke._common_prompt_prefix(
                [r.input_ids for r in reqs], bundle.audio_patch_id,
                min_len=max(8, kw["kv_block_size"]))
        server = BatchedServer(dataclasses.replace(cfg, kv_cache_quant=quant_kv), params,
                               bundle.audio_patch_id, gen_cfg, **kw)
        server._queue = reqs
        for r in server._queue:
            r.submitted_at = time.time()
        server._admit()
        server._refresh_tables()
        rounds = {n: [] for n in names}
        for order in (names, names[::-1]):
            for name in order:
                use(name)
                server._decode_round()  # warm
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    server._decode_round()
                    torch.cuda.synchronize()
                kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
                busy = sum(e.self_device_time_total for e in kernels) / 1e3
                k2 = sum(e.self_device_time_total for e in kernels if "decode_" in e.key) / 1e3
                rounds[name].append((busy, k2))
        print(f"serving ({label}) {desc}, one decode round of 8 slots x 8 tokens:")
        for name, runs in rounds.items():
            print("  " + name + ": " + "; ".join(
                f"device {busy:.2f} ms, flash decode {k2:.2f} ms ({k2 / busy:.1%})" if busy > 0
                else "device time not measured (the profiler saw none)" for busy, k2 in runs))
        del server
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--parent", default="", help="root of a checkout whose kernel to time as 'parent'")
    ap.add_argument("--ablations", action="store_true", help="also time the builds of ABLATIONS")
    ap.add_argument("--serving", action="store_true",
                    help="also profile a serving decode round per cache mode and variant")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke  # its timing and checking helpers; run from the repo root

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), torch.__version__)
    names = list(args.only)
    parent_csrc = ""
    if args.parent:
        parent_csrc = os.path.join(os.path.abspath(args.parent), "llark_tpu_torch", "csrc")
        names.append("parent")
    if args.ablations:
        names += list(ABLATIONS)
    names = [n for n in build(names, parent_csrc) if n in ABLATIONS or holds(n, smoke)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(smoke.SEED)
    for label, mode, bs in SHAPES:
        q, k, v, kw = inputs(smoke, gen, mode, bs)

        def call():
            return dec_ops.flash_decode_attention(q, k, v, **kw)

        times = {n: [] for n in names}
        for order in (names, names[::-1]):
            for name in order:
                use(name)
                times[name].append(smoke.median_ms(call))
                times[name].append(smoke.median_ms(call, clean=True))
        splits = {}
        for name in names:
            use(name)
            splits[name] = kernel_split_ms(smoke, call)
        print(f"{label}:")
        for name, t in times.items():
            parts = ", ".join(f"{k} {v:.4f}" for k, v in splits[name].items())
            print(f"  {name}: {t[0]:.4f}/{t[2]:.4f} ms, clean L2 {t[1]:.4f}/{t[3]:.4f} ms; "
                  f"profiler: {parts} ms")
    if args.serving:
        serving_rounds(smoke, [n for n in names if n not in ABLATIONS])
    q, k, v, kw = inputs(smoke, gen, "b1", 0)
    for name in names:
        use(name)
        # the host's speed varies with its other load: the least of five runs
        us = min(smoke.host_us(lambda: dec_ops.flash_decode_attention(q, k, v, **kw))
                 for _ in range(5))
        print(f"host enqueue, {name}: {us:.1f} us per call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
