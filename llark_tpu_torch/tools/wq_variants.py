"""Time the weight-only quantized products (`csrc/int8_matmul.cu`,
`csrc/int4_matmul.cu`, their tile loop `csrc/wq_matmul.cuh`) beside builds
that differ in one tuning choice, on one CUDA card.

    python -m llark_tpu_torch.tools.wq_variants [--only NAME ...] [--quick] [--ablations]

Each variant is the tile loop's header with the textual substitutions listed
in VARIANTS (ring depth, token and channel tiles, the split rule), written
beside copies of the two sources into `llark_tpu_torch/_build/variants/`
and compiled with the package's nvcc flags (one process per source and
variant, all started together). Each build is first held against the plain
versions (worst output row within `chip_smoke.ROW_TOL`, bitwise equal on
repeat) at every regime of the kernel; the builds that pass are then timed
in turns, in forward and then in reverse order, with `chip_smoke.median_ms`
(L2 flushed before each launch, the host enqueue hidden) at chip_smoke.py's
K5 / K6 shapes: M in 1, 8, 384, 2048, 4096 at the three Llama-2-7B
projections (`--quick`: M = 1, 8 and 2048 at (4096, 11008)). With
`--ablations` the builds of ABLATIONS (a part of the loop compiled out,
wrong by construction, so not checked) are timed beside them: what each part
costs. Prints the card's name and power limit, each build's ptxas report,
and per shape, format and variant both medians.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import torch

from llark_tpu_torch.ops import _build
from llark_tpu_torch.ops import int8_matmul as int8_ops

HEADER = "wq_matmul.cuh"
SOURCES = ("int8_matmul.cu", "int4_matmul.cu")
OUT_DIR = os.path.join(_build.BUILD_DIR, "variants")

# name -> [(text of the tile loop's header, its replacement)]; "shipped" is
# the header as it stands
VARIANTS = {
    "shipped": [],
    # decode regime (M <= 16): a ring of 4 or 6 stages (6: one block an SM)
    "decode_4_stages": [("using Decode8 = Tiles<8, 1, 128, 3, 2>;", "using Decode8 = Tiles<8, 1, 128, 4, 2>;"),
                        ("using Decode16 = Tiles<16, 1, 128, 3, 2>;", "using Decode16 = Tiles<16, 1, 128, 4, 2>;")],
    "decode_6_stages": [("using Decode8 = Tiles<8, 1, 128, 3, 2>;", "using Decode8 = Tiles<8, 1, 128, 6, 1>;"),
                        ("using Decode16 = Tiles<16, 1, 128, 3, 2>;", "using Decode16 = Tiles<16, 1, 128, 6, 1>;")],
    # decode blocks of two warpgroups (256 channels, 256-byte weight rows)
    "decode_two_warpgroups": [("using Decode8 = Tiles<8, 1, 128, 3, 2>;", "using Decode8 = Tiles<8, 2, 128, 3, 2>;"),
                              ("using Decode16 = Tiles<16, 1, 128, 3, 2>;", "using Decode16 = Tiles<16, 2, 128, 3, 2>;")],
    # the split rule: int8 at M <= 8 with int4's tiles (about 4 blocks an
    # SM, 2 stages each), int4 with int8's, or a split of at least 512
    # contraction rows
    "int8_decode_like_int4": [("using Decode8 = Tiles<8, 1, 128, 3, 2>;", "using Decode8 = Tiles<8, 1, 128, 2, 4>;")],
    "int4_decode_like_int8": [("using Decode8Int4 = Tiles<8, 1, 128, 2, 4>;", "using Decode8Int4 = Tiles<8, 1, 128, 3, 2>;")],
    "min_split_512": [("constexpr int MIN_SPLIT_ROWS = 256;", "constexpr int MIN_SPLIT_ROWS = 512;")],
    # admission: int8 with the 64-token tile at every M, or stages of 64
    # contraction rows (4 of them)
    "admit_64_tokens": [("return m <= 64 ? f(Admit64{}) : f(Admit128{});", "return f(Admit64{});")],
    "admit_64_rows": [("using Admit64 = Tiles<64, 2, 128, 3, 1>;", "using Admit64 = Tiles<64, 2, 64, 4, 1>;"),
                      ("using Admit128 = Tiles<128, 2, 128, 3, 1>;", "using Admit128 = Tiles<128, 2, 64, 4, 1>;")],
}

# builds with one part of the tile loop compiled out: their times say what
# the loads, the conversions and the products cost (their outputs are wrong)
_NO_PRODUCTS = ("        wgmma_rs<0>(acc[0], af[0], db, 1);\n        wgmma_rs<0>(acc[1], af[1], db, 1);\n", "")
ABLATIONS = {
    "ablate_no_products": [_NO_PRODUCTS],
    "ablate_loads_only": [_NO_PRODUCTS, ("        W::template frags<PITCH>(wt, ks, t, af);\n", "")],
    "ablate_no_loads": [
        ("    stage_w<WROWS, BN, PITCH, NT>(smem + W_OFF + stg * W_TILE, w, n, k0 * W::kRowsPer16 / 16,\n"
         "                                  kend * W::kRowsPer16 / 16, n0, vec16);\n", ""),
        ("      stage_x<XT, NTOK, BK, NT>(smem + stg * X_TILE, x, m, k_total, m0, k0, kend);\n"
         "      cp_async_arrive(full + stg);", "      cp_async_arrive(full + stg);")],
}

WQ_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
MS = (1, 8, 384, 2048, 4096)


def variant_dir(name: str) -> str:
    return os.path.join(OUT_DIR, f"wq_{name}")


def write_variant(name: str) -> None:
    with open(os.path.join(_build.CSRC_DIR, HEADER)) as f:
        src = f.read()
    for old, new in {**VARIANTS, **ABLATIONS}[name]:
        if old not in src:
            raise ValueError(f"variant {name}: {old!r} is not in {HEADER}")
        src = src.replace(old, new)
    d = variant_dir(name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, HEADER), "w") as f:
        f.write(src)
    for s in SOURCES:  # "wq_matmul.cuh" resolves beside the including file first
        shutil.copy(os.path.join(_build.CSRC_DIR, s), os.path.join(d, s))


def build(names) -> list:
    """Compile every variant's two sources at once; print each ptxas report
    line on registers and spills. Returns the names that built."""
    procs = {}
    for name in names:
        write_variant(name)
        for s in SOURCES:
            d = variant_dir(name)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
                   "-o", os.path.join(d, s.replace(".cu", ".so")), os.path.join(d, s)]
            procs[(name, s)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)
    failed = set()
    for (name, s), proc in procs.items():
        log, _ = proc.communicate()
        print(f"== build {name} {s}: rc {proc.returncode}")
        for line in log.splitlines():
            if proc.returncode or any(w in line for w in ("registers", "spill", "error", "C75")):
                print("   ", line.strip()[:200])
        if proc.returncode:
            failed.add(name)
    return [n for n in names if n not in failed]


def use(name: str) -> None:
    # the wrappers look their entry points up once per source: forget them
    for s in SOURCES:
        _build._libs[s] = ctypes.CDLL(os.path.join(variant_dir(name), s.replace(".cu", ".so")))
    int8_ops._entry_points.cache_clear()


def holds(name: str, smoke) -> bool:
    use(name)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(smoke.SEED)
    worst = {"int8": 0.0, "int4": 0.0}
    same = True
    k, n = WQ_SHAPES[1]
    w8, w4, _ = smoke.wq_case(gen, k, n)
    for m in (1, 8, 9, 16, 17, 64, 65, 384):
        x = smoke.bf16_randn(gen, m, k)
        for fmt, wq in (("int8", w8), ("int4", w4)):
            got = smoke.wq_run(fmt, x, wq)
            same = same and torch.equal(got, smoke.wq_run(fmt, x, wq))
            worst[fmt] = max(worst[fmt], smoke.row_err(got, smoke.wq_run(fmt, x, wq, plain=True)))
    ok = same and all(worst[f] <= smoke.ROW_TOL[f"{f}_matmul"] for f in worst)
    print(f"== check {name}: worst row int8 {worst['int8']:.3e}, int4 {worst['int4']:.3e}, "
          f"bitwise on repeat {same}: {'holds' if ok else 'FAILS'}")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--quick", action="store_true", help="M = 1, 8, 2048 at (4096, 11008) only")
    ap.add_argument("--ablations", action="store_true", help="also time the builds of ABLATIONS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke  # its timing and checking helpers; run from the repo root

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), torch.__version__)
    ablations = list(ABLATIONS) if args.ablations else []
    built = build(list(args.only) + ablations)
    names = [n for n in built if n in ablations or holds(n, smoke)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(smoke.SEED)
    shapes = [(m, k, n) for k, n in WQ_SHAPES for m in MS]
    if args.quick:
        shapes = [(m, 4096, 11008) for m in (1, 8, 2048)]
    for m, k, n in shapes:
        w8, w4, _ = smoke.wq_case(gen, k, n)
        x = smoke.bf16_randn(gen, m, k)
        for fmt, wq in (("int8", w8), ("int4", w4)):
            times = {v: [] for v in names}
            for order in (names, names[::-1]):
                for v in order:
                    use(v)
                    times[v].append(smoke.median_ms(lambda: smoke.wq_run(fmt, x, wq)))
            print(f"{fmt} M={m} (K,N)=({k},{n}): " + "; ".join(
                f"{v} {t[0]:.4f}/{t[1]:.4f} ms" for v, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
