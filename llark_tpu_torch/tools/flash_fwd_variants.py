"""Time the flash-prefill kernel (`csrc/flash_fwd.cu`) beside builds of it
that differ in one tuning choice, on one CUDA card.

    python -m llark_tpu_torch.tools.flash_fwd_variants [--only NAME ...]

Each variant is the kernel's source with the textual substitutions listed in
VARIANTS, compiled with the package's nvcc flags (one process per variant,
all started together) into `llark_tpu_torch/_build/variants/`. Each build is
first held against the plain version on ragged, GQA and ALiBi cases (worst
query row within `chip_smoke.ROW_TOL`, log-sum-exp within
`chip_smoke.LSE_TOL`); the builds that pass are then timed in turns, in
forward and then in reverse order, with `chip_smoke.median_ms` (L2 flushed
before each launch, the host enqueue hidden) at chip_smoke.py's four K1
shapes. Prints the card's name and power limit, each build's ptxas report,
and per shape and variant both medians.
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

SOURCE = "flash_fwd.cu"
OUT_DIR = os.path.join(_build.BUILD_DIR, "variants")

# name -> [(text of the kernel's source, its replacement)]; "shipped" is
# the source as it stands
VARIANTS = {
    "shipped": [],
    # blocks of two warpgroups (128 query rows), or of one, at every grid
    "two_warpgroups": [("if (blocks_of_two < sms[dev]) {", "if (false) {")],
    "one_warpgroup": [("if (blocks_of_two < sms[dev]) {", "if (true) {")],
    # builds with no register cap (one block of two warpgroups an SM)
    "one_block_per_sm": [("__launch_bounds__(128 * NWG, MIN_BLOCKS)",
                          "__launch_bounds__(128 * NWG, 1)")],
    # a three-stage K/V ring (its shared memory leaves room for one block)
    "three_stages": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
}

# (label, batch, seq, kv_lengths, with log-sum-exp): chip_smoke.py's K1
# shapes, 32 heads of 128, causal; the admission lengths are about those
# of the admitted prompts in its phase 7
SHAPES = (
    ("training + lse [2,32,1024,128] kv [1024,700]", 1024, [1024, 700], True),
    ("training + lse [2,32,1024,128] kv [1024,1024]", 1024, [1024, 1024], True),
    ("serving prefill [1,32,384,128] kv 297", 384, [297], False),
    ("one-shot admission [8,32,512,128] kv 288-312", 512,
     [297, 301, 290, 312, 288, 305, 295, 299], False),
)


def variant_source(name: str) -> str:
    with open(os.path.join(_build.CSRC_DIR, SOURCE)) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise ValueError(f"variant {name}: {old!r} is not in {SOURCE}")
        src = src.replace(old, new)
    return src


def build(names) -> list:
    """Compile every variant at once; print each ptxas report. Returns the
    names that built."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name in names:
        cu = os.path.join(OUT_DIR, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(name))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
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


def holds(name: str, smoke) -> bool:
    use(name)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(smoke.SEED)
    worst_row, worst_lse = 0.0, 0.0
    # (batch, heads, kv heads, head_dim, seq, kv_lengths, ALiBi)
    for b, h, hkv, d, s, lengths, alibi in ((3, 8, 2, 128, 200, [0, 1, 129], True),
                                            (3, 8, 8, 64, 200, [200, 65, 1], False),
                                            (2, 32, 32, 128, 1024, [1024, 700], False)):
        q = smoke.bf16_randn(gen, b, h, s, d)
        k, v = (smoke.bf16_randn(gen, b, hkv, s, d) for _ in range(2))
        kw = dict(causal=True, kv_lengths=torch.tensor(lengths, device="cuda"),
                  slopes=attn_ops.alibi_slopes(h, "cuda") if alibi else None)
        got, lse = attn_ops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        want, lse_want = attn_ops._flash_attention_fwd_plain(q, k, v, return_lse=True, **kw)
        worst_row = max(worst_row, smoke.row_err(got, want))
        worst_lse = max(worst_lse, float((lse - lse_want).abs().max()))
    ok = worst_row <= smoke.ROW_TOL["flash_fwd"] and worst_lse <= smoke.LSE_TOL
    print(f"== check {name}: worst row {worst_row:.3e}, worst lse {worst_lse:.3e}: "
          f"{'holds' if ok else 'FAILS'}")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=list(VARIANTS), choices=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke  # its timing and checking helpers; run from the repo root

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), torch.__version__)
    names = [n for n in build(args.only) if holds(n, smoke)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(smoke.SEED)
    for label, s, lengths, with_lse in SHAPES:
        b = len(lengths)
        q, k, v = (smoke.bf16_randn(gen, b, 32, s, 128) for _ in range(3))
        kw = dict(causal=True, kv_lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"),
                  return_lse=with_lse)
        times = {n: [] for n in names}
        for order in (names, names[::-1]):
            for name in order:
                use(name)
                times[name].append(smoke.median_ms(lambda: attn_ops.flash_attention_fwd(q, k, v, **kw)))
        print(f"{label}: " + "; ".join(
            f"{n} {t[0]:.4f}/{t[1]:.4f} ms" for n, t in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
