"""Time the weight-only quantized products (`csrc/int8_matmul.cu`,
`csrc/int4_matmul.cu`) beside PyTorch's own at the admission shapes, on one
CUDA card.

    python -m llark_tpu_torch.tools.wq_library_times

At M = 2048 (chunked admission) and 4096 (one-shot admission) and the three
Llama-2-7B projections (K, N): each kernel's median device time and bound,
`torch.matmul` on a bf16 copy of the weight (not the same function), and
`torch._weight_int8pack_mm` / `torch._weight_int4pack_mm` held against the
kernel (`chip_smoke.time_wq_library`, which chip_smoke.py runs at two shapes
only: the int8 library call takes 75-407 ms a call here).
"""

from __future__ import annotations

import subprocess
import sys

import torch

from llark_tpu_torch.ops import _build

SHAPES = tuple((m, k, n) for m in (2048, 4096) for k, n in
               ((4096, 4096), (4096, 11008), (11008, 4096)))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke  # its timing helpers; run from the repo root

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), torch.__version__)
    _build.build_all()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(smoke.SEED)
    kernel_ms = {}
    for m, k, n in SHAPES:
        w8, w4, wb = smoke.wq_case(gen, k, n)
        x = smoke.bf16_randn(gen, m, k)
        bf16_ms = smoke.median_ms(lambda: torch.matmul(x, wb))
        for fmt, wq in (("int8", w8), ("int4", w4)):
            ms = kernel_ms[(fmt, m, k, n)] = smoke.median_ms(lambda: smoke.wq_run(fmt, x, wq))
            bound_ms, bound_by = smoke.wq_bound(fmt, m, k, n)
            print(f"{fmt}_matmul at M={m} (K,N)=({k},{n}): kernel {ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}); not the same function: torch.matmul on a "
                  f"bf16 copy of the weight {bf16_ms:.4f} ms")
        del w8, w4, wb, x
    smoke.time_wq_library(gen, kernel_ms, shapes=SHAPES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
