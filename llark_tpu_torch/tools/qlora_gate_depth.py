"""Read chip_smoke.py phase 18's QLoRA gradient gate at another depth, on one
CUDA card.

    python -m llark_tpu_torch.tools.qlora_gate_depth [--layers 8] [--steps 3] [--bits 4]

Phase 18's run (b) (Llama-2-7B width, an int4 rows base with group 128, or
with `--bits 8` run (a)'s int8 base; rank 64, alpha 16, dropout 0.05, remat,
batch 2 x 2 x 512, the shard of phase 10) cut to `--layers` layers: first
the seeded init (every LoRA-B zero, the gate read before any step), then
`--steps` steps through `train()`. On each tree, `chip_smoke.plain_step_readings`:
the gate (quantized kernels against plain products, both bf16), and
against the plain step in fp32 the plain step's own bf16 rounding (the
floor) and the quantized kernels. A gate reading near the floor is the
rounding of the bf16 step; one well above it points at the kernels.
Nothing is gated. Starts with the card's name and power limit. Run from the
repo root.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import tempfile

import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.models import lora as lora_mod
from llark_tpu_torch.models import quant
from llark_tpu_torch.models.fusion import init_llark_params


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--bits", type=int, default=4, choices=(4, 8))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qlora_gate_depth: no CUDA card")
        return 1
    import chip_smoke as smoke  # its training and reading helpers; run from the repo root

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cfg = dataclasses.replace(ModelConfig.llama2_7b(), num_layers=args.layers)
    fmt = "int4" if args.bits == 4 else "int8"
    with tempfile.TemporaryDirectory() as directory:
        shard = smoke.write_shards(directory, cfg)
        batch, bundle = smoke.lora_batch(cfg, shard)
        lora_cfg = dataclasses.replace(cfg, lora_rank=64, lora_alpha=16.0, lora_dropout=0.05)
        params = init_llark_params(lora_cfg, seed=smoke.SEED, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 1)
        params = lora_mod.init_lora_params(lora_cfg, gen, params)
        if fmt == "int8":
            params = quant.quantize_params_int8_incremental(lora_cfg, params)
        else:
            params = quant.quantize_params_int4_incremental(lora_cfg, params, group=128,
                                                            layout="rows")
        for name in lora_mod.lora_keys(params):
            params["layers"][name].requires_grad_()
        trees = [("the seeded init (LoRA-B zero)", lora_cfg, params)]
        _, result = smoke.run_training(
            f"{fmt} QLoRA, {args.layers} layers", cfg, os.path.join(directory, "run"), shard,
            args.steps, frozen_base=True, lr=2e-3, seq=smoke.LORA_SEQ,
            train_flags=dict(smoke.LORA_FLAGS, bits=args.bits), keep=True)
        trees.append((f"after {args.steps} steps", result["cfg"], result["state"].params))
        for label, c, p in trees:
            r = smoke.plain_step_readings(c, p, batch, bundle.audio_patch_id)
            print(f"{fmt}, {args.layers} layers, {label}: loss {r['loss_p']:.5f} (plain), "
                  f"{r['loss_p32']:.5f} (plain, fp32); LoRA-B gradient rel-to-max, worst of "
                  f"{r['leaves']} leaves: the gate (quantized routes vs plain products, bf16) "
                  f"{r['gate']:.3e} (limit {smoke.TRAIN_GRAD_TOL:g}); against the plain step in "
                  f"fp32: the plain step {r['floor']:.3e}, the quantized routes {r['q32']:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
