"""Time the MoE layer's token dispatch in two designs on one CUDA card.

    python -m llark_tpu_torch.tools.moe_dispatch

"einsum" is the port's `models/moe.py`: one-hot [B, S, E, C] dispatch and
combine tensors contracted with the tokens, as the JAX package computes them
(llark_tpu/models/moe.py:106-150). "gather" is the design it replaced:
each (token, choice)'s capacity slot computed as an index, the tokens
gathered into the expert-major [E, B C, h] buffer, and each token's k
expert rows gathered back and summed. Both route alike (`top_k_experts`)
and run the same `expert_mlp` on every expert's C slots per row.

One Mixtral-8x7B-width layer (hidden 4096, 14336 intermediate, 8 experts,
top 2), bf16 weights drawn on the card from seed 0, at the shapes
chip_smoke.py phase 22 gives it: prefills of 1 and 4 rows of 384 positions
and a wave of 8 rows of 512 ("mixtral" routing, capacity factor 4), a decode
step of 8 rows, and the adapter step's micro-batch of 2 rows of 1024
("switch", capacity factor 1.25) forward, and forward and backward to the
layer's input. Per shape: the two designs' outputs against each other
(rel-to-max), then each design's median device time over 20 calls from CUDA
events (a sleep kernel hides the host's enqueue; the designs alternate),
and the difference, the dispatch's own cost. Starts with the card's name
and power limit.
"""

from __future__ import annotations

import dataclasses
import statistics
import subprocess

import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.models import moe

SHAPES = (  # (label, rows, positions, routing, capacity factor, backward)
    ("prefill 1 x 384", 1, 384, "mixtral", 4.0, False),
    ("prefill 4 x 384", 4, 384, "mixtral", 4.0, False),
    ("engine wave 8 x 512", 8, 512, "mixtral", 4.0, False),
    ("decode step 8 x 1", 8, 1, "mixtral", 4.0, False),
    ("train micro-batch 2 x 1024, forward", 2, 1024, "switch", 1.25, False),
    ("train micro-batch 2 x 1024, forward + backward", 2, 1024, "switch", 1.25, True),
)
N_TIMED = 20


def gather_moe_ffn(cfg: ModelConfig, lp, y: torch.Tensor):
    """`moe.moe_ffn` with the dispatch by index: the same routing, slots and
    drops; a dropped choice points at a zero row past the end."""
    dtype = y.dtype
    b, s, h = y.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    c = moe.expert_capacity(s, cfg)
    probs = torch.softmax(torch.matmul(y.float(), lp["moe_router"].float()), dim=-1)
    experts = moe.top_k_experts(cfg, probs)
    counts = probs.new_zeros((b, 1, e))
    rows = torch.arange(b, device=y.device)[:, None] * c
    slots, gates = [], []
    for kk in range(k):
        idx = experts[..., kk]
        oh = torch.nn.functional.one_hot(idx, e).to(probs.dtype)
        gates.append((probs * oh).sum(-1))
        pos = torch.cumsum(oh, dim=1) - oh + counts
        counts = counts + oh.sum(dim=1, keepdim=True)
        pos_tok = (pos * oh).sum(-1).long()
        slots.append(torch.where(pos_tok < c, idx * (b * c) + rows + pos_tok, e * b * c))
    slots = torch.stack(slots, dim=-1)  # [B, S, K]
    weights = torch.stack(gates, dim=-1)
    if cfg.moe_routing == "mixtral":
        weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    n_slots = e * b * c
    token = torch.arange(b * s, device=y.device).reshape(b, s, 1).expand_as(slots)
    src = torch.full((n_slots + 1,), b * s, dtype=torch.long, device=y.device)
    src.scatter_(0, slots.reshape(-1), token.reshape(-1))
    y_pad = torch.cat([y.reshape(b * s, h), y.new_zeros((1, h))])
    ein = y_pad[src[:n_slots]].reshape(e, b * c, h)
    eout = moe.expert_mlp(cfg, lp, ein, dtype).reshape(n_slots, h)
    eout_pad = torch.cat([eout, eout.new_zeros((1, h))])
    picked = eout_pad[slots.reshape(-1)].reshape(b, s, k, h)
    return (picked.float() * weights.to(dtype).float()[..., None]).sum(dim=2).to(dtype)


def device_ms(fn) -> float:
    """Median CUDA-event time of fn, a ~10 ms sleep kernel queued before
    each call so that the events time the device work alone."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(N_TIMED):
        torch.cuda._sleep(20_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_dispatch: no CUDA card")
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    base = ModelConfig(vocab_size=32004, hidden_size=4096, intermediate_size=14336, num_layers=1,
                       num_heads=32, num_kv_heads=8, moe_num_experts=8, moe_top_k=2)
    g = torch.Generator(device="cuda").manual_seed(0)
    lp = {k: w[0].to(torch.bfloat16) for k, w in moe.init_moe_layer_params(
        base, lambda shape, fan_in: torch.randn(shape, generator=g, device="cuda").div_(
            fan_in ** 0.5)).items()}
    lp["moe_router"] = lp["moe_router"].float()
    designs = {"einsum": lambda cfg, y: moe.moe_ffn(cfg, lp, y)[0], "gather":
               lambda cfg, y: gather_moe_ffn(cfg, lp, y)}
    for label, b, s, routing, cf, backward in SHAPES:
        cfg = dataclasses.replace(base, moe_routing=routing, moe_capacity_factor=cf)
        y = torch.randn((b, s, 4096), generator=g, device="cuda").to(torch.bfloat16)
        dy = torch.randn((b, s, 4096), generator=g, device="cuda").to(torch.bfloat16)
        if backward:
            y.requires_grad_()
            calls = {name: (lambda f=f: torch.autograd.grad(f(cfg, y), [y], dy)[0])
                     for name, f in designs.items()}
        else:
            calls = {name: (lambda f=f: f(cfg, y)) for name, f in designs.items()}
        with torch.set_grad_enabled(backward), torch.inference_mode(not backward):
            got = {name: call().float() for name, call in calls.items()}
            diff = (got["einsum"] - got["gather"]).abs().max().item()
            rel = diff / max(got["gather"].abs().max().item(), 1e-30)
            times = {name: [] for name in calls}
            for _ in range(2):  # alternated, in both orders
                for name in ("einsum", "gather", "gather", "einsum"):
                    times[name].append(device_ms(calls[name]))
        ms = {name: statistics.median(t) for name, t in times.items()}
        print(f"{label} (C = {moe.expert_capacity(s, cfg)}, {routing}): einsum {ms['einsum']:.4f} "
              f"ms, gather {ms['gather']:.4f} ms, einsum - gather {ms['einsum'] - ms['gather']:+.4f} "
              f"ms; {'dx' if backward else 'outputs'} einsum vs gather rel-to-max {rel:.3e}")
        del y, dy, got
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
