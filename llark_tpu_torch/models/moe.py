"""Mixture-of-Experts FFN (counterpart of llark_tpu/models/moe.py).

Routing is the JAX package's, step for step, in fp32:

  * router logits y @ W_r and their softmax;
  * top-k as k rounds of argmax (the first maximum on ties), each round
    masking the experts already chosen (`top_k_experts`);
  * a static capacity C per sequence row (`expert_capacity`); a token's slot
    in its expert is the number of earlier tokens of the row that chose that
    expert in this round plus every slot the earlier rounds used, and a
    token whose slot is >= C is dropped (its MLP output is 0; the residual
    stream still carries x);
  * "switch" gates are the raw softmax probabilities; "mixtral" divides the
    chosen gates by their sum (dropped choices included) after the loop;
  * the Switch load-balancing loss E * sum_e f_e p_e per row, meaned over
    rows, and the fraction of (token, choice) pairs dropped.

Padded positions route and take slots like any token, as in the JAX
package: nothing here masks them.

Dispatch is the JAX package's too: one-hot [B, S, E, C] dispatch and
combine tensors, contracted with the tokens into an expert-major [E, B, C, h]
buffer and back. Every expert runs on its C slots per row (slots no token
took hold zeros and give zeros). Every shape is static, as the JAX capacity
is: nothing reads a routing result back to the host, so the layer syncs
nothing and stays capturable in a CUDA graph.

On a sharded config (`parallel/mesh.py`) a rank holds E/e experts of the
"expert" axis, their FFN widths split over "tensor": it routes every token
as above (capacity and drops are those of the unsharded run), runs its own
experts and sums the outputs over both axes.

Expert stacks are [E, in, out] floats or weight-only quantized dicts
(models/quant.py): int8 stacks run one product per expert through
`quantized_dense` (the int8 kernel on the card), int4 stacks are
dequantized in the compute dtype first, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.models.quant import (
    dequantize_weight_int4,
    dequantize_weight_int4_cols,
    is_quantized,
    is_quantized_int4,
    quantized_dense,
)
from llark_tpu_torch.parallel import comm

Params = Dict[str, Any]


def expert_capacity(seq_len: int, cfg: ModelConfig) -> int:
    """Static per-row expert capacity: ceil(S K cf / E), clamped to [1, S]."""
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    c = math.ceil(seq_len * k * cfg.moe_capacity_factor / e)
    return max(1, min(seq_len, c))


def init_moe_layer_params(
    cfg: ModelConfig, dense_fn: Callable[[Tuple[int, ...], int], torch.Tensor]
) -> Params:
    """Stacked [L, ...] MoE params; `dense_fn(shape, fan_in)` is the
    decoder's init-scheme-aware draw (models/decoder.py)."""
    h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    e = cfg.moe_num_experts
    p: Params = {
        "moe_router": dense_fn((L, h, e), h),
        "moe_w_up": dense_fn((L, e, h, i), h),
        "moe_w_down": dense_fn((L, e, i, h), i),
    }
    if cfg.mlp_activation == "silu":
        p["moe_w_gate"] = dense_fn((L, e, h, i), h)
    return p


def top_k_experts(cfg: ModelConfig, probs: torch.Tensor) -> torch.Tensor:
    """The k experts each token chooses, in order ([B, S, K] int64): k rounds
    of argmax over the router probabilities [B, S, E] (the first maximum on
    ties), each round masking the experts already chosen."""
    masked, chosen = probs, []
    for _ in range(cfg.moe_top_k):
        idx = torch.argmax(masked, dim=-1)
        chosen.append(idx)
        masked = masked * (1.0 - F.one_hot(idx, cfg.moe_num_experts).to(probs.dtype))
    return torch.stack(chosen, dim=-1)


def moe_ffn(
    cfg: ModelConfig, lp: Params, y: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MoE feed-forward on the normed hidden states y [B, S, h] (compute
    dtype) with one layer's params `lp` (llark_tpu/models/moe.py:79-150).
    Returns (out [B, S, h] in y's dtype, {"aux_loss", "dropped_frac"} fp32
    scalars)."""
    dtype = y.dtype
    b, s, h = y.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    c = expert_capacity(s, cfg)
    logits = torch.matmul(y.float(), lp["moe_router"].float())
    probs = torch.softmax(logits, dim=-1)  # [B, S, E]
    experts = top_k_experts(cfg, probs)

    counts = probs.new_zeros((b, 1, e))  # slots already used per expert
    capacity = torch.arange(c, device=y.device)
    dispatch = probs.new_zeros((b, s, e, c))
    combine = probs.new_zeros((b, s, e, c))
    gate_sum = probs.new_zeros((b, s))  # the chosen gates' sum ("mixtral")
    top1 = None
    for kk in range(k):
        oh = F.one_hot(experts[..., kk], e).to(probs.dtype)  # [B, S, E]
        gate = (probs * oh).sum(-1)  # [B, S] the raw softmax probability
        # this token's slot: earlier tokens of the row in this round plus
        # every slot the earlier rounds used; a slot >= C matches no
        # capacity index, so the choice drops
        pos = torch.cumsum(oh, dim=1) - oh + counts
        counts = counts + oh.sum(dim=1, keepdim=True)
        pos_tok = (pos * oh).sum(-1)  # [B, S]
        slot = (pos_tok[..., None] == capacity).to(probs.dtype)  # [B, S, C]
        upd = oh[..., None] * slot[..., None, :]
        dispatch = dispatch + upd
        combine = combine + gate[..., None, None] * upd
        gate_sum = gate_sum + gate
        if kk == 0:
            top1 = oh
    if cfg.moe_routing == "mixtral":
        # the chosen gates, dropped ones included, renormalized to sum 1
        combine = combine / gate_sum.clamp_min(1e-9)[..., None, None]
    # Switch load-balancing loss: E * sum_e f_e p_e per row, meaned over rows
    f = top1.mean(dim=1)  # [B, E] top-1 token fraction
    p = probs.mean(dim=1)  # [B, E] mean router probability
    aux = e * (f * p).sum(-1).mean()
    dropped = 1.0 - dispatch.sum() / (b * s * k)

    shard = getattr(cfg, "shard", None)
    groups = shard.model_groups() if shard is not None else []
    if groups:
        # expert/tensor parallelism: every rank routed all its tokens
        # alike; it runs its E/e experts (their FFN columns split over
        # "tensor") and the partial outputs are summed over both axes. The
        # gates and the dispatched tokens carry the sum of the ranks'
        # gradients, so the replicated router and y get the whole of theirs.
        el = e // shard.size("expert")
        lo = shard.rank("expert") * el
        for g in groups:
            y = comm.copy_to(y, g)
            combine = comm.copy_to(combine, g)
        dispatch, combine = dispatch[:, :, lo:lo + el], combine[:, :, lo:lo + el]
        e = el
    ein = torch.einsum("bsec,bsh->ebch", dispatch.to(dtype), y)
    eout = expert_mlp(cfg, lp, ein.reshape(e, b * c, h), dtype).reshape(e, b, c, h)
    out = torch.einsum("bsec,ebch->bsh", combine.to(dtype), eout)
    if groups:
        out = out.float()
        for g in groups:
            out = comm.reduce_sum(out, g)
        out = out.to(dtype)
    return out, {"aux_loss": aux, "dropped_frac": dropped}


def _expert_dense(x: torch.Tensor, w: Any, dtype: torch.dtype) -> torch.Tensor:
    """x [E, N, in] @ w [E, in, out] -> [E, N, out] in `dtype`, where w is a
    float stack or a quantized dict. int8: one 2-D product per expert
    through `quantized_dense` (the int8 kernel on the card, the scale on its
    fp32 accumulator); int4 is a storage format and dequantizes first."""
    if is_quantized_int4(w):
        w = (dequantize_weight_int4_cols(w, dtype) if "q4c" in w
             else dequantize_weight_int4(w, dtype))
    if is_quantized(w):
        q, scale = w["q"], w["scale"]
        return torch.stack([
            quantized_dense(x[j], {"q": q[j], "scale": scale[j]}, None, dtype)
            for j in range(q.shape[0])
        ])
    return torch.bmm(x.to(dtype), w.to(dtype))


def expert_mlp(cfg: ModelConfig, lp: Params, ein: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The per-expert FFN on dispatched tokens ein [E, N, h]."""
    if lp.get("moe_w_gate") is not None:
        g = _expert_dense(ein, lp["moe_w_gate"], dtype)
        u = _expert_dense(ein, lp["moe_w_up"], dtype)
        z = F.silu(g.float()).to(dtype) * u
    else:
        u = _expert_dense(ein, lp["moe_w_up"], dtype)
        z = F.gelu(u.float(), approximate="tanh").to(dtype)
    return _expert_dense(z, lp["moe_w_down"], dtype)
