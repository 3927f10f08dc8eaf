"""Model-FLOP accounting and MFU (counterpart of llark_tpu/train/flops.py).

Accounting follows the PaLM-appendix convention:
  * matmul FLOPs per token (fwd+bwd) = 6 * N_matmul, where N_matmul is
    every parameter that takes part in a dense product (attention and MLP
    projections, the LM head or tied-embedding logits, the multimodal
    projector; of a MoE layer the top-k experts a token is routed to and
    the router); the embedding lookup is excluded;
  * attention score/value FLOPs (fwd+bwd) = 6 * L * T * d_attn per token
    for a causal mask (T / 2 keys on average, two products);
  * a frozen base counts 4 * N instead of 6 * N: the backward still takes
    dL/dx through every frozen product but no dL/dW; rank-r LoRA adds
    6 * N_lora for the adapters on the attention projections, as the JAX
    package counts them.

MFU = achieved model FLOP/s / the card's dense bf16 peak.
"""

from __future__ import annotations

from typing import Optional

from llark_tpu_torch.config import ModelConfig

# dense bf16 tensor-core FLOP/s by device-name substring (NVIDIA's data
# sheet, SXM part, at its full power limit of 700 W)
_PEAK_BF16 = (("H100", 989e12),)


def device_peak_flops(device_index: int = 0) -> Optional[float]:
    """Peak dense bf16 FLOP/s of the CUDA card, or None (no card, or a card
    this table does not know)."""
    import torch

    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device_index)
    for marker, peak in _PEAK_BF16:
        if marker in name:
            return peak
    return None


def matmul_param_count(cfg: ModelConfig, multimodal: bool = True) -> int:
    """Parameters that feed dense products (active per token)."""
    h = cfg.hidden_size
    d_attn = cfg.num_heads * cfg.head_dim
    d_kv = cfg.num_kv_heads * cfg.head_dim
    per_layer = h * d_attn + 2 * h * d_kv + d_attn * h  # wq, wk, wv, wo
    mlp = 2 * h * cfg.intermediate_size
    if cfg.mlp_activation == "silu":
        mlp += h * cfg.intermediate_size
    if cfg.moe_num_experts > 0:
        # the experts a token is routed to, and the router
        # (llark_tpu/train/flops.py:61-66)
        per_layer += cfg.moe_top_k * mlp + h * cfg.moe_num_experts
    else:
        per_layer += mlp
    total = cfg.num_layers * per_layer
    total += h * cfg.vocab_size  # logits product (tied or not, it computes)
    if multimodal:
        total += cfg.mm_hidden_size * h  # projector
    return total


def train_flops_per_token(
    cfg: ModelConfig, seq_len: int, multimodal: bool = True, frozen_base: bool = False
) -> float:
    """Model FLOPs per trained token, forward + backward
    (llark_tpu/train/flops.py:78-105)."""
    factor = 4.0 if frozen_base else 6.0
    matmul = factor * matmul_param_count(cfg, multimodal)
    if frozen_base and cfg.lora_rank:
        # adapters on the attention projections: (in x r + r x out) each
        h = cfg.hidden_size
        d_attn = cfg.num_heads * cfg.head_dim
        d_kv = cfg.num_kv_heads * cfg.head_dim
        r = cfg.lora_rank
        per_layer = r * (h + d_attn) + 2 * r * (h + d_kv) + r * (d_attn + h)
        matmul += 6.0 * cfg.num_layers * per_layer
    attn = 6.0 * cfg.num_layers * seq_len * cfg.num_heads * cfg.head_dim
    return matmul + attn


def infer_flops_per_token(
    cfg: ModelConfig, seq_len: int, multimodal: bool = True
) -> float:
    """Model FLOPs per token, FORWARD only (prefill/decode accounting):
    2 * N_matmul + causal attention 2 * L * (T/2) * 2 * d_attn."""
    matmul = 2.0 * matmul_param_count(cfg, multimodal)
    attn = 2.0 * cfg.num_layers * seq_len * cfg.num_heads * cfg.head_dim
    return matmul + attn


def train_mfu(
    cfg: ModelConfig,
    seq_len: int,
    tokens_per_s: float,
    n_devices: int = 1,
    peak: Optional[float] = None,
    frozen_base: bool = False,
) -> Optional[float]:
    """Achieved MFU in [0, 1], or None when the peak is unknown (CPU)."""
    peak = peak if peak is not None else device_peak_flops()
    if not peak or tokens_per_s <= 0:
        return None
    flops = train_flops_per_token(cfg, seq_len, frozen_base=frozen_base)
    return flops * tokens_per_s / (peak * n_devices)
