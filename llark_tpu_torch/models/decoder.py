"""Decoder for Llama-2 (RoPE/RMSNorm/SwiGLU/GQA) and MPT (ALiBi/LayerNorm/
GELU/tied embeddings) from one config: the counterpart of
llark_tpu/models/decoder.py for the serving path.

Parameters are a plain dict with the JAX package's layout: layer weights
are stacked [L, ...] and the layer loop is a Python loop over views of
them. Params live in `param_dtype` and are cast to the compute dtype at
use; norms and softmax accumulate in fp32.

The KV cache is a dict {"k", "v": [L, B, Hkv, S_max, D], "index": int}
and is UPDATED IN PLACE: `decoder_forward` writes the new keys/values into
the cache tensors it is given (slice assignment for prefill, a per-row
index write for ragged decode) and returns a dict that shares them with
an advanced "index".

Not in this slice of the port, each raising a clear error: paged caches,
the int8 KV cache, LoRA factors, MoE layers and quantized weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.ops.attention import alibi_slopes, multihead_attention, xla_attention
from llark_tpu_torch.ops.decode_attention import decode_attention

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ("bfloat16", "float32", ...) -> torch.dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Normalization and RoPE
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor], eps: float
) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _norm(cfg: ModelConfig, x, scale, bias):
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, scale, cfg.rms_norm_eps)
    return layer_norm(x, scale, bias, cfg.rms_norm_eps)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def _rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, S] or [S] -> (cos, sin), each [B|1, 1, S, D/2]."""
    freqs = rope_freqs(head_dim, theta, positions.device)  # [D/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    return torch.cos(angles)[:, None], torch.sin(angles)[:, None]


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2 :].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, H, S, D]; positions: [B, S] or [S]. Rotate-half convention
    (matches HF Llama so imported weights are compatible)."""
    return _rotate(x, *_rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_decoder_params(
    cfg: ModelConfig, generator: torch.Generator, device: torch.device
) -> Params:
    """Random parameters in the JAX package's layout (layer weights stacked
    on axis 0), drawn from `generator` on `device`. The init schemes are
    the JAX package's (cfg.init_scheme: kaiming N(0, 1/fan_in), xavier
    N(0, 2/(fan_in + fan_out)), small N(0, 2/(5 fan_in))); the numbers
    differ, since the two frameworks' generators do."""
    if cfg.moe_num_experts > 0:
        raise NotImplementedError("MoE layers come with a later slice of the port")
    pdt = torch_dtype(cfg.param_dtype)
    h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def _std(fan_in, fan_out):
        if cfg.init_scheme == "xavier":
            return math.sqrt(2.0 / (fan_in + fan_out))
        if cfg.init_scheme == "small":
            return math.sqrt(2.0 / (5.0 * fan_in))
        return 1.0 / math.sqrt(fan_in)  # kaiming

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return w.mul_(std).to(pdt)

    def dense(shape, fan_in):
        return normal(shape, _std(fan_in, shape[-1]))

    def const(shape, value):
        return torch.full(shape, value, dtype=pdt, device=device)

    layers: Params = {
        "attn_norm_scale": const((L, h), 1.0),
        "mlp_norm_scale": const((L, h), 1.0),
        "wq": dense((L, h, nh * hd), h),
        "wk": dense((L, h, nkv * hd), h),
        "wv": dense((L, h, nkv * hd), h),
        "wo": dense((L, nh * hd, h), nh * hd),
        "w_up": dense((L, h, i), h),
        "w_down": dense((L, i, h), i),
    }
    if cfg.mlp_activation == "silu":
        layers["w_gate"] = dense((L, h, i), h)
    if cfg.norm_type == "layernorm":
        layers["attn_norm_bias"] = const((L, h), 0.0)
        layers["mlp_norm_bias"] = const((L, h), 0.0)
    if cfg.use_bias:
        for name, width in (("bq", nh * hd), ("bk", nkv * hd), ("bv", nkv * hd),
                            ("bo", h), ("b_up", i), ("b_down", h)):
            layers[name] = const((L, width), 0.0)
        if cfg.mlp_activation == "silu":
            layers["b_gate"] = const((L, i), 0.0)

    params: Params = {
        "embed": normal((cfg.vocab_size, h), 0.02),
        "layers": layers,
        "final_norm_scale": const((h,), 1.0),
    }
    if cfg.norm_type == "layernorm":
        params["final_norm_bias"] = const((h,), 0.0)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((h, cfg.vocab_size), h)
    return params


def init_kv_cache(
    cfg: ModelConfig, batch_size: int, max_len: int, dtype=None, device=None
) -> Params:
    """Dense KV cache {"k", "v": [L, B, Hkv, max_len, D], "index": 0}."""
    if cfg.kv_cache_quant:
        raise NotImplementedError(
            "the int8 KV cache comes with a later slice of the port"
        )
    shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, max_len, cfg.head_dim)
    dtype = dtype or torch_dtype(cfg.dtype)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------


def _dense(x, w, b, dtype):
    if isinstance(w, dict):
        raise NotImplementedError(
            "quantized (int8/int4) weights come with a later slice of the port"
        )
    y = torch.matmul(x, w.to(dtype))
    if b is not None:
        y = y + b.to(dtype)
    return y


@dataclasses.dataclass
class _CacheStep:
    """Where one forward writes into the KV cache and what its queries
    attend there. The same for every layer, so decoder_forward computes it
    once."""

    start: Optional[int]  # prefill: slice start of the write
    rows: Optional[torch.Tensor]  # ragged decode: [B, 1] row index
    pos: Optional[torch.Tensor]  # ragged decode: [B, s] write positions
    kv_lengths: torch.Tensor  # [B] int32 live length after the write
    q_offset: Union[int, torch.Tensor]  # absolute position of query 0
    q_positions: Optional[torch.Tensor]  # ragged decode: [B] int32


def _cache_step(
    kv_cache: Params,
    b: int,
    s: int,
    cache_positions: Optional[torch.Tensor],
    seq_lengths: Optional[torch.Tensor],
    device: torch.device,
) -> _CacheStep:
    # write windows are clamped inside the cache like the JAX package's
    # dynamic_update_slice
    s_max = kv_cache["k"].shape[3]
    if cache_positions is not None:
        # ragged decode: each row writes at its own position
        cp = cache_positions.to(device=device, dtype=torch.int32)
        start = cp.long().clamp(0, s_max - s)
        step = _CacheStep(
            start=None,
            rows=torch.arange(b, device=device)[:, None],
            pos=start[:, None] + torch.arange(s, device=device),
            kv_lengths=cp + s,
            q_offset=cp,
            q_positions=cp,
        )
    else:
        # prefill: insert at the shared scalar index
        index = kv_cache["index"]
        step = _CacheStep(
            start=min(max(index, 0), s_max - s), rows=None, pos=None,
            kv_lengths=torch.full((b,), index + s, dtype=torch.int32, device=device),
            q_offset=index, q_positions=None,
        )
    if seq_lengths is not None:
        step.kv_lengths = torch.minimum(
            step.kv_lengths, seq_lengths.to(device=device, dtype=torch.int32)
        )
    return step


def _layer_forward(
    cfg: ModelConfig,
    lp: Params,
    x: torch.Tensor,  # [B, S, H] compute dtype
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],  # (cos, sin) tables
    kv_lengths: Optional[torch.Tensor],
    slopes: Optional[torch.Tensor],
    k_cache: Optional[torch.Tensor],  # [B, nkv, S_max, hd], written in place
    v_cache: Optional[torch.Tensor],
    step: Optional[_CacheStep],
    prefix_lengths: Optional[torch.Tensor] = None,
    prefill_from_empty: bool = False,
) -> torch.Tensor:
    dtype = x.dtype
    b, s, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    y = _norm(cfg, x, lp["attn_norm_scale"], lp.get("attn_norm_bias"))
    q = _dense(y, lp["wq"], lp.get("bq"), dtype).reshape(b, s, nh, hd).transpose(1, 2)
    k = _dense(y, lp["wk"], lp.get("bk"), dtype).reshape(b, s, nkv, hd).transpose(1, 2)
    v = _dense(y, lp["wv"], lp.get("bv"), dtype).reshape(b, s, nkv, hd).transpose(1, 2)

    if rope is not None:
        q = _rotate(q, *rope)
        k = _rotate(k, *rope)

    if k_cache is not None:
        if step.pos is not None:
            # [B, s] advanced index pairs -> values as [B, s, Hkv, D]
            k_cache[step.rows, :, step.pos] = k.transpose(1, 2).to(k_cache.dtype)
            v_cache[step.rows, :, step.pos] = v.transpose(1, 2).to(v_cache.dtype)
        else:
            k_cache[:, :, step.start : step.start + s] = k.to(k_cache.dtype)
            v_cache[:, :, step.start : step.start + s] = v.to(v_cache.dtype)
        if prefill_from_empty:
            # the cache held nothing before this call, so attention only
            # needs the in-flight K/V: S x S on the flash-prefill kernel
            attn = multihead_attention(
                q, k, v, causal=True, kv_lengths=kv_lengths, slopes=slopes,
                use_pallas=cfg.use_pallas_attention,
            )
        elif step.q_positions is not None and s <= 16 and cfg.use_flash_decode is True:
            # short-query decode: the flash-decode kernel reads only the
            # live cache positions
            attn = decode_attention(
                q, k_cache, v_cache, kv_lengths=step.kv_lengths,
                q_positions=step.q_positions, slopes=slopes,
            )
        else:
            attn = xla_attention(
                q, k_cache, v_cache, causal=True, kv_lengths=step.kv_lengths,
                slopes=slopes, q_offset=step.q_offset,
            )
    else:
        attn = multihead_attention(
            q, k, v, causal=True, kv_lengths=kv_lengths, slopes=slopes,
            use_pallas=cfg.use_pallas_attention, prefix_lengths=prefix_lengths,
        )

    attn = attn.transpose(1, 2).reshape(b, s, nh * hd)
    x = x + _dense(attn, lp["wo"], lp.get("bo"), dtype)

    y = _norm(cfg, x, lp["mlp_norm_scale"], lp.get("mlp_norm_bias"))
    up = _dense(y, lp["w_up"], lp.get("b_up"), dtype)
    if cfg.mlp_activation == "silu":
        gate = _dense(y, lp["w_gate"], lp.get("b_gate"), dtype)
        z = F.silu(gate.float()).to(dtype) * up
    else:
        z = F.gelu(up.float(), approximate="tanh").to(dtype)
    return x + _dense(z, lp["w_down"], lp.get("b_down"), dtype)


# ---------------------------------------------------------------------------
# Full decoder forward
# ---------------------------------------------------------------------------


def _check_slice(cfg: ModelConfig, params: Params, kv_cache: Optional[Params]) -> None:
    if cfg.moe_num_experts > 0:
        raise NotImplementedError("MoE layers come with a later slice of the port")
    if any(name.endswith(("_lora_a", "_lora_b")) for name in params["layers"]):
        raise NotImplementedError("LoRA factors come with the training slice of the port")
    if kv_cache is not None and "block_tables" in kv_cache:
        raise NotImplementedError("paged KV caches come with the serving-engine slice of the port")
    if kv_cache is not None and "k_scale" in kv_cache:
        raise NotImplementedError("the int8 KV cache comes with a later slice of the port")


def decoder_forward(
    cfg: ModelConfig,
    params: Params,
    *,
    input_ids: Optional[torch.Tensor] = None,  # [B, S]
    inputs_embeds: Optional[torch.Tensor] = None,  # [B, S, H]
    seq_lengths: Optional[torch.Tensor] = None,  # [B]
    positions: Optional[torch.Tensor] = None,  # [B, S]
    kv_cache: Optional[Params] = None,
    cache_positions: Optional[torch.Tensor] = None,  # [B] ragged decode writes
    return_hidden: bool = False,
    prefix_lengths: Optional[torch.Tensor] = None,  # [B] prefix-LM boundaries
    prefill_from_empty: bool = False,  # this call fills an EMPTY cache
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Run the decoder (llark_tpu/models/decoder.py:579-778). Returns
    (logits_or_hidden, kv_cache|None); logits are fp32.

    Without a cache: pass input_ids/inputs_embeds + seq_lengths (right-
    padded mask). Prefill/decode: also pass kv_cache, which is written in
    place; positions default to cache_index + arange(S), or to
    cache_positions + arange(S) for ragged decode.
    """
    _check_slice(cfg, params, kv_cache)
    dtype = torch_dtype(cfg.dtype)
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(cfg, params, input_ids)
    x = inputs_embeds.to(dtype)
    b, s, _ = x.shape
    dev = x.device

    step = None
    if kv_cache is not None:
        step = _cache_step(kv_cache, b, s, cache_positions, seq_lengths, dev)
    if positions is None:
        pos = torch.arange(s, device=dev)[None, :]
        if cache_positions is not None:
            pos = pos + cache_positions.to(dev).long()[:, None]
        elif kv_cache is not None:
            pos = pos + kv_cache["index"]
        positions = pos.expand(b, s)

    # layer-invariant inputs, computed once per forward
    rope = None if cfg.use_alibi else _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    slopes = alibi_slopes(cfg.num_heads, device=dev) if cfg.use_alibi else None
    for l in range(cfg.num_layers):
        lp = {name: w[l] for name, w in params["layers"].items()}
        x = _layer_forward(
            cfg, lp, x, rope, seq_lengths, slopes,
            None if kv_cache is None else kv_cache["k"][l],
            None if kv_cache is None else kv_cache["v"][l],
            step, prefix_lengths, prefill_from_empty,
        )
    new_cache = None
    if kv_cache is not None:
        new_cache = {"k": kv_cache["k"], "v": kv_cache["v"], "index": kv_cache["index"] + s}

    x = _norm(cfg, x, params["final_norm_scale"], params.get("final_norm_bias"))
    if return_hidden:
        return x, new_cache
    return compute_logits(cfg, params, x), new_cache


def embed_tokens(cfg: ModelConfig, params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][input_ids.long()].to(torch_dtype(cfg.dtype))


def compute_logits(cfg: ModelConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """LM head, tied to the embedding for MPT (reference: m2t/models/mpt.py:312).
    The product runs in the compute dtype and the logits come back as
    fp32 (in bf16 they carry bf16 rounding; the JAX package keeps the fp32
    accumulator)."""
    dtype = hidden.dtype
    if cfg.tie_embeddings:
        return torch.matmul(hidden, params["embed"].to(dtype).t()).float()
    w = params["lm_head"]
    if isinstance(w, dict):
        raise NotImplementedError(
            "quantized (int8/int4) weights come with a later slice of the port"
        )
    return torch.matmul(hidden, w.to(dtype)).float()
