"""Decoder for Llama-2 (RoPE/RMSNorm/SwiGLU/GQA) and MPT (ALiBi/LayerNorm/
GELU/tied embeddings) from one config: the counterpart of
llark_tpu/models/decoder.py for serving and training.

Parameters are a plain dict with the JAX package's layout: layer weights
are stacked [L, ...] and the layer loop is a Python loop over views of
them. Params live in `param_dtype` and are cast to the compute dtype at
use; norms and softmax accumulate in fp32.

The KV cache is a dict {"k", "v": [L, B, Hkv, S_max, D], "index": int}
and is UPDATED IN PLACE: `decoder_forward` writes the new keys/values into
the cache tensors it is given (slice assignment for prefill, a per-row
index write for ragged decode) and returns a dict that shares them with
an advanced "index". With `cfg.kv_cache_quant` the cache holds int8 values
and fp32 per-position scales "k_scale", "v_scale" [L, B, Hkv, S_max]. A
paged cache (`init_paged_kv_cache`) holds block POOLS [L, N, Hkv, bs, D]
(scales [L, N, Hkv, bs]) shared by all rows and per-row "block_tables"
[B, max_blocks]: logical position p of row b lives at
pool[tables[b, p // bs], :, p % bs].

Training runs the no-cache branch with autograd: attention goes through the
flash forward and backward kernels (`ops/attention.py` `_FlashAttention`),
and with `cfg.remat` each layer is a `torch.utils.checkpoint` segment whose
activations are recomputed in the backward (the JAX package's "full"
policy).

Weight-only quantized trees (`models/quant.py`: int8, int4 in the rows or
cols layout) serve through the same forward: a quantized leaf is a dict
whose tensors are stacked [L, ...] like any other, `_dense` routes it to
`quantized_dense` / `quantized_dense_int4`, and the LM head keeps its fp32
accumulator. The quantized products carry no gradient.

Not in this slice of the port, each raising a clear error: LoRA factors and
MoE layers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.models.quant import (
    dequantize_weight_int4,
    quantized_dense,
    quantized_dense_int4,
)
from llark_tpu_torch.ops.attention import alibi_slopes, multihead_attention, xla_attention
from llark_tpu_torch.ops.decode_attention import _dense_view, decode_attention

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
    """Dense KV cache {"k", "v": [L, B, Hkv, max_len, D], "index": 0}; with
    `cfg.kv_cache_quant` int8 values plus fp32 per-(layer, row, head,
    position) scales "k_scale", "v_scale" (llark_tpu/models/decoder.py:167-186)."""
    shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, max_len, cfg.head_dim)
    if cfg.kv_cache_quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "index": 0,
        }
    dtype = dtype or torch_dtype(cfg.dtype)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }


def init_paged_kv_cache(
    cfg: ModelConfig,
    batch_size: int,
    num_blocks: int,
    block_size: int,
    max_blocks_per_row: int,
    dtype=None,
    device=None,
) -> Params:
    """Block-pool KV cache (llark_tpu/models/decoder.py:189-231): pools
    [L, num_blocks, Hkv, block_size, D] (int8 + fp32 scales with
    `cfg.kv_cache_quant`) shared by all rows, and int32 block tables
    [batch_size, max_blocks_per_row]. Physical blocks 0..batch_size-1 are
    per-slot parking blocks: every table entry of row b starts at b, so
    parked writes of a row land in its own block and never in a block
    another row owns. Real blocks are allocated from batch_size upward."""
    shape = (cfg.num_layers, num_blocks, cfg.num_kv_heads, block_size, cfg.head_dim)
    tables = torch.arange(batch_size, dtype=torch.int32, device=device)[:, None]
    out: Params = {
        "block_tables": tables.expand(batch_size, max_blocks_per_row).contiguous(),
        "index": 0,
    }
    if cfg.kv_cache_quant:
        out.update(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )
    else:
        dtype = dtype or torch_dtype(cfg.dtype)
        out.update(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))
    return out


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, S, D] -> (int8 values, fp32 per-(B, H, S) scales), absmax over
    D (llark_tpu/models/decoder.py:234-240). torch.round, like jnp.round,
    rounds half to even."""
    xf = x.float()
    sc = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / sc.clamp_min(1e-8)[..., None]).to(torch.int8)
    return q, sc


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------


def _dense(x, w, b, dtype):
    if isinstance(w, dict):  # int8/int4 weight-only (models/quant.py)
        if "q4" in w or "q4c" in w:
            return quantized_dense_int4(x, w, b, dtype)
        return quantized_dense(x, w, b, dtype)
    y = torch.matmul(x, w.to(dtype))
    if b is not None:
        y = y + b.to(dtype)
    return y


@dataclasses.dataclass
class _CacheStep:
    """Where one forward writes into the KV cache and what its queries
    attend there. The same for every layer, so decoder_forward computes it
    once."""

    kv_lengths: torch.Tensor  # [B] int32 live length after the write
    q_offset: Union[int, torch.Tensor]  # absolute position of query 0
    q_positions: Optional[torch.Tensor] = None  # ragged/paged writes: [B] int32
    start: Optional[int] = None  # dense prefill: slice start of the write
    rows: Optional[torch.Tensor] = None  # dense ragged decode: [B, 1] row index
    pos: Optional[torch.Tensor] = None  # dense ragged decode: [B, s] positions
    # paged: the tables; per-token physical blocks and offsets [B, s] of a
    # decode write, or the [B, s // bs] whole blocks of a paged_chunk write
    block_tables: Optional[torch.Tensor] = None
    blocks: Optional[torch.Tensor] = None
    offsets: Optional[torch.Tensor] = None
    paged_chunk: bool = False


def _cache_step(
    kv_cache: Params,
    b: int,
    s: int,
    cache_positions: Optional[torch.Tensor],
    seq_lengths: Optional[torch.Tensor],
    device: torch.device,
    paged_chunk: bool = False,
) -> _CacheStep:
    # write windows are clamped inside the cache like the JAX package's
    # dynamic_update_slice
    tables = kv_cache.get("block_tables")
    if paged_chunk and tables is None:
        raise ValueError("paged_chunk writes need a paged cache (init_paged_kv_cache)")
    if tables is not None:
        if cache_positions is None:
            raise ValueError(
                "paged caches support ragged decode writes and block-aligned "
                "paged_chunk prefill (both keyed by cache_positions); scalar-"
                "index prefill goes through dense bucket caches and the "
                "server's block insert"
            )
        bk = kv_cache["k"].shape[3]
        tables = tables.to(device=device, dtype=torch.int64)
        last = tables.shape[1] - 1
        cp = cache_positions.to(device=device, dtype=torch.int32)
        step = _CacheStep(kv_lengths=cp + s, q_offset=cp, q_positions=cp,
                          block_tables=tables, paged_chunk=paged_chunk)
        if paged_chunk:
            # prefill-chunk bulk write: positions and s are block-aligned
            # (the server's contract), so each row writes s // bs whole
            # blocks
            if s % bk:
                raise ValueError(
                    f"paged_chunk requires the chunk ({s}) to be a multiple of "
                    f"the KV block size ({bk})"
                )
            idx = (cp.long() // bk)[:, None] + torch.arange(s // bk, device=device)
            step.blocks = tables.gather(1, idx.clamp(max=last))
        else:
            # token t of row b lands at pool[table[b, pos // bs], :, pos % bs]
            pos = cp.long()[:, None] + torch.arange(s, device=device)
            step.blocks = tables.gather(1, (pos // bk).clamp(0, last))
            step.offsets = pos % bk
    elif cache_positions is not None:
        # ragged decode: each row writes at its own position
        s_max = kv_cache["k"].shape[3]
        cp = cache_positions.to(device=device, dtype=torch.int32)
        start = cp.long().clamp(0, s_max - s)
        step = _CacheStep(
            kv_lengths=cp + s, q_offset=cp, q_positions=cp,
            rows=torch.arange(b, device=device)[:, None],
            pos=start[:, None] + torch.arange(s, device=device),
        )
    else:
        # prefill: insert at the shared scalar index
        s_max = kv_cache["k"].shape[3]
        index = kv_cache["index"]
        step = _CacheStep(
            kv_lengths=torch.full((b,), index + s, dtype=torch.int32, device=device),
            q_offset=index, start=min(max(index, 0), s_max - s),
        )
    if seq_lengths is not None:
        step.kv_lengths = torch.minimum(
            step.kv_lengths, seq_lengths.to(device=device, dtype=torch.int32)
        )
    return step


def _cache_write(step: _CacheStep, cache: torch.Tensor, x: torch.Tensor) -> None:
    """Write x [B, Hkv, s(, D)] -- keys or values, or their int8 scales --
    into one layer's cache tensor, in place."""
    x = x.to(cache.dtype)
    if step.paged_chunk:
        b, hkv, s = x.shape[:3]
        m = step.blocks.shape[1]
        blocks = x.reshape((b, hkv, m, s // m) + x.shape[3:]).transpose(1, 2)
        cache[step.blocks.reshape(-1)] = blocks.reshape((b * m, hkv, s // m) + x.shape[3:])
    elif step.blocks is not None:
        # advanced indices around a slice: the indexed view is [B, s, Hkv(, D)]
        cache[step.blocks, :, step.offsets] = x.transpose(1, 2)
    elif step.pos is not None:
        cache[step.rows, :, step.pos] = x.transpose(1, 2)
    else:
        cache[:, :, step.start : step.start + x.shape[2]] = x


def _layer_forward(
    cfg: ModelConfig,
    lp: Params,
    x: torch.Tensor,  # [B, S, H] compute dtype
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],  # (cos, sin) tables
    kv_lengths: Optional[torch.Tensor],
    slopes: Optional[torch.Tensor],
    layer_cache: Optional[Params],  # this layer's views, written in place:
    # "k", "v" [B, nkv, S_max, hd] (paged: pools [N, nkv, bs, hd]) and, for
    # an int8 cache, "k_scale", "v_scale"
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

    if layer_cache is not None:
        k_cache, v_cache = layer_cache["k"], layer_cache["v"]
        ks_cache, vs_cache = layer_cache.get("k_scale"), layer_cache.get("v_scale")
        if ks_cache is not None:
            k_store, k_sc = _quantize_kv(k)
            v_store, v_sc = _quantize_kv(v)
            _cache_write(step, ks_cache, k_sc)
            _cache_write(step, vs_cache, v_sc)
        else:
            k_store, v_store = k, v
        _cache_write(step, k_cache, k_store)
        _cache_write(step, v_cache, v_store)
        tables = step.block_tables
        if prefill_from_empty:
            # the cache held nothing before this call, so attention only
            # needs the in-flight K/V: S x S on the flash-prefill kernel
            attn = multihead_attention(
                q, k, v, causal=True, kv_lengths=kv_lengths, slopes=slopes,
                use_pallas=cfg.use_pallas_attention,
            )
        elif tables is not None and not step.paged_chunk:
            # paged decode: the flash-decode kernel resolves the tables
            # itself; the dispatcher's other route gathers a dense view
            attn = decode_attention(
                q, k_cache, v_cache, kv_lengths=step.kv_lengths,
                q_positions=step.q_positions, k_scale=ks_cache, v_scale=vs_cache,
                slopes=slopes, use_pallas=cfg.use_flash_decode is not False,
                block_tables=tables,
            )
        elif (step.pos is not None and s <= 16 and cfg.use_flash_decode is True):
            # short-query decode: the flash-decode kernel reads only the
            # live cache positions
            attn = decode_attention(
                q, k_cache, v_cache, kv_lengths=step.kv_lengths,
                q_positions=step.q_positions, k_scale=ks_cache, v_scale=vs_cache,
                slopes=slopes,
            )
        else:
            if step.paged_chunk:
                # chunk queries attend their rows' whole admission span (the
                # tables passed for admission are cropped to it): a dense
                # per-layer view of the pool
                k_cache, v_cache = _dense_view(k_cache, tables), _dense_view(v_cache, tables)
                if ks_cache is not None:
                    ks_cache = _dense_view(ks_cache, tables)
                    vs_cache = _dense_view(vs_cache, tables)
            attn = xla_attention(
                q, k_cache, v_cache, causal=True, kv_lengths=step.kv_lengths,
                slopes=slopes, q_offset=step.q_offset, k_scale=ks_cache, v_scale=vs_cache,
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

# the tensors of a KV cache dict, per layer [L, ...]
CACHE_TENSORS = ("k", "v", "k_scale", "v_scale")


def _layer_slice(w, l: int):
    """Layer l of a stacked leaf; a quantized leaf is sliced inside its dict
    ({'q': [L, K, N], 'scale': [L, 1, N]} -> {'q': [K, N], 'scale': [1, N]})."""
    if isinstance(w, dict):
        return {key: t[l] for key, t in w.items()}
    return w[l]


def _check_slice(cfg: ModelConfig, params: Params) -> None:
    if cfg.moe_num_experts > 0:
        raise NotImplementedError("MoE layers come with a later slice of the port")
    if any(name.endswith(("_lora_a", "_lora_b")) for name in params["layers"]):
        raise NotImplementedError("LoRA factors come with a later slice of the port")


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
    trainable_token_start: Optional[int] = None,  # tied-LM-head freeze boundary
    paged_chunk: bool = False,  # block-aligned prefill chunk straight into a
    # paged pool (cache_positions and S multiples of the block size)
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Run the decoder (llark_tpu/models/decoder.py:579-778). Returns
    (logits_or_hidden, kv_cache|None); logits are fp32.

    Without a cache: pass input_ids/inputs_embeds + seq_lengths (right-
    padded mask). Prefill/decode: also pass kv_cache (dense, int8 or
    paged), which is written in place; positions default to
    cache_index + arange(S), or to cache_positions + arange(S) for ragged
    decode and paged writes. The returned cache shares the given tensors
    (block tables and scales included) with "index" advanced by S.
    """
    _check_slice(cfg, params)
    dtype = torch_dtype(cfg.dtype)
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(cfg, params, input_ids)
    x = inputs_embeds.to(dtype)
    b, s, _ = x.shape
    dev = x.device

    step = None
    if kv_cache is not None:
        step = _cache_step(kv_cache, b, s, cache_positions, seq_lengths, dev, paged_chunk)
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
    # remat: only where autograd records a training forward
    remat = cfg.remat and kv_cache is None and torch.is_grad_enabled()
    for l in range(cfg.num_layers):
        lp = {name: _layer_slice(w, l) for name, w in params["layers"].items()}
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _layer_forward, cfg, lp, x, rope, seq_lengths, slopes, None, None,
                prefix_lengths, use_reentrant=False,
            )
            continue
        layer_cache = None
        if kv_cache is not None:
            layer_cache = {n: kv_cache[n][l] for n in CACHE_TENSORS if n in kv_cache}
        x = _layer_forward(
            cfg, lp, x, rope, seq_lengths, slopes, layer_cache, step, prefix_lengths,
            prefill_from_empty,
        )
    new_cache = None
    if kv_cache is not None:
        new_cache = dict(kv_cache, index=kv_cache["index"] + s)

    x = _norm(cfg, x, params["final_norm_scale"], params.get("final_norm_bias"))
    if return_hidden:
        return x, new_cache
    return compute_logits(cfg, params, x, trainable_token_start), new_cache


def embed_tokens(cfg: ModelConfig, params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][input_ids.long()].to(torch_dtype(cfg.dtype))


class _LowPrecisionLogits(torch.autograd.Function):
    """[N, H] x [H, V] in bf16/fp16 with an fp32 result: one tensor-core
    GEMM that keeps its fp32 accumulator (`torch.mm(..., out_dtype=)`, which
    has no derivative of its own). The backward rounds the fp32 cotangent to
    the operands' dtype and runs two GEMMs there."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        return torch.mm(g, w.t()), torch.mm(h.t(), g)


def _logits_matmul(hidden: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """hidden [..., H] x w [H, V] -> fp32 logits [..., V] from operands in
    hidden's dtype, accumulated in fp32 and never rounded to that dtype
    (the JAX package's preferred_element_type=float32)."""
    if hidden.dtype == torch.float32 or hidden.device.type != "cuda":
        return torch.matmul(hidden.float(), w.float())
    h2 = hidden.reshape(-1, hidden.shape[-1])
    return _LowPrecisionLogits.apply(h2, w).reshape(*hidden.shape[:-1], w.shape[-1])


def compute_logits(
    cfg: ModelConfig,
    params: Params,
    hidden: torch.Tensor,
    trainable_token_start: Optional[int] = None,
) -> torch.Tensor:
    """LM head, tied to the embedding for MPT (reference: m2t/models/mpt.py:312;
    llark_tpu/models/decoder.py:785-830). The weights are rounded to the
    compute dtype and the product keeps its fp32 accumulator: fp32 logits.

    With tied embeddings the LM head IS the embedding table, so the
    adapter-stage freeze (`trainable_token_start`: only appended audio-token
    rows train) also detaches the head's rows below the start."""
    dtype = hidden.dtype
    if cfg.tie_embeddings:
        w = params["embed"]  # [V, H]
        if trainable_token_start is not None:
            w = torch.cat([w[:trainable_token_start].detach(), w[trainable_token_start:]])
        return _logits_matmul(hidden, w.to(dtype).t())
    w = params["lm_head"]  # [H, V]
    if isinstance(w, dict):
        # a quantized head never reaches a kernel (nor does it in the JAX
        # package): fp32 logits from an fp32 accumulator
        if "q4c" in w:  # int4 cols layout
            return quantized_dense_int4(hidden, w, None, dtype).float()
        if "q4" in w:  # int4 rows layout: dequantize in the compute dtype
            return _logits_matmul(hidden, dequantize_weight_int4(w, dtype))
        # int8: the scale goes onto the fp32 product
        return _logits_matmul(hidden, w["q"].to(dtype)) * w["scale"].reshape(-1).float()
    return _logits_matmul(hidden, w.to(dtype))
