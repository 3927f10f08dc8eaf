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
activations are recomputed in the backward: all of them under the "full"
policy, all but the outputs of the non-batched products under "dots" and
"dots_narrow" (`_remat_context`).

Weight-only quantized trees (`models/quant.py`: int8, int4 in the rows or
cols layout) serve through the same forward: a quantized leaf is a dict
whose tensors are stacked [L, ...] like any other, `_dense` routes it to
`quantized_dense` / `quantized_dense_int4`, and the LM head keeps its fp32
accumulator. The rows-layout and int8 products carry dx (QLoRA training).

LoRA factors (`models/lora.py`) ride in the layer tree as stacked
`{name}_lora_a` [L, in, r] / `{name}_lora_b` [L, r, out] beside a float or
quantized base weight; `_lora_dense` adds their delta to every projection.
LoRA dropout draws its masks from `DropoutDraws`: per layer, one
generator for the forward and one for remat's recompute, both seeded on
the host from (dropout seed, layer) before the forward; a layer's targets
draw in turn from its pass's generator. So the recompute draws the masks
the forward drew without reading or setting a generator's state inside the
step, and a CUDA graph that registers the generators replays fresh masks
for every new seed.

With `cfg.moe_num_experts` > 0 the MLP is a Mixture-of-Experts
(`models/moe.py`): the layer tree holds `moe_router` [L, h, E] and the
expert stacks `moe_w_{gate,up,down}` [L, E, in, out] in place of the dense
MLP's weights and biases. A forward without a KV cache returns, in place of
the cache, {"moe_aux_loss": the layers' load-balancing losses summed,
"moe_dropped_frac": their dropped fractions meaned}, which the train step
reads (llark_tpu/models/decoder.py:757-768).

A sharded config (`parallel/mesh.py` `local_config`: this rank's widths, its
mesh and specs in `cfg.shard`) runs the same code on the rank's shards:
each layer's weights are all-gathered over "fsdp" before use, the
column-parallel inputs carry the "tensor" axis's gradient sum, wo and
w_down's partial products are summed over "tensor" in fp32 (their biases
added after), the ALiBi slopes are the rank's heads' and the untied head's
logits are gathered. The kernels see the local shapes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.models.lora import lora_scale
from llark_tpu_torch.models.moe import init_moe_layer_params, moe_ffn
from llark_tpu_torch.models.quant import (
    dequantize_weight_int4,
    quantized_dense,
    quantized_dense_int4,
)
from llark_tpu_torch.ops.attention import alibi_slopes, multihead_attention, xla_attention
from llark_tpu_torch.ops.decode_attention import _dense_view, decode_attention
from llark_tpu_torch.ops.int8_matmul import matmul_f32
from llark_tpu_torch.parallel import comm

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
    differ, since the two frameworks' generators do. A MoE config gets the
    router and expert stacks in place of the dense MLP and its biases
    (llark_tpu/models/decoder.py:132-149)."""
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
    }
    moe = cfg.moe_num_experts > 0
    if moe:
        layers.update(init_moe_layer_params(cfg, dense))
    else:
        layers["w_up"] = dense((L, h, i), h)
        layers["w_down"] = dense((L, i, h), i)
        if cfg.mlp_activation == "silu":
            layers["w_gate"] = dense((L, h, i), h)
    if cfg.norm_type == "layernorm":
        layers["attn_norm_bias"] = const((L, h), 0.0)
        layers["mlp_norm_bias"] = const((L, h), 0.0)
    if cfg.use_bias:
        widths = [("bq", nh * hd), ("bk", nkv * hd), ("bv", nkv * hd), ("bo", h)]
        if not moe:
            widths += [("b_up", i), ("b_down", h)]
            if cfg.mlp_activation == "silu":
                widths.append(("b_gate", i))
        for name, width in widths:
            layers[name] = const((L, width), 0.0)

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


_U64 = (1 << 64) - 1


def fold_seed(seed: int, *data: int) -> int:
    """A new 63-bit seed from `seed` and each integer of `data` in turn
    (splitmix64's finaliser): the port's counterpart of folding a JAX key.
    The streams it seeds are not JAX's."""
    for d in data:
        z = (seed + 0x9E3779B97F4A7C15 * (int(d) + 1)) & _U64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
        seed = z ^ (z >> 31)
    return seed >> 1


class DropoutDraws:
    """The generators LoRA dropout draws from in one forward: for each
    layer a pair, the first for the forward and the second for remat's
    recompute of the layer, both seeded by `seed(s)` with fold_seed(s,
    layer). A layer's targets draw from its pass's generator in their fixed
    order (wq, wk, wv, wo, then the MLP's), so each mask is a function of
    (seed, layer, target) and the recompute draws the masks of the forward.

    Seeding is a host operation: a train step seeds its micro-batches'
    draws before it runs, and a captured step registers every generator
    with its graph (`generators`), so a replay draws from the seeds set
    before it."""

    def __init__(self, num_layers: int, device: Union[str, torch.device]):
        self.pairs = [(torch.Generator(device=device), torch.Generator(device=device))
                      for _ in range(num_layers)]

    def seed(self, seed: int) -> "DropoutDraws":
        for layer, pair in enumerate(self.pairs):
            s = fold_seed(seed, layer)
            for gen in pair:
                gen.manual_seed(s)
        return self

    @property
    def generators(self):
        return [gen for pair in self.pairs for gen in pair]


class _LayerDraws:
    """One layer's pair in one forward: its first entry (the forward) draws
    from the first generator, a second (the recompute) from the second."""

    def __init__(self, pair):
        self.pair, self.entries = pair, 0

    def enter(self) -> torch.Generator:
        if self.entries == len(self.pair):
            raise RuntimeError(
                "a layer's LoRA-dropout masks are drawn in its forward and once more in remat's "
                "recompute; a third run of the layer would draw others"
            )
        self.entries += 1
        return self.pair[self.entries - 1]


def _dropout(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """x with each element kept with probability 1 - rate (scaled by its
    inverse), else zero; the mask drawn from `gen`."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


# tensor parallelism: the row-parallel products, whose outputs are partial
# sums over the "tensor" axis (the others are column-parallel)
ROW_PARALLEL = ("wo", "w_down")


def _lora_dense(cfg: ModelConfig, lp: Params, name: str, x, dtype,
                dropout: Optional[torch.Generator], tp=None):
    """Base dense + optional low-rank delta: y = xW + scale * ((drop(x) A) B)
    (llark_tpu/models/decoder.py:270-294); each product keeps an fp32
    accumulator and is rounded to `dtype`. Without `{name}_lora_a` in the
    layer tree it is `_dense`. `dropout` (this layer pass's generator; None
    in evaluation and serving) draws the dropout mask of this target.

    `tp`, the "tensor" group of a sharded config with more than one rank:
    a row-parallel target's partial products (and its LoRA x A) are summed
    over it in fp32 and rounded once, its bias added after the sum; a
    column-parallel target's A, whole on every rank, gets its gradient
    summed over it."""
    row = tp is not None and name in ROW_PARALLEL
    bias = lp.get("b" + name[1:])  # wq->bq, w_up->b_up
    w = lp[name]
    if row and not isinstance(w, dict):
        y = comm.reduce_sum(matmul_f32(x, w.to(dtype)), tp).to(dtype)
    elif row:
        y = comm.reduce_sum(_dense(x, w, None, dtype), tp)
    else:
        y = _dense(x, w, bias, dtype)
    if row and bias is not None:
        y = y + bias.to(dtype)
    a = lp.get(f"{name}_lora_a")
    if a is None:
        return y
    xl = x
    if dropout is not None and cfg.lora_dropout > 0.0:
        xl = _dropout(x, cfg.lora_dropout, dropout)
    if tp is not None and not row:
        a = comm.copy_to(a, tp)
    z = torch.matmul(xl, a.to(dtype))
    if row:
        z = comm.reduce_sum(z, tp)
    delta = torch.matmul(z, lp[f"{name}_lora_b"].to(dtype))
    return y + lora_scale(cfg) * delta


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
    dropout: Optional[_LayerDraws] = None,  # this layer's LoRA-dropout draws
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One decoder layer: (x out, the MoE metrics of `moe_ffn` or None).
    With a sharded config (`parallel/mesh.py` `local_config`) the widths
    are this rank's, the layer's weights are gathered over "fsdp" first
    and the column-parallel inputs carry the tensor axis's gradient sum."""
    dtype = x.dtype
    b, s, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shard = getattr(cfg, "shard", None)
    tp = None
    if shard is not None:
        lp = shard.gather_layer(lp)
        tp = shard.group("tensor") if shard.tensor > 1 else None
    gen = dropout.enter() if dropout is not None else None

    def dense(name, z):
        return _lora_dense(cfg, lp, name, z, dtype, gen, tp)

    y = _norm(cfg, x, lp["attn_norm_scale"], lp.get("attn_norm_bias"))
    y = comm.copy_to(y, tp)
    q = dense("wq", y).reshape(b, s, nh, hd).transpose(1, 2)
    k = dense("wk", y).reshape(b, s, nkv, hd).transpose(1, 2)
    v = dense("wv", y).reshape(b, s, nkv, hd).transpose(1, 2)

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
    x = x + dense("wo", attn)

    y = _norm(cfg, x, lp["mlp_norm_scale"], lp.get("mlp_norm_bias"))
    if cfg.moe_num_experts > 0:  # moe_ffn does its own tensor/expert sums
        out, metrics = moe_ffn(cfg, lp, y)
        return x + out, metrics
    if cfg.mlp_activation == "silu":
        y = comm.copy_to(y, tp)
        gate = dense("w_gate", y)
        up = dense("w_up", y)
        z = F.silu(gate.float()).to(dtype) * up
    else:
        y = comm.copy_to(y, tp)
        z = F.gelu(dense("w_up", y).float(), approximate="tanh").to(dtype)
    return x + dense("w_down", z), None


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


_QUANTIZED_PRODUCTS = (torch.ops.llark.int8_matmul.default, torch.ops.llark.int4_matmul.default)


def _product_width(op, args) -> Optional[int]:
    """Output features of a non-batched product the remat policies keep
    (dot_general without batch dims in the JAX package): a 2-D GEMM, or one
    of the quantized products' operators (x, weight [K or K/2, N], scale);
    None for anything else, the batched attention products among them."""
    if op is torch.ops.aten.mm.default or op in _QUANTIZED_PRODUCTS:
        return args[1].shape[-1]
    if op is torch.ops.aten.addmm.default:
        return args[2].shape[-1]
    return None


def _remat_context(cfg: ModelConfig):
    """`context_fn` of a layer's checkpoint under the "dots" policies
    (llark_tpu/models/decoder.py:661-688), None under "full": selective
    activation checkpointing saves the outputs of the non-batched products
    -- under "dots_narrow" only those narrower than 3 x hidden_size, so the
    wide MLP up-projections are recomputed -- and recomputes everything
    else, the flash forward too (a kernel launch, not a product)."""
    if cfg.remat_policy == "full":
        return None
    wide = 3 * cfg.hidden_size if cfg.remat_policy == "dots_narrow" else None
    save, recompute = (torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE,
                       torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)

    def policy(ctx, op, *args, **kwargs):
        n = _product_width(op, args)
        return save if n is not None and (wide is None or n < wide) else recompute

    return functools.partial(torch.utils.checkpoint.create_selective_checkpoint_contexts, policy)


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
    dropout_seed: Union[int, DropoutDraws, None] = None,  # LoRA dropout on
    # (training): the micro-batch's seed, or its draws seeded by the caller
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Run the decoder (llark_tpu/models/decoder.py:579-778). Returns
    (logits_or_hidden, kv_cache | MoE metrics | None); logits are fp32.

    Without a cache: pass input_ids/inputs_embeds + seq_lengths (right-
    padded mask). Prefill/decode: also pass kv_cache (dense, int8 or
    paged), which is written in place; positions default to
    cache_index + arange(S), or to cache_positions + arange(S) for ragged
    decode and paged writes. The returned cache shares the given tensors
    (block tables and scales included) with "index" advanced by S. Without
    a cache a MoE config returns its metrics in the cache's place (the
    module docstring).
    """
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
    slopes = _alibi(cfg, dev) if cfg.use_alibi else None
    # remat: only where autograd records a training forward
    remat = cfg.remat and kv_cache is None and torch.is_grad_enabled()
    context_fn = _remat_context(cfg) if remat else None
    remat_kw = {} if context_fn is None else {"context_fn": context_fn}
    draws = None
    if dropout_seed is not None and cfg.lora_dropout > 0.0:
        draws = dropout_seed
        if not isinstance(draws, DropoutDraws):
            draws = DropoutDraws(cfg.num_layers, dev).seed(dropout_seed)
    aux, dropped = [], []
    for l in range(cfg.num_layers):
        lp = {name: _layer_slice(w, l) for name, w in params["layers"].items()}
        layer_draws = _LayerDraws(draws.pairs[l]) if draws is not None else None
        if remat:
            x, metrics = torch.utils.checkpoint.checkpoint(
                _layer_forward, cfg, lp, x, rope, seq_lengths, slopes, None, None,
                prefix_lengths, False, layer_draws, use_reentrant=False, **remat_kw,
            )
        else:
            layer_cache = None
            if kv_cache is not None:
                layer_cache = {n: kv_cache[n][l] for n in CACHE_TENSORS if n in kv_cache}
            x, metrics = _layer_forward(
                cfg, lp, x, rope, seq_lengths, slopes, layer_cache, step, prefix_lengths,
                prefill_from_empty, layer_draws,
            )
        if metrics is not None:
            aux.append(metrics["aux_loss"])
            dropped.append(metrics["dropped_frac"])
    new_cache = None
    if kv_cache is not None:
        new_cache = dict(kv_cache, index=kv_cache["index"] + s)
    elif aux:
        # the train step adds moe_aux_loss_weight x the loss and logs both
        new_cache = {"moe_aux_loss": torch.stack(aux).sum(),
                     "moe_dropped_frac": torch.stack(dropped).mean()}

    x = _norm(cfg, x, params["final_norm_scale"], params.get("final_norm_bias"))
    if return_hidden:
        return x, new_cache
    return compute_logits(cfg, params, x, trainable_token_start), new_cache


def _alibi(cfg: ModelConfig, device) -> torch.Tensor:
    """ALiBi slopes of this rank's heads: the slopes of all heads, sliced
    to the rank's block under tensor parallelism."""
    shard = getattr(cfg, "shard", None)
    if shard is None or shard.tensor == 1:
        return alibi_slopes(cfg.num_heads, device=device)
    r = shard.rank("tensor")
    full = alibi_slopes(cfg.num_heads * shard.tensor, device=device)
    return full[r * cfg.num_heads:(r + 1) * cfg.num_heads]


def _top(cfg: ModelConfig, params: Params, name: str):
    """A top-level weight, whole over "fsdp" on a sharded config."""
    shard = getattr(cfg, "shard", None)
    return params[name] if shard is None else shard.gather_top(name, params[name])


def embed_tokens(cfg: ModelConfig, params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return _top(cfg, params, "embed")[input_ids.long()].to(torch_dtype(cfg.dtype))


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
        w = _top(cfg, params, "embed")  # [V, H]
        if trainable_token_start is not None:
            w = torch.cat([w[:trainable_token_start].detach(), w[trainable_token_start:]])
        return matmul_f32(hidden, w.to(dtype).t())
    shard = getattr(cfg, "shard", None)
    if shard is not None and shard.tensor > 1:
        # column-parallel head: this rank's vocab/t columns, gathered
        tp = shard.group("tensor")
        local = _head_logits(dtype, comm.copy_to(hidden, tp), _top(cfg, params, "lm_head"))
        return comm.gather(local, local.dim() - 1, tp, backward="split")
    return _head_logits(dtype, hidden, _top(cfg, params, "lm_head"))


def _head_logits(dtype: torch.dtype, hidden: torch.Tensor, w) -> torch.Tensor:
    """hidden @ the untied LM head [H, V] (float or quantized) -> fp32."""
    if isinstance(w, dict):
        # a quantized head never reaches a kernel (nor does it in the JAX
        # package): fp32 logits from an fp32 accumulator
        if "q4c" in w:  # int4 cols layout
            return quantized_dense_int4(hidden, w, None, dtype).float()
        if "q4" in w:  # int4 rows layout: dequantize in the compute dtype
            return matmul_f32(hidden, dequantize_weight_int4(w, dtype))
        # int8: the scale goes onto the fp32 product
        return matmul_f32(hidden, w["q"].to(dtype)) * w["scale"].reshape(-1).float()
    return matmul_f32(hidden, w.to(dtype))
