"""Jukebox top-level prior transformer, only-encode mode; counterpart of
llark_tpu/encoders/jukebox/prior.py.

The subset the reference exercises (reference: jukebox/main.py:101-110
`get_final_activations`: `top_prior.prior.forward(x, x_cond=, y_cond=,
only_encode=True)`): the 5B "scalable transformer" of Dhariwal et al. 2020
§4 with factored attention, truncated to depth 36.

  * token embed -> shift right by 1 with y_cond as the start embedding
  * + learned pos_emb + per-position x_cond (timing conditioning)
  * depth pre-norm layers cycling attention patterns (attn_order=2):
      d % 3 == 0: row attention      — causal within each 64-token block
      d % 3 == 1: column attention   — causal over blocks at fixed offset
      d % 3 == 2: previous-row attn  — full attention onto the previous block
    attention inner width = width/4, quick-GELU MLP of width*1
  * + x_cond again after the layers (add_cond_after_transformer)

Dtype semantics follow the JAX module: the layer norm runs in fp32 and is
cast back; each projection takes operands in the compute dtype and rounds
its fp32-accumulated result to it (cuBLAS bf16 GEMMs do); attention scores
and the softmax are fp32 (bf16 q and k are widened exactly), and the
probabilities are cast to v's dtype for P V. Masked scores are -1e9, not
-inf. Parameters keep the JAX package's layout: layers stacked
[depth // 3, 3, ...], weights [in, out].
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.encoders.jukebox.config import JukeboxPriorConfig
from llark_tpu_torch.models.decoder import torch_dtype

Params = Dict[str, Any]

NEG = -1e9


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


# jax.nn.gelu is the tanh approximation by default
ACT = {"quick_gelu": quick_gelu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
       "relu": torch.relu}


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """fp32 layer norm over the last axis, cast back to x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), eps).to(x.dtype)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    n, s, d = x.shape
    return x.reshape(n, s, heads, d // heads).transpose(1, 2)  # [N, H, S, hd]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    n, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(n, s, h * hd)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q, k, v [..., S_q, D], [..., S_k, D]; mask broadcastable [S_q, S_k]."""
    w = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        w = w.masked_fill(~mask, NEG)
    p = torch.softmax(w, dim=-1).to(v.dtype)
    return torch.matmul(p, v).to(q.dtype)


def _causal(n: int, device: torch.device) -> torch.Tensor:
    return torch.ones(n, n, dtype=torch.bool, device=device).tril()


def row_attention(q, k, v, blocks: int) -> torch.Tensor:
    """Causal attention within each contiguous block."""
    n, h, s, d = q.shape
    qb, kb, vb = (t.reshape(n, h, blocks, s // blocks, d) for t in (q, k, v))
    return _sdpa(qb, kb, vb, _causal(s // blocks, q.device)).reshape(n, h, s, d)


def column_attention(q, k, v, blocks: int) -> torch.Tensor:
    """Causal attention across blocks at the same intra-block offset."""
    n, h, s, d = q.shape
    # [N, H, blocks, bc, D] -> [N, H, bc, blocks, D]
    qb, kb, vb = (t.reshape(n, h, blocks, s // blocks, d).transpose(2, 3) for t in (q, k, v))
    out = _sdpa(qb, kb, vb, _causal(blocks, q.device))
    return out.transpose(2, 3).reshape(n, h, s, d)


def prev_row_attention(q, k, v, blocks: int) -> torch.Tensor:
    """Each block attends (unmasked) to the whole previous block; block 0
    sees zero keys and values -> a uniform softmax over zero values ->
    zeros, matching the reference's padding behavior."""
    n, h, s, d = q.shape
    shape = (n, h, blocks, s // blocks, d)
    qb, kb, vb = (t.reshape(shape) for t in (q, k, v))
    zero = torch.zeros((n, h, 1) + shape[3:], dtype=k.dtype, device=k.device)
    kb = torch.cat([zero, kb[:, :, :-1]], dim=2)
    vb = torch.cat([zero, vb[:, :, :-1]], dim=2)
    return _sdpa(qb, kb, vb, None).reshape(n, h, s, d)


ATTN_FUNCS = (row_attention, column_attention, prev_row_attention)


def _dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h @ w in h's dtype (fp32 accumulation, rounded to it), + b."""
    return torch.matmul(h, w.to(h.dtype)) + b.to(h.dtype)


def _attn_layer(cfg: JukeboxPriorConfig, lp: Params, x: torch.Tensor,
                func_idx: int) -> torch.Tensor:
    h = layer_norm(x, lp["ln0_g"], lp["ln0_b"], cfg.eps)
    q, k, v = _dense(h, lp["attn_w"], lp["attn_b"]).split(cfg.attn_width, dim=-1)
    a = ATTN_FUNCS[func_idx](*(_split_heads(t, cfg.heads) for t in (q, k, v)), cfg.blocks)
    x = x + _dense(_merge_heads(a), lp["proj_w"], lp["proj_b"])
    h = layer_norm(x, lp["ln1_g"], lp["ln1_b"], cfg.eps)
    m = ACT[cfg.afn](_dense(h, lp["fc_w"], lp["fc_b"]).float()).to(x.dtype)
    return x + _dense(m, lp["mlp_proj_w"], lp["mlp_proj_b"])


def _layer_param_shapes(cfg: JukeboxPriorConfig):
    w, aw, mw = cfg.width, cfg.attn_width, cfg.mlp_width
    return {
        "ln0_g": (w,), "ln0_b": (w,),
        "attn_w": (w, 3 * aw), "attn_b": (3 * aw,),
        "proj_w": (aw, w), "proj_b": (w,),
        "ln1_g": (w,), "ln1_b": (w,),
        "fc_w": (w, mw), "fc_b": (mw,),
        "mlp_proj_w": (mw, w), "mlp_proj_b": (w,),
    }


def init_prior_params(cfg: JukeboxPriorConfig, seed: int = 0,
                      device: Union[str, torch.device] = "cuda") -> Params:
    """Random prior parameters in the JAX package's layout and scales
    (weights normal / sqrt(fan_in), layer-norm gains one and biases zero,
    x_emb normal x 0.02, pos_emb normal x 0.01), in cfg.dtype, drawn on
    `device` from a torch.Generator seeded by `seed`: at full width that is
    2.5 B values, drawn where they are used rather than on the host. The
    card and the CPU draw different values from one seed."""
    if cfg.depth % 3:
        raise ValueError(f"depth {cfg.depth} is not a multiple of the attention cycle (3)")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(shape, scale):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype).mul_(scale)

    layers = {}
    for name, shape in _layer_param_shapes(cfg).items():
        full = (cfg.depth // 3, 3) + shape
        if name.endswith("_g"):
            layers[name] = torch.ones(full, dtype=dtype, device=dev)
        elif name.endswith("_b"):
            layers[name] = torch.zeros(full, dtype=dtype, device=dev)
        else:
            layers[name] = randn(full, 1.0 / math.sqrt(shape[0]))
    return {
        "x_emb": randn((cfg.bins, cfg.width), 0.02),
        "pos_emb": randn((cfg.n_ctx, cfg.width), 0.01),
        "layers": layers,
    }


def prior_encode(
    cfg: JukeboxPriorConfig,
    params: Params,
    codes: torch.Tensor,  # [N, n_ctx] integer
    x_cond: Optional[torch.Tensor] = None,  # [1|N, n_ctx, width]
    y_cond: Optional[torch.Tensor] = None,  # [1|N, 1, width]
) -> torch.Tensor:
    """Layer-`depth` activations [N, n_ctx, width], fp32, computed in
    cfg.dtype on the device that holds `codes` and `params`."""
    dtype = torch_dtype(cfg.dtype)
    n, s = codes.shape
    if s != cfg.n_ctx:
        raise ValueError(f"expected {cfg.n_ctx} codes, got {s}")
    dev = codes.device
    if x_cond is None:
        x_cond = torch.zeros((1, s, cfg.width), dtype=dtype, device=dev)
    if y_cond is None:
        y_cond = torch.zeros((1, 1, cfg.width), dtype=dtype, device=dev)
    x_cond = x_cond.to(dtype)

    x = params["x_emb"][codes.long()].to(dtype)  # [N, S, W]
    # shift right; position 0 gets the conditioning start embedding
    start = y_cond.to(dtype).expand(n, 1, cfg.width)
    x = torch.cat([start, x[:, :-1]], dim=1)
    x = x + params["pos_emb"].to(dtype)[None] + x_cond

    layers = params["layers"]
    for c in range(layers["ln0_g"].shape[0]):
        for i in range(3):
            x = _attn_layer(cfg, {name: t[c, i] for name, t in layers.items()}, x, i)
    if cfg.add_cond_after_transformer:
        x = x + x_cond
    return x.float()
