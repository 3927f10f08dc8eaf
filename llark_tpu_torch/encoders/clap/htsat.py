"""HTSAT audio transformer (Swin-style) for the CLAP embedding variant;
counterpart of llark_tpu/encoders/clap/htsat.py.

Shape pipeline (HTS-AT, Chen et al. 2022, and laion_clap's conventions):
  log-mel [B, T=1024, F=64]
    -> wav2img: time split into freq_ratio=4 chunks stacked along
       frequency -> [B, 1, 256, 256]
    -> 4x4 patch embedding (C = embed_dim) -> tokens on a 64x64 grid
    -> Swin stages (depths / heads per config): window attention with a
       relative-position bias, shifted windows on odd blocks, patch
       merging between stages
    -> final norm, mean pool -> [B, 8 * embed_dim]
    -> projection MLP (relu between its layers) -> [B, 512]

Plain functions over a parameter dict of tensors, in fp32 as the JAX
package computes it. Its numerics, kept on purpose: GELU is the tanh
approximation (`jax.nn.gelu`'s default; HF's ClapAudio uses the exact
one), masked window logits are -1e9, and the patch embedding, a
convolution with stride = kernel = patch, is written as patches times a
matrix, so no cuDNN convolution (TF32 by default on the card) runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from llark_tpu_torch.device import resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass
class HTSATConfig:
    spec_size: int = 256
    freq_ratio: int = 4
    patch_size: int = 4
    embed_dim: int = 128  # HTSAT-base; tiny=96
    depths: Tuple[int, ...] = (2, 2, 12, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    out_dim: int = 512  # CLAP joint space
    n_mels: int = 64
    n_frames: int = 1024
    eps: float = 1e-5
    dtype: str = "float32"

    @classmethod
    def base(cls) -> "HTSATConfig":
        return cls()

    @classmethod
    def tiny(cls, **kw) -> "HTSATConfig":
        base = dict(
            spec_size=64, freq_ratio=4, embed_dim=16, depths=(1, 1),
            num_heads=(2, 4), window_size=4, n_mels=16, n_frames=256,
        )
        base.update(kw)
        return cls(**base)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), eps)
    return y.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.matmul(x, w)
    return y if b is None else y + b


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, w*w, C]"""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def window_reverse(x: torch.Tensor, w: int, h: int, ww: int) -> torch.Tensor:
    b = x.shape[0] // ((h // w) * (ww // w))
    x = x.reshape(b, h // w, ww // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, -1)


def relative_position_index(w: int) -> np.ndarray:
    """Standard Swin relative position index [w*w, w*w]."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))  # [2,w,w]
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [2, ww, ww]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int32)


def shifted_window_mask(h: int, ww: int, w: int, shift: int) -> np.ndarray:
    """Attention mask [nW, w*w, w*w] (True = allowed) for shifted windows."""
    img = np.zeros((h, ww), np.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // w, w, ww // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    return win[:, :, None] == win[:, None, :]


def window_attention(
    x: torch.Tensor,  # [nWb, w*w, C]
    p: Params,
    heads: int,
    w: int,
    mask: Optional[Union[np.ndarray, torch.Tensor]],  # [nW, w*w, w*w] or None
) -> torch.Tensor:
    nwb, n, c = x.shape
    qkv = dense(x, p["qkv_w"], p["qkv_b"]).reshape(nwb, n, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # [nWb, H, n, hd] each
    scale = 1.0 / math.sqrt(c // heads)
    attn = torch.matmul(q, k.transpose(-1, -2)) * scale
    rel_idx = torch.as_tensor(relative_position_index(w).reshape(-1), dtype=torch.long,
                              device=x.device)
    bias = p["rel_bias"][rel_idx].reshape(n, n, heads)
    attn = attn + bias.permute(2, 0, 1)[None].float()
    if mask is not None:
        allowed = torch.as_tensor(mask, dtype=torch.bool, device=x.device)
        nw = allowed.shape[0]
        attn = attn.reshape(nwb // nw, nw, heads, n, n)
        attn = attn.masked_fill(~allowed[None, :, None], -1e9)
        attn = attn.reshape(nwb, heads, n, n)
    probs = torch.softmax(attn, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v)
    out = out.to(x.dtype).transpose(1, 2).reshape(nwb, n, c)
    return dense(out, p["proj_w"], p["proj_b"])


def swin_block(
    x: torch.Tensor,  # [B, H*W, C]
    p: Params,
    res: Tuple[int, int],
    heads: int,
    window: int,
    shift: int,
    mlp_ratio: float,
    eps: float,
) -> torch.Tensor:
    h, ww = res
    b, l, c = x.shape
    shortcut = x
    y = layer_norm(x, p["n1_g"], p["n1_b"], eps).reshape(b, h, ww, c)
    if shift > 0:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        mask = shifted_window_mask(h, ww, window, shift)
    else:
        mask = None
    wins = window_partition(y, window)
    wins = window_attention(wins, p, heads, window, mask)
    y = window_reverse(wins, window, h, ww)
    if shift > 0:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    x = shortcut + y.reshape(b, l, c)
    z = layer_norm(x, p["n2_g"], p["n2_b"], eps)
    z = dense(z, p["fc1_w"], p["fc1_b"])
    z = F.gelu(z.float(), approximate="tanh").to(x.dtype)
    z = dense(z, p["fc2_w"], p["fc2_b"])
    return x + z


def patch_merge(x: torch.Tensor, p: Params, res: Tuple[int, int], eps: float) -> torch.Tensor:
    h, ww = res
    b, l, c = x.shape
    y = x.reshape(b, h, ww, c)
    parts = [y[:, 0::2, 0::2], y[:, 1::2, 0::2], y[:, 0::2, 1::2], y[:, 1::2, 1::2]]
    y = torch.cat(parts, dim=-1).reshape(b, (h // 2) * (ww // 2), 4 * c)
    y = layer_norm(y, p["norm_g"], p["norm_b"], eps)
    return dense(y, p["red_w"])


# ---------------------------------------------------------------------------
# init + forward
# ---------------------------------------------------------------------------


def init_htsat_params(cfg: HTSATConfig, seed: int = 0,
                      device: Union[str, torch.device] = "cuda") -> Params:
    """Random HTSAT parameters in the JAX package's layout and scales
    (weights normal / sqrt(fan_in), biases and relative-position tables
    zero, norms one), drawn from a CPU torch.Generator seeded by `seed` and
    then moved to `device`: the card and the CPU get the same weights."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def w_(shape, fan_in=None):
        fan_in = fan_in or shape[0]
        return (torch.randn(shape, generator=gen) / math.sqrt(fan_in)).to(dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    def ones(*shape):
        return torch.ones(shape, device=dev)

    c = cfg.embed_dim
    hidden = lambda d: int(d * cfg.mlp_ratio)  # noqa: E731
    params: Params = {
        "patch_embed": {
            "w": w_((c, 1, cfg.patch_size, cfg.patch_size), cfg.patch_size**2),
            "b": zeros(c), "norm_g": ones(c), "norm_b": zeros(c),
        },
        "stages": [],
    }
    dim = c
    for si, depth in enumerate(cfg.depths):
        heads = cfg.num_heads[si]
        blocks = [
            {
                "n1_g": ones(dim), "n1_b": zeros(dim),
                "qkv_w": w_((dim, 3 * dim)), "qkv_b": zeros(3 * dim),
                "proj_w": w_((dim, dim)), "proj_b": zeros(dim),
                "rel_bias": zeros((2 * cfg.window_size - 1) ** 2, heads),
                "n2_g": ones(dim), "n2_b": zeros(dim),
                "fc1_w": w_((dim, hidden(dim))), "fc1_b": zeros(hidden(dim)),
                "fc2_w": w_((hidden(dim), dim)), "fc2_b": zeros(dim),
            }
            for _ in range(depth)
        ]
        stage: Params = {"blocks": blocks, "downsample": None}
        if si < len(cfg.depths) - 1:
            stage["downsample"] = {
                "norm_g": ones(4 * dim), "norm_b": zeros(4 * dim),
                "red_w": w_((4 * dim, 2 * dim)),
            }
            dim *= 2
        params["stages"].append(stage)
    params["final_norm"] = {"g": ones(dim), "b": zeros(dim)}
    params["proj"] = {
        "w1": w_((dim, cfg.out_dim)), "b1": zeros(cfg.out_dim),
        "w2": w_((cfg.out_dim, cfg.out_dim)), "b2": zeros(cfg.out_dim),
    }
    return params


def wav2img(mel: torch.Tensor, cfg: HTSATConfig) -> torch.Tensor:
    """[B, T, F] -> [B, 1, spec, spec]: time split into freq_ratio chunks
    stacked along frequency (laion_clap htsat reshape_wav2img)."""
    b, t, f = mel.shape
    r = cfg.freq_ratio
    if f * r != cfg.spec_size:
        raise ValueError(f"mel bins {f} * freq_ratio {r} != spec {cfg.spec_size}")
    t_target = cfg.spec_size * r
    if t < t_target:
        mel = F.pad(mel, (0, 0, 0, t_target - t))
    mel = mel[:, :t_target]
    x = mel.transpose(1, 2)  # [B, F, T]
    x = x.reshape(b, f, r, t_target // r)  # [B, F, r, T/r]
    x = x.transpose(1, 2)  # [B, r, F, T/r]
    x = x.reshape(b, r * f, t_target // r)  # [B, r*F=spec, T/r=spec]
    return x[:, None]  # [B, 1, spec, spec]


def patch_embed(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                patch: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """The VALID convolution of x [B, Cin, H, W] with w [C, Cin, p, p] at
    stride p (NCHW / OIHW), as tokens [B, (H/p)*(W/p), C] in row-major
    order, and the token grid (H/p, W/p): each patch flattened (cin, kh,
    kw), times w flattened alike."""
    bsz, cin, h, ww = x.shape
    hp, wp = h // patch, ww // patch
    x = x[:, :, : hp * patch, : wp * patch]
    cols = x.reshape(bsz, cin, hp, patch, wp, patch).permute(0, 2, 4, 1, 3, 5)
    cols = cols.reshape(bsz, hp * wp, cin * patch * patch)
    return torch.matmul(cols, w.reshape(w.shape[0], -1).T) + b, (hp, wp)


def htsat_embed(cfg: HTSATConfig, params: Params, mel: torch.Tensor) -> torch.Tensor:
    """log-mel [B, T, F] -> CLAP audio embedding [B, out_dim] (not normalised)."""
    bn = params.get("mel_bn")
    if bn is not None:
        # per-mel-bin BatchNorm in eval mode = affine with running stats
        # (HF ClapAudioEncoder.batch_norm)
        inv = torch.rsqrt(bn["var"].float() + 1e-5)
        mel = ((mel.float() - bn["mean"]) * inv * bn["g"] + bn["b"]).to(mel.dtype)
    x = wav2img(mel, cfg)  # [B,1,S,S]
    pe = params["patch_embed"]
    x, res = patch_embed(x, pe["w"], pe["b"], cfg.patch_size)
    x = layer_norm(x, pe["norm_g"], pe["norm_b"], cfg.eps)

    for si, stage in enumerate(params["stages"]):
        heads = cfg.num_heads[si]
        window = min(cfg.window_size, res[0])
        for bi, bp in enumerate(stage["blocks"]):
            shift = 0 if bi % 2 == 0 else window // 2
            if window >= res[0]:
                shift = 0
            x = swin_block(x, bp, res, heads, window, shift, cfg.mlp_ratio, cfg.eps)
        if stage["downsample"] is not None:
            x = patch_merge(x, stage["downsample"], res, cfg.eps)
            res = (res[0] // 2, res[1] // 2)

    x = layer_norm(x, params["final_norm"]["g"], params["final_norm"]["b"], cfg.eps)
    pooled = x.mean(dim=1)  # [B, C_final]
    p = params["proj"]
    y = dense(pooled, p["w1"], p["b1"])
    y = torch.relu(y)
    return dense(y, p["w2"], p["b2"])
