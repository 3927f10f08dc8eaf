"""Jukebox VQ-VAE encode path (audio -> top-level discrete codes);
counterpart of llark_tpu/encoders/jukebox/vqvae.py.

The encode-only subset the reference uses (reference: jukebox/main.py:54-68
`get_z`: vqvae.encode, top-level codes). Per level l (openai/jukebox
encdec.py semantics):
  EncoderConvBlock: downs_t[l] stages of
      [Conv1d(stride s, kernel 2s, pad s // 2) -> Resnet1D(depth, dilation 3^d)]
  then Conv1d(width -> emb_width, kernel 3, pad 1).
  Level l consumes the raw audio through blocks 0..l cumulatively.
Bottleneck: nearest-neighbour codebook lookup (L2), codebook [bins, emb].

Weights keep torch's Conv1d layout, [C_out, C_in, K], so `F.conv1d` takes
them as they are. One flipped code moves a whole prior token, so every
convolution and the codebook product run in full fp32 (`full_fp32`):
cuDNN would otherwise run them in TF32, its default.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Union

import torch
import torch.nn.functional as F

from llark_tpu_torch.device import full_fp32, resolve_device
from llark_tpu_torch.encoders.jukebox.config import JukeboxVQVAEConfig

Params = Dict[str, Any]


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, padding: int,
           dilation: int = 1) -> torch.Tensor:
    """x [N, C_in, T], w [C_out, C_in, K], b [C_out]; padding (p, p)."""
    return F.conv1d(x, w, b, stride=stride, padding=padding, dilation=dilation)


def res_conv_block(x: torch.Tensor, p: Params, dilation: int) -> torch.Tensor:
    """ReLU -> Conv(k3, dilated) -> ReLU -> Conv(k1) + residual."""
    h = conv1d(torch.relu(x), p["w1"], p["b1"], stride=1, padding=dilation, dilation=dilation)
    h = conv1d(torch.relu(h), p["w2"], p["b2"], stride=1, padding=0)
    return x + h


def resnet1d(x: torch.Tensor, blocks: List[Params], growth: int) -> torch.Tensor:
    for d, p in enumerate(blocks):
        x = res_conv_block(x, p, dilation=growth**d)
    return x


def encoder_conv_block(x: torch.Tensor, p: Params, cfg: JukeboxVQVAEConfig,
                       level: int) -> torch.Tensor:
    stride = cfg.strides_t[level]
    for stage in p["stages"]:
        x = conv1d(x, stage["down_w"], stage["down_b"], stride=stride, padding=stride // 2)
        x = resnet1d(x, stage["res"], cfg.dilation_growth_rate)
    return conv1d(x, p["proj_w"], p["proj_b"], stride=1, padding=1)


def init_vqvae_params(cfg: JukeboxVQVAEConfig, seed: int = 0,
                      device: Union[str, torch.device] = "cuda") -> Params:
    """Random VQ-VAE parameters in the JAX package's layout and scales
    (weights normal / sqrt(fan_in), biases zero, codebooks standard
    normal), drawn from a CPU torch.Generator seeded by `seed` and moved
    to `device`: the card and the CPU get the same weights. The tree
    models the TOP encoder's chain, the only one the embedding path
    consumes, so width and depth take the top multiplier."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def w(shape):
        return (torch.randn(shape, generator=gen) / math.sqrt(shape[1] * shape[2])).to(dev)

    def zeros(n):
        return torch.zeros(n, device=dev)

    width, depth, inner = cfg.top_width, cfg.top_depth, int(cfg.m_conv * cfg.top_width)
    levels = []
    for level in range(cfg.levels):
        in_ch = 1 if level == 0 else cfg.emb_width
        stride = cfg.strides_t[level]
        stages = [
            {
                "down_w": w((width, in_ch if stage == 0 else width, stride * 2)),
                "down_b": zeros(width),
                "res": [{"w1": w((inner, width, 3)), "b1": zeros(inner),
                         "w2": w((width, inner, 1)), "b2": zeros(width)}
                        for _ in range(depth)],
            }
            for stage in range(cfg.downs_t[level])
        ]
        levels.append({"stages": stages, "proj_w": w((cfg.emb_width, width, 3)),
                       "proj_b": zeros(cfg.emb_width)})
    codebooks = [torch.randn((cfg.l_bins, cfg.emb_width), generator=gen).to(dev)
                 for _ in range(cfg.levels)]
    return {"levels": levels, "codebooks": codebooks}


def quantize(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """x [N, emb, T] -> nearest codebook indices [N, T] (int32).

    dist(t, j) = |x_t|^2 - 2 x_t.k_j + |k_j|^2; the x term is constant per
    t and dropped. One fp32 product + argmin (the first index on a tie, as
    jnp.argmin).
    """
    scores = torch.matmul(x.transpose(1, 2), codebook.t())  # [N, T, bins]
    k_sq = 0.5 * codebook.float().square().sum(-1)  # [bins]
    return torch.argmin(k_sq - scores, dim=-1).to(torch.int32)


def encode_level(cfg: JukeboxVQVAEConfig, params: Params, audio: torch.Tensor,
                 level: int) -> torch.Tensor:
    """audio [N, T_samples] fp32 (mono, peak-normalized) -> codes [N, T/hop]."""
    with full_fp32():
        x = audio[:, None, :]  # NCW
        for l in range(level + 1):
            x = encoder_conv_block(x, params["levels"][l], cfg, l)
        return quantize(x, params["codebooks"][level])


def encode_top(cfg: JukeboxVQVAEConfig, params: Params, audio: torch.Tensor) -> torch.Tensor:
    """Top-level (128x hop) codes: the only level the reference consumes."""
    return encode_level(cfg, params, audio, cfg.levels - 1)
