"""Jukebox model configurations (counterpart of
llark_tpu/encoders/jukebox/config.py).

Hyperparameters follow the public openai/jukebox 5B release (Dhariwal et
al. 2020, Table 6) as exercised by the reference embedding path
(reference: jukebox/main.py:176-200 — 5b VQ-VAE + top-level prior with
prior_depth patched to 36). Exact widths are confirmed at weight-import
time by `import_torch.py`, which infers dimensions from checkpoint tensor
shapes, so a mismatch fails loudly rather than silently.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class JukeboxVQVAEConfig:
    levels: int = 3
    downs_t: Tuple[int, ...] = (3, 2, 2)  # level l downsamples 2**downs_t[l]
    strides_t: Tuple[int, ...] = (2, 2, 2)
    emb_width: int = 64  # codebook embedding dim
    l_bins: int = 2048  # codebook size
    width: int = 32  # conv channel width
    depth: int = 4  # resnet blocks per downsample stage
    # per-ENCODER width/depth multiplier (openai vqvae hps `multipliers`,
    # (2, 1, 1) in the public releases): jukebox builds one independent
    # full encoder per VQ level, and encoder l uses width*multipliers[l] /
    # depth*multipliers[l] for ALL of its chained blocks. The embedding
    # path consumes only the TOP encoder (multiplier 1 for 5b), so the
    # effective width/depth is top_width/top_depth; the field is recorded
    # so importers of non-top encoders size correctly.
    multipliers: Tuple[int, ...] = (2, 1, 1)
    m_conv: float = 1.0
    dilation_growth_rate: int = 3
    dtype: str = "float32"

    @property
    def top_width(self) -> int:
        return self.width * self.multipliers[self.levels - 1]

    @property
    def top_depth(self) -> int:
        return self.depth * self.multipliers[self.levels - 1]

    @property
    def hop_lengths(self) -> Tuple[int, ...]:
        hops = []
        total = 1
        for d, s in zip(self.downs_t, self.strides_t):
            total *= s**d
            hops.append(total)
        return tuple(hops)  # (8, 32, 128)

    @classmethod
    def tiny(cls, **kw) -> "JukeboxVQVAEConfig":
        base = dict(
            levels=3, downs_t=(1, 1, 1), strides_t=(2, 2, 2),
            emb_width=8, l_bins=32, width=8, depth=1, multipliers=(1, 1, 1),
        )
        base.update(kw)
        return cls(**base)


@dataclasses.dataclass
class JukeboxPriorConfig:
    """Top-level (level-2) prior transformer in only-encode mode."""

    n_ctx: int = 8192
    width: int = 4800
    depth: int = 36  # truncated from 72 (reference: make_models.py.patch)
    heads: int = 8
    bins: int = 2048  # vq codebook size
    blocks: int = 128  # factored-attention block count; block_ctx = n_ctx/blocks
    m_attn: float = 0.25  # attention inner width = width * m_attn
    m_mlp: float = 1.0
    attn_order: int = 2  # cycle (row, column, previous-row)
    afn: str = "quick_gelu"
    eps: float = 1e-5
    add_cond_after_transformer: bool = True
    dtype: str = "float32"

    @property
    def block_ctx(self) -> int:
        return self.n_ctx // self.blocks

    @property
    def attn_width(self) -> int:
        return int(self.width * self.m_attn)

    @property
    def mlp_width(self) -> int:
        return int(self.width * self.m_mlp)

    @classmethod
    def tiny(cls, **kw) -> "JukeboxPriorConfig":
        base = dict(
            n_ctx=64, width=16, depth=6, heads=2, bins=32, blocks=8,
            m_attn=0.5, m_mlp=1.0,
        )
        base.update(kw)
        return cls(**base)
