"""Model configuration for the PyTorch/CUDA port.

Own copy of the JAX package's `ModelConfig`, cut to the fields the port
reads, with the same names and defaults: the architecture, the numerics and
two kernel switches. `use_pallas_attention` switches the hand-written Hopper
flash-prefill kernel and `use_flash_decode` the flash-decode kernel; the
names are the JAX package's so that the same keyword arguments build the
same model in both. Features of later slices (int8 KV cache, MoE) keep only
the field that makes the decoder raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ModelConfig:
    """Decoder architecture. Defaults describe Llama-2-7B; `tiny()` and
    `mpt_1b()` provide the test and ablation variants."""

    arch: str = "llama"  # "llama" | "mpt"
    vocab_size: int = 32004  # 32000 + pad + 3 audio specials
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32  # < num_heads => GQA/MQA
    head_dim: Optional[int] = None  # default hidden/num_heads
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    # MPT-specific
    use_alibi: bool = False
    use_bias: bool = False
    tie_embeddings: bool = False  # MPT ties lm_head to wte
    mlp_activation: str = "silu"  # "silu" (SwiGLU) | "gelu" (plain MLP)
    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    # Multimodal
    mm_hidden_size: int = 4800  # Jukebox embedding dim; 512 for CLAP
    # Numerics
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    # Kernels: the Hopper flash-prefill kernel (ops/attention.py)
    use_pallas_attention: bool = True
    # int8 KV cache (not in this slice of the port: the decoder raises)
    kv_cache_quant: bool = False
    # Hopper flash-decode kernel for short cached steps (ops/
    # decode_attention.py). None = off, as in the JAX package's Generator;
    # the serving stack turns it on.
    use_flash_decode: Optional[bool] = None
    # from-scratch init scheme: kaiming | xavier | small
    init_scheme: str = "kaiming"
    # MoE (not in this slice of the port: the decoder raises)
    moe_num_experts: int = 0

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_heads

    @classmethod
    def llama2_7b(cls, **kw) -> "ModelConfig":
        return cls(**kw)

    @classmethod
    def mpt_1b(cls, **kw) -> "ModelConfig":
        """MPT-1B ablation (reference: m2t/llava/model/mpt/configuration_mpt.py:7-17)."""
        base = dict(
            arch="mpt",
            vocab_size=50368 + 3,
            hidden_size=2048,
            intermediate_size=8192,
            num_layers=24,
            num_heads=16,
            num_kv_heads=16,
            use_alibi=True,
            tie_embeddings=True,
            mlp_activation="gelu",
            norm_type="layernorm",
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def tiny(cls, arch: str = "llama", **kw) -> "ModelConfig":
        """Small config for CPU tests."""
        base = dict(
            arch=arch,
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=4,
            mm_hidden_size=48,
            use_pallas_attention=False,
        )
        if arch == "mpt":
            base.update(
                use_alibi=True,
                tie_embeddings=True,
                mlp_activation="gelu",
                norm_type="layernorm",
            )
        base.update(kw)
        return cls(**base)
