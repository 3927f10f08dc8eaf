"""Configuration for the PyTorch/CUDA port.

Own copy of the JAX package's `ModelConfig`, cut to the fields the port
reads, with the same names and defaults: the architecture, the numerics,
two kernel switches, activation recomputation and LoRA. `use_pallas_attention`
switches the hand-written Hopper flash-attention kernels (forward, and the
backward when training) and `use_flash_decode` the flash-decode kernel; the
names are the JAX package's so that the same keyword arguments build the
same model in both. `kv_cache_quant` makes the decoder keep an int8 KV
cache with fp32 per-position scales. The `moe_*` fields make the MLP a
Mixture-of-Experts (`models/moe.py`).

Also own copies of the training argument dataclasses, `write_args_to_file`
and `parse_args` (llark_tpu/config.py:160-335), field for field, so the
same flags drive both packages' trainers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Optional, Tuple


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
    max_seq_len: int = 2048  # max_position_embeddings of an HF config.json
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
    # Kernels: the Hopper flash-attention kernels (ops/attention.py)
    use_pallas_attention: bool = True
    # int8 KV cache with fp32 per-position scales (models/decoder.py)
    kv_cache_quant: bool = False
    # Hopper flash-decode kernel for short cached steps (ops/
    # decode_attention.py). None = off, as in the JAX package's Generator;
    # the serving stack turns it on.
    use_flash_decode: Optional[bool] = None
    # Training: recompute each layer's activations in the backward
    # (torch.utils.checkpoint per layer). "full" recomputes the whole layer;
    # "dots" keeps the outputs of its non-batched products (the JAX
    # package's dots_with_no_batch_dims_saveable), "dots_narrow" only those
    # narrower than 3 x hidden_size (models/decoder.py `_remat_context`).
    remat: bool = True
    remat_policy: str = "full"
    # from-scratch init scheme: kaiming | xavier | small
    init_scheme: str = "kaiming"
    # LoRA (0 = disabled; see models/lora.py)
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_dropout: float = 0.0
    # Mixture-of-Experts (0 = dense MLP): top-k routing with a static
    # capacity per sequence row; expert weights stack [L, E, ...]
    # (models/moe.py)
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01
    # "switch": raw-softmax gates + capacity drops (GShard/Switch).
    # "mixtral": top-k gates renormalized to sum 1, no token drops (HF
    # MixtralSparseMoeBlock); load_pretrained_backbone selects it for a
    # checkpoint with block_sparse_moe.* tensors.
    moe_routing: str = "switch"

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_heads
        if self.remat_policy not in ("full", "dots", "dots_narrow"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        if self.moe_routing not in ("switch", "mixtral"):
            raise ValueError(f"unknown moe_routing={self.moe_routing!r}")
        if self.moe_num_experts > 0 and self.moe_top_k > self.moe_num_experts:
            # with every expert masked, argmax over the zero row would send
            # each token to expert 0 again (moe_ffn)
            raise ValueError(
                f"moe_top_k={self.moe_top_k} must be <= "
                f"moe_num_experts={self.moe_num_experts}"
            )

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
            max_seq_len=256,
            mm_hidden_size=48,
            use_pallas_attention=False,
            remat=False,
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


@dataclasses.dataclass
class ModelArguments:
    """Reference-parity model flags (reference: m2t/arguments.py:22-44)."""

    model_name_or_path: str = "llama2-7b"
    version: str = "v0"
    freeze_backbone: bool = False
    tune_mm_mlp_adapter: bool = False
    pretrain_mm_mlp_adapter: Optional[str] = None
    mm_use_audio_start_end: bool = True
    mm_hidden_size: int = 4800
    # MoE (0 = dense MLP; see ModelConfig)
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25


@dataclasses.dataclass
class DataArguments:
    """Reference-parity data flags (reference: m2t/arguments.py:47-78)."""

    train_data_path: Optional[str] = None
    eval_data_path: Optional[str] = None
    # fraction of the eval stream to keep (reference rsample_frac,
    # m2t/data_modules.py:709); None = all
    eval_data_subsample: Optional[float] = None
    is_multimodal: bool = True
    sep_audio_conv_front: bool = False
    task_sample_probs: Optional[Dict[str, float]] = None
    # gate for task_sample_probs (reference: m2t/arguments.py:68,
    # data_modules.py:698-700)
    apply_task_sample_probs: bool = True
    # parity field: on-the-fly audio loading root (encodings come packed
    # in the shards instead)
    audio_folder: Optional[str] = None
    max_audio_frames: int = 256  # pad/truncate audio frame axis (static shapes)
    # parallel example-processing threads (1 = deterministic stream)
    num_workers: int = 1

    def __post_init__(self):
        if self.task_sample_probs is None:
            # reference: m2t/arguments.py:61-67
            self.task_sample_probs = {
                "captioning": 0.15,
                "reasoning": 0.55,
                "mir": 0.30,
            }


@dataclasses.dataclass
class TrainingArguments:
    """Training hyperparameters (reference: m2t/arguments.py:81-109 and the
    hyperparameters-of-record in scripts/training/train_llark.sh:24-44).
    The same fields as the JAX package's; the trainer raises on the ones
    the port does not run yet (multihost, a mesh larger than one device)."""

    output_dir: str = "/tmp/llark_tpu"
    cache_dir: Optional[str] = None
    optim: str = "adamw"
    model_max_length: int = 2048
    per_device_train_batch_size: int = 2
    gradient_accumulation_steps: int = 4
    learning_rate: float = 5e-5
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    lr_scheduler_type: str = "cosine"
    max_steps: int = 100_000
    save_steps: int = 5000
    # eval-loss pass over eval_data_path every N steps (0 = disabled)
    eval_steps: int = 0
    save_total_limit: int = 1
    logging_steps: int = 1
    seed: int = 42
    bf16: bool = True
    gradient_checkpointing: bool = True
    bits: int = 16
    lora_enable: bool = False
    lora_r: int = 64
    lora_alpha: int = 16
    lora_dropout: float = 0.05
    lora_weight_path: str = ""
    lora_bias: str = "none"
    # pin the projector while training other stages (reference:
    # m2t/llava/train/train.py:68)
    freeze_mm_mlp_adapter: bool = False
    mesh_shape: Tuple[int, int, int] = (1, 1, 1)  # (data, fsdp, tensor)
    resume: bool = True
    # chunked cross-entropy for long sequences (0 = disabled); must divide
    # model_max_length
    loss_chunk: int = 0
    # profiling: a torch.profiler trace over a step window when set
    profile_dir: Optional[str] = None
    profile_start_step: int = 10
    profile_num_steps: int = 3
    multihost: bool = False
    # on SIGTERM/SIGINT finish the in-flight step, checkpoint, exit cleanly
    checkpoint_on_preemption: bool = True
    # "jsonl" appends <output_dir>/metrics.jsonl per logged step;
    # "tensorboard" also writes event files under <output_dir>/tb; "none"
    # disables tracking
    report_to: str = "jsonl"


def write_args_to_file(args_list, output_dir: str) -> None:
    """Dump all argument dataclasses to `<output_dir>/args.txt`
    (reference: m2t/arguments.py:136-155)."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "args.txt")
    payload = {type(a).__name__: dataclasses.asdict(a) for a in args_list}
    tmp = f"{path}.{os.getpid()}.tmp"  # each writer its own (the ranks of a mesh run)
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, default=str)
    os.replace(tmp, path)  # atomic: tolerate concurrent writers


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def _parse_tuple(s: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in s.replace(",", " ").split())


# field type (as its annotation string) -> argparse type
_ARG_TYPES = {
    "bool": _parse_bool, "int": int, "float": float, "str": str,
    "Optional[int]": int, "Optional[float]": float, "Optional[str]": str,
    "Optional[Dict[str, float]]": json.loads, "Tuple[int, int, int]": _parse_tuple,
}


def _add_dataclass_args(parser: argparse.ArgumentParser, dc_type) -> None:
    for f in dataclasses.fields(dc_type):
        default = f.default if f.default is not dataclasses.MISSING else None
        parser.add_argument("--" + f.name, type=_ARG_TYPES[str(f.type)], default=default)


def parse_args(argv=None):
    """Parse (ModelArguments, DataArguments, TrainingArguments) from CLI."""
    parser = argparse.ArgumentParser("llark_tpu_torch")
    for dc in (ModelArguments, DataArguments, TrainingArguments):
        _add_dataclass_args(parser, dc)
    ns, _ = parser.parse_known_args(argv)
    d = vars(ns)

    def pick(dc_type):
        names = {f.name for f in dataclasses.fields(dc_type)}
        return dc_type(**{k: v for k, v in d.items() if k in names and v is not None})

    return pick(ModelArguments), pick(DataArguments), pick(TrainingArguments)
