"""HF-checkpoint interop (counterpart of llark_tpu/interop/hf.py).

Parity targets:
  * weight IMPORT replaces the reference's `from_pretrained` load of
    Llama-2-7b-chat / MPT-1B (m2t/train.py:62-75, m2t/models/utils.py:126-199);
  * weight EXPORT produces a state dict the reference's wrapped models could
    load (`model.layers...`, plus `model.mm_projector.{weight,bias}` -- the keys
    WrappedTrainer._save writes, m2t/models/trainer.py:35-65);
  * new-token embedding rows are mean-initialized exactly as
    `initialize_audio_tokenizer` does (m2t/models/llamav2.py:367-419).

State dicts are torch tensors on the CPU, in the dtypes the files hold.
Safetensors files are parsed here (an 8-byte little-endian header length,
a JSON header, raw little-endian data mapped with `torch.frombuffer`), so
no `safetensors` package is needed. Parameter trees come out on an
explicit device (the GPU unless the caller asks for the CPU) in
`cfg.param_dtype`. HF Linear stores [out, in]; the stacked layout is
[L, in, out], so every projection transposes on import. Each stacked
leaf is one preallocated tensor filled a layer at a time, so an import
holds one copy of the weights on the device beside the state dict (and
none of a layer once it is copied, when the importer owns the dict).

Mixtral checkpoints (`block_sparse_moe.*`) import into the MoE layout
(`models/moe.py`): the router `gate` [E, H] of each layer becomes
`moe_router` [L, H, E] and expert e's `w1` / `w3` / `w2` become
`moe_w_gate` / `moe_w_up` / `moe_w_down` [L, E, in, out]; the export is the
inverse, under a `MixtralForCausalLM` config.json.
"""

from __future__ import annotations

import json
import logging
import mmap
import os
import struct
import sys
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.models.decoder import torch_dtype

Params = Dict[str, Any]
StateDict = Dict[str, torch.Tensor]

log = logging.getLogger(__name__)

# a Mixtral (MoE) state dict has it
_MOE_KEY = "model.layers.0.block_sparse_moe.gate.weight"
# our expert stacks and Mixtral's expert weights: w1 gate, w3 up, w2 down
_MIXTRAL_EXPERTS = (("moe_w_gate", "w1"), ("moe_w_down", "w2"), ("moe_w_up", "w3"))

# ---------------------------------------------------------------------------
# state-dict loading (safetensors / torch .bin, sharded or single-file)
# ---------------------------------------------------------------------------

SAFETENSORS_DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I8": torch.int8,
}


def read_safetensors(path: str) -> StateDict:
    """Every tensor of a .safetensors file, mapped from the file (copy on
    write: the pages are read as the tensors are used)."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors data is little-endian; this host is not")
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out: StateDict = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype {meta['dtype']}, which the "
                             f"port does not read (it reads {', '.join(SAFETENSORS_DTYPES)})")
        start, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: tensor {name} spans {end - start} bytes, not {shape}")
        if end == start:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (base + start) % itemsize:  # unaligned: copy its bytes out
            out[name] = torch.frombuffer(bytearray(buf[base + start:base + end]),
                                         dtype=dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=(end - start) // itemsize,
                                         offset=base + start).reshape(shape)
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """A .safetensors file written by the format itself (no package): the
    header's length as 8 little-endian bytes, a JSON header of dtype, shape
    and data offsets, padded to 8 bytes, then the raw little-endian data.
    The inverse of `read_safetensors`, for its dtypes."""
    names = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().cpu().contiguous().view(torch.uint8).numpy().data)


def _load_one(path: str) -> StateDict:
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_hf_state_dict(path: str) -> StateDict:
    """Load an HF checkpoint directory or single weight file into CPU
    tensors. Handles sharded checkpoints via the *.index.json manifest
    (the reference's shard-by-shard loader: m2t/models/utils.py:55-123)."""
    if os.path.isfile(path):
        return _load_one(path)
    for index_name in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
        idx = os.path.join(path, index_name)
        if os.path.exists(idx):
            with open(idx) as f:
                manifest = json.load(f)
            out: StateDict = {}
            for shard in sorted(set(manifest["weight_map"].values())):
                out.update(_load_one(os.path.join(path, shard)))
            return out
    for name in ("model.safetensors", "pytorch_model.bin"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            return _load_one(p)
    raise FileNotFoundError(f"no HF weights found under {path}")


# ---------------------------------------------------------------------------
# import: HF -> the port's param tree
# ---------------------------------------------------------------------------


class _Importer:
    """Fills preallocated [L, ...] leaves from a state dict, one layer at a
    time, on `device` in `dtype`. With `consume`, each source tensor leaves
    the dict once it is copied."""

    def __init__(self, sd: StateDict, device: torch.device, dtype: torch.dtype, consume: bool):
        self.sd, self.device, self.dtype, self.consume = sd, device, dtype, consume

    def take(self, key: str) -> torch.Tensor:
        t = self.sd.pop(key) if self.consume else self.sd[key]
        return t.to(self.device)

    def single(self, key: str, transpose: bool = False) -> torch.Tensor:
        t = self.take(key)
        out = torch.empty((t.shape[::-1] if transpose else t.shape),
                          dtype=self.dtype, device=self.device)
        return out.copy_(t.T if transpose else t)

    def stacked(self, pattern: str, n_layers: int, transpose: bool = False) -> torch.Tensor:
        out = None
        for i in range(n_layers):
            t = self.take(pattern.format(i=i))
            t = t.T if transpose else t
            if out is None:
                out = torch.empty((n_layers, *t.shape), dtype=self.dtype, device=self.device)
            out[i].copy_(t)
        return out

    def experts(self, pattern: str, n_layers: int, n_experts: int) -> torch.Tensor:
        """[L, E, in, out] from per-(layer, expert) HF Linear weights [out, in]."""
        out = None
        for i in range(n_layers):
            for e in range(n_experts):
                t = self.take(pattern.format(i=i, e=e)).T
                if out is None:
                    out = torch.empty((n_layers, n_experts, *t.shape), dtype=self.dtype,
                                      device=self.device)
                out[i, e].copy_(t)
        return out


def _importer(sd, cfg, dtype, device, consume) -> _Importer:
    pdt = torch_dtype(dtype or cfg.param_dtype)
    return _Importer(sd, resolve_device(device), pdt, consume)


def llama_params_from_hf(
    sd: StateDict,
    cfg: ModelConfig,
    dtype: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    consume: bool = False,
) -> Params:
    """HF LlamaForCausalLM (or MixtralForCausalLM) state dict -> stacked
    decoder params on `device` in `dtype` (default cfg.param_dtype).
    `consume` empties `sd` as it goes. A Mixtral state dict's experts come
    in as [L, E, in, out] stacks (llark_tpu/interop/hf.py:108-132)."""
    L = cfg.num_layers
    moe_experts = sd[_MOE_KEY].shape[0] if _MOE_KEY in sd else 0
    if moe_experts and cfg.moe_num_experts and cfg.moe_num_experts != moe_experts:
        raise ValueError(f"checkpoint has {moe_experts} experts, "
                         f"cfg.moe_num_experts={cfg.moe_num_experts}")
    imp = _importer(sd, cfg, dtype, device, consume)
    layers: Params = {
        "attn_norm_scale": imp.stacked("model.layers.{i}.input_layernorm.weight", L),
        "mlp_norm_scale": imp.stacked("model.layers.{i}.post_attention_layernorm.weight", L),
    }
    projections = [("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                   ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj")]
    if not moe_experts:
        projections += [("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                        ("w_down", "mlp.down_proj")]
    for ours, theirs in projections:
        layers[ours] = imp.stacked(f"model.layers.{{i}}.{theirs}.weight", L, transpose=True)
    if moe_experts:
        layers["moe_router"] = imp.stacked("model.layers.{i}.block_sparse_moe.gate.weight", L,
                                           transpose=True)
        for ours, theirs in _MIXTRAL_EXPERTS:
            layers[ours] = imp.experts(
                f"model.layers.{{i}}.block_sparse_moe.experts.{{e}}.{theirs}.weight", L,
                moe_experts)
    return {
        "embed": imp.single("model.embed_tokens.weight"),
        "layers": layers,
        "final_norm_scale": imp.single("model.norm.weight"),
        "lm_head": imp.single("lm_head.weight", transpose=True),
    }


def mpt_params_from_hf(
    sd: StateDict,
    cfg: ModelConfig,
    dtype: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    consume: bool = False,
) -> Params:
    """HF MptForCausalLM state dict -> stacked decoder params.
    MPT fuses Wqkv ([3H, H]); it is split into wq/wk/wv. Embeddings are
    tied (reference: m2t/models/mpt.py:312)."""
    L, h = cfg.num_layers, cfg.hidden_size
    imp = _importer(sd, cfg, dtype, device, consume)
    wqkv = {name: torch.empty((L, h, h), dtype=imp.dtype, device=imp.device)
            for name in ("wq", "wk", "wv")}
    for i in range(L):
        w = imp.take(f"transformer.blocks.{i}.attn.Wqkv.weight")  # [3H, H]
        for j, name in enumerate(("wq", "wk", "wv")):
            wqkv[name][i].copy_(w[j * h:(j + 1) * h].T)
    layers: Params = {
        "attn_norm_scale": imp.stacked("transformer.blocks.{i}.norm_1.weight", L),
        "mlp_norm_scale": imp.stacked("transformer.blocks.{i}.norm_2.weight", L),
        **wqkv,
        "wo": imp.stacked("transformer.blocks.{i}.attn.out_proj.weight", L, transpose=True),
        "w_up": imp.stacked("transformer.blocks.{i}.ffn.up_proj.weight", L, transpose=True),
        "w_down": imp.stacked("transformer.blocks.{i}.ffn.down_proj.weight", L, transpose=True),
    }
    for ours, theirs in (("attn_norm_bias", "transformer.blocks.{i}.norm_1.bias"),
                         ("mlp_norm_bias", "transformer.blocks.{i}.norm_2.bias")):
        layers[ours] = (imp.stacked(theirs, L) if theirs.format(i=0) in sd
                        else torch.zeros((L, h), dtype=imp.dtype, device=imp.device))
    params: Params = {
        "embed": imp.single("transformer.wte.weight"),
        "layers": layers,
        "final_norm_scale": imp.single("transformer.norm_f.weight"),
    }
    params["final_norm_bias"] = (
        imp.single("transformer.norm_f.bias") if "transformer.norm_f.bias" in sd
        else torch.zeros((h,), dtype=imp.dtype, device=imp.device))
    return params


def _mean(t: torch.Tensor, axis: int) -> torch.Tensor:
    # numpy's reduction, on the host in fp32, as the JAX package computes
    # it: the same rows come out bit for bit
    m = t.detach().float().cpu().numpy().mean(axis=axis, keepdims=True)
    return torch.from_numpy(m).to(device=t.device, dtype=t.dtype)


def resize_embeddings(params: Params, new_vocab: int) -> Params:
    """Grow embed (and lm_head) to new_vocab rows; new rows/cols get the
    mean of the existing ones (reference: m2t/models/llamav2.py:367-419)."""
    out = dict(params)
    embed = params["embed"]
    old_vocab = embed.shape[0]
    if new_vocab < old_vocab:
        raise ValueError(f"cannot shrink vocab {old_vocab} -> {new_vocab}")
    if new_vocab > old_vocab:
        out["embed"] = torch.cat(
            [embed, _mean(embed, 0).expand(new_vocab - old_vocab, -1)], dim=0)
    if "lm_head" in params:
        head = params["lm_head"]  # [H, V]
        if new_vocab > head.shape[1]:
            out["lm_head"] = torch.cat(
                [head, _mean(head, 1).expand(-1, new_vocab - head.shape[1])], dim=1)
    return out


def load_pretrained_backbone(
    path: str, cfg: ModelConfig, device: Union[str, torch.device] = "cuda"
) -> Params:
    """Import an HF checkpoint dir onto `device`, detect the architecture by
    key prefix, resize the vocab to cfg.vocab_size.

    A Mixtral checkpoint (block_sparse_moe.* tensors) loaded into a MoE
    config sets, in `cfg` itself, moe_routing="mixtral" and a drop-free
    capacity factor E/K (llark_tpu/interop/hf.py:216-254): HF's
    MixtralSparseMoeBlock renormalizes the top-k gates and never drops a
    token, so Switch routing would scale every MoE output down."""
    sd = load_hf_state_dict(path)
    if any(k.startswith("transformer.blocks.") for k in sd):
        params = mpt_params_from_hf(sd, cfg, device=device, consume=True)
    else:
        if _MOE_KEY in sd and cfg.moe_num_experts > 0:
            if cfg.moe_routing != "mixtral":
                log.warning("Mixtral checkpoint: switching moe_routing %r -> 'mixtral' "
                            "(renormalized gates, no drops)", cfg.moe_routing)
                cfg.moe_routing = "mixtral"
            drop_free = cfg.moe_num_experts / cfg.moe_top_k
            if cfg.moe_capacity_factor < drop_free:
                log.warning("Mixtral checkpoint: raising moe_capacity_factor %.3g -> %.3g "
                            "so no token is ever dropped", cfg.moe_capacity_factor, drop_free)
                cfg.moe_capacity_factor = drop_free
        params = llama_params_from_hf(sd, cfg, device=device, consume=True)
    if params["embed"].shape[0] != cfg.vocab_size:
        params = resize_embeddings(params, cfg.vocab_size)
    return params


# ---------------------------------------------------------------------------
# export: the port's param tree -> HF state dict
# ---------------------------------------------------------------------------


def _host(t: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    t = t.detach().float()
    return (t.T if transpose else t).contiguous().cpu()


def hf_state_dict_from_params(
    cfg: ModelConfig, params: Params, include_projector: bool = True
) -> StateDict:
    """Inverse of the importers: fp32 CPU tensors. Keys match what the
    reference's wrapped models save/load, including `model.mm_projector.*`;
    a MoE tree's under Mixtral's `block_sparse_moe.*` names."""
    layers = params["layers"]
    L = cfg.num_layers
    sd: StateDict = {}

    def unstack(arr, pattern: str, transpose: bool = False):
        for i in range(L):
            sd[pattern.format(i=i)] = _host(arr[i], transpose)

    if cfg.arch == "mpt":
        # the reference's keys: no per-layer norm biases (an import reads
        # them as zeros)
        sd["transformer.wte.weight"] = _host(params["embed"])
        for i in range(L):
            sd[f"transformer.blocks.{i}.attn.Wqkv.weight"] = torch.cat(
                [_host(layers[n][i], True) for n in ("wq", "wk", "wv")], dim=0)
        unstack(layers["wo"], "transformer.blocks.{i}.attn.out_proj.weight", True)
        unstack(layers["w_up"], "transformer.blocks.{i}.ffn.up_proj.weight", True)
        unstack(layers["w_down"], "transformer.blocks.{i}.ffn.down_proj.weight", True)
        unstack(layers["attn_norm_scale"], "transformer.blocks.{i}.norm_1.weight")
        unstack(layers["mlp_norm_scale"], "transformer.blocks.{i}.norm_2.weight")
        sd["transformer.norm_f.weight"] = _host(params["final_norm_scale"])
        if "final_norm_bias" in params:
            sd["transformer.norm_f.bias"] = _host(params["final_norm_bias"])
    else:
        sd["model.embed_tokens.weight"] = _host(params["embed"])
        projections = [("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                       ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj")]
        if "moe_router" not in layers:
            projections += [("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                            ("w_down", "mlp.down_proj")]
        for ours, theirs in projections:
            unstack(layers[ours], f"model.layers.{{i}}.{theirs}.weight", True)
        if "moe_router" in layers:
            unstack(layers["moe_router"], "model.layers.{i}.block_sparse_moe.gate.weight", True)
            for ours, theirs in _MIXTRAL_EXPERTS:
                stack = layers[ours]  # [L, E, in, out]
                for i in range(L):
                    for e in range(stack.shape[1]):
                        sd[f"model.layers.{i}.block_sparse_moe.experts.{e}.{theirs}.weight"] = \
                            _host(stack[i, e], True)
        unstack(layers["attn_norm_scale"], "model.layers.{i}.input_layernorm.weight")
        unstack(layers["mlp_norm_scale"], "model.layers.{i}.post_attention_layernorm.weight")
        sd["model.norm.weight"] = _host(params["final_norm_scale"])
        sd["lm_head.weight"] = _host(params["lm_head"], True)

    if include_projector and "mm_projector" in params:
        # the reference stores the projector as nn.Linear: weight [H, mm]
        sd["model.mm_projector.weight"] = _host(params["mm_projector"]["kernel"], True)
        sd["model.mm_projector.bias"] = _host(params["mm_projector"]["bias"])
    return sd


def hf_config(cfg: ModelConfig) -> Dict[str, Any]:
    """The config.json the JAX package's `save_hf_checkpoint` writes for
    `cfg`, key for key."""
    if cfg.arch == "mpt":
        return {
            "model_type": "mpt",
            "d_model": cfg.hidden_size,
            "n_heads": cfg.num_heads,
            "n_layers": cfg.num_layers,
            "expansion_ratio": cfg.intermediate_size // cfg.hidden_size,
            "max_seq_len": cfg.max_seq_len,
            "vocab_size": cfg.vocab_size,
            "mm_hidden_size": cfg.mm_hidden_size,
        }
    # a MoE state dict carries Mixtral's tensor names, so the config says
    # mixtral too: a loader told 'llama' would drop every expert weight
    moe = bool(cfg.moe_num_experts)
    config = {
        "model_type": "mixtral" if moe else "llama",
        "architectures": ["MixtralForCausalLM" if moe else "LlamaForCausalLM"],
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "max_position_embeddings": cfg.max_seq_len,
        "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta,
        "vocab_size": cfg.vocab_size,
        "mm_hidden_size": cfg.mm_hidden_size,
    }
    if moe:
        config["num_local_experts"] = cfg.moe_num_experts
        config["num_experts_per_tok"] = cfg.moe_top_k
    return config


def save_hf_checkpoint(path: str, cfg: ModelConfig, params: Params) -> str:
    """Write an fp32 pytorch_model.bin + a minimal config.json readable by
    the reference's loaders and by the JAX package's importer."""
    os.makedirs(path, exist_ok=True)
    torch.save(hf_state_dict_from_params(cfg, params), os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f, indent=2)
    return path
