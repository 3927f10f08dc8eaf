"""CLAP text tower: RoBERTa-style encoder + 2-layer projection; counterpart
of llark_tpu/encoders/clap/text.py.

The reference's evaluation notebooks embed model completions and label
sets with the OpenAI text-embeddings API; CLAP's text tower (RoBERTa-base +
MLP projection, `ClapTextModelWithProjection` in laion/clap-htsat-unfused)
gives music-domain embeddings that run on the card instead, so
`evaluation/harness.py --embedder clap` ranks genre labels without an API.

Architecture (post-LN BERT encoder, RoBERTa position indexing):
  x = LN(word[ids] + pos[pos_ids] + type[0])
  per layer: x = LN(x + W_o·attn(x));  x = LN(x + W2·gelu(W1·x))
  pooled = tanh(W_p · x[:, 0]);  embed = W_b·act(W_a·pooled)
Position ids follow RoBERTa's create_position_ids_from_input_ids:
cumsum(mask)·mask + pad_id, so padding rows stay at the pad position.

`ClapTextModel` is an `nn.Module` in fp32 that runs with TF32 off whatever
the caller's flags (`device.full_fp32`), as the HTSAT tower does. Its
attention is plain products and a softmax: no TPU kernel computes it, and
the flash kernel would round fp32 operands to bf16. Masked keys take -1e9,
as in the JAX package. `config.json` is read with `transformers`'
ClapTextConfig defaults copied here (`CLAP_TEXT_DEFAULTS`), so
`transformers` is imported only for a checkpoint that ships tokenizer
files.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import types
import zlib
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from llark_tpu_torch.device import full_fp32, resolve_device
from llark_tpu_torch.interop.hf import load_hf_state_dict, write_safetensors

Device = Union[str, torch.device]
StateDict = Dict[str, torch.Tensor]
Params = StateDict  # the reference's name for the tower's weights (llark_tpu/encoders/clap/text.py:33)

# transformers.ClapTextConfig's defaults of the fields text_config_from_hf
# reads: what a config.json that leaves a field out means
CLAP_TEXT_DEFAULTS = dict(
    vocab_size=50265, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
    intermediate_size=3072, max_position_embeddings=514, type_vocab_size=1,
    pad_token_id=1, layer_norm_eps=1e-12, projection_dim=512, projection_hidden_act="relu",
)

# files one of which a directory holding an HF tokenizer has
_TOKENIZER_FILES = ("tokenizer_config.json", "tokenizer.json", "vocab.json", "merges.txt")


@dataclasses.dataclass
class ClapTextConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-12
    projection_dim: int = 512
    projection_act: str = "relu"  # ClapProjectionLayer's activation

    @classmethod
    def base(cls, **kw) -> "ClapTextConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "ClapTextConfig":
        base = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                    intermediate_size=128, max_position_embeddings=64,
                    projection_dim=32)
        base.update(kw)
        return cls(**base)


def roberta_position_ids(ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """RoBERTa position indexing: non-pad tokens count 1.. from the left,
    offset by pad_id (create_position_ids_from_input_ids)."""
    mask = (ids != pad_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_id


class ClapTextLayer(nn.Module):
    """One post-LN encoder layer: q/k/v fused in one projection."""

    def __init__(self, cfg: ClapTextConfig):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.num_heads = cfg.num_heads
        self.qkv = nn.Linear(h, 3 * h)
        self.proj = nn.Linear(h, h)
        self.n1 = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(h, i)
        self.fc2 = nn.Linear(i, h)
        self.n2 = nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        nh = self.num_heads
        dh = h // nh
        q, k, v = (t.reshape(b, s, nh, dh).transpose(1, 2)
                   for t in self.qkv(x).split(h, dim=-1))
        att = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh) + bias
        a = torch.matmul(torch.softmax(att, dim=-1), v)
        a = self.proj(a.transpose(1, 2).reshape(b, s, h))
        x = self.n1(x + a)
        ff = self.fc2(F.gelu(self.fc1(x)))
        return self.n2(x + ff)


def _table(n: int, h: int) -> nn.Embedding:
    # uninitialized: the weights come from a state dict (and normal_ on the
    # meta device costs seconds the first time)
    return nn.Embedding.from_pretrained(torch.empty(n, h), freeze=False)


class ClapTextModel(nn.Module):
    """input ids [B, S] -> L2-unnormalized text embeddings [B, projection_dim].
    Built by `build_text_model` from a state dict."""

    def __init__(self, cfg: ClapTextConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word = _table(cfg.vocab_size, h)
        self.position = _table(cfg.max_position_embeddings, h)
        self.token_type = _table(cfg.type_vocab_size, h)
        self.ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(ClapTextLayer(cfg) for _ in range(cfg.num_layers))
        self.pooler = nn.Linear(h, h)
        self.proj1 = nn.Linear(h, cfg.projection_dim)
        self.proj2 = nn.Linear(cfg.projection_dim, cfg.projection_dim)

    def compute(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The forward under the caller's TF32 flags."""
        cfg = self.cfg
        ids = input_ids.long()
        if attention_mask is None:
            attention_mask = ids != cfg.pad_token_id
        pos = roberta_position_ids(ids, cfg.pad_token_id)
        x = self.ln(self.word(ids) + self.position(pos) + self.token_type.weight[0])
        # additive key mask [B, 1, 1, S]
        bias = (1.0 - attention_mask.float())[:, None, None, :] * -1e9
        for layer in self.layers:
            x = layer(x, bias)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        z = self.proj1(pooled)
        z = F.relu(z) if cfg.projection_act == "relu" else F.gelu(z)
        return self.proj2(z)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        with full_fp32():
            return self.compute(input_ids, attention_mask)


def clap_text_embed(
    model: ClapTextModel,
    input_ids: Union[torch.Tensor, np.ndarray],  # [B, S] int
    attention_mask: Optional[Union[torch.Tensor, np.ndarray]] = None,  # [B, S] 1=real
) -> torch.Tensor:
    """input ids -> L2-unnormalized text embeddings [B, projection_dim] on
    the model's device."""
    dev = next(model.parameters()).device
    ids = torch.as_tensor(input_ids).to(dev)
    mask = None if attention_mask is None else torch.as_tensor(attention_mask).to(dev)
    with torch.no_grad():
        return model(ids, mask)


def build_text_model(cfg: ClapTextConfig, state: Mapping[str, torch.Tensor],
                     device: Device = "cuda") -> ClapTextModel:
    """A ClapTextModel on `device` (the GPU unless the caller asks for the
    CPU) in fp32, eval mode, holding `state`."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = ClapTextModel(cfg)
    model.load_state_dict({k: v.to(dev, torch.float32) for k, v in state.items()},
                          assign=True)
    return model.eval().requires_grad_(False)


def random_init(cfg: ClapTextConfig, generator: torch.Generator) -> StateDict:
    """Random weights (tests, the card's drive) as a ClapTextModel state
    dict on the generator's device: normal / sqrt(fan_in) products and
    tables, unit LayerNorm scales, zero biases."""
    dev = generator.device
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in ClapTextModel(cfg).state_dict().items()}
    state: StateDict = {}
    for name, shape in shapes.items():
        if name.endswith(".bias"):
            state[name] = torch.zeros(shape, device=dev)
        elif ".n1." in name or ".n2." in name or name.startswith("ln."):
            state[name] = torch.ones(shape, device=dev)
        else:  # a Linear's [out, in] or an embedding table's [n, hidden]
            state[name] = torch.randn(shape, generator=generator, device=dev) / math.sqrt(shape[-1])
    return state


# ---------------------------------------------------------------------------
# HF import and export
# ---------------------------------------------------------------------------


def text_config_from_hf(text_cfg) -> ClapTextConfig:
    """A transformers ClapTextConfig (or any object with its attributes) ->
    ClapTextConfig."""
    return ClapTextConfig(
        vocab_size=text_cfg.vocab_size,
        hidden_size=text_cfg.hidden_size,
        num_layers=text_cfg.num_hidden_layers,
        num_heads=text_cfg.num_attention_heads,
        intermediate_size=text_cfg.intermediate_size,
        max_position_embeddings=text_cfg.max_position_embeddings,
        type_vocab_size=text_cfg.type_vocab_size,
        pad_token_id=text_cfg.pad_token_id,
        layer_norm_eps=text_cfg.layer_norm_eps,
        projection_dim=getattr(text_cfg, "projection_dim", 512),
        projection_act=getattr(text_cfg, "projection_hidden_act", "relu"),
    )


# ClapTextModel state-dict names -> ClapTextModelWithProjection's
_HF_TOP = {
    "word.weight": "text_model.embeddings.word_embeddings.weight",
    "position.weight": "text_model.embeddings.position_embeddings.weight",
    "token_type.weight": "text_model.embeddings.token_type_embeddings.weight",
    "ln.weight": "text_model.embeddings.LayerNorm.weight",
    "ln.bias": "text_model.embeddings.LayerNorm.bias",
    "pooler.weight": "text_model.pooler.dense.weight",
    "pooler.bias": "text_model.pooler.dense.bias",
    "proj1.weight": "text_projection.linear1.weight",
    "proj1.bias": "text_projection.linear1.bias",
    "proj2.weight": "text_projection.linear2.weight",
    "proj2.bias": "text_projection.linear2.bias",
}
_HF_LAYER = {
    "proj": "attention.output.dense",
    "n1": "attention.output.LayerNorm",
    "fc1": "intermediate.dense",
    "fc2": "output.dense",
    "n2": "output.LayerNorm",
}
_QKV = ("query", "key", "value")


def text_params_from_hf(sd: Mapping[str, Any], cfg: ClapTextConfig) -> StateDict:
    """HF ClapTextModelWithProjection state dict (tensors or numpy) -> a
    ClapTextModel state dict of fp32 CPU tensors (q, k and v fused)."""

    def g(key):
        return torch.as_tensor(sd[key]).float()

    state = {ours: g(theirs) for ours, theirs in _HF_TOP.items()}
    for li in range(cfg.num_layers):
        pre = f"text_model.encoder.layer.{li}"
        for kind in ("weight", "bias"):
            state[f"layers.{li}.qkv.{kind}"] = torch.cat(
                [g(f"{pre}.attention.self.{n}.{kind}") for n in _QKV])
            for ours, theirs in _HF_LAYER.items():
                state[f"layers.{li}.{ours}.{kind}"] = g(f"{pre}.{theirs}.{kind}")
    return state


def hf_state_dict_from_text_params(state: Mapping[str, torch.Tensor],
                                   cfg: ClapTextConfig) -> StateDict:
    """The inverse of `text_params_from_hf`: HF key names, q/k/v apart,
    contiguous fp32 CPU tensors."""
    out = {theirs: state[ours] for ours, theirs in _HF_TOP.items()}
    h = cfg.hidden_size
    for li in range(cfg.num_layers):
        pre = f"text_model.encoder.layer.{li}"
        for kind in ("weight", "bias"):
            for n, part in zip(_QKV, state[f"layers.{li}.qkv.{kind}"].split(h)):
                out[f"{pre}.attention.self.{n}.{kind}"] = part
            for ours, theirs in _HF_LAYER.items():
                out[f"{pre}.{theirs}.{kind}"] = state[f"layers.{li}.{ours}.{kind}"]
    return {k: v.detach().to("cpu", torch.float32).contiguous() for k, v in out.items()}


def hf_text_config(cfg: ClapTextConfig) -> Dict[str, Any]:
    """A ClapTextModelWithProjection config.json for `cfg`."""
    return {
        "architectures": ["ClapTextModelWithProjection"],
        "model_type": "clap_text_model",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "type_vocab_size": cfg.type_vocab_size,
        "pad_token_id": cfg.pad_token_id,
        "layer_norm_eps": cfg.layer_norm_eps,
        "projection_dim": cfg.projection_dim,
        "projection_hidden_act": cfg.projection_act,
        "hidden_act": "gelu",
    }


def save_clap_text_checkpoint(path: str, cfg: ClapTextConfig,
                              state: Mapping[str, torch.Tensor]) -> str:
    """Write an HF-layout directory: `model.safetensors` (fp32) and
    `config.json`. Returns `path`."""
    os.makedirs(path, exist_ok=True)
    write_safetensors(os.path.join(path, "model.safetensors"),
                      hf_state_dict_from_text_params(state, cfg))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_text_config(cfg), f, indent=1)
    return path


def load_clap_text_encoder(path: str, device: Device = "cuda") -> Tuple[ClapTextConfig, ClapTextModel]:
    """HF CLAP checkpoint dir/file -> (ClapTextConfig, the model on
    `device`). Accepts ClapTextModelWithProjection exports and full
    ClapModel checkpoints. Without a config.json the config is RoBERTa-base's."""
    dev = resolve_device(device)
    sd = load_hf_state_dict(path)
    if not any(k.startswith("text_model.") for k in sd):
        sd = {
            k.split(".", 1)[1]: v
            for k, v in sd.items()
            if k.startswith(("clap.text", "model.text"))
        } or sd
    cfg_path = os.path.join(path, "config.json") if os.path.isdir(path) else None
    if cfg_path and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = json.load(f)
        text_raw = raw.get("text_config", raw)
        fields = {k: text_raw.get(k, v) for k, v in CLAP_TEXT_DEFAULTS.items()}
        cfg = text_config_from_hf(types.SimpleNamespace(**fields))
    else:
        cfg = ClapTextConfig.base()
    return cfg, build_text_model(cfg, text_params_from_hf(sd, cfg), dev)


def hashed_token_ids(texts, max_len: int, vocab_size: int, pad_id: int) -> np.ndarray:
    """The deterministic fallback tokenizer: <s>, crc32-hashed lowercase
    words, </s>, then padding ([N, max_len] int32)."""
    ids = np.full((len(texts), max_len), pad_id, np.int32)
    for r, t in enumerate(texts):
        words = str(t).lower().split()[: max_len - 2]
        ids[r, 0] = 0  # <s>
        for c, w in enumerate(words):
            ids[r, c + 1] = 2 + (zlib.crc32(w.encode()) % (vocab_size - 2))
        ids[r, len(words) + 1] = 2  # </s>
    return ids


def make_text_embedder(path: str, batch_size: int = 32, max_len: int = 77,
                       device: Device = "cuda"):
    """texts -> L2-normalized [N, D] numpy embeddings, the tower on `device`
    (the GPU unless the caller asks for the CPU): the drop-in embedder for
    `evaluation/harness.py --embedder clap`. Tokenizes with the checkpoint's
    own tokenizer where it ships one that loads, else with the
    deterministic hashed word tokenizer (keeps the harness runnable,
    clearly lower quality)."""
    dev = resolve_device(device)
    cfg, model = load_clap_text_encoder(path, dev)
    # RoBERTa position ids run up to seq_len + pad_id: cap the window so
    # they stay inside the position table
    max_len = min(max_len, cfg.max_position_embeddings - cfg.pad_token_id - 1)

    tok = None
    if os.path.isdir(path) and any(os.path.exists(os.path.join(path, n))
                                   for n in _TOKENIZER_FILES):
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        except Exception:  # noqa: BLE001 — tokenizers that do not load fall back
            pass

    def tokenize(texts):
        if tok is not None:
            out = tok(list(texts), padding="max_length", truncation=True,
                      max_length=max_len)
            return np.asarray(out["input_ids"], np.int32)
        return hashed_token_ids(texts, max_len, cfg.vocab_size, cfg.pad_token_id)

    def embedder(texts):
        texts = list(texts)
        out = []
        for i in range(0, len(texts), batch_size):
            ids = tokenize(texts[i : i + batch_size])
            out.append(clap_text_embed(model, ids).cpu().numpy())
        vecs = np.concatenate(out, axis=0)
        return vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-9)

    embedder.model, embedder.tokenize = model, tokenize
    return embedder
