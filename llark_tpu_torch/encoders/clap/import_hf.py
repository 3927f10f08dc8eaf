"""Import HF CLAP audio-tower weights into the port's HTSAT encoder;
counterpart of llark_tpu/encoders/clap/import_hf.py.

HF transformers ships laion_clap's HTSAT weights as
`ClapAudioModelWithProjection` (laion/clap-htsat-unfused). This maps that
state dict -- patch embedding, Swin stages with q/k/v fused on import,
relative-position-bias tables, patch merging, final norm, the mel
BatchNorm (an eval-mode affine) and the 2-layer projection -- onto the
parameters of `llark_tpu_torch.encoders.clap.htsat`. The checkpoint is
read by the port's own `load_hf_state_dict`, and its config.json with
`ClapAudioConfig`'s defaults copied here, so transformers is not imported.
"""

from __future__ import annotations

import json
import os
import types
from typing import Any, Dict, Mapping, Union

import torch

from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.encoders.clap.htsat import HTSATConfig
from llark_tpu_torch.interop.hf import load_hf_state_dict

Params = Dict[str, Any]

# transformers.ClapAudioConfig's defaults of the fields config_from_hf
# reads: what a config.json that leaves a field out means
CLAP_AUDIO_DEFAULTS = dict(
    spec_size=256, num_mel_bins=64, patch_size=4, patch_embeds_hidden_size=96,
    depths=[2, 2, 6, 2], num_attention_heads=[4, 8, 16, 32], window_size=8,
    mlp_ratio=4.0, projection_dim=512,
)


def config_from_hf(audio_cfg) -> HTSATConfig:
    """HTSATConfig from a transformers ClapAudioConfig (or any object with
    its attributes)."""
    return HTSATConfig(
        spec_size=audio_cfg.spec_size,
        freq_ratio=audio_cfg.spec_size // audio_cfg.num_mel_bins,
        patch_size=audio_cfg.patch_size,
        embed_dim=audio_cfg.patch_embeds_hidden_size,
        depths=tuple(audio_cfg.depths),
        num_heads=tuple(audio_cfg.num_attention_heads),
        window_size=audio_cfg.window_size,
        mlp_ratio=float(audio_cfg.mlp_ratio),
        out_dim=audio_cfg.projection_dim,
        n_mels=audio_cfg.num_mel_bins,
        n_frames=audio_cfg.spec_size * (audio_cfg.spec_size // audio_cfg.num_mel_bins),
    )


def clap_params_from_hf(sd: Mapping[str, Any], cfg: HTSATConfig,
                        device: Union[str, torch.device] = "cuda") -> Params:
    """HF ClapAudioModelWithProjection state dict (tensors or numpy) ->
    HTSAT parameters, fp32 on `device`."""
    dev = resolve_device(device)

    def g(key):
        return torch.as_tensor(sd[key]).to(device=dev, dtype=torch.float32)

    def t(key):  # an nn.Linear weight [out, in] -> [in, out]
        return g(key).T.contiguous()

    enc = "audio_model.audio_encoder"
    params: Params = {
        "mel_bn": {
            "g": g(f"{enc}.batch_norm.weight"),
            "b": g(f"{enc}.batch_norm.bias"),
            "mean": g(f"{enc}.batch_norm.running_mean"),
            "var": g(f"{enc}.batch_norm.running_var"),
        },
        "patch_embed": {
            "w": g(f"{enc}.patch_embed.proj.weight"),  # [C, 1, p, p] OIHW
            "b": g(f"{enc}.patch_embed.proj.bias"),
            "norm_g": g(f"{enc}.patch_embed.norm.weight"),
            "norm_b": g(f"{enc}.patch_embed.norm.bias"),
        },
        "stages": [],
    }
    for si, depth in enumerate(cfg.depths):
        blocks = []
        for bi in range(depth):
            pre = f"{enc}.layers.{si}.blocks.{bi}"
            attn = f"{pre}.attention.self"
            blocks.append(
                {
                    "n1_g": g(f"{pre}.layernorm_before.weight"),
                    "n1_b": g(f"{pre}.layernorm_before.bias"),
                    "qkv_w": torch.cat([t(f"{attn}.{n}.weight")
                                        for n in ("query", "key", "value")], dim=1),
                    "qkv_b": torch.cat([g(f"{attn}.{n}.bias")
                                        for n in ("query", "key", "value")]),
                    "rel_bias": g(f"{attn}.relative_position_bias_table"),
                    "proj_w": t(f"{pre}.attention.output.dense.weight"),
                    "proj_b": g(f"{pre}.attention.output.dense.bias"),
                    "n2_g": g(f"{pre}.layernorm_after.weight"),
                    "n2_b": g(f"{pre}.layernorm_after.bias"),
                    "fc1_w": t(f"{pre}.intermediate.dense.weight"),
                    "fc1_b": g(f"{pre}.intermediate.dense.bias"),
                    "fc2_w": t(f"{pre}.output.dense.weight"),
                    "fc2_b": g(f"{pre}.output.dense.bias"),
                }
            )
        stage: Params = {"blocks": blocks, "downsample": None}
        ds = f"{enc}.layers.{si}.downsample"
        if f"{ds}.reduction.weight" in sd:
            stage["downsample"] = {
                "norm_g": g(f"{ds}.norm.weight"),
                "norm_b": g(f"{ds}.norm.bias"),
                "red_w": t(f"{ds}.reduction.weight"),
            }
        params["stages"].append(stage)
    params["final_norm"] = {"g": g(f"{enc}.norm.weight"), "b": g(f"{enc}.norm.bias")}
    params["proj"] = {
        "w1": t("audio_projection.linear1.weight"),
        "b1": g("audio_projection.linear1.bias"),
        "w2": t("audio_projection.linear2.weight"),
        "b2": g("audio_projection.linear2.bias"),
    }
    return params


def load_clap_encoder(path: str, device: Union[str, torch.device] = "cuda"):
    """An HF CLAP checkpoint directory or weight file -> (HTSATConfig,
    params on `device`). Takes ClapAudioModelWithProjection exports and
    full ClapModel checkpoints (the audio tower's keys carry the same
    prefixes there). Without a config.json the config is HTSAT-base."""
    dev = resolve_device(device)
    sd = load_hf_state_dict(path)
    # full ClapModel checkpoints scope the audio tower under "clap." or not;
    # normalise to the audio_model. / audio_projection. prefixes
    if not any(k.startswith("audio_model.") for k in sd):
        sd = {
            k.split(".", 1)[1]: v
            for k, v in sd.items()
            if k.startswith(("clap.audio", "model.audio"))
        } or sd
    cfg_path = os.path.join(path, "config.json") if os.path.isdir(path) else None
    if cfg_path and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = json.load(f)
        audio_raw = raw.get("audio_config", raw)
        fields = {k: audio_raw.get(k, v) for k, v in CLAP_AUDIO_DEFAULTS.items()}
        cfg = config_from_hf(types.SimpleNamespace(**fields))
    else:
        cfg = HTSATConfig.base()
    return cfg, clap_params_from_hf(sd, cfg, dev)
