"""LLark multimodal model: audio projector + vectorized splice + decoder
(counterpart of llark_tpu/models/fusion.py:40-155).

The splice is a masked gather, as in the JAX package:

  patch_mask[b, s] = input_ids[b, s] == audio_patch_id
  frame_idx[b, s]  = cumsum(patch_mask)[b, s] - 1        (clipped)
  embeds[b, s]     = patch_mask ? projected_audio[b, frame_idx] : token_embed
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.models.decoder import (
    Params,
    decoder_forward,
    embed_tokens,
    init_decoder_params,
    torch_dtype,
)


def init_llark_params(
    cfg: ModelConfig,
    seed: Union[int, torch.Generator] = 0,
    device: Union[str, torch.device] = "cuda",
) -> Params:
    """Decoder params + the single-linear multimodal projector
    (reference: m2t/models/llamav2.py:60-93 `initialize_adapter_modules`),
    drawn on `device` from a generator seeded with `seed` (or from the
    given torch.Generator, which must live on `device`)."""
    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    params = init_decoder_params(cfg, gen, dev)
    pdt = torch_dtype(cfg.param_dtype)
    kernel = torch.randn(
        (cfg.mm_hidden_size, cfg.hidden_size), generator=gen, device=dev, dtype=torch.float32
    )
    params["mm_projector"] = {
        "kernel": kernel.mul_(cfg.mm_hidden_size ** -0.5).to(pdt),
        "bias": torch.zeros((cfg.hidden_size,), dtype=pdt, device=dev),
    }
    return params


def project_audio(cfg: ModelConfig, params: Params, audio_encodings: torch.Tensor) -> torch.Tensor:
    """[B, T, mm_hidden] -> [B, T, hidden] in compute dtype."""
    dtype = torch_dtype(cfg.dtype)
    w = params["mm_projector"]["kernel"].to(dtype)
    b = params["mm_projector"]["bias"].to(dtype)
    return torch.matmul(audio_encodings.to(dtype), w) + b


def splice_audio_embeddings(
    token_embeds: torch.Tensor,  # [B, S, H]
    audio_embeds: torch.Tensor,  # [B, T, H]
    input_ids: torch.Tensor,  # [B, S]
    audio_patch_id: int,
    audio_frame_counts: Optional[torch.Tensor] = None,  # [B] valid frames per row
) -> torch.Tensor:
    """Replace `<audio_patch>` embedding slots with projected audio frames."""
    patch_mask = input_ids == audio_patch_id  # [B, S]
    frame_idx = torch.cumsum(patch_mask.long(), dim=1) - 1
    frame_idx = frame_idx.clamp(0, audio_embeds.shape[1] - 1)
    gathered = torch.gather(
        audio_embeds, 1, frame_idx[..., None].expand(-1, -1, audio_embeds.shape[2])
    )
    if audio_frame_counts is not None:
        # patch slots beyond a row's frame count keep the token embedding
        patch_mask = patch_mask & (frame_idx < audio_frame_counts.to(frame_idx.device)[:, None])
    return torch.where(patch_mask[..., None], gathered.to(token_embeds.dtype), token_embeds)


def build_inputs_embeds(
    cfg: ModelConfig,
    params: Params,
    input_ids: torch.Tensor,
    audio_encodings: Optional[torch.Tensor],
    audio_patch_id: int,
    audio_frame_counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Token embeddings with audio frames spliced in at patch positions."""
    token_embeds = embed_tokens(cfg, params, input_ids)
    if audio_encodings is None:
        return token_embeds
    audio_embeds = project_audio(cfg, params, audio_encodings)
    return splice_audio_embeddings(
        token_embeds, audio_embeds, input_ids, audio_patch_id, audio_frame_counts
    )


def llark_forward(
    cfg: ModelConfig,
    params: Params,
    input_ids: torch.Tensor,  # [B, S]
    *,
    audio_encodings: Optional[torch.Tensor] = None,  # [B, T, mm_hidden]
    audio_patch_id: int,
    audio_frame_counts: Optional[torch.Tensor] = None,
    seq_lengths: Optional[torch.Tensor] = None,
    kv_cache: Optional[Params] = None,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full multimodal forward (reference: WrappedLlamav2ForCausalLM.forward)."""
    inputs_embeds = build_inputs_embeds(
        cfg, params, input_ids, audio_encodings, audio_patch_id, audio_frame_counts
    )
    return decoder_forward(
        cfg, params, inputs_embeds=inputs_embeds, seq_lengths=seq_lengths,
        kv_cache=kv_cache, return_hidden=return_hidden,
    )
