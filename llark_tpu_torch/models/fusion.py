"""LLark multimodal model: audio projector + vectorized splice + decoder,
and the training losses (counterpart of llark_tpu/models/fusion.py).

The splice is a masked gather, as in the JAX package:

  patch_mask[b, s] = input_ids[b, s] == audio_patch_id
  frame_idx[b, s]  = cumsum(patch_mask)[b, s] - 1        (clipped)
  embeds[b, s]     = patch_mask ? projected_audio[b, frame_idx] : token_embed

The "tune only new token embeddings" trick (reference llamav2.py:176-198
detaches original-vocab embedding rows) detaches the looked-up embeddings
of ids below `trainable_token_start`.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.models.decoder import (
    Params,
    compute_logits,
    decoder_forward,
    embed_tokens,
    init_decoder_params,
    torch_dtype,
)
from llark_tpu_torch.parallel import comm
from llark_tpu_torch.special_tokens import IGNORE_INDEX


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
    """[B, T, mm_hidden] -> [B, T, hidden] in compute dtype. On a sharded
    config the kernel is gathered whole first (over "fsdp", then over
    "tensor", whose ranks compute the same splice)."""
    dtype = torch_dtype(cfg.dtype)
    w = params["mm_projector"]["kernel"]
    shard = getattr(cfg, "shard", None)
    if shard is not None:
        w = comm.gather(comm.gather(w, 0, shard.group("fsdp")), 1, shard.group("tensor"),
                        backward="split")
    w = w.to(dtype)
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
    trainable_token_start: Optional[int] = None,
) -> torch.Tensor:
    """Token embeddings with audio frames spliced in at patch positions.
    Embeddings of ids below `trainable_token_start` carry no gradient to
    the table (llark_tpu/models/fusion.py:94-119)."""
    token_embeds = embed_tokens(cfg, params, input_ids)
    if trainable_token_start is not None:
        frozen = (input_ids < trainable_token_start)[..., None]
        token_embeds = torch.where(frozen, token_embeds.detach(), token_embeds)
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
    trainable_token_start: Optional[int] = None,
    return_hidden: bool = False,
    dropout_seed=None,  # LoRA dropout (training): a seed or `DropoutDraws`
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full multimodal forward (reference: WrappedLlamav2ForCausalLM.forward)."""
    inputs_embeds = build_inputs_embeds(
        cfg, params, input_ids, audio_encodings, audio_patch_id, audio_frame_counts,
        trainable_token_start,
    )
    return decoder_forward(
        cfg, params, inputs_embeds=inputs_embeds, seq_lengths=seq_lengths,
        kv_cache=kv_cache, return_hidden=return_hidden,
        trainable_token_start=trainable_token_start, dropout_seed=dropout_seed,
    )


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Summed negative log-likelihood of `targets` (IGNORE_INDEX skipped)
    under fp32 `logits` [..., V]."""
    return F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(), targets.reshape(-1).long(),
        ignore_index=IGNORE_INDEX, reduction="sum",
    )


def causal_lm_loss(
    logits: torch.Tensor,  # [B, S, V] (fp32 from compute_logits)
    labels: torch.Tensor,  # [B, S] with IGNORE_INDEX on masked positions
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift-by-one cross-entropy ignoring IGNORE_INDEX (reference:
    m2t/models/llamav2.py:314-325; llark_tpu/models/fusion.py:158-172).
    Returns (mean loss over valid tokens, number of valid tokens)."""
    targets = labels[:, 1:]
    n_valid = (targets != IGNORE_INDEX).sum()
    return _nll_sum(logits[:, :-1], targets) / n_valid.clamp_min(1), n_valid


def chunked_causal_lm_loss(
    cfg: ModelConfig,
    params: Params,
    hidden: torch.Tensor,  # [B, S, H] final decoder hidden states
    labels: torch.Tensor,  # [B, S]
    chunk: int = 512,
    trainable_token_start: Optional[int] = None,  # tied-LM-head freeze boundary
) -> Tuple[torch.Tensor, torch.Tensor]:
    """causal_lm_loss without the [B, S, V] logits: the LM head and the
    cross-entropy run one sequence chunk at a time, each chunk a
    torch.utils.checkpoint segment whose logits are recomputed in the
    backward (llark_tpu/models/fusion.py:175-217)."""
    b, s, _ = hidden.shape
    if s % chunk:
        raise ValueError(f"sequence {s} must divide loss chunk {chunk}")
    # next-token targets aligned to each position; final position ignored
    targets = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], IGNORE_INDEX)], dim=1)

    def chunk_nll(h_c, y_c):
        return _nll_sum(compute_logits(cfg, params, h_c, trainable_token_start), y_c)

    total = hidden.new_zeros((), dtype=torch.float32)
    for c in range(0, s, chunk):
        h_c, y_c = hidden[:, c : c + chunk], targets[:, c : c + chunk]
        if torch.is_grad_enabled():
            total = total + torch.utils.checkpoint.checkpoint(
                chunk_nll, h_c, y_c, use_reentrant=False
            )
        else:
            total = total + chunk_nll(h_c, y_c)
    n_valid = (targets != IGNORE_INDEX).sum()
    return total / n_valid.clamp_min(1), n_valid
