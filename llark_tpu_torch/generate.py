"""Generation: prefill + chunked KV-cached decode (counterpart of
llark_tpu/generate.py).

  * prefill: one multimodal forward over the right-padded prompt that
    fills an empty KV cache (the flash-prefill kernel attends S x S over
    the in-flight K/V) and returns the next-token logits of each row;
  * decode: `decode_chunk` single-token steps run back to back on the
    device, sampling on the device from an explicit torch.Generator; the
    host reads the chunk's [B, n] tokens once, not once per token;
  * stopping: EOS, max length, and the reference's `###` keyword check on
    the host over the decoded ids (reference: m2t/generate.py:18-44).

Row i's token at decode step t sits at cache position prompt_len[i] + t
and attends to [0, that position], so prompt padding never pollutes
attention.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.models import decoder as decoder_lib
from llark_tpu_torch.models.decoder import Params, init_kv_cache
from llark_tpu_torch.models.fusion import build_inputs_embeds


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 256
    temperature: float = 0.0  # 0 => greedy
    top_p: float = 1.0
    top_k: int = 0  # 0 => disabled
    eos_token_id: Optional[int] = None
    stop_text: str = "###"  # reference keyword stop
    decode_chunk: int = 8  # tokens per device chunk (one host read per chunk)


def _filter_logits(logits: torch.Tensor, cfg: GenerationConfig) -> torch.Tensor:
    """Temperature, then top-k and top-p masking (to -inf) of [B, V] logits,
    as in llark_tpu/generate.py:47-63."""
    logits = logits.float() / cfg.temperature
    if cfg.top_k > 0:
        k = min(cfg.top_k, logits.shape[-1])  # top_k > vocab degrades to no-op
        kth = torch.sort(logits, dim=-1).values[:, -k, None]
        logits = logits.masked_fill(logits < kth, -float("inf"))
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < cfg.top_p).sum(dim=-1, keepdim=True)
        cutoff_idx = cutoff_idx.clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, 1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, -float("inf"))
    return logits


def _sample(logits: torch.Tensor, cfg: GenerationConfig, generator: torch.Generator) -> torch.Tensor:
    """logits [B, V] -> token [B] (int64). Greedy at temperature 0; else a
    categorical draw by the Gumbel-max trick with noise from `generator`
    (the construction jax.random.categorical uses)."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    masked = _filter_logits(logits, cfg)
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(masked + gumbel, dim=-1)


def prefill(
    cfg: ModelConfig,
    params: Params,
    input_ids: torch.Tensor,  # [B, S] right-padded
    prompt_lengths: torch.Tensor,  # [B]
    audio_encodings: torch.Tensor,  # [B, T, mm]
    audio_frame_counts: torch.Tensor,  # [B]
    audio_patch_id: int,
    max_cache_len: int,
) -> Tuple[torch.Tensor, Params]:
    """Fill an empty KV cache with the prompt -> (next-token logits [B, V],
    cache) (llark_tpu/generate.py:66-96)."""
    b, s = input_ids.shape
    inputs_embeds = build_inputs_embeds(
        cfg, params, input_ids, audio_encodings, audio_patch_id, audio_frame_counts
    )
    cache = init_kv_cache(cfg, b, max_cache_len, device=input_ids.device)
    logits, cache = decoder_lib.decoder_forward(
        cfg, params, inputs_embeds=inputs_embeds, seq_lengths=prompt_lengths,
        kv_cache=cache, prefill_from_empty=True,
    )
    # logits at the last real prompt position of each row
    last = (prompt_lengths.long() - 1).clamp(0, s - 1)
    return logits[torch.arange(b, device=logits.device), last], cache


def prefill_chunk(
    cfg: ModelConfig,
    params: Params,
    embeds: torch.Tensor,  # [B, C, H] fused prompt embeddings of one chunk
    prompt_lengths: torch.Tensor,  # [B]
    cache: Params,
) -> Params:
    """Extend a dense cache at its index by one chunk of fused prompt
    embeddings, skipping the LM head (llark_tpu/generate.py:99-117): the
    server's chunked admission, which interleaves decode rounds with
    long-prompt prefills."""
    _, cache = decoder_lib.decoder_forward(
        cfg, params, inputs_embeds=embeds, seq_lengths=prompt_lengths, kv_cache=cache,
        return_hidden=True,
    )
    return cache


def paged_prefill_chunk(
    cfg: ModelConfig,
    params: Params,
    embeds: torch.Tensor,  # [B, C, H], C a multiple of the KV block size
    prompt_lengths: torch.Tensor,  # [B] absolute live lengths
    cache: Params,  # paged, tables cropped to each row's admission span
    chunk_start: int,  # a multiple of the KV block size
) -> Params:
    """One block-aligned chunk written straight into the pool blocks the
    cache's block tables name (llark_tpu/generate.py:120-146): no dense
    admission cache and no block insert afterwards."""
    b = embeds.shape[0]
    cpos = torch.full((b,), chunk_start, dtype=torch.int32, device=embeds.device)
    _, cache = decoder_lib.decoder_forward(
        cfg, params, inputs_embeds=embeds, seq_lengths=prompt_lengths, kv_cache=cache,
        cache_positions=cpos, return_hidden=True, paged_chunk=True,
    )
    return cache


def prefill_last(
    cfg: ModelConfig,
    params: Params,
    embeds: torch.Tensor,  # [B, S, H] the whole fused prompts (or suffixes)
    prompt_lengths: torch.Tensor,  # [B]
    cache: Params,
    pos_offset: int = 0,
) -> Tuple[torch.Tensor, Params]:
    """The tail of a chunked prefill (llark_tpu/generate.py:149-170): re-run
    each row's last prompt embedding, an idempotent cache rewrite at
    plen - 1, for the next-token logits the chunks skipped. `pos_offset`
    is the absolute cache position of embeds[:, 0]: 0, or the block-aligned
    shared-prefix length when the embeds hold only suffixes."""
    idx = (prompt_lengths.long() - 1).clamp(0, embeds.shape[1] - 1)
    last_embeds = embeds[torch.arange(embeds.shape[0], device=embeds.device), idx][:, None]
    logits, cache = decoder_lib.decoder_forward(
        cfg, params, inputs_embeds=last_embeds, kv_cache=cache,
        cache_positions=(idx + pos_offset).to(torch.int32),
    )
    return logits[:, 0, :], cache


def prefix_cache(cfg: ModelConfig, params: Params, prefix_ids: torch.Tensor) -> Params:
    """A dense cache holding exactly a shared prompt prefix [B, P], with
    index P (llark_tpu/generate.py:173-200): every LLark prompt opens with
    the same conversation header, so its KV is computed once and admission
    prefills only the per-request suffix (`suffix_prefill`)."""
    b, p = prefix_ids.shape
    dev = prefix_ids.device
    embeds = decoder_lib.embed_tokens(cfg, params, prefix_ids)
    cache = init_kv_cache(cfg, b, p, device=dev)
    _, cache = decoder_lib.decoder_forward(
        cfg, params, inputs_embeds=embeds,
        seq_lengths=torch.full((b,), p, dtype=torch.int32, device=dev), kv_cache=cache,
        prefill_from_empty=True, return_hidden=True,
    )
    return cache


def suffix_prefill(
    cfg: ModelConfig,
    params: Params,
    suffix_ids: torch.Tensor,  # [B, Ss] right-padded
    suffix_lengths: torch.Tensor,  # [B]
    audio_encodings: torch.Tensor,
    audio_frame_counts: torch.Tensor,
    audio_patch_id: int,
    cache: Params,  # its first cache["index"] positions hold the prefix
) -> Tuple[torch.Tensor, Params]:
    """Prefill per-request suffixes over a cache seeded with a shared prefix
    (llark_tpu/generate.py:203-240) -> (next-token logits [B, V], cache).
    Positions and attention windows are absolute, so with a full-precision
    cache the result is that of one-shot prefill of prefix + suffix; with an
    int8 cache the suffix attends the quantized prefix."""
    s = suffix_ids.shape[1]
    embeds = build_inputs_embeds(
        cfg, params, suffix_ids, audio_encodings, audio_patch_id, audio_frame_counts
    )
    logits, cache = decoder_lib.decoder_forward(
        cfg, params, inputs_embeds=embeds, seq_lengths=suffix_lengths + cache["index"],
        kv_cache=cache,
    )
    last = (suffix_lengths.long() - 1).clamp(0, s - 1)
    return logits[torch.arange(logits.shape[0], device=logits.device), last], cache


def decode_step(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,  # [B]
    cache: Params,
    write_positions: torch.Tensor,  # [B] absolute cache slot of the token
) -> Tuple[torch.Tensor, Params]:
    """One single-token step -> (logits [B, V], cache)
    (llark_tpu/generate.py:243-262)."""
    inputs_embeds = decoder_lib.embed_tokens(cfg, params, token[:, None])
    logits, cache = decoder_lib.decoder_forward(
        cfg, params, inputs_embeds=inputs_embeds, kv_cache=cache,
        cache_positions=write_positions,
    )
    return logits[:, 0, :], cache


def decode_n(
    cfg: ModelConfig,
    gen_cfg: GenerationConfig,
    params: Params,
    token: torch.Tensor,
    cache: Params,
    write_positions: torch.Tensor,
    steps: int,
    generator: torch.Generator,
) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """`steps` decode steps with sampling on the device, no host sync
    (llark_tpu/generate.py:265-287) -> (tokens [B, steps], last logits,
    cache)."""
    toks = []
    logits = None
    for i in range(steps):
        logits, cache = decode_step(cfg, params, token, cache, write_positions + i)
        token = _sample(logits, gen_cfg, generator)
        toks.append(token)
    return torch.stack(toks, dim=1), logits, cache


class Generator:
    """Prefill + chunked decode over one model on one device."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Params,
        audio_patch_id: int,
        gen_cfg: Optional[GenerationConfig] = None,
        max_cache_len: int = 2048,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the generator on {self.device}"
            )
        self.cfg = cfg
        self.params = params
        self.gen_cfg = gen_cfg or GenerationConfig()
        self.audio_patch_id = audio_patch_id
        self.max_cache_len = max_cache_len

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    @torch.inference_mode()
    def prefill(
        self,
        input_ids: np.ndarray,
        prompt_lengths: np.ndarray,
        audio_encodings: Optional[np.ndarray] = None,
        audio_frame_counts: Optional[np.ndarray] = None,
    ) -> Tuple[torch.Tensor, Params]:
        """Next-token logits [B, V] and the filled cache for a padded batch."""
        b = np.shape(input_ids)[0]
        if audio_encodings is None:
            audio_encodings = np.zeros((b, 1, self.cfg.mm_hidden_size), np.float32)
            audio_frame_counts = np.zeros((b,), np.int32)
        if audio_frame_counts is None:
            audio_frame_counts = np.full((b,), np.shape(audio_encodings)[1], np.int32)
        return prefill(
            self.cfg, self.params,
            self._tensor(input_ids, torch.int64),
            self._tensor(prompt_lengths, torch.int32),
            self._tensor(audio_encodings, torch.float32),
            self._tensor(audio_frame_counts, torch.int32),
            self.audio_patch_id, self.max_cache_len,
        )

    @torch.inference_mode()
    def generate(
        self,
        input_ids: np.ndarray,  # [B, S] right-padded
        prompt_lengths: np.ndarray,  # [B]
        audio_encodings: Optional[np.ndarray] = None,  # [B, T, mm]
        audio_frame_counts: Optional[np.ndarray] = None,
        tokenizer=None,  # optional: enables "###" text stopping
        rng: Optional[torch.Generator] = None,
    ) -> List[List[int]]:
        """Generate per-row token lists (without the prompt)."""
        gen_cfg = self.gen_cfg
        b, s = np.shape(input_ids)
        if s + gen_cfg.max_new_tokens > self.max_cache_len:
            raise ValueError("prompt + max_new_tokens exceeds cache length")
        if rng is None:
            rng = torch.Generator(device=self.device)
            rng.manual_seed(0)
        logits, cache = self.prefill(input_ids, prompt_lengths, audio_encodings, audio_frame_counts)
        lengths = self._tensor(prompt_lengths, torch.int64)

        done = np.zeros((b,), bool)
        out: List[List[int]] = [[] for _ in range(b)]
        eos = gen_cfg.eos_token_id
        stop_text = gen_cfg.stop_text

        def absorb(tok_col: np.ndarray) -> None:
            for i in range(b):
                if not done[i]:
                    t = int(tok_col[i])
                    if eos is not None and t == eos:
                        done[i] = True
                        continue
                    out[i].append(t)
                    if stop_text and tokenizer is not None:
                        if stop_text in tokenizer.decode(out[i][-8:]):
                            done[i] = True

        token = _sample(logits, gen_cfg, rng)
        absorb(token.cpu().numpy())
        emitted = 1
        chunk = max(1, int(gen_cfg.decode_chunk))
        while emitted < gen_cfg.max_new_tokens and not self._finished(done):
            n = min(chunk, gen_cfg.max_new_tokens - emitted)
            toks, _last_logits, cache = decode_n(
                self.cfg, gen_cfg, self.params, token, cache,
                lengths + (emitted - 1), n, rng,
            )
            tok_np = toks.cpu().numpy()  # [B, n]: the chunk's only host read
            for j in range(n):
                absorb(tok_np[:, j])
                if done.all():
                    break
            token = toks[:, -1]
            emitted += n

        if stop_text and tokenizer is not None:
            out = [self._trim_stop(ids, tokenizer, stop_text) for ids in out]
        return out

    def _finished(self, done: np.ndarray) -> bool:
        """Whether decoding stops: every row is done (a sharded generator
        agrees on it across its batch shards)."""
        return bool(done.all())

    @staticmethod
    def _trim_stop(ids: List[int], tokenizer, stop_text: str) -> List[int]:
        """Drop a trailing stop keyword from the decoded suffix
        (reference: KeywordsStoppingCriteria + response trimming)."""
        while ids and stop_text in tokenizer.decode(ids[-4:]):
            ids = ids[:-1]
        return ids
