"""Generation: prefill + chunked KV-cached decode (counterpart of
llark_tpu/generate.py).

  * prefill: one multimodal forward over the right-padded prompt that
    fills an empty KV cache (the flash-prefill kernel attends S x S over
    the in-flight K/V) and returns the next-token logits of each row; as
    one program (`PrefillProgram`, the reference's jitted
    `make_prefill_fn`) it is a CUDA graph on the card, one per shape. The
    serving engine's admission steps (chunks, the chunked prefill's tail,
    suffixes over a shared prefix) are programs too (`make_*_fn` below);
  * decode: `decode_chunk` single-token steps as one program
    (`DecodeProgram`, the reference's `make_multistep_decode_fn`): on the
    card a CUDA graph captured once and replayed for every chunk, sampling
    on the device from an explicit torch.Generator; the host reads the
    chunk's [B, n] tokens once, not once per token. `decode_n` is the same
    chunk issued op by op from Python: the CPU route, and the plain version
    a replay is held against;
  * stopping: EOS, max length, and the reference's `###` keyword check on
    the host over the decoded ids (reference: m2t/generate.py:18-44).

Row i's token at decode step t sits at cache position prompt_len[i] + t
and attends to [0, that position], so prompt padding never pollutes
attention.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.graphs import GraphPool, Program, cache_tensors
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
    cache: Optional[Params] = None,
) -> Tuple[torch.Tensor, Params]:
    """Fill an empty KV cache with the prompt -> (next-token logits [B, V],
    cache) (llark_tpu/generate.py:66-96). With `cache` (a dense cache of B
    rows and max_cache_len positions) the prompt is written into its
    tensors from position 0, in place, and nothing is allocated: a captured
    decode program replays on the tensors it was captured on. What an
    earlier prompt left past this one's live lengths is masked out of
    every attention (a zero weight; the kernels do not read it)."""
    b, s = input_ids.shape
    inputs_embeds = build_inputs_embeds(
        cfg, params, input_ids, audio_encodings, audio_patch_id, audio_frame_counts
    )
    if cache is None:
        cache = init_kv_cache(cfg, b, max_cache_len, device=input_ids.device)
    else:
        if tuple(cache["k"].shape[1::2]) != (b, max_cache_len):
            raise ValueError(
                f"a cache of {tuple(cache['k'].shape)} cannot take {b} rows of "
                f"{max_cache_len} positions"
            )
        cache = dict(cache, index=0)
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
    chunk_start: Union[int, torch.Tensor, None] = None,
) -> Params:
    """Extend a dense cache by one chunk of fused prompt embeddings at
    `chunk_start` (default: the cache's index), skipping the LM head
    (llark_tpu/generate.py:99-117): the server's chunked admission, which
    interleaves decode rounds with long-prompt prefills. The offset is an
    int or a [B] int32 device tensor, as the reference's index is traced:
    it goes through the decoder's per-row `cache_positions` route, with the
    plain attention over the cache at every chunk length, so one captured
    program serves every chunk of a bucket."""
    if not torch.is_tensor(chunk_start):
        start = cache["index"] if chunk_start is None else chunk_start
        chunk_start = torch.full((embeds.shape[0],), start, dtype=torch.int32,
                                 device=embeds.device)
    _, cache = decoder_lib.decoder_forward(
        dataclasses.replace(cfg, use_flash_decode=False), params, inputs_embeds=embeds,
        seq_lengths=prompt_lengths, kv_cache=cache, cache_positions=chunk_start,
        return_hidden=True,
    )
    return cache


def paged_prefill_chunk(
    cfg: ModelConfig,
    params: Params,
    embeds: torch.Tensor,  # [B, C, H], C a multiple of the KV block size
    prompt_lengths: torch.Tensor,  # [B] absolute live lengths
    cache: Params,  # paged, tables cropped to each row's admission span
    chunk_start: Union[int, torch.Tensor],  # a multiple of the KV block size
) -> Params:
    """One block-aligned chunk written straight into the pool blocks the
    cache's block tables name (llark_tpu/generate.py:120-146): no dense
    admission cache and no block insert afterwards. `chunk_start` is an int
    or a [B] int32 device tensor, as in `prefill_chunk`."""
    if not torch.is_tensor(chunk_start):
        chunk_start = torch.full((embeds.shape[0],), chunk_start, dtype=torch.int32,
                                 device=embeds.device)
    _, cache = decoder_lib.decoder_forward(
        cfg, params, inputs_embeds=embeds, seq_lengths=prompt_lengths, kv_cache=cache,
        cache_positions=chunk_start, return_hidden=True, paged_chunk=True,
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


# ---------------------------------------------------------------------------
# Compiled prefill and admission programs: the reference's jax.jit of each
# factory below, as `graphs.Program`s (one CUDA graph each on the card). A
# program serves one batch and shape and binds to the tensors it writes;
# `plain` is its eager route, with the same signature.
# ---------------------------------------------------------------------------


class PrefillProgram(Program):
    """`prefill` as one program (llark_tpu/generate.py:66-96, jitted per
    shape at :306): (params, input_ids [B, S], prompt_lengths [B], audio
    [B, T, mm], frame_counts [B], cache=None) -> (next-token logits [B, V],
    cache). It binds to the cache of its first call (a dense cache of B rows
    and max_cache_len positions; without one it makes its own) and fills it
    from position 0 at every call; the logits are its own buffer. One
    program serves one (B, S, T)."""

    what = "prefill"

    def __init__(self, cfg: ModelConfig, audio_patch_id: int, max_cache_len: int,
                 pool: Optional[GraphPool] = None):
        super().__init__(pool)
        self.cfg, self.audio_patch_id, self.max_cache_len = cfg, audio_patch_id, max_cache_len

    def plain(self, params, input_ids, prompt_lengths, audio_encodings, audio_frame_counts,
              cache=None):
        return prefill(self.cfg, params, input_ids, prompt_lengths, audio_encodings,
                       audio_frame_counts, self.audio_patch_id, self.max_cache_len, cache)

    @torch.inference_mode()
    def __call__(self, params, input_ids, prompt_lengths, audio_encodings, audio_frame_counts,
                 cache=None):
        b, s = input_ids.shape
        if cache is None:
            cache = (self._bound["cache"] if self._bound is not None else
                     init_kv_cache(self.cfg, b, self.max_cache_len, device=input_ids.device))
        self.bind(params=params, cache=cache_tensors(cache))
        x = self.stage(ids=input_ids, lengths=prompt_lengths, audio=audio_encodings,
                       frames=audio_frame_counts)
        work = dict(self._bound["cache"], index=0)
        logits, = self.run(lambda: (self.plain(params, x["ids"], x["lengths"], x["audio"],
                                               x["frames"], work)[0],), input_ids.device)
        return logits, dict(cache, index=s)


class PrefillChunkProgram(Program):
    """`prefill_chunk` as one program (llark_tpu/generate.py:99-117, jitted
    with the cache donated at llark_tpu/inference/server.py:328): (params,
    embeds [B, C, H], prompt_lengths [B], cache) -> cache with its index
    advanced by C. The chunk's offset is the cache's host-side index, which
    the call copies into a static device buffer that the body passes as
    `chunk_start`: one program serves every chunk of a bucket."""

    what = "prefill chunk"

    def __init__(self, cfg: ModelConfig, pool: Optional[GraphPool] = None):
        super().__init__(pool)
        self.cfg = cfg

    def plain(self, params, embeds, prompt_lengths, cache, chunk_start=None):
        return prefill_chunk(self.cfg, params, embeds, prompt_lengths, cache, chunk_start)

    @torch.inference_mode()
    def __call__(self, params, embeds, prompt_lengths, cache):
        b, c = embeds.shape[:2]
        self.bind(params=params, cache=cache_tensors(cache))
        x = self.stage(embeds=embeds, lengths=prompt_lengths,
                       offset=torch.full((b,), cache["index"], dtype=torch.int32,
                                         device=embeds.device))
        work = dict(self._bound["cache"], index=0)

        def body():
            self.plain(params, x["embeds"], x["lengths"], work, x["offset"])
            return ()

        self.run(body, embeds.device)
        return dict(cache, index=cache["index"] + c)


class PagedPrefillChunkProgram(Program):
    """`paged_prefill_chunk` as one program (llark_tpu/generate.py:120-146):
    (params, embeds [B, C, H], prompt_lengths [B], cache, chunk_start) ->
    cache. `chunk_start` goes into a static device buffer, so one program
    serves every chunk; the cache's block tables are bound like its pools,
    so a caller copies each admission's tables into the bound tensor."""

    what = "paged prefill chunk"

    def __init__(self, cfg: ModelConfig, pool: Optional[GraphPool] = None):
        super().__init__(pool)
        self.cfg = cfg

    def plain(self, params, embeds, prompt_lengths, cache, chunk_start):
        return paged_prefill_chunk(self.cfg, params, embeds, prompt_lengths, cache, chunk_start)

    @torch.inference_mode()
    def __call__(self, params, embeds, prompt_lengths, cache, chunk_start: int):
        b, c = embeds.shape[:2]
        self.bind(params=params, cache=cache_tensors(cache))
        x = self.stage(embeds=embeds, lengths=prompt_lengths,
                       start=torch.full((b,), chunk_start, dtype=torch.int32,
                                        device=embeds.device))
        work = dict(self._bound["cache"], index=0)

        def body():
            self.plain(params, x["embeds"], x["lengths"], work, x["start"])
            return ()

        self.run(body, embeds.device)
        return dict(cache, index=cache["index"] + c)


class PrefillLastProgram(Program):
    """`prefill_last` as one program (llark_tpu/generate.py:149-170; its
    `pos_offset` is static there too): (params, embeds [B, S, H],
    prompt_lengths [B], cache) -> (next-token logits [B, V], cache). Bound
    to a dense admission cache or to a paged pool with its tables."""

    what = "prefill tail"

    def __init__(self, cfg: ModelConfig, pos_offset: int = 0, pool: Optional[GraphPool] = None):
        super().__init__(pool)
        self.cfg, self.pos_offset = cfg, int(pos_offset)

    def plain(self, params, embeds, prompt_lengths, cache):
        return prefill_last(self.cfg, params, embeds, prompt_lengths, cache, self.pos_offset)

    @torch.inference_mode()
    def __call__(self, params, embeds, prompt_lengths, cache):
        self.bind(params=params, cache=cache_tensors(cache))
        x = self.stage(embeds=embeds, lengths=prompt_lengths)
        work = dict(self._bound["cache"], index=0)
        logits, = self.run(lambda: (self.plain(params, x["embeds"], x["lengths"], work)[0],),
                           embeds.device)
        return logits, dict(cache, index=cache["index"] + 1)


class SuffixPrefillProgram(Program):
    """`suffix_prefill` as one program (llark_tpu/generate.py:203-240,
    jitted at llark_tpu/inference/server.py:236): (params, suffix_ids
    [B, Ss], suffix_lengths [B], audio, frame_counts, cache) -> (next-token
    logits [B, V], cache). Bound to a cache seeded with the shared prefix
    and to its index, the prefix length: the suffixes are written from
    there on, so the prefix the cache was seeded with stays."""

    what = "suffix prefill"

    def __init__(self, cfg: ModelConfig, audio_patch_id: int, pool: Optional[GraphPool] = None):
        super().__init__(pool)
        self.cfg, self.audio_patch_id = cfg, audio_patch_id

    def plain(self, params, suffix_ids, suffix_lengths, audio_encodings, audio_frame_counts,
              cache):
        return suffix_prefill(self.cfg, params, suffix_ids, suffix_lengths, audio_encodings,
                              audio_frame_counts, self.audio_patch_id, cache)

    @torch.inference_mode()
    def __call__(self, params, suffix_ids, suffix_lengths, audio_encodings, audio_frame_counts,
                 cache):
        self.bind(params=params, cache=cache_tensors(cache), index=cache["index"])
        x = self.stage(ids=suffix_ids, lengths=suffix_lengths, audio=audio_encodings,
                       frames=audio_frame_counts)
        work = dict(self._bound["cache"], index=cache["index"])
        logits, = self.run(lambda: (self.plain(params, x["ids"], x["lengths"], x["audio"],
                                               x["frames"], work)[0],), suffix_ids.device)
        return logits, dict(cache, index=cache["index"] + suffix_ids.shape[1])


def make_prefill_fn(cfg: ModelConfig, audio_patch_id: int, max_cache_len: int,
                    pool: Optional[GraphPool] = None) -> PrefillProgram:
    """Prefill as one program (llark_tpu/generate.py:66-96): see
    `PrefillProgram`."""
    return PrefillProgram(cfg, audio_patch_id, max_cache_len, pool)


def make_prefill_chunk_fn(cfg: ModelConfig, pool: Optional[GraphPool] = None) -> PrefillChunkProgram:
    """One chunk of a dense chunked prefill as one program
    (llark_tpu/generate.py:99-117): see `PrefillChunkProgram`."""
    return PrefillChunkProgram(cfg, pool)


def make_paged_prefill_chunk_fn(cfg: ModelConfig,
                                pool: Optional[GraphPool] = None) -> PagedPrefillChunkProgram:
    """One block-aligned chunk straight into a paged pool as one program
    (llark_tpu/generate.py:120-146): see `PagedPrefillChunkProgram`."""
    return PagedPrefillChunkProgram(cfg, pool)


def make_prefill_last_fn(cfg: ModelConfig, pos_offset: int = 0,
                         pool: Optional[GraphPool] = None) -> PrefillLastProgram:
    """The tail of a chunked prefill as one program
    (llark_tpu/generate.py:149-170): see `PrefillLastProgram`."""
    return PrefillLastProgram(cfg, pos_offset, pool)


def make_prefix_cache_fn(cfg: ModelConfig):
    """(params, prefix_ids [B, P]) -> a dense cache holding the prefix
    (llark_tpu/generate.py:173-200): `prefix_cache`, eager. A server calls
    it once, so a capture (an eager warm-up, then the graph) would cost
    more than the one call it serves."""
    return functools.partial(prefix_cache, cfg)


def make_suffix_prefill_fn(cfg: ModelConfig, audio_patch_id: int,
                           pool: Optional[GraphPool] = None) -> SuffixPrefillProgram:
    """Suffix prefill over a seeded prefix cache as one program
    (llark_tpu/generate.py:203-240): see `SuffixPrefillProgram`."""
    return SuffixPrefillProgram(cfg, audio_patch_id, pool)


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


def make_decode_fn(cfg: ModelConfig):
    """The single-token decode step (llark_tpu/generate.py:243-262):
    (params, token [B], cache, write_positions [B]) -> (logits [B, V],
    cache). One step is not captured: the decode loops run chunks
    (`make_multistep_decode_fn`); speculation and beams call it eagerly."""
    return functools.partial(decode_step, cfg)


class DecodeProgram(Program):
    """`steps` decode steps with sampling as one program (the reference's
    `make_multistep_decode_fn`, llark_tpu/generate.py:265-287): called as
    (params, token [B], cache, write_positions [B], generator) -> (tokens
    [B, steps], last logits [B, V], cache), like `decode_n`.

    The program binds at its first call to the params tree, the batch size
    and the cache tensors (k, v, the int8 scales, a paged cache's block
    tables): a later call must pass the same ones, which hold what earlier
    writes left (prefill, admission and table refreshes write them in
    place), or it raises. A call copies the token and the write positions
    into the program's static buffers and runs the chunk; the returned
    cache is the given one with its host-side index advanced by `steps`, as
    from `decode_n`, and the returned tokens and logits are the program's
    own buffers, valid until its next call (the caller reads them first).

    On CUDA tensors the chunk is a CUDA graph, captured at the first call
    and replayed by it and every later one (`graphs.Program`); a capture
    that fails raises. At temperature > 0 the graph draws from a generator
    of its own, registered with it: a call sets its state from the
    caller's generator and hands the advanced state back, so replays draw
    new noise and the caller's generator advances as under `decode_n`.

    On CPU tensors a call runs `decode_n` on the same buffers: the CPU
    tests exercise the binding and the buffers."""

    what = "decode"

    def __init__(self, cfg: ModelConfig, gen_cfg: GenerationConfig, steps: int,
                 pool: Optional[GraphPool] = None):
        super().__init__(pool)
        self.cfg, self.gen_cfg, self.steps = cfg, gen_cfg, int(steps)
        self._generator = None  # the graph's own, at temperature > 0

    @property
    def _cache(self) -> Optional[Dict[str, torch.Tensor]]:
        """The bound cache tensors."""
        return None if self._bound is None else self._bound["cache"]

    @property
    def tokens(self) -> Optional[torch.Tensor]:
        return None if self.outputs is None else self.outputs[0]

    @property
    def logits(self) -> Optional[torch.Tensor]:
        return None if self.outputs is None else self.outputs[1]

    def plain(self, params: Params, token: torch.Tensor, cache: Params,
              write_positions: torch.Tensor, generator: Optional[torch.Generator]):
        """The eager route: `decode_n`."""
        return decode_n(self.cfg, self.gen_cfg, params, token, cache, write_positions, self.steps,
                        generator)

    @torch.inference_mode()
    def __call__(self, params: Params, token: torch.Tensor, cache: Params,
                 write_positions: torch.Tensor,
                 generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor, Params]:
        self.bind(params=params, cache=cache_tensors(cache))
        x = self.stage(token=token.long(), pos=write_positions.long())
        dev = token.device
        own = dev.type == "cuda" and self.gen_cfg.temperature > 0.0
        if own:
            if generator is None:
                raise ValueError("a sampling decode program draws from an explicit generator")
            if self._generator is None:
                self._generator = torch.Generator(device=dev)
            self._generator.set_state(generator.get_state())
        draw = self._generator if own else generator
        work = dict(self._cache, index=0)
        self.run(lambda: self.plain(params, x["token"], work, x["pos"], draw)[:2], dev,
                 (draw,) if own else ())
        if own:
            generator.set_state(self._generator.get_state())
        return self.tokens, self.logits, dict(cache, index=cache["index"] + self.steps)


def make_multistep_decode_fn(cfg: ModelConfig, gen_cfg: GenerationConfig, steps: int,
                             pool: Optional[GraphPool] = None) -> DecodeProgram:
    """N-token decode as one program (llark_tpu/generate.py:265-287): one
    CUDA graph per chunk on the card instead of every op of every step
    issued from Python. See `DecodeProgram`; programs that share `pool`
    share their graphs' memory and capture stream."""
    return DecodeProgram(cfg, gen_cfg, steps, pool)


class Generator:
    """Prefill + chunked decode over one model on one device.

    Prefills are `PrefillProgram`s, one per (batch, prompt length, audio
    frames) as the reference jits one per shape (llark_tpu/generate.py:306),
    and decode chunks `DecodeProgram`s, one per (batch size, chunk length)
    as the reference compiles one per chunk length
    (llark_tpu/generate.py:310-315); a tail chunk shorter than
    `decode_chunk` gets its own. On the card each is a CUDA graph, and the
    programs share one graph pool. A program replays on the cache it was
    captured on, so the generator keeps one cache per batch size, of
    `max_cache_len` positions, and every prefill of that batch size writes
    into it in place: the cache `prefill` returns is the generator's own,
    overwritten by its next prefill or generate, and its logits are the
    prefill program's buffer, overwritten by the next prefill of that
    shape."""

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
        self._caches: Dict[int, Params] = {}  # batch size -> its cache
        self._prefills: Dict[Tuple[int, int, int], PrefillProgram] = {}  # (batch, S, T)
        self._programs: Dict[Tuple[int, int], DecodeProgram] = {}  # (batch, chunk length)
        self._pool = GraphPool(self.device) if self.device.type == "cuda" else None

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    def _prefill_fn(self, b: int, s: int, t: int):
        """The prefill program of one (batch, prompt length, audio frames)."""
        key = (b, s, t)
        if key not in self._prefills:
            self._prefills[key] = make_prefill_fn(self.cfg, self.audio_patch_id,
                                                  self.max_cache_len, self._pool)
        return self._prefills[key]

    def _decode_chunk(self, token: torch.Tensor, cache: Params, positions: torch.Tensor,
                      n: int, rng: torch.Generator):
        """One chunk of n steps through the (batch, n) program."""
        key = (token.shape[0], n)
        if key not in self._programs:
            self._programs[key] = make_multistep_decode_fn(self.cfg, self.gen_cfg, n, self._pool)
        return self._programs[key](self.params, token, cache, positions, rng)

    @torch.inference_mode()
    def prefill(
        self,
        input_ids: np.ndarray,
        prompt_lengths: np.ndarray,
        audio_encodings: Optional[np.ndarray] = None,
        audio_frame_counts: Optional[np.ndarray] = None,
    ) -> Tuple[torch.Tensor, Params]:
        """Next-token logits [B, V] and the filled cache for a padded batch."""
        b, s = np.shape(input_ids)
        if audio_encodings is None:
            audio_encodings = np.zeros((b, 1, self.cfg.mm_hidden_size), np.float32)
            audio_frame_counts = np.zeros((b,), np.int32)
        if audio_frame_counts is None:
            audio_frame_counts = np.full((b,), np.shape(audio_encodings)[1], np.int32)
        logits, cache = self._prefill_fn(b, s, np.shape(audio_encodings)[1])(
            self.params,
            self._tensor(input_ids, torch.int64),
            self._tensor(prompt_lengths, torch.int32),
            self._tensor(audio_encodings, torch.float32),
            self._tensor(audio_frame_counts, torch.int32),
            self._caches.get(b),
        )
        self._caches.setdefault(b, cache)
        return logits, cache

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
            toks, _last_logits, cache = self._decode_chunk(
                token, cache, lengths + (emitted - 1), n, rng
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
