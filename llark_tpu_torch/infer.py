"""Inference: build a prompt conversation, cut it at '\\n### Assistant:',
generate one request at a time with the KV-cache Generator, or stream many
through the continuous-batching server (counterpart of llark_tpu/infer.py;
parity target m2t/infer.py:99-152).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from llark_tpu_torch.conversation import concat_audio_token_and_prompt, format_conversation
from llark_tpu_torch.generate import Generator
from llark_tpu_torch.tokenization import (
    TokenizerBundle,
    expand_conversation_audio,
    extract_prompt_tokens,
    prompt_end_token_sequence,
)

EMPTY_RESPONSE = "<empty>"


def build_prompt_ids(
    prompt: str,
    num_audio_frames: int,
    bundle: TokenizerBundle,
    audio_first: bool = True,
    use_audio_start_end: bool = True,
) -> List[int]:
    """Token ids ending exactly at '\\n### Assistant:'."""
    turns = [
        {"from": "human", "value": concat_audio_token_and_prompt(prompt, audio_first)},
        {"from": "gpt", "value": EMPTY_RESPONSE},
    ]
    turns = expand_conversation_audio(turns, num_audio_frames, use_audio_start_end)
    conv_text, _ = format_conversation(turns)
    ids = bundle.encode(conv_text, truncate=False)
    return extract_prompt_tokens(ids, prompt_end_token_sequence(bundle))


def _normalize_encoding(
    audio_encoding: np.ndarray, max_audio_frames: Optional[int]
) -> np.ndarray:
    """[T, mm] or [1, T, mm] -> f32 [T', mm], frame-capped."""
    enc = np.asarray(audio_encoding, np.float32)
    if enc.ndim == 3 and enc.shape[0] == 1:
        enc = enc[0]
    if max_audio_frames is not None:
        enc = enc[:max_audio_frames]
    return enc


def infer_with_prompt(
    prompt: str,
    audio_encoding: np.ndarray,  # [T, mm] (or [1, T, mm])
    generator: Generator,
    bundle: TokenizerBundle,
    *,
    audio_first: bool = True,
    max_audio_frames: Optional[int] = None,
    pad_to: Optional[int] = None,
    rng: Optional[torch.Generator] = None,
) -> str:
    """Generate a completion for one (prompt, audio) pair on the
    generator's device. Returns text."""
    enc = _normalize_encoding(audio_encoding, max_audio_frames)
    t = enc.shape[0]
    ids = build_prompt_ids(prompt, t, bundle, audio_first)
    s = pad_to or int(np.ceil(len(ids) / 128) * 128)
    if len(ids) > s:
        raise ValueError(f"prompt ({len(ids)} tokens) longer than pad_to={s}")
    input_ids = np.full((1, s), bundle.pad_token_id, np.int32)
    input_ids[0, : len(ids)] = ids
    out = generator.generate(
        input_ids,
        np.array([len(ids)], np.int32),
        enc[None, ...],
        np.array([t], np.int32),
        tokenizer=bundle.tokenizer,
        rng=rng,
    )[0]
    return bundle.decode(out, skip_special_tokens=True).strip()


def batch_infer(
    rows: Sequence[Dict],
    generator: Generator,
    bundle: TokenizerBundle,
    *,
    prompt_override: Optional[str] = None,
    max_audio_frames: Optional[int] = None,
    seed: int = 0,
) -> List[Dict]:
    """Run inference over rows of {example_id, prompt?, response?,
    audio_encoding}. Returns CSV-ready dicts (reference:
    scripts/inference/infer_from_webdataset.py:82-151). Row i samples from
    its own generator seeded with seed + i, so identical rows draw
    independent samples at temperature > 0."""
    results = []
    for i, row in enumerate(rows):
        prompt = prompt_override or row.get("prompt") or "Describe the audio."
        rng = torch.Generator(device=generator.device)
        rng.manual_seed(seed + i)
        completion = infer_with_prompt(
            prompt, row["audio_encoding"], generator, bundle,
            max_audio_frames=max_audio_frames, rng=rng,
        )
        results.append(
            {
                "example_id": row.get("example_id", ""),
                "prompt": prompt,
                "response": row.get("response", ""),
                "model_completion": completion,
            }
        )
    return results


def _common_prompt_prefix(
    id_lists: Sequence[np.ndarray], audio_patch_id: int, min_len: int = 8
) -> Optional[np.ndarray]:
    """Longest common token prefix across prompts, clamped to text-only
    (audio tokens belong to suffixes) and to leave every request at least
    one suffix token (llark_tpu/infer.py:130-150). None when shorter than
    `min_len`. Paged callers pass min_len=max(8, kv_block_size): sharing
    rides whole pool blocks, so a sub-block prefix has nothing to share."""
    lcp = np.asarray(id_lists[0], np.int32)
    for ids in id_lists[1:]:
        ids = np.asarray(ids, np.int32)
        n = min(len(lcp), len(ids))
        neq = np.nonzero(lcp[:n] != ids[:n])[0]
        lcp = lcp[: int(neq[0]) if neq.size else n]
    ap = np.nonzero(lcp == audio_patch_id)[0]
    if ap.size:
        lcp = lcp[: int(ap[0])]
    lcp = lcp[: min(len(ids_) for ids_ in id_lists) - 1]
    return lcp if len(lcp) >= min_len else None


def batch_infer_continuous(
    rows: Sequence[Dict],
    cfg,
    params,
    bundle: TokenizerBundle,
    *,
    gen_cfg=None,
    max_batch: int = 4,
    max_cache_len: int = 2048,
    prompt_buckets=(128, 512),
    max_audio_frames: int = 256,
    prompt_override: Optional[str] = None,
    prefill_chunk: Optional[int] = None,
    draft_cfg=None,
    draft_params=None,
    gamma: int = 4,
    spec_rounds: int = 2,
    prefix_cache: bool = False,
    spec_mode: Optional[str] = None,  # "ngram": draft-free host proposals
    kv_block_size: Optional[int] = None,
    kv_pool_blocks: Optional[int] = None,
    admit_batch: Optional[int] = None,
    admit_min_fill: int = 1,
    admit_max_wait_s: float = 0.05,
    admit_reorder: bool = False,
    admit_reorder_age_s: float = 0.5,
    decode_chunk: int = 8,
    decode_chunk_drain: Optional[int] = None,
    drain_max_active: Optional[int] = None,
    allow_divergent_spec: bool = False,  # opt into sub-fp32 speculation
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
) -> List[Dict]:
    """batch_infer through the continuous-batching engine
    (llark_tpu/infer.py:153-253): all rows stream through `max_batch`
    decode slots instead of generating one at a time. Same CSV-ready output
    as batch_infer.

    prefix_cache: the longest common token prefix of all prompts (every
    LLark prompt opens with the same conversation header) is prefilled
    once and admission computes only each request's suffix. `draft_cfg` /
    `draft_params` or `spec_mode="ngram"` serve speculatively
    (inference/speculative.py)."""
    from llark_tpu_torch.generate import GenerationConfig
    from llark_tpu_torch.inference.server import BatchedServer, Request

    requests: List[Request] = []
    prompts: List[str] = []
    for row in rows:
        prompt = prompt_override or row.get("prompt") or "Describe the audio."
        enc = _normalize_encoding(row["audio_encoding"], max_audio_frames)
        ids = build_prompt_ids(prompt, enc.shape[0], bundle, audio_first=True)
        requests.append(Request(np.asarray(ids, np.int32), enc))
        prompts.append(prompt)

    shared_prefix = None
    if prefix_cache and requests:
        shared_prefix = _common_prompt_prefix(
            [r.input_ids for r in requests], bundle.audio_patch_id,
            min_len=max(8, kv_block_size or 0),
        )
    server = BatchedServer(
        cfg, params, bundle.audio_patch_id, gen_cfg or GenerationConfig(),
        max_batch=max_batch, max_cache_len=max_cache_len, prompt_buckets=prompt_buckets,
        max_audio_frames=max_audio_frames, prefill_chunk=prefill_chunk,
        tokenizer=bundle.tokenizer, draft_cfg=draft_cfg, draft_params=draft_params,
        gamma=gamma, spec_rounds=spec_rounds, allow_divergent_spec=allow_divergent_spec,
        shared_prefix_ids=shared_prefix, spec_mode=spec_mode, kv_block_size=kv_block_size,
        kv_pool_blocks=kv_pool_blocks, admit_batch=admit_batch,
        admit_min_fill=admit_min_fill, admit_max_wait_s=admit_max_wait_s,
        admit_reorder=admit_reorder, admit_reorder_age_s=admit_reorder_age_s,
        decode_chunk=decode_chunk, decode_chunk_drain=decode_chunk_drain,
        drain_max_active=drain_max_active, device=device, seed=seed,
    )
    server.serve(requests)
    return [
        {
            "example_id": row.get("example_id", ""),
            "prompt": prompt,
            "response": row.get("response", ""),
            "model_completion": bundle.decode(req.tokens, skip_special_tokens=True).strip(),
        }
        for row, prompt, req in zip(rows, prompts, requests)
    ]
