"""Single-example inference: build a prompt conversation, cut it at
'\\n### Assistant:', generate with the KV-cache Generator (counterpart of
llark_tpu/infer.py:28-127; parity target m2t/infer.py:99-152).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

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
