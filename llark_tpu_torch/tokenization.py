"""Tokenization, audio-token expansion and label masking.

Host-side (pure Python/numpy) and framework-free: what `infer.py` needs to
turn a prompt plus an audio frame count into the token ids the model
reads, and what the training data pipeline needs to turn a conversation
into input ids and labels. Behaviour parity targets (semantics, not code):
audio token expansion (reference m2t/data_modules.py:112-143), tokenize +
mask (reference m2t/data_modules.py:57-109, 260-283) and the prompt split
(reference m2t/tokenizer.py:41-58).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from llark_tpu_torch.conversation import (
    DEFAULT_CONVERSATION_HEADER,
    PROMPT_END_TEXT,
    format_conversation,
)
from llark_tpu_torch.special_tokens import (
    DEFAULT_AUDIO_END_TOKEN,
    DEFAULT_AUDIO_PATCH_TOKEN,
    DEFAULT_AUDIO_START_TOKEN,
    DEFAULT_AUDIO_TOKEN,
    IGNORE_INDEX,
)


def expand_audio_placeholder(
    text: str, num_audio_frames: int, use_audio_start_end: bool = True
) -> str:
    """Replace `<audio>` with `<audio_start>` + `<audio_patch>`*T + `<audio_end>`."""
    replacement = DEFAULT_AUDIO_PATCH_TOKEN * num_audio_frames
    if use_audio_start_end:
        replacement = DEFAULT_AUDIO_START_TOKEN + replacement + DEFAULT_AUDIO_END_TOKEN
    return text.replace(DEFAULT_AUDIO_TOKEN, replacement)


def expand_conversation_audio(
    turns: Sequence[Dict[str, str]],
    num_audio_frames: int,
    use_audio_start_end: bool = True,
) -> List[Dict[str, str]]:
    """Expand `<audio>` placeholders in every turn (non-mutating)."""
    return [
        {
            "from": t["from"],
            "value": expand_audio_placeholder(
                t["value"], num_audio_frames, use_audio_start_end
            ),
        }
        for t in turns
    ]


@dataclasses.dataclass
class TokenizerBundle:
    """A tokenizer plus the resolved audio special-token ids and length policy."""

    tokenizer: Any
    model_max_length: int
    pad_token_id: int
    audio_start_id: int
    audio_end_id: int
    audio_patch_id: int

    @classmethod
    def from_tokenizer(cls, tokenizer, model_max_length: Optional[int] = None):
        """Adapt an HF-style tokenizer; registers audio special tokens if absent."""
        specials = [
            DEFAULT_AUDIO_PATCH_TOKEN,
            DEFAULT_AUDIO_START_TOKEN,
            DEFAULT_AUDIO_END_TOKEN,
        ]
        existing = set(getattr(tokenizer, "get_vocab", dict)() or {})
        to_add = [s for s in specials if s not in existing]
        if to_add:
            tokenizer.add_tokens(to_add, special_tokens=True)
        if model_max_length is None:
            model_max_length = int(getattr(tokenizer, "model_max_length", 2048))
        pad_id = getattr(tokenizer, "pad_token_id", None)
        if pad_id is None:
            pad_id = 0
        return cls(
            tokenizer=tokenizer,
            model_max_length=model_max_length,
            pad_token_id=int(pad_id),
            audio_start_id=int(tokenizer.convert_tokens_to_ids(DEFAULT_AUDIO_START_TOKEN)),
            audio_end_id=int(tokenizer.convert_tokens_to_ids(DEFAULT_AUDIO_END_TOKEN)),
            audio_patch_id=int(tokenizer.convert_tokens_to_ids(DEFAULT_AUDIO_PATCH_TOKEN)),
        )

    def encode(self, text: str, truncate: bool = True) -> List[int]:
        """Tokenize one string to a list of ids (with the tokenizer's own
        special-token policy, e.g. BOS for Llama tokenizers)."""
        enc = self.tokenizer(text)
        ids = enc["input_ids"] if isinstance(enc, dict) else enc.input_ids
        if ids and isinstance(ids[0], list):  # batched return
            ids = ids[0]
        if truncate:
            ids = ids[: self.model_max_length]
        return list(ids)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        return self.tokenizer.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def nonpad_len(self, ids: Sequence[int]) -> int:
        return int(sum(1 for i in ids if i != self.pad_token_id))


def mask_labels(
    labels: np.ndarray, tokenized_lens: Sequence[int], speakers: Sequence[str]
) -> np.ndarray:
    """Apply IGNORE_INDEX to the header and (most of) each human turn.

    The reference masking rule: the header is fully masked; for human turns,
    positions [start+2, start+len) are masked -- the first two tokens of the
    '### Human:' tag are left unmasked (reference m2t/data_modules.py:81-89;
    quirk kept for loss parity).
    """
    labels = labels.copy()
    cur = tokenized_lens[0]
    labels[:cur] = IGNORE_INDEX
    for tlen, speaker in zip(tokenized_lens[1:], speakers):
        if speaker == "human":
            labels[cur + 2 : cur + tlen] = IGNORE_INDEX
        cur += tlen
    return labels


def preprocess_conversation(
    turns: Sequence[Dict[str, str]],
    bundle: TokenizerBundle,
    header: str = DEFAULT_CONVERSATION_HEADER,
) -> Dict[str, np.ndarray]:
    """Format, tokenize, and mask one conversation.

    Returns {"input_ids": int32 [S], "labels": int32 [S]} with S <= max length.
    """
    conversation, rendered = format_conversation(turns, header)
    input_ids = np.asarray(bundle.encode(conversation), dtype=np.int32)
    piece_lens = [bundle.nonpad_len(bundle.encode(piece)) for piece in [header] + rendered]
    speakers = [t["from"] for t in turns]
    labels = mask_labels(input_ids.copy(), piece_lens, speakers)
    return {"input_ids": input_ids, "labels": labels}


def subsequence_pos(seq: Sequence[int], subseq: Sequence[int]) -> int:
    """Index of the first occurrence of subseq in seq, or -1."""
    n, m = len(seq), len(subseq)
    if m == 0 or m > n:
        return -1
    for i in range(n - m + 1):
        if list(seq[i : i + m]) == list(subseq):
            return i
    return -1


def adapt_tokenizer_for_denoising(tokenizer, num_sentinels: int = 100):
    """Append `<extra_id_k>` sentinel tokens (UL2-style denoising vocab;
    reference: m2t/llava/model/mpt/adapt_tokenizer.py:1-45). Returns the
    tokenizer with `sentinel_token_ids` attached."""
    sentinels = [f"<extra_id_{k}>" for k in range(num_sentinels)]
    tokenizer.add_tokens(sentinels, special_tokens=True)
    if getattr(tokenizer, "pad_token", None) is None:
        tokenizer.pad_token = getattr(tokenizer, "eos_token", "[PAD]")
    tokenizer.sentinel_token_ids = [
        tokenizer.convert_tokens_to_ids(s) for s in sentinels
    ]
    return tokenizer


def prompt_end_token_sequence(bundle: TokenizerBundle) -> List[int]:
    """Token ids of '\\n### Assistant:' with any tokenizer-prepended artifact
    (BOS / word-start token) stripped (reference m2t/tokenizer.py:41-58)."""
    ids = bundle.encode(PROMPT_END_TEXT, truncate=False)
    # a leading BOS-like token never appears at the boundary inside a
    # longer string, so strip ids until the sequence is found in a probe
    probe = bundle.encode("x" + PROMPT_END_TEXT, truncate=False)
    while ids and subsequence_pos(probe, ids) == -1:
        ids = ids[1:]
    return ids


def extract_prompt_tokens(ids: Sequence[int], end_seq: Sequence[int]) -> List[int]:
    """Everything up to and including the prompt-end sequence."""
    pos = subsequence_pos(ids, end_seq)
    if pos == -1:
        return list(ids)
    return list(ids[: pos + len(end_seq)])


def extract_response_tokens(ids: Sequence[int], end_seq: Sequence[int]) -> List[int]:
    """Everything after the prompt-end sequence."""
    pos = subsequence_pos(ids, end_seq)
    if pos == -1:
        return list(ids)
    return list(ids[pos + len(end_seq) :])


class WordTokenizer:
    """Minimal deterministic word-level tokenizer with the HF surface the
    framework touches. For tests and offline smoke runs (no pretrained
    tokenizer assets are needed)."""

    _TOKEN_RE = re.compile(r"<[a-z_]+>|###|\n|[^\s<]+|<")

    def __init__(self, model_max_length: int = 512):
        self.model_max_length = model_max_length
        self._vocab: Dict[str, int] = {}
        self._inv: Dict[int, str] = {}
        self.pad_token = "[PAD]"
        self.bos_token = "<s>"
        for tok in ("[PAD]", "<s>", "</s>", "<unk>"):
            self._intern(tok)
        self.pad_token_id = self._vocab["[PAD]"]
        self.bos_token_id = self._vocab["<s>"]
        self.eos_token_id = self._vocab["</s>"]

    def _intern(self, tok: str) -> int:
        if tok not in self._vocab:
            idx = len(self._vocab)
            self._vocab[tok] = idx
            self._inv[idx] = tok
        return self._vocab[tok]

    def get_vocab(self) -> Dict[str, int]:
        return dict(self._vocab)

    def add_tokens(self, tokens: Sequence[str], special_tokens: bool = False) -> int:
        before = len(self._vocab)
        for t in tokens:
            self._intern(t)
        return len(self._vocab) - before

    def convert_tokens_to_ids(self, token: str) -> int:
        return self._intern(token)

    def tokenize(self, text: str) -> List[str]:
        return self._TOKEN_RE.findall(text)

    def __call__(self, text: str, **kw) -> Dict[str, List[int]]:
        ids = [self.bos_token_id] + [self._intern(t) for t in self.tokenize(text)]
        return {"input_ids": ids}

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        specials = {"[PAD]", "<s>", "</s>"}
        toks = [self._inv.get(int(i), "<unk>") for i in ids]
        if skip_special_tokens:
            toks = [t for t in toks if t not in specials]
        out = []
        for t in toks:
            if t == "\n":
                out.append("\n")
            else:
                if out and out[-1] != "\n":
                    out.append(" ")
                out.append(t)
        return "".join(out)

    def __len__(self) -> int:
        return len(self._vocab)

    def to_dict(self) -> Dict:
        return {"model_max_length": self.model_max_length, "vocab": dict(self._vocab)}

    @classmethod
    def from_dict(cls, d: Dict) -> "WordTokenizer":
        tok = cls(d.get("model_max_length", 512))
        # re-intern in id order to reproduce the exact mapping
        for t, _ in sorted(d["vocab"].items(), key=lambda kv: kv[1]):
            tok._intern(t)
        if tok._vocab != d["vocab"]:
            raise ValueError("vocab reload mismatch")
        return tok
