"""Evaluation utilities (counterpart of llark_tpu/evaluation/utils.py; numpy
only).

The reference's notebooks import `m2t.evaluation.utils` (`acc_at_k`,
`strip_completion`, `map_keys_to_giantsteps`, `VALID_KEYS`) but that
module is MISSING from the release (SURVEY.md §2.7) — this implements the
documented surface plus the metric primitives the five notebooks compute:
  * genre: embedding-similarity argmin + acc@k
  * key: MIREX weighted score
  * tempo: ±8% accuracy with optional octave (x2 / x0.5) tolerance
  * instruments: set F1 from extracted instrument mentions
"""

from __future__ import annotations

import math
import re
import zlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# text utilities
# ---------------------------------------------------------------------------


def strip_completion(text: str) -> str:
    """Normalize a model completion: drop the stop keyword, role tags,
    surrounding whitespace/quotes."""
    if text is None:
        return ""
    t = str(text)
    t = t.split("###")[0]
    t = re.sub(r"^\s*(assistant|gpt)\s*:\s*", "", t, flags=re.IGNORECASE)
    return t.strip().strip('"').strip()


def acc_at_k(
    ranked_labels: Sequence[Sequence[str]], true_labels: Sequence[str], k: int
) -> float:
    """Fraction of rows whose true label appears in the top-k ranked list."""
    assert len(ranked_labels) == len(true_labels)
    if not true_labels:
        return 0.0
    hits = sum(
        1
        for ranked, truth in zip(ranked_labels, true_labels)
        if truth in list(ranked)[:k]
    )
    return hits / len(true_labels)


# ---------------------------------------------------------------------------
# embedding-similarity classification (genre notebooks)
# ---------------------------------------------------------------------------


def bag_of_words_embedder(texts: Sequence[str]) -> np.ndarray:
    """Offline fallback embedder: L2-normalized hashed bag of words.
    The reference uses OpenAI text embeddings; any callable
    `texts -> [N, D]` can be passed to rank_labels_by_similarity."""
    dim = 512
    out = np.zeros((len(texts), dim), np.float32)
    for i, t in enumerate(texts):
        for w in re.findall(r"[a-z]+", (t or "").lower()):
            # stable across processes (builtin hash() is PYTHONHASHSEED-randomized)
            out[i, zlib.crc32(w.encode()) % dim] += 1.0
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-9)


def rank_labels_by_similarity(
    completions: Sequence[str],
    label_set: Sequence[str],
    embedder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
) -> List[List[str]]:
    """Rank the label set per completion by cosine similarity of embeddings
    (the notebooks' genre method)."""
    embedder = embedder or bag_of_words_embedder
    comp_emb = np.asarray(embedder([strip_completion(c) for c in completions]))
    label_emb = np.asarray(embedder(list(label_set)))
    sims = comp_emb @ label_emb.T  # embeddings are normalized
    order = np.argsort(-sims, axis=1)
    return [[label_set[j] for j in row] for row in order]


# ---------------------------------------------------------------------------
# key evaluation (GiantSteps)
# ---------------------------------------------------------------------------

_SHARP_TO_FLAT = {
    "c#": "db", "d#": "eb", "f#": "gb", "g#": "ab", "a#": "bb",
}
_NOTE_TO_PC = {
    "c": 0, "c#": 1, "db": 1, "d": 2, "d#": 3, "eb": 3, "e": 4, "f": 5,
    "f#": 6, "gb": 6, "g": 7, "g#": 8, "ab": 8, "a": 9, "a#": 10, "bb": 10,
    "b": 11, "cb": 11, "e#": 5, "b#": 0, "fb": 4,
}

VALID_KEYS = tuple(
    f"{note} {mode}"
    for note in ("C", "Db", "D", "Eb", "E", "F", "Gb", "G", "Ab", "A", "Bb", "B")
    for mode in ("major", "minor")
)


def normalize_key_string(text: str) -> Optional[Tuple[int, str]]:
    """Parse a free-text key mention -> (pitch_class, 'major'|'minor')."""
    t = strip_completion(text).lower().replace("♭", "b").replace("♯", "#")
    t = re.sub(r"\b([a-g])[ -]?sharp\b", r"\1#", t)
    t = re.sub(r"\b([a-g])[ -]?flat\b", r"\1b", t)
    # prefer a note WITH an explicit mode ("c minor"); a bare-note fallback
    # must be a standalone word, or 'Based'/'Dark' parse as B/D keys
    m = re.search(r"\b([a-g][#b]?)\s*[- ]?\s*(major|minor|maj\b|min\b|m\b)", t)
    if m:
        note, mode_raw = m.group(1), m.group(2).strip()
    else:
        m = re.search(r"\b([a-g][#b]?)(?![a-z#])", t)
        if not m:
            return None
        note, mode_raw = m.group(1), "major"
    mode = "minor" if mode_raw in ("minor", "min", "m") else "major"
    pc = _NOTE_TO_PC.get(note)
    if pc is None:
        return None
    return pc, mode


def map_keys_to_giantsteps(key_text: str) -> Optional[str]:
    """Map any key spelling to the GiantSteps canonical flat spelling
    (e.g. 'C# major' -> 'Db major')."""
    parsed = normalize_key_string(key_text)
    if parsed is None:
        return None
    pc, mode = parsed
    flat_names = ("C", "Db", "D", "Eb", "E", "F", "Gb", "G", "Ab", "A", "Bb", "B")
    return f"{flat_names[pc]} {mode}"


def mirex_key_score(predicted: str, truth: str) -> float:
    """MIREX weighted key score: exact 1.0, perfect fifth 0.5, relative
    major/minor 0.3, parallel major/minor 0.2, else 0."""
    p = normalize_key_string(predicted)
    t = normalize_key_string(truth)
    if p is None or t is None:
        return 0.0
    (ppc, pmode), (tpc, tmode) = p, t
    if (ppc, pmode) == (tpc, tmode):
        return 1.0
    # fifth credit only for the fifth ABOVE the truth (mir_eval semantics;
    # accepting 5 as well doubled the credit window and inflated scores)
    if pmode == tmode and (ppc - tpc) % 12 == 7:
        return 0.5
    if pmode != tmode:
        # relative: minor is 9 semitones above its relative major
        if tmode == "major" and pmode == "minor" and (ppc - tpc) % 12 == 9:
            return 0.3
        if tmode == "minor" and pmode == "major" and (tpc - ppc) % 12 == 9:
            return 0.3
        if ppc == tpc:
            return 0.2
    return 0.0


# ---------------------------------------------------------------------------
# tempo evaluation (GiantSteps)
# ---------------------------------------------------------------------------

_BPM_UNIT_RE = re.compile(
    r"(\d{2,3}(?:\.\d+)?)\s*(?:bpm|beats per minute|beats/min)", re.IGNORECASE
)
_BPM_BARE_RE = re.compile(r"(?<![\d.])(\d{2,3}(?:\.\d+)?)(?![\ds])")


def parse_bpm(text: str) -> Optional[float]:
    """Extract a plausible BPM value from a completion. Numbers with an
    explicit unit win over bare numbers (else '1970s rock ... 120 BPM'
    parses as 197); bare-number fallback skips decade-like '1970s'."""
    t = strip_completion(text)
    for regex in (_BPM_UNIT_RE, _BPM_BARE_RE):
        for m in regex.finditer(t):
            v = float(m.group(1))
            if 30.0 <= v <= 300.0:
                return v
    return None


def tempo_acc(
    predicted_texts: Sequence[str],
    true_bpms: Sequence[float],
    tolerance: float = 0.08,
    octave_tolerant: bool = False,
) -> float:
    """±tolerance relative accuracy, optionally accepting x2 / x0.5
    metrical-level predictions."""
    assert len(predicted_texts) == len(true_bpms)
    if not true_bpms:
        return 0.0
    hits = 0
    for text, truth in zip(predicted_texts, true_bpms):
        bpm = parse_bpm(text)
        if bpm is None:
            continue
        factors = (1.0, 2.0, 0.5) if octave_tolerant else (1.0,)
        if any(abs(bpm - truth * f) <= tolerance * truth * f for f in factors):
            hits += 1
    return hits / len(true_bpms)


# ---------------------------------------------------------------------------
# instrument evaluation (MedleyDB / MusicNet)
# ---------------------------------------------------------------------------


def extract_instruments(
    text: str, instrument_vocab: Iterable[str]
) -> List[str]:
    """Instrument mentions from a completion, constrained to a vocab."""
    t = strip_completion(text).lower()
    found = []
    for inst in instrument_vocab:
        if re.search(rf"\b{re.escape(inst.lower())}s?\b", t):
            found.append(inst)
    return found


def set_f1(predicted: Iterable[str], truth: Iterable[str]) -> float:
    p, t = set(predicted), set(truth)
    if not p and not t:
        return 1.0
    if not p or not t:
        return 0.0
    tp = len(p & t)
    precision = tp / len(p)
    recall = tp / len(t)
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def bootstrap_ci(
    values: Sequence[float], n_boot: int = 1000, seed: int = 0
) -> Tuple[float, float]:
    """(center, halfwidth) of a 95% bootstrap CI over per-example scores."""
    rng = np.random.RandomState(seed)
    values = np.asarray(values, np.float64)
    if len(values) == 0:
        return 0.0, 0.0
    means = [
        values[rng.randint(0, len(values), len(values))].mean() for _ in range(n_boot)
    ]
    lo, hi = np.percentile(means, [2.5, 97.5])
    return float((lo + hi) / 2), float((hi - lo) / 2)
