"""WavCaps music filtering (reference: m2t/dataset_utils/wavcaps.py;
counterpart of llark_tpu/preprocessing/wavcaps_filters.py).

The reference keeps WavCaps captions that look like *music* and drops
sound-effect/speech content, via keyword allow/deny lists plus a minimum
caption length. Lists here are re-authored with the same intent and
filtering behavior (substring, case-insensitive).
"""

from __future__ import annotations

MUSIC_KEYWORDS = (
    "music", "song", "melody", "melodic", "instrumental", "orchestra",
    "orchestral", "symphony", "guitar", "piano", "violin", "cello", "drum",
    "drums", "bass", "synth", "synthesizer", "choir", "singing", "singer",
    "vocals", "chord", "harmony", "rhythm", "beat", "tempo", "jazz", "rock",
    "classical", "electronic", "hip hop", "rap", "folk", "blues", "reggae",
    "techno", "ambient", "flute", "trumpet", "saxophone", "organ", "banjo",
    "harp", "accordion", "ukulele", "strumming", "riff", "tune",
)

NON_MUSIC_KEYWORDS = (
    "speech", "speaking", "talking", "conversation", "narration", "lecture",
    "siren", "alarm", "engine", "traffic", "car horn", "dog bark", "barking",
    "meow", "bird call", "chirping", "thunder", "rain falling", "wind blowing",
    "footsteps", "door", "gunshot", "explosion", "applause only", "coughing",
    "sneezing", "snoring", "typing", "machine", "drill", "vacuum", "helicopter",
    "airplane", "train passing", "water running", "toilet", "crowd noise",
)

MIN_CAPTION_WORDS = 3


def keyword_filter(caption: str) -> bool:
    """True if the caption passes the music filter
    (has a music keyword, lacks non-music keywords)."""
    c = (caption or "").lower()
    if not any(k in c for k in MUSIC_KEYWORDS):
        return False
    return not any(k in c for k in NON_MUSIC_KEYWORDS)


def length_filter(caption: str, min_words: int = MIN_CAPTION_WORDS) -> bool:
    return len((caption or "").split()) >= min_words
