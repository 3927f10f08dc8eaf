"""Caption question prompts + caption-QA insertion.

Parity: m2t/instruct/captioning.py — pools of long/short caption request
phrasings (re-authored), a per-dataset map, and `insert_caption_qa` which
pairs a random prompt with a dataset-provided caption to form a QA pair.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

LONG_CAPTION_PROMPTS = (
    "Describe this piece of music in detail.",
    "Give a thorough description of what you hear in this recording.",
    "Walk me through everything happening in this track.",
    "Provide a detailed account of the music, covering instruments, tempo, and mood.",
    "What is going on in this piece of music? Please be specific.",
    "Describe the audio as an expert musicologist would.",
    "Offer an in-depth description of this song.",
    "Explain in detail what this music sounds like.",
    "Characterize this recording thoroughly, from rhythm to instrumentation.",
    "Please give a rich, detailed description of this piece.",
    "Tell me everything you can about this music.",
    "Describe the musical content of this clip at length.",
    "Lay out a comprehensive description of what you hear.",
    "How would you describe this track to someone who cannot hear it?",
    "Summarize the full musical picture of this recording in detail.",
)

SHORT_CAPTION_PROMPTS = (
    "Describe this music briefly.",
    "Give a short description of this track.",
    "Summarize what you hear in one or two sentences.",
    "What does this music sound like, in brief?",
    "Offer a concise caption for this audio.",
    "Briefly characterize this recording.",
    "In a sentence, what is this piece of music?",
    "Provide a quick summary of the music.",
    "Caption this clip.",
    "Short description, please.",
    "What's playing here, briefly?",
    "Sum up this track in a few words.",
    "Give a compact description of this piece.",
    "Describe the clip concisely.",
    "A one-line caption for this music, please.",
    "Quickly describe what this audio contains.",
    "What would a short caption for this track say?",
    "Briefly, what are the main elements of this music?",
    "Name the style and feel of this music in a sentence.",
    "Give a brief, clear caption for this recording.",
    "How would you caption this in one sentence?",
    "A terse description of the music, please.",
    "In short, what does this recording contain?",
    "Write a brief caption for the audio.",
    "Short and sweet: describe this track.",
    "One-sentence description of this piece, please.",
    "Give the gist of this music.",
    "Briefly note what this clip sounds like.",
)

# which prompt pool suits each dataset's caption style
# (reference captioning.py:71-77)
DATASET_CAPTION_STYLE = {
    "musiccaps": "long",
    "yt8m-musictextclips": "short",
    "wavcaps": "short",
    "fsl10k": "short",
    "musicnet": "long",
}


def insert_caption_qa(
    row: Dict[str, Any],
    dataset_name: str,
    caption_key: str = "caption",
    rng: Optional[random.Random] = None,
) -> Dict[str, Any]:
    """Pair the row's caption with a random caption prompt, appending a
    {question, answer} to row['response'] (reference captioning.py:84-89)."""
    rng = rng or random
    caption = row.get(caption_key)
    if not caption:
        return row
    style = DATASET_CAPTION_STYLE.get(dataset_name, "short")
    pool = LONG_CAPTION_PROMPTS if style == "long" else SHORT_CAPTION_PROMPTS
    qa = {"question": rng.choice(pool), "answer": caption}
    row.setdefault("response", [])
    row["response"].append(qa)
    return row
