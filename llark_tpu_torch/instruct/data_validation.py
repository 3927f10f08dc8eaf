"""Response validation: drop QA pairs that leak annotation provenance.

Parity: m2t/instruct/data_validation.py — the generated data must read as
if the model is listening to audio, so any question/answer that mentions
"the metadata", "the annotations", "the provided JSON", etc. is dropped
(lists re-authored with equivalent coverage; substring, case-insensitive).
"""

from __future__ import annotations

from typing import Any, Dict, List

DISALLOWED_ANSWER_PHRASES = (
    "metadata",
    "the annotation",
    "annotations provided",
    "provided json",
    "the json",
    "json data",
    "json object",
    "the provided data",
    "the given data",
    "based on the data provided",
    "based on the information provided",
    "the provided information",
    "the dataset",
    "musicnet",
    "magnatagatune",
    "jamendo",
    "as an ai",
    "i cannot listen",
    "i'm unable to listen",
    "cannot hear the audio",
    "without hearing",
    "the tags",
    "the file name",
)

DISALLOWED_QUESTION_PHRASES = (
    "metadata",
    "annotation",
    "json",
    "dataset",
    "provided data",
    "the tags",
)


def answer_is_valid(answer: str) -> bool:
    a = (answer or "").lower()
    return not any(p in a for p in DISALLOWED_ANSWER_PHRASES)


def question_is_valid(question: str) -> bool:
    q = (question or "").lower()
    return not any(p in q for p in DISALLOWED_QUESTION_PHRASES)


def qa_pair_is_valid(qa: Dict[str, Any]) -> bool:
    return (
        isinstance(qa, dict)
        and isinstance(qa.get("question"), str)
        and isinstance(qa.get("answer"), str)
        and len(qa["question"].strip()) > 0
        and len(qa["answer"].strip()) > 0
        and question_is_valid(qa["question"])
        and answer_is_valid(qa["answer"])
    )


def drop_invalid_qa_responses(row: Dict[str, Any]) -> Dict[str, Any]:
    """Filter row['response'] in place-style (returns the row)
    (reference data_validation.py:80-87)."""
    responses = row.get("response")
    if isinstance(responses, list):
        row["response"] = [qa for qa in responses if qa_pair_is_valid(qa)]
    return row
