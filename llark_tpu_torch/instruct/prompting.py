"""Prompt helpers for OpenAI-generated instruction data.

Parity target: m2t/instruct/prompting.py:106-277. Four prompt types:
  default    — structured-caption fields from title/artist metadata
  mir        — MIR question/answer list from annotation metadata
  reasoning  — complex musical-reasoning QA list
  captioning — free-text expert caption

Prompt texts resolve from `{type}-{dataset}-prompt.txt` files in this
directory when present, else from built-in templates (the reference
shipped *without* its default `openai-chatgpt-prompt.txt` — SURVEY.md §2.3
flags it; here the default prompt is always available).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence, Union

from llark_tpu_torch.dataset_utils import DatasetInfo
from llark_tpu_torch.instruct import FewShotExample
from llark_tpu_torch.instruct.fewshot_examples.mirqa import MIRQA_FEWSHOT_EXAMPLES
from llark_tpu_torch.instruct.fewshot_examples.reasoning_qa import (
    REASONING_QA_FEWSHOT_EXAMPLES,
)
from llark_tpu_torch.instruct.json_utils import oxford_comma, parse_almost_json, unnest_list

log = logging.getLogger(__name__)

EXPECTED_FIELDS = [
    "context_activities",
    "context_cultural",
    "genre",
    "mood",
    "sound_descriptions",
    "music_descriptions",
    "music_analysis",
    "music_creation",
    "abstract",
]
OPTIONAL_FIELDS = ["language", "lyrics", "vocals", "instruments", "rhythm"]
ALLOWED_FIELDS = set(["title", "artist", "uri"] + EXPECTED_FIELDS + OPTIONAL_FIELDS)

DEFAULT_PROMPT = (
    "You are an expert musicologist annotating a music catalogue. For each "
    "track given as a JSON object with its title and artist, return a JSON "
    "list with one object describing the track using exactly these fields: "
    + ", ".join(EXPECTED_FIELDS)
    + ". You may also include these optional fields when applicable: "
    + ", ".join(OPTIONAL_FIELDS)
    + ". Every field's value must be a JSON list of short strings. Do not "
    "invent fields, do not nest lists, and answer with JSON only."
)

_MIR_TEMPLATE = (
    "You are an expert in music information retrieval. The user sends JSON "
    "metadata describing a recording from the {dataset} collection (tempo, "
    "key, chords, beats, instruments, tags, or notes). Write a JSON list of "
    "question/answer objects (fields: \"question\", \"answer\") that a "
    "student could answer only by listening to the audio. Cover objective "
    "musical attributes (tempo, key, meter, chords, instrumentation). Never "
    "mention the metadata, annotations, or the {dataset} collection itself "
    "in the questions or answers. Answer with JSON only."
)

_REASONING_TEMPLATE = (
    "You are an expert music teacher. The user sends JSON metadata for a "
    "recording from the {dataset} collection. Write a JSON list of "
    "question/answer objects (fields: \"question\", \"answer\") that require "
    "multi-step musical reasoning about the piece — how its elements combine, "
    "what a performer or producer intended, how a listener might use or feel "
    "the music. Ground every answer in attributes present in the metadata, "
    "but never mention the metadata or any annotation source. Answer with "
    "JSON only."
)

_CAPTIONING_TEMPLATE = (
    "You are an expert musicologist. The user sends JSON metadata describing "
    "a recording from the {dataset} collection. Write one detailed paragraph "
    "describing the music as an expert listener would hear it: "
    "instrumentation, tempo and rhythm, key and harmony, genre, mood, and "
    "structure. Do not mention the metadata or the collection. Respond with "
    "the caption text only."
)

_TEMPLATES = {
    "mir": _MIR_TEMPLATE,
    "reasoning": _REASONING_TEMPLATE,
    "captioning": _CAPTIONING_TEMPLATE,
}


def correct_element(input_row: Dict) -> Dict:
    """Constrain a structured-caption row to the schema
    (reference prompting.py:44-74)."""
    output_row = {}
    for key, value in input_row.items():
        output_row[key] = unnest_list(value) if isinstance(value, list) else value
    for key in EXPECTED_FIELDS + OPTIONAL_FIELDS:
        if key in output_row and isinstance(output_row[key], str):
            output_row[key] = [output_row[key]]
    if output_row.get("language") is None:
        output_row["language"] = []
    return {k: v for k, v in output_row.items() if k in ALLOWED_FIELDS}


@dataclasses.dataclass
class PromptHelper(ABC):
    few_shot: bool
    prompt_text: str
    few_shot_examples: Optional[Sequence[FewShotExample]] = None

    def get_prompt_text(self) -> str:
        return self.prompt_text

    @abstractmethod
    def get_chatgpt_query(self, metadata: Dict[str, Any]) -> Dict[str, Any]:
        ...

    def build_messages(self, prompt_text: str, query) -> List[Dict[str, str]]:
        """system + optional few-shot turns + JSON user payload
        (reference :106-127)."""
        shots: List[Dict[str, str]] = []
        if self.few_shot and self.few_shot_examples:
            for ex in self.few_shot_examples:
                shots.append({"role": "user", "content": json.dumps(ex.user)})
                shots.append({"role": "assistant", "content": json.dumps(ex.assistant)})
        return [
            {"role": "system", "content": prompt_text},
            *shots,
            {"role": "user", "content": json.dumps([query])},
        ]

    @abstractmethod
    def postprocess_response_text(self, text: str, query, uri) -> Dict[str, Any]:
        ...

    @abstractmethod
    def check_chatgpt_response_meets_schema(self, response):
        ...


def _check_qa_schema(response) -> List[Dict[str, str]]:
    if not isinstance(response, list):
        raise ValueError("expected a list of question/answer objects")
    for elem in response:
        for field in ("question", "answer"):
            if field not in elem:
                raise ValueError(f"Missing field from ChatGPT response: {field}")
    return response


@dataclasses.dataclass
class BasicPromptHelper(PromptHelper):
    """Structured caption fields from track/artist metadata."""

    def get_chatgpt_query(self, metadata: Dict[str, Any]) -> Dict[str, Any]:
        track = metadata["name"]
        artists = oxford_comma([a["name"] for a in metadata["artist"]])
        return {"title": track, "artist": artists}

    def check_chatgpt_response_meets_schema(self, response):
        if not isinstance(response, dict):
            raise ValueError("expected a dict response")
        for field in EXPECTED_FIELDS:
            if field not in response:
                raise ValueError(f"Missing field from ChatGPT response: {field}")
        for field in OPTIONAL_FIELDS:
            response.setdefault(field, [])
        return response

    def postprocess_response_text(self, text, query, uri):
        parsed = parse_almost_json(text)
        if isinstance(parsed, list):
            parsed = parsed[0]
        response = self.check_chatgpt_response_meets_schema(parsed)
        row = dict(list(response.items()) + list(query.items()) + [("uri", uri)])
        return correct_element(row)


@dataclasses.dataclass
class MirQAPromptHelper(PromptHelper):
    def __post_init__(self):
        if self.few_shot_examples is None:
            self.few_shot_examples = MIRQA_FEWSHOT_EXAMPLES

    def get_chatgpt_query(self, metadata):
        return metadata

    def check_chatgpt_response_meets_schema(self, response):
        return _check_qa_schema(response)

    def postprocess_response_text(self, text, query, uri):
        response = self.check_chatgpt_response_meets_schema(parse_almost_json(text))
        row = dict(list(query.items()) + [("uri", uri)])
        row["response"] = response
        return row


@dataclasses.dataclass
class ReasoningQAPromptHelper(MirQAPromptHelper):
    def __post_init__(self):
        if self.few_shot_examples is None:
            self.few_shot_examples = REASONING_QA_FEWSHOT_EXAMPLES


@dataclasses.dataclass
class CaptioningPromptHelper(PromptHelper):
    def get_chatgpt_query(self, metadata):
        return metadata

    def check_chatgpt_response_meets_schema(self, response):
        return response

    def postprocess_response_text(self, text, query, uri):
        row = dict(list(query.items()) + [("uri", uri)])
        row["response"] = {"caption": self.check_chatgpt_response_meets_schema(text)}
        return row


def resolve_prompt_text(prompt_type: str, dataset_name: str) -> str:
    """File `{type}-{dataset}-prompt.txt` if present, else the template."""
    if prompt_type == "default":
        path = os.path.join(os.path.dirname(__file__), "openai-chatgpt-prompt.txt")
        if os.path.exists(path):
            with open(path) as f:
                return f.read()
        return DEFAULT_PROMPT
    path = os.path.join(
        os.path.dirname(__file__), f"{prompt_type}-{dataset_name}-prompt.txt"
    )
    if os.path.exists(path):
        with open(path) as f:
            return f.read()
    return _TEMPLATES[prompt_type].format(dataset=dataset_name)


def get_prompt_helper(
    prompt_type: str, dataset_info: DatasetInfo, few_shot: bool
) -> PromptHelper:
    """Registry (reference :255-277)."""
    prompt_text = resolve_prompt_text(prompt_type, dataset_info.name)
    if prompt_type == "default":
        if few_shot:
            log.warning("few_shot is True but BasicPromptHelper is selected.")
        return BasicPromptHelper(few_shot=few_shot, prompt_text=prompt_text)
    cls = {
        "mir": MirQAPromptHelper,
        "reasoning": ReasoningQAPromptHelper,
        "captioning": CaptioningPromptHelper,
    }.get(prompt_type)
    if cls is None:
        raise NotImplementedError(f"prompt type {prompt_type} not implemented.")
    return cls(few_shot=few_shot, prompt_text=prompt_text)
