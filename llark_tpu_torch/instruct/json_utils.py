"""Tolerant JSON parsing + small text helpers.

Parity: m2t/diffusify_utils.py (`parse_almost_json`, `oxford_comma`) —
LLM output is almost-JSON often enough that a repair pass pays for
itself (trailing commas, code fences, single quotes, chatter around the
payload).
"""

from __future__ import annotations

import json
import re
from typing import Any, List, Sequence


def oxford_comma(items: Sequence[str]) -> str:
    items = list(items)
    if not items:
        return ""
    if len(items) == 1:
        return items[0]
    if len(items) == 2:
        return f"{items[0]} and {items[1]}"
    return ", ".join(items[:-1]) + f", and {items[-1]}"


def _strip_code_fences(text: str) -> str:
    m = re.search(r"```(?:json)?\s*(.*?)```", text, re.DOTALL)
    return m.group(1) if m else text


def _extract_json_span(text: str) -> str:
    """Take the outermost [...] or {...} span."""
    starts = [(text.find(c), c) for c in "[{" if text.find(c) != -1]
    if not starts:
        return text
    start, opener = min(starts)
    closer = "]" if opener == "[" else "}"
    end = text.rfind(closer)
    return text[start : end + 1] if end > start else text


def _repair(text: str) -> str:
    # trailing commas before } or ]
    text = re.sub(r",\s*([}\]])", r"\1", text)
    # python literals
    text = re.sub(r"\bNone\b", "null", text)
    text = re.sub(r"\bTrue\b", "true", text)
    text = re.sub(r"\bFalse\b", "false", text)
    return text


def parse_almost_json(text: str) -> Any:
    """Parse JSON with progressively aggressive repairs; raises ValueError
    if nothing works. List results stay lists; bare dicts are wrapped by
    callers as needed (matches the reference's usage where [0] indexing
    expects list-like output for the basic prompt)."""
    candidates = []
    cleaned = _strip_code_fences(text).strip()
    candidates.append(cleaned)
    candidates.append(_extract_json_span(cleaned))
    candidates.append(_repair(_extract_json_span(cleaned)))
    # single-quoted JSON as a last resort
    candidates.append(
        _repair(_extract_json_span(cleaned)).replace("'", '"')
    )
    for cand in candidates:
        try:
            return json.loads(cand)
        except (json.JSONDecodeError, TypeError):
            continue
    raise ValueError(f"could not parse as JSON: {text[:200]!r}")


def unnest_list(list_in: List[Any]) -> List[Any]:
    """Flatten nested lists, dropping nested dicts
    (reference prompting.py unnest_list)."""

    def _walk(a):
        for e in a:
            if isinstance(e, list):
                yield from _walk(e)
            elif isinstance(e, dict):
                continue
            else:
                yield e

    return list(_walk(list_in))
