"""Fetch instruction-tuning data from an OpenAI-compatible chat API.

Parity: scripts/openai/fetch_openai_instruct_data.py — per-row
ChatCompletion with retry/backoff and sharded JSONL output — rebuilt as
plain concurrent Python (thread pool) instead of a Beam pipeline
(SURVEY.md §7 step 9). The transport is injectable so the pipeline is
testable offline and portable across OpenAI-compatible endpoints.

  python -m llark_tpu_torch.instruct.fetch_openai \
      --input annotations.jsonl --output-dir out/ \
      --prompt-type mir --dataset-name mtg-jamendo \
      [--model gpt-4] [--few-shot] [--num-workers 8] [--shard-size 500]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import random
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

from llark_tpu_torch.dataset_utils import DATASET_INFO
from llark_tpu_torch.instruct.data_validation import drop_invalid_qa_responses
from llark_tpu_torch.instruct.prompting import PromptHelper, get_prompt_helper

log = logging.getLogger(__name__)

MAX_RETRIES = 4  # reference :153-177 exponential backoff


def default_transport(model: str):
    """Build a real OpenAI client transport; requires the openai package
    and OPENAI_API_KEY (absent in offline environments)."""
    import openai  # type: ignore

    client = openai.OpenAI()

    def call(messages: List[Dict[str, str]]) -> str:
        resp = client.chat.completions.create(model=model, messages=messages)
        return resp.choices[0].message.content

    return call


def prompt_one(
    row: Dict[str, Any],
    helper: PromptHelper,
    transport: Callable[[List[Dict[str, str]]], str],
    uri_key: str = "id",
    max_retries: int = MAX_RETRIES,
) -> Optional[Dict[str, Any]]:
    """One row -> messages -> completion -> validated response row
    (retries with exponential backoff + jitter)."""
    query = helper.get_chatgpt_query(row)
    messages = helper.build_messages(helper.get_prompt_text(), query)
    uri = row.get(uri_key, "")
    for attempt in range(max_retries):
        try:
            text = transport(messages)
            out = helper.postprocess_response_text(text, query, uri)
            return drop_invalid_qa_responses(out)
        except Exception as e:  # noqa: BLE001 — retry then skip
            wait = (2**attempt) + random.random()
            log.warning(
                "attempt %d/%d failed for %s: %s (sleep %.1fs)",
                attempt + 1, max_retries, uri, e, wait,
            )
            if attempt + 1 < max_retries:
                time.sleep(wait)
    return None


class ShardedJsonlWriter:
    """Sharded output files (reference StreamIntoFiles :54-132)."""

    def __init__(self, output_dir: str, prefix: str = "instruct", shard_size: int = 500):
        self.output_dir = output_dir
        self.prefix = prefix
        self.shard_size = shard_size
        self.count = 0
        self.shard_idx = 0
        self._fh = None
        os.makedirs(output_dir, exist_ok=True)

    def write(self, row: Dict[str, Any]) -> None:
        if self._fh is None or self.count >= self.shard_size:
            if self._fh:
                self._fh.close()
                self.shard_idx += 1
                self.count = 0
            path = os.path.join(
                self.output_dir, f"{self.prefix}-{self.shard_idx:05d}.jsonl"
            )
            self._fh = open(path, "w")
        self._fh.write(json.dumps(row) + "\n")
        self.count += 1

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def fetch_instruct_data(
    rows: List[Dict[str, Any]],
    helper: PromptHelper,
    transport: Callable[[List[Dict[str, str]]], str],
    writer: ShardedJsonlWriter,
    num_workers: int = 8,
    uri_key: str = "id",
) -> int:
    written = 0
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for result in pool.map(
            lambda r: prompt_one(r, helper, transport, uri_key), rows
        ):
            if result is not None:
                writer.write(result)
                written += 1
    writer.close()
    return written


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True, help="annotations JSONL")
    p.add_argument("--output-dir", required=True)
    p.add_argument(
        "--prompt-type", default="mir",
        choices=["default", "mir", "reasoning", "captioning"],
    )
    p.add_argument("--dataset-name", required=True, choices=sorted(DATASET_INFO))
    p.add_argument("--model", default="gpt-4")
    p.add_argument("--few-shot", action="store_true")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--shard-size", type=int, default=500)
    p.add_argument("--uri-key", default="id")
    ns = p.parse_args(argv)

    with open(ns.input) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    helper = get_prompt_helper(ns.prompt_type, DATASET_INFO[ns.dataset_name], ns.few_shot)
    transport = default_transport(ns.model)
    writer = ShardedJsonlWriter(ns.output_dir, f"{ns.prompt_type}-{ns.dataset_name}",
                                ns.shard_size)
    n = fetch_instruct_data(rows, helper, transport, writer, ns.num_workers, ns.uri_key)
    print(f"wrote {n}/{len(rows)} rows to {ns.output_dir}")


if __name__ == "__main__":
    main()
