"""Training-data pipeline: shards -> conversations -> tokens -> fixed-shape
device batches.

Reference semantics being matched (m2t/data_modules.py):
  * webdataset_element_to_conversation (:295-340): unpack each sample's
    multi-QA `response` list into standalone (question, answer) examples,
    random audio-first placement (:328);
  * preprocess_multimodal_mappable (:234-258): `<audio>` ->
    `<audio_start>` + `<audio_patch>`*T + `<audio_end>`;
  * preprocess_for_lm_mappable (:260-283): format + tokenize + mask;
  * shuffle buffer of 1000 (:523), skip-and-warn on corrupt samples;
  * collator (:189-222), but every batch is padded to the static
    (S, T_audio) contract (the reference's "list when unequal shapes"
    fallback is not kept).

The iterator is pure host-side Python/numpy; `PrefetchIterator` overlaps
host work with device steps. A copy of llark_tpu/data/pipeline.py: on the
same shards and seed it yields the same batches, bit for bit.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from llark_tpu_torch.config import DataArguments
from llark_tpu_torch.conversation import concat_audio_token_and_prompt
from llark_tpu_torch.data.records import make_shard_reader
from llark_tpu_torch.data.shards import expand_url_to_file_list, repeat_shards, split_by_host
from llark_tpu_torch.special_tokens import IGNORE_INDEX
from llark_tpu_torch.tokenization import (
    TokenizerBundle,
    expand_conversation_audio,
    preprocess_conversation,
)

log = logging.getLogger(__name__)

SHUFFLE_BUFFER_SIZE = 1000


def sample_to_conversations(
    sample: Dict[str, Any], rng: random.Random
) -> Iterator[Dict[str, Any]]:
    """Unpack one WDS sample into per-QA conversation examples."""
    js = sample.get("json")
    if not isinstance(js, dict):  # foreign/corrupt member: skip, don't crash
        log.warning("non-dict json member for %s; skipping", sample.get("__key__"))
        return
    if not js or not isinstance(js.get("response"), list):
        log.warning("no valid json response for %s; skipping", sample.get("__key__"))
        return
    enc = sample.get("audio_encoding.pyd")
    if enc is None:
        enc = sample.get("audio_encoding.npy")
    if enc is None:
        log.warning("no audio encoding for %s; skipping", sample.get("__key__"))
        return
    enc = np.asarray(enc, np.float32)
    if enc.ndim == 3 and enc.shape[0] == 1:
        enc = enc[0]
    for response in js["response"]:
        try:
            question, answer = response["question"], response["answer"]
        except (TypeError, KeyError):
            continue
        audio_first = rng.random() > 0.5
        prompt_text = concat_audio_token_and_prompt(question, audio_first)
        yield {
            "id": sample["__key__"],
            "audio_encoding": enc,
            "conversations": [
                {"from": "human", "value": prompt_text},
                {"from": "gpt", "value": answer},
            ],
        }


def example_to_arrays(
    example: Dict[str, Any],
    bundle: TokenizerBundle,
    max_audio_frames: int,
    use_audio_start_end: bool = True,
) -> Optional[Dict[str, Any]]:
    """Expand audio tokens, tokenize, mask. Returns variable-length arrays."""
    enc = example["audio_encoding"]
    n_frames = min(enc.shape[0], max_audio_frames)
    turns = expand_conversation_audio(
        example["conversations"], n_frames, use_audio_start_end
    )
    arrays = preprocess_conversation(turns, bundle)
    if int((arrays["input_ids"] == bundle.audio_patch_id).sum()) != n_frames:
        # truncation cut into the audio span; unusable for splicing
        log.warning("audio span truncated for %s; skipping", example.get("id"))
        return None
    return {
        "input_ids": arrays["input_ids"],
        "labels": arrays["labels"],
        "audio_encoding": enc[:n_frames],
        "num_frames": n_frames,
        "id": example["id"],
    }


def shuffled(iterator, buffer_size: int, rng: random.Random):
    buf: List[Any] = []
    for item in iterator:
        if len(buf) < buffer_size:
            buf.append(item)
            continue
        idx = rng.randrange(len(buf))
        buf[idx], item = item, buf[idx]
        yield item
    rng.shuffle(buf)
    yield from buf


def collate(
    examples: Sequence[Dict[str, Any]],
    bundle: TokenizerBundle,
    max_seq_len: int,
    max_audio_frames: int,
    mm_hidden_size: int,
) -> Dict[str, np.ndarray]:
    """Fixed-shape batch: pad ids/labels to max_seq_len, audio to
    max_audio_frames."""
    b = len(examples)
    input_ids = np.full((b, max_seq_len), bundle.pad_token_id, np.int32)
    labels = np.full((b, max_seq_len), IGNORE_INDEX, np.int32)
    seq_lengths = np.zeros((b,), np.int32)
    audio = np.zeros((b, max_audio_frames, mm_hidden_size), np.float32)
    frame_counts = np.zeros((b,), np.int32)
    ids = []
    for i, ex in enumerate(examples):
        s = min(len(ex["input_ids"]), max_seq_len)
        input_ids[i, :s] = ex["input_ids"][:s]
        labels[i, :s] = ex["labels"][:s]
        seq_lengths[i] = s
        t = ex["num_frames"]
        audio[i, :t] = ex["audio_encoding"][:t]
        frame_counts[i] = t
        ids.append(ex["id"])
    return {
        "input_ids": input_ids,
        "labels": labels,
        "seq_lengths": seq_lengths,
        "audio_encodings": audio,
        "audio_frame_counts": frame_counts,
        "example_ids": ids,
    }


class PrefetchIterator:
    """Background-thread prefetch so host batch assembly overlaps device
    compute (replaces DataLoader workers)."""

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in iterator:
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001 — propagate to consumer
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def make_dataset_iterator(
    url: str,
    bundle: TokenizerBundle,
    data_args: DataArguments,
    *,
    batch_size: int,
    max_seq_len: int,
    mm_hidden_size: int,
    is_train: bool = True,
    seed: int = 0,
    max_batches: Optional[int] = None,
    prefetch: int = 4,
    skip_batches: int = 0,
    num_workers: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Full pipeline: urls -> per-host shards -> samples -> conversations ->
    arrays -> shuffled -> collated fixed-shape batches.

    num_workers > 1 processes disjoint shard subsets on parallel threads
    (decode/tokenize overlap; numpy/pickle/tar-parse release or amortize the
    GIL) at the cost of deterministic ordering — resume fast-forward
    (skip_batches) and golden-replay tests require num_workers=1."""
    urls = expand_url_to_file_list(url)
    if is_train:
        # the apply_task_sample_probs gate disables only the task WEIGHTING
        # (probs=None -> uniform); the epoch-spanning repeat + seeded shuffle
        # always applies to training streams (reference: repeat_shards is
        # unconditional in read_webdataset, m2t/data_modules.py:466-495)
        probs = (
            data_args.task_sample_probs
            if data_args.apply_task_sample_probs
            else None
        )
        urls = repeat_shards(urls, probs, seed=seed)
    if is_train:
        # each batch shard its own shards; an eval stream is read whole by
        # every rank, which takes its rows of each batch
        urls = split_by_host(urls)
    rng = random.Random(seed)
    # eval-stream subsampling (reference rsample_frac: m2t/data_modules.py:709)
    subsample = None if is_train else data_args.eval_data_subsample

    def example_stream_for(worker_urls, worker_rng):
        reader = make_shard_reader(worker_urls)
        for sample in reader:
            if subsample is not None and worker_rng.random() >= subsample:
                continue
            for conv in sample_to_conversations(sample, worker_rng):
                arrays = example_to_arrays(
                    conv, bundle, data_args.max_audio_frames
                )
                if arrays is not None:
                    yield arrays

    if num_workers <= 1:
        stream = example_stream_for(urls, rng)
    else:
        if skip_batches:
            raise ValueError(
                "skip_batches (resume fast-forward) requires num_workers=1 "
                "for a deterministic stream"
            )
        out_q: "queue.Queue" = queue.Queue(maxsize=4 * batch_size)
        _END = object()

        def worker(widx):
            try:
                wrng = random.Random(seed * 1000003 + widx)
                for ex in example_stream_for(urls[widx::num_workers], wrng):
                    out_q.put(ex)
            except Exception:  # noqa: BLE001 — never hang the merger
                log.exception("data worker %d failed", widx)
            finally:
                out_q.put(_END)

        for widx in range(num_workers):
            threading.Thread(target=worker, args=(widx,), daemon=True).start()

        def merged():
            live = num_workers
            while live:
                item = out_q.get()
                if item is _END:
                    live -= 1
                    continue
                yield item

        stream = merged()
    if is_train:
        stream = shuffled(stream, SHUFFLE_BUFFER_SIZE, rng)

    def batch_stream():
        batch: List[Dict[str, Any]] = []
        n = 0
        skipped = 0
        for ex in stream:
            batch.append(ex)
            if len(batch) == batch_size:
                if skipped < skip_batches:
                    # resume fast-forward: walk the identical stream (same
                    # seed, same shuffle-buffer state) without collating so
                    # restarted runs do not re-train on already-seen batches
                    skipped += 1
                    batch = []
                    continue
                yield collate(
                    batch, bundle, max_seq_len, data_args.max_audio_frames, mm_hidden_size
                )
                batch = []
                n += 1
                if max_batches is not None and n >= max_batches:
                    return
        if batch and not is_train:
            yield collate(
                batch, bundle, max_seq_len, data_args.max_audio_frames, mm_hidden_size
            )

    return PrefetchIterator(batch_stream(), depth=prefetch)


def make_data_module(
    bundle: TokenizerBundle,
    data_args: DataArguments,
    *,
    batch_size: int,
    max_seq_len: int,
    mm_hidden_size: int,
    seed: int = 0,
) -> Dict[str, Any]:
    """Reference-parity entry (m2t/data_modules.py:681-717): returns train /
    eval iterator factories keyed off DataArguments paths."""

    def _resume_workers(skip_batches: int, num_workers: int) -> int:
        if not skip_batches:
            return num_workers
        if num_workers > 1:
            log.warning(
                "resume fast-forward replays the deterministic single-worker "
                "stream, but this run is configured with num_workers=%d whose "
                "merged ordering is thread-timing-dependent — the %d skipped "
                "batches may not be exactly the ones the interrupted run saw. "
                "Use num_workers=1 for exact resume.",
                num_workers,
                skip_batches,
            )
        return 1
    out: Dict[str, Any] = {}
    if data_args.train_data_path:
        out["train_iterator"] = lambda skip_batches=0: make_dataset_iterator(
            data_args.train_data_path,
            bundle,
            data_args,
            batch_size=batch_size,
            max_seq_len=max_seq_len,
            mm_hidden_size=mm_hidden_size,
            is_train=True,
            seed=seed,
            skip_batches=skip_batches,
            num_workers=_resume_workers(skip_batches, data_args.num_workers),
        )
    if data_args.eval_data_path:
        out["eval_iterator"] = lambda: make_dataset_iterator(
            data_args.eval_data_path,
            bundle,
            data_args,
            batch_size=batch_size,
            max_seq_len=max_seq_len,
            mm_hidden_size=mm_hidden_size,
            is_train=False,
            seed=seed,
        )
    return out
