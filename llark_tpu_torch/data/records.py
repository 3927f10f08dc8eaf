"""Alternate dataset readers: JSONL / JSON and msgpack record shards.

Reference parity: m2t/data_modules.py:562-668 — `read_hf_dataset` streams
`.jsonl`/`.json` files via HF datasets or `.msgpack` shards via
`gen_from_msgpack_shards` (each shard decodes to a LIST of examples), then
`hf_preprocess_encodings` reshapes the flat `audio_encoding` float list to
`audio_encoding_shape`. Here each record is normalized into the same sample
dict `TarShardReader` yields ({"__key__", "json", "audio_encoding.pyd":
np.ndarray}) so the rest of the pipeline is reader-agnostic; per-host
splitting (the reference's `split_dataset_by_node`) already happens at the
shard-list level in `data/shards.py`.
"""

from __future__ import annotations

import io
import json
import logging
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np

from llark_tpu_torch import storage

log = logging.getLogger(__name__)

try:  # optional, like the reference's msgspec dependency
    import msgpack  # type: ignore

    _HAVE_MSGPACK = True
except ImportError:  # pragma: no cover - environment-dependent
    msgpack = None
    _HAVE_MSGPACK = False


def record_to_sample(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Normalize one flat record into a tar-reader-shaped sample.

    Accepts the reference's record schema: `__key__` (or `id`), `json`
    (dict with a `response` list), `audio_encoding` (flat or nested float
    list), `audio_encoding_shape` (optional; reshape target, reference
    m2t/data_modules.py:180-186).
    """
    if not isinstance(rec, dict):
        return None
    key = rec.get("__key__")
    if key is None:  # not `or`: integer id 0 / "" are valid keys
        key = rec.get("id")
    js = rec.get("json")
    if js is None:
        # records may also inline the response list at top level
        js = {k: rec[k] for k in ("response",) if k in rec}
    if isinstance(js, str):
        try:
            js = json.loads(js)
        except json.JSONDecodeError:
            log.warning("undecodable json for record %s; skipping", key)
            return None
    enc = rec.get("audio_encoding")
    if key is None or not isinstance(js, dict) or enc is None:
        log.warning("malformed record %s; skipping", key)
        return None
    arr = np.asarray(enc, dtype=np.float32)
    shape = rec.get("audio_encoding_shape")
    if shape:
        try:
            arr = arr.reshape([int(s) for s in shape])
        except ValueError:
            log.warning(
                "audio_encoding for %s has %d values, unreshapable to %s; skipping",
                key, arr.size, shape,
            )
            return None
    return {"__key__": str(key), "json": js, "audio_encoding.pyd": arr}


def iter_jsonl_records(path: str) -> Iterator[Dict[str, Any]]:
    with storage.fopen(path, "rb") as fb, io.TextIOWrapper(fb, encoding="utf-8") as f:
        if path.endswith(".json"):
            decoded = json.load(f)
            if not isinstance(decoded, list):
                decoded = [decoded]
            yield from decoded
            return
        for lineno, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError as e:
                log.warning("bad json at %s:%d: %s; skipping", path, lineno + 1, e)


def iter_msgpack_records(path: str) -> Iterator[Dict[str, Any]]:
    if not _HAVE_MSGPACK:
        raise ImportError(
            "msgpack is not available; install it or repack shards as .jsonl/.tar"
        )
    with storage.fopen(path, "rb") as f:
        decoded = msgpack.unpackb(f.read(), raw=False)
    if not isinstance(decoded, list):
        raise ValueError(f"expected list after decoding {path}; got {type(decoded)}")
    yield from decoded


class RecordShardReader:
    """Iterate normalized samples from JSONL/JSON/msgpack record shards.

    Same skip-and-warn contract as TarShardReader: nonexistent or
    undecodable shards are skipped with a warning unless handler="raise".
    """

    def __init__(self, paths: Sequence[str], handler: str = "warn"):
        self.paths = list(paths)
        self.handler = handler

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if not _HAVE_MSGPACK and any(p.endswith(".msgpack") for p in self.paths):
            # a missing dependency must fail loudly, not skip-and-warn every
            # shard into an empty dataset
            raise ImportError(
                "msgpack is required for .msgpack shards; install it or "
                "repack as .jsonl/.tar"
            )
        for path in self.paths:
            if not storage.exists(path):
                if self.handler == "raise":
                    raise FileNotFoundError(path)
                log.warning("skipping nonexistent shard %s", path)
                continue
            try:
                if path.endswith(".msgpack"):
                    records: Iterator[Dict[str, Any]] = iter_msgpack_records(path)
                else:
                    records = iter_jsonl_records(path)
                for rec in records:
                    sample = record_to_sample(rec)
                    if sample is not None:
                        yield sample
            except Exception as e:  # noqa: BLE001 — skip-and-warn contract
                if self.handler == "raise":
                    raise
                log.warning("error decoding shard %s: %s; skipping", path, e)


_RECORD_EXTS = (".jsonl", ".json", ".msgpack")


def make_shard_reader(paths: Sequence[str], handler: str = "warn"):
    """Dispatch on shard extension: .tar -> TarShardReader, record formats ->
    RecordShardReader (reference extension dispatch, data_modules.py:640-648).
    Mixing tar and record shards in one list is an error — a single reader
    would silently skip the other format's shards as undecodable."""
    paths = list(paths)
    is_record = [any(p.endswith(ext) for ext in _RECORD_EXTS) for p in paths]
    if any(is_record) and not all(is_record):
        raise ValueError(
            "cannot mix tar and jsonl/json/msgpack shards in one dataset: "
            f"{paths[:4]}..."
        )
    if paths and is_record[0]:
        return RecordShardReader(paths, handler=handler)
    from llark_tpu_torch.data.webdataset import TarShardReader

    return TarShardReader(paths, handler=handler)
