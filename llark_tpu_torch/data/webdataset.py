"""WebDataset-format tar shard reader/writer (dependency-free).

The reference trains from WebDataset `.tar` shards where each sample is a
group of files sharing a key: `<key>.json` (metadata + QA responses) and
`<key>.audio_encoding.pyd` (pickled tensor) (reference:
m2t/data_modules.py:466-520, m2t/dataset_utils/__init__.py:234-272).

This module provides:
  * TarShardReader — streams samples {key, field -> decoded object} from a
    tar, tolerating corrupt members (skip-and-warn, the reference's
    wds.warn_and_continue policy);
  * TarShardWriter — packs samples into shards, filling the packing-script
    gap noted in SURVEY.md §3.4.

Decoders: .json -> dict, .pyd/.pickle -> pickle (numpy arrays; torch
tensors are converted to numpy when torch is importable), .npy -> numpy.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import pickle
import tarfile
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from llark_tpu_torch import storage

log = logging.getLogger(__name__)


def _to_numpy(obj: Any) -> Any:
    if hasattr(obj, "detach") and hasattr(obj, "numpy"):  # torch tensor
        return obj.detach().cpu().numpy()
    return obj


def decode_member(name: str, data: bytes) -> Any:
    if name.endswith(".json"):
        return json.loads(data.decode("utf-8"))
    if name.endswith((".pyd", ".pickle", ".pkl")):
        return _to_numpy(pickle.loads(data))
    if name.endswith(".npy"):
        return np.load(io.BytesIO(data), allow_pickle=False)
    if name.endswith((".txt", ".text")):
        return data.decode("utf-8")
    return data


def split_key_field(name: str) -> tuple:
    """'abc/track-001.audio_encoding.pyd' -> ('abc/track-001', 'audio_encoding.pyd')."""
    base = name
    parts = base.split("/")
    fname = parts[-1]
    dirp = "/".join(parts[:-1])
    key, _, field = fname.partition(".")
    return (f"{dirp}/{key}" if dirp else key), field


class TarShardReader:
    """Iterate samples from one or more tar shards.

    Local plain-tar shards stream through the native C++ loader
    (`native/tarloader.cpp`): file reads and the ustar parse run on
    background threads that read shards ahead, in the order of the
    sequential Python path. A gzipped, remote or missing shard sends every
    shard to the Python `tarfile` reader, as does `use_native=False`,
    `LLARK_TPU_NO_NATIVE_TAR=1` or `handler="raise"`.
    """

    def __init__(
        self, paths: Sequence[str], handler: str = "warn", use_native: bool = True
    ):
        self.paths = list(paths)
        self.handler = handler  # "warn" | "raise"
        self.use_native = use_native and not os.environ.get("LLARK_TPU_NO_NATIVE_TAR")

    @staticmethod
    def _native_parsable(path: str) -> bool:
        """The C++ loader reads raw ustar only: a gzipped (magic 0x1f8b),
        missing or short file would yield no sample there, while the Python
        tarfile path reads it. Remote shards take the Python streaming
        reader."""
        if storage.is_remote(path):
            return False
        try:
            with open(path, "rb") as f:
                head = f.read(512)
        except OSError:
            return False
        if len(head) < 512 or head[:2] == b"\x1f\x8b":
            return False
        return head[257:262] == b"ustar"

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.use_native and self.handler != "raise":
            from llark_tpu_torch.native import tarloader

            bad = [p for p in self.paths if not self._native_parsable(p)]
            if not bad:
                yield from self._iter_native(tarloader)
                return
            log.warning(
                "native tar loader cannot parse %s (gzipped/missing/short/"
                "remote); using the Python reader for all %d shard(s)",
                bad[0], len(self.paths),
            )
        for path in self.paths:
            try:
                yield from self._iter_shard(path)
            except (tarfile.TarError, OSError) as e:
                if self.handler == "raise":
                    raise
                log.warning("skipping corrupt shard %s: %s", path, e)

    def _iter_native(self, tarloader) -> Iterator[Dict[str, Any]]:
        for raw in tarloader.iter_samples(self.paths):
            sample: Dict[str, Any] = {"__key__": raw["__key__"]}
            for field, data in raw.items():
                if field == "__key__":
                    continue
                try:
                    sample[field] = decode_member(f"{raw['__key__']}.{field}", data)
                except Exception as e:  # noqa: BLE001 — skip-and-warn contract
                    log.warning("skipping corrupt member %s.%s: %s",
                                raw["__key__"], field, e)
            yield sample

    def _iter_shard(self, path: str) -> Iterator[Dict[str, Any]]:
        with contextlib.ExitStack() as stack:
            fobj = stack.enter_context(storage.fopen(path, "rb"))
            tf = stack.enter_context(tarfile.open(fileobj=fobj, mode="r|*"))
            current_key: Optional[str] = None
            sample: Dict[str, Any] = {}
            for member in tf:
                if not member.isfile():
                    continue
                key, field = split_key_field(member.name)
                data = tf.extractfile(member).read()
                if current_key is not None and key != current_key:
                    yield sample
                    sample = {}
                current_key = key
                sample["__key__"] = key
                try:
                    sample[field] = decode_member(member.name, data)
                except Exception as e:  # noqa: BLE001 — skip-and-warn contract
                    if self.handler == "raise":
                        raise
                    log.warning("skipping corrupt member %s: %s", member.name, e)
            if sample:
                yield sample


class TarShardWriter:
    """Pack samples into WebDataset-compatible tar shards.

    write({"__key__": k, "json": {...}, "audio_encoding.pyd": np.ndarray})
    Shards roll over at max_count samples.
    """

    def __init__(self, pattern: str, max_count: int = 512):
        # pattern like "/path/shard-%05d.tar"
        self.pattern = pattern
        self.max_count = max_count
        self.shard_idx = 0
        self.count = 0
        self._tar: Optional[tarfile.TarFile] = None
        self.written_paths: List[str] = []

    def _ensure_open(self):
        if self._tar is None:
            path = self.pattern % self.shard_idx
            storage.makedirs_for(path)
            self._tar = tarfile.open(fileobj=storage.fopen(path, "wb"), mode="w")
            self.written_paths.append(path)

    def write(self, sample: Dict[str, Any]) -> None:
        self._ensure_open()
        key = sample["__key__"]
        for field, value in sample.items():
            if field == "__key__":
                continue
            name = f"{key}.{field}"
            if field.endswith(".json") or field == "json":
                payload = json.dumps(value).encode("utf-8")
            elif field.endswith((".pyd", ".pickle", ".pkl")):
                payload = pickle.dumps(np.asarray(value))
            elif field.endswith(".npy"):
                buf = io.BytesIO()
                np.save(buf, np.asarray(value))
                payload = buf.getvalue()
            elif isinstance(value, bytes):
                payload = value
            else:
                payload = str(value).encode("utf-8")
            info = tarfile.TarInfo(name=name)
            info.size = len(payload)
            self._tar.addfile(info, io.BytesIO(payload))
        self.count += 1
        if self.count >= self.max_count:
            self._roll()

    def _roll(self):
        self.close()
        self.shard_idx += 1
        self.count = 0

    def close(self):
        if self._tar is not None:
            f = self._tar.fileobj
            self._tar.close()
            f.close()  # tarfile leaves a file object it was given open
            self._tar = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
