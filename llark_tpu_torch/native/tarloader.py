"""ctypes wrapper for the native tar shard loader (tarloader.cpp).

`iter_samples(paths)` yields the same {"__key__", field: bytes} groups as
the Python tarfile path of llark_tpu_torch/data/webdataset.py, with the
file reads and the ustar parse on C++ threads that read shards ahead of
the consumer. Decoding (json, pickle, npy) stays in Python, on the
consumer's side. The library is built at first use (`native/build.py`);
a failed build raises.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Dict, Iterator, Sequence

from llark_tpu_torch.native.build import calls, load

log = logging.getLogger(__name__)


def load_library() -> ctypes.CDLL:
    return load("tarloader.cpp")


def iter_samples(
    paths: Sequence[str], n_threads: int = 2, readahead: int = 2
) -> Iterator[Dict[str, bytes]]:
    """Yield {"__key__": str, field_name: raw bytes} per sample, in shard
    order. A shard that cannot be read, or whose headers stop checking out,
    yields what it held up to there, with a warning."""
    lib = load_library()
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    h = lib.ljt_loader_open(arr, len(paths), n_threads, readahead)
    try:
        while True:
            s = lib.ljt_loader_next(h)
            if not s:
                break
            try:
                out: Dict[str, bytes] = {
                    "__key__": lib.ljt_sample_key(s).decode()
                }
                for i in range(lib.ljt_sample_nfields(s)):
                    name = lib.ljt_sample_field_name(s, i).decode()
                    size = lib.ljt_sample_field_size(s, i)
                    ptr = lib.ljt_sample_field_data(s, i)
                    out[name] = ctypes.string_at(ptr, size) if size else b""
                calls["tar_samples"] += 1
                yield out
            finally:
                lib.ljt_sample_free(s)
        for i, path in enumerate(paths):
            if lib.ljt_loader_shard_failed(h, i):
                log.warning("skipping the rest of corrupt shard %s", path)
    finally:
        lib.ljt_loader_close(h)
