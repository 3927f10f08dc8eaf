"""Storage seam: the local-path subset of llark_tpu/storage.py.

Every path the port's training and audio I/O touch (shards, checkpoints,
the projector side-save, WAV files, extracted embeddings) goes through
these helpers, so the remote-storage slice can add
`scheme://` URLs in one place. This slice reads and writes local paths
(plain or `file://`) only; any other URL raises.
"""

from __future__ import annotations

import contextlib
import glob as _glob
import os
import re
from typing import IO, Iterator, List

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")


def is_remote(path: str) -> bool:
    """True for `scheme://` URLs other than file:// (which is local)."""
    if not isinstance(path, str):
        return False
    return bool(_SCHEME_RE.match(path)) and not path.startswith("file://")


def _local(path: str) -> str:
    if is_remote(path):
        raise NotImplementedError(
            f"remote storage ({path.split('://')[0]}://) comes with a later slice "
            "of the port; this one reads and writes local paths"
        )
    return path[len("file://"):] if path.startswith("file://") else path


def fopen(path: str, mode: str = "rb") -> IO:
    return open(_local(path), mode)


def read_bytes(path: str) -> bytes:
    with fopen(path, "rb") as f:
        return f.read()


def write_bytes(path: str, data: bytes) -> None:
    makedirs_for(path)
    with fopen(path, "wb") as f:
        f.write(data)


def exists(path: str) -> bool:
    return os.path.exists(_local(path))


def fs_glob(pattern: str) -> List[str]:
    """Sorted matches of a glob pattern."""
    return sorted(_glob.glob(_local(pattern)))


def listdir(path: str) -> List[str]:
    return sorted(os.listdir(_local(path)))


def makedirs_for(path: str) -> None:
    """mkdir -p the parent of `path`."""
    parent = os.path.dirname(_local(path))
    if parent:
        os.makedirs(parent, exist_ok=True)


def join(base: str, *parts: str) -> str:
    return os.path.join(_local(base), *parts)


@contextlib.contextmanager
def local_input(path: str) -> Iterator[str]:
    """Yield a real local file path for `path`."""
    yield _local(path)


@contextlib.contextmanager
def local_output(path: str) -> Iterator[str]:
    """Yield a local path to write, its parent directory made."""
    makedirs_for(path)
    yield _local(path)


def normalize_checkpoint_dir(directory: str) -> str:
    """Absolute path of a local checkpoint directory, made if missing."""
    directory = os.path.abspath(_local(directory))
    os.makedirs(directory, exist_ok=True)
    return directory
