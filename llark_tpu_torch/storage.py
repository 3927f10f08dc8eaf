"""Storage seam: scheme-aware open/glob/exists over fsspec (counterpart of
llark_tpu/storage.py).

Every path the port touches (shards, checkpoints, the projector side-save,
WAV files, extracted embeddings, JSONL records) goes through these helpers.
Local paths (plain or `file://`) go to the plain filesystem; `scheme://`
URLs go to fsspec (`gs://` through gcsfs, `memory://` for tests, anything
else fsspec knows). fsspec is imported only when a remote URL comes, so the
local paths need neither it nor its import time; a remote URL on a machine
without fsspec raises its ImportError, as the reference does.

Checkpoints: the port writes torch.save files, not orbax directories, so
`rmtree` and `move` carry the checkpoint manager's replace-when-complete
over to object stores (the reference leaves that to orbax).
"""

from __future__ import annotations

import contextlib
import glob as _glob
import os
import re
import shutil
import tempfile
from typing import IO, Iterator, List

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")


def is_remote(path: str) -> bool:
    """True for `scheme://` URLs other than file:// (which is local)."""
    if not isinstance(path, str):
        return False
    return bool(_SCHEME_RE.match(path)) and not path.startswith("file://")


def strip_file_scheme(path: str) -> str:
    return path[len("file://"):] if path.startswith("file://") else path


def _fs_for(path: str):
    import fsspec

    fs, _ = fsspec.core.url_to_fs(path)
    return fs


def fopen(path: str, mode: str = "rb") -> IO:
    """Open local paths with builtin open(), remote URLs via fsspec."""
    if is_remote(path):
        import fsspec

        return fsspec.open(path, mode).open()
    return open(strip_file_scheme(path), mode)


def read_bytes(path: str) -> bytes:
    with fopen(path, "rb") as f:
        return f.read()


def write_bytes(path: str, data: bytes) -> None:
    makedirs_for(path)
    with fopen(path, "wb") as f:
        f.write(data)


def exists(path: str) -> bool:
    if is_remote(path):
        return _fs_for(path).exists(path)
    return os.path.exists(strip_file_scheme(path))


def fs_glob(pattern: str) -> List[str]:
    """Glob with the scheme preserved on the results (fsspec strips it)."""
    if not is_remote(pattern):
        return sorted(_glob.glob(strip_file_scheme(pattern)))
    fs = _fs_for(pattern)
    return sorted(fs.unstrip_protocol(p) for p in fs.glob(pattern))


def listdir(path: str) -> List[str]:
    if not is_remote(path):
        return sorted(os.listdir(strip_file_scheme(path)))
    fs = _fs_for(path)
    return sorted(os.path.basename(p.rstrip("/")) for p in fs.ls(path, detail=False))


def makedirs_for(path: str) -> None:
    """mkdir -p the parent of `path` (no-op on object stores)."""
    if is_remote(path):
        return  # object stores have no directories
    parent = os.path.dirname(strip_file_scheme(path))
    if parent:
        os.makedirs(parent, exist_ok=True)


def join(base: str, *parts: str) -> str:
    """Path join that keeps URL semantics for remote bases."""
    if is_remote(base):
        return "/".join([base.rstrip("/")] + [p.strip("/") for p in parts])
    return os.path.join(strip_file_scheme(base), *parts)


def rmtree(path: str) -> None:
    """Remove a directory tree (every object under a remote prefix); no
    error if there is none."""
    if not is_remote(path):
        shutil.rmtree(strip_file_scheme(path), ignore_errors=True)
        return
    fs = _fs_for(path)
    if fs.exists(path):
        fs.rm(path, recursive=True)


def move(src: str, dst: str) -> None:
    """Rename `src` to `dst` (a directory tree too); on an object store, a
    copy of every object and the removal of the source."""
    if not is_remote(src):
        os.replace(strip_file_scheme(src), strip_file_scheme(dst))
        return
    _fs_for(src).mv(src, dst, recursive=True)


@contextlib.contextmanager
def local_input(path: str) -> Iterator[str]:
    """Yield a real local file path for `path` (download remote to temp).

    For tools that need an on-disk file (ffmpeg, ctypes readers). Local
    paths pass through untouched.
    """
    if not is_remote(path):
        yield strip_file_scheme(path)
        return
    suffix = os.path.splitext(path)[1]
    fd, tmp = tempfile.mkstemp(suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as out, fopen(path, "rb") as src:
            shutil.copyfileobj(src, out)
        yield tmp
    finally:
        os.unlink(tmp)


@contextlib.contextmanager
def local_output(path: str) -> Iterator[str]:
    """Yield a local path to write; upload to `path` on clean exit."""
    if not is_remote(path):
        p = strip_file_scheme(path)
        makedirs_for(p)
        yield p
        return
    suffix = os.path.splitext(path)[1]
    fd, tmp = tempfile.mkstemp(suffix=suffix)
    os.close(fd)
    try:
        yield tmp
        with open(tmp, "rb") as src, fopen(path, "wb") as out:
            shutil.copyfileobj(src, out)
    finally:
        os.unlink(tmp)


def normalize_checkpoint_dir(directory: str) -> str:
    """Local dirs -> abspath + mkdir; remote URLs pass through untouched
    but for a trailing slash."""
    if is_remote(directory):
        return directory.rstrip("/")
    directory = os.path.abspath(strip_file_scheme(directory))
    os.makedirs(directory, exist_ok=True)
    return directory
