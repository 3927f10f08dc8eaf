"""Build and load the port's native host libraries (g++ on the host, not nvcc).

`audioproc.cpp` (WAV parse and mono mix, Kaiser-windowed sinc resample,
peak normalisation) and `tarloader.cpp` (the threaded WebDataset tar
reader, `native/tarloader.py`) are compiled at first use, never at import,
with `g++ -O3 -march=native -shared -fPIC` (`-pthread` for the tar loader)
into `llark_tpu_torch/_build/`. A library's file name carries a hash of its
source, the compiler, the flags and the host CPU (`-march=native` code runs
only where it was built), and it is written under a temporary name and
renamed, so that processes building at once do not collide.

A failed build raises with the compiler's output: the port does not fall
back to its numpy routes when the library is missing. `load_library()`
returns the audio library with its ctypes signatures.

`calls` counts the calls of each native entry point made by the port's
wrappers (`audio/io.py`, `native/tarloader.py`; the tar loader counts
samples), so that a driver can show a path went through the library.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
EXTRA_FLAGS = {"audioproc.cpp": (), "tarloader.cpp": ("-pthread",)}

calls: Dict[str, int] = collections.Counter()

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _host_cpu() -> bytes:
    """The CPU model and feature flags that -march=native compiles for."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().split(b"\n\n")[0].splitlines()
        return b"\n".join(l for l in lines if l.startswith((b"model name", b"flags")))
    except OSError:
        return platform.processor().encode()


def lib_path(source: str) -> str:
    """Where the library of `native/<source>` is (or will be) built."""
    flags = (CXX, *CXX_FLAGS, *EXTRA_FLAGS[source])
    digest = hashlib.sha256(" ".join(flags).encode() + _host_cpu())
    with open(os.path.join(_HERE, source), "rb") as f:
        digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def compile_native(src: str, so: str, extra_flags=()) -> None:
    """g++ build of one source file into a shared object, written to a
    temporary name and renamed; raises with the compiler's output."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [CXX, *CXX_FLAGS, *extra_flags, "-o", tmp, src]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native build of {os.path.basename(src)} failed: "
                           f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native build of {os.path.basename(src)} failed "
                           f"({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builds race harmlessly


def _audio_signatures(lib: ctypes.CDLL) -> None:
    fp = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lp = ctypes.POINTER(ctypes.c_long)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.ljt_peak_normalize.argtypes = [fp, ctypes.c_long]
    lib.ljt_resample_len.argtypes = [ctypes.c_long, ctypes.c_int, ctypes.c_int]
    lib.ljt_resample_len.restype = ctypes.c_long
    lib.ljt_resample.argtypes = [
        fp, ctypes.c_long, ctypes.c_int,
        fp, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
    ]
    lib.ljt_parse_wav.argtypes = [u8p, ctypes.c_long, fp, lp, ip, ip]
    lib.ljt_parse_wav.restype = ctypes.c_int


def _tar_signatures(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.ljt_loader_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_int, ctypes.c_long,
    ]
    lib.ljt_loader_open.restype = vp
    lib.ljt_loader_next.argtypes = [vp]
    lib.ljt_loader_next.restype = vp
    lib.ljt_loader_shard_failed.argtypes = [vp, ctypes.c_long]
    lib.ljt_loader_shard_failed.restype = ctypes.c_int
    lib.ljt_loader_close.argtypes = [vp]
    lib.ljt_sample_key.argtypes = [vp]
    lib.ljt_sample_key.restype = ctypes.c_char_p
    lib.ljt_sample_nfields.argtypes = [vp]
    lib.ljt_sample_nfields.restype = ctypes.c_long
    lib.ljt_sample_field_name.argtypes = [vp, ctypes.c_long]
    lib.ljt_sample_field_name.restype = ctypes.c_char_p
    lib.ljt_sample_field_size.argtypes = [vp, ctypes.c_long]
    lib.ljt_sample_field_size.restype = ctypes.c_long
    lib.ljt_sample_field_data.argtypes = [vp, ctypes.c_long]
    lib.ljt_sample_field_data.restype = ctypes.c_void_p
    lib.ljt_sample_free.argtypes = [vp]


_SIGNATURES = {"audioproc.cpp": _audio_signatures, "tarloader.cpp": _tar_signatures}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `native/<source>` with its ctypes signatures,
    built at first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = lib_path(source)
            if not os.path.exists(path):
                compile_native(os.path.join(_HERE, source), path, EXTRA_FLAGS[source])
            lib = ctypes.CDLL(path)
            _SIGNATURES[source](lib)
            _libs[source] = lib
        return lib


def load_library() -> ctypes.CDLL:
    """The audio library (`audioproc.cpp`)."""
    return load("audioproc.cpp")
