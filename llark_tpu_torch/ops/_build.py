"""Build and load the hand-written CUDA kernels of `llark_tpu_torch/csrc/`.

Each `csrc/*.cu` source (the three flash-attention kernels' and the two
weight-only quantized products', `int8_matmul.cu` and `int4_matmul.cu`,
which share `wq_matmul.cuh`) has a plain C interface and is compiled by
`nvcc` for Hopper (`sm_90a`) into its own shared library, loaded with
`ctypes`.
The build happens at first use, never at import: every source is compiled
at once, one `nvcc` process each, into `llark_tpu_torch/_build/`, with a
file name keyed by a hash of the source, the shared headers (`csrc/*.cuh`)
and the flags, so an edited kernel is rebuilt and an unchanged one is
reused. `nvcc -Xptxas -v`'s
report (registers, shared memory, spills) is kept beside each library and
returned by `build_all()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("flash_fwd.cu", "flash_decode.cu", "flash_bwd.cu", "int8_matmul.cu", "int4_matmul.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are "
            "built from source at first use on a machine with the toolkit"
        )
    return path


def _lib_path(source: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for name in (source, *headers):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.
    Returns {source: ptxas report}; raises with nvcc's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for src in SOURCES:
        out = _lib_path(src)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
        procs[src] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        with open(out + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    reports = {}
    for src in SOURCES:
        log_path = _lib_path(src) + ".log"
        if os.path.exists(log_path):
            with open(log_path) as f:
                reports[src] = f.read()
    return reports


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one `csrc/` source, building all at first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = _lib_path(source)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            _libs[source] = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
