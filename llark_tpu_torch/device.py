"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
GPU and no explicit `device="cpu"` they raise instead of quietly running
on the host. `full_fp32` keeps fp32 products in full precision (no TF32)
inside a block, for the paths whose result a TF32 rounding would move.
"""

from __future__ import annotations

import contextlib
from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return `device` as a torch.device; raise if it is a CUDA device and
    no GPU is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "llark_tpu_torch runs on a CUDA GPU by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


@contextlib.contextmanager
def full_fp32():
    """No TF32 in cuDNN convolutions or cuBLAS products inside the block,
    whatever the caller's flags say; they are restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
