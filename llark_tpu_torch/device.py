"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
GPU and no explicit `device="cpu"` they raise instead of quietly running
on the host.
"""

from __future__ import annotations

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
