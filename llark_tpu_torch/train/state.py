"""Train state: params + optimizer state + step (counterpart of
llark_tpu/train/state.py).

Params are the port's nested dict of tensors; the tensors that train are
those with `requires_grad` set. The optimizer state covers only them
(frozen leaves hold no state), and both are updated in place by the train
step: at 7B width a functional copy of the parameters and moments would
not fit beside them.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List

import torch


def iter_leaves(tree: Dict[str, Any], prefix: str = "") -> Iterator:
    """(path, tensor) for every leaf of a nested dict, in insertion order;
    paths join the keys with '/'."""
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, dict):
            yield from iter_leaves(value, path + "/")
        else:
            yield path, value


def trainable_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    return [t for _, t in iter_leaves(params) if t.requires_grad]


class TrainState:
    """(params, opt_state, step); `step` counts optimizer steps taken."""

    def __init__(self, params: Dict[str, Any], opt_state: Dict[str, Any], step: int = 0):
        self.params = params
        self.opt_state = opt_state
        self.step = step

    @classmethod
    def create(cls, params: Dict[str, Any], optimizer) -> "TrainState":
        return cls(params, optimizer.init(trainable_leaves(params)), 0)
