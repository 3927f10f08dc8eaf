"""What the port's captured programs share: a graph pool with its capture
stream, and the kernel wrappers' launch counters across captures and
replays.

A program (`generate.DecodeProgram`, `train.step.TrainProgram`) runs its
work once eagerly on its pool's stream, captures it as a CUDA graph on the
same stream and replays the graph at every later call. A replay launches
what its capture recorded without running the wrappers, whose launch
counters are Python increments: so the counts the capture added are taken
back, and every replay adds them again (`add_launch_counts`).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import torch

from llark_tpu_torch.ops import int8_matmul as int8_ops
from llark_tpu_torch.ops.attention import flash_attention_bwd, flash_attention_fwd
from llark_tpu_torch.ops.decode_attention import flash_decode_attention
from llark_tpu_torch.ops.int4_matmul import int4_matmul
from llark_tpu_torch.ops.int8_matmul import int8_matmul

# the kernel wrappers whose `launches` a program keeps
COUNTED = (flash_attention_fwd, flash_attention_bwd, flash_decode_attention, int8_matmul,
           int4_matmul)

Counts = Tuple[Tuple[int, ...], Dict]


def launch_counts() -> Counts:
    """Every counted wrapper's launches, and the flash-decode kernel's by
    (cache mode, Sq)."""
    return (tuple(fn.launches for fn in COUNTED),
            dict(flash_decode_attention.launches_by_window))


def count_difference(after: Counts, before: Counts) -> Counts:
    totals = tuple(a - b for a, b in zip(after[0], before[0]))
    windows = {key: n - before[1].get(key, 0) for key, n in after[1].items()}
    return totals, {key: n for key, n in windows.items() if n}


def set_launch_counts(counts: Counts) -> None:
    for fn, n in zip(COUNTED, counts[0]):
        fn.launches = n
    windows = flash_decode_attention.launches_by_window
    windows.clear()
    windows.update(counts[1])


def add_launch_counts(counts: Counts) -> None:
    """What one replay launched, added to the counters."""
    for fn, n in zip(COUNTED, counts[0]):
        fn.launches += n
    by_window = flash_decode_attention.launches_by_window
    for key, n in counts[1].items():
        by_window[key] = by_window.get(key, 0) + n


def launches_by_name(counts: Counts) -> Dict[str, int]:
    """The launches of `counts` by kernel wrapper, those that launched."""
    return {fn.__name__: n for fn, n in zip(COUNTED, counts[0]) if n}


class GraphPool:
    """What the programs of one Generator, server or trainer share on the
    card: one memory pool for their graphs (`torch.cuda.graph_pool_handle`)
    and one stream that every program warms up and is captured on, so that
    the quantized products' split workspace, kept per (device, stream)
    (`ops/int8_matmul.py` `_workspace`), exists before any capture begins.

    A pool's graphs reuse each other's intermediate memory: a program's
    outputs are valid until the next call of a program of the same pool."""

    def __init__(self, device: Union[str, torch.device]):
        self.stream = torch.cuda.Stream(device)
        self.handle = torch.cuda.graph_pool_handle()

    def workspace(self, device: torch.device):
        """The quantized products' split workspace of this pool's stream."""
        return int8_ops._workspaces.get((device.index, self.stream.cuda_stream))


def capture(pool: GraphPool, graph: torch.cuda.CUDAGraph, device: torch.device,
            fn: Callable, warm: Counts):
    """fn() captured into `graph` on the pool's stream and memory; returns
    (fn's result, the launches the capture recorded). The counters read as
    before the capture. `warm` is what the same work launched eagerly just
    before on this stream: a capture that launches otherwise depends on its
    data, and one that grows the quantized products' workspace would replay
    into memory it does not own; both raise."""
    workspace = pool.workspace(device)
    counts = launch_counts()
    try:
        with torch.cuda.graph(graph, pool=pool.handle, stream=pool.stream):
            out = fn()
        captured = count_difference(launch_counts(), counts)
    finally:
        set_launch_counts(counts)
    if pool.workspace(device) is not workspace:
        raise RuntimeError("the quantized products allocated a workspace inside the capture")
    if captured != warm:
        raise RuntimeError(
            f"the capture launched {captured}, the eager run before it {warm}: the program "
            "depends on its data"
        )
    return out, captured
