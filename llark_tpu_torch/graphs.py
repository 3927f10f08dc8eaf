"""What the port's captured programs share: a graph pool with its capture
stream, the kernel wrappers' launch counters across captures and replays,
and `Program`, the binding, static buffers, warm-up, capture and replay of
one piece of work.

A program (`Program` and its subclasses in `generate.py` and
`inference/`, `train.step.TrainProgram`) runs its work once eagerly on its
pool's stream, captures it as a CUDA graph on the same stream and replays
the graph at every later call. A replay launches what its capture recorded
without running the wrappers, whose launch counters are Python increments:
so the counts the capture added are taken back, and every replay adds them
again (`add_launch_counts`).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

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


# what a binding mismatch names, by `Program.bind` keyword
_BOUND = {"params": "params tree", "cache": "cache tensors", "rows": "row cache tensors"}


def _same(name: str, got: Any, want: Any) -> bool:
    """A cache's tensors key by key and everything else by identity, but
    host values (ints, tuples) by equality."""
    if name in ("cache", "rows"):
        return got.keys() == want.keys() and all(got[k] is want[k] for k in want)
    if isinstance(want, (int, float, str, tuple)):
        return got == want
    return got is want


class Program:
    """One piece of work bound to its tensors and, on the card, one CUDA
    graph: the binding, the static buffers, the warm-up, the capture and
    the replay that the port's captured programs share. A subclass's call
    does three things, in order:

      * `bind(name=object, ...)`: at the first call the program keeps what
        its work reads and writes in place -- the params tree, a cache's
        tensors (`cache_tensors`) -- and any host value the work bakes in,
        such as a cache index it reads as an int. A later call must pass
        the same tensors (identity) and equal values, or it raises
        ValueError: callers write new contents into the bound tensors in
        place;
      * `stage(name=tensor, ...)`: copies the call's inputs into static
        buffers made at the first call; an input of another shape or dtype
        raises (a program serves one batch and shape, as a jit is traced
        per shape);
      * `run(body, device)`: body() computes from the bound objects and the
        staged buffers and returns the program's outputs, a tuple of
        tensors. On CPU tensors it runs eagerly at every call. On the card,
        at the first call, it runs once eagerly on the pool's stream (the
        warm-up, which builds the kernels, loads their libraries and
        allocates every lazily kept buffer outside the graph), then is
        captured into the pool (`capture`) and replayed; later calls replay.
        The outputs are copied inside the graph into buffers the program
        owns, made before the capture outside the pool: a pool's graphs
        reuse each other's memory (`GraphPool`), so only such buffers hold
        across the replays of the pool's other programs. They hold until
        the program's own next call.

    Every call adds the launches the capture recorded (`launches`,
    `launches_by_window`). A capture that fails raises; nothing falls back
    to eager work. Generators the body draws from (`run(generators=)`) are
    registered with the graph and set back after the warm-up, so the
    replay that follows the capture draws what the warm-up drew.
    `warm_ms` and `capture_ms` are the host's wall time of the first
    call's warm-up and capture on the card, each up to a synchronize."""

    what = "program"

    def __init__(self, pool: Optional[GraphPool] = None):
        self.pool = pool
        self._bound: Optional[Dict[str, Any]] = None
        self._inputs: Optional[Dict[str, torch.Tensor]] = None  # static inputs
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self._graph = None
        self._workspace = None  # the products' split workspace the graph writes
        self._captured: Optional[Counts] = None  # launches a call adds
        self.warm_ms: Optional[float] = None
        self.capture_ms: Optional[float] = None
        self.calls = 0

    @property
    def launches(self) -> Dict[str, int]:
        """The launches one call adds on the card, by kernel wrapper (those
        it launches); empty before the capture and on the CPU."""
        return {} if self._captured is None else launches_by_name(self._captured)

    @property
    def launches_by_window(self) -> Dict[Tuple[str, int], int]:
        """The flash-decode launches one call adds, by (cache mode, Sq)."""
        return {} if self._captured is None else dict(self._captured[1])

    def bind(self, **objects: Any) -> None:
        if self._bound is None:
            self._bound = objects
            return
        for name, obj in objects.items():
            if not _same(name, obj, self._bound[name]):
                raise ValueError(
                    f"this {self.what} program was bound to another {_BOUND.get(name, name)}"
                    + ("; write new contents into the bound tensors in place instead of "
                       "passing new tensors" if name in ("cache", "rows") else "")
                )

    def stage(self, **inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The static buffers, holding the call's inputs."""
        if self._inputs is None:
            self._inputs = {k: torch.empty_like(v) for k, v in inputs.items()}
        else:
            want = {k: (tuple(v.shape), v.dtype) for k, v in self._inputs.items()}
            got = {k: (tuple(v.shape), v.dtype) for k, v in inputs.items()}
            if got != want:
                raise ValueError(f"this {self.what} program runs one batch and shape, {want}; "
                                 f"got {got}")
        for k, v in inputs.items():
            self._inputs[k].copy_(v)
        return self._inputs

    def run(self, body: Callable[[], Sequence[torch.Tensor]], device: torch.device,
            generators: Sequence[torch.Generator] = ()) -> Tuple[torch.Tensor, ...]:
        if device.type != "cuda":
            self.outputs = tuple(body())
        else:
            if self._graph is None:
                self._capture(body, device, generators)
            self._graph.replay()
            add_launch_counts(self._captured)
        self.calls += 1
        return self.outputs

    def _capture(self, body, dev: torch.device, generators) -> None:
        pool = self.pool if self.pool is not None else GraphPool(dev)
        self.pool = pool
        states = [g.get_state() for g in generators]
        counts = launch_counts()
        t0 = time.perf_counter()
        try:
            # the warm-up: the eager work on the capture stream, then the graph
            pool.stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(pool.stream):
                warm_out = tuple(body())
            torch.cuda.current_stream(dev).wait_stream(pool.stream)
            warm = count_difference(launch_counts(), counts)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            # kept: a later warm-up on this stream may replace a workspace it
            # outgrows, and the graph writes this one
            self._workspace = pool.workspace(dev)
            outputs = tuple(torch.empty_like(t) for t in warm_out)
            del warm_out
            for g, state in zip(generators, states):
                g.set_state(state)
            graph = torch.cuda.CUDAGraph()
            for g in generators:
                graph.register_generator_state(g)

            def recorded():
                for dst, src in zip(outputs, body()):
                    dst.copy_(src)

            _, self._captured = capture(pool, graph, dev, recorded, warm)
            torch.cuda.synchronize(dev)
        finally:
            set_launch_counts(counts)
        self.outputs, self._graph = outputs, graph
        self.warm_ms, self.capture_ms = (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def cache_tensors(cache: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The tensors of a cache dict a program binds to: k, v, the int8
    scales and a paged cache's block tables."""
    return {k: cache[k] for k in ("k", "v", "k_scale", "v_scale", "block_tables") if k in cache}


def as_index(ids, device: torch.device) -> torch.Tensor:
    """An int, a sequence of ints or an int64 device tensor as a 1-d int64
    index on `device`. A program's static buffer passes through as it is:
    an int would need a host-to-device copy, which a capture refuses."""
    return torch.as_tensor(ids, dtype=torch.long, device=device).reshape(-1)
