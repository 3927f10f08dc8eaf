"""A world of local ranks: n spawned processes on this host, joined in one
process group, each running the functions it is handed.

    with LocalWorld(4) as world:          # gloo, CPU tensors
        results = world.run(fn, arg)      # fn(arg) on every rank, by rank

`fn` must be importable by name (a module-level function) and its result
picklable. On the card, `LocalWorld(2, device="cuda")` puts both ranks on
card 0 of a one-GPU host over gloo (`parallel/comm.py` stages the
collectives gloo does not take on CUDA); `torchrun` is the launcher for a
real multi-card or multi-node run. A rank that raises fails the call with
its traceback and tears the world down (the other ranks may be waiting in
a collective; they get `grace_s` to answer).
"""

from __future__ import annotations

import datetime
import queue
import socket
import traceback
from typing import Any, Callable, List, Optional

import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(rank: int, world: int, port: int, backend: str, device: str, timeout_s: float,
           inbox, outbox) -> None:
    import torch
    import torch.distributed as dist

    _die_with_parent()
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    outbox.put((rank, True, "ready"))
    while True:
        job = inbox.get()
        if job is None:
            break
        fn, args, kwargs = job
        try:
            outbox.put((rank, True, fn(*args, **kwargs)))
        except BaseException:  # noqa: BLE001 -- reported to the caller
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


def _die_with_parent() -> None:
    """Ask Linux to kill this rank when the process that spawned it dies,
    so no rank outlives its world (a rank stuck in a collective would)."""
    try:
        import ctypes
        import signal

        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


class LocalWorld:
    """n ranks of one process group on this host (see the module docstring)."""

    def __init__(self, n: int, backend: str = "gloo", device: str = "cpu",
                 timeout_s: float = 300.0, grace_s: float = 20.0):
        self.n = n
        self.grace_s = grace_s
        self.timeout_s = timeout_s
        ctx = mp.get_context("spawn")
        self._inbox = [ctx.Queue() for _ in range(n)]
        self._outbox = ctx.Queue()
        port = free_port()
        self._procs = [
            ctx.Process(target=_serve, daemon=True,
                        args=(r, n, port, backend, device, timeout_s, self._inbox[r], self._outbox))
            for r in range(n)
        ]
        for p in self._procs:
            p.start()
        self._collect("ready")

    def _collect(self, what: str) -> List[Any]:
        got: dict = {}
        failure: Optional[str] = None
        deadline = self.timeout_s
        while len(got) < self.n:
            try:
                rank, ok, value = self._outbox.get(timeout=deadline)
            except queue.Empty:
                self.close()
                missing = sorted(set(range(self.n)) - set(got))
                raise RuntimeError(failure or f"ranks {missing} gave no answer for {what}")
            got[rank] = value
            if not ok and failure is None:
                failure = f"rank {rank} failed in {what}:\n{value}"
                deadline = self.grace_s  # the others may be stuck in a collective
        if failure is not None:
            self.close()  # the ranks' collectives may be out of step now
            raise RuntimeError(failure)
        return [got[r] for r in range(self.n)]

    def run(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """fn(*args, **kwargs) on every rank; the results in rank order."""
        if not self._procs:
            raise RuntimeError("this LocalWorld is closed")
        for q in self._inbox:
            q.put((fn, args, kwargs))
        return self._collect(getattr(fn, "__name__", "a job"))

    def close(self) -> None:
        for q in self._inbox:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self._procs = []

    def __enter__(self) -> "LocalWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
