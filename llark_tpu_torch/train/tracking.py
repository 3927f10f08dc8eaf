"""Per-step metrics stream of a training run (counterpart of
llark_tpu/train/tracking.py).

`<output_dir>/metrics.jsonl` gets one JSON object per logged step, append
mode and line-flushed, so a long run survives crashes and a resumed run
continues the same file (each record carries its step). The reference
logs to wandb (reference:
scripts/training/train_llark.sh:33,43); this stream is the local
equivalent.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    """`report_to`: "jsonl" writes the stream, "none" disables it.
    "tensorboard" raises: TensorBoard event files come with a later slice
    of the port (the port does not depend on the tensorboard package)."""

    def __init__(self, output_dir: str, report_to: str = "jsonl"):
        if report_to == "tensorboard":
            raise NotImplementedError(
                "report_to='tensorboard' comes with a later slice of the port; "
                "use 'jsonl' or 'none'"
            )
        if report_to not in ("jsonl", "none"):
            raise ValueError(f"unknown report_to {report_to!r}")
        self.enabled = report_to != "none"
        self._fh = None
        self._t0 = time.time()
        if self.enabled:
            os.makedirs(output_dir, exist_ok=True)
            self._fh = open(os.path.join(output_dir, "metrics.jsonl"), "a", buffering=1)

    def log(self, step: int, **metrics: float) -> None:
        """Record scalar metrics for `step`; values are coerced to float and
        those that are not numbers are dropped."""
        if not self.enabled:
            return
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
