"""Per-step metrics stream of a training run (counterpart of
llark_tpu/train/tracking.py).

`<output_dir>/metrics.jsonl` gets one JSON object per logged step, append
mode and line-flushed, so a long run survives crashes and a resumed run
continues the same file (each record carries its step). The reference
logs to wandb (reference:
scripts/training/train_llark.sh:33,43); this stream is the local
equivalent. With report_to="tensorboard" the same scalars also go to
TensorBoard event files under `<output_dir>/tb/` through `tensorboardX`
where it is installed; where it is not, one warning and the JSONL stream
alone, as in the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
import time

log = logging.getLogger("llark_tpu_torch.tracking")


class MetricsWriter:
    """`report_to`: "jsonl" writes the stream, "tensorboard" the stream and
    TensorBoard events, "none" nothing."""

    def __init__(self, output_dir: str, report_to: str = "jsonl"):
        if report_to not in ("jsonl", "tensorboard", "none"):
            raise ValueError(f"unknown report_to {report_to!r}")
        self.enabled = report_to != "none"
        self._fh = None
        self._tb = None
        self._t0 = time.time()
        if not self.enabled:
            return
        os.makedirs(output_dir, exist_ok=True)
        self._fh = open(os.path.join(output_dir, "metrics.jsonl"), "a", buffering=1)
        if report_to == "tensorboard":
            try:
                from tensorboardX import SummaryWriter
            except ImportError as e:
                log.warning("tensorboardX unavailable (%s); JSONL only", e)
            else:
                self._tb = SummaryWriter(logdir=os.path.join(output_dir, "tb"))

    def log(self, step: int, **metrics: float) -> None:
        """Record scalar metrics for `step`; values are coerced to float and
        those that are not numbers are dropped."""
        if not self.enabled:
            return
        clean = {}
        for k, v in metrics.items():
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                continue
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3), **clean}
        self._fh.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(k, v, global_step=step)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
