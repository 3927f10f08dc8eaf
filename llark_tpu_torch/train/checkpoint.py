"""Checkpoint save/restore in the port's own torch.save format (counterpart
of llark_tpu/train/checkpoint.py, which writes orbax directories).

Parity targets:
  * HF-Trainer style periodic checkpoints with save_total_limit
    (reference: scripts/training/train_llark.sh:42, save_total_limit 1);
  * auto-resume from the latest checkpoint (reference: m2t/train.py:255-260);
  * the projector side-save `mm_projector/checkpoint-N.npz` per save, in the
    JAX package's format (keys "mm_projector.kernel", "mm_projector.bias",
    "embed"), so `llark_tpu.train.checkpoint.load_projector_weights` reads
    it too (reference: m2t/models/trainer.py:35-65);
  * data-iterator state (seed, batches seen) saved alongside params.

Layout: `<dir>/checkpoint-<step>/state.pt` holding {"params", "opt_state",
"step", "data_state"}; torch.save copies each tensor off the card as it
writes it (no second host copy of the whole state), and restore maps them
to the CPU and copies them into the live tensors. A checkpoint is
written under a temporary name and renamed when complete, so a run cut
during a save resumes from the previous one. A `scheme://` directory
(`gs://`, `memory://`) is written through the storage seam, where the
reference hands such URLs to orbax; there the rename is a copy.
"""

from __future__ import annotations

import io
import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from llark_tpu_torch import storage
from llark_tpu_torch.train.state import TrainState, iter_leaves

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detach(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy in float32 when numpy has no dtype for the tensor's
    (bfloat16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class CheckpointManager:
    def __init__(self, directory: str, save_total_limit: int = 1, save_projector: bool = False):
        self.directory = storage.normalize_checkpoint_dir(directory)
        self.save_total_limit = max(1, save_total_limit)
        self.save_projector = save_projector

    def steps(self):
        """Steps of the complete checkpoints in the directory, ascending."""
        if not storage.exists(self.directory):  # a remote prefix nothing was written under
            return []
        found = (_CKPT_RE.match(n) for n in storage.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return storage.join(self.directory, f"checkpoint-{step}")

    def save(self, step: int, state: TrainState, data_state: Optional[Dict] = None) -> None:
        payload = {
            "params": _detach(state.params),
            "opt_state": _detach(state.opt_state),
            "step": int(state.step),
            "data_state": data_state,
        }
        final = self._path(step)
        tmp = final + ".tmp"
        storage.rmtree(tmp)
        path = storage.join(tmp, "state.pt")
        storage.makedirs_for(path)
        if storage.is_remote(path):
            with storage.fopen(path, "wb") as f:
                torch.save(payload, f)
        else:  # by name: torch writes a local file from C++
            torch.save(payload, path)
        storage.rmtree(final)
        storage.move(tmp, final)
        if self.save_projector:
            self._save_projector(step, state.params)
        for old in self.steps()[: -self.save_total_limit]:
            storage.rmtree(self._path(old))

    def _save_projector(self, step: int, params: Dict[str, Any]) -> None:
        """Side-save of the adapter weights as a plain npz (host-readable
        without torch; mirrors mm_projector/checkpoint-N.bin). bf16 tensors
        are written as float32."""
        out = {}
        if "mm_projector" in params:
            out["mm_projector.kernel"] = _numpy(params["mm_projector"]["kernel"])
            out["mm_projector.bias"] = _numpy(params["mm_projector"]["bias"])
        out["embed"] = _numpy(params["embed"])
        path = storage.join(self.directory, "mm_projector", f"checkpoint-{step}.npz")
        storage.makedirs_for(path)
        with storage.fopen(path, "wb") as f:
            np.savez(f, **out)

    @torch.no_grad()
    def restore(self, state: TrainState, step: Optional[int] = None,
                local: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
                ) -> Optional[Tuple[TrainState, Optional[Dict]]]:
        """Load a checkpoint (the latest by default) into the tensors of
        `state`, in place: their devices, dtypes and requires_grad flags
        stay. Returns (state, data_state), or None if there is none.

        Checkpoints hold whole tensors. On a mesh, `local(path, tensor)`
        cuts this rank's shard of the saved params/<path> (and of its
        optimizer moments), so a run saved on one mesh restores on another
        or on none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        state_pt = storage.join(self._path(step), "state.pt")
        if storage.is_remote(state_pt):
            with storage.fopen(state_pt, "rb") as f:
                payload = torch.load(io.BytesIO(f.read()), map_location="cpu", weights_only=True)
        else:
            payload = torch.load(state_pt, map_location="cpu", weights_only=True)
        saved = dict(iter_leaves(payload["params"]))
        for path, t in iter_leaves(state.params):
            src = saved.get(path)
            if src is not None and local is not None:
                src = local(path, src)
            if src is None or src.shape != t.shape:
                raise ValueError(f"checkpoint-{step} does not hold params/{path} as {tuple(t.shape)}")
            t.copy_(src)
        opt = payload["opt_state"]
        # the moments of the trainable leaves, in their order
        trained = [path for path, t in iter_leaves(state.params) if t.requires_grad]
        for key in ("mu", "nu"):
            if len(opt[key]) != len(state.opt_state[key]):
                raise ValueError(f"checkpoint-{step} optimizer state covers other tensors")
            for i, (dst, src) in enumerate(zip(state.opt_state[key], opt[key])):
                dst.copy_(src if local is None else local(trained[i], src))
        state.opt_state["count"] = int(opt["count"])
        state.step = int(payload["step"])
        return state, payload.get("data_state")


def load_projector_weights(path: str) -> Dict[str, np.ndarray]:
    """Load a side-saved projector npz (pretrain_mm_mlp_adapter parity);
    reads the JAX package's files too."""
    with storage.fopen(path, "rb") as f:
        data = np.load(io.BytesIO(f.read()))
        return {k: data[k] for k in data.files}


@torch.no_grad()
def apply_pretrained_projector(params: Dict[str, Any], weights: Dict[str, np.ndarray]):
    """Copy side-saved projector(+embed) weights into a params tree, in
    place, keeping each tensor's device and dtype."""
    targets = []
    if "mm_projector.kernel" in weights:
        targets += [(params["mm_projector"]["kernel"], weights["mm_projector.kernel"]),
                    (params["mm_projector"]["bias"], weights["mm_projector.bias"])]
    if "embed" in weights:
        targets.append((params["embed"], weights["embed"]))
    for t, w in targets:
        if tuple(t.shape) != tuple(w.shape):
            raise ValueError(f"pretrained adapter weight {w.shape} does not fit {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.asarray(w, np.float32)))
    return params
