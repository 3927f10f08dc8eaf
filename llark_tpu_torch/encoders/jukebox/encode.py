"""Jukebox embedding extraction (audio -> [T_pooled, 4800]); counterpart of
llark_tpu/encoders/jukebox/encode.py.

Behavior parity with reference jukebox/main.py:
  SR=44100, window=2^20 samples, T=8192 activation frames ...... :10-22
  load: mono mean, peak-normalize ............................. :29-45
  pad to 2^20 ................................................. :48-51
  VQ-VAE top-level codes ...................................... :54-68
  prior only-encode activations [8192, 4800] .................. :101-110
  truncate to floor(T * input_len / 2^20) ..................... :154
  mean-pool windows of frame_len = floor(344.53/fps) .......... :113-131

A batch of clips goes through codes, activations and pooling on the
device in one call; true lengths ride along as frame counts, applied on
the host when the files are written.
"""

from __future__ import annotations

import dataclasses
from math import floor
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.encoders.jukebox.config import JukeboxPriorConfig, JukeboxVQVAEConfig
from llark_tpu_torch.encoders.jukebox.prior import init_prior_params, prior_encode
from llark_tpu_torch.encoders.jukebox.vqvae import encode_top, init_vqvae_params
from llark_tpu_torch.models.decoder import torch_dtype
from llark_tpu_torch.parallel.mesh import check_mesh, gather_rows, split_rows

JUKEBOX_SAMPLE_RATE = 44100
JUKEBOX_EXPECTED_SAMPLES_LEN = 1048576  # 2^20
JUKEBOX_SAMPLE_SECONDS = JUKEBOX_EXPECTED_SAMPLES_LEN / JUKEBOX_SAMPLE_RATE
T_ACTS = 8192
ACTS_SAMPLE_RATE = T_ACTS / JUKEBOX_SAMPLE_SECONDS  # 344.53125 Hz


class EmptyFileError(ValueError):
    """An audio file with no samples (llark_tpu/encoders/jukebox/encode.py:40)."""


def prepare_audio(audio: np.ndarray) -> np.ndarray:
    """Mono-mean, peak-normalize, flatten (reference :29-45)."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 2:
        audio = audio.mean(axis=0)
    norm = np.abs(audio).max()
    if norm > 0:
        audio = audio / norm
    return audio.flatten()


def pad_or_crop(
    audio: np.ndarray, target_len: int = JUKEBOX_EXPECTED_SAMPLES_LEN
) -> np.ndarray:
    if len(audio) < target_len:
        audio = np.pad(audio, (0, target_len - len(audio)))
    return audio[:target_len]


def pooled_frame_len(pool_frames_per_second: float) -> int:
    return floor(ACTS_SAMPLE_RATE / pool_frames_per_second)  # fps=10 -> 34


def windowed_average(acts: torch.Tensor, frame_len: int) -> torch.Tensor:
    """[..., T, D] -> [..., T//frame_len, D]; floor mode (drop remainder),
    matching AvgPool1d(kernel=stride=frame_len) (reference :113-131)."""
    n_out = acts.shape[-2] // frame_len
    trimmed = acts[..., : n_out * frame_len, :]
    return trimmed.reshape(trimmed.shape[:-2] + (n_out, frame_len, trimmed.shape[-1])).mean(-2)


def tree_to(tree: Any, device: torch.device, dtype: Optional[torch.dtype] = None) -> Any:
    """A nested dict / list of tensors on `device` (and in `dtype` if given)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device, dtype) for v in tree]
    if not isinstance(tree, torch.Tensor):
        tree = torch.from_numpy(np.array(tree))  # a copy: the caller's may be read-only
    return tree.to(device=device, dtype=dtype)


@dataclasses.dataclass
class JukeboxEncoder:
    """Batched Jukebox embedding extractor on `device` (the GPU unless the
    caller asks for the CPU); the parameter trees are moved there.

    `transfer_dtype="int16"` quantizes the upload (clip * 32767, divided by
    32767 on the device) and `output_dtype="bfloat16"` rounds the
    activations before the readback, as the JAX package does to halve both
    transfers. `encode_stream` enqueues batch k+1 before it waits for batch
    k, whose readback runs on a copy stream while k+1 computes.
    """

    vq_cfg: JukeboxVQVAEConfig
    prior_cfg: JukeboxPriorConfig
    vq_params: Dict[str, Any]
    prior_params: Dict[str, Any]
    x_cond: Optional[Any] = None  # [1, n_ctx, width] timing conditioning
    y_cond: Optional[Any] = None  # [1, 1, width] artist/genre start embedding
    pool_frames_per_second: Optional[float] = 10.0
    transfer_dtype: str = "float32"  # audio upload: "float32" | "int16"
    output_dtype: str = "float32"  # activation readback: "float32" | "bfloat16"
    device: Union[str, torch.device] = "cuda"
    # data-parallel extraction (`parallel/mesh.py` make_mesh): every rank
    # encodes its rows of each batch (padded to a multiple of the world
    # size) and gets the whole batch back, padding trimmed
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            check_mesh(self.mesh)
        self.device = resolve_device(self.device)
        self._frame_len = (pooled_frame_len(self.pool_frames_per_second)
                           if self.pool_frames_per_second else None)
        self._out_dtype = torch_dtype(self.output_dtype)
        self.vq_params = tree_to(self.vq_params, self.device)
        self.prior_params = tree_to(self.prior_params, self.device)
        # kept in fp32; prior_encode casts them to the compute dtype
        self._conds = [None if c is None else tree_to(c, self.device, torch.float32)
                       for c in (self.x_cond, self.y_cond)]
        self._copy_stream = None

    @classmethod
    def from_npz(cls, path: str, metadata=None, artist_id: int = 0, genre_id: int = 0,
                 **kw) -> "JukeboxEncoder":
        """Build an encoder from an importer npz (the JAX package's or the
        port's `import_torch`). When the npz carries label-conditioner
        tables, x_cond / y_cond are computed for the reference's dummy
        metadata (jukebox/main.py:71-98), or for the given `metadata`
        rows, instead of defaulting to zeros."""
        from llark_tpu_torch.encoders.jukebox.import_torch import load_npz

        vq_cfg, pr_cfg, vq_params, pr_params, cond_params, conds = load_npz(path)
        if conds:
            kw.setdefault("x_cond", conds["x_cond"])
            kw.setdefault("y_cond", conds["y_cond"])
        elif cond_params is not None:
            x_cond, y_cond = reference_conds(vq_cfg, pr_cfg, cond_params, metadata,
                                             artist_id, genre_id)
            kw.setdefault("x_cond", x_cond[:1])
            kw.setdefault("y_cond", y_cond[:1])
        return cls(vq_cfg, pr_cfg, vq_params, pr_params, **kw)

    @classmethod
    def random_init(cls, vq_cfg: Optional[JukeboxVQVAEConfig] = None,
                    prior_cfg: Optional[JukeboxPriorConfig] = None, seed: int = 0,
                    device: Union[str, torch.device] = "cuda", **kw) -> "JukeboxEncoder":
        """Random-weight encoder (tests, throughput): the VQ-VAE from a CPU
        generator, the prior drawn on `device` in prior_cfg.dtype."""
        vq_cfg = vq_cfg or JukeboxVQVAEConfig()
        prior_cfg = prior_cfg or JukeboxPriorConfig()
        return cls(vq_cfg, prior_cfg, init_vqvae_params(vq_cfg, seed, device),
                   init_prior_params(prior_cfg, seed + 1, device), device=device, **kw)

    @property
    def samples_per_ctx(self) -> int:
        """Raw samples covered by one prior context window."""
        return self.prior_cfg.n_ctx * self.vq_cfg.hop_lengths[-1]

    def _prepare_transfer(self, audio: np.ndarray) -> torch.Tensor:
        """The host-side upload, quantized when transfer_dtype is int16."""
        if self.transfer_dtype == "int16":
            q = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
            return torch.from_numpy((q * 32767.0).astype(np.int16))
        return torch.from_numpy(np.ascontiguousarray(audio, np.float32))

    def _encode(self, audio: torch.Tensor) -> torch.Tensor:
        """[N, samples_per_ctx] on the device -> pooled activations in
        output_dtype, on the device."""
        if audio.dtype == torch.int16:
            audio = audio.float() / 32767.0
        codes = encode_top(self.vq_cfg, self.vq_params, audio)[:, : self.prior_cfg.n_ctx]
        acts = prior_encode(self.prior_cfg, self.prior_params, codes, *self._conds)
        if self._frame_len is not None:
            acts = windowed_average(acts, self._frame_len)
        return acts.to(self._out_dtype)

    @torch.inference_mode()
    def _launch(self, audio: np.ndarray):
        """Enqueue one batch: (the host tensor that receives its result, the
        event that marks the copy done; None on the CPU, where the result is
        ready on return). On a mesh, this rank's rows only."""
        if self.mesh is not None:
            audio = split_rows(self.mesh, audio)
        host_in = self._prepare_transfer(audio)
        if self.device.type != "cuda":
            return self._encode(host_in), None
        out = self._encode(host_in.pin_memory().to(self.device, non_blocking=True))
        computed = torch.cuda.Event()
        computed.record()
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(computed)
            host_out.copy_(out, non_blocking=True)
            out.record_stream(self._copy_stream)  # no reuse of out's memory before the copy
            copied = torch.cuda.Event()
            copied.record()
        return host_out, copied

    def _collect(self, host_out: torch.Tensor, copied,
                 input_lengths) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for a launched batch's copy: (acts fp32, frame counts)."""
        if copied is not None:
            copied.synchronize()
        acts = host_out.float().numpy()
        if self.mesh is not None:
            acts = gather_rows(acts, len(input_lengths))
        return acts, self._frame_counts(input_lengths)

    def encode_batch(
        self, audio: np.ndarray, input_lengths: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """audio [N, samples_per_ctx] (already prepared and padded);
        input_lengths [N] true sample counts. Returns (acts [N, T_out,
        width] fp32, frame_counts [N])."""
        if input_lengths is None:
            input_lengths = np.full((audio.shape[0],), audio.shape[1], np.int64)
        return self._collect(*self._launch(audio), input_lengths)

    def _frame_counts(self, input_lengths: np.ndarray) -> np.ndarray:
        latent_lens = np.floor(
            self.prior_cfg.n_ctx * np.asarray(input_lengths) / self.samples_per_ctx
        ).astype(np.int64)
        if self._frame_len is not None:
            return latent_lens // self._frame_len
        return latent_lens

    def encode_stream(
        self, batches: Iterable[Tuple[np.ndarray, Optional[np.ndarray]]]
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Pipelined encode over (audio, input_lengths) batches: batch k+1
        is enqueued (and the iterable asked for it) before batch k's result
        is waited for, so the host's preparation and batch k's readback
        overlap the device's compute. Yields (acts fp32, frame_counts) per
        batch, in order."""
        pending = None
        for audio, input_lengths in batches:
            if input_lengths is None:
                input_lengths = np.full((audio.shape[0],), audio.shape[1], np.int64)
            launched = self._launch(audio)
            if pending is not None:
                yield self._collect(*pending)
            pending = (*launched, input_lengths)
        if pending is not None:
            yield self._collect(*pending)

    def get_acts_from_audio(self, audio: np.ndarray, meanpool: bool = True) -> np.ndarray:
        """Single-clip API mirroring get_acts_from_file (reference
        :133-173): the trimmed activations."""
        prepared = prepare_audio(audio)
        input_len = min(len(prepared), self.samples_per_ctx)
        padded = pad_or_crop(prepared, self.samples_per_ctx)
        acts, counts = self.encode_batch(padded[None], np.array([input_len]))
        out = acts[0, : counts[0]]
        if meanpool and self.pool_frames_per_second is None:
            out = out.mean(axis=0)
        return out


def reference_conds(vq_cfg: JukeboxVQVAEConfig, prior_cfg: JukeboxPriorConfig,
                    cond_params: Dict[str, np.ndarray], metadata=None, artist_id: int = 0,
                    genre_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(x_cond, y_cond) from the label-conditioner tables for `metadata`
    rows, by default the reference's dummy metadata (jukebox/main.py:71-98)."""
    from llark_tpu_torch.encoders.jukebox.conditioner import (
        dummy_metadata,
        get_cond,
        infer_conditioner_config,
    )

    ccfg = infer_conditioner_config(cond_params, prior_cfg.n_ctx, prior_cfg.width)
    if metadata is None:
        metadata = dummy_metadata(ccfg, vq_cfg.hop_lengths[-1], artist_id=artist_id,
                                  genre_id=genre_id)
    return get_cond(ccfg, cond_params, metadata)
