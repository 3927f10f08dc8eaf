"""CLAP audio-embedding pipeline: waveform -> 512-d unit vector;
counterpart of llark_tpu/encoders/clap/encode.py.

The laion_clap invocation LLark's CLAP variant uses:
  * 48 kHz mono input
  * int16 quantize round trip (int16_to_float32(float32_to_int16(x)))
  * data_truncating='rand_trunc': clips longer than clip_samples (480000,
    10 s) take a random 10 s window, drawn from a numpy RandomState so
    the same files in the same order crop as in the JAX package
  * data_filling='repeatpad': shorter clips are tiled, then zero-padded
  * log-mel (1024 fft / 480 hop / 64 mel / 50..14000 Hz) -> HTSAT ->
    audio projection -> L2 normalisation -> 512-d embedding
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from llark_tpu_torch.audio.mel import log_mel_spectrogram
from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.encoders.clap.htsat import HTSATConfig, htsat_embed, init_htsat_params

CLAP_SAMPLE_RATE = 48000
CLIP_SAMPLES = 480000  # 10 s
N_FFT = 1024
HOP = 480
N_MELS = 64
FMIN, FMAX = 50.0, 14000.0


def float32_to_int16(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, -1.0, 1.0)
    return (x * 32767.0).astype(np.int16)


def int16_to_float32(x: np.ndarray) -> np.ndarray:
    return (x / 32767.0).astype(np.float32)


def quantize_roundtrip(x: np.ndarray) -> np.ndarray:
    """int16 quantization round trip."""
    return int16_to_float32(float32_to_int16(x))


def prepare_clip(
    audio: np.ndarray,
    rng: Optional[np.random.RandomState] = None,
    clip_samples: int = CLIP_SAMPLES,
) -> np.ndarray:
    """rand_trunc + repeatpad to a fixed clip_samples window."""
    rng = rng or np.random.RandomState(0)
    audio = np.asarray(audio, np.float32).flatten()
    n = len(audio)
    if n > clip_samples:
        start = rng.randint(0, n - clip_samples + 1)
        return audio[start : start + clip_samples]
    if n < clip_samples:
        if n == 0:
            return np.zeros(clip_samples, np.float32)
        n_repeat = clip_samples // n
        audio = np.tile(audio, n_repeat)
        audio = np.pad(audio, (0, clip_samples - len(audio)))
    return audio


@dataclasses.dataclass
class ClapEncoder:
    """Batched CLAP audio-embedding extractor (512-d) on `device` (the GPU
    unless the caller asks for the CPU), where `params` lie: as
    `random_init`, `load_clap_encoder` and `htsat_params_from_numpy` put
    them."""

    cfg: HTSATConfig
    params: Dict[str, Any]
    device: Union[str, torch.device] = "cuda"
    mesh: Any = None  # the JAX package's data-parallel route

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "data-parallel CLAP extraction over a device mesh is Queue A item 9 "
                "(parallelism) of the port; run one process per card with "
                "--num-shards / --shard-index")
        self.device = resolve_device(self.device)

    @classmethod
    def random_init(cls, cfg: Optional[HTSATConfig] = None, seed: int = 0,
                    device: Union[str, torch.device] = "cuda", mesh=None) -> "ClapEncoder":
        cfg = cfg or HTSATConfig.base()
        return cls(cfg, init_htsat_params(cfg, seed, device), device, mesh)

    def embed_batch(self, audio: np.ndarray) -> np.ndarray:
        """audio [B, clip_samples] prepared waveforms -> [B, out_dim] unit vectors."""
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)
            mel = log_mel_spectrogram(
                x, CLAP_SAMPLE_RATE, N_FFT, HOP, self.cfg.n_mels, FMIN, FMAX
            )[:, : self.cfg.n_frames]
            emb = htsat_embed(self.cfg, self.params, mel).float()
            # laion_clap's get_audio_embedding normalises after the projection;
            # htsat_embed stays raw, as HF's audio_embeds are
            emb = emb / torch.clamp(emb.norm(dim=-1, keepdim=True), min=1e-12)
            return emb.cpu().numpy()

    def embed_clip(self, audio: np.ndarray, rng=None) -> np.ndarray:
        """One clip through quantize + trunc/pad -> [1, out_dim] (the
        [1, 512] of the .npy files LLark reads)."""
        x = quantize_roundtrip(np.asarray(audio, np.float32).flatten())
        x = prepare_clip(x, rng)
        return self.embed_batch(x[None])
