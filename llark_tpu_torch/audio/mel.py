"""Mel-spectrogram frontend in PyTorch (STFT -> mel filterbank -> log);
counterpart of llark_tpu/audio/mel.py.

The CLAP path's settings (sr 48k, n_fft = win 1024, hop 480, 64 mels,
fmin 50, fmax 14000) and the JAX package's conventions: centred frames
with reflect padding of n_fft // 2, the periodic Hann window
0.5 - 0.5 cos(2 pi n / N), the power spectrogram, the HTK mel scale, no
filterbank norm, and 10 log10(max(mel, 1e-10)) (AmplitudeToDB, top_db
None). The window, the mel scale and the filterbank stay numpy; the
framing, the FFT and the log are torch on the input's device. torch is
imported where it is used, so that the host-only users of the numpy half
(`audio/dsp.py`, and through it the preprocessing CLIs and their worker
processes) start without it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def hann_window(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


def hz_to_mel(f, htk: bool = True):
    f = np.asarray(f, np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz, min_log_mel = 1000.0, (1000.0 - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mels)


def mel_to_hz(m, htk: bool = True):
    m = np.asarray(m, np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz, min_log_mel = 1000.0, (1000.0 - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float,
    fmax: Optional[float] = None,
    htk: bool = True,
    norm: Optional[str] = None,
) -> np.ndarray:
    """[n_mels, n_fft//2 + 1] triangular filterbank."""
    fmax = fmax or sr / 2
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fb = np.zeros((n_mels, n_freqs))
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[m] = np.maximum(0.0, np.minimum(up, down))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[:, None]
    return fb.astype(np.float32)


def stft_power(
    audio: torch.Tensor,  # [..., T]
    n_fft: int,
    hop: int,
    window: Optional[np.ndarray] = None,
    center: bool = True,
) -> torch.Tensor:
    """Power spectrogram [..., frames, n_fft//2+1] in fp32, on audio's device."""
    import torch

    if window is None:
        window = hann_window(n_fft)
    win = torch.as_tensor(np.asarray(window, np.float32), device=audio.device)
    audio = audio.to(torch.float32)
    if center:
        # reflect padding of a 1-D signal wants a [N, C, T] input
        lead = audio.shape[:-1]
        audio = torch.nn.functional.pad(
            audio.reshape(-1, 1, audio.shape[-1]), (n_fft // 2, n_fft // 2), mode="reflect"
        ).reshape(*lead, -1)
    frames = audio.unfold(-1, n_fft, hop) * win  # [..., frames, n_fft], frame i at i * hop
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real**2 + spec.imag**2


def log_mel_spectrogram(
    audio: torch.Tensor,
    sr: int = 48000,
    n_fft: int = 1024,
    hop: int = 480,
    n_mels: int = 64,
    fmin: float = 50.0,
    fmax: float = 14000.0,
    htk: bool = True,
    norm: Optional[str] = None,
    amin: float = 1e-10,
) -> torch.Tensor:
    """[..., T] -> [..., frames, n_mels] in dB (AmplitudeToDB, top_db=None)."""
    import torch

    power = stft_power(audio, n_fft, hop)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm))
    mel = torch.matmul(power, fb.to(power.device).T)
    return 10.0 * torch.log10(torch.clamp(mel, min=amin))
