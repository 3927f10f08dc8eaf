"""Audio I/O: WAV read/write, resampling, conversion, cropping
(counterpart of llark_tpu/audio/io.py).

  * read_wav(path, target_sr=44100) -> (mono float32 samples, target_sr):
    a RIFF parse (PCM 8/16/24/32, float32/64; channels mixed to mono) and
    a Kaiser-windowed sinc resample;
  * convert_to_wav: any format -> mono WAV through ffmpeg where it is
    installed, the WAV path otherwise;
  * crop policies and the `-start{:.3f}-end{:.3f}` naming.

The parse, the resample and peak normalisation run in the port's native
library (`native/audioproc.cpp`, built with g++ at first use; a failed
build raises). The numpy routes `_parse_wav_numpy` and `_resample_numpy`
stay: the parse takes a WAV the native parser refuses, as the JAX package
does, and a caller may name either; the numpy resample matches the native
one in the interior to 1e-4.
"""

from __future__ import annotations

import ctypes
import logging
import struct
import subprocess
from typing import List, Optional, Tuple

import numpy as np

from llark_tpu_torch import storage
from llark_tpu_torch.native.build import calls, load_library

log = logging.getLogger(__name__)

DEFAULT_SR = 44100
CROP_SECONDS = 30.0


# ---------------------------------------------------------------------------
# WAV parse / write
# ---------------------------------------------------------------------------


def _parse_wav_numpy(data: bytes) -> Tuple[np.ndarray, int]:
    """Minimal RIFF parser (PCM 8/16/24/32 + float32/64), mono-mixed."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = channels = sr = bits = 0
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (clen,) = struct.unpack_from("<I", data, pos + 4)
        if cid == b"fmt ":
            fmt, channels, sr = struct.unpack_from("<HHI", data, pos + 8)
            (bits,) = struct.unpack_from("<H", data, pos + 22)
            if fmt == 0xFFFE and clen >= 40:
                (fmt,) = struct.unpack_from("<H", data, pos + 32)
        elif cid == b"data":
            # clamp to what is actually present (truncated/streaming file)
            raw = data[pos + 8 : min(pos + 8 + clen, len(data))]
        pos += 8 + clen + (clen & 1)
    if raw is None or not channels:
        raise ValueError("missing fmt/data chunk")
    if bits in (16, 24, 32, 64):
        frame = max(1, (bits // 8) * max(channels, 1))
        raw = raw[: len(raw) - (len(raw) % frame)]  # drop a partial frame
    if fmt == 1:
        if bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, "u1").reshape(-1, 3).astype(np.uint32)
            v = (b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)).astype(np.int32)
            v = np.where(v & 0x800000, v - (1 << 24), v)
            x = v.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"unsupported PCM bits {bits}")
    elif fmt == 3:
        x = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format tag {fmt}")
    n = (len(x) // channels) * channels
    return x[:n].reshape(-1, channels).mean(axis=1), sr


def parse_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode WAV bytes to (mono float32 samples, sample_rate) in the native
    library; a file it refuses goes to the numpy parser, which reads it or
    raises ValueError."""
    lib = load_library()
    calls["parse_wav"] += 1
    buf = np.frombuffer(data, np.uint8)
    n_frames = ctypes.c_long()
    channels = ctypes.c_int()
    sr = ctypes.c_int()
    u8 = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    rc = lib.ljt_parse_wav(
        u8, len(data), None, ctypes.byref(n_frames), ctypes.byref(channels), ctypes.byref(sr)
    )
    if rc == 0:
        out = np.empty(n_frames.value, np.float32)
        rc = lib.ljt_parse_wav(
            u8,
            len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(n_frames),
            ctypes.byref(channels),
            ctypes.byref(sr),
        )
        if rc == 0:
            return out, sr.value
    log.debug("native WAV parse refused the file (rc=%d); numpy parser", rc)
    return _parse_wav_numpy(data)


def write_wav(path: str, samples: np.ndarray, sr: int = DEFAULT_SR) -> None:
    """Write mono [T] or multi-channel [T, C] float samples as PCM16 WAV."""
    x = np.asarray(samples, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    pcm = (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2")
    n_ch = x.shape[1]
    data = pcm.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, 1, n_ch, sr, sr * n_ch * 2, n_ch * 2, 16
    )
    hdr += b"data" + struct.pack("<I", len(data))
    storage.write_bytes(path, hdr + data)


# ---------------------------------------------------------------------------
# Resampling
# ---------------------------------------------------------------------------


def _resample_numpy(x: np.ndarray, sr_in: int, sr_out: int,
                    num_zeros: int = 16, precision: int = 512,
                    beta: float = 14.769656459379492) -> np.ndarray:
    """Kaiser-windowed sinc resample, in chunks of 65536 output samples."""
    if sr_in == sr_out:
        return x.astype(np.float32)
    ratio = sr_out / sr_in
    cutoff = min(ratio, 1.0) * 0.9475
    # t is in zero-crossing units (u = tau * cutoff): the lookup below
    # indexes by |tau| * cutoff, so the sinc argument is pi * u here
    t = np.arange(num_zeros * precision + 1) / precision
    arg = t * np.pi
    sinc = np.ones_like(t)
    sinc[1:] = np.sin(arg[1:]) / arg[1:]
    w = t / t[-1]
    kais = np.i0(beta * np.sqrt(np.maximum(0.0, 1 - w**2))) / np.i0(beta)
    table = (cutoff * sinc * kais).astype(np.float64)

    # integer ceil: float ceil(len * ratio) can land one high (44100 -> 48000
    # gives 48000.000000000004)
    n_out = (len(x) * sr_out + sr_in - 1) // sr_in
    half_width = num_zeros / cutoff
    out = np.zeros(n_out, np.float32)
    xpad = np.concatenate(
        [np.zeros(int(half_width) + 2), x.astype(np.float64), np.zeros(int(half_width) + 2)]
    )
    off = int(half_width) + 2
    chunk = 65536
    k = np.arange(-int(half_width), int(half_width) + 1)
    for start in range(0, n_out, chunk):
        n = np.arange(start, min(start + chunk, n_out))
        t_in = n / ratio
        i0 = np.floor(t_in).astype(np.int64)
        frac_idx = (np.abs(t_in[:, None] - (i0[:, None] + k[None, :])) * cutoff * precision)
        ti = frac_idx.astype(np.int64)
        fr = frac_idx - ti
        valid = ti + 1 < len(table)
        ti = np.minimum(ti, len(table) - 2)
        coef = np.where(valid, table[ti] * (1 - fr) + table[ti + 1] * fr, 0.0)
        seg = xpad[(i0[:, None] + k[None, :]) + off]
        out[n] = (coef * seg).sum(axis=1).astype(np.float32)
    return out


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Resample mono float audio in the native library."""
    x = np.ascontiguousarray(x, np.float32)
    if sr_in == sr_out:
        return x
    lib = load_library()
    calls["resample"] += 1
    n_out = lib.ljt_resample_len(len(x), sr_in, sr_out)
    out = np.empty(n_out, np.float32)
    lib.ljt_resample(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), sr_in,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_out, sr_out,
        16, 512, 14.769656459379492,
    )
    return out


def peak_normalize(x: np.ndarray) -> np.ndarray:
    """x / max|x| (x itself when silent) in the native library, as a new
    array: the library works in place on a copy, so the input is never
    changed."""
    x = np.array(x, np.float32, copy=True, order="C")
    lib = load_library()
    calls["peak_normalize"] += 1
    lib.ljt_peak_normalize(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x))
    return x


# ---------------------------------------------------------------------------
# High-level APIs
# ---------------------------------------------------------------------------


def read_wav(
    filepath: str, target_sr: int = DEFAULT_SR, duration: Optional[float] = None
) -> Tuple[np.ndarray, int]:
    """Read, mix to mono and resample a WAV file; the first `duration`
    seconds when given."""
    data = storage.read_bytes(filepath)
    samples, sr = parse_wav_bytes(data)
    if duration is not None:
        samples = samples[: int(sr * duration)]
    if sr != target_sr:
        samples = resample(samples, sr, target_sr)
    return samples.astype(np.float32), target_sr


def convert_to_wav(
    input_path: str, output_path: str, sample_rate: int = DEFAULT_SR
) -> str:
    """Any format -> mono WAV at sample_rate: ffmpeg when installed, the
    WAV path otherwise."""
    try:
        with storage.local_input(input_path) as lin, \
                storage.local_output(output_path) as lout:
            subprocess.run(
                [
                    "ffmpeg", "-y", "-i", lin,
                    "-ar", str(sample_rate), "-ac", "1", "-f", "wav", lout,
                ],
                check=True,
                capture_output=True,
                timeout=600,
            )
        return output_path
    except (subprocess.SubprocessError, FileNotFoundError):
        if not input_path.lower().endswith(".wav"):
            raise RuntimeError(
                f"ffmpeg unavailable and {input_path} is not WAV"
            ) from None
        samples, _ = read_wav(input_path, target_sr=sample_rate)
        write_wav(output_path, samples, sample_rate)
        return output_path


# ---------------------------------------------------------------------------
# Cropping
# ---------------------------------------------------------------------------


def make_start_end_str(start: float, end: float) -> str:
    return f"-start{start:.3f}-end{end:.3f}"


def crop_single(
    samples: np.ndarray,
    sr: int,
    rng: Optional[np.random.RandomState] = None,
    p_first: float = 0.2,
    crop_seconds: float = CROP_SECONDS,
) -> Tuple[np.ndarray, float, float]:
    """Single-crop policy: tracks shorter than 2 * crop take the first
    crop; longer ones the second, with probability 1 - p_first."""
    rng = rng or np.random.RandomState(0)
    n_crop = int(crop_seconds * sr)
    duration = len(samples) / sr
    if duration < 2 * crop_seconds or rng.uniform() < p_first:
        start = 0.0
    else:
        start = crop_seconds
    s = int(start * sr)
    out = samples[s : s + n_crop]
    return out, start, start + len(out) / sr


def crop_multi(
    samples: np.ndarray, sr: int, crop_seconds: float = CROP_SECONDS
) -> List[Tuple[np.ndarray, float, float]]:
    """Every full crop_seconds chunk."""
    n_crop = int(crop_seconds * sr)
    out = []
    for i in range(len(samples) // n_crop):
        s = i * n_crop
        out.append((samples[s : s + n_crop], s / sr, (s + n_crop) / sr))
    return out
