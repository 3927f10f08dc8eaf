"""Host-side music DSP primitives: onset envelope, chroma, beat tracking
(counterpart of llark_tpu/audio/dsp.py; numpy on the host, as there: the
beat tracker and the Viterbi decoder are sequential dynamic programs).

These back the annotation stage (llark_tpu_torch/audio/annotate.py), replacing
madmom's Cython/C processors (reference: m2t/annotation.py) with
numpy implementations of the classic algorithms:
  * onset envelope: log-mel spectral flux (Böck et al.)
  * tempo: autocorrelation of the onset envelope with a log-normal prior
    (Ellis 2007)
  * beats: dynamic-programming beat tracker (Ellis 2007)
  * chroma: FFT-bin -> pitch-class projection
The numerical *values* differ from madmom's neural models; the output
interfaces and units are identical (see annotate.py).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from llark_tpu_torch.audio.mel import hann_window, mel_filterbank


def _stft_mag(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Magnitude STFT [frames, n_fft//2+1] (center-padded)."""
    pad = n_fft // 2
    x = np.pad(x, (pad, pad), mode="reflect" if len(x) > pad else "constant")
    n_frames = 1 + (len(x) - n_fft) // hop
    win = hann_window(n_fft).astype(np.float32)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = x[idx] * win
    return np.abs(np.fft.rfft(frames, axis=-1)).astype(np.float32)


def onset_envelope(
    x: np.ndarray, sr: int, fps: int = 100, n_fft: int = 2048, n_mels: int = 80,
    low_weight: float = 2.0, return_low: bool = False,
):
    """Log-mel spectral-flux onset strength at `fps` frames/second.

    `low_weight` adds a separately-computed low-band (<200 Hz) flux term:
    kick/bass onsets mark the metrical grid, while broadband percussion
    (hi-hats, snares) often sits OFF the beat — a flat mean over mel bands
    lets that broadband flux dominate and phase-locks the beat tracker
    onto off-beats (measured on synthbench: beat F 0.13 -> 1.00 with the
    emphasis). madmom solves the same problem with a trained RNN; the
    low-band prior is the DSP-level equivalent.
    """
    hop = int(round(sr / fps))
    mag = _stft_mag(x, n_fft, hop)
    fb = mel_filterbank(sr, n_fft, n_mels, 30.0, min(17000.0, sr / 2), htk=True)
    mel = mag @ fb.T
    logmel = np.log1p(1000.0 * mel)
    flux = np.diff(logmel, axis=0, prepend=logmel[:1])
    env = np.maximum(flux, 0.0).mean(axis=1)
    lowflux = None
    if low_weight > 0.0 or return_low:
        freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
        lowsel = freqs < 200.0
        # LINEAR low-band energy flux (not log): bar-accent level differences
        # survive, where log compression flattens a 2x kick accent to ~0.1
        # env units (downbeat scoring needs the contrast; see return_low)
        lowe = (mag[:, lowsel] ** 2).sum(axis=1)
        lowflux = np.maximum(np.diff(lowe, prepend=lowe[:1]), 0.0)
        lowflux = lowflux / max(lowflux.max(), 1e-12)
        if low_weight > 0.0:
            lowmag = np.log1p(1000.0 * lowe)
            lflux = np.maximum(np.diff(lowmag, prepend=lowmag[:1]), 0.0)
            env = env + low_weight * lflux
    # local mean removal for sharper peaks
    k = max(1, fps // 10)
    kernel = np.ones(2 * k + 1) / (2 * k + 1)
    local = np.convolve(env, kernel, mode="same")
    env = np.maximum(env - 0.7 * local, 0.0)
    if return_low:
        return env, lowflux
    return env


def estimate_tempo(
    env: np.ndarray, fps: int = 100, min_bpm: float = 40.0, max_bpm: float = 250.0
) -> List[Tuple[float, float]]:
    """Tempo candidates [(bpm, strength)] sorted by strength desc."""
    if len(env) < fps:
        return [(120.0, 1.0)]
    e = env - env.mean()
    ac = np.correlate(e, e, mode="full")[len(e) - 1 :]
    ac = ac / (ac[0] + 1e-9)
    lag_min = int(fps * 60.0 / max_bpm)
    lag_max = min(int(fps * 60.0 / min_bpm), len(ac) - 1)
    lags = np.arange(lag_min, lag_max + 1)
    bpms = 60.0 * fps / lags
    # log-normal preference centered ~120 BPM
    prior = np.exp(-0.5 * ((np.log2(bpms / 120.0)) / 0.9) ** 2)
    score = ac[lags] * prior
    order = np.argsort(score)[::-1]
    out = []
    used = np.zeros(len(lags), bool)
    for i in order[:20]:
        if used[i]:
            continue
        lo, hi = max(0, i - 2), min(len(lags), i + 3)
        used[lo:hi] = True
        out.append((float(bpms[i]), float(max(score[i], 0.0))))
        if len(out) >= 5:
            break
    return out


def track_beats(
    env: np.ndarray, fps: int = 100, bpm: Optional[float] = None, tightness: float = 100.0
) -> np.ndarray:
    """DP beat tracker (Ellis 2007). Returns beat times in seconds."""
    if bpm is None:
        bpm = estimate_tempo(env, fps)[0][0]
    period = max(1, int(round(fps * 60.0 / bpm)))
    n = len(env)
    if n == 0:
        return np.zeros(0)
    score = env.copy()
    backlink = np.full(n, -1, np.int64)
    for t in range(period // 2, n):
        lo = max(0, t - 2 * period)
        prev = np.arange(lo, max(lo, t - period // 2))
        if len(prev) == 0:
            continue
        rel = prev - t
        tc = -tightness * (np.log(np.maximum(-rel, 1) / period) ** 2)
        cand = score[prev] + tc
        j = int(np.argmax(cand))
        score[t] = env[t] + cand[j]
        backlink[t] = prev[j]
    # backtrace from the best late score
    tail = score[-period:] if n > period else score
    t = int(np.argmax(tail)) + (n - len(tail))
    beats = [t]
    while backlink[t] >= 0:
        t = int(backlink[t])
        beats.append(t)
    beats = np.array(beats[::-1], np.float64)
    return beats / fps


def hpss_harmonic(x: np.ndarray, sr: int, n_fft: int = 2048, hop: int = 512,
                  k_time: int = 8, k_freq: int = 8) -> np.ndarray:
    """Harmonic component of x via median-filtering HPSS (Fitzgerald 2010,
    the librosa.effects.harmonic algorithm): soft-mask the STFT by
    comparing a time-axis median (sustained partials = horizontal ridges)
    against a frequency-axis median (percussive hits = vertical ridges),
    then overlap-add resynthesize with the original phase.

    Run at a FINE time resolution (93 ms window / 23 ms hop) so drum hits
    are vertical events the mask can remove — at the chroma analysis
    resolution (371 ms windows) a kick smears across whole inter-beat
    intervals and no time-domain filter can see it. The kick's 120->45 Hz
    sweep otherwise injects a stable B/C/D chroma signature that dominates
    whole clips when the tonal parts are weak (held-out pluck family:
    chord recall 0.25 -> 0.84 with HPSS)."""
    x = np.asarray(x, np.float32)
    pad = n_fft // 2
    xp = np.pad(x, (pad, pad), mode="reflect" if len(x) > pad else "constant")
    n_frames = 1 + (len(xp) - n_fft) // hop
    win = hann_window(n_fft).astype(np.float32)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    spec = np.fft.rfft(xp[idx] * win, axis=-1)
    mag = np.abs(spec).astype(np.float32)
    padt = np.pad(mag, ((k_time, k_time), (0, 0)), mode="edge")
    harm = np.median(
        np.stack([padt[i:i + mag.shape[0]] for i in range(2 * k_time + 1)]),
        axis=0,
    )
    padf = np.pad(mag, ((0, 0), (k_freq, k_freq)), mode="edge")
    perc = np.median(
        np.stack([padf[:, i:i + mag.shape[1]] for i in range(2 * k_freq + 1)]),
        axis=0,
    )
    mask = (harm ** 2) / (harm ** 2 + perc ** 2 + 1e-12)
    fh = np.fft.irfft(spec * mask, n=n_fft, axis=-1).astype(np.float32) * win
    out = np.zeros(len(xp), np.float32)
    wsum = np.zeros(len(xp), np.float32)
    for i in range(n_frames):
        out[i * hop:i * hop + n_fft] += fh[i]
        wsum[i * hop:i * hop + n_fft] += win ** 2
    out = out / np.maximum(wsum, 1e-9)
    return out[pad:pad + len(x)]


def chroma_from_audio(
    x: np.ndarray, sr: int, fps: float = 10.0, n_fft: int = 8192,
    return_energy: bool = False, harmonic_median: int = 2,
    hpss: bool = True,
):
    """Pitch-class energy [frames, 12] at `fps`, max-normalized per frame.
    With return_energy, also returns the PRE-normalization per-frame energy
    [frames] (the normalized rows carry no loudness information).

    `harmonic_median` > 0 median-filters the magnitude spectrogram over a
    +-k frame window along TIME before squaring — the harmonic half of
    HPSS: sustained partials (horizontal ridges) survive the median,
    broadband attack transients (vertical events) are suppressed. Plucked/
    percussive timbres otherwise flood the chroma with attack noise
    (held-out pluck family: near-flat chroma on fast clips).

    `hpss` additionally runs the input through `hpss_harmonic` first —
    drum suppression at a time resolution this analysis window cannot
    reach (see hpss_harmonic docstring)."""
    if hpss:
        x = hpss_harmonic(np.asarray(x, np.float32), sr)
    hop = int(round(sr / fps))
    mag = _stft_mag(x, n_fft, hop)
    if harmonic_median > 0 and mag.shape[0] > 1:
        k = harmonic_median
        pad = np.pad(mag, ((k, k), (0, 0)), mode="edge")
        mag = np.median(
            np.stack([pad[i:i + mag.shape[0]] for i in range(2 * k + 1)]),
            axis=0,
        )
    mag = mag ** 2
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    out = np.zeros((mag.shape[0], 12), np.float32)
    valid = (freqs > 55.0) & (freqs < 5000.0)
    midis = 69.0 + 12.0 * np.log2(np.maximum(freqs, 1e-6) / 440.0)
    pcs = np.round(midis).astype(int) % 12
    # harmonic whitening: weight high freqs down
    weight = 1.0 / np.maximum(freqs / 440.0, 1.0)
    for pc in range(12):
        sel = valid & (pcs == pc)
        out[:, pc] = (mag[:, sel] * weight[sel]).sum(axis=1)
    energy = out.sum(axis=1)
    norm = out.max(axis=1, keepdims=True)
    chroma = out / np.maximum(norm, 1e-9)
    if return_energy:
        return chroma, energy
    return chroma


KRUMHANSL_MAJOR = np.array(
    [6.35, 2.23, 3.48, 2.33, 4.38, 4.09, 2.52, 5.19, 2.39, 3.66, 2.29, 2.88]
)
KRUMHANSL_MINOR = np.array(
    [6.33, 2.68, 3.52, 5.38, 2.60, 3.53, 2.54, 4.75, 3.98, 2.69, 3.34, 3.17]
)

NOTE_NAMES = ("C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B")


def estimate_key(chroma: np.ndarray) -> str:
    """Krumhansl-Schmuckler correlation -> '<tonic> major|minor' (madmom
    key_prediction_to_label format)."""
    mean = chroma.mean(axis=0)
    if mean.sum() <= 0:
        return "C major"
    best_score, best = -np.inf, "C major"
    for tonic in range(12):
        rolled = np.roll(mean, -tonic)
        for profile, mode in ((KRUMHANSL_MAJOR, "major"), (KRUMHANSL_MINOR, "minor")):
            r = np.corrcoef(rolled, profile)[0, 1]
            if r > best_score:
                best_score, best = r, f"{NOTE_NAMES[tonic]} {mode}"
    return best


def chord_templates(n_harm: int = 5, bass_weight: float = 1.2) -> Tuple[np.ndarray, List[str]]:
    """25 templates: 12 maj, 12 min, no-chord; rows L2-normalized.

    Harmonic-aware: each chord tone contributes its overtone series
    (harmonics 1..n_harm at 1/h weight — pitch classes +0, +0, +7, +0,
    +4, +7) instead of a single bin, matching what real/synthesized
    timbres put into a chroma vector; the root gets `bass_weight` extra
    (bass notes dominate the low spectrum). Binary one-bin templates
    mis-matched harmonic-rich audio badly: synthbench chord frame recall
    0.60 -> 0.95 with this parameterization.
    """
    harm_pc = (0, 0, 7, 0, 4, 7)

    def tone_profile(pc: int) -> np.ndarray:
        prof = np.zeros(12, np.float32)
        for h in range(1, n_harm + 1):
            prof[(pc + harm_pc[h - 1]) % 12] += 1.0 / h
        return prof

    templates, labels = [], []
    for third, tag in ((4, "maj"), (3, "min")):
        for root in range(12):
            t = (
                tone_profile(root) * (1.0 + bass_weight)
                + tone_profile((root + third) % 12)
                + tone_profile((root + 7) % 12)
            )
            templates.append(t)
            labels.append(f"{NOTE_NAMES[root]}:{tag}")
    templates.append(np.full(12, 1 / 12, np.float32))
    labels.append("N")
    t = np.stack(templates)
    t = t / np.linalg.norm(t, axis=1, keepdims=True)
    return t, labels


# diatonic triads (offset-from-tonic, is_major) per mode; minor includes
# the natural-minor set plus the harmonic-minor dominant V
_DIATONIC_MAJOR = frozenset({(0, 1), (2, 0), (4, 0), (5, 1), (7, 1), (9, 0)})
_DIATONIC_MINOR = frozenset(
    {(0, 0), (2, 0), (3, 1), (5, 0), (7, 0), (7, 1), (8, 1), (10, 1)}
)


def estimate_key_from_chords(segments: List[dict]) -> Optional[str]:
    """Key from a decoded chord sequence: duration-weighted diatonic
    coverage + tonic-triad prominence + first-chord bonus.

    Relative major/minor share their whole diatonic triad set, so chroma
    profiles alone confuse them constantly; tonic prominence is the
    classical disambiguator. Returns None when no chords were decoded
    (caller falls back to the chroma profile correlation).
    """
    durs: dict = {}
    first = None
    total = 0.0
    for s in segments:
        if s["chord"] == "no chord":
            continue
        name, qual = s["chord"].rsplit(" ", 1)
        pc = NOTE_NAMES.index(name)
        q = 1 if qual == "major" else 0
        d = float(s["end_time"]) - float(s["start_time"])
        durs[(pc, q)] = durs.get((pc, q), 0.0) + d
        total += d
        if first is None:
            first = (pc, q)
    if not durs or total <= 0:
        return None
    best, best_score = None, -np.inf
    for tonic in range(12):
        for mode, dia in (("major", _DIATONIC_MAJOR), ("minor", _DIATONIC_MINOR)):
            cover = sum(
                d for (pc, q), d in durs.items() if ((pc - tonic) % 12, q) in dia
            )
            tonic_d = durs.get((tonic, 1 if mode == "major" else 0), 0.0)
            score = cover / total + 0.5 * tonic_d / total
            if first == (tonic, 1 if mode == "major" else 0):
                score += 0.15
            if score > best_score:
                best_score, best = score, f"{NOTE_NAMES[tonic]} {mode}"
    return best


def viterbi_decode(emissions: np.ndarray, self_bias: float = 0.9) -> np.ndarray:
    """Max-product smoothing over states with sticky self-transitions.
    emissions [T, S] (higher better, log-domain)."""
    t_len, s = emissions.shape
    n_other = s - 1
    log_self = math.log(self_bias)
    log_other = math.log((1 - self_bias) / n_other)
    delta = emissions[0].copy()
    back = np.zeros((t_len, s), np.int32)
    for t in range(1, t_len):
        stay = delta + log_self
        move = delta.max() + log_other
        best_prev = int(np.argmax(delta))
        choose_stay = stay >= move
        delta = np.where(choose_stay, stay, move) + emissions[t]
        back[t] = np.where(choose_stay, np.arange(s), best_prev)
    path = np.zeros(t_len, np.int32)
    path[-1] = int(np.argmax(delta))
    for t in range(t_len - 2, -1, -1):
        path[t] = back[t + 1][path[t + 1]]
    return path
