"""Trained neural annotators: madmom-architecture parity for beats and key
(counterpart of llark_tpu/audio/neural.py).

The reference's pseudo-labels come from madmom's trained models, an RNN
beat/downbeat activation network decoded by a DBN and a CNN key classifier
(reference: m2t/annotation.py:29-111). This module holds two small
trained networks with the JAX package's architecture and weights, decoded
by the same dynamic programs as the DSP annotators:

  * BeatNet: a dilated temporal conv net (six `Conv1d` layers, k 5,
    dilations 1-32, 64 -> 32 channels, "same" padding, ReLU; a 32 -> 2 head
    and a sigmoid) over a standardized log-mel spectrogram at 100 fps,
    giving per-frame (beat, downbeat) activations. `estimate_tempo` +
    `track_beats` decode the beat activation; bar (bpb, phase) selection
    scores the downbeat activation at hypothesized downbeats.
  * KeyNet: two `Conv1d` layers (k 9, dilations 1 and 2, 12 -> 32) over the
    HPSS chroma at 10 fps, mean and max pooling over time, 64 -> 48 with
    ReLU, 48 -> 24 key logits (12 tonics x major/minor).

The features stay numpy on the host (`beat_features`, `key_features`), as
in the JAX package. The networks are `nn.Module`s that run on the card
unless the caller asks for the CPU: the annotators send the features to the
device and bring the activations back for the host's dynamic programs. The
convolutions and products run in fp32 with TF32 off whatever the caller's
flags (`device.full_fp32`): cuDNN's default is TF32, and a moved
activation peak moves a beat. `beat_activations_np` and `key_logits_np`
keep the JAX package's names as functions over the modules on the CPU.

Weights: the port's own copy of the JAX package's committed npz,
`llark_tpu_torch/audio/weights/neural_annotators.npz`, carried into the
modules by `interop.from_jax.annotator_params_from_numpy` (a convolution
[k, c_in, c_out] there is `Conv1d`'s [c_out, c_in, k] here).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from llark_tpu_torch.audio.dsp import (
    NOTE_NAMES,
    _stft_mag,
    chroma_from_audio,
    estimate_tempo,
    track_beats,
)
from llark_tpu_torch.audio.mel import mel_filterbank
from llark_tpu_torch.device import full_fp32, resolve_device

Device = Union[str, torch.device]

WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "weights",
                            "neural_annotators.npz")

# ---------------------------------------------------------------------------
# Architecture spec (the JAX package's; its trainer,
# scripts/train_annotators.py, wrote the weights)
# ---------------------------------------------------------------------------

# (kernel, dilation, c_in, c_out) per conv layer; a 1x1 head follows.
BEAT_LAYERS: Tuple[Tuple[int, int, int, int], ...] = (
    (5, 1, 64, 32),
    (5, 2, 32, 32),
    (5, 4, 32, 32),
    (5, 8, 32, 32),
    (5, 16, 32, 32),
    (5, 32, 32, 32),
)
BEAT_HEAD = (32, 2)  # -> (beat, downbeat) logits
BEAT_FPS = 100
BEAT_N_MELS = 64

KEY_LAYERS: Tuple[Tuple[int, int, int, int], ...] = (
    (9, 1, 12, 32),
    (9, 2, 32, 32),
)
KEY_HIDDEN = (64, 48)  # pooled mean+max (2*32) -> 48
KEY_CLASSES = 24  # tonic * 2 + (0 major, 1 minor)
KEY_FPS = 10


def beat_param_shapes() -> Dict[str, Tuple[int, ...]]:
    shapes: Dict[str, Tuple[int, ...]] = {}
    for i, (k, _d, cin, cout) in enumerate(BEAT_LAYERS):
        shapes[f"beat/conv{i}_w"] = (k, cin, cout)
        shapes[f"beat/conv{i}_b"] = (cout,)
    shapes["beat/head_w"] = BEAT_HEAD
    shapes["beat/head_b"] = (BEAT_HEAD[1],)
    return shapes


def key_param_shapes() -> Dict[str, Tuple[int, ...]]:
    shapes: Dict[str, Tuple[int, ...]] = {}
    for i, (k, _d, cin, cout) in enumerate(KEY_LAYERS):
        shapes[f"key/conv{i}_w"] = (k, cin, cout)
        shapes[f"key/conv{i}_b"] = (cout,)
    shapes["key/fc0_w"] = KEY_HIDDEN
    shapes["key/fc0_b"] = (KEY_HIDDEN[1],)
    shapes["key/fc1_w"] = (KEY_HIDDEN[1], KEY_CLASSES)
    shapes["key/fc1_b"] = (KEY_CLASSES,)
    return shapes


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------


def beat_features(audio: np.ndarray, sr: int, fps: int = BEAT_FPS,
                  n_fft: int = 2048, n_mels: int = BEAT_N_MELS) -> np.ndarray:
    """Standardized log-mel spectrogram [T, n_mels] at `fps`."""
    hop = int(round(sr / fps))
    mag = _stft_mag(np.asarray(audio, np.float32), n_fft, hop)
    fb = mel_filterbank(sr, n_fft, n_mels, 30.0, min(11000.0, sr / 2),
                        htk=True)
    logmel = np.log1p(1000.0 * (mag @ fb.T))
    mu = logmel.mean()
    sd = logmel.std()
    return ((logmel - mu) / max(sd, 1e-6)).astype(np.float32)


def key_features(audio: np.ndarray, sr: int, fps: float = KEY_FPS) -> np.ndarray:
    """HPSS chroma [T, 12] (max-normalized rows, as chord analysis uses)."""
    return chroma_from_audio(np.asarray(audio, np.float32), sr,
                             fps=fps).astype(np.float32)


# ---------------------------------------------------------------------------
# The networks
# ---------------------------------------------------------------------------


def _convs(layers) -> nn.ModuleList:
    """'same' dilated convolutions over time, one per (k, dilation, c_in, c_out)."""
    return nn.ModuleList(
        nn.Conv1d(cin, cout, k, dilation=d, padding=(k - 1) // 2 * d)
        for k, d, cin, cout in layers
    )


class BeatNet(nn.Module):
    """[T, n_mels] features -> sigmoid activations [T, 2] (beat, downbeat)."""

    def __init__(self):
        super().__init__()
        self.convs = _convs(BEAT_LAYERS)
        self.head = nn.Linear(*BEAT_HEAD)

    def compute(self, feats: torch.Tensor) -> torch.Tensor:
        """The forward under the caller's TF32 flags."""
        h = feats.t().unsqueeze(0)  # [1, C, T]
        for conv in self.convs:
            h = torch.relu(conv(h))
        return torch.sigmoid(self.head(h[0].t()))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        with full_fp32():
            return self.compute(feats)


class KeyNet(nn.Module):
    """[T, 12] chroma -> [24] key logits."""

    def __init__(self):
        super().__init__()
        self.convs = _convs(KEY_LAYERS)
        self.fc0 = nn.Linear(*KEY_HIDDEN)
        self.fc1 = nn.Linear(KEY_HIDDEN[1], KEY_CLASSES)

    def compute(self, chroma: torch.Tensor) -> torch.Tensor:
        """The forward under the caller's TF32 flags."""
        h = chroma.t().unsqueeze(0)
        for conv in self.convs:
            h = torch.relu(conv(h))
        pooled = torch.cat([h[0].mean(dim=1), h[0].amax(dim=1)])
        return self.fc1(torch.relu(self.fc0(pooled)))

    def forward(self, chroma: torch.Tensor) -> torch.Tensor:
        with full_fp32():
            return self.compute(chroma)


def nets_from_params(params: Dict[str, np.ndarray],
                     device: Device = "cuda") -> Tuple[BeatNet, KeyNet]:
    """The JAX-layout numpy tree (`load_params`) -> (BeatNet, KeyNet) in
    fp32 on `device` (the GPU unless the caller asks for the CPU)."""
    from llark_tpu_torch.interop.from_jax import annotator_params_from_numpy

    dev = resolve_device(device)
    state = annotator_params_from_numpy(params, dev)
    beat, key = BeatNet().to(dev), KeyNet().to(dev)
    beat.load_state_dict(state["beat"])
    key.load_state_dict(state["key"])
    return beat.eval().requires_grad_(False), key.eval().requires_grad_(False)


def _run(net: nn.Module, x: np.ndarray) -> np.ndarray:
    """numpy features -> the net on its device -> numpy fp32 on the host."""
    dev = next(net.parameters()).device
    with torch.no_grad():
        out = net(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev))
    return out.cpu().numpy()


def beat_activations(net: BeatNet, feats: np.ndarray) -> np.ndarray:
    """[T, n_mels] -> sigmoid activations [T, 2] (beat, downbeat)."""
    return _run(net, feats)


def key_logits(net: KeyNet, chroma: np.ndarray) -> np.ndarray:
    """[T, 12] -> [24] key logits."""
    return _run(net, chroma)


def beat_activations_np(params: Dict[str, np.ndarray],
                        feats: np.ndarray) -> np.ndarray:
    """[T, n_mels] -> sigmoid activations [T, 2], BeatNet on the CPU."""
    return beat_activations(nets_from_params(params, "cpu")[0], feats)


def key_logits_np(params: Dict[str, np.ndarray],
                  chroma: np.ndarray) -> np.ndarray:
    """[T, 12] -> [24] key logits, KeyNet on the CPU."""
    return key_logits(nets_from_params(params, "cpu")[1], chroma)


def key_label(idx: int) -> str:
    return f"{NOTE_NAMES[idx // 2]} {'major' if idx % 2 == 0 else 'minor'}"


def key_index(label: str) -> int:
    tonic, mode = label.split()
    return NOTE_NAMES.index(tonic) * 2 + (0 if mode == "major" else 1)


# keyed by os.path.realpath so equal-but-not-identical spellings of the
# same file (relative form, normpath variant) hit the same entry instead
# of re-reading the npz on every annotator call
_PARAMS_CACHE: Dict[str, Dict[str, np.ndarray]] = {}
# the modules built from them, by (real path, device)
_NETS_CACHE: Dict[Tuple[str, str], Tuple[BeatNet, KeyNet]] = {}


def load_params(path: str = WEIGHTS_PATH) -> Dict[str, np.ndarray]:
    key = os.path.realpath(path)
    cached = _PARAMS_CACHE.get(key)
    if cached is not None:
        return cached
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"neural annotator weights missing at {path}; the JAX package's "
            "scripts/train_annotators.py trains them"
        )
    with np.load(path) as z:
        params = {k: z[k].astype(np.float32) for k in z.files}
    _PARAMS_CACHE[key] = params
    return params


def load_nets(path: str = WEIGHTS_PATH, device: Device = "cuda") -> Tuple[BeatNet, KeyNet]:
    """(BeatNet, KeyNet) from the weights at `path` on `device`, built once."""
    dev = resolve_device(device)
    key = (os.path.realpath(path), str(dev))
    nets = _NETS_CACHE.get(key)
    if nets is None:
        nets = _NETS_CACHE[key] = nets_from_params(load_params(path), dev)
    return nets


# ---------------------------------------------------------------------------
# Annotators (same elem contract as annotate.py)
# ---------------------------------------------------------------------------

# one-slot activation memo: the chain runs beat/downbeat/tempo annotators
# back-to-back on the SAME elem, and the stft dominates their cost. The
# memo pins the audio object so its id cannot be recycled; never stored in
# the elem (elems are serialized downstream).
_ACT_MEMO: List[Any] = [None, None, None]  # [audio_ref, (fps, weights, device), act]


def _activations(elem: Dict[str, Any], fps: int, weights: str,
                 device: torch.device) -> np.ndarray:
    audio = elem["audio"]
    if _ACT_MEMO[0] is audio and _ACT_MEMO[1] == (fps, weights, device):
        return _ACT_MEMO[2]
    beat, _ = load_nets(weights, device)
    feats = beat_features(audio, elem["audio_sample_rate"], fps)
    act = beat_activations(beat, feats)
    _ACT_MEMO[0], _ACT_MEMO[1], _ACT_MEMO[2] = audio, (fps, weights, device), act
    return act

class NeuralBeatFeatures:
    """Beat-tracked tempo + beats from the TCN beat activation
    (librosa-field contract, mirroring ExtractLibrosaTempoAndDownbeatFeatures)."""

    def __init__(self, fps: int = BEAT_FPS, weights: str = WEIGHTS_PATH,
                 device: Device = "cuda"):
        self.fps = fps
        self.weights = weights
        self.device = resolve_device(device)

    def __call__(self, elem: Dict[str, Any]) -> Dict[str, Any]:
        act = _activations(elem, self.fps, self.weights, self.device)
        env = act[:, 0]
        tempo = estimate_tempo(env, self.fps)[0][0]
        beats = track_beats(env, self.fps, tempo)
        elem["tempo_in_beats_per_minute_librosa"] = float(tempo)
        elem["downbeats_librosa"] = [{"time": float(t)} for t in beats]
        return elem


class NeuralTempoFeatures:
    """Dominant tempo from the beat activation (madmom contract)."""

    def __init__(self, fps: int = BEAT_FPS, weights: str = WEIGHTS_PATH,
                 device: Device = "cuda"):
        self.fps = fps
        self.weights = weights
        self.device = resolve_device(device)

    def __call__(self, elem: Dict[str, Any]) -> Dict[str, Any]:
        act = _activations(elem, self.fps, self.weights, self.device)
        tempo = estimate_tempo(act[:, 0], self.fps)[0][0]
        elem["tempo_in_beats_per_minute_madmom"] = round(float(tempo), 1)
        return elem


class NeuralDownbeatFeatures:
    """Beats with bar positions; (bpb, phase) scores the DOWNBEAT
    activation at hypothesized downbeats (madmom
    DBNDownBeatTrackingProcessor contract)."""

    def __init__(self, fps: int = BEAT_FPS,
                 beats_per_bar: Sequence[int] = (3, 4),
                 weights: str = WEIGHTS_PATH, device: Device = "cuda"):
        self.fps = fps
        self.beats_per_bar = tuple(beats_per_bar)
        self.weights = weights
        self.device = resolve_device(device)

    def __call__(self, elem: Dict[str, Any]) -> Dict[str, Any]:
        act = _activations(elem, self.fps, self.weights, self.device)
        env, db = act[:, 0], act[:, 1]
        beats = track_beats(env, self.fps)
        if len(beats) == 0:
            elem["downbeats_madmom"] = []
            return elem
        frames = np.clip((beats * self.fps).astype(int), 0, len(db) - 1)
        # +-2-frame max absorbs tracker/activation misalignment (the DSP
        # downbeat selector does the same on its onset envelope)
        at_beats = np.array(
            [db[max(0, f - 2):f + 3].max() for f in frames]
        )
        best = None
        for bpb in self.beats_per_bar:
            for phase in range(bpb):
                idx = np.arange(phase, len(at_beats), bpb)
                rest = np.ones(len(at_beats), bool)
                rest[idx] = False
                score = at_beats[idx].mean() - (
                    at_beats[rest].mean() if rest.any() else 0.0
                )
                if best is None or score > best[0]:
                    best = (score, bpb, phase)
        _, bpb, phase = best
        elem["downbeats_madmom"] = [
            {"time": float(t), "beat_number": int(((i - phase) % bpb) + 1)}
            for i, t in enumerate(beats)
        ]
        return elem


class NeuralKeyEstimates:
    """Key via the trained chroma CNN (madmom CNNKeyRecognitionProcessor
    contract)."""

    def __init__(self, weights: str = WEIGHTS_PATH, device: Device = "cuda"):
        self.weights = weights
        self.device = resolve_device(device)

    def __call__(self, elem: Dict[str, Any]) -> Dict[str, Any]:
        _, net = load_nets(self.weights, self.device)
        chroma = key_features(elem["audio"], elem["audio_sample_rate"])
        logits = key_logits(net, chroma)
        elem["key"] = key_label(int(np.argmax(logits)))
        return elem


def neural_annotators(weights: str = WEIGHTS_PATH, device: Device = "cuda") -> Tuple[Any, ...]:
    """Full neural annotation chain, the networks on `device` (the GPU
    unless the caller asks for the CPU; chords stay on the DSP template +
    Viterbi route: the reference's chord model is a separate CNN+CRF and
    the DSP chords already score 0.98+ on synthbench)."""
    from llark_tpu_torch.audio.annotate import ExtractChordEstimates

    dev = resolve_device(device)
    return (
        ExtractChordEstimates,
        NeuralKeyEstimates(weights=weights, device=dev),
        NeuralBeatFeatures(weights=weights, device=dev),
        NeuralDownbeatFeatures(weights=weights, device=dev),
        NeuralTempoFeatures(weights=weights, device=dev),
    )
