"""The port's annotation stack against the JAX package's, on the CPU:
`audio/dsp.py`, `audio/annotate.py`, `audio/neural.py`,
`audio/synthbench.py` and `evaluation/utils.py`.

The DSP functions and the annotators are numpy in both packages, op for op,
so their outputs must be EQUAL on the same seeded synthbench clip. The
neural annotators' networks are `nn.Module`s in the port; on the CPU they
must be within 1e-5 (relative to the maximum) of the JAX package's numpy
forward, and the chain they drive must give the same key and beat times.
The JAX side runs once per module, in fixtures.
"""

import os

import numpy as np
import pytest
import torch

from llark_tpu.audio import annotate as jann
from llark_tpu.audio import dsp as jdsp
from llark_tpu.audio import neural as jneural
from llark_tpu.audio import synthbench as jsb
from llark_tpu.evaluation import utils as jeu
from llark_tpu_torch.audio import annotate as tann
from llark_tpu_torch.audio import dsp as tdsp
from llark_tpu_torch.audio import neural as tneural
from llark_tpu_torch.audio import synthbench as tsb
from llark_tpu_torch.evaluation import utils as teu
from llark_tpu_torch.interop.from_jax import annotator_params_from_numpy

SR = jsb.SR
NET_TOL = 1e-5  # relative to max: conv1d / GEMM against numpy einsum, fp32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip():
    audio, truth = jsb.make_clip(11, 6.0)
    return audio, truth


def _equal(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# case: (dsp function, its arguments from the clip's audio)
DSP_CASES = {
    "stft_mag": ("_stft_mag", lambda x: (x, 2048, 441)),
    "onset_envelope": ("onset_envelope", lambda x: (x, SR)),
    "onset_envelope_low": ("onset_envelope", lambda x: (x, SR, 100, 2048, 80, 2.0, True)),
    "hpss_harmonic": ("hpss_harmonic", lambda x: (x, SR)),
    "chroma_from_audio": ("chroma_from_audio", lambda x: (x, SR)),
    "chroma_energy_no_hpss": ("chroma_from_audio", lambda x: (x, SR, 10.0, 8192, True, 2, False)),
}


@pytest.mark.parametrize("case", sorted(DSP_CASES))
def test_dsp_function_equals_the_reference(clip, case):
    name, args = DSP_CASES[case]
    args = args(clip[0])
    _equal(getattr(tdsp, name)(*args), getattr(jdsp, name)(*args))


def test_tempo_beats_key_and_viterbi_equal_the_reference(clip):
    env = jdsp.onset_envelope(clip[0], SR)
    assert tdsp.estimate_tempo(env) == jdsp.estimate_tempo(env)
    assert tdsp.estimate_tempo(env[:50]) == jdsp.estimate_tempo(env[:50]) == [(120.0, 1.0)]
    _equal(tdsp.track_beats(env), jdsp.track_beats(env))
    _equal(tdsp.track_beats(env, bpm=97.0, tightness=50.0),
           jdsp.track_beats(env, bpm=97.0, tightness=50.0))
    chroma = jdsp.chroma_from_audio(clip[0], SR)
    assert tdsp.estimate_key(chroma) == jdsp.estimate_key(chroma)
    assert tdsp.estimate_key(np.zeros((4, 12))) == "C major"
    emissions = np.log(np.random.RandomState(0).rand(80, 25) + 1e-3)
    for bias in (0.4, 0.9):
        _equal(tdsp.viterbi_decode(emissions, bias), jdsp.viterbi_decode(emissions, bias))


def test_chord_templates_key_from_chords_and_constants():
    _equal(tdsp.chord_templates(), jdsp.chord_templates())
    _equal(tdsp.chord_templates(3, 0.5), jdsp.chord_templates(3, 0.5))
    for name in ("KRUMHANSL_MAJOR", "KRUMHANSL_MINOR"):
        _equal(getattr(tdsp, name), getattr(jdsp, name))
    assert tdsp.NOTE_NAMES == jdsp.NOTE_NAMES
    assert tdsp._DIATONIC_MAJOR == jdsp._DIATONIC_MAJOR
    assert tdsp._DIATONIC_MINOR == jdsp._DIATONIC_MINOR
    segs = [{"start_time": 0.0, "end_time": 2.0, "chord": "A minor"},
            {"start_time": 2.0, "end_time": 3.0, "chord": "F major"},
            {"start_time": 3.0, "end_time": 3.5, "chord": "no chord"},
            {"start_time": 3.5, "end_time": 5.0, "chord": "E major"}]
    assert tdsp.estimate_key_from_chords(segs) == jdsp.estimate_key_from_chords(segs)
    assert tdsp.estimate_key_from_chords(segs[2:3]) is None


@pytest.fixture(scope="module")
def jax_elems():
    """The JAX package's DSP chain on two clips of two families."""
    out = {}
    for seed, family in ((3, "additive"), (4, "perc")):
        audio, _ = jsb.make_clip(seed, 6.0, family=family)
        out[family] = (audio, jann.annotate_elem({"audio": audio, "audio_sample_rate": SR}))
    return out


@pytest.mark.parametrize("family", ["additive", "perc"])
def test_annotate_elem_equals_the_reference(jax_elems, family):
    audio, want = jax_elems[family]
    got = tann.annotate_elem({"audio": audio, "audio_sample_rate": SR})
    assert sorted(got) == sorted(want)
    for field in ("key", "tempo_in_beats_per_minute_madmom",
                  "tempo_in_beats_per_minute_librosa", "downbeats_librosa",
                  "downbeats_madmom", "chords"):
        assert got[field] == want[field], field
    assert [a.__name__ for a in tann.DEFAULT_ANNOTATORS] == [
        a.__name__ for a in jann.DEFAULT_ANNOTATORS]


def test_weight_file_is_the_reference_bytes():
    with open(tneural.WEIGHTS_PATH, "rb") as f, open(jneural.WEIGHTS_PATH, "rb") as g:
        assert f.read() == g.read()
    assert not tneural.WEIGHTS_PATH.startswith(os.path.dirname(jneural.WEIGHTS_PATH))
    assert tneural.beat_param_shapes() == jneural.beat_param_shapes()
    assert tneural.key_param_shapes() == jneural.key_param_shapes()
    params = tneural.load_params()
    assert {k: v.shape for k, v in params.items()} == {
        **tneural.beat_param_shapes(), **tneural.key_param_shapes()}


def test_annotator_params_carry_the_layout():
    params = tneural.load_params()
    state = annotator_params_from_numpy(params, "cpu")
    w = state["beat"]["convs.3.weight"]
    assert w.shape == (32, 32, 5) and w.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), params["beat/conv3_w"].transpose(2, 1, 0))
    np.testing.assert_array_equal(state["key"]["fc0.weight"].numpy(), params["key/fc0_w"].T)
    beat, key = tneural.load_nets(device="cpu")
    assert sorted(beat.state_dict()) == sorted(state["beat"])
    assert sorted(key.state_dict()) == sorted(state["key"])
    assert [c.dilation[0] for c in beat.convs] == [d for _, d, _, _ in tneural.BEAT_LAYERS]
    assert tneural.load_nets(device="cpu")[0] is beat  # built once a device


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_beatnet_and_keynet_match_the_reference_forward(clip):
    params = jneural.load_params()
    feats = jneural.beat_features(clip[0], SR)
    chroma = jneural.key_features(clip[0], SR)
    np.testing.assert_array_equal(tneural.beat_features(clip[0], SR), feats)
    np.testing.assert_array_equal(tneural.key_features(clip[0], SR), chroma)
    beat, key = tneural.load_nets(device="cpu")
    act, want = tneural.beat_activations(beat, feats), jneural.beat_activations_np(params, feats)
    assert act.shape == want.shape and act.dtype == np.float32
    assert _rel(act, want) <= NET_TOL
    logits, want = tneural.key_logits(key, chroma), jneural.key_logits_np(params, chroma)
    assert logits.shape == (24,) and _rel(logits, want) <= NET_TOL
    # the names the JAX package exports, over the modules
    assert _rel(tneural.beat_activations_np(params, feats), jneural.beat_activations_np(params, feats)) <= NET_TOL
    assert _rel(tneural.key_logits_np(params, chroma), jneural.key_logits_np(params, chroma)) <= NET_TOL
    for i in (0, 5, 23):
        assert tneural.key_label(i) == jneural.key_label(i)
        assert tneural.key_index(tneural.key_label(i)) == i


@pytest.fixture(scope="module")
def jax_neural_elems():
    out = []
    for seed, family in ((5, "additive"), (6, "drift")):
        audio, _ = jsb.make_clip(seed, 6.0, family=family)
        elem = jann.annotate_elem({"audio": audio, "audio_sample_rate": SR},
                                  annotators=jneural.neural_annotators())
        out.append((audio, elem))
    return out


@pytest.mark.parametrize("which", [0, 1])
def test_neural_chain_equals_the_reference(jax_neural_elems, which):
    audio, want = jax_neural_elems[which]
    got = tann.annotate_elem({"audio": audio, "audio_sample_rate": SR},
                             annotators=tneural.neural_annotators(device="cpu"))
    assert got["key"] == want["key"]
    assert got["chords"] == want["chords"]
    for field in ("downbeats_librosa", "downbeats_madmom"):
        assert len(got[field]) == len(want[field])
        for a, b in zip(got[field], want[field]):
            assert abs(a["time"] - b["time"]) <= 1e-9
            assert a.get("beat_number") == b.get("beat_number")
    for field in ("tempo_in_beats_per_minute_madmom", "tempo_in_beats_per_minute_librosa"):
        assert got[field] == want[field]


def test_neural_annotators_take_a_device():
    chain = tneural.neural_annotators(device="cpu")
    assert [type(a).__name__ if not isinstance(a, type) else a.__name__ for a in chain] == [
        "ExtractChordEstimates", "NeuralKeyEstimates", "NeuralBeatFeatures",
        "NeuralDownbeatFeatures", "NeuralTempoFeatures"]
    assert all(a.device.type == "cpu" for a in chain[1:])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tneural.NeuralKeyEstimates()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tneural.load_nets()


def test_nets_keep_tf32_off_and_restore_the_flags():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    seen = []

    class Probe(tneural.BeatNet):
        def compute(self, feats):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            return super().compute(feats)

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        Probe()(torch.zeros(20, 64))
        assert seen == [(False, False)]
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("family", jsb.FAMILIES)
def test_make_clip_is_bitwise_the_reference(family):
    got, gt = tsb.make_clip(7, 4.0, family=family)
    want, wt = jsb.make_clip(7, 4.0, family=family)
    _equal(got, want)
    assert sorted(gt) == sorted(wt)
    for k in wt:
        _equal(gt[k], wt[k])
    with pytest.raises(ValueError):
        tsb.make_clip(0, 1.0, family="nope")


def test_scoring_utilities_equal_the_reference():
    rng = np.random.RandomState(8)
    truth = np.sort(rng.uniform(0, 10, 20))
    pred = list(truth[::2] + rng.uniform(-0.1, 0.1, 10))
    for tol in (0.07, 0.02):
        assert tsb.f_measure_events(pred, truth, tol) == jsb.f_measure_events(pred, truth, tol)
    assert tsb.f_measure_events([], []) == jsb.f_measure_events([], []) == 1.0
    for p, t in ((120.0, 121.0), (60.0, 121.0), (100.0, 121.0)):
        for octaves in ((1.0,), (1.0, 2.0, 0.5)):
            assert tsb.tempo_accuracy(p, t, octaves=octaves) == jsb.tempo_accuracy(p, t, octaves=octaves)
    segs = [{"start_time": 0.0, "end_time": 2.0, "chord": "C major"},
            {"start_time": 2.0, "end_time": 6.0, "chord": "A minor"}]
    other = [{"start_time": 0.0, "end_time": 3.0, "chord": "C major"}]
    assert tsb.chord_frame_recall(segs, other, 6.0) == jsb.chord_frame_recall(segs, other, 6.0)
    for p, t in (("C major", "C major"), ("G major", "C major"), ("A minor", "C major"),
                 ("C minor", "C major"), ("F major", "C major"), ("Db major", "C# major")):
        assert teu.mirex_key_score(p, t) == jeu.mirex_key_score(p, t)
    assert teu.VALID_KEYS == jeu.VALID_KEYS
    for text in ("The tempo is 128 BPM.", "about 90", "none", "C# minor", "key of Eb major"):
        assert teu.parse_bpm(text) == jeu.parse_bpm(text)
        assert teu.normalize_key_string(text) == jeu.normalize_key_string(text)
        assert teu.map_keys_to_giantsteps(text) == jeu.map_keys_to_giantsteps(text)
        assert teu.strip_completion(text) == jeu.strip_completion(text)
    assert teu.set_f1(["a", "b"], ["b", "c"]) == jeu.set_f1(["a", "b"], ["b", "c"])
    labels = ["rock", "jazz", "classical music", "hip hop"]
    _equal(teu.bag_of_words_embedder(labels), jeu.bag_of_words_embedder(labels))


@pytest.fixture(scope="module")
def jax_benchmark():
    return jsb.run_benchmark(n=2, seconds=6.0)


def test_run_benchmark_gives_the_reference_scores(jax_benchmark):
    assert tsb.run_benchmark(n=2, seconds=6.0) == jax_benchmark
