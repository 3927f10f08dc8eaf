"""The port's CLAP encoder path (`audio/`, `encoders/clap/`) against the
JAX package's, fp32 on the CPU.

Inputs come from numpy seeds and go through both packages: the mel
frontend to relative 1e-5 (log-mel with an absolute 1e-4 dB floor); the
clip preparation bitwise from one RandomState; the numpy resampler to
1e-6, and to 1e-4 in the interior against the JAX package's `resample`
(its native library where that builds); HTSAT's window attention, with and
without the shifted-window mask, and `htsat_embed` at depths (2, 2) with
shifted windows to relative 1e-5, from one random tree given to the JAX
package as it is and to the port through `htsat_params_from_numpy`; the
HF import to 1e-5 of the JAX import and to the JAX package's own 2e-4 /
1e-3 of HF's `audio_embeds`.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu.audio import io as jio
from llark_tpu.audio import mel as jmel
from llark_tpu.encoders.clap import encode as jenc
from llark_tpu.encoders.clap import htsat as jh
from llark_tpu.encoders.clap import import_hf as jimp
from llark_tpu_torch.audio import io as tio
from llark_tpu_torch.audio import mel as tmel
from llark_tpu_torch.encoders.clap import encode as tenc
from llark_tpu_torch.encoders.clap import htsat as th
from llark_tpu_torch.encoders.clap import import_hf as timp
from llark_tpu_torch.interop.from_jax import htsat_params_from_numpy

# depths of 2 and a 16 x 16 token grid over windows of 4: odd blocks shift
SHIFTED = dict(depths=(2, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_tree(cfg: th.HTSATConfig, seed: int, mel_bn: bool = False):
    """An HTSAT tree in the JAX layout with every leaf random (numpy):
    relative-position tables, biases and norms too, which the seeded init
    leaves at zero or one."""
    rng = np.random.RandomState(seed)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [fill(v) for v in tree]
        if tree is None:
            return None
        scale = 1.0 / np.sqrt(tree.shape[0]) if tree.ndim > 1 else 0.1
        return (rng.randn(*tree.shape) * scale).astype(np.float32)

    tree = fill(th.init_htsat_params(cfg, 0, "cpu"))
    if mel_bn:
        tree["mel_bn"] = {
            "g": (1 + 0.1 * rng.randn(cfg.n_mels)).astype(np.float32),
            "b": (0.1 * rng.randn(cfg.n_mels)).astype(np.float32),
            "mean": rng.randn(cfg.n_mels).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, cfg.n_mels).astype(np.float32),
        }
    return tree


def rel_to_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# mel frontend
# ---------------------------------------------------------------------------


def test_mel_helpers_equal_the_reference():
    np.testing.assert_array_equal(tmel.hann_window(1024), jmel.hann_window(1024))
    f, m = np.array([1.0, 50.0, 700.0, 1000.0, 14000.0]), np.array([0.5, 10.0, 15.0, 40.0])
    for htk in (True, False):
        np.testing.assert_array_equal(tmel.hz_to_mel(f, htk), jmel.hz_to_mel(f, htk))
        np.testing.assert_array_equal(tmel.mel_to_hz(m, htk), jmel.mel_to_hz(m, htk))
    for norm in (None, "slaney"):
        np.testing.assert_array_equal(tmel.mel_filterbank(48000, 1024, 64, 50.0, 14000.0, True, norm),
                                      jmel.mel_filterbank(48000, 1024, 64, 50.0, 14000.0, True, norm))


@pytest.mark.parametrize("center", [True, False])
def test_stft_power_matches_jax(center):
    audio = np.random.RandomState(0).randn(2, 3, 9600).astype(np.float32)
    want = np.asarray(jmel.stft_power(jnp.asarray(audio), 1024, 480, center=center))
    got = tmel.stft_power(torch.from_numpy(audio), 1024, 480, center=center)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_log_mel_spectrogram_matches_jax():
    audio = (0.3 * np.random.RandomState(1).randn(2, 48000)).astype(np.float32)
    audio[1, :4800] = 0.0  # a silent stretch: the amin floor
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio), 48000, 1024, 480, 64, 50.0,
                                               14000.0))
    got = tmel.log_mel_spectrogram(torch.from_numpy(audio), 48000, 1024, 480, 64, 50.0, 14000.0)
    assert tuple(got.shape) == want.shape == (2, 101, 64)
    assert want.min() == -100.0  # 10 log10(1e-10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# clip preparation and audio I/O
# ---------------------------------------------------------------------------


def test_prepare_clip_and_quantize_are_bitwise_the_reference():
    rng = np.random.RandomState(3)
    clips = [rng.randn(n).astype(np.float32) * 0.7 for n in (2000, 1000, 999, 1, 0, 5000)]
    clips[0][:3] = [1.5, -2.0, 1.0]  # clipped by the int16 round trip
    t_rng, j_rng = np.random.RandomState(0), np.random.RandomState(0)
    for x in clips:
        tq, jq = tenc.quantize_roundtrip(x), jenc.quantize_roundtrip(x)
        np.testing.assert_array_equal(tq, jq)
        assert tq.dtype == jq.dtype == np.float32
        got = tenc.prepare_clip(tq, t_rng, clip_samples=1000)
        want = jenc.prepare_clip(jq, j_rng, clip_samples=1000)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype and got.shape == (1000,)
    # the windows drawn from the shared RandomState come out alike
    assert t_rng.randint(1 << 30) == j_rng.randint(1 << 30)
    assert (tenc.CLAP_SAMPLE_RATE, tenc.CLIP_SAMPLES, tenc.N_FFT, tenc.HOP, tenc.N_MELS,
            tenc.FMIN, tenc.FMAX) == (jenc.CLAP_SAMPLE_RATE, jenc.CLIP_SAMPLES, jenc.N_FFT,
                                      jenc.HOP, jenc.N_MELS, jenc.FMIN, jenc.FMAX)


@pytest.mark.parametrize("pair", [(44100, 48000), (48000, 44100), (22050, 44100)])
def test_resample_numpy_matches_the_reference(pair):
    x = (0.3 * np.random.RandomState(4).randn(9000)).astype(np.float32)
    got = tio._resample_numpy(x, *pair)
    want = jio._resample_numpy(x, *pair)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tio.resample(x, 48000, 48000), x)


def test_read_wav_stereo_44k_matches_the_reference(tmp_path):
    rng = np.random.RandomState(5)
    stereo = (0.3 * rng.randn(44100, 2)).astype(np.float32)
    path = str(tmp_path / "stereo.wav")
    tio.write_wav(path, stereo, 44100)
    jio.write_wav(str(tmp_path / "ref.wav"), stereo, 44100)
    assert (tmp_path / "stereo.wav").read_bytes() == (tmp_path / "ref.wav").read_bytes()

    got, sr = tio.read_wav(path, 48000)
    assert sr == 48000 and got.dtype == np.float32 and got.shape == (48000,)
    mono, src_sr = jio._parse_wav_numpy((tmp_path / "stereo.wav").read_bytes())
    assert src_sr == 44100
    np.testing.assert_allclose(got, jio._resample_numpy(mono, 44100, 48000), rtol=0, atol=1e-6)
    want, _ = jio.read_wav(path, 48000)  # the native library where it builds
    n = len(want)
    np.testing.assert_allclose(got[n // 8 : -n // 8], want[n // 8 : -n // 8], rtol=0, atol=1e-4)
    short, _ = tio.read_wav(path, 44100, duration=0.5)
    np.testing.assert_array_equal(short, jio.read_wav(path, 44100, duration=0.5)[0])


def test_wav_parse_crops_and_names_match_the_reference(tmp_path):
    rng = np.random.RandomState(6)
    x = (0.5 * rng.randn(8000, 3)).astype(np.float32)
    path = str(tmp_path / "three.wav")
    tio.write_wav(path, x, 8000)
    data = (tmp_path / "three.wav").read_bytes()
    for cut in (data, data[:-501]):  # whole, and truncated mid-frame
        got, want = tio.parse_wav_bytes(cut), jio._parse_wav_numpy(cut)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == 8000
    long = rng.randn(8000 * 70).astype(np.float32)
    for seed in range(3):
        got = tio.crop_single(long, 8000, np.random.RandomState(seed))
        want = jio.crop_single(long, 8000, np.random.RandomState(seed))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    got, want = tio.crop_multi(long, 8000), jio.crop_multi(long, 8000)
    assert [c[1:] for c in got] == [c[1:] for c in want] and len(got) == 2
    assert tio.make_start_end_str(30.0, 60.5) == jio.make_start_end_str(30.0, 60.5)
    # the JAX package's native library scales by the reciprocal of the peak
    np.testing.assert_allclose(tio.peak_normalize(x[:, 0]), jio.peak_normalize(x[:, 0]),
                               rtol=0, atol=1e-6)
    # without ffmpeg both convert through their own resamplers, then PCM16
    out, ref = str(tmp_path / "out.wav"), str(tmp_path / "ref.wav")
    assert tio.convert_to_wav(path, out, 16000) == out
    jio.convert_to_wav(path, ref, 16000)
    got, want = tio.read_wav(out, 16000)[0], jio.read_wav(ref, 16000)[0]
    n = len(want)
    assert len(got) == n == 16000
    np.testing.assert_allclose(got[n // 8 : -n // 8], want[n // 8 : -n // 8], rtol=0,
                               atol=1e-4 + 1 / 32767)


# ---------------------------------------------------------------------------
# HTSAT
# ---------------------------------------------------------------------------


def test_htsat_geometry_helpers_equal_the_reference():
    for w in (4, 8):
        np.testing.assert_array_equal(th.relative_position_index(w),
                                      jh.relative_position_index(w))
    np.testing.assert_array_equal(th.shifted_window_mask(16, 16, 4, 2),
                                  jh.shifted_window_mask(16, 16, 4, 2))
    x = np.random.RandomState(7).randn(2, 8, 8, 3).astype(np.float32)
    wins = th.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jh.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(th.window_reverse(wins, 4, 8, 8).numpy(), x)
    cfg = jh.HTSATConfig.tiny()
    for frames in (256, 200, 300):  # exact, padded, cut
        mel = np.random.RandomState(frames).randn(2, frames, 16).astype(np.float32)
        np.testing.assert_array_equal(th.wav2img(torch.from_numpy(mel), th.HTSATConfig.tiny()).numpy(),
                                      np.asarray(jh.wav2img(jnp.asarray(mel), cfg)))


@pytest.mark.parametrize("shift", [0, 2], ids=["plain", "shifted"])
def test_window_attention_matches_jax(shift):
    cfg = th.HTSATConfig.tiny(**SHIFTED)
    block = random_tree(cfg, 8)["stages"][0]["blocks"][1]
    w, heads, c = cfg.window_size, cfg.num_heads[0], cfg.embed_dim
    x = np.random.RandomState(9).randn(2 * 16, w * w, c).astype(np.float32)  # 2 images of 4x4 windows
    mask = jh.shifted_window_mask(16, 16, w, shift) if shift else None
    want = np.asarray(jh.window_attention(jnp.asarray(x), jax.tree.map(jnp.asarray, block),
                                          heads, w, mask))
    tblock = {k: torch.from_numpy(v) for k, v in block.items()}
    got = th.window_attention(torch.from_numpy(x), tblock, heads, w,
                              th.shifted_window_mask(16, 16, w, shift) if shift else None)
    assert rel_to_max(got.numpy(), want) <= 1e-5
    if shift:  # the mask changes the answer: the check above reads it
        unmasked = th.window_attention(torch.from_numpy(x), tblock, heads, w, None)
        assert rel_to_max(unmasked.numpy(), want) > 1e-2


@functools.lru_cache(maxsize=None)
def _jax_embed(cfg_kw):
    return jax.jit(functools.partial(jh.htsat_embed, jh.HTSATConfig.tiny(**dict(cfg_kw))))


@pytest.mark.parametrize("mel_bn", [False, True], ids=["seeded", "hf_batchnorm"])
def test_htsat_embed_with_shifted_windows_matches_jax(mel_bn):
    cfg = th.HTSATConfig.tiny(**SHIFTED)
    tree = random_tree(cfg, 10, mel_bn=mel_bn)
    mel = (np.random.RandomState(11).randn(2, cfg.n_frames, cfg.n_mels) * 3 - 20).astype(np.float32)
    want = np.asarray(_jax_embed(tuple(SHIFTED.items()))(jax.tree.map(jnp.asarray, tree), mel))
    got = th.htsat_embed(cfg, htsat_params_from_numpy(tree, cfg, "cpu"), torch.from_numpy(mel))
    assert got.shape == (2, cfg.out_dim) and got.dtype == torch.float32
    assert rel_to_max(got.numpy(), want) <= 1e-5


def test_htsat_params_from_numpy_checks_the_tree():
    cfg = th.HTSATConfig.tiny(**SHIFTED)
    tree = random_tree(cfg, 12)
    params = htsat_params_from_numpy(tree, cfg, "cpu")
    assert params["stages"][1]["downsample"] is None
    assert params["stages"][0]["blocks"][1]["rel_bias"].shape == (49, 2)
    with pytest.raises(ValueError, match="depths"):
        htsat_params_from_numpy(tree, th.HTSATConfig.tiny(), "cpu")
    with pytest.raises(ValueError, match="embed_dim"):
        htsat_params_from_numpy(tree, th.HTSATConfig.tiny(depths=(2, 2), embed_dim=8), "cpu")


def test_clap_encoder_embed_batch_matches_jax():
    cfg = th.HTSATConfig.tiny(**SHIFTED)
    tree = random_tree(cfg, 13)
    rng = np.random.RandomState(14)
    n = cfg.n_frames * tenc.HOP + 1000  # the mel is cut to n_frames
    audio = np.stack([tenc.prepare_clip(tenc.quantize_roundtrip(0.3 * rng.randn(n)), rng,
                                        clip_samples=n) for _ in range(2)])
    want = jenc.ClapEncoder(jh.HTSATConfig.tiny(**SHIFTED),
                            jax.tree.map(jnp.asarray, tree)).embed_batch(audio)
    enc = tenc.ClapEncoder(cfg, htsat_params_from_numpy(tree, cfg, "cpu"), device="cpu")
    got = enc.embed_batch(audio)
    assert got.shape == (2, 512) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # embed_clip: quantize + rand_trunc of one clip from the RandomState
    long = (0.3 * np.random.RandomState(15).randn(tenc.CLIP_SAMPLES + 4000)).astype(np.float32)
    one = enc.embed_clip(long, np.random.RandomState(0))
    assert one.shape == (1, 512)
    clip = tenc.prepare_clip(tenc.quantize_roundtrip(long), np.random.RandomState(0))
    np.testing.assert_array_equal(one, enc.embed_batch(clip[None]))


def test_clap_encoder_needs_a_device_or_the_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tenc.ClapEncoder.random_init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tenc.ClapEncoder(th.HTSATConfig.tiny(), {})
    # data-parallel extraction takes a DeviceMesh (tests/test_torch_parallel.py)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tenc.ClapEncoder.random_init(th.HTSATConfig.tiny(), device="cpu", mesh=object())
    a = tenc.ClapEncoder.random_init(th.HTSATConfig.tiny(), seed=3, device="cpu")
    b = tenc.ClapEncoder.random_init(th.HTSATConfig.tiny(), seed=3, device="cpu")
    assert torch.equal(a.params["proj"]["w2"], b.params["proj"]["w2"])
    assert a.device.type == "cpu"


# ---------------------------------------------------------------------------
# the HF import
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_hf_clap():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_cfg = transformers.ClapAudioConfig(
        spec_size=64, num_mel_bins=16, patch_size=4, patch_stride=4,
        patch_embeds_hidden_size=16, depths=[2, 2], num_attention_heads=[2, 4],
        window_size=4, mlp_ratio=4.0, hidden_size=32, projection_dim=64,
        projection_hidden_act="relu", enable_fusion=False, drop_path_rate=0.0,
        attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0,
    )
    # depths of 2: HF's shifted windows too
    model = transformers.ClapAudioModelWithProjection(hf_cfg).eval().float()
    with torch.no_grad():  # non-trivial running statistics and relative-position tables
        enc = model.audio_model.audio_encoder
        enc.batch_norm.running_mean.normal_(0, 1)
        enc.batch_norm.running_var.uniform_(0.5, 2.0)
        for name, p in model.named_parameters():
            if "relative_position_bias_table" in name:
                p.normal_(0, 0.5)
    return hf_cfg, model


def test_clap_params_from_hf_match_the_jax_import_and_hf(tiny_hf_clap):
    hf_cfg, model = tiny_hf_clap
    jcfg, tcfg = jimp.config_from_hf(hf_cfg), timp.config_from_hf(hf_cfg)
    assert jcfg.__dict__ == tcfg.__dict__
    sd = model.state_dict()
    want = jimp.clap_params_from_hf({k: v.numpy() for k, v in sd.items()}, jcfg)
    got = timp.clap_params_from_hf(sd, tcfg, "cpu")
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), got))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5, err_msg=str(path))

    mel = np.random.RandomState(16).randn(2, tcfg.n_frames, tcfg.n_mels).astype(np.float32)
    emb = th.htsat_embed(tcfg, got, torch.from_numpy(mel)).numpy()
    ref = np.asarray(jax.jit(functools.partial(jh.htsat_embed, jcfg))(want, mel))
    np.testing.assert_allclose(emb, ref, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        hf = model(input_features=torch.from_numpy(mel[:, None])).audio_embeds.numpy()
    np.testing.assert_allclose(emb, hf, atol=2e-4, rtol=1e-3)


def test_load_clap_encoder_reads_an_hf_directory_as_the_reference(tiny_hf_clap, tmp_path):
    transformers = pytest.importorskip("transformers")
    hf_cfg, model = tiny_hf_clap
    model.save_pretrained(str(tmp_path))
    jcfg, want = jimp.load_clap_encoder(str(tmp_path))
    tcfg, got = timp.load_clap_encoder(str(tmp_path), device="cpu")
    assert tcfg.__dict__ == jcfg.__dict__
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))):
        np.testing.assert_array_equal(g, w)
    # a config.json that leaves fields out means ClapAudioConfig's defaults
    assert timp.CLAP_AUDIO_DEFAULTS == {
        k: getattr(transformers.ClapAudioConfig(), k) for k in timp.CLAP_AUDIO_DEFAULTS}
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"audio_config": {"spec_size": 64, "num_mel_bins": 16,
                                    "patch_embeds_hidden_size": 16, "depths": [2, 2],
                                    "num_attention_heads": [2, 4], "window_size": 4,
                                    "projection_dim": 64}}, f)
    assert timp.load_clap_encoder(str(tmp_path), device="cpu")[0].__dict__ == jcfg.__dict__
