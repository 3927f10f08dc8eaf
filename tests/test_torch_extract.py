"""The port's extraction CLI (`encoders/extract_cli.py`) against the JAX
package's, and the CLAP path as a whole: WAV files -> [1, 512] .npy
embeddings -> a CLAP-width LLark's greedy answer, on the CPU.

`jukebox`: both CLIs run `--checkpoint <npz>` (the parity fixture's state
dicts through the port's importer: a mid-size Jukebox, 512-token window of
65536 samples, width 64) over the same 44.1 kHz WAVs with the CLI's
defaults: bf16 prior, int16 upload, bf16 output, fps 10. They must write the
same file names and [floor(floor(512 n / 65536) / 34), 64] fp32 arrays
within JUKEBOX_TOL relative to max (below).

Both CLIs run `clap --tiny` over the same WAVs (48 kHz; one longer than
10 s in each batch, so rand_trunc draws from the run's RandomState) with
the same HTSAT weights: each package's seeded init is replaced by one
random numpy tree, given to JAX as it is and to the port through
`htsat_params_from_numpy`. They must write the same file names and arrays
within 1e-5. The embeddings then go through each package's
`infer_with_prompt` at `ModelConfig.tiny(mm_hidden_size=512)` from one
numpy parameter tree, and the greedy tokens must be EQUAL.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu import generate as jgen
from llark_tpu import infer as jinfer
from llark_tpu.config import ModelConfig as JaxConfig
from llark_tpu.encoders import extract_cli as jcli
from llark_tpu.encoders.clap import encode as jenc
from llark_tpu.tokenization import TokenizerBundle as JBundle
from llark_tpu.tokenization import WordTokenizer as JWordTokenizer
from llark_tpu_torch import generate as tgen
from llark_tpu_torch import infer as tinfer
from llark_tpu_torch.audio.io import write_wav
from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.encoders import extract_cli as tcli
from llark_tpu_torch.encoders.clap import encode as tenc
from llark_tpu_torch.encoders.jukebox import import_torch as jb_import
from llark_tpu_torch.encoders.clap.htsat import HTSATConfig, init_htsat_params
from llark_tpu_torch.interop.from_jax import htsat_params_from_numpy, params_from_numpy
from llark_tpu_torch.models.fusion import init_llark_params
from llark_tpu_torch.tokenization import TokenizerBundle, WordTokenizer

SR = 48000
# seconds: batches of 2 are (12, 3) and (11, 0.5): a rand_trunc draw in each
SECONDS = {"a_long.wav": 12.0, "b_short.wav": 3.0, "c_long.wav": 11.0, "d_tiny.wav": 0.5}
PROMPT = "What is the genre of this music?"
JB_FIX = os.path.join(os.path.dirname(__file__), "fixtures", "jukebox_parity")
JB_SR = 44100
# (seconds, channels): the fixture's window is 65536 samples (1.486 s), so
# one clip is cropped, three are padded, two are stereo; batches of 2
JB_WAVS = {"a_crop.wav": (2.0, 1), "b_pad.wav": (0.5, 2), "c_pad.wav": (1.2, 1),
           "d_pad.wav": (0.9, 2)}
# The two CLIs' .npy files, relative to max: both run the prior in bf16 and
# round the pooled output to bf16, so they differ by bf16 steps where fp32
# sums taken in another order round apart (the four files read 2.8e-3 to
# 6.7e-3): held at the repo's bf16 gate
JUKEBOX_TOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_wavs(directory, seconds=SECONDS, sr=SR, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(directory, exist_ok=True)
    for name, s in seconds.items():
        n = int(s * sr)
        # a tone under noise: a clip whose crop position shows in its embedding
        tone = np.sin(2 * np.pi * rng.uniform(100, 2000) * np.arange(n) / sr) * np.linspace(0, 1, n)
        write_wav(os.path.join(directory, name), 0.3 * tone + 0.05 * rng.randn(n), sr)
    return sorted(seconds)


def htsat_tree(seed=1):
    """A tiny HTSAT tree in the JAX layout, every leaf random (numpy)."""
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

    return fill(init_htsat_params(HTSATConfig.tiny(), 0, "cpu"))


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    """Both packages' `clap --tiny` over the same WAVs and weights; returns
    the WAV names and the two output directories."""
    root = tmp_path_factory.mktemp("clap")
    wavs = str(root / "wavs")
    names = write_wavs(wavs)
    tree = htsat_tree()
    mp = pytest.MonkeyPatch()
    mp.setattr(jenc, "init_htsat_params", lambda cfg, key: jax.tree.map(jnp.asarray, tree))
    mp.setattr(tenc, "init_htsat_params",
               lambda cfg, seed, device: htsat_params_from_numpy(tree, cfg, device))
    out = {"jax": str(root / "jax"), "torch": str(root / "torch")}
    args = ["clap", "--input-dir", wavs, "--batch-size", "2", "--tiny"]
    try:
        assert jcli.main(args + ["--output-dir", out["jax"]]) == 0
        assert tcli.main(args + ["--output-dir", out["torch"], "--device", "cpu"]) == 0
    finally:
        mp.undo()
    return wavs, names, out


def test_clap_cli_writes_what_the_reference_writes(extracted):
    _, names, out = extracted
    npys = [n.replace(".wav", ".npy") for n in names]
    assert sorted(os.listdir(out["torch"])) == sorted(os.listdir(out["jax"])) == npys
    for name in npys:
        got, want = np.load(os.path.join(out["torch"], name)), np.load(os.path.join(out["jax"], name))
        assert got.shape == want.shape == (1, 512) and got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
        assert abs(float(np.linalg.norm(got)) - 1.0) < 1e-5
    # each clip its own embedding, apart by more than the tolerance above
    embs = np.concatenate([np.load(os.path.join(out["torch"], n)) for n in npys])
    assert np.abs(embs[:, None] - embs[None]).max(-1)[np.triu_indices(len(npys), 1)].min() > 1e-4


def test_list_shard_and_skip_existing_follow_the_reference(tmp_path, extracted):
    wavs, names, _ = extracted
    out = str(tmp_path / "emb")
    for num_shards in (1, 2, 3):
        shards = [tcli.list_shard(wavs, num_shards, i, False, out) for i in range(num_shards)]
        assert shards == [jcli.list_shard(wavs, num_shards, i, False, out)
                          for i in range(num_shards)]
        assert sorted(sum(shards, [])) == names
    os.makedirs(out)
    np.save(os.path.join(out, names[0].replace(".wav", ".npy")), np.zeros(1))
    assert tcli.list_shard(wavs, 1, 0, True, out) == jcli.list_shard(wavs, 1, 0, True, out) \
        == names[1:]
    # the CLI with --skip-existing leaves the existing file and writes the rest
    assert tcli.main(["clap", "--input-dir", wavs, "--output-dir", out, "--tiny",
                      "--skip-existing", "--num-shards", "2", "--shard-index", "1",
                      "--device", "cpu"]) == 0
    written = sorted(os.listdir(out))
    assert written == sorted([names[0].replace(".wav", ".npy")]
                             + [n.replace(".wav", ".npy") for n in names[1::2]])
    assert np.load(os.path.join(out, written[0])).shape == (1,)


def test_run_clap_returns_what_it_did(tmp_path):
    # the parser main() uses; run_clap returns its ClapRun, which the
    # card's smoke run reads for its host / embed split
    wavs, out = str(tmp_path / "wavs"), str(tmp_path / "emb")
    write_wavs(wavs, {"a.wav": 1.0, "b.wav": 0.5, "c.wav": 0.25})
    ns = tcli.build_parser().parse_args(["clap", "--input-dir", wavs, "--output-dir", out,
                                         "--tiny", "--batch-size", "2", "--device", "cpu"])
    run = ns.fn(ns)
    assert isinstance(run, tcli.ClapRun) and run.n == 3
    assert sorted(os.listdir(out)) == ["a.npy", "b.npy", "c.npy"]
    assert 0 < run.host_s < run.seconds and 0 < run.embed_s < run.seconds
    assert run.host_s + run.embed_s <= run.seconds


@pytest.mark.parametrize("argv, item", [
    pytest.param(["clap", "--data-parallel"], "Queue A item 9", id="argv1-Queue A item 9"),
    pytest.param(["jukebox", "--data-parallel", "--fps", "10"], "Queue A item 9",
                 id="argv2-Queue A item 9"),
])
def test_jukebox_and_data_parallel_name_their_queue_items(tmp_path, argv, item):
    # Queue A item 9 brought --data-parallel into the port: one process alone
    # is a world of one, which writes what a run without the flag writes and
    # takes down the process group it brought up (two ranks with a batch
    # that does not divide them: tests/test_torch_parallel.py)
    wavs = str(tmp_path / "wavs")
    write_wavs(wavs, {"a.wav": 1.0, "b.wav": 0.5, "c.wav": 0.25})
    got = {}
    for flag in ([], ["--data-parallel"]):
        out = str(tmp_path / ("dp" if flag else "plain"))
        rest = [a for a in argv[1:] if a != "--data-parallel"]
        tcli.main(argv[:1] + ["--input-dir", wavs, "--output-dir", out, "--device", "cpu",
                              "--tiny", "--batch-size", "2"] + rest + flag)
        got[bool(flag)] = {n: np.load(os.path.join(out, n)) for n in sorted(os.listdir(out))}
    assert sorted(got[True]) == sorted(got[False]) == ["a.npy", "b.npy", "c.npy"]
    for name, want in got[False].items():
        np.testing.assert_array_equal(got[True][name], want)
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def jukebox_extracted(tmp_path_factory):
    """Both packages' `jukebox --checkpoint <npz>` over the same WAVs, at
    the CLI's defaults; returns the WAV directory, names, output
    directories and the port's JukeboxRun."""
    root = tmp_path_factory.mktemp("jukebox")
    meta = json.load(open(os.path.join(JB_FIX, "meta.json")))
    npz = str(root / "mid.npz")
    jb_import.main(["--vqvae", os.path.join(JB_FIX, "vqvae_sd.pt"),
                    "--prior", os.path.join(JB_FIX, "prior_sd.pt"),
                    "--output", npz, *meta["import_args"]])
    wavs = str(root / "wavs")
    rng = np.random.RandomState(11)
    os.makedirs(wavs)
    for name, (secs, channels) in JB_WAVS.items():
        n = int(secs * JB_SR)
        tone = np.sin(2 * np.pi * rng.uniform(100, 2000) * np.arange(n) / JB_SR)
        write_wav(os.path.join(wavs, name), 0.3 * tone[:, None] + 0.05 * rng.randn(n, channels),
                  JB_SR)
    out = {"jax": str(root / "jax"), "torch": str(root / "torch")}
    args = ["jukebox", "--input-dir", wavs, "--checkpoint", npz]
    assert jcli.main(args + ["--output-dir", out["jax"]]) == 0
    ns = tcli.build_parser().parse_args(args + ["--output-dir", out["torch"], "--device", "cpu"])
    return wavs, sorted(JB_WAVS), out, ns.fn(ns)


def test_jukebox_cli_writes_what_the_reference_writes(jukebox_extracted):
    _, names, out, run = jukebox_extracted
    assert isinstance(run, tcli.JukeboxRun) and run.n == len(names)
    assert 0 < run.host_s < run.seconds and 0 < run.encode_s < run.seconds
    npys = [n.replace(".wav", ".npy") for n in names]
    assert sorted(os.listdir(out["torch"])) == sorted(os.listdir(out["jax"])) == npys
    for name, npy in zip(names, npys):
        got, want = np.load(os.path.join(out["torch"], npy)), np.load(os.path.join(out["jax"], npy))
        secs, _ = JB_WAVS[name]
        n = min(int(secs * JB_SR), 65536)
        assert got.shape == want.shape == ((512 * n // 65536) // 34, 64), name
        assert got.dtype == want.dtype == np.float32 and np.isfinite(got).all()
        err = float(np.abs(got - want).max() / np.abs(want).max())
        assert err <= JUKEBOX_TOL, (name, err)


def test_jukebox_cli_skip_existing(jukebox_extracted, tmp_path):
    wavs, names, out, _ = jukebox_extracted
    npys = [n.replace(".wav", ".npy") for n in names]
    shutil.copytree(out["torch"], tmp_path / "emb")
    os.remove(tmp_path / "emb" / npys[1])
    before = {n: os.path.getmtime(tmp_path / "emb" / n) for n in npys if n != npys[1]}
    ns = tcli.build_parser().parse_args(
        ["jukebox", "--input-dir", wavs, "--output-dir", str(tmp_path / "emb"), "--device", "cpu",
         "--checkpoint", os.path.join(os.path.dirname(out["torch"]), "mid.npz"),
         "--skip-existing"])
    run = ns.fn(ns)
    assert run.n == 1 and sorted(os.listdir(tmp_path / "emb")) == npys
    assert {n: os.path.getmtime(tmp_path / "emb" / n) for n in before} == before
    np.testing.assert_array_equal(np.load(tmp_path / "emb" / npys[1]),
                                  np.load(os.path.join(out["torch"], npys[1])))
    assert ns.fn(ns).n == 0


def test_jukebox_cli_openai_route_checks_the_vqvae_as_the_reference(tmp_path):
    # --checkpoint + --prior-checkpoint read openai state dicts with the 5B
    # VQ-VAE config (4 res blocks a stage); the fixture's has 2, and both
    # packages refuse it rather than truncate
    os.makedirs(tmp_path / "wavs")
    args = ["jukebox", "--input-dir", str(tmp_path / "wavs"), "--output-dir", str(tmp_path / "out"),
            "--checkpoint", os.path.join(JB_FIX, "vqvae_sd.pt"),
            "--prior-checkpoint", os.path.join(JB_FIX, "prior_sd.pt"), "--prior-depth", "6"]
    with pytest.raises(ValueError, match="checkpoint has 2 res blocks") as want:
        jcli.main(args)
    with pytest.raises(ValueError, match="checkpoint has 2 res blocks") as got:
        tcli.main(args + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_jukebox_cli_needs_the_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    os.makedirs(tmp_path / "wavs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["jukebox", "--input-dir", str(tmp_path / "wavs"), "--output-dir",
                   str(tmp_path / "out"), "--tiny"])
    assert tcli.main(["jukebox", "--input-dir", str(tmp_path / "wavs"), "--output-dir",
                      str(tmp_path / "out"), "--tiny", "--device", "cpu"]) == 0


def test_clap_embeddings_answer_alike_through_both_packages(extracted):
    _, names, out = extracted
    over = dict(dtype="float32", param_dtype="float32", mm_hidden_size=512)
    jcfg, tcfg = JaxConfig.tiny(**over), ModelConfig.tiny(**over)
    tree = jax.tree.map(lambda t: t.numpy(), init_llark_params(tcfg, seed=3, device="cpu"))
    jb = JBundle.from_tokenizer(JWordTokenizer(512))
    tb = TokenizerBundle.from_tokenizer(WordTokenizer(512))
    gcfg = dict(max_new_tokens=6, stop_text="")
    jg = jgen.Generator(jcfg, jax.tree.map(jnp.asarray, tree), jb.audio_patch_id,
                        jgen.GenerationConfig(**gcfg), max_cache_len=256)
    tg = tgen.Generator(tcfg, params_from_numpy(tree, tcfg, "cpu"), tb.audio_patch_id,
                        tgen.GenerationConfig(**gcfg), max_cache_len=256, device="cpu")
    for name in names:
        npy = name.replace(".wav", ".npy")
        t_enc, j_enc = (np.load(os.path.join(out[k], npy)) for k in ("torch", "jax"))
        ids = tinfer.build_prompt_ids(PROMPT, 1, tb)
        assert ids == jinfer.build_prompt_ids(PROMPT, 1, jb)
        args = (np.array([ids + [tb.pad_token_id] * (128 - len(ids))], np.int32),
                np.array([len(ids)], np.int32))
        got = tg.generate(*args, t_enc[None], np.array([1], np.int32))[0]
        want = jg.generate(*args, j_enc[None], np.array([1], np.int32))[0]
        assert got == want and len(got) == 6, name
        text = tinfer.infer_with_prompt(PROMPT, t_enc, tg, tb)
        assert text == jinfer.infer_with_prompt(PROMPT, j_enc, jg, jb)
