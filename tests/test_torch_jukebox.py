"""The port's Jukebox encoder (`llark_tpu_torch/encoders/jukebox/`) against
the JAX package and the parity goldens, on the CPU.

Two kinds of oracle:
  * `tests/fixtures/jukebox_parity/`: a mid-size torch Jukebox in openai
    checkpoint naming and its goldens (HF's torch port of openai/jukebox).
    The port's importer reads the state dicts; codes and the conditioner
    must equal the goldens exactly, activations and pooled embeddings stay
    within atol 1e-6, the JAX package's own bar (test_jukebox_parity.py).
  * the JAX package at `tiny()` configs: one random JAX tree goes to both
    packages (to the port through `jukebox_params_from_numpy`). fp32 within
    1e-5 relative to max; a bf16 prior within BF16_TOL (below).

The JAX side runs in module fixtures, so each recorded test call is the
port's work (well under a second at these sizes).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu.encoders.jukebox import conditioner as jcond
from llark_tpu.encoders.jukebox import encode as jenc
from llark_tpu.encoders.jukebox import import_torch as jimp
from llark_tpu.encoders.jukebox import prior as jprior
from llark_tpu.encoders.jukebox import vqvae as jvq
from llark_tpu.encoders.jukebox.config import JukeboxPriorConfig as JPriorConfig
from llark_tpu.encoders.jukebox.config import JukeboxVQVAEConfig as JVQConfig
from llark_tpu_torch.encoders.jukebox import conditioner as tcond
from llark_tpu_torch.encoders.jukebox import encode as tenc
from llark_tpu_torch.encoders.jukebox import import_torch as timp
from llark_tpu_torch.encoders.jukebox import prior as tprior
from llark_tpu_torch.encoders.jukebox import vqvae as tvq
from llark_tpu_torch.encoders.jukebox.config import JukeboxPriorConfig, JukeboxVQVAEConfig
from llark_tpu_torch.interop.from_jax import jukebox_params_from_numpy

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "jukebox_parity")
CLIPS = ("full", "short", "stereo")
GOLD_ATOL = 1e-6  # the JAX package's bar against the torch oracle
FP32_TOL = 1e-5  # relative to max, the port's fp32 twins against JAX
# A bf16 prior, relative to max over [N, n_ctx, width], held at the repo's
# bf16 logits gate: both packages round every projection, the attention
# output and the MLP input to bf16 after fp32 sums taken in another order,
# so a value can land on the neighbouring bf16 number and carry that step
# through 6 layers. Four seeds of this case read 1.0e-2 to 1.7e-2 (fp32:
# 3.9e-7 to 1.3e-6), about one bf16 step at the largest activations.
BF16_TOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meta():
    with open(os.path.join(FIX, "meta.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def gold():
    return np.load(os.path.join(FIX, "goldens.npz"))


@pytest.fixture(scope="module")
def clips():
    return np.load(os.path.join(FIX, "audio.npz"))


@pytest.fixture(scope="module")
def bundle(tmp_path_factory, meta):
    """The fixture state dicts through the port's importer CLI -> npz."""
    path = str(tmp_path_factory.mktemp("jb") / "mid.npz")
    timp.main(["--vqvae", os.path.join(FIX, "vqvae_sd.pt"),
               "--prior", os.path.join(FIX, "prior_sd.pt"),
               "--output", path, *meta["import_args"]])
    return path


@pytest.fixture(scope="module")
def encoder(bundle, meta):
    enc = tenc.JukeboxEncoder.from_npz(bundle, pool_frames_per_second=meta["fps"], device="cpu")
    enc.encode_batch(np.zeros((1, enc.samples_per_ctx), np.float32))  # first-call set-up
    return enc


def _padded(enc, audio):
    return tenc.pad_or_crop(tenc.prepare_audio(audio), enc.samples_per_ctx)


def _rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the parity goldens
# ---------------------------------------------------------------------------


def test_conditioner_matches_the_goldens_and_jax(encoder, gold):
    # table lookups and sums: exact, against the oracle and the JAX package
    np.testing.assert_array_equal(encoder._conds[0].numpy(), gold["x_cond"])
    np.testing.assert_array_equal(encoder._conds[1].numpy(), gold["y_cond"])
    sd = torch.load(os.path.join(FIX, "prior_sd.pt"), map_location="cpu")["model"]
    t_params = tcond.convert_conditioner(timp.strip_module(sd))
    j_params = jcond.convert_conditioner(jimp.strip_module(sd))
    assert t_params.keys() == j_params.keys()
    for name in t_params:
        np.testing.assert_array_equal(t_params[name], j_params[name])
    t_cfg = tcond.infer_conditioner_config(t_params, 512, 64)
    j_cfg = jcond.infer_conditioner_config(j_params, 512, 64)
    assert vars(t_cfg) == vars(j_cfg)
    # two rows of other metadata too: an offset, a second genre slot, clamping
    t_cfg.max_nb_genres = j_cfg.max_nb_genres = 2
    meta = np.array([[2734080, 0, 2734080, 0, 0, -1],
                     [5000000, 1000000, 65536, 1, 3, 2]], np.int64)
    for got, want in zip(tcond.get_cond(t_cfg, t_params, meta),
                         jcond.get_cond(j_cfg, j_params, meta)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcond.dummy_metadata(t_cfg, 128, n=2),
                                  jcond.dummy_metadata(j_cfg, 128, n=2))


@pytest.mark.parametrize("name", CLIPS)
def test_codes_equal_the_goldens(encoder, gold, clips, meta, name):
    audio = torch.from_numpy(_padded(encoder, clips[name])[None])
    codes = tvq.encode_top(encoder.vq_cfg, encoder.vq_params, audio)[0, : meta["n_ctx"]]
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), gold[f"{name}.codes"])
    assert len(np.unique(codes.numpy())) > 16  # a degenerate fixture would pass trivially


def test_prior_acts_on_golden_codes(encoder, gold):
    acts = tprior.prior_encode(encoder.prior_cfg, encoder.prior_params,
                               torch.from_numpy(gold["full.codes"][None]),
                               torch.from_numpy(gold["x_cond"]), torch.from_numpy(gold["y_cond"]))
    assert acts.dtype == torch.float32 and acts.shape == (1, 512, 64)
    np.testing.assert_allclose(acts[0].numpy(), gold["full.acts"], atol=GOLD_ATOL, rtol=0)


@pytest.mark.parametrize("name", CLIPS)
def test_pooled_embeddings_equal_the_goldens(encoder, gold, clips, name):
    got = encoder.get_acts_from_audio(clips[name])
    want = gold[f"{name}.pooled"]
    assert got.shape == want.shape, name  # the short clip's truncation included
    np.testing.assert_allclose(got, want, atol=GOLD_ATOL, rtol=0)


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory, meta):
    path = str(tmp_path_factory.mktemp("jbj") / "mid.npz")
    jimp.main(["--vqvae", os.path.join(FIX, "vqvae_sd.pt"),
               "--prior", os.path.join(FIX, "prior_sd.pt"),
               "--output", path, *meta["import_args"]])
    return path


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, (tree.numpy() if isinstance(tree, torch.Tensor)
                       else tree if isinstance(tree, jax.ShapeDtypeStruct) else np.asarray(tree))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_reads_back_as_jax_load_npz_reads_it(bundle, jax_bundle, writer):
    path = bundle if writer == "port" else jax_bundle
    got, want = timp.load_npz(path), jimp.load_npz(path)
    assert vars(got[0]) == vars(want[0]) and vars(got[1]) == vars(want[1])
    for g_tree, w_tree in zip(got[2:], want[2:]):
        g, w = dict(_leaves(g_tree)), dict(_leaves(w_tree))
        assert g.keys() == w.keys()
        for key in g:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    # and both importers write the same arrays under the same keys
    port, ref = np.load(bundle), np.load(jax_bundle)
    assert port.files == ref.files
    for key in port.files:
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)


def test_importer_counts_res_blocks_from_the_checkpoint():
    sd = torch.load(os.path.join(FIX, "vqvae_sd.pt"), map_location="cpu")["model"]
    cfg = JukeboxVQVAEConfig(width=8, depth=3, emb_width=16, l_bins=64)
    with pytest.raises(ValueError, match="checkpoint has 2 res blocks"):
        timp.convert_vqvae(sd, cfg)
    tree = timp.convert_vqvae(sd, JukeboxVQVAEConfig(width=8, depth=2, emb_width=16, l_bins=64))
    assert [len(s["res"]) for lv in tree["levels"] for s in lv["stages"]] == [2] * 7


# ---------------------------------------------------------------------------
# the JAX package at tiny configs, from one numpy tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """One random JAX tree at tiny() (numpy leaves), an audio batch, codes,
    conditioning, and the JAX package's outputs on them."""
    vq_cfg, pr_cfg = JVQConfig.tiny(), JPriorConfig.tiny()
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    vq = jax.tree.map(np.asarray, jvq.init_vqvae_params(vq_cfg, k1))
    pr = jax.tree.map(np.asarray, jprior.init_prior_params(pr_cfg, k2))
    rng = np.random.RandomState(4)
    audio = (0.3 * rng.randn(3, 512)).astype(np.float32)
    codes = rng.randint(0, pr_cfg.bins, (2, pr_cfg.n_ctx)).astype(np.int32)
    x_cond = (0.1 * rng.randn(1, pr_cfg.n_ctx, pr_cfg.width)).astype(np.float32)
    y_cond = (0.1 * rng.randn(1, 1, pr_cfg.width)).astype(np.float32)
    want = {"codes": np.asarray(jax.jit(lambda a: jvq.encode_top(vq_cfg, vq, a))(audio))}
    for dtype in ("float32", "bfloat16"):
        cfg = JPriorConfig.tiny(dtype=dtype)
        want[dtype] = np.asarray(jax.jit(lambda c: jprior.prior_encode(
            cfg, pr, c, jnp.asarray(x_cond), jnp.asarray(y_cond)))(codes))
    encoders = {}
    for transfer, output in (("float32", "float32"), ("int16", "bfloat16")):
        enc = jenc.JukeboxEncoder(vq_cfg, pr_cfg, vq, pr, x_cond=x_cond, y_cond=y_cond,
                                  pool_frames_per_second=None, transfer_dtype=transfer,
                                  output_dtype=output)
        encoders[transfer] = (enc._prepare_transfer(audio), enc.encode_batch(audio, [512, 300, 7]))
    return dict(vq=vq, pr=pr, audio=audio, codes=codes, x_cond=x_cond, y_cond=y_cond,
                want=want, encoders=encoders)


def test_jukebox_params_from_numpy_encode_top_equals_jax(tiny):
    vq, _ = jukebox_params_from_numpy(tiny["vq"], tiny["pr"], "cpu")
    codes = tvq.encode_top(JukeboxVQVAEConfig.tiny(), vq, torch.from_numpy(tiny["audio"]))
    assert codes.shape == (3, 64)
    np.testing.assert_array_equal(codes.numpy(), tiny["want"]["codes"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jukebox_params_from_numpy_prior_encode_matches_jax(tiny, dtype):
    _, pr = jukebox_params_from_numpy(tiny["vq"], tiny["pr"], "cpu")
    assert pr["layers"]["attn_w"].shape == (2, 3, 16, 24) and pr["x_emb"].dtype == torch.float32
    got = tprior.prior_encode(JukeboxPriorConfig.tiny(dtype=dtype), pr,
                              torch.from_numpy(tiny["codes"]), torch.from_numpy(tiny["x_cond"]),
                              torch.from_numpy(tiny["y_cond"]))
    assert got.dtype == torch.float32 and got.shape == (2, 64, 16)
    err = _rel_to_max(got.numpy(), tiny["want"][dtype])
    assert err <= (FP32_TOL if dtype == "float32" else BF16_TOL), err


def test_jukebox_params_from_numpy_checks_keys_and_shapes(tiny):
    vq, pr = tiny["vq"], tiny["pr"]
    bad = dict(pr, layers=dict(pr["layers"], fc_w=pr["layers"]["fc_w"][:, :, :8]))
    with pytest.raises(ValueError, match="layers/fc_w"):
        jukebox_params_from_numpy(vq, bad, "cpu")
    bad = dict(pr, layers={k: v for k, v in pr["layers"].items() if k != "ln1_b"})
    with pytest.raises(ValueError, match="layers hold"):
        jukebox_params_from_numpy(vq, bad, "cpu")
    stage = vq["levels"][1]["stages"][0]
    bad = dict(vq, levels=[vq["levels"][0], dict(vq["levels"][1], stages=[
        dict(stage, down_w=stage["down_w"][:, :3])])] + vq["levels"][2:])
    with pytest.raises(ValueError, match="levels/1/stages/0/down_w"):
        jukebox_params_from_numpy(bad, pr, "cpu")
    with pytest.raises(ValueError, match="codebooks"):
        jukebox_params_from_numpy(dict(vq, codebooks=vq["codebooks"][:2]), pr, "cpu")
    _, pr16 = jukebox_params_from_numpy(vq, pr, "cpu", torch.bfloat16)
    assert pr16["pos_emb"].dtype == torch.bfloat16


@pytest.mark.parametrize("transfer,output", [("float32", "float32"), ("int16", "bfloat16")])
def test_encoder_transfer_and_output_dtypes_match_jax(tiny, transfer, output):
    vq, pr = jukebox_params_from_numpy(tiny["vq"], tiny["pr"], "cpu")
    enc = tenc.JukeboxEncoder(JukeboxVQVAEConfig.tiny(), JukeboxPriorConfig.tiny(), vq, pr,
                              x_cond=tiny["x_cond"], y_cond=tiny["y_cond"],
                              pool_frames_per_second=None, transfer_dtype=transfer,
                              output_dtype=output, device="cpu")
    upload, (want, want_counts) = tiny["encoders"][transfer]
    # the upload: int16 values equal to the JAX package's quantization
    np.testing.assert_array_equal(enc._prepare_transfer(tiny["audio"]).numpy(), upload)
    got, counts = enc.encode_batch(tiny["audio"], [512, 300, 7])
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(counts, [64, 37, 0])
    assert got.dtype == np.float32 and got.shape == (3, 64, 16)
    if output == "bfloat16":
        # values on the bf16 grid, each within one bf16 step of JAX's (at
        # most 2**-7 relative, 8 significant bits): fp32 sums taken in
        # another order may round to neighbouring bf16 numbers
        assert np.array_equal(got, torch.from_numpy(got).bfloat16().float().numpy())
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    else:
        assert _rel_to_max(got, want) <= FP32_TOL


def test_encode_stream_equals_encode_batch(tiny):
    vq, pr = jukebox_params_from_numpy(tiny["vq"], tiny["pr"], "cpu")
    enc = tenc.JukeboxEncoder(JukeboxVQVAEConfig.tiny(), JukeboxPriorConfig.tiny(), vq, pr,
                              pool_frames_per_second=None, transfer_dtype="int16",
                              output_dtype="bfloat16", device="cpu")
    rng = np.random.RandomState(5)
    batches = [((0.3 * rng.randn(2, 512)).astype(np.float32), np.array([512, 100 * i]))
               for i in range(3)]
    asked = []

    def feed():
        for i, b in enumerate(batches):
            asked.append(i)
            yield b

    stream = enc.encode_stream(feed())
    for i, (audio, lengths) in enumerate(batches):
        acts, counts = next(stream)
        # batch i + 1 was asked for (and enqueued) before batch i came back
        assert asked == list(range(min(i + 2, len(batches))))
        want, want_counts = enc.encode_batch(audio, lengths)
        np.testing.assert_array_equal(acts, want)
        np.testing.assert_array_equal(counts, want_counts)
    assert next(stream, None) is None


# ---------------------------------------------------------------------------
# pieces against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("func", ["row_attention", "column_attention", "prev_row_attention"])
def test_factored_attention_matches_jax(func):
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(2, 2, 32, 8).astype(np.float32) for _ in range(3))
    got = getattr(tprior, func)(*map(torch.from_numpy, (q, k, v)), 4).numpy()
    want = np.asarray(getattr(jprior, func)(*map(jnp.asarray, (q, k, v)), 4))
    assert _rel_to_max(got, want) <= FP32_TOL
    if func == "prev_row_attention":
        assert not got[:, :, :8].any()  # block 0 attends to zeros: zeros


def test_audio_helpers_match_jax():
    rng = np.random.RandomState(7)
    stereo = rng.randn(2, 1000).astype(np.float32)
    np.testing.assert_array_equal(tenc.prepare_audio(stereo), jenc.prepare_audio(stereo))
    np.testing.assert_array_equal(tenc.prepare_audio(np.zeros(5)), jenc.prepare_audio(np.zeros(5)))
    for n in (10, 512, 2000):
        np.testing.assert_array_equal(tenc.pad_or_crop(stereo[0, :n], 512),
                                      jenc.pad_or_crop(stereo[0, :n], 512))
    assert tenc.ACTS_SAMPLE_RATE == jenc.ACTS_SAMPLE_RATE and tenc.pooled_frame_len(10) == 34
    acts = rng.randn(3, 37, 12).astype(np.float32)
    got = tenc.windowed_average(torch.from_numpy(acts), 5).numpy()
    want = np.asarray(jenc.windowed_average(jnp.asarray(acts), 5))
    assert got.shape == (3, 7, 12)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_quantize_matches_a_naive_argmin():
    rng = np.random.RandomState(8)
    x = rng.randn(2, 8, 16).astype(np.float32)
    book = rng.randn(32, 8).astype(np.float32)
    d = ((x.transpose(0, 2, 1)[:, :, None] - book[None, None]) ** 2).sum(-1)
    got = tvq.quantize(torch.from_numpy(x), torch.from_numpy(book))
    np.testing.assert_array_equal(got.numpy(), d.argmin(-1))


def test_full_fp32_keeps_tf32_off_inside_and_restores_the_flags():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with tvq.full_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_random_init_shapes_and_config_copies():
    assert vars(JukeboxVQVAEConfig()) == vars(JVQConfig())
    assert vars(JukeboxPriorConfig()) == vars(JPriorConfig())
    cfg = JukeboxPriorConfig()
    assert (cfg.block_ctx, cfg.attn_width, cfg.mlp_width) == (64, 1200, 4800)
    assert JukeboxVQVAEConfig().hop_lengths == (8, 32, 128)
    enc = tenc.JukeboxEncoder.random_init(JukeboxVQVAEConfig.tiny(), JukeboxPriorConfig.tiny(),
                                          device="cpu")
    j_vq = jax.eval_shape(lambda: jvq.init_vqvae_params(JVQConfig.tiny(), jax.random.PRNGKey(0)))
    j_pr = jax.eval_shape(lambda: jprior.init_prior_params(JPriorConfig.tiny(),
                                                           jax.random.PRNGKey(0)))
    for got, want in ((enc.vq_params, j_vq), (enc.prior_params, j_pr)):
        assert {k: v.shape for k, v in _leaves(got)} == {k: v.shape for k, v in _leaves(want)}
    assert enc.samples_per_ctx == 512
    acts, counts = enc.encode_batch(np.zeros((1, 512), np.float32))
    assert acts.shape == (1, 1, 16) and np.isfinite(acts).all() and list(counts) == [1]


# ---------------------------------------------------------------------------
# the device contract
# ---------------------------------------------------------------------------


def test_entry_points_need_the_gpu_unless_asked_for_the_cpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    vq_cfg, pr_cfg = JukeboxVQVAEConfig.tiny(), JukeboxPriorConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tenc.JukeboxEncoder.random_init(vq_cfg, pr_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jukebox_params_from_numpy(tiny["vq"], tiny["pr"])
    vq, pr = jukebox_params_from_numpy(tiny["vq"], tiny["pr"], "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tenc.JukeboxEncoder(vq_cfg, pr_cfg, vq, pr)
    enc = tenc.JukeboxEncoder(vq_cfg, pr_cfg, vq, pr, device="cpu")
    assert enc.device.type == "cpu" and enc.vq_params["codebooks"][0].device.type == "cpu"
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        tenc.JukeboxEncoder(vq_cfg, pr_cfg, vq, pr, device="cpu", mesh=object())
