"""The port's annotator trainer (`python -m
llark_tpu_torch.audio.train_annotators`) against the JAX package's
scripts/train_annotators.py, on the CPU.

The JAX trainer is loaded by file path (as tests/test_neural_annotators.py
does) and run once per module in fixtures: its datasets of one family's
4 s clips, its initial trees (PRNGKey(0) / (1)) and 3 of its Adam steps
from them. The port, given the same initial tree and a RandomState of the
same seed, must draw the same batches and land within 1e-5 of the JAX
trainer's weights, relative to each tensor's largest entry (fp32; the
Adam bias corrections are fp32 in optax and double in torch, ~6e-6 of an
update). The file the port writes must read through both packages'
`load_params`, in the committed file's keys, shapes and dtypes.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from llark_tpu.audio import neural as jneural
from llark_tpu_torch.audio import neural as tneural
from llark_tpu_torch.audio import train_annotators as ta

TOL = 1e-5  # relative to max, per tensor
STEPS, BATCH, CROP, KEY_BATCH, LR = 3, 4, 200, 8, 1e-3
FAMILY = ["additive"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    # torch.optim's first optimizer imports its compile hooks (~2 s here):
    # pay for it in the module's setup, not in a recorded test
    torch.optim.Adam([torch.nn.Parameter(torch.zeros(1))])
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def jt():
    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "train_annotators.py")
    spec = importlib.util.spec_from_file_location("train_annotators", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data(jt):
    beat = jt.build_beat_dataset(2, jt.TRAIN_SEED_BASE, seconds=4.0, families=FAMILY)
    key = jt.build_key_dataset(2, jt.TRAIN_SEED_BASE, seconds=4.0, families=FAMILY)
    return beat, key


@pytest.fixture(scope="module")
def jax_runs(jt, data):
    (feats, targs), (xs, ys) = data
    init = {k: np.asarray(v) for k, v in {
        **jt.init_params(jneural.beat_param_shapes(), jax.random.PRNGKey(0)),
        **jt.init_params(jneural.key_param_shapes(), jax.random.PRNGKey(1))}.items()}
    beat = jt.train_beat(feats, targs, STEPS, BATCH, CROP, LR, np.random.RandomState(0))
    key = jt.train_key(xs, ys, STEPS, KEY_BATCH, LR, np.random.RandomState(0))
    return init, {k: np.asarray(v) for k, v in {**beat, **key}.items()}


def test_datasets_equal_the_reference(jt, data):
    (feats, targs), (xs, ys) = data
    (got_f, got_t), (got_x, got_y) = ta.build_datasets(2, ta.TRAIN_SEED_BASE, seconds=4.0,
                                                       families=FAMILY)
    assert len(got_f) == len(feats) == 2
    for a, b in zip(got_f + got_t, feats + targs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got_x, xs)
    np.testing.assert_array_equal(got_y, ys)
    assert got_x.shape == (2, 120, 12) and got_y.dtype == np.int32
    assert ta.TRAIN_SEED_BASE == jt.TRAIN_SEED_BASE
    for times, n in (([0.0, 0.5, 1.234, 9.99, -1.0], 120), ([], 5), ([0.01, 0.02], 4)):
        np.testing.assert_array_equal(ta.smear_targets(times, n, 100),
                                      jt.smear_targets(times, n, 100))


def test_the_key_dataset_leaves_percussion_out():
    assert [f for _, f in ta._clip_seeds(1, 0, None, skip=("perc",))] == [
        f for f in ta.FAMILIES if f != "perc"]
    # one pass over the clips gives each builder's dataset
    fams = ["perc", "additive"]
    (feats, targs), (xs, ys) = ta.build_datasets(1, 0, seconds=1.0, families=fams)
    assert len(feats) == 2 and len(xs) == len(ys) == 1
    got_f, got_t = ta.build_beat_dataset(1, 0, seconds=1.0, families=fams)
    got_x, got_y = ta.build_key_dataset(1, 0, seconds=1.0, families=fams)
    for a, b in zip(got_f + got_t + [got_x, got_y], feats + targs + [xs, ys]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("net", ["beat", "key"])
def test_three_steps_match_the_jax_trainer(data, jax_runs, net):
    (feats, targs), (xs, ys) = data
    init, want = jax_runs
    rng = np.random.RandomState(0)
    if net == "beat":
        run = ta.train_beat(feats, targs, STEPS, BATCH, CROP, LR, rng, init=init, device="cpu")
    else:
        run = ta.train_key(xs, ys, STEPS, KEY_BATCH, LR, rng, init=init, device="cpu")
    assert sorted(run.params) == sorted(k for k in want if k.startswith(net + "/"))
    for name, got in run.params.items():
        assert got.dtype == np.float32 and got.shape == want[name].shape
        assert _rel(got, want[name]) <= TOL, name
        assert not np.array_equal(got, init[name]), name  # the steps moved it
    assert len(run.losses) == STEPS and all(np.isfinite(run.losses))
    assert 0.0 <= run.batch_seconds <= run.seconds


def test_the_written_file_reads_through_both_packages(data, jax_runs, tmp_path):
    _, want = jax_runs
    path = str(tmp_path / "w.npz")
    ta.save_params(path, want)
    with np.load(tneural.WEIGHTS_PATH) as z:
        committed = {k: (z[k].shape, z[k].dtype) for k in z.files}
    with np.load(path) as z:
        assert {k: (z[k].shape, z[k].dtype) for k in z.files} == committed
    jp, tp = jneural.load_params(path), tneural.load_params(path)
    (feats, _), (xs, _) = data
    beat, key = tneural.nets_from_params(tp, "cpu")
    assert _rel(tneural.beat_activations(beat, feats[0]),
                jneural.beat_activations_np(jp, feats[0])) <= TOL
    assert _rel(tneural.key_logits(key, xs[0]), jneural.key_logits_np(jp, xs[0])) <= TOL


def test_params_from_nets_inverts_nets_from_params():
    params = tneural.load_params()
    beat, key = tneural.nets_from_params(params, "cpu")
    back = ta.params_from_nets(beat, key)
    assert list(back) == list(tneural.beat_param_shapes()) + list(tneural.key_param_shapes())
    for name, arr in params.items():
        np.testing.assert_array_equal(back[name], arr)
    assert list(ta.params_from_nets(key=key)) == list(tneural.key_param_shapes())


def test_initial_weights_come_from_a_seeded_generator():
    shapes = tneural.beat_param_shapes()
    a = ta.init_tree(shapes, torch.Generator().manual_seed(0))
    b = ta.init_tree(shapes, torch.Generator().manual_seed(0))
    assert list(a) == list(shapes)
    for name, shape in shapes.items():
        assert a[name].shape == shape and a[name].dtype == np.float32
        np.testing.assert_array_equal(a[name], b[name])
        if name.endswith("_b"):
            assert not a[name].any()
        else:  # He-normal over the JAX layout's fan-in
            assert abs(a[name].std() / np.sqrt(2.0 / np.prod(shape[:-1])) - 1) < 0.2
    with pytest.raises(ValueError, match="initial beat weights"):
        ta.train_beat([], [], 1, 1, 1, LR, np.random.RandomState(0),
                      init={"beat/conv0_w": a["beat/conv0_w"]}, device="cpu")


def _small_data(data, monkeypatch):
    (feats, targs), (xs, ys) = data
    monkeypatch.setattr(ta, "build_datasets", lambda *a, **kw: ((feats, targs), (xs, ys)))


def test_cli_writes_the_weights_and_scores_them(data, tmp_path, monkeypatch, capsys):
    _small_data(data, monkeypatch)
    scored = []
    monkeypatch.setattr(ta, "run_benchmark", lambda *a, **kw: scored.append(kw) or {"beat_f": 0.5})
    out = str(tmp_path / "w.npz")
    beat, key = ta.main(["--steps-beat", "2", "--steps-key", "2", "--batch", "2", "--crop", "100",
                         "--eval-n", "1", "--out", out, "--device", "cpu"])
    assert len(beat.losses) == len(key.losses) == 2
    written = jneural.load_params(out)
    assert list(written) == list(beat.params) + list(key.params)
    for name, arr in {**beat.params, **key.params}.items():
        np.testing.assert_array_equal(written[name], arr)
    assert [kw["family"] for kw in scored] == list(ta.FAMILIES)
    assert scored[0]["annotators"][1].weights == out
    assert "saved " + out in capsys.readouterr().out


def test_lofo_writes_its_json_under_the_given_path(data, tmp_path, monkeypatch):
    _small_data(data, monkeypatch)
    monkeypatch.setattr(ta, "run_benchmark", lambda *a, **kw: {"beat_f": 0.25, "key_mirex": 1.0})
    out = tmp_path / "lofo.json"
    rows = ta.main(["--lofo", "--steps-beat", "1", "--steps-key", "1", "--batch", "2",
                    "--crop", "100", "--eval-n", "1", "--lofo-out", str(out), "--device", "cpu"])
    assert [r["excluded_family"] for r in rows] == list(ta.FAMILIES)
    assert json.loads(out.read_text())["rows"] == rows
    assert rows[0]["lofo_beat_f"] == 0.25 and rows[0]["dsp_key_mirex"] == 1.0
    assert ta.LOFO_OUT.startswith(os.path.dirname(ta.__file__))
