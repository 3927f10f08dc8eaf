"""The port stands alone: no JAX, no llark_tpu, and no quiet CPU fallback.

Every module of llark_tpu_torch, and chip_smoke.py, is imported in a fresh
interpreter whose import system refuses jax, flax, optax, orbax, chex and
llark_tpu; and every import statement in their sources, those inside
functions included, is read with `ast` and must name none of them. Entry
points default to the GPU and raise without one.
"""

import ast
import os
import pathlib
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import llark_tpu_torch
from llark_tpu_torch.audio import train_annotators
from llark_tpu_torch.audio.neural import neural_annotators
from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.encoders.clap import text
from llark_tpu_torch.evaluation import harness
from llark_tpu_torch.generate import Generator
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models.fusion import init_llark_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "llark_tpu")

_PROBE = r"""
import importlib, importlib.abc, sys
BLOCKED = {blocked!r}

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Blocker())
for mod in {modules!r}:
    importlib.import_module(mod)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len({modules!r}), "modules")
"""


def _port_modules():
    mods = ["llark_tpu_torch"]
    for info in pkgutil.walk_packages(llark_tpu_torch.__path__, "llark_tpu_torch."):
        mods.append(info.name)
    return mods


def test_port_imports_without_jax_or_reference():
    modules = _port_modules() + ["chip_smoke"]
    assert "llark_tpu_torch.ops.decode_attention" in modules
    for new in ("models.quant", "ops.int8_matmul", "ops.int4_matmul", "audio.io", "audio.mel",
                "encoders.extract_cli", "encoders.clap.encode", "encoders.clap.htsat",
                "encoders.clap.import_hf", "encoders.jukebox", "encoders.jukebox.config",
                "encoders.jukebox.conditioner", "encoders.jukebox.vqvae",
                "encoders.jukebox.prior", "encoders.jukebox.import_torch",
                "encoders.jukebox.encode", "interop.from_jax", "native", "native.build",
                "native.tarloader", "audio.dsp", "audio.annotate", "audio.neural",
                "audio.synthbench", "dataset_utils", "dataset_utils.midi", "evaluation",
                "evaluation.utils", "preprocessing", "preprocessing.jsonify",
                "preprocessing.jsonify_cli", "preprocessing.pack_webdataset",
                "preprocessing.pipeline_cli", "preprocessing.wavcaps_filters",
                "audio.train_annotators", "encoders.clap.text", "evaluation.harness",
                "instruct", "instruct.captioning", "instruct.data_validation",
                "instruct.fetch_openai", "instruct.json_utils", "instruct.prompting",
                "instruct.fewshot_examples", "instruct.fewshot_examples.mirqa",
                "instruct.fewshot_examples.reasoning_qa", "keys", "notebook_lib",
                "parallel", "parallel.comm", "parallel.mesh", "parallel.serving",
                "parallel.pipeline", "parallel.ring_attention", "parallel.launch"):
        assert f"llark_tpu_torch.{new}" in modules
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(blocked=BLOCKED, modules=modules)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"imported {len(modules)} modules" in proc.stdout


def _statements(node):
    """Every statement under `node`, nested bodies included (an import is
    a statement, so expressions need no visit)."""
    for field in ("body", "orelse", "finalbody", "handlers", "cases"):
        for child in getattr(node, field, ()):
            yield child
            yield from _statements(child)


def test_no_source_of_the_port_imports_jax_or_reference():
    """Cheap and without a subprocess: every `import` and `from ... import`
    anywhere in the port's sources and chip_smoke.py, read with `ast`."""
    sources = sorted(pathlib.Path(REPO, "llark_tpu_torch").rglob("*.py"))
    sources.append(pathlib.Path(REPO, "chip_smoke.py"))
    assert len(sources) > 100
    found = []
    for path in sources:
        for node in _statements(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [f"{path.relative_to(REPO)}:{node.lineno} {name}" for name in names
                      if name.split(".")[0] in BLOCKED]
    assert not found, found


def test_entry_points_refuse_to_run_on_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    cfg = ModelConfig.tiny(dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_llark_params(cfg)
    params = init_llark_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Generator(cfg, params, audio_patch_id=7)
    assert Generator(cfg, params, audio_patch_id=7, device="cpu").device.type == "cpu"
    tree = {name: ({k: w.numpy() for k, w in leaf.items()} if isinstance(leaf, dict)
                   else leaf.numpy()) for name, leaf in params.items()}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(tree, cfg)
    assert params_from_numpy(tree, cfg, "cpu")["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        neural_annotators()
    assert neural_annotators(device="cpu")[1].device.type == "cpu"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_gpu(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: chip_smoke.py would run for real")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_new_entry_points_refuse_to_run_on_cpu_by_default(tmp_path):
    """The annotator trainer, `harness genre --embedder clap` and
    `make_text_embedder` default to the GPU and raise without one; given
    the CPU they run."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    cfg = text.ClapTextConfig.tiny(num_layers=1)
    ckpt = text.save_clap_text_checkpoint(
        str(tmp_path / "clap"), cfg, text.random_init(cfg, torch.Generator().manual_seed(0)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        text.make_text_embedder(ckpt)
    assert text.make_text_embedder(ckpt, device="cpu")(["a tune"]).shape == (1, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_annotators.main(["--steps-beat", "1", "--out", str(tmp_path / "w.npz")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_annotators.train_key([], [], 1, 1, 1e-3, None)
    (tmp_path / "r.csv").write_text("example_id,prompt,response,model_completion\n1,,,jazz\n")
    (tmp_path / "l.jsonl").write_text('{"example_id": "1", "genre": "jazz"}\n')
    argv = ["genre", "--results", str(tmp_path / "r.csv"), "--labels", str(tmp_path / "l.jsonl"),
            "--label-set", "jazz,rock", "--embedder", "clap", "--clap-checkpoint", ckpt]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.main(argv)
    harness.main(argv + ["--device", "cpu"])


def test_parallel_names_resolve_without_jax():
    """llark_tpu_torch.parallel exports the JAX package's names
    (llark_tpu/parallel/__init__.py), resolved lazily, with JAX blocked."""
    names = ["MeshAxes", "batch_sharding", "make_mesh", "param_partition_specs",
             "param_shardings", "make_pipeline_layers_fn", "make_pp_mesh",
             "make_pp_train_step", "pp_param_specs"]
    code = _PROBE.format(blocked=BLOCKED, modules=["llark_tpu_torch.parallel"]) + (
        "import llark_tpu_torch.parallel as par\n"
        f"assert sorted(par.__all__) == {sorted(names)!r}\n"
        f"assert all(callable(getattr(par, n)) for n in {names!r})\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)\n"
        "assert not leaked, leaked\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
