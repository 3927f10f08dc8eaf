"""The port stands alone: no JAX, no llark_tpu, and no quiet CPU fallback.

Every module of llark_tpu_torch, and chip_smoke.py, is imported in a fresh
interpreter whose import system refuses jax, flax, optax, orbax, chex and
llark_tpu. Entry points default to the GPU and raise without one.
"""

import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import llark_tpu_torch
from llark_tpu_torch.config import ModelConfig
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
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(blocked=BLOCKED, modules=modules)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"imported {len(modules)} modules" in proc.stdout


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
