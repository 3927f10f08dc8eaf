"""The port's checkpoint I/O against the JAX package's, on the CPU.

The same seeded numpy state dicts and parameter trees go through
`llark_tpu.interop.{hf,delta}` and `llark_tpu_torch.interop.{hf,delta}`.
Tolerances, stated per case:
  * exact equality for every import, export, resize and delta in fp32 (and
    for the bf16 casts of an import: both round to nearest even), for the
    safetensors reader against the `safetensors` package, for the
    config.json files and configurations, and for the backbone `train()`
    imports before its first step;
  * atol 2e-4 / rtol 1e-3 for the port's decoder on imported weights
    against `transformers`' own models, as tests/test_interop.py holds
    the JAX package.
"""

import json
import os
import subprocess
import sys

import pkgutil

import numpy as np
import pytest
import torch

from llark_tpu.config import ModelArguments as JModelArguments
from llark_tpu.config import ModelConfig as JaxConfig
from llark_tpu.config import TrainingArguments as JTrainingArguments
from llark_tpu.interop import delta as jdelta
from llark_tpu.interop import hf as jhf
from llark_tpu.train import train as jtrain
import llark_tpu_torch
from llark_tpu_torch.config import DataArguments, ModelArguments, ModelConfig, TrainingArguments
from llark_tpu_torch.data.webdataset import TarShardWriter
from llark_tpu_torch.interop import delta as tdelta
from llark_tpu_torch.interop import hf as thf
from llark_tpu_torch.models import decoder as tdecoder
from llark_tpu_torch.models.utils import load_model_metadata, load_pretrained_model
from llark_tpu_torch.models.utils import save_model_metadata
from llark_tpu_torch.train import train as ttrain

safetensors_torch = pytest.importorskip("safetensors.torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what tests/test_torch_isolation.py blocks, and the two packages the port
# does without
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "llark_tpu", "safetensors",
           "transformers")

# tiny architectures, the same keyword arguments for both packages' configs
ARCHS = {
    "llama": dict(arch="llama", num_kv_heads=4),
    "llama_gqa": dict(arch="llama", num_kv_heads=2),
    "mpt": dict(arch="mpt", intermediate_size=256),
}
BASE = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
            dtype="float32", param_dtype="float32", use_pallas_attention=False, remat=False,
            mm_hidden_size=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **over):
    kw = dict(BASE, **ARCHS[arch], **over)
    return ModelConfig.tiny(**kw), JaxConfig.tiny(**kw)


def _hf_state_dict(arch, seed=0, norm_bias=True):
    """A seeded HF-format numpy state dict of a tiny `arch` model."""
    rng = np.random.RandomState(seed)
    h, L, v = BASE["hidden_size"], BASE["num_layers"], BASE["vocab_size"]

    def w(*shape):
        return rng.randn(*shape).astype(np.float32) * 0.1

    sd = {}
    if ARCHS[arch]["arch"] == "mpt":
        i = ARCHS[arch]["intermediate_size"]
        sd["transformer.wte.weight"] = w(v, h)
        for l in range(L):
            p = f"transformer.blocks.{l}."
            sd[p + "attn.Wqkv.weight"] = w(3 * h, h)
            sd[p + "attn.out_proj.weight"] = w(h, h)
            sd[p + "ffn.up_proj.weight"] = w(i, h)
            sd[p + "ffn.down_proj.weight"] = w(h, i)
            sd[p + "norm_1.weight"] = 1 + w(h)
            sd[p + "norm_2.weight"] = 1 + w(h)
            if norm_bias:
                sd[p + "norm_1.bias"] = w(h)
                sd[p + "norm_2.bias"] = w(h)
        sd["transformer.norm_f.weight"] = 1 + w(h)
        if norm_bias:
            sd["transformer.norm_f.bias"] = w(h)
        return sd
    kv = ARCHS[arch]["num_kv_heads"] * h // BASE["num_heads"]
    i = BASE["intermediate_size"]
    sd["model.embed_tokens.weight"] = w(v, h)
    for l in range(L):
        p = f"model.layers.{l}."
        for name, shape in (("self_attn.q_proj", (h, h)), ("self_attn.k_proj", (kv, h)),
                            ("self_attn.v_proj", (kv, h)), ("self_attn.o_proj", (h, h)),
                            ("mlp.gate_proj", (i, h)), ("mlp.up_proj", (i, h)),
                            ("mlp.down_proj", (h, i))):
            sd[p + name + ".weight"] = w(*shape)
        sd[p + "input_layernorm.weight"] = 1 + w(h)
        sd[p + "post_attention_layernorm.weight"] = 1 + w(h)
    sd["model.norm.weight"] = 1 + w(h)
    sd["lm_head.weight"] = w(v, h)
    return sd


def _torch_sd(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy() if tree.dtype == torch.bfloat16 else tree.numpy()
    return np.asarray(tree.astype(np.float32) if tree.dtype.name == "bfloat16" else tree)


def _assert_trees_equal(got, want):
    got, want = _numpy_tree(got), _numpy_tree(want)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k])
        else:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _params(arch, seed=1, projector=True):
    """A seeded parameter tree (numpy, the shared layout) of a tiny model."""
    tcfg, _ = _cfgs(arch)
    tree = thf.llama_params_from_hf if tcfg.arch == "llama" else thf.mpt_params_from_hf
    params = _numpy_tree(tree(_torch_sd(_hf_state_dict(arch, seed)), tcfg, device="cpu"))
    if projector:
        rng = np.random.RandomState(seed + 100)
        params["mm_projector"] = {"kernel": rng.randn(16, 64).astype(np.float32),
                                  "bias": rng.randn(64).astype(np.float32)}
    return params


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I8": torch.int8, "I32": torch.int32, "I64": torch.int64}


def _st_tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = {"a.weight": (7, 5), "b.bias": (3,), "c.scalar": (), "d.empty": (0, 4),
              "e.odd": (1, 3, 5)}
    out = {}
    for name, shape in shapes.items():
        if dtype.is_floating_point:
            out[name] = torch.randn(shape, generator=g).to(dtype)
        else:
            out[name] = torch.randint(-100, 100, shape, generator=g).to(dtype)
    return out


def _write_st(directory, tensors, sharded):
    os.makedirs(directory, exist_ok=True)
    if not sharded:
        safetensors_torch.save_file(tensors, os.path.join(directory, "model.safetensors"),
                                    metadata={"format": "pt"})
        return
    keys = sorted(tensors)
    parts = {"model-00001-of-00002.safetensors": keys[:2],
             "model-00002-of-00002.safetensors": keys[2:]}
    for fname, names in parts.items():
        safetensors_torch.save_file({k: tensors[k] for k in names},
                                    os.path.join(directory, fname), metadata={"format": "pt"})
    with open(os.path.join(directory, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": {k: fn for fn, ks in parts.items() for k in ks}}, f)


@pytest.mark.parametrize("layout", ["single", "sharded"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_safetensors_reader_matches_the_package(tmp_path, dtype, layout):
    tensors = _st_tensors(DTYPES[dtype])
    _write_st(str(tmp_path), tensors, layout == "sharded")
    got = thf.load_hf_state_dict(str(tmp_path))
    want = {}
    for fname in sorted(os.listdir(tmp_path)):
        if fname.endswith(".safetensors"):
            want.update(safetensors_torch.load_file(str(tmp_path / fname)))
    assert sorted(got) == sorted(want) == sorted(tensors)
    for k, t in want.items():
        assert got[k].dtype == t.dtype == DTYPES[dtype] and got[k].shape == t.shape, k
        assert torch.equal(got[k], t), k
    # the mapped tensors are private copies: writing one leaves the file as it was
    got["a.weight"].zero_()
    again = thf.load_hf_state_dict(str(tmp_path))
    assert torch.equal(again["a.weight"], tensors["a.weight"])


def test_safetensors_reader_takes_unaligned_data_and_refuses_other_dtypes(tmp_path):
    # an odd-length F16 tensor puts the F32 one after it off its alignment
    f16 = torch.arange(3, dtype=torch.float16)
    f32 = torch.linspace(-1, 1, 6).reshape(2, 3)
    path = str(tmp_path / "model.safetensors")
    safetensors_torch.save_file({"a": f16, "b": f32}, path)
    got = thf.read_safetensors(path)
    want = safetensors_torch.load_file(path)
    assert torch.equal(got["a"], want["a"]) and torch.equal(got["b"], want["b"])
    safetensors_torch.save_file({"f8": torch.zeros(4).to(torch.float8_e4m3fn)},
                                str(tmp_path / "f8.safetensors"))
    with pytest.raises(ValueError, match="F8_E4M3"):
        thf.read_safetensors(str(tmp_path / "f8.safetensors"))
    with pytest.raises(FileNotFoundError):
        thf.load_hf_state_dict(str(tmp_path / "nowhere"))


_BLOCKED_PROBE = r"""
import importlib, importlib.abc, sys
BLOCKED = {blocked!r}

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Blocker())
import logging
import torch
for mod in {modules!r}:
    importlib.import_module(mod)
from llark_tpu_torch.config import ModelArguments, ModelConfig, TrainingArguments
from llark_tpu_torch.interop import hf
from llark_tpu_torch.train.train import build_tokenizer
from llark_tpu_torch.tokenization import WordTokenizer

got = hf.load_hf_state_dict({directory!r})
want = torch.load({expected!r}, weights_only=True)
assert sorted(got) == sorted(want)
assert all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want)
cfg = ModelConfig.tiny(**{cfg_kw!r})
params = hf.load_pretrained_backbone({directory!r}, cfg, device="cpu")
assert params["layers"]["wq"].shape == (cfg.num_layers, cfg.hidden_size, cfg.hidden_size)
bundle = build_tokenizer(ModelArguments(model_name_or_path={directory!r}), TrainingArguments())
assert isinstance(bundle.tokenizer, WordTokenizer)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("read", len(got), "tensors")
"""


def test_port_reads_safetensors_without_the_packages(tmp_path):
    # with neither safetensors nor transformers importable, the whole port
    # and chip_smoke.py import, and the same files read the same
    tcfg, _ = _cfgs("llama_gqa")
    hf_dir = tmp_path / "hf"
    tensors = {k: v.to(torch.bfloat16) for k, v in _torch_sd(_hf_state_dict("llama_gqa")).items()}
    _write_st(str(hf_dir), tensors, sharded=True)
    with open(hf_dir / "config.json", "w") as f:
        json.dump(thf.hf_config(tcfg), f)
    torch.save(tensors, tmp_path / "expected.pt")
    cfg_kw = {k: v for k, v in dict(BASE, **ARCHS["llama_gqa"]).items() if k != "arch"}
    modules = ["llark_tpu_torch", "chip_smoke"] + [
        info.name for info in pkgutil.walk_packages(llark_tpu_torch.__path__, "llark_tpu_torch.")]
    assert "llark_tpu_torch.interop.hf" in modules
    probe = _BLOCKED_PROBE.format(
        blocked=BLOCKED, modules=modules, directory=str(hf_dir),
        expected=str(tmp_path / "expected.pt"), cfg_kw=cfg_kw)
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"read {len(tensors)} tensors" in proc.stdout


# ---------------------------------------------------------------------------
# import, export, resize
# ---------------------------------------------------------------------------

IMPORTS = ["llama", "llama_gqa", "mpt", "mpt_no_norm_bias"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", IMPORTS)
def test_import_matches_jax(case, dtype):
    arch = case.replace("_no_norm_bias", "")
    tcfg, jcfg = _cfgs(arch, param_dtype=dtype)
    sd = _hf_state_dict(arch, norm_bias=case == arch)
    jfn, tfn = ((jhf.llama_params_from_hf, thf.llama_params_from_hf) if tcfg.arch == "llama"
                else (jhf.mpt_params_from_hf, thf.mpt_params_from_hf))
    want = jfn(sd, jcfg)
    tsd = _torch_sd(sd)
    got = tfn(tsd, tcfg, device="cpu")
    assert got["embed"].dtype == tdecoder.torch_dtype(dtype)
    assert all(t.is_contiguous() for t in got["layers"].values())
    _assert_trees_equal(got, want)
    assert len(tsd) == len(sd)
    # with consume, the importer empties the dict it was handed
    again = tfn(tsd, tcfg, device="cpu", consume=True)
    assert not tsd
    _assert_trees_equal(again, want)


@pytest.mark.parametrize("arch", ["llama", "llama_gqa", "mpt"])
def test_export_and_config_match_jax(tmp_path, arch):
    tcfg, jcfg = _cfgs(arch)
    params = _params(arch)
    want = jhf.hf_state_dict_from_params(jcfg, params)
    got = thf.hf_state_dict_from_params(tcfg, _torch_sd_tree(params))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    jhf.save_hf_checkpoint(str(tmp_path / "jax"), jcfg, params)
    thf.save_hf_checkpoint(str(tmp_path / "port"), tcfg, _torch_sd_tree(params))
    with open(tmp_path / "jax" / "config.json") as f:
        jconfig = json.load(f)
    with open(tmp_path / "port" / "config.json") as f:
        assert json.load(f) == jconfig


def _torch_sd_tree(tree):
    return {k: _torch_sd_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["llama_gqa", "mpt"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_reads_the_others_export(tmp_path, arch, direction):
    # each package reads the other's export as it reads its own (an MPT
    # export carries no per-layer norm biases in either package: the
    # reference's keys)
    tcfg, jcfg = _cfgs(arch)
    params = _params(arch)
    path = str(tmp_path / "hf")
    if direction == "jax_to_port":
        jhf.save_hf_checkpoint(path, jcfg, params)
    else:
        thf.save_hf_checkpoint(path, tcfg, _torch_sd_tree(params))
    got = thf.load_pretrained_backbone(path, tcfg, device="cpu")
    want = jhf.load_pretrained_backbone(path, jcfg)
    _assert_trees_equal(got, want)
    params.pop("mm_projector")
    if tcfg.arch == "mpt":
        for name in ("attn_norm_bias", "mlp_norm_bias"):
            params["layers"][name] = np.zeros_like(params["layers"][name])
    _assert_trees_equal(got, params)


@pytest.mark.parametrize("case", ["with_head", "tied", "same_size"])
def test_resize_embeddings_matches_jax(case):
    rng = np.random.RandomState(3)
    params = {"embed": rng.randn(37, 8).astype(np.float32)}
    if case != "tied":
        params["lm_head"] = rng.randn(8, 37).astype(np.float32)
    new = 37 if case == "same_size" else 45
    want = jhf.resize_embeddings(params, new)
    got = thf.resize_embeddings(_torch_sd_tree(params), new)
    _assert_trees_equal(got, want)
    with pytest.raises(ValueError, match="shrink"):
        thf.resize_embeddings(_torch_sd_tree(params), 30)


@pytest.mark.parametrize("arch", ["llama_gqa", "mpt"])
def test_load_pretrained_backbone_detects_and_resizes_as_jax(tmp_path, arch):
    # the checkpoint's vocab (96) grows to the config's (160): mean rows
    tcfg, jcfg = _cfgs(arch, vocab_size=160)
    _, small_j = _cfgs(arch)
    params = _params(arch, projector=False)
    jhf.save_hf_checkpoint(str(tmp_path / "hf"), small_j, params)
    want = jhf.load_pretrained_backbone(str(tmp_path / "hf"), jcfg)
    got = thf.load_pretrained_backbone(str(tmp_path / "hf"), tcfg, device="cpu")
    assert tuple(got["embed"].shape) == (160, 64)
    assert ("lm_head" in got) == (tcfg.arch == "llama")
    if tcfg.arch == "llama":
        # the JAX import leaves lm_head a transposed view, whose column mean
        # numpy sums in another order: within fp32 rounding there
        np.testing.assert_allclose(got.pop("lm_head").numpy(), want.pop("lm_head"),
                                   rtol=0, atol=1e-6)
    _assert_trees_equal(got, want)


@pytest.fixture(scope="module", params=["llama_gqa", "mpt"])
def hf_model(request):
    """(arch, a tiny transformers model of it, built offline from a config
    as tests/test_interop.py builds them)."""
    import transformers

    if request.param == "llama_gqa":
        torch.manual_seed(0)
        model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            rms_norm_eps=1e-5, rope_theta=10000.0, attention_bias=False,
            tie_word_embeddings=False))
    else:
        torch.manual_seed(1)
        model = transformers.MptForCausalLM(transformers.MptConfig(
            vocab_size=96, d_model=64, n_heads=4, n_layers=2, expansion_ratio=4,
            max_seq_len=128, layer_norm_epsilon=1e-5))
    model = model.eval().float()
    # the first forward initialises lazily (seconds): here, outside the
    # timed test call
    with torch.no_grad():
        model(torch.zeros((1, 4), dtype=torch.long))
    return request.param, model


def test_decoder_on_imported_weights_matches_transformers(hf_model):
    arch, model = hf_model
    tcfg, _ = _cfgs(arch)
    importer = thf.llama_params_from_hf if tcfg.arch == "llama" else thf.mpt_params_from_hf
    params = importer({k: v.detach() for k, v in model.state_dict().items()}, tcfg,
                      device="cpu")
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 96, size=(2, 12)))
    with torch.no_grad():
        want = model(ids.long()).logits
        got, _ = tdecoder.decoder_forward(tcfg, params, input_ids=ids.int())
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("where", ["import", "backbone", "export", "config"])
def test_mixtral_weights_raise(tmp_path, where):
    tcfg, _ = _cfgs("llama")
    sd = _torch_sd(_hf_state_dict("llama"))
    sd[thf._MOE_KEY] = torch.zeros(4, 64)
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        if where == "import":
            thf.llama_params_from_hf(sd, tcfg, device="cpu")
        elif where == "backbone":
            torch.save(sd, tmp_path / "pytorch_model.bin")
            thf.load_pretrained_backbone(str(tmp_path), tcfg, device="cpu")
        elif where == "export":
            params = thf.llama_params_from_hf(_torch_sd(_hf_state_dict("llama")), tcfg,
                                              device="cpu")
            params["layers"]["moe_router"] = torch.zeros(2, 64, 4)
            thf.hf_state_dict_from_params(tcfg, params)
        else:
            (tmp_path / "config.json").write_text(
                json.dumps({"model_type": "mixtral", "num_local_experts": 8}))
            ttrain.model_config_from_name(str(tmp_path), ModelArguments())


# ---------------------------------------------------------------------------
# weight deltas
# ---------------------------------------------------------------------------


def _delta_sds(case, rng):
    """(base, target) numpy state dicts: equal shapes, a target with a
    resized vocab, or a target with the projector."""
    hidden, vocab = 8, 16
    base = {
        "model.layers.0.self_attn.q_proj.weight": rng.randn(hidden, hidden).astype(np.float32),
        "model.norm.weight": rng.randn(hidden).astype(np.float32),
        "model.embed_tokens.weight": rng.randn(vocab, hidden).astype(np.float32),
        "lm_head.weight": rng.randn(vocab, hidden).astype(np.float32),
    }
    extra = 3 if case in ("resized", "resized_projector") else 0
    target = {k: (rng.randn(v.shape[0] + extra, *v.shape[1:]).astype(np.float32)
                  if k in ("model.embed_tokens.weight", "lm_head.weight")
                  else rng.randn(*v.shape).astype(np.float32)) for k, v in base.items()}
    if "projector" in case:
        target["model.mm_projector.weight"] = rng.randn(hidden, 4).astype(np.float32)
        target["model.mm_projector.bias"] = rng.randn(hidden).astype(np.float32)
    return base, target


DELTA_CASES = ["same_shape", "resized", "projector", "resized_projector"]


@pytest.mark.parametrize("case", DELTA_CASES)
def test_delta_state_matches_jax_and_inverts(case):
    base, target = _delta_sds(case, np.random.RandomState(5))
    want = jdelta.make_delta_state(base, target)
    got = tdelta.make_delta_state(_torch_sd(base), _torch_sd(target))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    back = tdelta.apply_delta_state(_torch_sd(base), got)
    jback = jdelta.apply_delta_state(base, want)
    for k in target:
        np.testing.assert_array_equal(back[k].numpy(), jback[k], err_msg=k)
    # resized rows stay absolute in the delta; the projector passes through
    if "resized" in case:
        np.testing.assert_array_equal(got["lm_head.weight"][16:].numpy(),
                                      target["lm_head.weight"][16:])
    if "projector" in case:
        np.testing.assert_array_equal(got["model.mm_projector.bias"].numpy(),
                                      target["model.mm_projector.bias"])


def test_delta_of_bf16_checkpoints_inverts_exactly():
    base, target = _delta_sds("resized_projector", np.random.RandomState(6))
    tb = {k: v.to(torch.bfloat16) for k, v in _torch_sd(base).items()}
    tt = {k: v.to(torch.bfloat16) for k, v in _torch_sd(target).items()}
    back = tdelta.apply_delta_state(tb, tdelta.make_delta_state(tb, tt))
    for k in tt:
        assert back[k].dtype == torch.float32
        assert torch.equal(back[k], tt[k].float()), k


@pytest.mark.parametrize("fault", ["unknown_key", "shape"])
def test_delta_refuses_what_the_reference_refuses(fault):
    base, target = _delta_sds("same_shape", np.random.RandomState(7))
    if fault == "unknown_key":
        target["model.extra.weight"] = np.zeros(3, np.float32)
        error = KeyError
    else:
        target["model.norm.weight"] = np.zeros(5, np.float32)
        error = ValueError
    for fn in (jdelta.make_delta_state, lambda b, t: tdelta.make_delta_state(
            _torch_sd(b), _torch_sd(t))):
        with pytest.raises(error):
            fn(base, target)


def test_delta_cli_round_trip_and_sidecars(tmp_path):
    base, target = _delta_sds("resized_projector", np.random.RandomState(8))
    for name, sd in (("base", base), ("target", target)):
        os.makedirs(tmp_path / name)
        torch.save(_torch_sd(sd), tmp_path / name / "pytorch_model.bin")
    (tmp_path / "target" / "tokenizer_config.json").write_text("{}")
    tdelta.main(["make", "--base-model-path", str(tmp_path / "base"), "--target-model-path",
                 str(tmp_path / "target"), "--delta-path", str(tmp_path / "delta")])
    assert (tmp_path / "delta" / "tokenizer_config.json").exists()
    # the JAX package's delta tool reads the port's delta, and the other way round
    jdelta.main(["apply", "--base-model-path", str(tmp_path / "base"), "--target-model-path",
                 str(tmp_path / "jax_back"), "--delta-path", str(tmp_path / "delta")])
    tdelta.main(["apply", "--base-model-path", str(tmp_path / "base"), "--target-model-path",
                 str(tmp_path / "back"), "--delta-path", str(tmp_path / "delta")])
    got = thf.load_hf_state_dict(str(tmp_path / "back"))
    jgot = jhf.load_hf_state_dict(str(tmp_path / "jax_back"))
    for k in target:
        np.testing.assert_array_equal(got[k].numpy(), jgot[k], err_msg=k)
        # (target - base) + base: the target up to one fp32 rounding
        np.testing.assert_allclose(got[k].numpy(), target[k], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_consolidate_writes_one_file_and_drops_the_stale_index(tmp_path, fmt):
    sd = _torch_sd(_delta_sds("projector", np.random.RandomState(9))[1])
    src = tmp_path / "sharded"
    if fmt == "safetensors":
        _write_st(str(src), sd, sharded=True)
    else:
        os.makedirs(src)
        keys = sorted(sd)
        parts = {"pytorch_model-00001-of-00002.bin": keys[:3],
                 "pytorch_model-00002-of-00002.bin": keys[3:]}
        for fname, names in parts.items():
            torch.save({k: sd[k] for k in names}, src / fname)
        (src / "pytorch_model.bin.index.json").write_text(json.dumps(
            {"weight_map": {k: fn for fn, ks in parts.items() for k in ks}}))
    (src / "config.json").write_text("{}")
    dst = tmp_path / "single"
    os.makedirs(dst)
    (dst / "model.safetensors.index.json").write_text("{}")  # stale, from an earlier copy
    tdelta.main(["consolidate", "--src", str(src), "--dst", str(dst)])
    assert sorted(os.listdir(dst)) == ["config.json", "pytorch_model.bin"]
    got = jhf.load_hf_state_dict(str(dst))
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# train(): configuration, tokenizer and backbone from an HF directory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["llama_gqa", "mpt", "no_config"])
def test_model_config_from_name_matches_jax(tmp_path, case):
    name = str(tmp_path / "tiny-model")
    os.makedirs(name)
    if case != "no_config":
        _, jcfg = _cfgs(case, max_seq_len=96, rope_theta=5e5, rms_norm_eps=1e-6)
        jhf.save_hf_checkpoint(name, jcfg, _params(case, projector=False))
    got = ttrain.model_config_from_name(name, ModelArguments(mm_hidden_size=24))
    want = jtrain.model_config_from_name(name, JModelArguments(mm_hidden_size=24))
    for field in ModelConfig.__dataclass_fields__:
        assert getattr(got, field) == getattr(want, field), field


def _write_train_shard(directory):
    w = TarShardWriter(os.path.join(directory, "mir-train-%05d.tar"), max_count=10)
    rng = np.random.RandomState(0)
    for i in range(4):
        w.write({"__key__": f"t{i}", "json": {"response": [
            {"question": "genre ?", "answer": "jazz ."}]},
            "audio_encoding.pyd": rng.randn(4, 16).astype(np.float32)})
    w.close()
    return w.written_paths[0]


def _train_first_params(tmp_path, monkeypatch, model_dir, **model_kw):
    """train() for one step from `model_dir`; the parameters the first step
    receives, and the run's result."""
    seen = []
    make = ttrain.make_train_step

    def make_watched(*args, **kw):
        step = make(*args, **kw)

        def watched(state, batch):
            if not seen:
                seen.append({k: ({n: t.detach().clone() for n, t in v.items()}
                                 if isinstance(v, dict) else v.detach().clone())
                             for k, v in state.params.items()})
            return step(state, batch)
        return watched

    monkeypatch.setattr(ttrain, "make_train_step", make_watched)
    shard = _write_train_shard(str(tmp_path))
    result = ttrain.train(
        ModelArguments(model_name_or_path=model_dir, mm_hidden_size=16, **model_kw),
        DataArguments(train_data_path=shard, max_audio_frames=4, task_sample_probs={"mir": 1.0}),
        TrainingArguments(output_dir=str(tmp_path / "out"), per_device_train_batch_size=2,
                          model_max_length=64, max_steps=1, save_steps=100, seed=0),
        device="cpu")
    return seen[0], result


@pytest.mark.parametrize("arch", ["llama_gqa", "mpt"])
def test_train_starts_from_the_hf_backbone(tmp_path, monkeypatch, arch):
    _, jcfg = _cfgs(arch)
    hf_dir = str(tmp_path / "hf")
    jhf.save_hf_checkpoint(hf_dir, jcfg, _params(arch, projector=False))
    first, result = _train_first_params(tmp_path, monkeypatch, hf_dir, freeze_backbone=True,
                                        tune_mm_mlp_adapter=True)
    # the same directory through the JAX package's importer, at fp32
    jcfg_run = jtrain.model_config_from_name(hf_dir, JModelArguments(mm_hidden_size=16))
    want = jhf.load_pretrained_backbone(hf_dir, jcfg_run)
    first.pop("mm_projector")  # each package's own random init
    _assert_trees_equal(first, want)
    assert result["final_step"] == 1 and np.isfinite(result["losses"][0])
    assert result["cfg"].vocab_size == jcfg.vocab_size


def test_train_keeps_random_init_without_hf_weights(tmp_path, monkeypatch, caplog):
    tcfg, _ = _cfgs("llama_gqa")
    hf_dir = tmp_path / "hf"
    os.makedirs(hf_dir)
    (hf_dir / "config.json").write_text(json.dumps(thf.hf_config(tcfg)))
    with caplog.at_level("WARNING", logger="llark_tpu_torch.train"):
        first, _ = _train_first_params(tmp_path, monkeypatch, str(hf_dir))
    assert "no HF weights" in caplog.text
    from llark_tpu_torch.models.fusion import init_llark_params

    run_cfg = ttrain.model_config_from_name(str(hf_dir), ModelArguments(mm_hidden_size=16))
    _assert_trees_equal(first, init_llark_params(run_cfg, seed=0, device="cpu"))


def _write_hf_tokenizer(directory):
    from transformers import BertTokenizer

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "tempo", "is", "slow",
             "what", "?", "###", ":", "human", "assistant", "."]
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    BertTokenizer(os.path.join(directory, "vocab.txt")).save_pretrained(directory)


def test_build_tokenizer_loads_a_local_hf_tokenizer_as_jax_does(tmp_path):
    path = str(tmp_path / "hf")
    _write_hf_tokenizer(path)
    targs = TrainingArguments(model_max_length=64)
    got = ttrain.build_tokenizer(ModelArguments(model_name_or_path=path), targs)
    want = jtrain.build_tokenizer(JModelArguments(model_name_or_path=path),
                                  JTrainingArguments(model_max_length=64))
    assert type(got.tokenizer).__name__ == type(want.tokenizer).__name__ == "BertTokenizer"
    assert len(got.tokenizer) == len(want.tokenizer)
    text = "what is the tempo ? <audio_start><audio_patch><audio_end>"
    assert got.encode(text) == want.encode(text)
    for field in ("audio_patch_id", "audio_start_id", "audio_end_id", "pad_token_id"):
        assert getattr(got, field) == getattr(want, field), field
    # the run directory records it as the JAX package does ("hf", by path)
    run = str(tmp_path / "run")
    tcfg, _ = _cfgs("llama")
    save_model_metadata(run, tcfg, got)
    with open(os.path.join(run, "model_config.json")) as f:
        tok_meta = json.load(f)["tokenizer"]
    assert tok_meta == {"type": "hf", "path": path, "model_max_length": 64}
    cfg, bundle = load_model_metadata(run)
    assert cfg == tcfg and bundle.encode(text) == got.encode(text)


def test_build_tokenizer_needs_tokenizer_files(tmp_path, monkeypatch, caplog):
    # a directory of weights and config.json alone gives the word-level
    # tokenizer: transformers is not asked, since its newer releases build
    # an empty tokenizer from such a directory instead of raising
    import transformers

    _, jcfg = _cfgs("llama")
    jhf.save_hf_checkpoint(str(tmp_path), jcfg, _params("llama", projector=False))

    def refuse(*args, **kw):
        raise AssertionError("AutoTokenizer asked for a directory without tokenizer files")

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", refuse)
    with caplog.at_level("WARNING", logger="llark_tpu_torch.train"):
        bundle = ttrain.build_tokenizer(ModelArguments(model_name_or_path=str(tmp_path)),
                                        TrainingArguments(model_max_length=64))
    assert type(bundle.tokenizer).__name__ == "WordTokenizer"
    assert "no tokenizer files" in caplog.text


def test_load_pretrained_model_points_hf_and_orbax_directories_elsewhere(tmp_path):
    _, jcfg = _cfgs("llama")
    jhf.save_hf_checkpoint(str(tmp_path / "hf"), jcfg, _params("llama", projector=False))
    with pytest.raises(NotImplementedError, match="through train"):
        load_pretrained_model(str(tmp_path / "hf"), device="cpu")
    # a JAX run directory: model_config.json beside Orbax step directories
    from llark_tpu.models.utils import save_model_metadata as jsave_model_metadata
    from llark_tpu.tokenization import TokenizerBundle as JBundle
    from llark_tpu.tokenization import WordTokenizer as JWordTokenizer

    jsave_model_metadata(str(tmp_path / "orbax"), jcfg, JBundle.from_tokenizer(JWordTokenizer(64)))
    os.makedirs(tmp_path / "orbax" / "1")
    with pytest.raises(NotImplementedError, match="Orbax"):
        load_pretrained_model(str(tmp_path / "orbax"), device="cpu")


@pytest.mark.parametrize("where", ["missing", "hf"])
def test_load_pretrained_model_without_model_config_raises_as_the_reference(tmp_path, where):
    # no model_config.json: a path that does not exist, or an HF checkpoint
    # directory written by the JAX package. The reference raises from
    # load_model_metadata's open; the port's error is of that type and
    # still names the route through train().
    from llark_tpu.models.utils import load_pretrained_model as jload_pretrained_model

    directory = str(tmp_path / where)
    if where == "hf":
        _, jcfg = _cfgs("llama")
        jhf.save_hf_checkpoint(directory, jcfg, _params("llama", projector=False))
    with pytest.raises(Exception) as want:
        jload_pretrained_model(directory)
    assert type(want.value) is FileNotFoundError
    with pytest.raises(type(want.value), match="through train") as got:
        load_pretrained_model(directory, device="cpu")
    assert isinstance(got.value, NotImplementedError)


def test_load_pretrained_model_without_checkpoints_raises_as_the_reference(tmp_path):
    # a run stopped before its first save: model_config.json and no
    # checkpoint. Both packages raise FileNotFoundError.
    from llark_tpu.models.utils import load_pretrained_model as jload_pretrained_model
    from llark_tpu.models.utils import save_model_metadata as jsave_model_metadata
    from llark_tpu.tokenization import TokenizerBundle as JBundle
    from llark_tpu.tokenization import WordTokenizer as JWordTokenizer
    from llark_tpu_torch.tokenization import TokenizerBundle, WordTokenizer

    tcfg, jcfg = _cfgs("llama")
    jsave_model_metadata(str(tmp_path / "jax"), jcfg, JBundle.from_tokenizer(JWordTokenizer(64)))
    with pytest.raises(FileNotFoundError) as want:
        jload_pretrained_model(str(tmp_path / "jax"))
    save_model_metadata(str(tmp_path / "torch"), tcfg, TokenizerBundle.from_tokenizer(WordTokenizer(64)))
    with pytest.raises(type(want.value), match="no checkpoints in"):
        load_pretrained_model(str(tmp_path / "torch"), device="cpu")
