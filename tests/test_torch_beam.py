"""The port's beam search against the JAX package's, fp32 on the CPU.

Both packages run the same weights (a seeded init as numpy arrays in the
JAX layout, handed to JAX as they are and to the port through
`params_from_numpy`). With one beam the port's tokens must EQUAL the JAX
`Generator`'s greedy tokens; with three, every beam's tokens must EQUAL
the JAX `BeamSearcher`'s and its score agree to 1e-5, with a
full-precision or an int8 cache. The JAX sides run once per case in a
module fixture. On the CPU the flash-decode wrapper runs its plain
version; the configs turn `use_flash_decode` on, as on the card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu import generate as jgen
from llark_tpu.config import ModelConfig as JaxConfig
from llark_tpu.inference import beam as jbeam
from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.inference import beam as tbeam
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models.fusion import init_llark_params

PATCH_ID = 7
MAX_NEW = 8
CONFIGS = {"llama_gqa": dict(arch="llama", num_kv_heads=2), "mpt": dict(arch="mpt")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(name, int8=False):
    over = dict(CONFIGS[name])
    arch = over.pop("arch")
    over.update(dtype="float32", param_dtype="float32", use_flash_decode=True,
                kv_cache_quant=int8)
    tcfg = ModelConfig.tiny(arch, **over)
    jcfg = JaxConfig.tiny(arch, **over)
    tree = jax.tree.map(lambda t: t.numpy(),
                        init_llark_params(dataclasses.replace(tcfg, kv_cache_quant=False),
                                          seed=0, device="cpu"))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tree, tcfg, "cpu")


def _batch(mm):
    rng = np.random.RandomState(0)
    ids = np.array([[9, 1, PATCH_ID, PATCH_ID, PATCH_ID, 4, 5, 0],
                    [9, PATCH_ID, PATCH_ID, PATCH_ID, 11, 0, 0, 0]], np.int32)
    return (ids, np.array([7, 5], np.int32), rng.randn(2, 3, mm).astype(np.float32),
            np.array([3, 3], np.int32))


def _beam_cfg(module, k, **kw):
    return module.BeamSearchConfig(num_beams=k, max_new_tokens=MAX_NEW, stop_text="", **kw)


@functools.lru_cache(maxsize=None)
def _jax_beams(name, k, int8=False, eos=None):
    jcfg, jparams, tcfg, _ = _setup(name, int8)
    if k == 1:  # plain greedy decode
        gen = jgen.Generator(jcfg, jparams, PATCH_ID,
                             jgen.GenerationConfig(max_new_tokens=MAX_NEW, stop_text="",
                                                   decode_chunk=MAX_NEW - 1), max_cache_len=32)
        return [list(map(int, t)) for t in gen.generate(*_batch(tcfg.mm_hidden_size))]
    searcher = jbeam.BeamSearcher(jcfg, jparams, PATCH_ID, _beam_cfg(jbeam, k, eos_token_id=eos),
                                  max_cache_len=32)
    return searcher.generate(*_batch(tcfg.mm_hidden_size), return_all_beams=True)


@pytest.fixture(scope="module", params=list(CONFIGS))
def oracle(request):
    name = request.param
    return name, {"greedy": _jax_beams(name, 1), "k3": _jax_beams(name, 3),
                  "k3_int8": _jax_beams(name, 3, True)}


def _port(name, k, int8=False, **kw):
    _, _, tcfg, tparams = _setup(name, int8)
    return tbeam.BeamSearcher(tcfg, tparams, PATCH_ID, _beam_cfg(tbeam, k, **kw),
                              max_cache_len=32, device="cpu")


def _check_beams(got, want):
    assert [[seq for seq, _ in row] for row in got] == [[seq for seq, _ in row] for row in want]
    np.testing.assert_allclose([[sc for _, sc in row] for row in got],
                               [[sc for _, sc in row] for row in want], rtol=1e-5, atol=0)


def test_one_beam_is_greedy_decode(oracle):
    name, refs = oracle
    got = _port(name, 1).generate(*_batch(_setup(name)[2].mm_hidden_size))
    assert got == refs["greedy"]


@pytest.mark.parametrize("int8", [False, True], ids=["fp32_cache", "int8_cache"])
def test_three_beams_match_jax(oracle, int8):
    name, refs = oracle
    got = _port(name, 3, int8).generate(*_batch(_setup(name)[2].mm_hidden_size),
                                        return_all_beams=True)
    _check_beams(got, refs["k3_int8" if int8 else "k3"])
    # the best beam is what generate() returns by default
    best = _port(name, 3, int8).generate(*_batch(_setup(name)[2].mm_hidden_size))
    assert best == [row[0][0] for row in got]


@pytest.fixture(scope="module")
def eos_oracle():
    # a token the JAX beams emit mid-sequence, as a fake EOS: beams that
    # reach it finish there (llama_gqa, 3 beams)
    want = _jax_beams("llama_gqa", 3)
    eos = want[0][0][0][2]
    return eos, _jax_beams("llama_gqa", 3, False, eos)


def test_eos_trims_and_freezes_beams(eos_oracle):
    eos, want = eos_oracle
    got = _port("llama_gqa", 3, eos_token_id=eos).generate(
        *_batch(_setup("llama_gqa")[2].mm_hidden_size), return_all_beams=True)
    _check_beams(got, want)
    assert all(eos not in seq for row in got for seq, _ in row)
    assert any(len(seq) < MAX_NEW for row in got for seq, _ in row)


class _Words:
    """Decodes `stop` as the stop keyword and every other token as a word."""

    eos_token_id = None

    def __init__(self, stop):
        self.stop = stop

    def decode(self, toks):
        return " ".join("###" if t == self.stop else "w" for t in toks)


@pytest.fixture(scope="module")
def penalty_oracle():
    # one JAX searcher (mpt, 2 beams); its second run divides the scores by
    # length and trims a stop keyword: both host-side, no new program
    jcfg, jparams, tcfg, _ = _setup("mpt")
    searcher = jbeam.BeamSearcher(jcfg, jparams, PATCH_ID, _beam_cfg(jbeam, 2), max_cache_len=32)
    base = searcher.generate(*_batch(tcfg.mm_hidden_size), return_all_beams=True)
    stop = base[0][0][0][4]
    searcher.beam_cfg = _beam_cfg(jbeam, 2, length_penalty=1.0)
    searcher.beam_cfg.stop_text = "###"
    return stop, searcher.generate(*_batch(tcfg.mm_hidden_size), tokenizer=_Words(stop),
                                   return_all_beams=True)


def test_length_penalty_and_stop_text_match_jax(penalty_oracle):
    stop, want = penalty_oracle
    searcher = _port("mpt", 2, length_penalty=1.0)
    searcher.beam_cfg.stop_text = "###"
    got = searcher.generate(*_batch(_setup("mpt")[2].mm_hidden_size), tokenizer=_Words(stop),
                            return_all_beams=True)
    _check_beams(got, want)
    assert any(len(seq) < MAX_NEW for row in got for seq, _ in row)


def test_top_k_orders_ties_as_jax():
    rng = np.random.RandomState(2)
    x = np.round(rng.randn(3, 40), 1).astype(np.float32)  # many exact ties
    x[1, :] = -1e30  # a dead beam's frozen row
    x[2, 5] = x[2, 30] = 9.0
    for k in (1, 3, 7):
        values, idx = tbeam._top_k(torch.from_numpy(x), k)
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(values.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))


def test_gather_beams_keeps_int8_cache_leaves_as_jax():
    # the beam reorder gathers every cache leaf by parent along the row
    # axis, the int8 scales too (tests/test_kv_quant.py holds JAX's)
    rng = np.random.RandomState(4)
    cache = {"k": rng.randint(-127, 128, (2, 6, 2, 5, 4)).astype(np.int8),
             "v": rng.randint(-127, 128, (2, 6, 2, 5, 4)).astype(np.int8),
             "k_scale": rng.rand(2, 6, 2, 5).astype(np.float32),
             "v_scale": rng.rand(2, 6, 2, 5).astype(np.float32)}
    gidx = np.array([2, 2, 0, 5, 3, 3])
    got = tbeam.gather_beams(dict({k: torch.from_numpy(v) for k, v in cache.items()}, index=3),
                             torch.from_numpy(gidx))
    assert got["index"] == 3
    for key, leaf in cache.items():
        assert got[key].dtype == torch.from_numpy(leaf).dtype
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(jnp.take(jnp.asarray(leaf), gidx, axis=1)))


def test_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    _, _, tcfg, tparams = _setup("mpt")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbeam.BeamSearcher(tcfg, tparams, PATCH_ID)
    assert _port("mpt", 2).device.type == "cpu"


@pytest.mark.parametrize("flags", [
    ["--num-beams", "2", "--continuous-batching", "2"],
    ["--num-beams", "2", "--speculative", "ngram"],
    ["--num-beams", "2", "--temperature", "0.7"],
    ["--speculative", "draft", "--continuous-batching", "2"],
    ["--num-beams", "3", "--speculative", "off"],
], ids=["beams_batching", "beams_speculation", "beams_temperature", "draft_without_dir",
        "beams_alone"])
def test_serving_args_refuse_as_jax(flags):
    # the CLIs' flag checks: beams refuse continuous batching, speculation
    # and temperature; a draft needs its checkpoint; the same messages
    import argparse

    from llark_tpu.inference import common as jcommon
    from llark_tpu_torch.inference import common as tcommon

    outcomes = []
    for common in (jcommon, tcommon):
        p = argparse.ArgumentParser()
        common.add_generation_args(p)
        p.add_argument("--continuous-batching", type=int, default=0)
        args = p.parse_args(flags)
        try:
            common.check_serving_args(args)
            outcomes.append(None)
        except SystemExit as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1] is None) == (flags[1] in ("3",))
