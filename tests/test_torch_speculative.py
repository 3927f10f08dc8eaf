"""The port's speculative decoding against the JAX package, fp32 on the
CPU.

Both packages run the same weights: a seeded init as numpy arrays in the
JAX layout, handed to JAX as they are and to the port through
`params_from_numpy`. Speculative greedy tokens (n-gram, the target as its
own draft, a draft with other weights) must EQUAL the JAX `Generator`'s
plain greedy tokens, computed once per config in a module fixture: both
sides compute in fp32, far below the gaps between the tiny models' top
logits. The host-side drafting (`ngram_propose`, the acceptance replay)
is held equal to JAX's; one JAX `SpeculativeGenerator` run, in a module
fixture, is the acceptance oracle of a draft with other weights.

On the CPU the kernel wrappers run their plain versions; the configs turn
`use_flash_decode` on, so every verify window and draft step takes the
flash-decode route as on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llark_tpu import generate as jgen
from llark_tpu.config import ModelConfig as JaxConfig
from llark_tpu.inference import speculative as jspec
from llark_tpu_torch import generate as tgen
from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.inference import speculative as tspec
from llark_tpu_torch.interop.from_jax import params_from_numpy
from llark_tpu_torch.models.fusion import init_llark_params

PATCH_ID = 7
MAX_NEW = 12
CONFIGS = {"llama_gqa": dict(arch="llama", num_kv_heads=2), "mpt": dict(arch="mpt")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(jcfg, jparams, tcfg, tparams, tdraft) of one config: target weights
    from seed 0, the port's draft with other weights from seed 9."""
    over = dict(CONFIGS[name])
    arch = over.pop("arch")
    over.update(dtype="float32", param_dtype="float32", use_flash_decode=True)
    tcfg = ModelConfig.tiny(arch, **over)
    jcfg = JaxConfig.tiny(arch, **over)
    tree = jax.tree.map(lambda t: t.numpy(), init_llark_params(tcfg, seed=0, device="cpu"))
    draft = jax.tree.map(lambda t: t.numpy(), init_llark_params(tcfg, seed=9, device="cpu"))
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tree, tcfg, "cpu"),
            draft)


def _batch(mm, seed=0):
    rng = np.random.RandomState(seed)
    ids = np.array([[9, 1, PATCH_ID, PATCH_ID, PATCH_ID, 4, 5, 0],
                    [9, PATCH_ID, PATCH_ID, PATCH_ID, 11, 0, 0, 0]], np.int32)
    lengths = np.array([7, 5], np.int32)
    return ids, lengths, rng.randn(2, 3, mm).astype(np.float32), np.array([3, 3], np.int32)


def _gen_cfg(module, **kw):
    return module.GenerationConfig(**dict(dict(max_new_tokens=MAX_NEW, stop_text="",
                                               decode_chunk=MAX_NEW - 1), **kw))


@functools.lru_cache(maxsize=None)
def _jax_greedy(name):
    """The JAX Generator's plain greedy tokens for _batch."""
    jcfg, jparams, tcfg, _, _ = _setup(name)
    gen = jgen.Generator(jcfg, jparams, PATCH_ID, _gen_cfg(jgen), max_cache_len=64)
    return [list(map(int, t)) for t in gen.generate(*_batch(tcfg.mm_hidden_size))]


@pytest.fixture(scope="module", params=list(CONFIGS))
def oracle(request):
    name = request.param
    return name, _jax_greedy(name)


def _port(name, draft=None, **kw):
    """The port's SpeculativeGenerator: `draft` None (n-gram), "self" (the
    target's own tensors) or "other" (seed-9 weights)."""
    _, _, tcfg, tparams, dtree = _setup(name)
    if draft == "self":
        kw.update(draft_cfg=tcfg, draft_params=tparams)
    elif draft == "other":
        kw.update(draft_cfg=tcfg, draft_params=params_from_numpy(dtree, tcfg, "cpu"))
    kw.setdefault("gen_cfg", _gen_cfg(tgen))
    return tspec.SpeculativeGenerator(tcfg, tparams, PATCH_ID, max_cache_len=64, device="cpu",
                                      **kw)


HISTORIES = [
    [0, 4, 5, 6, 7, 8, 4, 5],
    [1, 2, 3],
    [4, 5, 9, 4, 5],
    [7],
    list(np.random.RandomState(1).randint(0, 6, 40)),
    [3, 1, 4, 1, 5, 9] * 4,
]


@pytest.mark.parametrize("gamma,max_k", [(1, 3), (3, 3), (4, 1), (5, 2)])
def test_ngram_propose_and_replay_match_jax(gamma, max_k):
    for h in HISTORIES:
        assert tspec.ngram_propose(h, gamma, max_k) == jspec.ngram_propose(h, gamma, max_k)
    rng = np.random.RandomState(gamma)
    for seq, plen in ((HISTORIES[-1] * 3, 6), (list(rng.randint(0, 5, 80)), 10),
                      (list(rng.randint(0, 1000, 60)), 20)):
        assert tspec.simulate_ngram_acceptance(seq, plen, gamma, max_k) == \
            jspec.simulate_ngram_acceptance(seq, plen, gamma, max_k)


@pytest.mark.parametrize("draft", [None, "self", "other"], ids=["ngram", "self_draft", "draft"])
def test_speculative_tokens_match_jax_greedy(oracle, draft):
    name, want = oracle
    _, _, tcfg, _, _ = _setup(name)
    for gamma in ((1, 3, 5) if draft is None else (4,)):
        spec = _port(name, draft, gamma=gamma)
        assert spec.generate(*_batch(tcfg.mm_hidden_size)) == want, gamma
        assert 0.0 <= spec.last_acceptance_rate <= 1.0
    if draft == "self":
        # every proposal of the target's own greedy draft is accepted: 1 token
        # from prefill, then two whole rounds of gamma + 1 = 5
        spec = _port(name, draft, gamma=4, gen_cfg=_gen_cfg(tgen, max_new_tokens=11))
        assert spec.generate(*_batch(tcfg.mm_hidden_size)) == [row[:11] for row in want]
        assert spec.last_acceptance_rate == 1.0


def test_fused_rounds_match_the_host_loop(oracle):
    name, want = oracle
    _, _, tcfg, _, _ = _setup(name)
    outs, rates = [], []
    for fused in (0, 3):
        spec = _port(name, "other", gamma=3, fused_rounds=fused)
        outs.append(spec.generate(*_batch(tcfg.mm_hidden_size)))
        rates.append(spec.last_acceptance_rate)
    assert outs[0] == outs[1] == want
    assert rates[0] == rates[1]


@pytest.fixture(scope="module")
def jax_draft_acceptance():
    """The JAX SpeculativeGenerator with the seed-9 draft (llama_gqa): its
    tokens and acceptance rate. The one JAX speculative program here."""
    jcfg, jparams, tcfg, _, dtree = _setup("llama_gqa")
    spec = jspec.SpeculativeGenerator(
        jcfg, jparams, PATCH_ID, _gen_cfg(jgen), max_cache_len=64, draft_cfg=jcfg,
        draft_params=jax.tree.map(jnp.asarray, dtree), gamma=3, fused_rounds=3)
    out = spec.generate(*_batch(tcfg.mm_hidden_size))
    return out, spec.last_acceptance_rate


def test_draft_acceptance_matches_jax(jax_draft_acceptance):
    want, rate = jax_draft_acceptance
    spec = _port("llama_gqa", "other", gamma=3, fused_rounds=3)
    _, _, tcfg, _, _ = _setup("llama_gqa")
    assert spec.generate(*_batch(tcfg.mm_hidden_size)) == want
    assert spec.last_acceptance_rate == rate


def replayed_acceptance(replay, prompts, rows, gamma):
    """The acceptance rate a speculative generator reports for `rows`
    (emitted tokens cut by the token budget, not by EOS), from `replay`
    (`simulate_ngram_acceptance`) over each prompt + row. Both count the
    proposals that match the emitted stream, except in a final round that
    matched every token left in the budget: the generator credits a round
    with the tokens it emitted less the one the target emits anyway, the
    replay with every match. Masking the last emitted token (-1 matches no
    proposal) makes the replay's final round stop one short there and
    changes no other round, since no round's proposals read it."""
    accepted = proposed = 0
    for prompt, row in zip(prompts, rows):
        seq = list(map(int, prompt)) + list(row[:-1]) + [-1]
        rate, rounds = replay(seq, len(prompt), gamma)
        accepted += round(rate * rounds * gamma)
        proposed += rounds * gamma
    return accepted / proposed


def test_ngram_acceptance_matches_the_jax_replay(oracle):
    name, want = oracle
    _, _, tcfg, _, _ = _setup(name)
    ids, lengths, audio, counts = _batch(tcfg.mm_hidden_size)
    for gamma in (1, 3, 5):
        spec = _port(name, None, gamma=gamma)
        assert spec.generate(ids, lengths, audio, counts) == want
        prompts = [ids[i, : lengths[i]] for i in range(len(want))]
        assert spec.last_acceptance_rate == replayed_acceptance(
            jspec.simulate_ngram_acceptance, prompts, want, gamma)


@pytest.mark.parametrize("draft", [None, "other"], ids=["ngram", "draft"])
def test_speculative_eos_stop(oracle, draft):
    name, want = oracle
    _, _, tcfg, _, _ = _setup(name)
    eos = want[0][3]  # row 0's 4th token as a fake EOS: generation cuts there
    spec = _port(name, draft, gamma=4, gen_cfg=_gen_cfg(tgen, eos_token_id=eos))
    out = spec.generate(*_batch(tcfg.mm_hidden_size))
    for row, full in zip(out, want):
        assert row == full[: full.index(eos) if eos in full else len(full)]


LEN1_BATCH = (np.array([[9, 0, 0, 0], [9, 4, 5, 11]], np.int32), np.array([1, 4], np.int32))


@pytest.fixture(scope="module")
def len1_reference():
    jcfg, jparams, _, _, _ = _setup("llama_gqa")
    gen = jgen.Generator(jcfg, jparams, PATCH_ID,
                         _gen_cfg(jgen, max_new_tokens=8, decode_chunk=7), max_cache_len=64)
    return [list(map(int, t)) for t in gen.generate(*LEN1_BATCH)]


def test_draft_survives_a_length_1_history_row(len1_reference):
    # a 1-token prompt whose first token is EOS leaves a length-1 history;
    # the draft's [prev, last] must not break on the ragged batch
    ids, lengths = LEN1_BATCH
    ref = len1_reference
    eos = int(ref[0][0])
    spec = _port("llama_gqa", "self", gamma=3,
                 gen_cfg=_gen_cfg(tgen, max_new_tokens=8, eos_token_id=eos))
    out = spec.generate(ids, lengths)
    assert out[0] == []
    assert out[1] == (ref[1][: ref[1].index(eos)] if eos in ref[1] else list(ref[1]))


def test_sampled_speculation_runs():
    spec = _port("mpt", None, gamma=3, gen_cfg=_gen_cfg(tgen, temperature=1.0, max_new_tokens=8))
    rng = torch.Generator().manual_seed(3)
    out = spec.generate(*_batch(_setup("mpt")[2].mm_hidden_size), rng=rng)
    assert all(len(row) == 8 for row in out)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_check_spec_dtype_refuses_as_jax(dtype):
    tcfg, jcfg = ModelConfig.tiny(dtype=dtype), JaxConfig.tiny(dtype=dtype)
    for allow in (False, True):
        if dtype == "bfloat16" and not allow:
            with pytest.raises(ValueError, match="allow-divergent-spec"):
                jspec.check_spec_dtype(jcfg, allow)
            with pytest.raises(ValueError, match="allow-divergent-spec"):
                tspec.check_spec_dtype(tcfg, allow)
        else:
            jspec.check_spec_dtype(jcfg, allow)
            tspec.check_spec_dtype(tcfg, allow)


@pytest.mark.parametrize("cache_mode", ["dense", "paged", "paged_int8"])
def test_rejected_window_writes_are_never_attended(cache_mode):
    # the contract speculation rests on, in the port's in-place caches: a
    # verify window over [last, d_1..d_4] at pos gives the logits of five
    # single-token steps; the next window at pos + 2 (one proposal
    # accepted) overwrites the rejected positions before any query attends
    # them, so it gives the logits of steps that never saw d_2..d_4. Row 1's
    # windows cross an 8-position block boundary in the paged modes. fp32:
    # within 1e-5 relative to max (summation order alone; the int8 cache
    # quantizes each position alike in both)
    import dataclasses

    from llark_tpu_torch.models.decoder import (_quantize_kv, decoder_forward, init_kv_cache,
                                                init_paged_kv_cache)

    _, _, tcfg, tparams, _ = _setup("llama_gqa")
    cfg = dataclasses.replace(tcfg, kv_cache_quant=cache_mode == "paged_int8")
    rng = np.random.RandomState(5)
    if cache_mode == "dense":
        cache = init_kv_cache(cfg, 3, 48)
    else:
        cache = init_paged_kv_cache(cfg, 3, 3 + 18, 8, 6)
        cache["block_tables"] = torch.from_numpy(
            rng.permutation(np.arange(3, 21)).reshape(3, 6).astype(np.int32))
    for name in ("k", "v"):
        x = torch.from_numpy(rng.randn(*cache[name].shape).astype(np.float32))
        if cfg.kv_cache_quant:
            cache[name], cache[name + "_scale"] = _quantize_kv(x)
        else:
            cache[name] = x
    first = torch.from_numpy(rng.randint(4, 200, (3, 5)))
    second = torch.from_numpy(rng.randint(4, 200, (3, 5)))
    pos = torch.tensor([3, 6, 20], dtype=torch.int32)
    windows = {k: v.clone() if torch.is_tensor(v) else v for k, v in cache.items()}
    steps = {k: v.clone() if torch.is_tensor(v) else v for k, v in cache.items()}
    with torch.inference_mode():
        w1 = decoder_forward(cfg, tparams, input_ids=first, kv_cache=windows,
                             cache_positions=pos)[0]
        w2 = decoder_forward(cfg, tparams, input_ids=second, kv_cache=windows,
                             cache_positions=pos + 2)[0]
        s1 = [tgen.decode_step(cfg, tparams, first[:, j], steps, pos + j)[0] for j in range(5)]
        s2 = [tgen.decode_step(cfg, tparams, second[:, j], steps, pos + 2 + j)[0]
              for j in range(5)]
    for window, seq in ((w1, s1), (w2, s2)):
        want = torch.stack(seq, dim=1)
        assert float((window - want).abs().max() / want.abs().max()) <= 1e-5


def test_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    _, _, tcfg, tparams, _ = _setup("llama_gqa")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tspec.SpeculativeGenerator(tcfg, tparams, PATCH_ID)
    assert _port("llama_gqa").device.type == "cpu"
