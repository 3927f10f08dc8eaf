"""The port's CLAP text tower (llark_tpu_torch/encoders/clap/text.py) on
the CPU, against `transformers`' ClapTextModelWithProjection built offline
from a tiny config (as tests/test_clap_text.py builds it) and against the
JAX package's tower on one numpy tree.

Tolerance: 1e-5 relative to the largest embedding entry, fp32 on both
sides (they read ~1e-7 here: the same products summed in another order).
The JAX side runs once per module, in fixtures.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from llark_tpu.encoders.clap import text as jtext
from llark_tpu_torch.encoders.clap import text as ttext
from llark_tpu_torch.interop.from_jax import clap_text_params_from_numpy

transformers = pytest.importorskip("transformers")

TOL = 1e-5  # relative to max, fp32
TEXTS = ["This piece is a fast bebop jazz tune with saxophone.",
         "A heavy metal track with distorted guitars.", "jazz", "metal",
         "Gentle classical piano sonata in a minor key.", ""]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ragged(vocab, pad_id, seed=3):
    rng = np.random.RandomState(seed)
    ids = np.full((3, 12), pad_id, np.int32)
    for r, n in enumerate((12, 7, 4)):
        ids[r, :n] = rng.randint(2, vocab, size=(n,))
    return ids, (ids != pad_id).astype(np.int64)


@pytest.fixture(scope="module")
def hf_tiny(tmp_path_factory):
    """A tiny ClapTextModelWithProjection, its embeddings of a ragged batch,
    and its checkpoint directory (weights + config.json, no tokenizer)."""
    from transformers import ClapTextConfig as HFTextConfig
    from transformers import ClapTextModelWithProjection

    torch.manual_seed(1)
    hf_cfg = HFTextConfig(
        vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, max_position_embeddings=64, type_vocab_size=1,
        pad_token_id=1, layer_norm_eps=1e-12, projection_dim=32,
        projection_hidden_act="relu", hidden_act="gelu",
        attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0,
    )
    model = ClapTextModelWithProjection(hf_cfg).eval().float()
    ids, mask = _ragged(512, 1)
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask)).text_embeds.numpy()
    ckpt = tmp_path_factory.mktemp("clap_text")
    torch.save(model.state_dict(), ckpt / "pytorch_model.bin")
    with open(ckpt / "config.json", "w") as f:
        json.dump({"text_config": hf_cfg.to_dict(), "projection_dim": 32}, f)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return hf_cfg, sd, ids, mask, ref, str(ckpt)


@pytest.fixture(scope="module")
def jax_tree():
    """One JAX tower tree (numpy leaves) and the JAX tower's embeddings of
    a ragged batch, with and without an explicit mask."""
    cfg = jtext.ClapTextConfig.tiny()
    tree = jax.tree.map(np.asarray, jtext.init_text_params(cfg, jax.random.PRNGKey(0)))
    ids, mask = _ragged(cfg.vocab_size, cfg.pad_token_id, seed=5)
    want = np.asarray(jtext.clap_text_embed(cfg, tree, ids))
    want_masked = np.asarray(jtext.clap_text_embed(cfg, tree, ids, mask))
    return tree, ids, mask, want, want_masked


@pytest.fixture(scope="module")
def jax_embedder(hf_tiny):
    """The JAX package's `make_text_embedder` on the checkpoint (its hashed
    word tokenizer: the directory ships no tokenizer files)."""
    return jtext.make_text_embedder(hf_tiny[5])(TEXTS)


def test_clap_text_matches_transformers(hf_tiny):
    hf_cfg, sd, ids, mask, ref, _ = hf_tiny
    cfg = ttext.text_config_from_hf(hf_cfg)
    assert cfg == ttext.ClapTextConfig.tiny()
    model = ttext.build_text_model(cfg, ttext.text_params_from_hf(sd, cfg), "cpu")
    got = ttext.clap_text_embed(model, ids, mask).numpy()
    assert _rel(got, ref) <= TOL
    # the mask defaults to the non-pad ids
    assert _rel(ttext.clap_text_embed(model, ids).numpy(), ref) <= TOL


def test_clap_text_matches_jax_on_one_tree(jax_tree):
    tree, ids, mask, want, want_masked = jax_tree
    model = clap_text_params_from_numpy(tree, ttext.ClapTextConfig.tiny(), "cpu")
    assert _rel(ttext.clap_text_embed(model, ids).numpy(), want) <= TOL
    assert _rel(ttext.clap_text_embed(model, ids, mask).numpy(), want_masked) <= TOL
    assert torch.equal(ttext.roberta_position_ids(torch.from_numpy(ids), 1),
                       torch.from_numpy(np.array(jtext.roberta_position_ids(ids, 1))).long())
    with pytest.raises(ValueError, match="layers"):
        clap_text_params_from_numpy(tree, ttext.ClapTextConfig.tiny(num_layers=3), "cpu")


def test_clap_text_defaults_are_transformers():
    hf = transformers.ClapTextConfig()
    for k, v in ttext.CLAP_TEXT_DEFAULTS.items():
        assert getattr(hf, k) == v, k
    base = ttext.text_config_from_hf(hf)
    assert base == ttext.ClapTextConfig.base()
    assert dataclass_fields(base) == dataclass_fields(jtext.text_config_from_hf(hf))


def dataclass_fields(cfg) -> dict:
    import dataclasses

    return dataclasses.asdict(cfg)


def test_load_reads_the_checkpoint_as_the_reference(hf_tiny):
    """load_clap_text_encoder with config.json (the defaults filled in for
    what it leaves out) and without one."""
    hf_cfg, sd, ids, mask, ref, ckpt = hf_tiny
    cfg, model = ttext.load_clap_text_encoder(ckpt, device="cpu")
    jcfg, _ = jtext.load_clap_text_encoder(ckpt)
    assert dataclass_fields(cfg) == dataclass_fields(jcfg)
    assert _rel(ttext.clap_text_embed(model, ids, mask).numpy(), ref) <= TOL
    assert not model.training and not any(p.requires_grad for p in model.parameters())


def test_hashed_token_ids_are_the_reference_rule():
    """The fallback tokenizer of both packages: <s>, crc32 of each lowercase
    word mod (vocab - 2) + 2, </s>, padding (tests/test_clap_text.py's
    rebuild of the JAX closure)."""
    import zlib

    max_len, vocab, pad = 8, 512, 1
    want = np.full((len(TEXTS), max_len), pad, np.int32)
    for r, t in enumerate(TEXTS):
        words = str(t).lower().split()[: max_len - 2]
        want[r, 0] = 0
        for c, w in enumerate(words):
            want[r, c + 1] = 2 + (zlib.crc32(w.encode()) % (vocab - 2))
        want[r, len(words) + 1] = 2
    np.testing.assert_array_equal(ttext.hashed_token_ids(TEXTS, max_len, vocab, pad), want)


def test_make_text_embedder_matches_the_reference(hf_tiny, jax_embedder):
    """Same ids (the hashed tokenizer), the same max_len cap (the position
    table of 64 leaves 62), unit rows within TOL of the JAX embedder's."""
    emb = ttext.make_text_embedder(hf_tiny[5], batch_size=4, device="cpu")
    got = emb(TEXTS)
    assert got.shape == jax_embedder.shape == (len(TEXTS), 32)
    assert _rel(got, jax_embedder) <= TOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)
    assert emb.tokenize(["x"]).shape == (1, 62)


def test_hf_directory_roundtrip(tmp_path):
    """random_init -> save_clap_text_checkpoint (safetensors + config.json)
    -> both packages' loaders: the same config and embeddings."""
    cfg = ttext.ClapTextConfig.tiny(num_layers=1)
    state = ttext.random_init(cfg, torch.Generator().manual_seed(0))
    ttext.save_clap_text_checkpoint(str(tmp_path), cfg, state)
    assert sorted(os.listdir(tmp_path)) == ["config.json", "model.safetensors"]
    cfg2, model = ttext.load_clap_text_encoder(str(tmp_path), device="cpu")
    assert cfg2 == cfg
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k
    jcfg, jparams = jtext.load_clap_text_encoder(str(tmp_path))
    assert dataclass_fields(jcfg) == dataclass_fields(cfg)
    ids, _ = _ragged(cfg.vocab_size, cfg.pad_token_id)
    want = jtext.clap_text_embed(jcfg, jparams, ids)
    assert _rel(ttext.clap_text_embed(model, ids).numpy(), want) <= TOL
