"""The port's ring attention against the JAX package's, fp32 on the CPU:
the sequence split over the "tensor" axis of 2 or 4 ranks, with ragged
lengths, ALiBi and without the causal mask.

The port runs in a world of 4 gloo ranks (`parallel/launch.py` LocalWorld,
one module-scoped world); the JAX side runs its ring attention on 4 of the
8 virtual CPU devices and its plain attention on one. Both get the same
numpy q/k/v. Tolerance: atol 2e-5, as the JAX package's tests hold its
ring (tests/test_ring_attention.py). The worker functions import no JAX:
the ranks import this module by name.
"""

import functools
import types

import numpy as np
import pytest
import torch

from llark_tpu_torch.ops.attention import alibi_slopes
from llark_tpu_torch.parallel import mesh as tmesh
from llark_tpu_torch.parallel.launch import LocalWorld
from llark_tpu_torch.parallel.ring_attention import ring_attention

WORLD = 4
ATOL = 2e-5


@functools.lru_cache(maxsize=None)
def _jax():
    import jax
    import jax.numpy as jnp

    from llark_tpu.ops import attention as jattention
    from llark_tpu.parallel import mesh as jmesh
    from llark_tpu.parallel import ring_attention as jring

    return types.SimpleNamespace(**locals())


@pytest.fixture(scope="module")
def world():
    with LocalWorld(WORLD) as w:
        yield w


def _qkv(b=3, h=4, s=32, d=8, seed=1):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))


CASES = {
    "causal": dict(causal=True, lengths=None, alibi=False),
    "ragged_alibi": dict(causal=True, lengths=(32, 17, 5), alibi=True),
    "non_causal": dict(causal=False, lengths=None, alibi=False),
    "non_causal_ragged": dict(causal=False, lengths=(32, 9, 1), alibi=True),
}


def _w_ring(axis, qkv, case):
    # the ring runs over "tensor"; "data" holds the ranks' other copies
    mesh = tmesh.make_mesh((WORLD // axis, 1, axis), device="cpu")
    c = CASES[case]
    out = ring_attention(*(torch.from_numpy(x) for x in qkv), mesh, "tensor",
                         causal=c["causal"],
                         kv_lengths=None if c["lengths"] is None else torch.tensor(c["lengths"]),
                         slopes=alibi_slopes(qkv[0].shape[1]) if c["alibi"] else None)
    return out.numpy()


def _jax_ref(axis, qkv, case):
    J = _jax()
    c = CASES[case]
    q, k, v = (J.jnp.asarray(x) for x in qkv)
    kw = dict(causal=c["causal"],
              kv_lengths=None if c["lengths"] is None else J.jnp.asarray(c["lengths"], J.jnp.int32),
              slopes=J.jattention.alibi_slopes(q.shape[1]) if c["alibi"] else None)
    mesh = J.jmesh.make_mesh((1, WORLD // axis, axis), devices=J.jax.devices()[:WORLD])
    plain = J.jax.jit(lambda q, k, v: J.jattention.xla_attention(q, k, v, **kw))
    ring = J.jax.jit(lambda q, k, v: J.jring.ring_attention(q, k, v, mesh, axis="tensor", **kw))
    return np.asarray(plain(q, k, v)), np.asarray(ring(q, k, v))


@pytest.mark.parametrize("axis", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_ring_matches_jax(world, axis, case):
    qkv = _qkv()
    outs = world.run(_w_ring, axis, qkv, case)
    plain, ring = _jax_ref(axis, qkv, case)
    for got in outs:  # every rank gets the whole sequence back
        np.testing.assert_allclose(got, plain, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got, ring, atol=ATOL, rtol=0)


def _w_indivisible():
    mesh = tmesh.make_mesh((1, 1, WORLD), device="cpu")
    q = torch.zeros(1, 1, 6, 4)
    try:
        ring_attention(q, q, q, mesh, "tensor")
    except ValueError as e:
        return str(e)
    return None


def test_ring_rejects_an_indivisible_sequence(world):
    assert world.run(_w_indivisible) == ["sequence 6 must divide axis size 4"] * WORLD
