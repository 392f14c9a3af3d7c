"""The port's flat policy steps against ``repro.cache.flat.FLAT_STEPS``.

The JAX steps replay N requests per lane; the state is carried across with
``repro_torch.convert.flat_state_from_numpy`` and both sides replay M more.
States, hits, evicted keys and op vectors must be bit-identical, on every
policy, with pad > capacity and capacities that are not a tile multiple.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.cache import flat as jflat
from repro_torch.cache import flat as tflat
from repro_torch.convert import flat_state_from_numpy

KEY_SPACE = 48
PAD = 20
N = 200  # requests before the hand-over, and again after it

PARAMS = {
    "lru": {},
    "fifo": {},
    "prob_lru": {"q": 0.5},
    "clock": {"max_scan": 3},
    "slru": {"protected_frac": 0.5},
    "s3fifo": {"small_frac": 0.25, "max_scan": 3},
    "sieve": {},
}
CAPS = (2, 7, 13, 20)


@functools.partial(jax.jit, static_argnames="policy")
def _jax_replay(policy, state, pvecs, qs, keys, us):
    step = jflat.FLAT_STEPS[policy]

    def lane(st, p, q, k, u):
        def body(st, x):
            st, hit, ev, ops = step(st, x[0], x[1], p, q)
            return st, (hit, ev, ops)

        return lax.scan(body, st, (k, u))

    return jax.vmap(lane)(state, pvecs, qs, keys, us)


def _torch_replay(policy, st, pvecs, qs, keys, us):
    step = tflat.FLAT_STEPS[policy]
    outs = []
    for t in range(keys.shape[1]):
        outs.append(step(st, keys[:, t], us[:, t], pvecs, qs))
    hits, ev, ops = (torch.stack(x, dim=1).numpy() for x in zip(*outs))
    return hits, ev, ops


def _stream(seed, lanes, n):
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, KEY_SPACE + 1)
    probs = ranks ** -0.99 / np.sum(ranks ** -0.99)
    keys = rng.choice(KEY_SPACE, size=(lanes, n), p=probs).astype(np.int32)
    us = rng.random((lanes, n), dtype=np.float32)
    return keys, us


def _assert_state_equal(tstate, jstate):
    for f in tflat.FlatState._fields:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)),
                                      err_msg=f)


@pytest.mark.parametrize("policy", sorted(PARAMS))
def test_steps_bit_identical_across_handover(policy):
    params = [jflat.flat_lane_params(policy, c, **PARAMS[policy]) for c in CAPS]
    tparams = [tflat.flat_lane_params(policy, c, **PARAMS[policy]) for c in CAPS]
    for (jv, jq), (tv, tq) in zip(params, tparams):
        np.testing.assert_array_equal(jv, tv)
        assert jq == tq
    pvecs = np.stack([v for v, _ in params])
    qs = np.asarray([q for _, q in params], np.float32)
    lanes = len(CAPS)
    keys, us = _stream(1, lanes, 2 * N)

    st0 = jflat.flat_state_init(KEY_SPACE, PAD)
    jst0 = jax.tree.map(lambda a: jnp.stack([a] * lanes), st0)
    jst1, (h1, e1, o1) = _jax_replay(policy, jst0, pvecs, qs, keys[:, :N],
                                     us[:, :N])
    jst2, (h2, e2, o2) = _jax_replay(policy, jst1, pvecs, qs, keys[:, N:],
                                     us[:, N:])

    tp, tq = torch.from_numpy(pvecs), torch.from_numpy(qs)
    tk, tu = torch.from_numpy(keys).long(), torch.from_numpy(us)

    # from scratch: the first N requests and the state they leave
    tst = tflat.flat_state_init(KEY_SPACE, PAD, lanes=lanes, device="cpu")
    h, e, o = _torch_replay(policy, tst, tp, tq, tk[:, :N], tu[:, :N])
    np.testing.assert_array_equal(h, np.asarray(h1))
    np.testing.assert_array_equal(e, np.asarray(e1))
    np.testing.assert_array_equal(o, np.asarray(o1))
    _assert_state_equal(tst, jst1)

    # carried across from the JAX state, M more requests on both sides
    tst = flat_state_from_numpy(jax.tree.map(np.asarray, jst1), device="cpu")
    h, e, o = _torch_replay(policy, tst, tp, tq, tk[:, N:], tu[:, N:])
    np.testing.assert_array_equal(h, np.asarray(h2))
    np.testing.assert_array_equal(e, np.asarray(e2))
    np.testing.assert_array_equal(o, np.asarray(o2))
    _assert_state_equal(tst, jst2)
    assert np.asarray(h2).any() and (~np.asarray(h2)).any()


def test_single_lane_state_gains_lane_axis():
    st = jax.tree.map(np.asarray, jflat.flat_state_init(KEY_SPACE, PAD))
    tst = flat_state_from_numpy(st, device="cpu")
    assert tst.key2slot.shape == (1, KEY_SPACE)
    assert tst.regs.shape == (1, tflat.N_REGS)
    assert int(tst.regs[0, tflat.R_HAND]) == tflat.NIL


def test_s3fifo_rejects_capacity_one():
    with pytest.raises(ValueError, match="capacity >= 2"):
        tflat.flat_lane_params("s3fifo", 1)
    with pytest.raises(ValueError, match="capacity >= 2"):
        jflat.flat_lane_params("s3fifo", 1)


def test_lane_params_validation():
    with pytest.raises(KeyError):
        tflat.flat_lane_params("nope", 4)
    with pytest.raises(TypeError, match="unexpected params"):
        tflat.flat_lane_params("lru", 4, q=0.5)
    with pytest.raises(ValueError, match="max_scan"):
        tflat.flat_lane_params("clock", 4, max_scan=-1)


def test_pack_roundtrip():
    rng = np.random.default_rng(0)
    ops = np.stack([rng.integers(0, 2, 64), rng.integers(0, 256, 64),
                    rng.integers(0, 8, 64), rng.integers(0, 2**19, 64)],
                   axis=-1).astype(np.int32)
    packed = tflat.pack_ops(torch.from_numpy(ops))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jflat.pack_ops(ops.T)))
    np.testing.assert_array_equal(tflat.unpack_ops(packed).numpy(), ops)
