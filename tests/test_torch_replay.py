"""The port's replay grid, LRU sweep and classifier against the JAX package.

``repro_torch.kernels.replay.replay_grid_fused`` (on the CPU: the kernel's
plain version, the flat steps looped over the stream) must equal
``repro.kernels.replay.replay_grid_pallas`` bit for bit on every policy:
hits, evicted keys, packed ops and the fused delayed-hit classes, with
scalar windows, per-request windows and ``fail_prob > 0``, and on the
edge lanes of ``test_torch_replay_cuda.EDGE_CASES`` (tolerance: exact).
The kernel itself is held against the plain version on the card in
``test_torch_replay_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro.cache import replay as jreplay
from repro.kernels import replay as jkreplay
from repro_torch.cache import flat
from repro_torch.cache import replay as treplay
from repro_torch.kernels import replay as tkreplay
from test_torch_replay_cuda import (CAPS, CASES, EDGE_CASES, KEY_SPACE,
                                    PARAMS, T, edge_stream, streams,
                                    window_of)


def _assert_grid_equal(t, j):
    np.testing.assert_array_equal(t.hits.numpy(), np.asarray(j.hits))
    np.testing.assert_array_equal(t.evicted.numpy(), np.asarray(j.evicted))
    np.testing.assert_array_equal(t.ops.numpy(), np.asarray(j.ops))
    if j.cls is None:
        assert t.cls is None
    else:
        np.testing.assert_array_equal(t.cls.numpy(), np.asarray(j.cls))


@pytest.mark.parametrize("policy,kind,fail_prob,pad_to", CASES)
def test_fused_grid_bit_identical(policy, kind, fail_prob, pad_to):
    keys, us = streams()
    kw = dict(key_space=KEY_SPACE, pad_to=pad_to, window=window_of(kind),
              fail_prob=fail_prob, fail_seed=4, **PARAMS[policy])
    t = tkreplay.replay_grid_fused(policy, keys, us, CAPS, device="cpu", **kw)
    j = jkreplay.replay_grid_pallas(policy, keys, us, CAPS, **kw)
    assert t.hits.shape == (len(CAPS), 2, T)
    _assert_grid_equal(t, j)
    np.testing.assert_array_equal(tkreplay.unpack_grid_ops(t),
                                  jkreplay.unpack_grid_ops(j))
    cls = t.cls.numpy()
    assert (cls == treplay.DELAYED_HIT).any() and (cls == treplay.TRUE_MISS).any()


def test_kernel_body_interpreter_matches():
    """One tiny case against the JAX kernel body itself (interpret=True)."""
    keys, us = streams(seed=5, n_seeds=1, n=160)
    kw = dict(key_space=KEY_SPACE, window=4, **PARAMS["sieve"])
    t = tkreplay.replay_grid_fused("sieve", keys, us, [6, 11], device="cpu",
                                   **kw)
    j = jkreplay.replay_grid_pallas("sieve", keys, us, [6, 11],
                                    interpret=True, **kw)
    _assert_grid_equal(t, j)


@pytest.mark.parametrize("policy", ["slru", "clock"])
def test_replay_grid_matches_reference(policy):
    keys, us = streams(seed=2, n=600)
    t = treplay.replay_grid(policy, keys, us, [4, 19], key_space=KEY_SPACE,
                            device="cpu", **PARAMS[policy])
    j = jreplay.replay_grid(policy, keys, us, [4, 19], key_space=KEY_SPACE,
                            **PARAMS[policy])
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    assert t.ops.dtype == np.int64 and t.ops.shape == (2, 2, 600, 4)


def test_lru_sweep_matches_reference():
    keys, _ = streams(seed=3, n_seeds=1, n=4000)
    caps = [1, 7, 30, 95]
    th, to = treplay.lru_sweep(keys[0], caps)
    jh, jo = jreplay.lru_sweep(keys[0], caps)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(to, jo)


@pytest.mark.parametrize("window,fail_prob", [(5, 0.0), (3, 0.25),
                                              ("per_request", 0.1)])
def test_classify_inflight_matches_reference(window, fail_prob):
    keys, _ = streams(seed=4)
    hits = np.random.default_rng(9).random((3, 2, T)) < 0.6
    w = window_of("per_request") if window == "per_request" else window
    t = treplay.classify_inflight(keys, hits, w, key_space=KEY_SPACE,
                                  fail_prob=fail_prob, fail_seed=2,
                                  device="cpu")
    j = jreplay.classify_inflight(keys, hits, w, key_space=KEY_SPACE,
                                  fail_prob=fail_prob, fail_seed=2)
    assert t.dtype == np.int8 and t.shape == hits.shape
    np.testing.assert_array_equal(t, np.asarray(j))


@pytest.mark.parametrize("fail_prob", [0.0, 0.2])
def test_classify_lanes_equal_each_lane_classified_alone(fail_prob):
    """One window stream per hits row, every row a lane of one pass: each
    lane bit for bit the row classified alone (and the reference's)."""
    keys, _ = streams(seed=5)
    keys = keys[0]
    hits = np.random.default_rng(3).random((4, T)) < 0.55
    windows = [5, 0, 3, window_of("per_request")]
    per_row = np.stack([np.broadcast_to(w, (T,)) for w in windows])
    got = treplay.classify_inflight(keys, hits, per_row, key_space=KEY_SPACE,
                                    fail_prob=fail_prob, fail_seed=1,
                                    device="cpu")
    assert got.dtype == np.int8 and got.shape == hits.shape
    for i, w in enumerate(windows):
        alone = treplay.classify_inflight(keys, hits[i], w,
                                          key_space=KEY_SPACE,
                                          fail_prob=fail_prob, fail_seed=1,
                                          device="cpu")
        np.testing.assert_array_equal(got[i], alone)
        np.testing.assert_array_equal(got[i], np.asarray(
            jreplay.classify_inflight(keys, hits[i], w, key_space=KEY_SPACE,
                                      fail_prob=fail_prob, fail_seed=1)))
    with pytest.raises(ValueError):
        treplay.classify_inflight(keys, hits[:3], per_row,
                                  key_space=KEY_SPACE, device="cpu")


def test_window_and_attempt_streams_match():
    np.testing.assert_array_equal(treplay.refetch_attempts(500, 0.3, 7),
                                  jreplay.refetch_attempts(500, 0.3, 7))
    np.testing.assert_array_equal(
        treplay._window_stream(np.arange(50) % 7, 50, 0.2, 1),
        jreplay._window_stream(np.arange(50) % 7, 50, 0.2, 1))


def test_validation_errors():
    keys, us = streams(n=50)
    with pytest.raises(ValueError, match="shape mismatch"):
        tkreplay.replay_grid_fused("lru", keys, us[:, :-1], [8],
                                   key_space=KEY_SPACE, device="cpu")
    with pytest.raises(ValueError, match="at least one capacity"):
        tkreplay.replay_grid_fused("lru", keys, us, [], key_space=KEY_SPACE,
                                   device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        tkreplay.replay_grid_fused("lru", keys, us, [8], key_space=10,
                                   device="cpu")
    with pytest.raises(ValueError, match="pad_to"):
        tkreplay.replay_grid_fused("lru", keys, us, [8], pad_to=4,
                                   device="cpu")


def test_wrapper_checks_inputs():
    keys = torch.zeros((2, 5), dtype=torch.int64)
    args = (torch.zeros((2, 6), dtype=torch.int32),
            torch.zeros(2, dtype=torch.float32), keys,
            torch.zeros((2, 5), dtype=torch.float32),
            torch.zeros((2, 5), dtype=torch.int32))
    with pytest.raises(ValueError, match="keys must be torch.int32"):
        tkreplay.replay_lanes("lru", *args, key_space=4, pad=4)
    # parameters that would index past the slot arrays
    args = (args[0], args[1], keys.to(torch.int32)) + args[3:]
    args[0][:, flat.P_CAP] = 5
    with pytest.raises(ValueError, match="capacity 5 > pad 4"):
        tkreplay.replay_lanes("lru", *args, key_space=4, pad=4)
    args[0][:, flat.P_CAP] = 2
    with pytest.raises(ValueError, match="ghost ring capacity"):
        tkreplay.replay_lanes("s3fifo", *args, key_space=4, pad=4)
    with pytest.raises(ValueError, match="pad must be >= 1"):
        tkreplay.replay_lanes("lru", *args, key_space=4, pad=0)


def test_shared_memory_budget():
    """Which layout a lane's state gets (``replay.replay_layout``)."""
    # the main path's lanes keep everything in one block's shared memory
    for policy in flat.POLICY_IDS:
        lay = tkreplay.replay_layout(policy, 4096, 3300)
        assert lay.kind == "shared" and lay.scratch_bytes == 0
        assert lay.shared_bytes <= 232_448
    # LRU at 4096 / 3300: 896 bytes of staging, expiry and key2slot (int32,
    # int16 per key), slot2key, prv, nxt (int32, int16, int16 per slot;
    # each array rounded up to 16 bytes)
    assert tkreplay.replay_layout("lru", 4096, 3300).shared_bytes == (
        896 + (4 + 2) * 4096 + 4 * 3300 + 2 * 6608)
    # state that does not fit in one block's shared memory, or slot arrays
    # past int16 links, goes to device memory with int32 links: only the
    # staging stays in shared memory
    for policy in flat.POLICY_IDS:
        for key_space in (40_000, 1 << 17, 1 << 22):
            lay = tkreplay.replay_layout(policy, key_space, 3300)
            assert lay.kind == "global" and lay.shared_bytes == 896
            assert lay.scratch_bytes >= 8 * key_space + 12 * 3300
    assert tkreplay.replay_layout("s3fifo", 4096, 20_000).kind == "global"
    assert tkreplay.replay_layout("sieve", 4096, 20_000).kind == "shared"
    for policy in flat.POLICY_IDS:
        lay = tkreplay.replay_layout(policy, 96, 40_000)
        assert lay == tkreplay.layout_bytes(policy, 96, 40_000, "global")
        assert lay.shared_bytes == 896


@pytest.mark.parametrize("policy,params,stream,caps,pad_to", EDGE_CASES)
def test_edge_lanes_bit_identical(policy, params, stream, caps, pad_to):
    keys, us, key_space = edge_stream(stream)
    kw = dict(key_space=key_space, pad_to=pad_to, window=4, fail_prob=0.1,
              fail_seed=4, **params)
    t = tkreplay.replay_grid_fused(policy, keys, us, caps, device="cpu", **kw)
    j = jkreplay.replay_grid_pallas(policy, keys, us, caps, **kw)
    _assert_grid_equal(t, j)
