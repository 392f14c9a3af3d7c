"""The port's replay grid, LRU sweep and classifier against the JAX package.

``repro_torch.kernels.replay.replay_grid_fused`` (on the CPU: the kernel's
plain version, the flat steps looped over the stream) must equal
``repro.kernels.replay.replay_grid_pallas`` bit for bit on every policy:
hits, evicted keys, packed ops and the fused delayed-hit classes, with
scalar windows, per-request windows and ``fail_prob > 0``.
"""

import numpy as np
import pytest
import torch

from repro.cache import replay as jreplay
from repro.kernels import replay as jkreplay
from repro_torch.cache import flat
from repro_torch.cache import replay as treplay
from repro_torch.core.harness import miss_window_stream
from repro_torch.kernels import _build
from repro_torch.kernels import replay as tkreplay

KEY_SPACE = 96
T = 800

PARAMS = {
    "lru": {},
    "fifo": {},
    "prob_lru": {"q": 0.5},
    "clock": {"max_scan": 3},
    "slru": {"protected_frac": 0.5},
    "s3fifo": {"small_frac": 0.25, "max_scan": 3},
    "sieve": {},
}

# (policy, window, fail_prob, pad_to): scalar and per-request windows,
# re-issue stretching, and slot arrays padded past the largest capacity
CASES = [
    ("lru", "scalar", 0.1, None),
    ("fifo", "per_request", 0.0, 48),
    ("prob_lru", "scalar", 0.0, None),
    ("clock", "per_request", 0.2, 45),
    ("slru", "scalar", 0.1, None),
    ("s3fifo", "per_request", 0.0, None),
    ("sieve", "scalar", 0.2, 41),
]
CAPS = [5, 17, 40]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return "cuda"


def _streams(seed=0, n_seeds=2, n=T):
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, KEY_SPACE + 1)
    probs = ranks ** -0.99 / np.sum(ranks ** -0.99)
    keys = rng.choice(KEY_SPACE, size=(n_seeds, n), p=probs)
    us = rng.random((n_seeds, n), dtype=np.float32)
    return keys, us


def _window(kind, n=T):
    return 6 if kind == "scalar" else miss_window_stream(n, 5.0, seed=3)


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
    keys, us = _streams()
    kw = dict(key_space=KEY_SPACE, pad_to=pad_to, window=_window(kind),
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
    keys, us = _streams(seed=5, n_seeds=1, n=160)
    kw = dict(key_space=KEY_SPACE, window=4, **PARAMS["sieve"])
    t = tkreplay.replay_grid_fused("sieve", keys, us, [6, 11], device="cpu",
                                   **kw)
    j = jkreplay.replay_grid_pallas("sieve", keys, us, [6, 11],
                                    interpret=True, **kw)
    _assert_grid_equal(t, j)


@pytest.mark.parametrize("policy", ["slru", "clock"])
def test_replay_grid_matches_reference(policy):
    keys, us = _streams(seed=2, n=600)
    t = treplay.replay_grid(policy, keys, us, [4, 19], key_space=KEY_SPACE,
                            device="cpu", **PARAMS[policy])
    j = jreplay.replay_grid(policy, keys, us, [4, 19], key_space=KEY_SPACE,
                            **PARAMS[policy])
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    assert t.ops.dtype == np.int64 and t.ops.shape == (2, 2, 600, 4)


def test_lru_sweep_matches_reference():
    keys, _ = _streams(seed=3, n_seeds=1, n=4000)
    caps = [1, 7, 30, 95]
    th, to = treplay.lru_sweep(keys[0], caps)
    jh, jo = jreplay.lru_sweep(keys[0], caps)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(to, jo)


@pytest.mark.parametrize("window,fail_prob", [(5, 0.0), (3, 0.25),
                                              ("per_request", 0.1)])
def test_classify_inflight_matches_reference(window, fail_prob):
    keys, _ = _streams(seed=4)
    hits = np.random.default_rng(9).random((3, 2, T)) < 0.6
    w = _window("per_request") if window == "per_request" else window
    t = treplay.classify_inflight(keys, hits, w, key_space=KEY_SPACE,
                                  fail_prob=fail_prob, fail_seed=2,
                                  device="cpu")
    j = jreplay.classify_inflight(keys, hits, w, key_space=KEY_SPACE,
                                  fail_prob=fail_prob, fail_seed=2)
    assert t.dtype == np.int8 and t.shape == hits.shape
    np.testing.assert_array_equal(t, np.asarray(j))


def test_window_and_attempt_streams_match():
    np.testing.assert_array_equal(treplay.refetch_attempts(500, 0.3, 7),
                                  jreplay.refetch_attempts(500, 0.3, 7))
    np.testing.assert_array_equal(
        treplay._window_stream(np.arange(50) % 7, 50, 0.2, 1),
        jreplay._window_stream(np.arange(50) % 7, 50, 0.2, 1))


def test_validation_errors():
    keys, us = _streams(n=50)
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


def _lane_shared_bytes(key_space, pad):
    """replay.cu's lane layout: key2slot + expiry (key_space each),
    slot2key/ts/bit/aux/ghost (pad each), the registers and the reduction
    scratch of a 256-thread block (8 warps)."""
    return 4 * (2 * key_space + 5 * pad + flat.N_REGS + 2 * (256 // 32 + 1))


def test_shared_memory_budget():
    # the main path's lane (key_space 4096, pad 3300) fits in one block
    assert _lane_shared_bytes(4096, 3300) <= _build.MAX_SHARED_BYTES
    assert _lane_shared_bytes(40_000, 3300) > _build.MAX_SHARED_BYTES


@pytest.mark.cuda
def test_shared_memory_layout_on_card(cuda_device):
    lib = _build.load_library()
    for key_space, pad in ((4096, 3300), (96, 41)):
        assert (lib.replay_shared_bytes(key_space, pad)
                == _lane_shared_bytes(key_space, pad))
    keys = torch.zeros((1, 4), dtype=torch.int32, device=cuda_device)
    args = (torch.zeros((1, 6), dtype=torch.int32, device=cuda_device),
            torch.zeros(1, dtype=torch.float32, device=cuda_device), keys,
            torch.zeros((1, 4), dtype=torch.float32, device=cuda_device),
            torch.zeros((1, 4), dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match="shared memory"):
        tkreplay.replay_lanes("lru", *args, key_space=40_000, pad=3300)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    keys, us = _streams(seed=6)
    for policy, kind, fail_prob, pad_to in CASES:
        kw = dict(key_space=KEY_SPACE, pad_to=pad_to, window=_window(kind),
                  fail_prob=fail_prob, **PARAMS[policy])
        before = tkreplay.replay_lanes.launches
        k = tkreplay.replay_grid_fused(policy, keys, us, CAPS,
                                       device=cuda_device, **kw)
        assert tkreplay.replay_lanes.launches == before + 1
        p = tkreplay.replay_grid_fused(policy, keys, us, CAPS, device="cpu",
                                       **kw)
        for a, b in zip(k, p):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
