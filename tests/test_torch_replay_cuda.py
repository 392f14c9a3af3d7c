"""The replay kernel against its plain version, on the card.

These tests import neither jax nor the JAX package, so they run where the
card is (``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_replay_cuda.py``); without a card they skip.  Every
output is held bit for bit (tolerance: exact): hits, evicted keys, packed
op vectors and the fused delayed-hit classes.  The lanes:

* ``EDGE_CASES``, where the flat engine's masked argmins meet an empty
  mask or a list of one: capacity 0, 1 and 2, CLOCK's ``max_scan`` 0,
  SLRU's ``protected_frac`` 1.0, S3-FIFO's ``small_frac`` 1.0 (no main
  queue) and 2.0, Prob-LRU's q 0.0 and 1.0, a one-key stream, an
  all-distinct stream and slot arrays padded far past the capacity; each
  in both state layouts of the kernel (``replay.LAYOUTS``);
* key space 2**17, whose state lives in device memory;
* the grid cases ``CASES``.

The cases are defined here, once: ``test_torch_replay.py`` imports them
and holds the plain version on them against the JAX reference, on the
CPU, and ``chip_smoke.py`` runs ``EDGE_CASES`` on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.cache import flat
from repro_torch.core.harness import miss_window_stream
from repro_torch.kernels import _build
from repro_torch.kernels import replay as tkreplay

# (policy, params, stream, capacities, pad_to)
EDGE_CASES = [
    ("lru", {}, "zipf", (0, 1, 2), 64),
    ("lru", {}, "one_key", (1, 2), None),
    ("fifo", {}, "distinct", (1, 2, 5), 64),
    ("prob_lru", {"q": 0.0}, "zipf", (1, 2, 7), None),
    ("prob_lru", {"q": 1.0}, "zipf", (1, 2, 7), 64),
    ("clock", {"max_scan": 0}, "zipf", (1, 2, 7), None),
    ("clock", {"max_scan": 3}, "one_key", (0, 1, 2), 64),
    ("slru", {"protected_frac": 1.0}, "zipf", (1, 2, 7), None),
    ("slru", {"protected_frac": 0.5}, "distinct", (0, 1, 2), 64),
    ("s3fifo", {"small_frac": 1.0, "max_scan": 3}, "zipf", (2, 3, 7), None),
    ("s3fifo", {"small_frac": 2.0, "max_scan": 1}, "zipf", (2, 5), 64),
    ("s3fifo", {"small_frac": 0.1, "max_scan": 0}, "zipf", (2, 3, 7), 64),
    ("s3fifo", {"small_frac": 0.5, "max_scan": 3}, "distinct", (2, 3), 64),
    ("sieve", {}, "zipf", (0, 1, 2, 7), 64),
    ("sieve", {}, "distinct", (1, 2), None),
]
EDGE_T = 300


def edge_stream(kind, n=EDGE_T):
    """(keys, us, key_space) of an edge lane's stream: Zipf(0.99) over 12
    keys (two seeds), one key, or every request a new key."""
    rng = np.random.default_rng(11)
    if kind == "zipf":
        probs = np.arange(1, 13) ** -0.99
        keys = rng.choice(12, size=(2, n), p=probs / probs.sum())
    elif kind == "one_key":
        keys = np.zeros((1, n), np.int64)
    else:
        keys = np.arange(n)[None]
    us = rng.random(keys.shape, dtype=np.float32)
    return keys, us, int(keys.max()) + 1


# the grid cases: (policy, window, fail_prob, pad_to) over CAPS, two Zipf
# streams of T requests over KEY_SPACE keys; scalar and per-request
# windows, re-issue stretching, slot arrays padded past the largest
# capacity
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


def streams(seed=0, n_seeds=2, n=T):
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, KEY_SPACE + 1)
    probs = ranks ** -0.99 / np.sum(ranks ** -0.99)
    keys = rng.choice(KEY_SPACE, size=(n_seeds, n), p=probs)
    us = rng.random((n_seeds, n), dtype=np.float32)
    return keys, us


def window_of(kind, n=T):
    return 6 if kind == "scalar" else miss_window_stream(n, 5.0, seed=3)


def _hold(kern, plain):
    for a, b in zip(kern, plain):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def _hold_launch(policy, grid, plain):
    """The wrapper launches once and matches ``plain``."""
    before = tkreplay.replay_lanes.launches
    _hold(tkreplay.replay_lanes(policy, *grid.args, grid.key_space, grid.pad),
          plain)
    assert tkreplay.replay_lanes.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("policy,params,stream,caps,pad_to", EDGE_CASES)
def test_edge_lanes_on_card(cuda_device, policy, params, stream, caps, pad_to):
    keys, us, key_space = edge_stream(stream)
    grid = tkreplay.grid_lanes(policy, keys, us, caps, key_space=key_space,
                               pad_to=pad_to, window=4, fail_prob=0.1,
                               device=cuda_device, **params)
    plain = tkreplay.replay_lanes_plain(policy, *grid.args, grid.key_space,
                                        grid.pad)
    lib = _build.load_library()
    for kind in tkreplay.LAYOUTS:
        layout = tkreplay.layout_bytes(policy, grid.key_space, grid.pad, kind)
        _hold(tkreplay._launch(lib, policy, layout, grid.args, grid.key_space,
                               grid.pad), plain)
    _hold_launch(policy, grid, plain)


@pytest.mark.cuda
def test_shared_memory_layout_on_card(cuda_device):
    lib = _build.load_library()
    for policy, pid in flat.POLICY_IDS.items():
        for key_space, pad in ((4096, 3300), (96, 41), (1 << 17, 40_000)):
            for i, kind in enumerate(tkreplay.LAYOUTS):
                want = tkreplay.layout_bytes(policy, key_space, pad, kind)
                assert (lib.replay_bytes(pid, key_space, pad, i, 0),
                        lib.replay_bytes(pid, key_space, pad, i, 1)) == (
                            want.shared_bytes, want.scratch_bytes)
    # 40 000 keys do not fit beside 3 300 slots: the state goes to device
    # memory, and the lane still matches
    keys, us = streams(seed=8, n_seeds=1, n=400)
    keys = keys * 400 + 17
    grid = tkreplay.grid_lanes("lru", keys, us, [7, 3300], key_space=40_000,
                               window=6, device=cuda_device)
    assert tkreplay.replay_layout("lru", 40_000, 3300).kind == "global"
    _hold_launch("lru", grid, tkreplay.replay_lanes_plain(
        "lru", *grid.args, grid.key_space, grid.pad))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", list(PARAMS))
def test_device_memory_tables_on_card(cuda_device, policy):
    """Key space 2**17: the lane's state in device memory."""
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 1 << 17, size=(1, 600))
    keys[0, ::3] = keys[0, :200]  # repeats, so there are hits
    us = rng.random(keys.shape, dtype=np.float32)
    grid = tkreplay.grid_lanes(policy, keys, us, [5, 60], key_space=1 << 17,
                               window=8, fail_prob=0.1, device=cuda_device,
                               **PARAMS[policy])
    assert tkreplay.replay_layout(policy, 1 << 17, grid.pad).kind == "global"
    _hold_launch(policy, grid, tkreplay.replay_lanes_plain(
        policy, *grid.args, grid.key_space, grid.pad))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    keys, us = streams(seed=6)
    for policy, kind, fail_prob, pad_to in CASES:
        kw = dict(key_space=KEY_SPACE, pad_to=pad_to, window=window_of(kind),
                  fail_prob=fail_prob, **PARAMS[policy])
        before = tkreplay.replay_lanes.launches
        k = tkreplay.replay_grid_fused(policy, keys, us, CAPS,
                                       device=cuda_device, **kw)
        assert tkreplay.replay_lanes.launches == before + 1
        p = tkreplay.replay_grid_fused(policy, keys, us, CAPS, device="cpu",
                                       **kw)
        for a, b in zip(k, p):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
