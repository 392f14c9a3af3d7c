"""The port's batched LRU update against ``repro.kernels.ops.lru_batch_update``.

The same inputs, made with numpy, go through the Pallas kernel (in
interpret mode), its jnp reference ``ref.lru_batch_update_ref`` and the
port's ``ops.lru_batch_update`` (its plain version, on CPU tensors).  The
function is integer-exact: new timestamps and the victim (the first index
of the minimum) must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import cache_update as cu
from repro_torch.kernels import ops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return "cuda"


def _inputs(n_slots, n_acc, *, ties, duplicates, padding, seed=0):
    rng = np.random.default_rng(seed)
    hi = 8 if ties else 10_000
    ts = rng.integers(1, hi, n_slots).astype(np.int32)
    acc = rng.choice(n_slots, min(n_acc, n_slots), replace=False)
    acc = acc.astype(np.int32)
    if duplicates:
        acc[len(acc) // 2:] = acc[: len(acc) - len(acc) // 2]
    if padding:
        acc = np.concatenate([acc, np.full(7, -1, np.int32)])
    return ts, acc


CASES = [
    # (C, N, tile, ties, duplicates, padding)
    (1024, 64, 512, False, False, False),
    (2048, 128, 512, False, False, False),   # benchmarks/kernel_bench.py
    (512, 16, 128, True, False, False),
    (700, 32, 512, True, True, True),        # C not a tile multiple
    (1000, 96, 256, True, True, True),
    (129, 129, 64, True, False, True),       # every slot accessed
    (64, 1, 64, False, False, False),
    (300, 40, 1, True, True, False),
]


@pytest.mark.parametrize("C,N,tile,ties,dup,pad", CASES)
def test_plain_matches_pallas_and_ref(C, N, tile, ties, dup, pad):
    ts, acc = _inputs(C, N, ties=ties, duplicates=dup, padding=pad, seed=C)
    now = 50_000
    j_ts, j_victim = jops.lru_batch_update(jnp.asarray(ts), jnp.asarray(acc),
                                           jnp.int32(now), tile=tile,
                                           interpret=True)
    r_ts, r_victim = jref.lru_batch_update_ref(jnp.asarray(ts),
                                               jnp.asarray(acc),
                                               jnp.int32(now))
    t_ts, t_victim = ops.lru_batch_update(torch.from_numpy(ts),
                                          torch.from_numpy(acc), now,
                                          tile=tile)
    assert t_ts.dtype == torch.int32 and t_ts.shape == (C,)
    assert t_victim.dtype == torch.int32 and t_victim.dim() == 0
    np.testing.assert_array_equal(t_ts.numpy(), np.asarray(j_ts))
    np.testing.assert_array_equal(t_ts.numpy(), np.asarray(r_ts))
    assert int(t_victim) == int(j_victim) == int(r_victim)
    # the wrapper does not touch its input
    np.testing.assert_array_equal(ts, _inputs(C, N, ties=ties, duplicates=dup,
                                              padding=pad, seed=C)[0])


def test_semantics_and_tie_order():
    """Accessed slots become most recent; negative ids are no-ops; the
    victim is the first of several equal minima."""
    ts = torch.tensor([5, 3, 9, 1, 7, 1, 8, 1], dtype=torch.int32)
    acc = torch.tensor([3, -1, 3, -5], dtype=torch.int32)
    new_ts, victim = ops.lru_batch_update(ts, acc, 100, tile=8)
    assert new_ts.tolist() == [5, 3, 9, 100, 7, 1, 8, 1]
    assert int(victim) == 5


def test_rejects_bad_inputs():
    ts = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="capacity 16"):
        ops.lru_batch_update(ts, torch.tensor([3, 16], dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="tile"):
        ops.lru_batch_update(ts, torch.tensor([3], dtype=torch.int32), 1,
                             tile=0)
    with pytest.raises(ValueError, match="int32"):
        ops.lru_batch_update(ts.long(), torch.tensor([3], dtype=torch.int32),
                             1)
    with pytest.raises(ValueError, match="int32"):
        ops.lru_batch_update(ts, torch.tensor([3], dtype=torch.int32), 2**31)
    # an empty batch only finds the victim
    new_ts, victim = ops.lru_batch_update(ts, torch.zeros(0, dtype=torch.int32),
                                          1)
    assert torch.equal(new_ts, ts) and int(victim) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("C,N,pad", [(2048, 128, False), (1000, 96, True),
                                     (1 << 22, 4096, False)])
def test_kernel_matches_plain_on_card(cuda_device, C, N, pad):
    ts, acc = _inputs(C, N, ties=True, duplicates=pad, padding=pad)
    ts_d = torch.from_numpy(ts).to(cuda_device)
    acc_d = torch.from_numpy(acc).to(cuda_device)
    before = cu.lru_update.launches
    k_ts, k_victim = ops.lru_batch_update(ts_d, acc_d, 77)
    assert cu.lru_update.launches == before + 1
    p_ts, p_victim = cu.lru_update_plain(torch.from_numpy(ts),
                                         torch.from_numpy(acc), 77)
    np.testing.assert_array_equal(k_ts.cpu().numpy(), p_ts.numpy())
    assert int(k_victim) == int(p_victim)
