"""The port's main path against the JAX package's ``backend="pallas"`` route.

Zipf replay -> measured-profile network -> closed-loop simulation.  The
replay and the network fold are the same integer and numpy arithmetic on
both sides, so hit ratios, class fractions and bounds agree to rtol 1e-12;
the simulated throughput is held against the reference's counter-RNG
engine, within the 6% bound the reference uses between its engines (and
in fact to float32 rounding: both draw the same uniforms).
"""

import numpy as np
import pytest

from repro.core import harness as jharness
from repro.core.simulator import simulate_network as jsimulate_network
from repro_torch.core import harness as tharness
from repro_torch.core.simulator import simulate_network as tsimulate_network
from repro_torch.kernels import event_sim as tes

SIM_RTOL = 0.06


def test_streams_match():
    np.testing.assert_array_equal(tharness.zipf_trace(3000, 512, 0.99, 4),
                                  jharness.zipf_trace(3000, 512, 0.99, 4))
    np.testing.assert_array_equal(tharness.coin_stream(3000, 4),
                                  jharness.coin_stream(3000, 4))
    np.testing.assert_array_equal(tharness.miss_window_stream(3000, 6.5, 4),
                                  jharness.miss_window_stream(3000, 6.5, 4))


def test_measure_cache_matches_reference():
    kw = dict(key_space=256, n_requests=2000, miss_latency_requests=5,
              fetch_fail_prob=0.1, max_scan=3)
    t = tharness.measure_cache("clock", 32, device="cpu", **kw)
    j = jharness.measure_cache("clock", 32, backend="pallas", **kw)
    assert t.hit_ratio == j.hit_ratio
    assert t.profiles == j.profiles
    np.testing.assert_array_equal(t.mean_ops_hit, j.mean_ops_hit)
    np.testing.assert_array_equal(t.mean_ops_miss, j.mean_ops_miss)
    np.testing.assert_allclose(t.class_fracs, j.class_fracs, rtol=1e-12)
    np.testing.assert_allclose(t.throughput_bound(), j.throughput_bound(),
                               rtol=1e-12)
    np.testing.assert_allclose(t.coalesced_throughput_bound(),
                               j.coalesced_throughput_bound(), rtol=1e-12)
    assert t.miss_latency_requests == j.miss_latency_requests == 5


@pytest.mark.parametrize("policy,window", [("lru", 5), ("clock", [3, 7])])
def test_sweep_matches_reference(policy, window):
    """LRU with a shared window (classification fused into the replay) and
    CLOCK with per-size windows (classified after it), both simulated.

    The reference sweep simulates with its threefry engine whatever the
    backend; one seed of either engine scatters by more than 10% at these
    lengths, so ``x_sim`` is held against the reference's counter-RNG
    engine on the same measured network, which draws the same uniforms."""
    sizes = [40, 200]
    kw = dict(key_space=512, n_requests=2000,
              miss_latency_requests=np.asarray(window))
    t = tharness.sweep_cache_sizes(policy, sizes, simulate=True,
                                   sim_requests=800, device="cpu", **kw)
    j = jharness.sweep_cache_sizes(policy, sizes, backend="pallas", **kw)
    assert set(t) == set(j) | {"x_sim"}
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-12, err_msg=k)
    assert np.all(np.diff(t["p_hit"]) > 0)
    for c, x in zip(sizes, t["x_sim"]):
        m = jharness.measure_cache(policy, c, key_space=512, n_requests=2000,
                                   backend="pallas")
        ref = jsimulate_network(m.network, [m.hit_ratio], n_requests=800,
                                seeds=(0,), backend="pallas")
        np.testing.assert_allclose(x, ref.throughput[0], rtol=SIM_RTOL)
        # same uniforms, same float32 formulas: the same trajectory
        np.testing.assert_allclose(x, ref.throughput[0], rtol=1e-5)


def test_sweep_simulates_every_size_in_one_launch(monkeypatch):
    """``x_sim`` of a sweep, every size a lane of one event-sim call, is
    bit for bit each size's network simulated alone by simulate_network
    (seed 0)."""
    calls = []
    real = tes.sim_lanes

    def counted(*args, **kwargs):
        calls.append(args[1].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(tes, "sim_lanes", counted)
    sizes = [40, 120, 300]
    kw = dict(key_space=512, n_requests=2000)
    t = tharness.sweep_cache_sizes("slru", sizes, simulate=True,
                                   sim_requests=600, device="cpu", **kw)
    assert calls == [len(sizes)]
    monkeypatch.setattr(tes, "sim_lanes", real)
    for c, x in zip(sizes, t["x_sim"]):
        m = tharness.measure_cache("slru", c, device="cpu", **kw)
        alone = tsimulate_network(m.network, [m.hit_ratio], n_requests=600,
                                  seeds=(0,), device="cpu")
        assert x == float(alone.throughput[0])


def test_sweep_classifies_every_size_in_one_pass(monkeypatch):
    """Per-size windows that differ: every size is a lane of one
    classification pass, and the columns are the reference's."""
    from repro_torch.cache import replay as treplay

    calls = []
    real = treplay._classify_lanes

    def counted(keys, hits, windows, key_space):
        calls.append(tuple(keys.shape))
        return real(keys, hits, windows, key_space)

    monkeypatch.setattr(treplay, "_classify_lanes", counted)
    sizes = [40, 120, 300]
    kw = dict(key_space=512, n_requests=2000, fetch_fail_prob=0.1,
              miss_latency_requests=np.array([3, 9, 5]))
    t = tharness.sweep_cache_sizes("lru", sizes, device="cpu", **kw)
    assert calls == [(len(sizes), 2000)]
    j = jharness.sweep_cache_sizes("lru", sizes, backend="pallas", **kw)
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-12, err_msg=k)


def test_run_cache_trace_matches_reference():
    trace = tharness.zipf_trace(1000, 256, 0.99, 1)
    th, to = tharness.run_cache_trace("s3fifo", 24, trace, seed=1,
                                      key_space=256, device="cpu",
                                      small_frac=0.25)
    jh, jo = jharness.run_cache_trace("s3fifo", 24, trace, seed=1,
                                      backend="pallas", key_space=256,
                                      small_frac=0.25)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(to, jo)


def test_parameterized_network_bound_matches():
    t = tharness.parameterized_network("lru", (1, 1, 0, 0), (0, 1, 1, 0))
    j = jharness.parameterized_network("lru", (1, 1, 0, 0), (0, 1, 1, 0))
    for p in (0.5, 0.9, 0.99):
        assert t.throughput_upper(p) == j.throughput_upper(p)
