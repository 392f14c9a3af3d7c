"""The port's streaming observability against the reference's.

``repro_torch.obs.streaming`` against ``repro.obs.streaming``: the port's
``sketch_trace`` (the plain version of its kernel here) gives the
reference's jitted scan state in every field, the float32 EWMAs bit for
bit (both compute the fused multiply-adds XLA's CPU backend makes of the
reference's); the host side (decoding, ``sketch_trace_py`` and the
exact-counting twin ``PyStreamSketch``) is the reference's numpy and
gives its results exactly, on the port's state and on the reference's.
Then the reference's own assertions (``tests/test_streaming.py``,
``tests/test_properties.py``'s sketch cases) on the port's estimates.

The simulators with ``sketch_cap > 0`` run on the event-sim kernel's
plain version here: every output is identical with the sketch on and off
(closed loop, coalescing, the open loop with a burst, the cluster and the
hierarchy), and the sketched statistics hold to the reference tests'
bands (the port's counter engine draws other numbers than the
reference's threefry engine).  The heapq oracles run the same numpy code
as the reference's, so their sketches are the reference's exactly.

``drift``, ``residuals`` and ``profile`` are copies of the reference's
numpy and agree with it to rtol 1e-12.  The serving engine's admission
sketch is held in ``tests/test_torch_serving.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs.drift as Jdrift
import repro.obs.profile as Jprofile
import repro.obs.residuals as Jres
import repro.obs.streaming as J
import repro_torch.obs.drift as Tdrift
import repro_torch.obs.profile as Tprofile
import repro_torch.obs.residuals as Tres
import repro_torch.obs.streaming as T
from repro.cache.replay import lru_sweep
from repro.core import build as jbuild
from repro.core.harness import zipf_trace
from repro.core.py_sim import simulate_py as jsimulate_py
from repro_torch.core import build
from repro_torch.core.py_sim import simulate_py
from repro_torch.core.simulator import simulate_network
from repro_torch.kernels.sketch import sketch_trace_lanes

KEY_SPACE = 256  # tests/test_streaming.py's stream
THETA = 0.9
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def zipf_stream():
    trace = zipf_trace(6_000, KEY_SPACE, THETA, seed=0)
    hits, _ = lru_sweep(trace, [32])
    return trace, np.asarray(hits[0], np.int64)


@pytest.fixture(scope="module")
def twin_estimates(zipf_stream):
    trace, hits = zipf_stream
    fast = T.sketch_trace(trace, hits=hits, sketch_cap=64, window_us=500.0,
                          **CPU)
    oracle = T.sketch_trace_py(trace, hits=hits, sketch_cap=64,
                               window_us=500.0)
    return fast, oracle


@pytest.fixture(scope="module")
def wide_estimates(zipf_stream):
    """The stream without hits at sketch_cap 128: the port's and the
    reference's."""
    trace, _ = zipf_stream
    return (T.sketch_trace(trace, sketch_cap=128, window_us=500.0, **CPU),
            J.sketch_trace(trace, sketch_cap=128, window_us=500.0))


@pytest.fixture(scope="module")
def twin_state(zipf_stream):
    """The port's and the reference's state on the stream with hits."""
    trace, hits = zipf_stream
    return _state(trace, hits, 64, 500.0)


def _state(trace, hits, cap, window):
    """The port's and the reference's raw sketch_trace state."""
    t = np.arange(len(trace), dtype=np.float32)
    h = np.zeros(len(trace), np.int64) if hits is None else hits
    port = sketch_trace_lanes(
        torch.from_numpy(np.asarray(trace, np.int32))[None],
        torch.from_numpy(t)[None],
        torch.from_numpy(np.asarray(h, np.int32))[None],
        sketch_cap=cap, window_us=window)
    ref = J._sketch_trace(jnp.asarray(trace, jnp.int32), jnp.asarray(t),
                          jnp.asarray(h, jnp.int32), cap, float(window))
    return port, ref


def _same_estimates(a, b, exact_floats=True):
    """Every field of two SketchEstimates equal (NaN == NaN)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if x is None or y is None:
                assert x is None and y is None, f.name
            else:
                assert np.array_equal(np.asarray(x), np.asarray(y),
                                      equal_nan=True), f.name
        elif isinstance(x, float):
            assert (np.isnan(x) and np.isnan(y)) or x == y, f.name
        else:
            assert x == y, f.name


# ---------------------------------------------------------------------------
# The sketch twins: the port against the reference


def test_sketch_trace_state_equals_the_reference(twin_state):
    """Every field of the state, the scrap rows and the float32 EWMAs
    included, is the reference's jitted scan state."""
    port, ref = twin_state
    for f in T.SketchState._fields:
        a, b = getattr(port, f)[0].numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_the_ewma_is_fused_as_xla_fuses_it(zipf_stream, twin_state):
    """The reference's jitted EWMA, ``s * (1 - a) + where(hit, a, 0)`` per
    event, ends on the fused multiply-add recurrence's float32, not on the
    unfused one's: why the port fuses it (``fma_f32``, ``__fmaf_rn``)."""
    from repro_torch import fma_f32

    _, hits = zipf_stream
    _, ref = twin_state
    a = np.float32(T.EWMA_ALPHA)
    d = np.float32(1.0) - a
    unfused = np.float32(0.0)
    fused = torch.zeros(1, dtype=torch.float32)
    for h in hits:
        c = a if h else np.float32(0.0)
        unfused = np.float32(unfused * d) + c
        fused = fma_f32(fused, torch.tensor([d]), torch.tensor([c]))
    assert float(fused[0]) == float(np.asarray(ref.ewma_hit_frac))
    assert float(unfused) != float(np.asarray(ref.ewma_hit_frac))


@pytest.mark.parametrize("theta,cap,seed", [(0.0, 16, 0), (0.9, 32, 1),
                                            (1.3, 16, 2)])
def test_property_streams_equal_the_reference(theta, cap, seed):
    """``tests/test_properties.py``'s sketch-bounds cases (600 keys of 64):
    the state equals the reference's, and the decoded estimates hold that
    file's bounds against the exact twin."""
    trace = zipf_trace(600, 64, theta=theta, seed=seed)
    port, ref = _state(trace, None, cap, 50.0)
    for f in T.SketchState._fields:
        assert np.array_equal(getattr(port, f)[0].numpy(),
                              np.asarray(getattr(ref, f))), f
    fast = T.sketch_trace(trace, sketch_cap=cap, window_us=50.0, **CPU)
    exact = T.sketch_trace_py(trace, sketch_cap=cap, window_us=50.0)
    _same_estimates(fast, J.sketch_trace(trace, sketch_cap=cap,
                                         window_us=50.0))
    assert np.array_equal(fast.window_id, exact.window_id)
    assert np.array_equal(fast.win_done_count, exact.win_done_count)
    assert fast.key_count == exact.key_count == 600
    probe = np.arange(64)
    truth = exact.cm_estimate(probe)
    assert np.all(fast.cm_estimate(probe) >= truth)
    keys, upper, err = fast.topk()
    t = exact.cm_estimate(keys)
    assert np.all(upper >= t) and np.all(upper - err <= t)
    heavy = probe[truth > 600 / cap]
    assert set(heavy.tolist()) <= set(keys.tolist())


def test_estimates_equal_the_reference(zipf_stream, twin_estimates):
    trace, hits = zipf_stream
    fast, oracle = twin_estimates
    _same_estimates(fast, J.sketch_trace(trace, hits=hits, sketch_cap=64,
                                         window_us=500.0))
    _same_estimates(oracle, J.sketch_trace_py(trace, hits=hits, sketch_cap=64,
                                              window_us=500.0))


def test_decoding_the_reference_state(twin_state):
    """The port's decoder reads the reference's jnp state, and the
    reference's decoder the port's tensors' numpy, to the same estimates."""
    port, ref = twin_state
    _same_estimates(T.decode_sketch(ref, 500.0), J.decode_sketch(ref, 500.0))
    one = J.SketchState(*(getattr(port, f)[0].numpy()
                          for f in T.SketchState._fields))
    _same_estimates(T.decode_sketch(one, 500.0), J.decode_sketch(one, 500.0))
    grid = T.decode_sketch_grid(port, 1, 1, 500.0)
    _same_estimates(grid[0][0], J.decode_sketch(ref, 500.0))


def test_py_stream_sketch_equals_the_reference():
    """The exact twin on one event stream of arrivals, keys, hits, delayed
    hits, several branches and a ring that wraps."""
    rng = np.random.default_rng(3)
    port = T.PyStreamSketch(8, n_branches=3, window_us=10.0, n_windows=4)
    ref = J.PyStreamSketch(8, n_branches=3, window_us=10.0, n_windows=4)
    t = 0.0
    for _ in range(500):
        t += float(rng.exponential(0.7))
        k, b, u = int(rng.zipf(1.5)), int(rng.integers(3)), rng.random()
        for sk in (port, ref):
            sk.arrival(t)
            sk.key(k)
            sk.done(t, b, is_hit=u < 0.5, delayed=0.5 <= u < 0.7)
    _same_estimates(port.estimates(), ref.estimates())
    assert port.ewma_hit == ref.ewma_hit and port.ewma_norm == ref.ewma_norm


def test_pow_table():
    """The batch decay table: float32 of the float64 power, 1 at n = 0."""
    tab = T.pow_table(300).numpy()
    base = np.float32(1.0) - np.float32(T.EWMA_ALPHA)
    assert tab.dtype == np.float32 and tab[0] == 1.0 and tab[1] == base
    assert np.array_equal(
        tab, (np.float64(base) ** np.arange(301)).astype(np.float32))


# ---------------------------------------------------------------------------
# The reference's own assertions on the port's estimates
# (tests/test_streaming.py's TestSketchTwins)


class TestSketchTwins:
    def test_windowed_counters_bit_equal(self, twin_estimates):
        fast, oracle = twin_estimates
        assert np.array_equal(fast.window_id, oracle.window_id)
        assert np.array_equal(fast.win_done_count, oracle.win_done_count)
        assert np.array_equal(fast.win_arrival_rate,
                              oracle.win_arrival_rate)
        assert np.allclose(fast.win_hit_frac, oracle.win_hit_frac,
                           equal_nan=True)
        assert np.allclose(fast.win_done_rate, oracle.win_done_rate)
        assert fast.key_count == oracle.key_count

    def test_ewma_matches_to_float32(self, twin_estimates):
        fast, oracle = twin_estimates
        assert fast.ewma_hit_frac == pytest.approx(oracle.ewma_hit_frac,
                                                   abs=1e-5)

    def test_count_min_never_underestimates(self, twin_estimates):
        fast, oracle = twin_estimates
        probe = np.arange(KEY_SPACE)
        assert np.all(fast.cm_estimate(probe) >= oracle.cm_estimate(probe))

    def test_spacesaving_topk_recall(self, twin_estimates):
        fast, oracle = twin_estimates
        probe = np.arange(KEY_SPACE)
        truth = oracle.cm_estimate(probe)
        true_top = set(probe[np.argsort(truth)[::-1][:16]].tolist())
        got = set(fast.topk(16)[0].tolist())
        assert len(true_top & got) / 16 >= 0.9

    def test_topk_bounds_bracket_truth(self, twin_estimates):
        fast, oracle = twin_estimates
        keys, upper, err = fast.topk()
        truth = oracle.cm_estimate(keys)
        assert np.all(upper >= truth)
        assert np.all(upper - err <= truth)

    def test_hits_none_gives_nan_hit_fields(self, zipf_stream):
        trace, _ = zipf_stream
        est = T.sketch_trace(trace[:1_000], sketch_cap=16, window_us=100.0,
                             **CPU)
        assert np.isnan(est.ewma_hit_frac)
        assert np.all(np.isnan(est.win_hit_frac))
        assert est.win_done_count.sum() == 1_000

    def test_rejects_degenerate_parameters(self):
        with pytest.raises(ValueError, match="sketch_cap"):
            T.sketch_trace(np.arange(4), sketch_cap=0, **CPU)
        with pytest.raises(ValueError, match="window_us"):
            T.sketch_trace(np.arange(4), sketch_cap=4, window_us=0.0, **CPU)
        with pytest.raises(ValueError, match="window_us"):
            T.sketch_trace_py(np.arange(4), sketch_cap=4, window_us=0.0)
        with pytest.raises(ValueError, match="sketch_cap"):
            T.PyStreamSketch(0)
        with pytest.raises(RuntimeError, match="CUDA"):
            if not torch.cuda.is_available():
                T.sketch_trace(np.arange(4), sketch_cap=4)
            else:
                raise RuntimeError("CUDA is here: the default device runs")

    def test_delayed_hits_count_as_misses(self):
        sk = T.PyStreamSketch(8, window_us=100.0)
        for i in range(10):
            delayed = i % 2 == 1
            sk.arrival(float(i))
            sk.key(i % 2)
            sk.done(float(i), 0, is_hit=not delayed, delayed=delayed)
        est = sk.estimates()
        assert est.win_hit_frac[0] == pytest.approx(0.5)
        assert est.win_delayed_frac[0] == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# The simulators with the sketch: transparency and the reference's bands


def _transparent(base, on, fields):
    for f in fields:
        a, b = getattr(base, f), getattr(on, f)
        assert np.array_equal(np.asarray(a), np.asarray(b),
                              equal_nan=True), f
    assert base.sketches is None and on.sketches is not None


def test_closed_loop_transparent_and_consistent():
    """``tests/test_streaming.py``'s closed-loop cases in one grid: every
    output identical with the sketch on, every completion in one window,
    full windows at the configured hit ratio."""
    net = build("lru", disk_us=100.0)
    kw = dict(n_requests=1_500, seeds=(0,), **CPU)
    base = simulate_network(net, [0.4, 0.7, 0.8], **kw)
    on = simulate_network(net, [0.4, 0.7, 0.8], sketch_cap=8,
                          window_us=1_000.0, **kw)
    _transparent(base, on, ("throughput", "ci95", "delayed_frac"))
    for p, est in zip((0.4, 0.7, 0.8), on.sketches[0]):
        assert est.win_done_count.sum() == 1_500
        full = est.win_done_count > 0.5 * est.win_done_count.max()
        assert abs(np.nanmean(est.win_hit_frac[full]) - p) < 0.05
        assert est.key_count == 0  # no coalescing: no flow keys
        assert 0.0 <= est.ewma_hit_frac <= 1.0


def test_coalescing_transparent_and_keys_the_flows():
    net = build("lru", disk_us=100.0)
    kw = dict(n_requests=1_000, seeds=(0,), coalesce_flows=8, **CPU)
    base = simulate_network(net, [0.5], **kw)
    on = simulate_network(net, [0.5], sketch_cap=16, window_us=1_000.0, **kw)
    _transparent(base, on, ("throughput", "delayed_frac",
                            "branch_throughput", "branch_delayed"))
    est = on.sketches[0][0]
    # every miss arrival at the disk observes one of the 8 flows
    assert est.key_count > 0 and set(est.topk_key.tolist()) <= set(range(8))
    done = est.win_done_count
    assert done.sum() >= 1_000
    run_frac = np.nansum(est.win_delayed_frac * done) / done.sum()
    assert abs(run_frac - float(on.delayed_frac[0])) < 0.05
    assert 0.0 < est.ewma_delayed_frac < 1.0


def test_open_loop_transparent():
    """``tests/test_streaming.py``'s open-loop case, and the same with an
    ON-OFF burst: identical outputs; Poisson windows at the offered rate
    within 25%."""
    net = build("lru", disk_us=100.0)
    kw = dict(seeds=(0,), arrival_rate=0.02, max_in_system=256, **CPU)
    for burst, n in ((None, 1_000), ((0.5, 5_000.0), 500)):
        base = simulate_network(net, [0.6], burst=burst, n_requests=n, **kw)
        on = simulate_network(net, [0.6], burst=burst, n_requests=n,
                              sketch_cap=8, window_us=2_000.0, **kw)
        _transparent(base, on, ("sojourn_mean", "sojourn_p99", "throughput",
                                "class_frac", "drop_frac"))
        est = on.sketches[0][0]
        full = est.win_done_count > 0
        if burst is None:
            assert est.win_arrival_rate[full].mean() == pytest.approx(
                0.02, rel=0.25)
        assert est.win_arrival_rate.sum() * 2_000.0 >= n


def test_cluster_transparent():
    from repro_torch.cluster import cluster_network, simulate_cluster

    model = cluster_network("lru", n_shards=2, mpl=16)
    for flows in (0, 4):
        kw = dict(n_requests=600, seeds=(0,), coalesce_flows=flows, **CPU)
        base = simulate_cluster(model, [0.6], **kw)
        on = simulate_cluster(model, [0.6], sketch_cap=8, window_us=1_000.0,
                              **kw)
        _transparent(base, on, ("throughput", "shard_throughput",
                                "delayed_frac"))
        heat = on.sketches[0][0].shard_heat(model.branch_shard,
                                            model.n_shards)
        assert heat.shape[1] == model.n_shards and heat.sum() > 0


def test_hierarchy_transparent():
    from repro_torch.hierarchy import hierarchy_network
    from repro_torch.hierarchy.sim import simulate_hierarchy

    model = hierarchy_network("lru", "lru", n_clients=2, n_shards=2,
                              mpl=16, disk_us=50.0)
    for flows in (2, 0):
        kw = dict(n_requests=600, seeds=(0,), coalesce_flows=flows, **CPU)
        base = simulate_hierarchy(model, [0.5], **kw)
        on = simulate_hierarchy(model, [0.5], sketch_cap=8,
                                window_us=1_000.0, **kw)
        _transparent(base, on, ("throughput", "delayed_l1_frac",
                                "level_throughput"))
        done = on.sketches[0][0].win_done_count.sum()
        assert 600 <= done <= 600 + 16
        assert (on.sketches[0][0].key_count > 0) == (flows > 0)


@pytest.mark.parametrize("policy,mpl,p,seed", [("lru", 4, 0.3, 0),
                                               ("fifo", 12, 0.8, 1),
                                               ("lru", 12, 0.95, 2)])
def test_property_transparency(policy, mpl, p, seed):
    """``tests/test_properties.py``'s transparency cases, shortened: the
    retained windows are an increasing suffix of the run."""
    net = build(policy, mpl=mpl)
    kw = dict(n_requests=300, seeds=(seed,), **CPU)
    base = simulate_network(net, [p], **kw)
    on = simulate_network(net, [p], sketch_cap=8, window_us=500.0, **kw)
    _transparent(base, on, ("throughput", "delayed_frac"))
    est = on.sketches[0][0]
    assert 0 < est.win_done_count.sum() <= 300
    assert np.all(np.diff(est.window_id) >= 1)


def test_sketch_needs_a_window():
    net = build("lru")
    with pytest.raises(ValueError, match="window_us"):
        simulate_network(net, [0.5], sketch_cap=8, **CPU)
    with pytest.raises(ValueError, match="window_us"):
        simulate_py(net, 0.5, n_requests=50, full=True, sketch_cap=8)
    with pytest.raises(ValueError, match="full=True"):
        simulate_py(net, 0.5, n_requests=50, sketch_cap=8, window_us=5.0)


# ---------------------------------------------------------------------------
# The heapq oracles: the reference's sketches exactly


def _port_network(jnet):
    """The port's copy of a reference ``ClosedNetwork``."""
    from repro_torch.core import queueing as tq

    stations = tuple(tq.Station(**{f.name: getattr(s, f.name)
                                   for f in dataclasses.fields(s)})
                     for s in jnet.stations)
    branches = tuple(tq.Branch(b.name, b.prob, b.visits) for b in jnet.branches)
    return tq.ClosedNetwork(jnet.name, stations, branches, jnet.mpl,
                            jnet.description)


@pytest.mark.parametrize("kw", [
    dict(coalesce_flows=8),
    dict(coalesce_flows=4, coalesce_theta=0.99),
    dict(arrival_rate=0.03, max_in_system=64, coalesce_flows=8),
    dict(arrival_rate=0.03, max_in_system=64, burst=(0.5, 2_000.0)),
])
def test_oracle_sketches_equal_the_reference(kw):
    net = jbuild("lru", disk_us=100.0)
    args = dict(n_requests=1_500, seed=3, full=True, sketch_cap=8,
                window_us=500.0, **kw)
    port = simulate_py(_port_network(net), 0.6, **args)["sketch"]
    ref = jsimulate_py(net, 0.6, **args)["sketch"]
    _same_estimates(port, ref)
    assert port.key_count > 0 or "coalesce_flows" not in kw


def test_tiered_oracle_sketch_equals_the_reference():
    import repro.hierarchy as JH
    import repro_torch.hierarchy as TH

    args = dict(n_requests=1_500, seed=2, coalesce_flows=2, sketch_cap=8,
                window_us=500.0)
    tm = TH.hierarchy_network("lru", "lru", n_clients=2, n_shards=2, mpl=16,
                              disk_us=50.0)
    jm = JH.hierarchy_network("lru", "lru", n_clients=2, n_shards=2, mpl=16,
                              disk_us=50.0)
    port = TH.simulate_hierarchy_py(tm, 0.5, **args)
    ref = JH.simulate_hierarchy_py(jm, 0.5, **args)
    _same_estimates(port.sketches, ref.sketches)
    assert port.sketches.key_count > 0


def test_cluster_oracle_sketch_equals_the_reference():
    import repro.cluster as JC
    import repro_torch.cluster as TC

    def setup(pkg):
        probs = pkg.zipf_key_probs(512, 1.0, seed=0)
        assign = pkg.HashRing(4, vnodes=64, seed=1).assignment(512)
        model = pkg.cluster_network("lru", 4, profile=pkg.ideal_shard_profile(
            assign, probs), disk_us=100.0, mpl=32)
        return model, probs, assign

    args = dict(n_requests=1_500, seed=1, coalesce_flows=4, sketch_cap=32,
                window_us=500.0)
    port = TC.simulate_cluster_py(*setup(TC), 0.6, **args)["sketch"]
    ref = JC.simulate_cluster_py(*setup(JC), 0.6, **args)["sketch"]
    _same_estimates(port, ref)
    # the routed keys themselves, and n_shards * B per-branch lanes
    assert port.key_count >= 1_500
    assert port.win_branch_rate.shape[1] == 4 * len(
        setup(TC)[0].base.branches)


# ---------------------------------------------------------------------------
# drift, residuals, profile: the reference's numpy, rtol 1e-12

STEP = np.concatenate([np.full(30, 0.5), np.full(30, 0.3)])


def _series():
    rng = np.random.default_rng(0)
    noisy = 0.5 + 0.01 * rng.standard_normal(200)
    up = np.concatenate([np.full(30, 0.3), np.full(30, 0.6)])
    nan = STEP.copy()
    nan[10] = np.nan
    return [STEP, noisy, up, nan]


@pytest.mark.parametrize("kw", [dict(), dict(k_slack=0.02, h_threshold=0.2)])
def test_cusum_equals_the_reference(kw):
    for xs in _series():
        assert np.array_equal(Tdrift.cusum_scan(xs, **kw),
                              Jdrift.cusum_scan(xs, **kw))
        a, b = Tdrift.Cusum(**kw), Jdrift.Cusum(**kw)
        assert [a.update(float(x)) for x in xs] == \
            [b.update(float(x)) for x in xs]
        assert vars(a) == pytest.approx(vars(b), rel=1e-12, nan_ok=True)


@pytest.mark.parametrize("kw", [dict(), dict(delta_slack=0.02,
                                             lam_threshold=0.2)])
def test_page_hinkley_equals_the_reference(kw):
    for xs in _series():
        assert np.array_equal(Tdrift.page_hinkley_scan(xs, **kw),
                              Jdrift.page_hinkley_scan(xs, **kw))
        a, b = Tdrift.PageHinkley(**kw), Jdrift.PageHinkley(**kw)
        assert [a.update(float(x)) for x in xs] == \
            [b.update(float(x)) for x in xs]
        assert a.n_alarms == b.n_alarms


def _alarms(alarms):
    return [a.as_dict() for a in alarms]


def _same_alarms(a, b):
    assert len(a) == len(b)
    for x, y in zip(_alarms(a), _alarms(b)):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], float):
                assert x[k] == pytest.approx(y[k], rel=1e-12, nan_ok=True), k
            else:
                assert x[k] == y[k], k


@pytest.mark.parametrize("case", ["bias", "stale", "live", "open"])
def test_residual_monitor_equals_the_reference(case):
    """``tests/test_streaming.py``'s monitor cases through both monitors."""
    tnet, jnet = build("lru", disk_us=100.0), jbuild("lru", disk_us=100.0)
    if case == "bias":
        p_hats = np.full(30, 0.6)
        xs = np.full(30, jnet.mva_throughput(0.6) * 0.85)
    elif case == "stale":
        xs = np.concatenate([np.full(20, jnet.mva_throughput(0.55)),
                             np.full(20, jnet.mva_throughput(0.85))])
        p_hats = np.full(40, 0.55)
    else:
        p_hats = np.concatenate([np.full(20, 0.55), np.full(20, 0.85)])
        xs = np.array([jnet.mva_throughput(p) for p in p_hats])
    mode, lam = "closed", None
    if case == "open":
        mode, lam = "open", np.full(len(p_hats), 0.05)
        xs = 50.0 + 10.0 * np.arange(len(p_hats)) / len(p_hats)
    ids = np.arange(len(xs))
    _same_alarms(
        Tres.ResidualMonitor(tnet, mode=mode).run(ids, p_hats, xs, lam),
        Jres.ResidualMonitor(jnet, mode=mode).run(ids, p_hats, xs, lam))
    a = Tres.ResidualMonitor(tnet, mode=mode)
    b = Jres.ResidualMonitor(jnet, mode=mode)
    rate = None if lam is None else 0.05
    for i in range(3):
        _same_alarms(a.observe(i, 0.6, float(xs[i]), rate,
                               saturation_frac=0.2),
                     b.observe(i, 0.6, float(xs[i]), rate,
                               saturation_frac=0.2))
    assert a.expected(0.7, rate) == pytest.approx(b.expected(0.7, rate),
                                                  rel=1e-12)


def _same_profile(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        np.testing.assert_allclose(np.asarray(x, float), np.asarray(y, float),
                                   rtol=1e-12, err_msg=f.name)


def test_profile_equals_the_reference(zipf_stream, wide_estimates):
    """``tests/test_streaming.py``'s profile cases: masses, hit curves and
    their inverses, the shard and tiered lifts, and the SLO forecast they
    feed, on the port's and on the exact twin's estimates."""
    trace, _ = zipf_stream
    fast, ref_fast = wide_estimates
    oracle = T.sketch_trace_py(trace, sketch_cap=64, window_us=500.0)
    for est in (fast, ref_fast, oracle):
        for ks in (KEY_SPACE, None):
            np.testing.assert_allclose(
                Tprofile.estimate_key_masses(est, ks),
                Jprofile.estimate_key_masses(est, ks), rtol=1e-12)
        tp = Tprofile.observed_profile(est, key_space=KEY_SPACE)
        jp = Jprofile.observed_profile(est, key_space=KEY_SPACE)
        _same_profile(tp, jp)
        lo, hi = tp.p_range()
        assert (lo, hi) == pytest.approx(jp.p_range(), rel=1e-12)
        for p in (lo + 0.1 * (hi - lo), 0.5 * (lo + hi)):
            assert tp.cap_of_p(p) == pytest.approx(jp.cap_of_p(p), rel=1e-12)
        for c in (8, 32, 100):
            assert tp.p_of_cap(c) == pytest.approx(jp.p_of_cap(c), rel=1e-12)
        assign = np.arange(KEY_SPACE) % 4
        ts = tp.shard_profile(assign, n_shards=4)
        js = jp.shard_profile(assign, n_shards=4)
        for f in ("weights", "caps"):
            np.testing.assert_allclose(np.asarray(getattr(ts, f), float),
                                       np.asarray(getattr(js, f), float),
                                       rtol=1e-12)
        for p in (0.3, 0.7):
            np.testing.assert_allclose(ts.shard_p(p), js.shard_p(p),
                                       rtol=1e-12)
        tt = tp.tiered([8, 16, 32], 64.0, assign, n_shards=4)
        jt = jp.tiered([8, 16, 32], 64.0, assign, n_shards=4)
        np.testing.assert_allclose(np.asarray(tt.l1_hit),
                                   np.asarray(jt.l1_hit), rtol=1e-12)
    from repro.latency import slo_forecast as jslo
    from repro_torch.latency import slo_forecast as tslo

    tp = Tprofile.observed_profile(fast, key_space=KEY_SPACE)
    jp = Jprofile.observed_profile(ref_fast, key_space=KEY_SPACE)
    kw = dict(arrival_rate=0.05, slo_us=400.0)
    tf = tslo(build("lru", disk_us=100.0), profile=tp, **kw)
    jf = jslo(jbuild("lru", disk_us=100.0), profile=jp, **kw)
    assert tf.p_star_slo == pytest.approx(jf.p_star_slo, rel=1e-12)
    np.testing.assert_allclose(tf.cap_grid, jf.cap_grid, rtol=1e-12)


class TestObservedProfile:
    """``tests/test_streaming.py``'s profile assertions on the port."""

    def test_exact_twin_recovers_zipf_masses(self, zipf_stream):
        trace, _ = zipf_stream
        oracle = T.sketch_trace_py(trace, sketch_cap=64, window_us=500.0)
        prof = Tprofile.observed_profile(oracle, key_space=KEY_SPACE)
        assert prof.masses.sum() == pytest.approx(1.0)
        counts = np.bincount(trace, minlength=KEY_SPACE)
        emp = counts / counts.sum()
        order = np.argsort(emp)[::-1][:16]
        assert np.allclose(prof.masses[order], emp[order], atol=0.01)

    def test_hit_curve_monotone_and_invertible(self, wide_estimates):
        prof = Tprofile.observed_profile(wide_estimates[0],
                                         key_space=KEY_SPACE)
        assert np.all(np.diff(prof.hit_curve) >= -1e-9)
        lo, hi = prof.p_range()
        for p in (lo + 0.1 * (hi - lo), 0.5 * (lo + hi)):
            assert prof.p_of_cap(prof.cap_of_p(p)) == pytest.approx(
                p, abs=0.02)

    def test_online_curve_tracks_mattson_resweep(self, zipf_stream,
                                                 wide_estimates):
        trace, _ = zipf_stream
        prof = Tprofile.observed_profile(wide_estimates[0],
                                         key_space=KEY_SPACE)
        caps = np.array([32, 64, 128])
        hits, _ = lru_sweep(trace, caps)
        warm = len(trace) // 4
        for i, c in enumerate(caps):
            true_p = float(np.asarray(hits[i][warm:]).mean())
            assert abs(prof.p_of_cap(int(c)) - true_p) <= 0.06, (c, true_p)
