"""The port's tiered-hierarchy prong ``repro_torch.hierarchy`` against
``repro.hierarchy``.

The analytic layer (``model``) is numpy over the port's queueing, policy,
latency and Mattson-sweep copies: profiles, composed networks and their
``MshrSpec`` tables, bounds, MVA, p*, level fractions and the cross-tier
coalescing transform equal the reference's (``==`` or rtol 1e-12).

The tiered simulation runs on the port's counter engine (here the
event-sim kernel's plain version, ``sim_lanes_plain(tiers=...)``), the
reference's on its threefry engine, so they agree within
``tests/test_hierarchy.py``'s bands, at that file's run lengths: X within
rel 0.15, the L1 delayed fraction within 0.08 and the L2 one within
0.05, the level shares within 0.05 of ``level_fractions``, sigma1 within
rel 0.3 of the analytic transform.  Every tiered run of this file is a
lane of ONE plain call (the ``tiered`` fixture).
"""

import numpy as np
import pytest
import torch

import repro.hierarchy as J
import repro_torch.hierarchy as T
from repro.cluster import zipf_key_probs as jzipf_key_probs
from repro.core import build as jbuild
from repro.core.harness import zipf_trace
from repro.core.py_sim import simulate_py as jsimulate_py
from repro_torch.core import (QUEUE, THINK, Branch, ClosedNetwork, MshrSpec,
                              Station)
from repro_torch.core import build as tbuild
from repro_torch.core.py_sim import simulate_py
from repro_torch.core.simspec import compile_network
from repro_torch.core.simulator import simulate_network
from repro_torch.hierarchy.sim import _fold
from repro_torch.kernels import event_sim as tes

RTOL = 1e-12
GRID = (0.0, 0.01, 0.3, 0.5, 0.77, 0.99, 1.0)
KEY_SPACE = 128
SMALL = dict(n_clients=2, n_shards=2, mpl=16, disk_us=50.0)
N_SIM, N_PY, FLOWS = 8_000, 4_000, 2  # tests/test_hierarchy.py's lengths
P_TWIN, P_LEVELS = 0.35, 0.4


def _small(pkg):
    """``tests/test_hierarchy.py``'s ``small_model``."""
    return pkg.hierarchy_network("lru", "lru", **SMALL)


def _fig_profile(pkg):
    """``benchmarks/fig_hierarchy.py``'s Che profile (256 keys, Zipf 0.8,
    2 shards, L2 cap 32)."""
    probs = jzipf_key_probs(256, 0.8, seed=0)
    return pkg.tiered_profile(probs, np.array([4, 8, 16, 32, 64, 96, 128,
                                               176, 224]),
                              l2_cap=32, assign=np.arange(256) % 2,
                              n_shards=2)


# ---------------------------------------------------------------------------
# Profiles: rtol 1e-12
# ---------------------------------------------------------------------------


def _same_profile(a, b):
    for f in ("caps", "l1_hit", "shard_weights", "l2_hit"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=RTOL,
                                   atol=0, err_msg=f)
    assert a.n_shards == b.n_shards and a.p_range() == b.p_range()
    lo, hi = b.p_range()
    for p in np.linspace(lo - 0.05, hi + 0.05, 9):
        for x, y in zip(a.tier_p(p), b.tier_p(p)):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=0)
        assert a.l1_cap(p) == pytest.approx(b.l1_cap(p), rel=RTOL, abs=0)


@pytest.mark.parametrize("theta,cap", [(1.0, 4), (1.0, 32), (0.5, 63),
                                       (0.0, 64), (1.2, 0), (0.9, 200)])
def test_che_hit_equals_the_reference(theta, cap):
    probs = jzipf_key_probs(64, theta, seed=0)
    probs[::7] = 0.0
    np.testing.assert_allclose(T.che_hit(probs, cap), J.che_hit(probs, cap),
                               rtol=RTOL, atol=0)


def test_profiles_equal_the_reference():
    _same_profile(_fig_profile(T), _fig_profile(J))
    probs = jzipf_key_probs(KEY_SPACE, 0.9, seed=0)
    assign = np.arange(KEY_SPACE) % 3
    caps = np.array([4, 16, 48, 96, 200])
    _same_profile(T.tiered_profile(probs, caps, 16, assign),
                  J.tiered_profile(probs, caps, 16, assign))
    trace = zipf_trace(6_000, KEY_SPACE, 0.9, seed=0)
    for kw in (dict(n_clients=2, seed=0),
               dict(n_clients=3, seed=4, warmup_frac=0.1, n_shards=4)):
        _same_profile(
            T.measured_tiered_profile(trace, caps, 16, assign, **kw),
            J.measured_tiered_profile(trace, caps, 16, assign, **kw))
    for args in ((0.5,), (0.3, 3), ([0.2, 0.7],),
                 ([0.4, 0.6], None, [0.25, 0.75])):
        _same_profile(T.TieredProfile.constant(*args),
                      J.TieredProfile.constant(*args))
    with pytest.raises(ValueError):
        T.measured_tiered_profile(np.zeros(0, np.int64), caps, 16, assign,
                                  n_clients=2)
    with pytest.raises(ValueError):
        T.TieredProfile(np.array([1.0, 0.5]), np.array([0.1, 0.2]),
                        np.full((2, 1), 1.0), np.zeros((2, 1)))


# ---------------------------------------------------------------------------
# Composition, MshrSpec and analytics: == or rtol 1e-12
# ---------------------------------------------------------------------------


def _same_network(a, b, grid=GRID):
    assert (a.name, a.mpl, a.description) == (b.name, b.mpl, b.description)
    assert [(s.name, s.kind, s.servers, s.dist, s.bound, s.dist_params)
            for s in a.stations] == [(s.name, s.kind, s.servers, s.dist,
                                      s.bound, s.dist_params)
                                     for s in b.stations]
    assert [(x.name, x.visits) for x in a.branches] == \
        [(x.name, x.visits) for x in b.branches]
    for p in grid:
        np.testing.assert_allclose([s.mean_service(p) for s in a.stations],
                                   [s.mean_service(p) for s in b.stations],
                                   rtol=RTOL, atol=0)
        np.testing.assert_allclose([x.probability(p) for x in a.branches],
                                   [x.probability(p) for x in b.branches],
                                   rtol=RTOL, atol=1e-300)


def _same_model(a, b):
    _same_network(a.network, b.network)
    assert (a.l1.name, a.l2.name, a.n_clients, a.n_shards) == \
        (b.l1.name, b.l2.name, b.n_clients, b.n_shards)
    assert (a.branch_client, a.branch_shard, a.branch_level) == \
        (b.branch_client, b.branch_shard, b.branch_level)
    assert isinstance(a.mshr, MshrSpec)
    for f in ("acq_group", "acq_slot", "rel_slot"):
        x, y = getattr(a.mshr, f), getattr(b.mshr, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.mshr.n_groups, a.mshr.max_held) == (b.mshr.n_groups,
                                                  b.mshr.max_held)


MODELS = [
    ("small", lambda pkg: _small(pkg)),
    ("fig-lru", lambda pkg: pkg.hierarchy_network(
        "lru", "lru", n_clients=3, n_shards=2, profile=_fig_profile(pkg),
        disk_us=100.0, mpl=96)),
    ("fig-fifo", lambda pkg: pkg.hierarchy_network(
        "fifo", "lru", n_clients=3, n_shards=2, profile=_fig_profile(pkg),
        disk_us=100.0, mpl=96)),
    ("clock-slru", lambda pkg: pkg.hierarchy_network(
        "clock", "slru", n_clients=1, n_shards=3,
        profile=pkg.TieredProfile.constant([0.3, 0.5, 0.7]), disk_us=80.0,
        disk_servers=4, l1_kwargs=dict(mpl=24),
        l2_kwargs=dict(cores=4))),
]


@pytest.mark.parametrize("name,make", MODELS, ids=[m[0] for m in MODELS])
def test_composed_hierarchy_equals_the_reference(name, make):
    tm, jm = make(T), make(J)
    tm.network.validate()
    _same_model(tm, jm)
    tm.mshr.validate(compile_network(tm.network, 0.5,
                                     device="cpu").visits.numpy())
    grid = np.linspace(0.05, 0.95, 7)
    for tail in ("zero", "nominal"):
        np.testing.assert_allclose(tm.throughput_upper(grid, tail_mode=tail),
                                   jm.throughput_upper(grid, tail_mode=tail),
                                   rtol=RTOL, atol=0)
        np.testing.assert_allclose(tm.lambda_max(grid, tail_mode=tail),
                                   jm.lambda_max(grid, tail_mode=tail),
                                   rtol=RTOL, atol=0)
    np.testing.assert_allclose(tm.mva_throughput(grid),
                               jm.mva_throughput(grid), rtol=RTOL, atol=0)
    assert tm.p_star(grid=501) == pytest.approx(jm.p_star(grid=501),
                                                rel=RTOL, abs=0)
    for p in GRID:
        np.testing.assert_allclose(tm.level_fractions(p),
                                   jm.level_fractions(p), rtol=RTOL,
                                   atol=1e-300)
    lam = 0.4 * float(jm.lambda_max(0.6, tail_mode="nominal"))
    assert tm.response_time(0.6, lam) == pytest.approx(
        jm.response_time(0.6, lam), rel=RTOL, abs=0)


def test_fig_hierarchy_p_star_equals_the_reference():
    """fig_hierarchy B's tier-aware p* on its own grid (4001 points)."""
    for policy in ("lru", "fifo"):
        tm, jm = (pkg.hierarchy_network(policy, "lru", n_clients=3,
                                        n_shards=2, profile=_fig_profile(pkg),
                                        disk_us=100.0, mpl=96)
                  for pkg in (T, J))
        assert tm.p_star(grid=4001) == pytest.approx(jm.p_star(grid=4001),
                                                     rel=RTOL, abs=0)


def test_tier_spec_and_compose_errors_are_the_reference_errors():
    bare = ClosedNetwork(
        "bare", (Station("lookup", THINK, 0.5), Station("disk", THINK, 50.0)),
        (Branch("hit", lambda p: p, ("lookup",)),
         Branch("miss", lambda p: 1.0 - p, ("lookup", "disk"))), mpl=8)
    with pytest.raises(ValueError, match="disk"):
        T.compose_tiers(T.TierSpec(policy="lru", n_instances=2),
                        T.TierSpec(net=bare, n_instances=2, name="l2"))
    with pytest.raises(ValueError, match="policy or a net"):
        T.TierSpec(name="x").build()
    with pytest.raises(ValueError, match="shards"):
        T.compose_tiers(T.TierSpec("lru", 2),
                        T.TierSpec("lru", 2, name="l2"),
                        profile=T.TieredProfile.constant(0.5, n_shards=3))
    with pytest.raises(ValueError, match="n_instances"):
        T.compose_tiers(T.TierSpec("lru", 0), T.TierSpec("lru", 1, name="l2"))
    # an explicit tier network, as the serving engine passes its own
    _same_model(T.compose_tiers(T.TierSpec(net=tbuild("clock"), n_instances=2),
                                T.TierSpec("fifo", 2, name="l2"), mpl=40),
                J.compose_tiers(J.TierSpec(net=jbuild("clock"), n_instances=2),
                                J.TierSpec("fifo", 2, name="l2"), mpl=40))


def test_coalesced_hierarchy_equals_the_reference():
    tm, jm = _small(T), _small(J)
    grid = (0.2, 0.35, 0.9)
    for kw in (dict(flows=2), dict(flows=4, window_us=80.0, flow_theta=0.5)):
        a, b = T.coalesced_hierarchy(tm, **kw), J.coalesced_hierarchy(jm, **kw)
        _same_network(a, b, grid=grid)
        for p in grid:
            for x, y in zip(T.tier_sigma_of(a, p), J.tier_sigma_of(b, p)):
                np.testing.assert_allclose(x, y, rtol=RTOL, atol=0)
    _same_network(tm.coalesced(flows=2), jm.coalesced(flows=2), grid=grid)
    assert T.tier_sigma_of(tm.network, 0.5) == (0.0, 0.0)


# ---------------------------------------------------------------------------
# MshrSpec.validate: each of its errors
# ---------------------------------------------------------------------------


def _mshr(ag, asl, rs, n_groups=2, max_held=2):
    return MshrSpec(np.array(ag, np.int32), np.array(asl, np.int32),
                    np.array(rs, np.int32), n_groups, max_held)


@pytest.mark.parametrize("spec,match", [
    (_mshr([[-1, 0, -1]], [[-1, 0, -1]], [[-1, -1, 0]]), None),
    (_mshr([[-1, 0]], [[-1, 0]], [[-1, 0]]), "do not match"),
    (_mshr([[-1, 0, -1]], [[-1, -1, -1]], [[-1, -1, 0]]), "same positions"),
    (_mshr([[-1, 2, -1]], [[-1, 0, -1]], [[-1, -1, 0]]), "out of range"),
    (_mshr([[-1, 0, -1]], [[-1, 2, -1]], [[-1, -1, 0]]), "out of range"),
    (_mshr([[-1, 0, -1]], [[-1, 0, -1]], [[-1, -1, 2]]), "out of range"),
    (_mshr([[0, -1, -1]], [[0, -1, -1]], [[-1, -1, 0]]), "first visit"),
    (_mshr([[-1, 0, -1]], [[-1, 0, -1]], [[-1, -1, 1]]), "!= released"),
    (_mshr([[-1, -1, 0]], [[-1, -1, 0]], [[-1, 0, -1]]), "before its acquire"),
])
def test_mshr_validate_raises_as_the_reference(spec, match):
    from repro.core.simspec import MshrSpec as JMshrSpec

    visits = np.zeros((1, 3), np.int32)
    jspec = JMshrSpec(*spec)
    if match is None:
        spec.validate(visits)
        jspec.validate(visits)
        return
    with pytest.raises(ValueError, match=match) as got:
        spec.validate(visits)
    with pytest.raises(ValueError) as want:
        jspec.validate(visits)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The simulations
# ---------------------------------------------------------------------------


def test_uncoalesced_run_is_the_counting_grid():
    """``coalesce_flows=0``: the plain closed loop with per-branch counts,
    exactly the port's own ``simulate_grid(count_branches=True)``."""
    m = _small(T)
    res = T.simulate_hierarchy(m, [0.3, 0.6], n_requests=600, seeds=(0, 1),
                               device="cpu")
    grid = tes.simulate_grid(m.network, [0.3, 0.6], n_requests=600,
                             seeds=(0, 1), count_branches=True, device="cpu")
    np.testing.assert_array_equal(res.throughput, grid.throughput)
    np.testing.assert_array_equal(res.ci95, grid.ci95)
    level = np.asarray(m.branch_level)
    for lv in range(3):
        np.testing.assert_array_equal(
            res.level_throughput[:, lv],
            grid.branch_throughput[:, level == lv].sum(axis=1))
    assert np.all(res.delayed_frac == 0.0)
    assert np.all(res.delayed_l1_frac == 0.0) and np.all(
        res.delayed_l2_frac == 0.0)
    np.testing.assert_allclose(res.level_throughput.sum(axis=1),
                               res.throughput, rtol=1e-6)
    np.testing.assert_allclose(res.shard_throughput.sum(axis=1),
                               res.level_throughput[:, 1:].sum(axis=1),
                               rtol=1e-12)


def test_simulate_hierarchy_is_the_batched_run():
    """``simulate_hierarchy`` on the CPU equals its lanes run inside a
    padded batch with another network (what the ``tiered`` fixture
    runs)."""
    m = _small(T)
    other = T.hierarchy_network("fifo", "lru", n_clients=3, n_shards=2,
                                mpl=16)
    got = T.simulate_hierarchy(m, [0.5], n_requests=400, seeds=(0, 1),
                               coalesce_flows=FLOWS, device="cpu")
    want = _tiered_runs([(other, 0.5, (0,)), (m, 0.5, (0, 1))], 400)[1]
    for f in ("throughput", "ci95", "level_throughput", "shard_throughput",
              "delayed_frac", "delayed_l1_frac", "delayed_l2_frac"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def _tiered_runs(cells, n_requests, flows=FLOWS):
    """``simulate_hierarchy(m, [p], n_requests, seeds,
    coalesce_flows=flows)`` of every ``(m, p, seeds)`` cell, all lanes of
    ONE plain call (lane seeds ``s * 1000``, as the grid of one p gives
    them)."""
    dev = torch.device("cpu")
    specs, seeds, mshrs = [], [], []
    for m, p, ss in cells:
        specs += [compile_network(m.network, p, device=dev)] * len(ss)
        seeds += [1000 * s for s in ss]
        mshrs += [m.mshr] * len(ss)
    spec, seed_t, kw = tes.pad_lanes(specs, seeds, n_requests, 0.25)
    tiers = tes.lane_tiers(mshrs, *spec.visits.shape[1:], dev)
    out = tes.sim_lanes(spec, seed_t, n_flows=flows, tiers=tiers, **kw)
    res, lane = [], 0
    for m, p, ss in cells:
        part = tes.LaneOutputs(*(f[lane:lane + len(ss)]
                                 if isinstance(f, torch.Tensor) else f
                                 for f in out))
        part = part._replace(delayed_tier=part.delayed_tier[:, :m.mshr.max_held])
        r = tes._grid_result(part, np.array([p]), len(ss),
                             len(m.network.branches), n_requests)
        res.append(_fold(m, r.p_hit, r.throughput, r.ci95,
                         r.branch_throughput, r.delayed_frac,
                         r.delayed_tier_frac, n_requests))
        lane += len(ss)
    return res


@pytest.fixture(scope="module")
def tiered():
    """The port's runs of ``tests/test_hierarchy.py`` (one plain call), the
    reference's ``simulate_hierarchy`` and both oracles."""
    tm, jm = _small(T), _small(J)
    twin, levels = _tiered_runs([(tm, P_TWIN, (0, 1)),
                                 (tm, P_LEVELS, (0,))], N_SIM)
    ref = J.simulate_hierarchy(jm, [P_TWIN], n_requests=N_SIM, seeds=(0, 1),
                               coalesce_flows=FLOWS)
    oracle = T.simulate_hierarchy_py(tm, P_TWIN, n_requests=N_PY, seed=2,
                                     coalesce_flows=FLOWS)
    joracle = J.simulate_hierarchy_py(jm, P_TWIN, n_requests=N_PY, seed=2,
                                      coalesce_flows=FLOWS)
    return dict(model=tm, twin=twin, levels=levels, ref=ref, oracle=oracle,
                joracle=joracle)


def _twin_bands(a, b):
    """``tests/test_hierarchy.py::test_tiered_twins_agree``'s bands."""
    assert a.throughput[0] == pytest.approx(b.throughput[0], rel=0.15)
    assert a.delayed_l1_frac[0] == pytest.approx(b.delayed_l1_frac[0],
                                                 abs=0.08)
    assert a.delayed_l2_frac[0] == pytest.approx(b.delayed_l2_frac[0],
                                                 abs=0.05)


def test_oracle_equals_the_reference_oracle(tiered):
    got, want = tiered["oracle"], tiered["joracle"]
    for f in ("throughput", "level_throughput", "shard_throughput",
              "delayed_frac", "delayed_l1_frac", "delayed_l2_frac"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("against", ["oracle", "ref"])
def test_tiered_twins_agree(tiered, against):
    """The port against the heapq oracle and against the reference's
    threefry simulation, in the reference test's bands; the tier split
    partitions the delayed mass on every side."""
    port = tiered["twin"]
    _twin_bands(port, tiered[against])
    _twin_bands(tiered["ref"], tiered["oracle"])
    for r in (port, tiered[against]):
        assert r.delayed_frac[0] == pytest.approx(
            r.delayed_l1_frac[0] + r.delayed_l2_frac[0], abs=1e-6)
        assert r.delayed_l1_frac[0] > r.delayed_l2_frac[0] > 0.0


def test_tiered_sim_levels_match_analytic(tiered):
    res, m = tiered["levels"], tiered["model"]
    frac = res.level_throughput[0] / res.throughput[0]
    np.testing.assert_allclose(frac, m.level_fractions(P_LEVELS), atol=0.05)
    np.testing.assert_allclose(res.shard_throughput[0].sum(),
                               res.level_throughput[0, 1:].sum(), rtol=1e-6)
    np.testing.assert_allclose(res.level_throughput[0].sum(),
                               res.throughput[0], rtol=1e-6)


def test_coalesced_sigma_tracks_sim(tiered):
    s1, _ = T.tier_sigma_of(tiered["model"].coalesced(flows=FLOWS), P_TWIN)
    sim_s1 = tiered["twin"].delayed_l1_frac[0] / (1.0 - P_TWIN)
    assert s1 == pytest.approx(sim_s1, rel=0.3)


def test_delayed_tier_partitions_the_delayed_hits(tiered):
    """Per lane, the per-level delayed fractions sum to the delayed
    fraction and the per-branch delayed rates to it times X (the
    reference's accounting)."""
    for r in (tiered["twin"], tiered["levels"]):
        np.testing.assert_allclose(r.delayed_l1_frac + r.delayed_l2_frac,
                                   r.delayed_frac, atol=1e-6)
        assert np.all(r.delayed_l2_frac >= 0) and np.all(r.delayed_frac < 1)


def test_a_job_reacquiring_the_entry_it_fills_leads_it():
    """One job, whose route fills an entry at position 1 and acquires the
    same entry (group 0, its request's flow) at position 2, in the same
    event: the freed entry must read free, so the job leads again and
    never parks (a park behind its own fill would strand it)."""
    net = ClosedNetwork(
        "refill", (Station("think", THINK, 1.0), Station("a", QUEUE, 0.3),
                   Station("disk", THINK, 0.2)),
        (Branch("x", lambda p: 1.0, ("think", "a", "disk")),), mpl=1)
    mshr = _mshr([[-1, 0, 0]], [[-1, 0, 0]], [[-1, 0, 0]], n_groups=1,
                 max_held=1)
    res = simulate_network(net, [0.5], n_requests=300, seeds=(0,),
                           coalesce_flows=1, tiers=mshr, device="cpu")
    assert res.delayed_frac[0] == 0.0 and res.throughput[0] > 0.0
    np.testing.assert_array_equal(res.delayed_tier_frac, [[0.0]])
    py = simulate_py(net, 0.5, n_requests=300, coalesce_flows=1, tiers=mshr,
                     full=True)
    want = jsimulate_py(net, 0.5, n_requests=300, coalesce_flows=1,
                        tiers=mshr, full=True)
    assert py["delayed"] == want["delayed"] == 0


def test_simulate_network_refusals():
    m = _small(T)
    with pytest.raises(ValueError, match="closed loop"):
        simulate_network(m.network, [0.5], n_requests=500, tiers=m.mshr,
                         coalesce_flows=2, arrival_rate=0.5, device="cpu")
    traced = simulate_network(m.network, [0.5], n_requests=500,
                              seeds=(0,), tiers=m.mshr, coalesce_flows=2,
                              trace=8, device="cpu")
    assert len(traced.traces) == 1 and len(traced.traces[0][0]) == 8
    with pytest.raises(ValueError, match="do not match"):
        simulate_network(m.network, [0.5], n_requests=500,
                         tiers=_mshr([[-1]], [[-1]], [[-1]]),
                         coalesce_flows=2, device="cpu")
    with pytest.raises(ValueError, match="window_us"):
        T.simulate_hierarchy(m, [0.5], n_requests=50, sketch_cap=8,
                             device="cpu")
    with pytest.raises(ValueError, match="n_flows > 0"):
        spec, seeds, kw = tes.grid_lanes(m.network, [0.5], 50, (0,), 0.25,
                                         torch.device("cpu"))
        tes.sim_lanes(spec, seeds, tiers=tes.lane_tiers(
            [m.mshr], *spec.visits.shape[1:], "cpu"), **kw)
