"""The port's cluster prong ``repro_torch.cluster`` against ``repro.cluster``.

Routing (``hashing``) is integer-exact numpy, so every function must
equal the reference's exactly.  The analytic layer (``model``) is numpy
over the port's queueing, latency and Mattson-sweep copies: profiles,
composed networks, bounds, MVA, lambda_max and response times within
rtol 1e-12.  The key-routing heapq oracle ``simulate_cluster_py`` draws
in the reference's order and must equal the reference's oracle exactly.

The simulated cluster runs on the port's counter engine (the event-sim
kernel's plain version here), the reference's on its threefry engine, so
they agree within ``tests/test_cluster.py``'s bands: 12% on X, 0.06 on
the traffic-weighted per-shard hit and delayed gaps, 0.08 on the
oracle's emergent shard shares and rtol 0.02 on the shard sum, at that
file's run lengths, for LRU, FIFO and CLOCK at Zipf theta 1 on 4 shards,
with 8 flows per shard and without coalescing (the counting kernel's
plain version).  Every such run of one coalescing setting is a lane of
ONE plain call (``_port_runs``); the 12-case matrix and the 16-shard cases
run on the card (``chip_smoke.py``'s ``cluster_differential``).
"""

import numpy as np
import pytest
import torch

import repro.cluster as J
import repro_torch.cluster as T
from repro.cluster import hashing as jhashing
from repro.core.harness import zipf_trace
from repro_torch.cluster import hashing as thashing
from repro_torch.cluster.sim import _shard_result
from repro_torch.core.simspec import compile_network, stack_specs
from repro_torch.kernels import event_sim as tes

KEY_SPACE = 1024
P_OP = 0.6  # tests/test_cluster.py's global operating point
N_PORT, N_PY = 9_000, 7_000  # its run lengths: simulator, oracle
SEEDS = (0, 1)
POLICIES = ("lru", "fifo", "clock")


def _setup(pkg, n_shards, theta=1.0, key_space=KEY_SPACE):
    probs = pkg.zipf_key_probs(key_space, theta, seed=0)
    assign = pkg.HashRing(n_shards, vnodes=64, seed=1).assignment(key_space)
    return probs, assign, pkg.ideal_shard_profile(assign, probs)


def _models(policy, n_shards, theta=1.0, **kw):
    """(port model, reference model, key probs, assignment) of
    ``tests/test_cluster.py``'s differential."""
    tp, ta, tprof = _setup(T, n_shards, theta)
    jp, ja, jprof = _setup(J, n_shards, theta)
    kw = dict(profile=None, disk_us=100.0, mpl=12 * n_shards, **kw)
    tm = T.cluster_network(policy, n_shards, **{**kw, "profile": tprof})
    jm = J.cluster_network(policy, n_shards, **{**kw, "profile": jprof})
    return tm, jm, tp, ta


# ---------------------------------------------------------------------------
# Hashing: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards,vnodes,seed", [(1, 8, 0), (4, 64, 1),
                                                   (8, 32, 3), (16, 64, 7)])
def test_ring_equals_the_reference(n_shards, vnodes, seed):
    t = T.HashRing(n_shards, vnodes=vnodes, seed=seed)
    j = J.HashRing(n_shards, vnodes=vnodes, seed=seed)
    np.testing.assert_array_equal(t._pos, j._pos)
    np.testing.assert_array_equal(t._owner, j._owner)
    for ks in (1, 1000, 4096):
        a, b = t.assignment(ks), j.assignment(ks)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert t.shard_of(12345) == j.shard_of(12345)
    assert isinstance(t.shard_of(12345), int)
    if n_shards > 1:
        np.testing.assert_array_equal(t.without(0).assignment(2048),
                                      j.without(0).assignment(2048))
        np.testing.assert_array_equal(
            t.without(0).with_shard(99).assignment(2048),
            j.without(0).with_shard(99).assignment(2048))
    np.testing.assert_array_equal(
        thashing._mix64(np.arange(-5, 5000)), jhashing._mix64(np.arange(-5, 5000)))


def test_ring_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        T.HashRing(2, shards=(1, 1))
    with pytest.raises(KeyError):
        T.HashRing(4).without(9)


@pytest.mark.parametrize("theta,n_shards,seed", [(0.0, 8, 1), (1.0, 8, 1),
                                                  (0.8, 16, 4), (1.2, 3, 0)])
def test_placement_functions_equal_the_reference(theta, n_shards, seed):
    probs = J.zipf_key_probs(4096, theta, seed=0)
    np.testing.assert_array_equal(T.zipf_key_probs(4096, theta, seed=0), probs)
    tc = T.two_choice_assignment(probs, n_shards, seed=seed)
    np.testing.assert_array_equal(tc, J.two_choice_assignment(probs, n_shards,
                                                              seed=seed))
    ring = J.HashRing(n_shards, vnodes=64, seed=seed).assignment(4096)
    for assign in (tc, ring):
        w = T.shard_weights(assign, probs, n_shards)
        np.testing.assert_array_equal(w, J.shard_weights(assign, probs,
                                                         n_shards))
        assert T.imbalance(w) == J.imbalance(w)
    trace = zipf_trace(5_000, 4096, theta, seed=seed)
    got = T.partition_trace(trace, ring)
    want = J.partition_trace(trace, ring)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        T.two_choice_assignment(-probs, n_shards)
    with pytest.raises(ValueError):
        T.shard_weights(ring, np.zeros(4096), n_shards)


# ---------------------------------------------------------------------------
# Analytic model: rtol 1e-12
# ---------------------------------------------------------------------------

RTOL = 1e-12
GRID = (0.0, 0.2, 0.45, 0.6, 0.8, 0.95, 1.0)


def _same_profile(a, b):
    for f in ("weights", "caps", "shard_hit"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=RTOL,
                                   atol=1e-15, err_msg=f)
    for p in GRID:
        np.testing.assert_allclose(a.shard_p(p), b.shard_p(p), rtol=RTOL,
                                   atol=1e-15)
    assert a.p_range() == pytest.approx(b.p_range(), rel=RTOL)
    assert a.imbalance() == pytest.approx(b.imbalance(), rel=RTOL)


def test_profiles_equal_the_reference():
    _same_profile(T.uniform_profile(5), J.uniform_profile(5))
    tp, ta, tprof = _setup(T, 8, key_space=4096)
    _, _, jprof = _setup(J, 8, key_space=4096)
    _same_profile(tprof, jprof)
    caps = np.array([0.0, 4.0, 16.0, 64.0, 200.0])
    _same_profile(T.ideal_shard_profile(ta, tp, caps=caps, n_shards=9),
                  J.ideal_shard_profile(ta, tp, caps=caps, n_shards=9))
    trace = zipf_trace(20_000, 4096, 1.0, seed=0)
    _same_profile(T.measured_shard_profile(trace, ta),
                  J.measured_shard_profile(trace, ta))
    _same_profile(T.measured_shard_profile(trace, ta, caps=caps,
                                           warmup_frac=0.1),
                  J.measured_shard_profile(trace, ta, caps=caps,
                                           warmup_frac=0.1))
    with pytest.raises(ValueError):
        T.ShardProfile(np.array([0.5, 0.6]), np.array([0.0, 1.0]),
                       np.zeros((2, 2)))
    with pytest.raises(ValueError):
        T.measured_shard_profile(np.zeros(0, np.int64), ta)


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
                                   rtol=RTOL)
        np.testing.assert_allclose([x.probability(p) for x in a.branches],
                                   [x.probability(p) for x in b.branches],
                                   rtol=RTOL, atol=1e-15)


@pytest.mark.parametrize("policy,n_shards,skewed,kw", [
    ("lru", 4, False, {}),
    ("lru", 8, True, {}),
    ("fifo", 8, True, dict(disk_servers=8)),
    ("clock", 4, True, dict(cores=16, mpl=40)),
    ("s3fifo", 16, True, dict(mpl=192)),
])
def test_composed_cluster_equals_the_reference(policy, n_shards, skewed, kw):
    if skewed:
        tprof = _setup(T, n_shards, key_space=4096)[2]
        jprof = _setup(J, n_shards, key_space=4096)[2]
    else:
        tprof = jprof = None
    tm = T.cluster_network(policy, n_shards, profile=tprof, disk_us=100.0,
                           **kw)
    jm = J.cluster_network(policy, n_shards, profile=jprof, disk_us=100.0,
                           **kw)
    tm.network.validate()
    _same_network(tm.network, jm.network)
    assert (tm.branch_shard, tm.branch_has_disk, tm.n_shards) == \
        (jm.branch_shard, jm.branch_has_disk, jm.n_shards)
    grid = np.linspace(0.05, 0.95, 7)
    for name in ("throughput_upper", "lambda_max"):
        for tail in ("zero", "nominal"):
            np.testing.assert_allclose(
                getattr(tm, name)(grid, tail_mode=tail),
                getattr(jm, name)(grid, tail_mode=tail), rtol=RTOL,
                err_msg=f"{name} {tail}")
    np.testing.assert_allclose(tm.shard_throughput_upper(0.6),
                               jm.shard_throughput_upper(0.6), rtol=RTOL)
    assert tm.p_star(grid=501) == pytest.approx(jm.p_star(grid=501),
                                                rel=RTOL)
    np.testing.assert_allclose(tm.mva_throughput(grid),
                               jm.mva_throughput(grid), rtol=RTOL)
    np.testing.assert_allclose(tm.ideal_lambda_max(grid[:3]),
                               jm.ideal_lambda_max(grid[:3]), rtol=RTOL)
    lam = 0.4 * float(jm.lambda_max(0.6, tail_mode="nominal"))
    for p in (0.3, 0.6):
        assert tm.response_time(p, lam) == pytest.approx(
            jm.response_time(p, lam), rel=RTOL)
    _same_network(tm.coalesced(flows=8), jm.coalesced(flows=8),
                  grid=(0.2, 0.6, 0.9))


def test_compose_cluster_rejects_a_mismatched_profile():
    with pytest.raises(ValueError):
        T.cluster_network("lru", 4, profile=T.uniform_profile(8))


# ---------------------------------------------------------------------------
# The key-routing oracle: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy,n_shards,theta,flows,seed", [
    ("lru", 1, 0.0, 8, 3),
    ("lru", 4, 1.0, 8, 3),
    ("fifo", 4, 0.0, 0, 4),
    ("clock", 16, 1.0, 8, 3),
    ("lru", 4, 1.0, 16, 5),
])
def test_oracle_equals_the_reference(policy, n_shards, theta, flows, seed):
    tm, jm, probs, assign = _models(policy, n_shards, theta)
    kw = dict(n_requests=5_000, seed=seed, coalesce_flows=flows,
              coalesce_theta=0.5 if seed == 5 else 0.0)
    got = T.simulate_cluster_py(tm, probs, assign, P_OP, **kw)
    want = J.simulate_cluster_py(jm, probs, assign, P_OP, **kw)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
            continue
        a, b = np.asarray(got[k]), np.asarray(v)
        assert a.dtype == b.dtype, k
        assert np.array_equal(a, b, equal_nan=True), k


# ---------------------------------------------------------------------------
# The simulated cluster: the reference's bands
# ---------------------------------------------------------------------------


def _port_runs(models, flows, n_requests, seeds=SEEDS):
    """``simulate_cluster(m, [P_OP], n_requests, seeds, coalesce_flows=
    flows)`` of every model, each cluster's lanes part of ONE plain call
    (lane seeds ``s * 1000``, as the grid of one p gives them; padded
    lanes run as their networks alone)."""
    dev = torch.device("cpu")
    specs, lane_seeds = [], []
    for m in models:
        specs += [compile_network(m.network, P_OP, device=dev)] * len(seeds)
        lane_seeds += [1000 * s for s in seeds]
    spec, seed_t, kw = tes.pad_lanes(specs, lane_seeds, n_requests, 0.25)
    if flows:
        kw.update(n_flows=flows, n_disks=models[0].n_shards,
                  disk_rank=stack_specs(specs).disk_rank.to(torch.int32))
    out = tes.sim_lanes(spec, seed_t, count_branches=True, **kw)
    res, n_s = [], len(seeds)
    for i, m in enumerate(models):
        part = tes.LaneOutputs(*(f[i * n_s:(i + 1) * n_s]
                                 if isinstance(f, torch.Tensor) else f
                                 for f in out))
        res.append(_shard_result(m, tes._grid_result(
            part, np.array([P_OP]), n_s, len(m.network.branches),
            n_requests)))
    return res


def test_simulate_cluster_is_the_batched_run():
    """``simulate_cluster`` on the CPU equals its lanes run inside a
    batch of clusters (what the band tests below run)."""
    tm = _models("lru", 4)[0]
    other = _models("fifo", 4)[0]
    for flows in (8, 0):
        got = T.simulate_cluster(tm, [P_OP], n_requests=500, seeds=SEEDS,
                                 coalesce_flows=flows, device="cpu")
        want = _port_runs([other, tm], flows, 500)[1]
        for f in ("throughput", "ci95", "shard_throughput",
                  "shard_hit_ratio", "shard_delayed_frac", "delayed_frac"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)


@pytest.fixture(scope="module")
def differential():
    """The port's runs (one plain call per coalescing setting), the
    reference's ``simulate_cluster`` and the port's oracle (equal to the
    reference's, above) of every policy, at F 8 and 0."""
    models = {pol: _models(pol, 4) for pol in POLICIES}
    out = {}
    for flows in (8, 0):
        runs = _port_runs([models[p][0] for p in POLICIES], flows, N_PORT)
        for pol, port in zip(POLICIES, runs):
            tm, jm, probs, assign = models[pol]
            ref = J.simulate_cluster(jm, [P_OP], n_requests=N_PORT,
                                     seeds=SEEDS, coalesce_flows=flows)
            oracle = T.simulate_cluster_py(tm, probs, assign, P_OP,
                                           n_requests=N_PY, seed=3,
                                           coalesce_flows=flows)
            out[(pol, flows)] = (tm, port, ref, oracle)
    return out


def _within_bands(m, sim, py):
    """``tests/test_cluster.py::_differential``'s assertions of ``sim``
    (a ClusterSimResult) against ``py`` (the oracle's dict)."""
    assert abs(py["x"] - sim.throughput[0]) / py["x"] < 0.12, (
        py["x"], sim.throughput)
    w = m.profile.weights
    hit_gap = np.nansum(w * np.abs(sim.shard_hit_ratio[0]
                                   - py["shard_hit_ratio"]))
    assert hit_gap < 0.06, hit_gap
    assert np.abs(py["shard_share"] - w).max() < 0.08
    del_gap = np.nansum(w * np.abs(sim.shard_delayed_frac[0]
                                   - py["shard_delayed_frac"]))
    assert del_gap < 0.06, del_gap
    assert abs(sim.delayed_frac[0] - py["delayed_frac"]) < 0.06
    np.testing.assert_allclose(sim.shard_throughput[0].sum(),
                               sim.throughput[0], rtol=0.02)


def _as_oracle(res, m):
    """A ClusterSimResult read as the oracle's dict (for the bands)."""
    return {"x": float(res.throughput[0]),
            "shard_hit_ratio": res.shard_hit_ratio[0],
            "shard_delayed_frac": res.shard_delayed_frac[0],
            "shard_share": res.shard_throughput[0] / res.throughput[0],
            "delayed_frac": float(res.delayed_frac[0])}


@pytest.mark.parametrize("flows", [8, 0])
@pytest.mark.parametrize("policy", POLICIES)
def test_simulated_cluster_within_the_bands(differential, policy, flows):
    m, port, ref, oracle = differential[(policy, flows)]
    _within_bands(m, port, oracle)  # the port against the oracle
    _within_bands(m, port, _as_oracle(ref, m))  # and the reference's sim
    _within_bands(m, ref, oracle)  # the bands hold for the reference too
    assert port.delayed_frac[0] > 0.05 if flows else port.delayed_frac[0] == 0


def test_shard_local_coalescing(differential):
    """The hot shard (higher local hit ratio) coalesces less than the
    cold one, as in the reference's test."""
    m, port, _, _ = differential[("lru", 8)]
    pk = m.profile.shard_p(P_OP)
    hot, cold = int(np.argmax(pk)), int(np.argmin(pk))
    assert port.shard_delayed_frac[0, hot] < port.shard_delayed_frac[0, cold]


def test_counts_sum_to_the_measured_completions():
    """The counting variant (plain version): every lane's per-branch counts
    sum to its measured completions, and its events are the closed
    loop's without counts, draw for draw."""
    tm = _models("lru", 4)[0]
    spec, seeds, kw = tes.grid_lanes(tm.network, np.array([0.3, 0.6, 0.9]),
                                     800, (0, 1), 0.25, torch.device("cpu"))
    counted = tes.sim_lanes(spec, seeds, count_branches=True, **kw)
    plain = tes.sim_lanes(spec, seeds, **kw)
    assert plain.branch_done is None
    for f in ("x", "completed", "events", "t_measured"):
        assert torch.equal(getattr(counted, f), getattr(plain, f)), f
    measured = counted.completed - kw["warmup"]
    assert torch.equal(counted.branch_done.sum(dim=1), measured)
    assert int(counted.branch_delayed.abs().sum()) == 0
    assert float(counted.delayed_frac.abs().max()) == 0.0
    assert int((counted.branch_done > 0).sum()) > counted.branch_done.shape[0]


def test_unported_options_raise():
    """Tracing with coalescing runs: ``[seed][p]`` records, the counts
    as untraced; the sketches run: on the simulator with every output as
    without them, on the oracle equal to the reference oracle's."""
    tm, jm, probs, assign = _models("lru", 2)
    co = dict(n_requests=50, seeds=(0, 1), coalesce_flows=4, device="cpu")
    traced = T.simulate_cluster(tm, [0.5], trace=8, **co)
    assert len(traced.traces) == 2 and len(traced.traces[0]) == 1
    assert all(len(t[0]) == 8 for t in traced.traces)
    np.testing.assert_array_equal(traced.shard_throughput,
                                  T.simulate_cluster(tm, [0.5], **co)
                                  .shard_throughput)
    with pytest.raises(ValueError, match="window_us"):
        T.simulate_cluster(tm, [0.5], n_requests=50, sketch_cap=8,
                           device="cpu")
    kw = dict(n_requests=200, seeds=(0,), device="cpu")
    on = T.simulate_cluster(tm, [0.5], sketch_cap=8, window_us=50.0, **kw)
    bare = T.simulate_cluster(tm, [0.5], **kw)
    np.testing.assert_array_equal(on.shard_throughput, bare.shard_throughput)
    assert bare.sketches is None and on.sketches[0][0].win_done_count.sum() \
        == 200
    args = dict(n_requests=300, sketch_cap=4, window_us=5.0)
    port = T.simulate_cluster_py(tm, np.full(KEY_SPACE, 1.0 / KEY_SPACE),
                                 np.zeros(KEY_SPACE, np.int64), 0.5,
                                 **args)["sketch"]
    ref = J.simulate_cluster_py(jm, np.full(KEY_SPACE, 1.0 / KEY_SPACE),
                                np.zeros(KEY_SPACE, np.int64), 0.5,
                                **args)["sketch"]
    assert port.key_count == ref.key_count >= 300
    assert np.array_equal(port.topk_key, ref.topk_key)
    assert np.array_equal(port.win_branch_rate, ref.win_branch_rate)


def test_traced_cluster_keeps_its_counts():
    """Traced without coalescing: the records of the traced kernel's
    plain version and the per-shard counts of the same run."""
    tm = _models("fifo", 2)[0]
    kw = dict(n_requests=400, seeds=(0,), device="cpu")
    traced = T.simulate_cluster(tm, [0.5], trace=64, **kw)
    untraced = T.simulate_cluster(tm, [0.5], **kw)
    np.testing.assert_array_equal(traced.shard_throughput,
                                  untraced.shard_throughput)
    rec = traced.traces[0][0]
    assert len(rec.req) == 64 and rec.n_emitted == 400
    assert set(np.asarray(tm.branch_shard)[rec.branch]) <= {0, 1}
