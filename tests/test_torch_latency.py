"""The latency prong in the port: the analytic copies and the open loop.

``repro_torch.latency`` is a numpy copy of ``repro.latency``: on the
networks of ``tests/test_latency.py`` every function must equal the
reference's to rtol 1e-12.

The open loop runs on the port's counter engine (the reference runs it
only on its threefry engine, ``_simulate_open``), so it is held
statistically against that engine and against the heapq oracle
``repro.core.py_sim.simulate_py``, with ``tests/test_latency.py``'s
tolerances, at its run length (10 000 requests; 12 000 under bursts).
Every open-loop run without bursts is one lane of ONE plain call (the
``runs`` fixture), and every burst run one lane of another: the per-event
cost of the plain version is paid twice.  A lane without coalescing gets
no disk ranks, so it coalesces nothing in a call that coalesces.
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from repro import latency as jlat
from repro.core import build as jbuild
from repro.core import exponential_analogue as jexponential_analogue
from repro.core import lru_network as jlru_network
from repro.core.py_sim import simulate_py
from repro.core.queueing import QUEUE as JQUEUE
from repro.core.queueing import THINK as JTHINK
from repro.core.queueing import Branch as JBranch
from repro.core.queueing import ClosedNetwork as JClosedNetwork
from repro.core.queueing import Station as JStation
from repro.core.simulator import simulate_network as jsimulate_network
from repro_torch import latency as tlat
from repro_torch.core import build, exponential_analogue, lru_network
from repro_torch.core.queueing import QUEUE, THINK, Branch, ClosedNetwork, Station
from repro_torch.core.simspec import compile_network, stack_specs
from repro_torch.core.simulator import (CLS_DELAYED, OpenSimResult,
                                        open_result, simulate_network)
from repro_torch.kernels import event_sim as tes

RTOL = 1e-12


def _same(a, b, what=""):
    """Equal structures: floats and arrays to rtol 1e-12 (inf and nan in
    the same places), everything else exactly."""
    if isinstance(b, dict):
        assert a.keys() == b.keys(), what
        for k in b:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif dataclasses.is_dataclass(b):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(b):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(b, (float, np.ndarray, np.floating)) and not isinstance(b, bool):
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                   rtol=RTOL, err_msg=what)
    else:
        assert a == b, what


def _mm(mod_q, mod_t, station, branch, network, servers):
    return network(
        f"mm{servers}",
        (station("z", mod_t, 0.0),
         station("q", mod_q, 2.0 if servers == 1 else 1.0, dist="exp",
                 servers=servers)),
        (branch("all", 1.0, ("z", "q")),), mpl=1)


def _pairs():
    """(name, port network, reference network) of tests/test_latency.py."""
    pairs = [(f"mm{c}", _mm(QUEUE, THINK, Station, Branch, ClosedNetwork, c),
              _mm(JQUEUE, JTHINK, JStation, JBranch, JClosedNetwork, c))
             for c in (1, 2)]
    for policy in ("lru", "fifo", "s3fifo"):
        kw = dict(disk_us=100.0, disk_servers=4)
        pairs.append((f"{policy}-io4", build(policy, **kw),
                      jbuild(policy, **kw)))
    pairs.append(("lru-100", lru_network(disk_us=100.0),
                  jlru_network(disk_us=100.0)))
    pairs.append(("lru-5-exp", exponential_analogue(build("lru", disk_us=5.0)),
                  jexponential_analogue(jbuild("lru", disk_us=5.0))))
    pairs.append(("lru-co16-mva", build("lru", disk_us=500.0, disk_servers=8,
                                        coalesce_flows=16,
                                        coalesce_window_mode="mva"),
                  jbuild("lru", disk_us=500.0, disk_servers=8,
                         coalesce_flows=16, coalesce_window_mode="mva")))
    return pairs


PAIRS = _pairs()
PAIR_IDS = [name for name, _, _ in PAIRS]
GRID = np.linspace(0.0, 1.0, 41)


def test_erlang_c_equals_the_reference():
    for c in range(1, 9):
        for a in np.linspace(0.0, c * 0.999, 23):
            _same(tlat.erlang_c(c, float(a)), jlat.erlang_c(c, float(a)))


@pytest.mark.parametrize("name,tnet,jnet", PAIRS, ids=PAIR_IDS)
def test_analytic_layer_equals_the_reference(name, tnet, jnet):
    """lambda_max, analyze_open (every field and the percentiles of both
    tails), response_time, response_percentile and max_arrival_for_slo."""
    for mode in ("zero", "nominal"):
        _same(tlat.lambda_max(tnet, GRID, tail_mode=mode),
              jlat.lambda_max(jnet, GRID, tail_mode=mode), name)
    lmax = float(np.max(jlat.lambda_max(jnet, GRID)))
    for p in (0.3, 0.7, 0.95):
        for frac in (0.2, 0.6, 0.9, 1.1):
            lam = frac * (lmax if math.isfinite(lmax) else 1.0)
            t, j = tlat.analyze_open(tnet, p, lam), jlat.analyze_open(jnet, p, lam)
            _same(t, j, f"{name} p={p} lam={lam}")
            for q in (0.5, 0.9, 0.99):
                for tail in ("hypo", "exp"):
                    _same(t.percentile(q, tail=tail), j.percentile(q, tail=tail))
    lam = 0.5 * lmax if math.isfinite(lmax) else 0.5
    _same(tlat.response_time(tnet, GRID, lam), jlat.response_time(jnet, GRID, lam))
    _same(tlat.response_percentile(tnet, GRID[::4], lam, q=0.99),
          jlat.response_percentile(jnet, GRID[::4], lam, q=0.99))
    slo = 4.0 * jlat.response_time(jnet, 0.5, 0.0)
    _same(tlat.max_arrival_for_slo(tnet, 0.9, slo),
          jlat.max_arrival_for_slo(jnet, 0.9, slo))


@pytest.mark.parametrize("name,tnet,jnet", PAIRS[2:], ids=PAIR_IDS[2:])
def test_slo_forecast_equals_the_reference(name, tnet, jnet):
    lam = 0.7 * float(np.max(jlat.lambda_max(jnet, GRID)))
    slo = 3.0 * jlat.response_time(jnet, 0.5, lam)
    for q in (0.99, 0.9):
        _same(tlat.slo_forecast(tnet, lam, slo, percentile=q, p_grid=GRID),
              jlat.slo_forecast(jnet, lam, slo, percentile=q, p_grid=GRID),
              name)


def test_observed_response_equals_the_reference():
    rng = np.random.default_rng(3)
    trace = types.SimpleNamespace(sojourn_us=rng.exponential(40.0, 5000),
                                  cls=rng.integers(0, 3, 5000))
    _same(tlat.observed_response(trace), jlat.observed_response(trace))


# ---------------------------------------------------------------------------
# The open loop
# ---------------------------------------------------------------------------

N_REQUESTS = 10_000
N_SLOTS = 256
FLOWS = 16
DISK_TIERS = [
    {"disk_us": 100.0, "disk_servers": 0},  # paper's infinite-server disk
    {"disk_us": 500.0, "disk_servers": 8},  # bounded I/O depth
]
ORACLE_CASES = [(policy, tier) for tier in range(len(DISK_TIERS))
                for policy in ("lru", "fifo", "clock")]
BURST = (0.6, 1_000.0)
BURST_REQUESTS = 12_000


def _det_disk(net):
    return dataclasses.replace(net, stations=tuple(
        dataclasses.replace(s, dist="det") if s.name == "disk" else s
        for s in net.stations))


def _open_rate(net, p, frac):
    return frac * float(tlat.lambda_max(net, p, tail_mode="nominal"))


def _cells():
    """name -> (builder of the network (port or reference), p_hits, rate,
    seeds, coalesce) of every open-loop run without bursts."""
    cells = {}
    for policy, tier in ORACLE_CASES:
        def net(mod, policy=policy, tier=tier):
            return mod.exponential_analogue(mod.build(policy, **DISK_TIERS[tier]))
        cells[(policy, tier)] = (net, [0.7], _open_rate(net(_PORT), 0.7, 0.55),
                                 (0, 1, 2), False)
    low = lambda mod: mod.exponential_analogue(mod.lru_network(disk_us=100.0))
    cells["low"] = (low, [0.4, 0.8], _open_rate(low(_PORT), 0.8, 0.35),
                    (0, 1, 2), False)
    cells["classes"] = (lambda mod: _det_disk(mod.lru_network(
        disk_us=100.0, disk_servers=8)), [0.5], 0.1, (0, 1), True)
    cells["coalesce"] = (lambda mod: mod.exponential_analogue(mod.lru_network(
        disk_us=100.0, disk_servers=8)), [0.5], 0.1, (0, 1, 2), True)
    return cells


_PORT = types.SimpleNamespace(build=build, lru_network=lru_network,
                              exponential_analogue=exponential_analogue)
_REF = types.SimpleNamespace(build=jbuild, lru_network=jlru_network,
                             exponential_analogue=jexponential_analogue)


def _run_cells(cells, n_requests, burst=None):
    """Every cell's (seed x p_hit) lanes in ONE plain call, each reduced as
    ``simulate_network`` reduces its own grid (lane seed ``s * 1000 +
    p_index``)."""
    dev = torch.device("cpu")
    specs, seeds, ranks, means, bmiss, spans = [], [], [], [], [], {}
    for name, (net_of, p_hits, rate, cell_seeds, co) in cells.items():
        net = net_of(_PORT)
        cs = [compile_network(net, p, device=dev) for p in p_hits]
        spans[name] = (len(specs), p_hits, rate, len(cell_seeds))
        for s in cell_seeds:
            for i, spec in enumerate(cs):
                specs.append(spec)
                seeds.append(1000 * s + i)
                ranks.append(spec.disk_rank if co else
                             torch.full_like(spec.disk_rank, -1))
                means.append(np.float32(1e3 / rate))
                bmiss.append(torch.from_numpy(tes.branch_miss(spec)))
    lane_spec, seed_t, kw = tes.pad_lanes(specs, seeds, n_requests, 0.25,
                                          budget_visits=3)
    stacked = stack_specs([s._replace(disk_rank=r) for s, r in zip(specs, ranks)])
    n_b = lane_spec.visits.shape[1]
    miss = torch.stack([torch.nn.functional.pad(b.to(torch.int32),
                                                (0, n_b - len(b)))
                        for b in bmiss])
    mean_ns = np.asarray(means, np.float32)
    phases = None
    if burst is not None:
        duty, on_us = burst
        mean_ns = mean_ns * np.float32(duty)
        phases = (np.float32(on_us * 1e3),
                  np.float32(on_us * 1e3 * (1.0 - duty) / duty))
    out = tes.sim_open_lanes(
        lane_spec, seed_t, n_requests=n_requests, warmup=kw["warmup"],
        n_slots=N_SLOTS, max_events=kw["max_events"],
        ia_mean=torch.from_numpy(mean_ns), bmiss=miss, burst=phases,
        n_flows=FLOWS, n_disks=1, disk_rank=stacked.disk_rank.to(torch.int32))
    res = {}
    for name, (start, p_hits, rate, n_s) in spans.items():
        sl = slice(start, start + n_s * len(p_hits))
        lanes = tes.OpenLaneOutputs(*(a[sl] if isinstance(a, torch.Tensor)
                                      else a for a in out))
        res[name] = open_result(lanes, np.asarray(p_hits, float),
                                np.full(len(p_hits), rate), n_requests, n_s,
                                kw["warmup"])
    return res


@pytest.fixture(scope="module")
def runs():
    return _run_cells(_cells(), N_REQUESTS)


@pytest.fixture(scope="module")
def burst_runs():
    cells = {"burst": (lambda mod: mod.exponential_analogue(
        mod.lru_network(disk_us=100.0)), [0.7], 0.8, (0, 1, 2), False)}
    return _run_cells(cells, BURST_REQUESTS, burst=BURST)


@pytest.mark.parametrize("policy,tier", ORACLE_CASES)
def test_open_sim_matches_oracle(runs, policy, tier):
    """The port against the heapq oracle and the reference simulator:
    throughput within 0.06 and mean sojourn within 0.12 of each, and no
    drops (the tolerances of ``tests/test_latency.py``)."""
    net_of, p_hits, lam, seeds, _ = _cells()[(policy, tier)]
    jnet, p = net_of(_REF), p_hits[0]
    py = [simulate_py(jnet, p, n_requests=5_000, seed=s, arrival_rate=lam)
          for s in (3, 4)]
    jx = jsimulate_network(jnet, [p], arrival_rate=lam, n_requests=N_REQUESTS,
                           seeds=seeds)
    got = runs[(policy, tier)]
    assert isinstance(got, OpenSimResult)
    assert np.all(got.drop_frac == 0.0) and not got.truncated.any()
    for what, x, r in (("oracle", np.mean([d["x"] for d in py]),
                        np.mean([d["sojourn_mean"] for d in py])),
                       ("reference", jx.throughput[0], jx.sojourn_mean[0])):
        assert abs(got.throughput[0] - x) / x < 0.06, (what, got.throughput, x)
        assert abs(got.sojourn_mean[0] - r) / r < 0.12, (
            what, policy, tier, got.sojourn_mean, r)


def test_open_sim_matches_analytic_at_low_utilization(runs):
    """At 35% of the stability boundary the mean sojourn is the Erlang-C
    figure within 0.08, the throughput the offered rate within 0.05."""
    net_of, p_hits, lam, _, _ = _cells()["low"]
    got = runs["low"]
    want = tlat.response_time(net_of(_PORT), np.asarray(p_hits), lam)
    assert np.all(np.abs(got.sojourn_mean - want) / want < 0.08), (
        got.sojourn_mean, want)
    assert np.all(np.abs(got.throughput - lam) / lam < 0.05)
    assert np.all(got.sojourn_p99 > got.sojourn_mean)


def test_open_sim_class_breakdown_and_parked_sojourns(runs):
    """Delayed hits carry the parked interval in their sojourn: slower than
    true hits, faster than true misses when the fetch is deterministic;
    the classes add up and the delayed class is the delayed fraction."""
    got = runs["classes"]
    assert got.class_frac[0].sum() == pytest.approx(1.0)
    assert got.class_frac[0, CLS_DELAYED] > 0.03
    assert got.delayed_frac[0] == pytest.approx(got.class_frac[0, 2], abs=1e-6)
    hit, miss, delayed = (got.class_sojourn[0, 1], got.class_sojourn[0, 0],
                          got.class_sojourn[0, 2])
    assert hit < delayed < miss, got.class_sojourn
    assert np.all(got.drop_frac == 0.0)


def test_open_sim_oracle_agrees_with_coalescing(runs):
    """Coalescing in the open loop against the oracle and the reference:
    mean sojourn within 0.15, delayed fraction within 0.05."""
    net_of, p_hits, lam, seeds, _ = _cells()["coalesce"]
    jnet = net_of(_REF)
    py = simulate_py(jnet, 0.5, n_requests=5_000, seed=5, arrival_rate=lam,
                     coalesce_flows=FLOWS)
    jx = jsimulate_network(jnet, [0.5], arrival_rate=lam,
                           n_requests=N_REQUESTS, seeds=seeds,
                           coalesce_flows=FLOWS, max_in_system=N_SLOTS)
    got = runs["coalesce"]
    for what, r, df in (("oracle", py["sojourn_mean"], py["delayed_frac"]),
                        ("reference", jx.sojourn_mean[0], jx.delayed_frac[0])):
        assert abs(r - got.sojourn_mean[0]) / r < 0.15, (what, r,
                                                         got.sojourn_mean)
        assert abs(df - got.delayed_frac[0]) < 0.05, (what, df,
                                                      got.delayed_frac)


def test_burst_oracle_agrees(burst_runs):
    """ON-OFF arrivals against the oracle and the reference: throughput
    within 0.1, mean sojourn within 0.2."""
    jnet = jexponential_analogue(jlru_network(disk_us=100.0))
    lam = 0.8
    py = [simulate_py(jnet, 0.7, n_requests=8_000, seed=s, arrival_rate=lam,
                      burst=BURST, max_in_system=N_SLOTS) for s in (3, 4)]
    jx = jsimulate_network(jnet, [0.7], arrival_rate=lam,
                           n_requests=BURST_REQUESTS, seeds=(0, 1, 2),
                           burst=BURST, max_in_system=N_SLOTS)
    got = burst_runs["burst"]
    assert np.all(got.drop_frac == 0.0)
    for what, x, r in (("oracle", np.mean([d["x"] for d in py]),
                        np.mean([d["sojourn_mean"] for d in py])),
                       ("reference", jx.throughput[0], jx.sojourn_mean[0])):
        assert abs(x - got.throughput[0]) / x < 0.1, (what, x, got.throughput)
        assert abs(r - got.sojourn_mean[0]) / r < 0.2, (what, r,
                                                        got.sojourn_mean)


def test_simulate_network_open_loop_is_deterministic():
    """The open loop through ``simulate_network``: the same result on every
    call for a given seed, a drop-free sized pool, and the one grid
    equal to its cell run in a shared call."""
    net = lru_network(disk_us=100.0)
    kw = dict(arrival_rate=1.0, n_requests=400, seeds=(7,), device="cpu",
              coalesce_flows=4, max_in_system=64)
    a = simulate_network(net, [0.8], **kw)
    b = simulate_network(net, [0.8], **kw)
    for f in dataclasses.fields(a):
        _same(getattr(a, f.name), getattr(b, f.name), f.name)
    assert np.all(a.drop_frac == 0.0)
    assert a.class_frac[0].sum() == pytest.approx(1.0)


def test_small_pool_drops_and_budget_warns():
    """A pool too small for the offered load drops arrivals and counts
    them; a rate far past the boundary spends the event budget and warns,
    as the reference does."""
    net = lru_network(disk_us=100.0)
    small = simulate_network(net, [0.5], arrival_rate=2.0, n_requests=300,
                             seeds=(0,), max_in_system=8, device="cpu")
    assert 0.0 < small.drop_frac[0] < 1.0
    over = exponential_analogue(build("lru", disk_us=100.0, disk_servers=1))
    with pytest.warns(RuntimeWarning, match="event budget"):
        res = simulate_network(over, [0.0], arrival_rate=1.0, n_requests=60,
                               seeds=(0,), max_in_system=4096, device="cpu")
    assert res.truncated[0]


def test_open_sim_rejects_bad_rate_and_burst():
    net = lru_network(disk_us=100.0)
    with pytest.raises(ValueError, match="arrival_rate must be > 0"):
        simulate_network(net, [0.5], arrival_rate=0.0, n_requests=100,
                         device="cpu")
    with pytest.raises(ValueError, match="require arrival_rate"):
        simulate_network(net, [0.5], n_requests=100, burst=(0.5, 100.0),
                         device="cpu")
    for burst in ((1.5, 100.0), (0.0, 100.0), (0.5, 0.0)):
        with pytest.raises(ValueError, match="burst"):
            simulate_network(net, [0.5], arrival_rate=0.5, n_requests=100,
                             burst=burst, device="cpu")
