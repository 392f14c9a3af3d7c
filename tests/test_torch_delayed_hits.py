"""Miss coalescing (delayed hits) in the port's closed-loop simulator.

The reference runs coalescing only on its threefry engine
(``repro.core.simulator._simulate`` with ``n_flows``); the port runs it on
its counter engine, in the event-sim kernel and its plain version
(``repro_torch.kernels.event_sim.sim_lanes_plain``, which these tests
run).  So the port is held statistically, with the tolerances of
``tests/test_delayed_hits.py``, against both the reference simulator and
the independent heapq oracle ``repro.core.py_sim.simulate_py``, at that
file's run lengths (12 000 requests).

Every coalescing run of this file is one lane of ONE plain call (the
``runs`` fixture): the per-event cost of the plain version is paid once.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import build as jbuild
from repro.core import lru_network as jlru_network
from repro.core import queueing as jqueueing
from repro.core.py_sim import simulate_py
from repro.core.simulator import simulate_network as jsimulate_network
from repro.kernels import event_sim as jes
from repro_torch.core import build, lru_network, sigma_of
from repro_torch.core.simspec import compile_network, stack_specs
from repro_torch.core.simulator import simulate_network
from repro_torch.kernels import event_sim as tes
from test_torch_event_sim_cuda import two_disk_network

N_REQUESTS = 12_000
FLOWS = 16
P = 0.7
DISK_TIERS = [
    {"disk_us": 100.0, "disk_servers": 0},  # paper's infinite-server disk
    {"disk_us": 500.0, "disk_servers": 8},  # bounded I/O depth
]
ORACLE_CASES = [(policy, tier) for tier in range(len(DISK_TIERS))
                for policy in ("lru", "fifo", "clock")]
ORACLE_SEEDS = (0, 1, 2, 3)
# (network builder kwargs, p_hit, seeds) of the other coalescing runs
PARKED = (dict(policy="lru", disk_us=100.0, disk_servers=4), 0.5, (0, 1))
SIGMA = (dict(policy="lru", disk_us=100.0), 0.5, (0, 1, 2))


def _cells():
    """(name, port network, p_hit, seeds) of every run, in lane order."""
    cells = [((policy, tier), build(policy, mpl=72, **DISK_TIERS[tier]), P,
              ORACLE_SEEDS) for policy, tier in ORACLE_CASES]
    for name, (kw, p, seeds) in (("parked", PARKED), ("sigma", SIGMA)):
        kw = dict(kw)
        cells.append((name, build(kw.pop("policy"), **kw), p, seeds))
    return cells


@pytest.fixture(scope="module")
def runs():
    """Every cell's lanes in one plain call: lane seed ``s * 1000`` as
    ``simulate_network(net, [p], seeds=...)`` gives it, so each cell's
    numbers are those ``simulate_network`` returns for it alone."""
    dev = torch.device("cpu")
    specs, seeds, spans = [], [], {}
    for name, net, p, cell_seeds in _cells():
        spec = compile_network(net, p, device=dev)
        spans[name] = (len(specs), len(cell_seeds), len(net.branches))
        specs += [spec] * len(cell_seeds)
        seeds += [1000 * s for s in cell_seeds]
    lane_spec, seed_t, kw = tes.pad_lanes(specs, seeds, N_REQUESTS, 0.25)
    disk_rank = stack_specs(specs).disk_rank.to(torch.int32)
    out = tes.sim_lanes(lane_spec, seed_t, n_flows=FLOWS, disk_rank=disk_rank,
                        n_disks=1, **kw)
    res = {}
    for name, (start, n, n_b) in spans.items():
        sl = slice(start, start + n)
        t = out.t_measured[sl].double()[:, None]
        res[name] = dict(
            x=float(out.x[sl].mean()), delayed_frac=float(out.delayed_frac[sl].mean()),
            lanes=dict(x=out.x[sl], completed=out.completed[sl],
                       delayed_frac=out.delayed_frac[sl],
                       branch_done=out.branch_done[sl, :n_b],
                       branch_delayed=out.branch_delayed[sl, :n_b], t=t))
    return res


@pytest.mark.parametrize("policy,tier", ORACLE_CASES)
def test_sim_matches_oracle_with_coalescing(runs, policy, tier):
    """The port against the heapq oracle and the reference simulator:
    throughput within 0.07 (0.12 on the slowly mixing bounded disk) and
    delayed-hit fraction within 0.04 of each, the tolerances of
    ``tests/test_delayed_hits.py``."""
    net = jbuild(policy, mpl=72, **DISK_TIERS[tier])
    py = [simulate_py(net, P, n_requests=N_REQUESTS, seed=s,
                      coalesce_flows=FLOWS, full=True) for s in (3, 4, 5)]
    x_py = np.mean([r["x"] for r in py])
    df_py = np.mean([r["delayed_frac"] for r in py])
    jx = jsimulate_network(net, [P], n_requests=N_REQUESTS,
                           seeds=ORACLE_SEEDS, coalesce_flows=FLOWS)
    got = runs[(policy, tier)]
    tol = 0.07 if DISK_TIERS[tier]["disk_servers"] == 0 else 0.12
    assert df_py > 0.0 and got["delayed_frac"] > 0.0
    for what, x, df in (("oracle", x_py, df_py),
                        ("reference", float(jx.throughput[0]),
                         float(jx.delayed_frac[0]))):
        assert abs(got["x"] - x) / x < tol, (what, policy, tier, got["x"], x)
        assert abs(got["delayed_frac"] - df) < 0.04, (
            what, policy, tier, got["delayed_frac"], df)


def test_parked_requests_do_not_hold_io_depth(runs):
    """With a 4-deep disk, duplicate misses clog the I/O queue: without
    coalescing the throughput cannot pass the disk's bound c / D_disk;
    parked on the MSHR table they hold no slot, and the port's coalesced
    throughput passes twice that bound."""
    kw, p, _ = PARKED
    kw = dict(kw)
    net = build(kw.pop("policy"), **kw)
    bound = float(net.throughput_upper(p))
    assert runs["parked"]["x"] > 2.0 * bound, (runs["parked"]["x"], bound)
    assert runs["parked"]["delayed_frac"] > 0.1


def test_sim_delayed_frac_tracks_model_sigma(runs):
    """Event-level coalescing and the analytic sigma fixed point describe
    the same mechanism: delayed completions ~= sigma * (1 - p), within
    rel 0.25 as the reference's test holds its simulator."""
    kw, p, _ = SIGMA
    model = build("lru", disk_us=kw["disk_us"], coalesce_flows=FLOWS)
    want = sigma_of(model, p) * (1.0 - p)
    assert runs["sigma"]["delayed_frac"] == pytest.approx(want, rel=0.25)


@pytest.mark.parametrize("name", ["parked", "sigma", ("lru", 1)])
def test_delayed_frac_consistent_with_branch_counts(runs, name):
    """Per lane, the per-branch counts add up to the measured completions
    and delayed hits, and a delayed hit is a completion of a miss branch
    (the reference's accounting, ``simulator.py:266-270``)."""
    lanes = runs[name]["lanes"]
    done = lanes["branch_done"].long().sum(dim=1)
    delayed = lanes["branch_delayed"].long().sum(dim=1)
    assert torch.all(delayed <= done) and torch.all(delayed > 0)
    frac = delayed.to(torch.float32) / done.to(torch.float32)
    np.testing.assert_allclose(frac.numpy(), lanes["delayed_frac"].numpy(),
                               rtol=1e-6)
    # no hit branch (the first, in every policy network) parks
    assert torch.all(lanes["branch_delayed"][:, 0] == 0)
    # the rates the result reports: counts over each lane's measured time
    x = (done.double()[:, None] / lanes["t"])[:, 0]
    np.testing.assert_allclose(x.numpy(), lanes["x"].double().numpy(),
                               rtol=1e-5)


def _det(net):
    return dataclasses.replace(net, stations=tuple(
        dataclasses.replace(s, dist="det", dist_params=()) for s in net.stations))


def test_disabled_coalescing_unchanged():
    """coalesce_flows=0 runs no coalescing code: on a deterministic network
    the port's throughput is the reference counter engine's bit for bit,
    as before, whatever coalesce_theta says; delayed_frac is zero and the
    branch columns are None."""
    p = [0.5, 0.9]
    kw = dict(n_requests=1500, seeds=(7,))
    a = simulate_network(_det(lru_network(disk_us=100.0)), p, device="cpu",
                         **kw)
    b = simulate_network(_det(lru_network(disk_us=100.0)), p, device="cpu",
                         coalesce_theta=0.9, **kw)
    ref = jes.simulate_grid_pallas(_det(jlru_network(disk_us=100.0)), p, **kw)
    np.testing.assert_array_equal(a.throughput, ref.throughput)
    np.testing.assert_array_equal(b.throughput, a.throughput)
    assert np.all(a.delayed_frac == 0.0)
    assert a.branch_throughput is None and a.branch_delayed is None


@pytest.mark.parametrize("flows,theta", [(8, 0.0), (64, 0.9), (64, 0.99)])
def test_flow_draw_is_the_references_law(flows, theta):
    """A Zipf flow is searchsorted-left over the float32 CDF of the
    reference's ``zipf_flow_weights`` (``_sample_flow``); a uniform flow
    is floor(u F).  Both stay within the flow group."""
    cdf = tes.flow_cdf(flows, theta)
    u = torch.from_numpy(np.random.default_rng(flows).random(4096,
                                                             dtype=np.float32))
    got = tes.flow_index(u, flows, None if cdf is None else torch.from_numpy(cdf))
    if theta == 0.0:
        assert cdf is None
        want = np.floor(u.numpy() * np.float32(flows)).astype(np.int64)
    else:
        ref = np.cumsum(jqueueing.zipf_flow_weights(flows, theta)).astype(
            np.float32)
        np.testing.assert_array_equal(cdf, ref)
        want = np.minimum(np.searchsorted(ref, u.numpy()), flows - 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() <= flows - 1


def test_flow_groups_are_per_disk():
    """Each disk rank owns its own F flows: with one flow per group, every
    miss of a group behind an in-flight fetch parks, and both groups see
    delayed hits; a run is the same on every call."""
    net = two_disk_network()
    kw = dict(n_requests=400, seeds=(0,), coalesce_flows=1, device="cpu")
    a = simulate_network(net, [0.3], **kw)
    b = simulate_network(net, [0.3], **kw)
    np.testing.assert_array_equal(a.throughput, b.throughput)
    np.testing.assert_array_equal(a.branch_delayed, b.branch_delayed)
    assert a.branch_delayed.shape == (1, 3)
    assert a.branch_delayed[0, 0] == 0.0
    assert a.branch_delayed[0, 1] > 0.0 and a.branch_delayed[0, 2] > 0.0
    assert tes._n_disks(compile_network(net, 0.3, device="cpu")) == 2


def test_coalescing_arguments_validated():
    net = lru_network(disk_us=100.0, mpl=8)
    spec, seeds, kw = tes.grid_lanes(net, [0.5], 50, (0,), 0.25,
                                     torch.device("cpu"), coalesce_flows=4)
    with pytest.raises(ValueError, match="disk_rank"):
        tes.sim_lanes(spec, seeds, **dict(kw, disk_rank=None))
    with pytest.raises(ValueError, match="disk_rank must be"):
        tes.sim_lanes(spec, seeds, **dict(kw, disk_rank=kw["disk_rank"][:, :2]))
    traced = tes.sim_lanes(spec, seeds, trace_cap=8,
                           bmiss=torch.zeros((1, 2), dtype=torch.int32), **kw)
    assert tuple(traced.rings.req.shape) == (1, 9)
    assert torch.equal(traced.rings.n_count, traced.completed)
