"""Tracing in every simulator mode: coalescing, the open loop and the
tiered tables, on the port's plain versions against the JAX reference
(``repro.core.simulator.simulate_network(trace=K)``, its threefry engine)
and the port's heapq oracle (``simulate_py(trace=K)``).

The reference runs these modes on its threefry engine and the port on its
counter engine, so the two agree statistically, at the tolerances of the
reference's ``tests/test_obs.py`` ``TestTwinTraceAgreement``: class
fractions within 0.06, mean sojourn within 25%, the hierarchy's per-level
mix within 0.06.  What holds exactly: tracing is inert (every untraced
output of a traced run is the untraced run's, with the sketch on too), the
records reconcile with the counters (per-branch counts, delayed hits, the
open loop's own class records), the ring keeps the last ``cap`` records,
and the port's metrics give the reference's answers on the same records.
"""

import math

import numpy as np
import pytest
import torch

from repro.core.policy_models import clock_network as jclock_network
from repro.core.policy_models import fifo_network as jfifo_network
from repro.core.policy_models import lru_network as jlru_network
from repro.core.simulator import simulate_network as jsimulate_network
from repro.hierarchy.model import hierarchy_network as jhierarchy_network
from repro.hierarchy.sim import simulate_hierarchy as jsimulate_hierarchy
from repro.latency import lambda_max as jlambda_max
from repro.obs import metrics as jmetrics
from repro_torch.cluster import (HashRing, cluster_network,
                                 ideal_shard_profile, zipf_key_probs)
from repro_torch.core import policy_models as tpm
from repro_torch.core.py_sim import simulate_py
from repro_torch.core.simspec import compile_network, stack_specs
from repro_torch.core.simulator import simulate_network
from repro_torch.hierarchy import hierarchy_network
from repro_torch.hierarchy.sim import simulate_hierarchy, simulate_hierarchy_py
from repro_torch.kernels import event_sim as tes
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs.trace import (CLS_DELAYED, CLS_HIT, CLS_MISS,
                                   trace_from_rings)
from test_torch_trace import _as_reference, _assert_same

N_REQ = 2_500  # tests/test_obs.py's
WARMUP = N_REQ // 4
SMALL = 300  # the exact checks' run length
LOSSLESS = 1024  # a ring no SMALL run fills
CPU = torch.device("cpu")
POLICIES = ("lru", "fifo", "clock")


def _hierarchy(pkg_network):
    return pkg_network("lru", "lru", n_clients=2, n_shards=2, mpl=16,
                       disk_us=50.0)


def _cluster():
    """tests/test_cluster.py's 4-shard LRU cluster (Zipf(1) keys over a
    64-vnode ring), mpl 48."""
    probs = zipf_key_probs(1024, 1.0, seed=0)
    assign = HashRing(4, vnodes=64, seed=1).assignment(1024)
    return cluster_network("lru", 4,
                           profile=ideal_shard_profile(assign, probs),
                           disk_us=100.0, mpl=48)


def _lanes(mode, cap):
    """``(wrapper, spec, seeds, kwargs)`` of one mode's plain lanes on the
    CPU, traced into rings of ``cap`` (0: untraced), ``SMALL`` requests:
    coalescing on the LRU, FIFO or CLOCK network (4 flows), the open loop
    on the LRU network at half its stability boundary (without coalescing,
    with 4 flows, with 4 flows and ON-OFF bursts), the tiered tables of
    tests/test_hierarchy.py's 2 x 2 hierarchy, and a 4-shard cluster with
    4 flows a shard (its per-branch counts)."""
    if mode.startswith("open"):
        net = tpm.lru_network(disk_us=100.0)
        lam = 0.5 * float(jlambda_max(jlru_network(disk_us=100.0), 0.7,
                                      tail_mode="nominal"))
        spec, seeds, kw = tes.open_lanes(
            net, np.array([0.7]), np.array([lam]), SMALL, (0, 1), 0.25, 128,
            burst=(0.5, 40.0) if mode.endswith("burst") else None,
            coalesce_flows=0 if mode == "open" else 4, device="cpu",
            trace=cap)
        return tes.sim_open_lanes, spec, seeds, kw
    tiers, count = None, False
    if mode == "tiers":
        model = _hierarchy(hierarchy_network)
        net, tiers = model.network, model.mshr
    elif mode == "cluster":
        net, count = _cluster().network, True
    else:
        net = getattr(tpm, f"{mode}_network")(disk_us=100.0)
    spec, seeds, kw = tes.grid_lanes(net, np.array([0.5, 0.8]), SMALL, (0,),
                                     0.25, CPU, trace=cap, coalesce_flows=4,
                                     tiers=tiers)
    if count:
        kw["count_branches"] = True
    return tes.sim_lanes, spec, seeds, kw


MODES = ("lru", "fifo", "clock", "open", "open-flows", "open-flows-burst",
         "tiers", "cluster")


@pytest.mark.parametrize("mode", MODES)
def test_tracing_is_inert(mode):
    """A traced run's untraced outputs are the untraced run's bit for
    bit, with the sketch off and on; the traced and sketched run's rings
    are the traced run's; one record per completion."""
    fn, spec, seeds, kw = _lanes(mode, LOSSLESS)
    bare = {k: v for k, v in kw.items() if k != "trace_cap"}
    sk = dict(sketch_cap=8, window_us=50.0)
    runs = {"traced": fn(spec, seeds, **kw), "bare": fn(spec, seeds, **bare),
            "both": fn(spec, seeds, **dict(kw, **sk)),
            "sketched": fn(spec, seeds, **dict(bare, **sk))}
    for traced, untraced in (("traced", "bare"), ("both", "sketched")):
        a, b = runs[traced], runs[untraced]
        assert b.rings is None and a.rings is not None
        for f, x in a._asdict().items():
            y = getattr(b, f)
            if f == "rings" or (x is None and y is None):
                continue
            if f == "sketch":
                for sx, sy in zip(x, y):
                    assert torch.equal(sx, sy), (traced, f)
            else:
                assert torch.equal(x, y), (traced, f)
    for ra, rb in zip(runs["both"].rings, runs["traced"].rings):
        assert torch.equal(ra, rb)
    out = runs["traced"]
    assert torch.equal(out.rings.n_count, out.completed)
    assert int(out.rings.n_count.max()) < kw["trace_cap"]  # lossless


def _decode(out, spec, lane):
    r = [a[lane].numpy() for a in out.rings]
    return trace_from_rings(*r, visits=spec.visits[lane].numpy())


@pytest.mark.parametrize("mode", ("lru", "tiers", "cluster"))
def test_closed_records_reconcile_with_the_counts(mode):
    """Lossless rings of the closed modes: records ``0 .. completed - 1``;
    over the measured window (from the warmup snapshot, which a fill may
    carry past ``warmup``) the per-branch record counts are
    ``branch_done`` exactly and the delayed records ``branch_delayed``;
    ``parked_us`` is 0 on every other record; every visit leaves after it
    enters."""
    fn, spec, seeds, kw = _lanes(mode, LOSSLESS)
    out = fn(spec, seeds, **kw)
    n_b = spec.visits.shape[1]
    n_delayed = 0
    for lane in range(seeds.shape[0]):
        tr = _decode(out, spec, lane)
        done = int(out.completed[lane])
        assert tr.n_emitted == done and tr.n_dropped == 0
        assert np.array_equal(tr.req, np.arange(done))
        warm = done - int(out.branch_done[lane].sum())
        assert kw["warmup"] <= warm < kw["warmup"] + kw["mpl"]
        m = tr.req >= warm
        np.testing.assert_array_equal(
            np.bincount(tr.branch[m], minlength=n_b),
            out.branch_done[lane].numpy())
        dl = m & (tr.cls == CLS_DELAYED)
        np.testing.assert_array_equal(
            np.bincount(tr.branch[dl], minlength=n_b),
            out.branch_delayed[lane].numpy())
        n_delayed += int(dl.sum())
        assert (tr.parked_us[tr.cls != CLS_DELAYED] == 0).all()
        assert (tr.parked_us[tr.cls == CLS_DELAYED] >= 0).all()
        live = np.arange(tr.enter_us.shape[1])[None, :] < tr.nvis[:, None]
        assert (tr.leave_us[live] >= tr.enter_us[live]).all()
        np.testing.assert_allclose(
            float(out.delayed_frac[lane]),
            dl.sum() / max(done - warm, 1), rtol=1e-6)
    assert n_delayed > 0


@pytest.mark.parametrize("mode", ("open-flows", "open-flows-burst"))
def test_open_records_reconcile_with_the_sojourns(mode):
    """The open loop's records are its completions: ``req`` the completion
    index, the class the one its sojourn buffer holds there, the sojourn
    (last leave - first enter) its summed age to float32 rounding."""
    fn, spec, seeds, kw = _lanes(mode, LOSSLESS)
    out = fn(spec, seeds, **kw)
    for lane in range(seeds.shape[0]):
        tr = _decode(out, spec, lane)
        done = int(out.completed[lane])
        assert tr.n_emitted == done and np.array_equal(tr.req,
                                                       np.arange(done))
        np.testing.assert_array_equal(tr.cls,
                                      out.cls[lane, :done].numpy())
        np.testing.assert_allclose(tr.sojourn_us,
                                   out.sojourn_us[lane, :done].numpy(),
                                   rtol=1e-4, atol=1e-3)
        assert (tr.cls == CLS_DELAYED).sum() > 0
        assert (tr.parked_us[tr.cls != CLS_DELAYED] == 0).all()


@pytest.mark.parametrize("mode", ("lru", "open-flows", "tiers"))
def test_overflow_keeps_the_last_records(mode):
    """Rings smaller than the run: the last ``cap`` records survive, ``req``
    runs ``n - cap .. n - 1`` and the scrap row is dropped."""
    cap = 64
    fn, spec, seeds, kw = _lanes(mode, cap)
    out = fn(spec, seeds, **kw)
    for lane in range(seeds.shape[0]):
        tr = _decode(out, spec, lane)
        n = int(out.completed[lane])
        assert tr.n_emitted == n and len(tr) == cap
        assert tr.n_dropped == n - cap
        assert np.array_equal(tr.req, np.arange(n - cap, n))
        assert int(out.rings.req[lane, cap]) != -1  # the scrap row was hit


def _class_fracs(tr, warm):
    m = tr.req >= warm
    return np.array([(tr.cls[m] == c).mean()
                     for c in (CLS_MISS, CLS_HIT, CLS_DELAYED)])


def _sojourn(tr, warm):
    return float(tr.sojourn_us[tr.req >= warm].mean())


def _twin(mine, other):
    """tests/test_obs.py's twin bands between lists of ``(records,
    warmup)``, each side's class fractions and mean sojourn averaged over
    its list: class fractions within 0.06, mean sojourn within 25%."""
    def mean(side):
        return (np.mean([_class_fracs(t, w) for t, w in side], axis=0),
                np.mean([_sojourn(t, w) for t, w in side]))

    (fm, sm), (fo, so) = mean(mine), mean(other)
    np.testing.assert_allclose(fm, fo, atol=0.06)
    assert abs(sm - so) / so < 0.25, (sm, so)


# seeds a side of the coalesced twins: at one seed a side (the reference
# test's) the mean sojourn of the Pareto-headed FIFO and CLOCK networks
# scatters by 30% between seeds on every engine (CPU runs of the port, its
# oracle and the reference), so the bands hold means over these
TWIN_SEEDS = 8


@pytest.fixture(scope="module")
def coalesced_policies():
    """The LRU, FIFO and CLOCK networks at p 0.7 with 4 flows, lossless
    rings, N_REQ requests, ``TWIN_SEEDS`` seeds each: one plain call of
    padded lanes (lane seed ``1000 s``, as ``simulate_network(seeds=...)``
    runs seed ``s`` of one p).  ``{policy: [records of each seed]}``."""
    nets = [getattr(tpm, f"{p}_network")(disk_us=100.0) for p in POLICIES]
    specs = [compile_network(net, 0.7, device="cpu")
             for net in nets for _ in range(TWIN_SEEDS)]
    spec, seeds, kw = tes.pad_lanes(specs, [1000 * s for _ in POLICIES
                                            for s in range(TWIN_SEEDS)],
                                    N_REQ, 0.25)
    n_b = spec.visits.shape[1]
    bmiss = np.stack([np.concatenate(
        [m, np.repeat(m[-1:], n_b - len(m))])
        for m in map(tes.branch_miss, specs)]).astype(np.int32)
    kw.update(n_flows=4, n_disks=1, disk_rank=stack_specs(specs).disk_rank,
              trace_cap=2 * N_REQ, bmiss=torch.from_numpy(bmiss))
    out = tes.sim_lanes(spec, seeds, **kw)
    return {p: [_decode(out, spec, i * TWIN_SEEDS + s)
                for s in range(TWIN_SEEDS)] for i, p in enumerate(POLICIES)}


@pytest.mark.parametrize("policy", POLICIES)
def test_coalesced_twins_agree(coalesced_policies, policy):
    """tests/test_obs.py's closed-coalesced twins, ``TWIN_SEEDS`` seeds a
    side: the port against its oracle and against the reference's
    threefry engine."""
    port = [(tr, WARMUP) for tr in coalesced_policies[policy]]
    for tr, _ in port:
        assert tr.n_emitted >= N_REQ and tr.n_dropped == 0
        assert (tr.cls == CLS_DELAYED).sum() > 0
    net = getattr(tpm, f"{policy}_network")(disk_us=100.0)
    py = [simulate_py(net, 0.7, n_requests=N_REQ, seed=s + 1,
                      coalesce_flows=4, full=True, trace=2 * N_REQ)
          for s in range(TWIN_SEEDS)]
    _twin(port, [(o["trace"], o["warm_done"]) for o in py])
    jnet = {"lru": jlru_network, "fifo": jfifo_network,
            "clock": jclock_network}[policy](disk_us=100.0)
    jx = jsimulate_network(jnet, [0.7], n_requests=N_REQ,
                           seeds=tuple(range(TWIN_SEEDS)), coalesce_flows=4,
                           trace=2 * N_REQ)
    _twin(port, [(t[0], WARMUP) for t in jx.traces])


def test_open_twins_agree():
    """tests/test_obs.py's open-loop twins (half the stability boundary)."""
    net = tpm.lru_network(disk_us=100.0)
    jnet = jlru_network(disk_us=100.0)
    lam = 0.5 * float(jlambda_max(jnet, 0.7, tail_mode="nominal"))
    res = simulate_network(net, [0.7], arrival_rate=lam, n_requests=N_REQ,
                           seeds=(0,), trace=2 * N_REQ, device="cpu")
    tr = res.traces[0][0]
    assert tr.n_emitted == N_REQ and tr.n_dropped == 0
    py = simulate_py(net, 0.7, n_requests=N_REQ, seed=1, arrival_rate=lam,
                     trace=2 * N_REQ)
    _twin([(tr, WARMUP)], [(py["trace"], py["warm_done"])])
    jx = jsimulate_network(jnet, [0.7], arrival_rate=lam, n_requests=N_REQ,
                           seeds=(0,), trace=2 * N_REQ)
    _twin([(tr, WARMUP)], [(jx.traces[0][0], WARMUP)])
    # the records' sojourns are the result's
    assert math.isclose(_sojourn(tr, WARMUP), float(res.sojourn_mean[0]),
                        rel_tol=1e-4)


def test_tiered_twins_agree():
    """tests/test_obs.py's tiered-hierarchy twins: every record resolves to
    a serving level, the per-level mix within 0.06 of the oracle's and the
    reference's, cross-tier coalescing on every side."""
    model = _hierarchy(hierarchy_network)
    res = simulate_hierarchy(model, [0.6], n_requests=N_REQ, seeds=(0,),
                             coalesce_flows=4, trace=2 * N_REQ, device="cpu")
    py = simulate_hierarchy_py(model, 0.6, n_requests=N_REQ, seed=1,
                               coalesce_flows=4, trace=2 * N_REQ)
    jx = jsimulate_hierarchy(_hierarchy(jhierarchy_network), [0.6],
                             n_requests=N_REQ, seeds=(0,), coalesce_flows=4,
                             trace=2 * N_REQ)
    level = np.asarray(model.branch_level)
    mix = {}
    for name, tr in (("port", res.traces[0][0]), ("oracle", py.traces),
                     ("reference", jx.traces[0][0])):
        assert len(tr) >= N_REQ
        assert set(np.unique(level[tr.branch])) <= {0, 1, 2}
        assert (tr.cls == CLS_DELAYED).sum() > 0
        mix[name] = np.bincount(level[tr.branch], minlength=3) / len(tr)
    np.testing.assert_allclose(mix["port"], mix["oracle"], atol=0.06)
    np.testing.assert_allclose(mix["port"], mix["reference"], atol=0.06)


def test_metrics_match_the_reference_on_coalesced_records(
        coalesced_policies):
    """trace_summary and convoy_stats on coalesced records (delayed ones
    with their parked times among them) give the reference's answers."""
    tr = coalesced_policies["lru"][0]
    jtr = _as_reference(tr)
    n_k = len(tpm.lru_network().stations)
    _assert_same(tmetrics.trace_summary(tr, n_k),
                 jmetrics.trace_summary(jtr, n_k))
    for k in range(n_k):
        _assert_same(tmetrics.convoy_stats(tr, k),
                     jmetrics.convoy_stats(jtr, k))
    assert tmetrics.trace_summary(tr)["classes_count"]["delayed"] > 0
