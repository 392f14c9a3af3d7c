"""The port's traced simulation and its ``obs`` modules against
``repro.kernels.event_sim.simulate_grid_pallas(trace=K)`` and ``repro.obs``.

The counter RNG is shared, so the decoded trace records agree field by
field: the integer fields (req, branch, cls, nvis, station, n_emitted)
identically, the stamps exactly on the deterministic network and within
rtol 1e-5 on the LRU network (the tolerance of
``test_lru_network_statistics_match``: its Pareto and exponential draws go
through float32 ``log``/``pow``, whose last ulp may differ between
libraries).  The reference runs its vmapped twin (``interpret=None``) and,
on one tiny case, the Pallas kernel body in interpret mode.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core import lru_network as jlru_network
from repro.kernels import event_sim as jes
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs.trace import TraceRecords as JTraceRecords
from repro_torch.core import policy_models as tpm
from repro_torch.core.simulator import simulate_network
from repro_torch.kernels import event_sim as tes
from repro_torch.obs import export as texport
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs.trace import TraceRecords

INT_FIELDS = ("req", "branch", "cls", "nvis", "station")
STAMP_FIELDS = ("parked_us", "enter_us", "leave_us")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return "cuda"


def _det(net):
    """The network with every station's service made deterministic."""
    return dataclasses.replace(net, stations=tuple(
        dataclasses.replace(s, dist="det", dist_params=())
        for s in net.stations))


def _assert_records_equal(t, j, *, rtol):
    assert t.n_emitted == j.n_emitted and len(t) == len(j)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)
    for f in STAMP_FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype
        if rtol:
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def _assert_grids_equal(t_res, j_res, *, rtol):
    assert len(t_res.traces) == len(j_res.traces)
    for t_row, j_row in zip(t_res.traces, j_res.traces):
        assert len(t_row) == len(j_row)
        for t, j in zip(t_row, j_row):
            _assert_records_equal(t, j, rtol=rtol)


def test_det_network_records_bit_identical():
    p = np.array([0.5, 0.9])
    kw = dict(n_requests=600, seeds=(0, 1), trace=256)
    t = simulate_network(_det(tpm.lru_network(disk_us=20.0, mpl=24)), p,
                         device="cpu", **kw)
    j = jes.simulate_grid_pallas(_det(jlru_network(disk_us=20.0, mpl=24)), p,
                                 **kw)
    _assert_grids_equal(t, j, rtol=0)
    tr = t.traces[1][0]
    assert len(tr) == 256 and tr.n_emitted == 600 and tr.n_dropped == 344
    np.testing.assert_array_equal(tr.req, np.arange(344, 600))


@pytest.mark.parametrize("trace", [128, 3000], ids=["overflow", "lossless"])
def test_lru_network_records_match(trace):
    p = np.array([0.7, 0.9])
    kw = dict(n_requests=1500, seeds=(0, 1), trace=trace)
    t = simulate_network(tpm.lru_network(disk_us=100.0), p, device="cpu",
                         **kw)
    j = jes.simulate_grid_pallas(jlru_network(disk_us=100.0), p, **kw)
    _assert_grids_equal(t, j, rtol=1e-5)
    for row in t.traces:
        for tr in row:
            if trace == 128:
                assert len(tr) == 128 and tr.n_dropped > 0
                np.testing.assert_array_equal(tr.req, np.arange(1372, 1500))
            else:
                assert len(tr) == 1500 and tr.n_dropped == 0
                np.testing.assert_array_equal(tr.req, np.arange(1500))


def test_records_match_the_pallas_kernel_body():
    """One tiny case against the reference's Pallas kernel in interpret
    mode (the twin of the previous tests)."""
    net_t = _det(tpm.lru_network(disk_us=20.0, mpl=8))
    net_j = _det(jlru_network(disk_us=20.0, mpl=8))
    kw = dict(n_requests=40, seeds=(3,), trace=16)
    t = simulate_network(net_t, [0.6], device="cpu", **kw)
    j = jes.simulate_grid_pallas(net_j, [0.6], interpret=True, **kw)
    _assert_grids_equal(t, j, rtol=0)
    assert len(t.traces[0][0]) == 16


def test_trace_leaves_the_simulation_bit_identical():
    net = tpm.lru_network(disk_us=100.0)
    kw = dict(n_requests=500, seeds=(0, 1), device="cpu")
    base = simulate_network(net, [0.7, 0.99], **kw)
    traced = simulate_network(net, [0.7, 0.99], trace=64, **kw)
    assert base.traces is None and len(traced.traces) == 2
    np.testing.assert_array_equal(base.throughput, traced.throughput)
    np.testing.assert_array_equal(base.ci95, traced.ci95)
    # the lane outputs too, ring by ring
    spec, seeds, lane_kw = tes.grid_lanes(net, np.array([0.7]), 300, (0,),
                                          0.25, torch.device("cpu"), trace=32)
    a = tes.sim_lanes(spec, seeds, **lane_kw)
    b = tes.sim_lanes(spec, seeds, **{k: v for k, v in lane_kw.items()
                                      if k not in ("trace_cap", "bmiss")})
    assert b.rings is None
    for f in ("x", "completed", "events", "t_measured"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.rings.n_count, a.completed)


def test_records_reconcile_with_throughput():
    """Post-warmup records over the measured interval (both read off the
    records) give the lane's throughput, as chip_smoke.py checks on the
    card."""
    net = tpm.lru_network(disk_us=100.0)
    n, warmup = 800, 200
    res = simulate_network(net, [0.8], n_requests=n, seeds=(0, 1),
                           trace=n, device="cpu")
    xs = []
    for row in res.traces:
        tr = row[0]
        end = tr.end_us
        counts = np.bincount(tr.branch[tr.req >= warmup],
                             minlength=len(net.branches))
        xs.append(counts.sum() / (end[-1] - end[warmup - 1]))
    np.testing.assert_allclose(np.mean(xs), res.throughput[0], rtol=1e-5)


def test_traced_lane_inputs_are_checked():
    net = tpm.lru_network(disk_us=100.0)
    spec, seeds, kw = tes.grid_lanes(net, np.array([0.7]), 50, (0,), 0.25,
                                     torch.device("cpu"), trace=8)
    bad = dict(kw, bmiss=None)
    with pytest.raises(ValueError, match="bmiss"):
        tes.sim_lanes(spec, seeds, **bad)
    with pytest.raises(ValueError, match="bmiss"):
        tes.sim_lanes(spec, seeds, **dict(kw, bmiss=kw["bmiss"][:, :1]))
    with pytest.raises(ValueError, match="trace_cap"):
        tes.sim_lanes(spec, seeds, **dict(kw, trace_cap=-1))


def _as_reference(tr: TraceRecords) -> JTraceRecords:
    return JTraceRecords(**{f.name: getattr(tr, f.name)
                            for f in dataclasses.fields(TraceRecords)})


def _assert_same(a, b):
    """Equal nested dicts / lists / numbers, NaN equal to NaN."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    else:
        assert a == b


def test_obs_functions_match_the_reference():
    """trace_summary, station_utilization, convoy_stats and to_perfetto
    give the reference's output on the same records."""
    net = tpm.lru_network(disk_us=100.0)
    res = simulate_network(net, [0.9], n_requests=400, seeds=(0,), trace=256,
                           device="cpu")
    tr = res.traces[0][0]
    jtr = _as_reference(tr)
    names = [s.name for s in net.stations]
    n_k = len(names)
    _assert_same(tmetrics.trace_summary(tr, n_k),
                 jmetrics.trace_summary(jtr, n_k))
    _assert_same(tmetrics.station_utilization(tr, n_k),
                 jmetrics.station_utilization(jtr, n_k))
    for k in range(n_k + 1):  # station n_k is never visited
        _assert_same(tmetrics.convoy_stats(tr, k), jmetrics.convoy_stats(jtr, k))
        np.testing.assert_array_equal(tmetrics.busy_periods(tr, k),
                                      jmetrics.busy_periods(jtr, k))
    obj = texport.to_perfetto(tr, station_names=names)
    _assert_same(obj, jexport.to_perfetto(jtr, station_names=names))
    _assert_same(texport.summarize_events(obj), jexport.summarize_events(obj))
    assert texport.summarize_events(obj)["requests_count"] == len(tr)


def test_perfetto_round_trip(tmp_path):
    res = simulate_network(tpm.lru_network(disk_us=100.0), [0.7],
                           n_requests=200, seeds=(0,), trace=64, device="cpu")
    tr = res.traces[0][0]
    path = tmp_path / "trace.json"
    obj = texport.write_perfetto(path, tr)
    assert texport.read_perfetto(path) == obj
    summ = texport.summarize_events(obj)
    assert summ["slices_count"] == int(tr.nvis.sum())
    assert summ["by_cls_count"] == {k: v for k, v in tr.class_counts().items()
                                    if v}


@pytest.mark.cuda
def test_traced_kernel_matches_plain_on_card(cuda_device):
    net = tpm.lru_network(disk_us=100.0)
    spec, seeds, kw = tes.grid_lanes(net, np.array([0.5, 0.9]), 1200, (0, 1),
                                     0.25, torch.device(cuda_device),
                                     trace=256)
    before = tes.sim_lanes.traced_launches
    k = tes.sim_lanes(spec, seeds, **kw)
    assert tes.sim_lanes.traced_launches == before + 1
    c = tes.sim_lanes(*(tes.grid_lanes(net, np.array([0.5, 0.9]), 1200,
                                       (0, 1), 0.25, torch.device("cpu"),
                                       trace=256)))
    np.testing.assert_array_equal(k.completed.cpu().numpy(),
                                  c.completed.numpy())
    np.testing.assert_array_equal(k.events.cpu().numpy(), c.events.numpy())
    np.testing.assert_array_equal(k.rings.n_count.cpu().numpy(),
                                  c.rings.n_count.numpy())
    cap = kw["trace_cap"]  # the scrap row is left out of the comparison
    for f in ("req", "branch", "cls", "nvis"):
        np.testing.assert_array_equal(getattr(k.rings, f)[:, :cap].cpu().numpy(),
                                      getattr(c.rings, f)[:, :cap].numpy())
    for f in ("parked_us", "enter_us", "leave_us"):
        np.testing.assert_allclose(getattr(k.rings, f)[:, :cap].cpu().numpy(),
                                   getattr(c.rings, f)[:, :cap].numpy(),
                                   rtol=1e-6)
