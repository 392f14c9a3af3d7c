"""The port's heapq oracle ``repro_torch.core.py_sim`` against the reference's.

``simulate_py`` draws from ``random.Random(seed)`` in the reference's
order over the same compiled arrays, so for one network, hit ratio and
seed every number it returns must equal ``repro.core.py_sim.simulate_py``'s
exactly (``==``, no tolerance): the closed loop, coalescing with uniform
and Zipf flows, a network of two disks (shard-local flow groups), the
open loop with and without bursts, trace records, and the tiered path
given the reference's ``MshrSpec``.
"""

import dataclasses
import random

import numpy as np
import pytest

from repro.core import build as jbuild
from repro.core.py_sim import _flow_sampler as j_flow_sampler
from repro.core.py_sim import simulate_py as jsimulate_py
from repro.core.queueing import QUEUE as JQUEUE
from repro.core.queueing import THINK as JTHINK
from repro.core.queueing import Branch as JBranch
from repro.core.queueing import ClosedNetwork as JClosedNetwork
from repro.core.queueing import Station as JStation
from repro.hierarchy import hierarchy_network
from repro_torch.core import queueing as tq
from repro_torch.core.py_sim import _flow_sampler, simulate_py

N_REQUESTS = 2_500


def port_network(jnet):
    """The port's copy of a reference ``ClosedNetwork`` (same stations,
    service laws and branches)."""
    stations = tuple(tq.Station(**{f.name: getattr(s, f.name)
                                   for f in dataclasses.fields(s)})
                     for s in jnet.stations)
    branches = tuple(tq.Branch(b.name, b.prob, b.visits) for b in jnet.branches)
    return tq.ClosedNetwork(jnet.name, stations, branches, jnet.mpl,
                            jnet.description)


def two_disk_network(mpl=16):
    """Two backing stores, so two flow groups (as a 2-shard cluster)."""
    stations = (JStation("lookup", JTHINK, 0.5),
                JStation("s0:disk", JTHINK, 40.0, dist="exp"),
                JStation("s1:disk", JQUEUE, 30.0, dist="det", servers=2),
                JStation("head", JQUEUE, 0.6))
    branches = (JBranch("hit", lambda p: p, ("lookup", "head")),
                JBranch("miss0", lambda p: (1.0 - p) / 2,
                        ("lookup", "s0:disk", "head")),
                JBranch("miss1", lambda p: (1.0 - p) / 2,
                        ("lookup", "s1:disk", "head")))
    return JClosedNetwork("two disks", stations, branches, mpl)


def assert_same(got, want, path="result"):
    """``got`` equals ``want`` exactly: dicts key by key, trace records
    field by field, arrays element by element (NaN where NaN)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            assert_same(getattr(got, f.name), getattr(want, f.name),
                        f"{path}.{f.name}")
    elif want is None:
        assert got is None, path
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.shape == b.shape, path
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path


# (id, reference network, p_hit, simulate_py keywords)
CASES = [
    ("lru-closed", lambda: jbuild("lru", disk_us=100.0), 0.7, {}),
    ("fifo-io-depth", lambda: jbuild("fifo", disk_us=500.0, disk_servers=8),
     0.5, {}),
    ("clock-pareto", lambda: jbuild("clock", disk_us=100.0), 0.8, {}),
    ("lru-coalesce-theta0", lambda: jbuild("lru", disk_us=100.0,
                                           disk_servers=4),
     0.5, dict(coalesce_flows=16)),
    ("lru-coalesce-theta1", lambda: jbuild("lru", disk_us=100.0), 0.5,
     dict(coalesce_flows=16, coalesce_theta=1.0)),
    ("two-disks-coalesce", two_disk_network, 0.4,
     dict(coalesce_flows=4, coalesce_theta=0.99)),
    ("open", lambda: jbuild("lru", disk_us=5.0), 0.7,
     dict(arrival_rate=0.8, max_in_system=64)),
    ("open-burst-coalesce", lambda: jbuild("lru", disk_us=100.0,
                                           disk_servers=8), 0.5,
     dict(arrival_rate=0.12, burst=(0.5, 200.0), coalesce_flows=16)),
    ("open-drops", lambda: jbuild("lru", disk_us=100.0), 0.3,
     dict(arrival_rate=2.0, max_in_system=4)),
    ("closed-trace", lambda: jbuild("lru", disk_us=100.0), 0.6,
     dict(trace=64)),
    ("coalesce-trace", lambda: jbuild("lru", disk_us=100.0), 0.5,
     dict(trace=4096, coalesce_flows=8)),
    ("open-trace", lambda: jbuild("lru", disk_us=5.0), 0.7,
     dict(arrival_rate=0.8, trace=128, coalesce_flows=4)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("seed", [0, 3])
def test_simulate_py_equals_the_reference(case, seed):
    _, net, p, kw = case
    jnet = net()
    want = jsimulate_py(jnet, p, n_requests=N_REQUESTS, seed=seed, full=True,
                        **kw)
    got = simulate_py(port_network(jnet), p, n_requests=N_REQUESTS,
                      seed=seed, full=True, **kw)
    assert_same(got, want)


def test_bare_float_return_equals_the_reference():
    jnet = jbuild("slru", disk_us=100.0)
    want = jsimulate_py(jnet, 0.6, n_requests=N_REQUESTS, seed=1)
    got = simulate_py(port_network(jnet), 0.6, n_requests=N_REQUESTS, seed=1)
    assert type(got) is type(want) and got == want


@pytest.mark.parametrize("seed", [0, 1])
def test_tiered_path_equals_the_reference(seed):
    """The cross-tier MSHR path, given the reference's ``MshrSpec``: the
    port reads only its annotation arrays."""
    hm = hierarchy_network("lru", "lru", n_clients=2, n_shards=2, mpl=16,
                           disk_us=50.0)
    kw = dict(n_requests=N_REQUESTS, seed=seed, full=True, tiers=hm.mshr,
              coalesce_flows=2)
    want = jsimulate_py(hm.network, 0.4, **kw)
    got = simulate_py(port_network(hm.network), 0.4, **kw)
    assert_same(got, want)
    assert got["delayed"] > 0


@pytest.mark.parametrize("theta", [0.0, 0.99])
def test_flow_sampler_draws_the_reference_flows(theta):
    a, b = random.Random(5), random.Random(5)
    port, ref = _flow_sampler(a, 16, theta), j_flow_sampler(b, 16, theta)
    assert [port() for _ in range(500)] == [ref() for _ in range(500)]


def test_the_sketch_hook_raises():
    """The sketch hook runs the exact twin, as the reference's does: the
    closed loop's estimates equal the reference's (no raise any more)."""
    jnet = jbuild("lru")
    kw = dict(n_requests=300, full=True, sketch_cap=8, window_us=10.0,
              coalesce_flows=4)
    port = simulate_py(port_network(jnet), 0.5, **kw)["sketch"]
    ref = jsimulate_py(jnet, 0.5, **kw)["sketch"]
    assert port.key_count == ref.key_count > 0
    for f in ("window_id", "win_done_count", "win_hit_frac",
              "win_branch_rate", "topk_key", "topk_count"):
        assert np.array_equal(getattr(port, f), getattr(ref, f),
                              equal_nan=True), f
    assert port.ewma_hit_frac == ref.ewma_hit_frac


@pytest.mark.parametrize("kw", [dict(), dict(arrival_rate=0.5)])
def test_errors_are_the_reference_errors(kw):
    """The reference's argument checks, kept: trace in the closed loop
    needs ``full=True``; a network without a disk cannot coalesce."""
    jnet = jbuild("lru")
    net = port_network(jnet)
    if not kw:
        with pytest.raises(ValueError, match="full=True"):
            simulate_py(net, 0.5, n_requests=100, trace=4)
    nodisk = dataclasses.replace(net, stations=tuple(
        dataclasses.replace(s, name="store" if s.name == "disk" else s.name)
        for s in net.stations), branches=tuple(
        dataclasses.replace(b, visits=tuple("store" if v == "disk" else v
                                            for v in b.visits))
        for b in net.branches))
    with pytest.raises(ValueError, match="no 'disk' station"):
        simulate_py(nodisk, 0.5, n_requests=100, coalesce_flows=4, **kw)
