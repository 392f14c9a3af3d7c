"""The event-sim kernel against its plain version, on the card.

These tests import neither jax nor the JAX package, so they run where the
card is (``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_event_sim_cuda.py``); without a card they skip.  Every
instantiation of the kernel is held, untraced and traced: job state in
1, 2, 4 and 8 register slots per thread (mpl 1, 24, 48, 72, 144) and in
shared memory (mpl 300), a route of 41 visits (the traced kernel's
instantiation for routes longer than a warp), and a grid padding three
networks of different shapes, which must also equal each network
launched alone.  Kernel and
plain version draw the same uniforms through the same float32 formulas:
``completed`` and ``events`` identical, throughput and stamps within
1e-6 (torch's and CUDA's log/pow may differ in the last ulp).

The coalescing and open-loop instantiations are held the same way
(``COALESCE_CASES``, ``OPEN_CASES``, which ``chip_smoke.py`` runs too):
flows F 1, 16 and 64, uniform and Zipf(0.99), one and two disk ranks,
job slots in registers and in shared memory, with and without bursts.
On deterministic service every output is identical, the per-branch
counts, sojourns and classes included.

The counting instantiation (``count_branches`` without coalescing) is
held against its plain version and against the closed kernel, whose
events it must repeat draw for draw (``COUNT_CASES``), and lanes of the
sharded cluster's composed networks run through the counting and the
coalescing instantiations (``CLUSTER_CASES``: 4 shards at mpl 48, 8
shards at mpl 96, 16 shards at mpl 192 and 8 shards at the cluster's
default mpl, 576 jobs in shared memory); both lists run in
``chip_smoke.py`` too.

The tiered instantiation (``tiers``: cross-tier leader tables and
cascading fills) is held on lanes of composed hierarchies
(``TIERS_CASES``, which ``chip_smoke.py``'s ``tiers_vs_plain`` runs): 2
clients and 2 shards at mpl 16, 48, 72, 192 and 300 (1, 2, 4, 8 register
slots and shared memory), F 2 and 4, uniform and Zipf flows,
``benchmarks/fig_hierarchy.py``'s 3 clients x 2 shards at mpl 96 and F 4,
and one job whose fill and re-acquire hit the same entry in one event.
Integers (completions, events, per-branch counts) are identical, and on
deterministic service every output, the per-level delayed fractions
included.

The sketched instantiations (``sketch_cap > 0``: the streaming
estimators in the launch) are held on ``SKETCH_CASES``, which
``chip_smoke.py``'s ``sketch_vs_plain`` runs: the closed loop (untraced
and traced, a route longer than a warp among them), the counting,
coalescing, open-loop (with a burst) and tiered modes, each at register
slots and in shared memory, on deterministic service.  Every field of the
sketch state is identical to the plain version's, the float32 EWMAs
included, and every simulation output is identical to the unsketched
kernel's.  The ``sketch_trace`` kernel is held against its plain version
and against the exact twin ``sketch_trace_py`` (``SKETCH_TRACE_CASES``).

The traced coalescing, open-loop and tiered instantiations are held on
``TRACE_EXT_CASES``, which ``chip_smoke.py``'s ``trace_ext_vs_plain``
runs: every register-slot count and shared memory, routes over 32 visits,
rings that overflow and rings that do not.  The rings' ``req``,
``branch``, ``cls`` and ``nvis`` are identical to the traced plain
version's, the stamps too on deterministic service, and every other
output is the untraced kernel's, with the sketch on as well.  The same
modes run through the entry points (``TRACED_ENTRY_MODES``:
``simulate_network`` with coalescing, the open loop with coalescing and
with bursts, the tiered tables; ``simulate_cluster`` and
``simulate_hierarchy`` with coalescing): the decoded ``traces`` on the
card equal the same call's on the CPU.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.core import policy_models as tpm
from repro_torch.core.queueing import QUEUE, THINK, Branch, ClosedNetwork, Station
from repro_torch.core.simspec import compile_network
from repro_torch.kernels import event_sim as tes
from repro_torch.kernels import sketch as tsk
from repro_torch.obs import streaming as tst

RTOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _hold(kern, plain, cap=0):
    assert torch.equal(kern.completed.cpu(), plain.completed.cpu())
    assert torch.equal(kern.events.cpu(), plain.events.cpu())
    for f in ("x", "t_measured"):
        np.testing.assert_allclose(getattr(kern, f).cpu().numpy(),
                                   getattr(plain, f).cpu().numpy(), rtol=RTOL)
    if not cap:
        return
    assert torch.equal(kern.rings.n_count.cpu(), kern.completed.cpu())
    # the scrap row is left out of the comparison
    for f in ("req", "branch", "cls", "nvis"):
        assert torch.equal(getattr(kern.rings, f)[:, :cap].cpu(),
                           getattr(plain.rings, f)[:, :cap].cpu()), f
    for f in ("parked_us", "enter_us", "leave_us"):
        np.testing.assert_allclose(getattr(kern.rings, f)[:, :cap].cpu(),
                                   getattr(plain.rings, f)[:, :cap].cpu(),
                                   rtol=RTOL, err_msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 128])
@pytest.mark.parametrize("mpl", [1, 24, 48, 72, 144, 300])
def test_kernel_matches_plain_at_every_instantiation(cuda_device, mpl, trace):
    net = tpm.lru_network(disk_us=100.0, mpl=mpl, disk_servers=2)
    spec, seeds, kw = tes.grid_lanes(net, np.array([0.5, 0.9]), 600, (0, 1),
                                     0.25, cuda_device, trace=trace)
    counter = "traced_launches" if trace else "launches"
    before = getattr(tes.sim_lanes, counter)
    kern = tes.sim_lanes(spec, seeds, **kw)
    assert getattr(tes.sim_lanes, counter) == before + 1
    _hold(kern, tes.sim_lanes_plain(spec, seeds, **kw), trace)
    if trace:
        untraced = tes.sim_lanes(spec, seeds, **{
            k: v for k, v in kw.items() if k not in ("trace_cap", "bmiss")})
        for f in ("x", "completed", "events", "t_measured"):
            assert torch.equal(getattr(kern, f), getattr(untraced, f)), f


def long_route_network(mpl):
    """A request that alternates two queues twenty times after a think
    station (41 visits), or visits one queue once."""
    stations = (Station("think", THINK, 2.0, dist="exp"),
                Station("a", QUEUE, 0.05, dist="det"),
                Station("b", QUEUE, 0.04, dist="pareto",
                        dist_params=(0.45, 0.1, 1.2), servers=2))
    branches = (Branch("long", lambda p: p, ("think",) + ("a", "b") * 20),
                Branch("short", lambda p: 1.0 - p, ("think", "a")))
    return ClosedNetwork("long route", stations, branches, mpl)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 512])
def test_route_longer_than_a_warp(cuda_device, trace):
    spec, seeds, kw = tes.grid_lanes(long_route_network(24),
                                     np.array([0.3, 0.8]), 300, (0, 1), 0.25,
                                     cuda_device, trace=trace)
    assert spec.visits.shape[-1] == 41
    _hold(tes.sim_lanes(spec, seeds, **kw),
          tes.sim_lanes_plain(spec, seeds, **kw), trace)


@pytest.mark.cuda
def test_padded_grid_on_card(cuda_device):
    nets = [tpm.lru_network(disk_us=100.0), tpm.s3fifo_network(disk_us=100.0),
            tpm.slru_network(disk_us=100.0, disk_servers=2)]
    specs = [compile_network(n, p, device=cuda_device)
             for n, p in zip(nets, (0.6, 0.8, 0.9))]
    seeds = [0, 7, 2001]
    lane, seed_v, kw = tes.pad_lanes(specs, seeds, 2000, 0.25)
    kern = tes.sim_lanes(lane, seed_v, **kw)
    _hold(kern, tes.sim_lanes_plain(lane, seed_v, **kw))
    for i, (spec, seed) in enumerate(zip(specs, seeds)):
        one, one_seed, one_kw = tes.pad_lanes([spec], [seed], 2000, 0.25)
        alone = tes.sim_lanes(one, one_seed, **one_kw)
        for f in ("x", "completed", "events", "t_measured"):
            assert torch.equal(getattr(kern, f)[i:i + 1], getattr(alone, f)), f


def det_network(net):
    """The network with every station's service made deterministic."""
    return dataclasses.replace(net, stations=tuple(
        dataclasses.replace(s, dist="det", dist_params=())
        for s in net.stations))


def two_disk_network(mpl: int = 16) -> ClosedNetwork:
    """Two backing stores ("s0:disk" a think station, "s1:disk" a 2-server
    queue), so two flow groups: a miss coalesces only within its own."""
    stations = (Station("lookup", THINK, 0.5),
                Station("s0:disk", THINK, 40.0, dist="exp"),
                Station("s1:disk", QUEUE, 30.0, dist="det", servers=2),
                Station("head", QUEUE, 0.6))
    branches = (Branch("hit", lambda p: p, ("lookup", "head")),
                Branch("miss0", lambda p: (1.0 - p) / 2,
                       ("lookup", "s0:disk", "head")),
                Branch("miss1", lambda p: (1.0 - p) / 2,
                       ("lookup", "s1:disk", "head")))
    return ClosedNetwork("two disks", stations, branches, mpl)


def _lru(mpl, det, disk_servers=2):
    net = tpm.lru_network(disk_us=20.0, mpl=mpl, disk_servers=disk_servers)
    return det_network(net) if det else net


def _two(mpl, det):
    return det_network(two_disk_network(mpl)) if det else two_disk_network(mpl)


# (id, network, F, theta, deterministic service): mpl 24, 48, 72, 144 and
# 300 run 1, 2, 4, 8 register slots per thread and shared memory
COALESCE_CASES = [
    ("lru-mpl24-F1", lambda: _lru(24, True), 1, 0.0, True),
    ("lru-mpl48-F16", lambda: _lru(48, True), 16, 0.0, True),
    ("lru-mpl72-F64-zipf", lambda: _lru(72, True), 64, 0.99, True),
    ("lru-mpl144-F16-zipf", lambda: _lru(144, True), 16, 0.99, True),
    ("lru-mpl300-F16", lambda: _lru(300, True), 16, 0.0, True),
    ("2disk-mpl72-F1", lambda: _two(72, True), 1, 0.0, True),
    ("2disk-mpl72-F64-zipf", lambda: _two(72, True), 64, 0.99, True),
    ("lru-exp-mpl72-F16", lambda: _lru(72, False, 8), 16, 0.0, False),
    ("2disk-exp-mpl24-F16-zipf", lambda: _two(24, False), 16, 0.99, False),
]
# (id, network, max_in_system, F, burst, deterministic service) at arrival
# rates 0.1 and 0.6 per us; the interarrival times are exponential in
# every case, and 4 slots are too few (arrivals are dropped)
OPEN_CASES = [
    ("lru-N128", lambda: _lru(1, True, 8), 128, 0, None, True),
    ("lru-N128-F16", lambda: _lru(1, True, 8), 128, 16, None, True),
    ("lru-N256-F16-burst", lambda: _lru(1, True, 8), 256, 16, (0.6, 200.0),
     True),
    ("lru-N300-burst", lambda: _lru(1, True, 8), 300, 0, (0.6, 200.0), True),
    ("lru-N300-F16", lambda: _lru(1, True, 8), 300, 16, None, True),
    ("lru-N40-F1-burst", lambda: _lru(1, True, 8), 40, 1, (0.5, 100.0), True),
    ("lru-N4-F4-drops", lambda: _lru(1, True, 8), 4, 4, None, True),
    ("2disk-N64-F16-burst", lambda: _two(1, True), 64, 16, (0.6, 200.0), True),
    ("lru-exp-N256-F16", lambda: _lru(1, False, 8), 256, 16, None, False),
]
OPEN_RATES = np.array([0.1, 0.6])


# (id, network, deterministic service) of the counting instantiation:
# mpl 24, 48, 72, 144, 300 run 1, 2, 4, 8 register slots and shared memory
COUNT_CASES = [
    ("lru-mpl24", lambda: _lru(24, True), True),
    ("lru-mpl48", lambda: _lru(48, True), True),
    ("lru-exp-mpl72", lambda: _lru(72, False), False),
    ("lru-mpl144", lambda: _lru(144, True), True),
    ("lru-mpl300", lambda: _lru(300, True), True),
    ("2disk-exp-mpl24", lambda: _two(24, False), False),
]


def cluster_model(n_shards, mpl=None, policy="lru", theta=1.0,
                  key_space=1024):
    """The composed cluster of ``tests/test_cluster.py``: ``n_shards``
    shards behind a 64-vnode ring (seed 1), ideal profile of Zipf(theta)
    keys, a 100 us disk; ``mpl`` None is the cluster's default, 72 jobs per
    shard."""
    from repro_torch.cluster import (HashRing, cluster_network,
                                     ideal_shard_profile, zipf_key_probs)

    probs = zipf_key_probs(key_space, theta, seed=0)
    assign = HashRing(n_shards, vnodes=64, seed=1).assignment(key_space)
    return cluster_network(policy, n_shards,
                           profile=ideal_shard_profile(assign, probs),
                           disk_us=100.0, mpl=mpl)


# (id, shards, mpl (None: the default), flows per shard; 0: counting):
# the widths the cluster's phases launch — 4 shards at mpl 48 (2 register
# slots), fig_cluster C's 8 shards at mpl 96 (4 slots), the differential's
# 16 shards at mpl 192 (K 65, B 32, a 16 x 8 leader table; 8 slots) and 8
# shards at the default mpl 576 (jobs in shared memory)
CLUSTER_CASES = [
    ("4shard-mpl48-F8", 4, 48, 8),
    ("4shard-mpl48-count", 4, 48, 0),
    ("8shard-mpl96-F8", 8, 96, 8),
    ("16shard-mpl192-F8", 16, 192, 8),
    ("16shard-mpl192-count", 16, 192, 0),
    ("8shard-mpl576-F8", 8, None, 8),
    ("8shard-mpl576-count", 8, None, 0),
]


def hierarchy_model(kind, mpl=16):
    """The hierarchies of the tiered cases: ``"small"`` is
    ``tests/test_hierarchy.py``'s (2 LRU clients, 2 LRU shards, a 50 us
    origin, constant p2 0.5), ``"fig"`` ``benchmarks/fig_hierarchy.py``'s
    LRU-client model (3 clients, 2 shards, its Che profile, a 100 us
    origin), ``"refill"`` one job whose route fills an entry at position 1
    and acquires it again at position 2."""
    from repro_torch.cluster import zipf_key_probs
    from repro_torch.core.simspec import MshrSpec
    from repro_torch.hierarchy import hierarchy_network, tiered_profile

    if kind == "small":
        return hierarchy_network("lru", "lru", n_clients=2, n_shards=2,
                                 mpl=mpl, disk_us=50.0)
    if kind == "fig":
        prof = tiered_profile(zipf_key_probs(256, 0.8, seed=0),
                              np.array([4, 8, 16, 32, 64, 96, 128, 176, 224]),
                              l2_cap=32, assign=np.arange(256) % 2,
                              n_shards=2)
        return hierarchy_network("lru", "lru", n_clients=3, n_shards=2,
                                 profile=prof, disk_us=100.0, mpl=mpl)
    net = ClosedNetwork(
        "refill", (Station("think", THINK, 1.0), Station("a", QUEUE, 0.3),
                   Station("disk", THINK, 0.2)),
        (Branch("x", lambda p: 1.0, ("think", "a", "disk")),), mpl=1)
    tables = [np.array([[-1, 0, 0]], np.int32)] * 3
    return dataclasses.make_dataclass("Refill", ["network", "mshr"])(
        net, MshrSpec(*tables, n_groups=1, max_held=1))


# (id, hierarchy, mpl, F, theta, p_hits, deterministic service): mpl 16,
# 48, 72, 192 and 300 run 1, 2, 4, 8 register slots and shared memory;
# 0.8393 is the p of the reference's failing tiered-twins case
TIERS_CASES = [
    ("small-mpl16-F2", "small", 16, 2, 0.0, (0.2, 0.5, 0.8393), True),
    ("small-mpl16-F4", "small", 16, 4, 0.0, (0.35, 0.8), True),
    ("small-exp-mpl16-F2", "small", 16, 2, 0.0, (0.35, 0.8393), False),
    ("small-mpl48-F4-zipf", "small", 48, 4, 0.99, (0.3, 0.7), True),
    ("small-mpl72-F2", "small", 72, 2, 0.0, (0.4,), True),
    ("small-mpl192-F8", "small", 192, 8, 0.0, (0.5,), True),
    ("small-mpl300-F4", "small", 300, 4, 0.0, (0.5,), True),
    ("fig-mpl96-F4", "fig", 96, 4, 0.0, (0.3, 0.55, 0.8), False),
    ("fig-det-mpl96-F4", "fig", 96, 4, 0.0, (0.55,), True),
    ("refill-mpl1-F1", "refill", 1, 1, 0.0, (0.5,), True),
]


def tiers_pair(case, device, n_requests=300, seeds=(0, 1)):
    """Kernel and plain outputs of a ``TIERS_CASES`` case: its p_hits x
    ``seeds``, at least ``n_requests`` requests and enough for two
    measured completions per job."""
    _, kind, mpl, flows, theta, ps, det = case
    model = hierarchy_model(kind, mpl)
    net = det_network(model.network) if det else model.network
    n_requests = max(n_requests, math.ceil(2 * net.mpl / 0.75))
    spec, seed_t, kw = tes.grid_lanes(net, np.array(ps), n_requests, seeds,
                                      0.25, device, coalesce_flows=flows,
                                      coalesce_theta=theta, tiers=model.mshr)
    return (tes.sim_lanes(spec, seed_t, **kw),
            tes.sim_lanes_plain(spec, seed_t, **kw))


def hold_tiered(kern, plain, exact) -> float:
    """As :func:`hold_coalesced`, and the per-level delayed fractions
    identical on deterministic service, else within RTOL.  Returns max
    |dx|."""
    err = hold_coalesced(kern, plain, exact)
    a, b = kern.delayed_tier.cpu(), plain.delayed_tier.cpu()
    if exact:
        assert torch.equal(a, b)
    else:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL)
    return err


def count_pair(case, device, n_requests=400):
    """Counting kernel, its plain version and the closed kernel on a
    ``COUNT_CASES`` case: two p_hits x two seeds."""
    _, net, _ = case
    spec, seeds, kw = tes.grid_lanes(net(), np.array([0.3, 0.7]), n_requests,
                                     (0, 1), 0.25, device)
    return (tes.sim_lanes(spec, seeds, count_branches=True, **kw),
            tes.sim_lanes_plain(spec, seeds, count_branches=True, **kw),
            tes.sim_lanes(spec, seeds, **kw))


def cluster_pair(case, device, n_requests=300):
    """Kernel and plain outputs of a ``CLUSTER_CASES`` case: the cluster
    network at two global p_hits, one seed, with the per-branch counts;
    at least ``n_requests`` requests, and enough that the measured window
    (after the 25% warmup) holds two completions per job."""
    _, n_shards, mpl, flows = case
    net = cluster_model(n_shards, mpl).network
    n_requests = max(n_requests, math.ceil(2 * net.mpl / 0.75))
    spec, seeds, kw = tes.grid_lanes(net, np.array([0.45, 0.75]), n_requests,
                                     (0,), 0.25, device,
                                     coalesce_flows=flows)
    return (tes.sim_lanes(spec, seeds, count_branches=True, **kw),
            tes.sim_lanes_plain(spec, seeds, count_branches=True, **kw))


def traced_count_pair(device, n_requests=300, cap=64):
    """A traced run with per-branch counts (on the card: one traced and one
    counting launch) and its plain version (one pass): a 4-shard cluster
    lane at two global p_hits."""
    net = cluster_model(4, 48).network
    spec, seeds, kw = tes.grid_lanes(net, np.array([0.45, 0.75]), n_requests,
                                     (0,), 0.25, device, trace=cap)
    return (tes.sim_lanes(spec, seeds, count_branches=True, **kw),
            tes.sim_lanes_plain(spec, seeds, count_branches=True, **kw))


def hold_traced_count(kern, plain, cap=64) -> float:
    """Records as the traced kernel's are held, counts as the counting
    kernel's.  Returns max |dx|."""
    _hold(kern, plain, cap)
    return hold_coalesced(kern, plain, exact=False)


def coalesce_pair(case, device, n_requests=400):
    """Kernel and plain outputs of a ``COALESCE_CASES`` case: two p_hits x
    two seeds."""
    _, net, flows, theta, _ = case
    spec, seeds, kw = tes.grid_lanes(net(), np.array([0.3, 0.7]), n_requests,
                                     (0, 1), 0.25, device,
                                     coalesce_flows=flows,
                                     coalesce_theta=theta)
    return (tes.sim_lanes(spec, seeds, **kw),
            tes.sim_lanes_plain(spec, seeds, **kw))


def hold_coalesced(kern, plain, exact) -> float:
    """Integer outputs identical; throughput, measured time and delayed
    fraction identical on deterministic service, else within RTOL.
    Returns max |dx|."""
    for f in ("completed", "events", "branch_done", "branch_delayed"):
        assert torch.equal(getattr(kern, f).cpu(), getattr(plain, f).cpu()), f
    for f in ("x", "t_measured", "delayed_frac"):
        a, b = getattr(kern, f).cpu(), getattr(plain, f).cpu()
        if exact:
            assert torch.equal(a, b), f
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                       err_msg=f)
    return float((kern.x.cpu() - plain.x.cpu()).abs().max())


def hold_counted(kern, plain, closed, exact) -> float:
    """The counting kernel against its plain version (as
    :func:`hold_coalesced`), and its events, completions, throughput and
    measured time identical to the closed kernel's.  Returns max |dx|."""
    err = hold_coalesced(kern, plain, exact)
    for f in ("x", "completed", "events", "t_measured"):
        assert torch.equal(getattr(kern, f), getattr(closed, f)), f
    return err


def open_pair(case, device, n_requests=250):
    """Kernel and plain outputs of an ``OPEN_CASES`` case: two p_hits x
    two seeds."""
    _, net, n_slots, flows, burst, _ = case
    spec, seeds, kw = tes.open_lanes(net(), np.array([0.5, 0.8]), OPEN_RATES,
                                     n_requests, (0, 1), 0.25, n_slots,
                                     burst=burst, coalesce_flows=flows,
                                     device=device)
    return (tes.sim_open_lanes(spec, seeds, **kw),
            tes.sim_open_lanes_plain(spec, seeds, **kw))


def hold_open(kern, plain, exact) -> float:
    """Counts, drops and classes identical; sojourns, throughput and
    measured time identical on deterministic service, else within RTOL.
    Returns max |d sojourn| (µs)."""
    for f in ("completed", "events", "dropped", "cls"):
        assert torch.equal(getattr(kern, f).cpu(), getattr(plain, f).cpu()), f
    for f in ("x", "t_measured", "delayed_frac", "sojourn_us"):
        a, b = getattr(kern, f).cpu(), getattr(plain, f).cpu()
        if exact:
            assert torch.equal(a, b), f
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                       err_msg=f)
    return float((kern.sojourn_us.cpu() - plain.sojourn_us.cpu()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", COALESCE_CASES, ids=[c[0] for c in COALESCE_CASES])
def test_coalescing_kernel_matches_plain(cuda_device, case):
    before = tes.sim_lanes.flows_launches
    kern, plain = coalesce_pair(case, cuda_device)
    assert tes.sim_lanes.flows_launches == before + 1
    hold_coalesced(kern, plain, exact=case[-1])
    assert float(kern.delayed_frac.max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", OPEN_CASES, ids=[c[0] for c in OPEN_CASES])
def test_open_kernel_matches_plain(cuda_device, case):
    before = tes.sim_open_lanes.launches
    kern, plain = open_pair(case, cuda_device)
    assert tes.sim_open_lanes.launches == before + 1
    hold_open(kern, plain, exact=case[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", COUNT_CASES, ids=[c[0] for c in COUNT_CASES])
def test_counting_kernel_matches_plain(cuda_device, case):
    before = tes.sim_lanes.count_launches
    kern, plain, closed = count_pair(case, cuda_device)
    assert tes.sim_lanes.count_launches == before + 1
    hold_counted(kern, plain, closed, exact=case[-1])
    measured = kern.completed.long() - int(0.25 * 400)
    assert torch.equal(kern.branch_done.long().sum(dim=1), measured)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CLUSTER_CASES,
                         ids=[c[0] for c in CLUSTER_CASES])
def test_cluster_lanes_match_plain(cuda_device, case):
    counter = "flows_launches" if case[-1] else "count_launches"
    before = getattr(tes.sim_lanes, counter)
    kern, plain = cluster_pair(case, cuda_device)
    assert getattr(tes.sim_lanes, counter) == before + 1
    hold_coalesced(kern, plain, exact=False)
    assert int((kern.branch_done > 0).sum()) > case[1]


@pytest.mark.cuda
def test_traced_counting_takes_two_launches(cuda_device):
    before = (tes.sim_lanes.traced_launches, tes.sim_lanes.count_launches)
    kern, plain = traced_count_pair(cuda_device)
    assert (tes.sim_lanes.traced_launches, tes.sim_lanes.count_launches) == \
        (before[0] + 1, before[1] + 1)
    hold_traced_count(kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TIERS_CASES, ids=[c[0] for c in TIERS_CASES])
def test_tiered_kernel_matches_plain(cuda_device, case):
    before = tes.sim_lanes.tiers_launches
    kern, plain = tiers_pair(case, cuda_device)
    assert tes.sim_lanes.tiers_launches == before + 1
    hold_tiered(kern, plain, exact=case[-1])
    if case[1] == "refill":  # the job never parks behind its own fill
        assert float(kern.delayed_frac.max()) == 0.0
    else:
        assert float(kern.delayed_tier[:, 0].max()) > 0.0


@pytest.mark.cuda
def test_tiered_kernel_refuses_too_many_levels(cuda_device):
    model = hierarchy_model("small")
    spec, seeds, kw = tes.grid_lanes(model.network, np.array([0.5]), 50, (0,),
                                     0.25, cuda_device, coalesce_flows=2,
                                     tiers=model.mshr)
    kw["tiers"] = kw["tiers"]._replace(max_held=tes.MAX_HELD + 1)
    with pytest.raises(ValueError, match="MAX_HELD"):
        tes.sim_lanes(spec, seeds, **kw)


# (id, mode, lanes): the sketched instantiations, each mode at register
# slots and in shared memory (mpl or slots 300), on deterministic service;
# "trace" 64 runs the traced closed kernel (the long route: its
# instantiation for routes over 32 visits).  Caps up to 32 and past it
# (a coalescing, an open-loop and a tiered case with more SpaceSaving
# slots than the warp has threads); "wraps": windows short enough that
# the ring comes back to its slots; "partial": some lane observes a number
# of keys that is not a multiple of 32 (the count-min block flushed at
# the end); "branches": B, the largest any path runs (fig_cluster's 16
# shards: 32, one register a thread) and past it
SKETCH_CASES = [
    ("closed-mpl24", "closed", dict(net=lambda: _lru(24, True), cap=16,
                                    window=20.0)),
    ("closed-mpl144", "closed", dict(net=lambda: _lru(144, True), cap=8,
                                     window=50.0)),
    ("closed-mpl300", "closed", dict(net=lambda: _lru(300, True), cap=8,
                                     window=50.0)),
    ("traced-mpl48", "closed", dict(net=lambda: _lru(48, True), trace=64,
                                    cap=16, window=20.0)),
    ("traced-long-mpl24", "closed", dict(
        net=lambda: det_network(long_route_network(24)), trace=64, cap=16,
        window=20.0)),
    ("count-mpl48", "count", dict(net=lambda: _lru(48, True), cap=16,
                                  window=20.0)),
    ("count-4shard-mpl48", "count", dict(
        net=lambda: det_network(cluster_model(4, 48).network), cap=16,
        window=50.0)),
    ("flows-mpl72-F64-zipf", "flows", dict(net=lambda: _lru(72, True),
                                           flows=64, theta=0.99, cap=16,
                                           window=20.0)),
    ("flows-2disk-mpl144-F16", "flows", dict(net=lambda: _two(144, True),
                                             flows=16, cap=32, window=20.0)),
    ("flows-mpl300-F16", "flows", dict(net=lambda: _lru(300, True), flows=16,
                                       cap=8, window=50.0)),
    ("open-N128-F16-burst", "open", dict(net=lambda: _lru(1, True, 8),
                                         slots=128, flows=16,
                                         burst=(0.6, 200.0), cap=16,
                                         window=20.0)),
    ("open-N300-F16", "open", dict(net=lambda: _lru(1, True, 8), slots=300,
                                   flows=16, cap=16, window=20.0)),
    ("open-N64-burst", "open", dict(net=lambda: _two(1, True), slots=64,
                                    burst=(0.6, 200.0), cap=8, window=20.0)),
    ("tiers-small-mpl16-F2", "tiers", dict(kind="small", mpl=16, flows=2,
                                           ps=(0.2, 0.8393), cap=8,
                                           window=20.0)),
    ("tiers-fig-mpl96-F4", "tiers", dict(kind="fig", mpl=96, flows=4,
                                         ps=(0.55,), cap=16, window=50.0)),
    ("tiers-small-mpl300-F4", "tiers", dict(kind="small", mpl=300, flows=4,
                                            ps=(0.5,), cap=8, window=50.0)),
    ("closed-mpl24-wraps", "closed", dict(net=lambda: _lru(24, True), cap=8,
                                          window=1.0, wraps=True)),
    ("count-16shard-mpl64-B32", "count", dict(
        net=lambda: det_network(cluster_model(16, 64).network), cap=16,
        window=50.0, branches=32)),
    ("count-17shard-mpl68-B34", "count", dict(
        net=lambda: det_network(cluster_model(17, 68).network), cap=16,
        window=20.0, branches=34)),
    ("flows-mpl72-F64-zipf-cap48", "flows", dict(
        net=lambda: _lru(72, True), flows=64, theta=0.99, cap=48,
        window=20.0)),
    ("flows-mpl24-F8-wraps-partial", "flows", dict(
        net=lambda: _lru(24, True), flows=8, cap=8, window=2.0, wraps=True,
        partial=True)),
    ("open-N128-F64-cap40", "open", dict(net=lambda: _lru(1, True, 8),
                                         slots=128, flows=64, cap=40,
                                         window=20.0)),
    ("tiers-fig-mpl96-F64-cap33", "tiers", dict(kind="fig", mpl=96,
                                                flows=64, ps=(0.55,), cap=33,
                                                window=50.0)),
]


def sketch_lanes(case, device, n_requests=300):
    """``(kernel wrapper, plain version, spec, seeds, kwargs)`` of a
    ``SKETCH_CASES`` case: its networks at two p_hits x two seeds (the
    tiered cases at their own p_hits), at least ``n_requests`` requests and
    enough for two measured completions per job."""
    _, mode, c = case
    if mode == "open":
        spec, seeds, kw = tes.open_lanes(c["net"](), np.array([0.5, 0.8]),
                                         OPEN_RATES, n_requests, (0, 1), 0.25,
                                         c["slots"], burst=c.get("burst"),
                                         coalesce_flows=c.get("flows", 0),
                                         device=device)
        return tes.sim_open_lanes, tes.sim_open_lanes_plain, spec, seeds, kw
    tiers, ps = None, np.array([0.3, 0.7])
    if mode == "tiers":
        model = hierarchy_model(c["kind"], c["mpl"])
        net, tiers, ps = det_network(model.network), model.mshr, np.array(c["ps"])
    else:
        net = c["net"]()
    n_requests = max(n_requests, math.ceil(2 * net.mpl / 0.75))
    spec, seeds, kw = tes.grid_lanes(net, ps, n_requests, (0, 1), 0.25, device,
                                     trace=c.get("trace", 0),
                                     coalesce_flows=c.get("flows", 0),
                                     coalesce_theta=c.get("theta", 0.0),
                                     tiers=tiers, sketch=True)
    if mode == "count":
        kw["count_branches"] = True
    return tes.sim_lanes, tes.sim_lanes_plain, spec, seeds, kw


def sketch_pair(case, device, n_requests=300):
    """The sketched kernel, the sketched plain version and the unsketched
    kernel on a ``SKETCH_CASES`` case."""
    kern_fn, plain_fn, spec, seeds, kw = sketch_lanes(case, device, n_requests)
    sk = dict(kw, sketch_cap=case[2]["cap"], window_us=case[2]["window"])
    return (kern_fn(spec, seeds, **sk), plain_fn(spec, seeds, **sk),
            kern_fn(spec, seeds, **kw))


def hold_sketch_case(case, kern) -> None:
    """A ``SKETCH_CASES`` case's own property: its branches, ring wraps or
    partial count-min block."""
    c = case[2]
    if "branches" in c:
        assert kern.sketch.win_branch_count.shape[2] == c["branches"]
        assert int((kern.sketch.win_branch_count[..., 32:] > 0).sum()) > 0 \
            or c["branches"] <= 32
    if c.get("wraps"):
        assert int(kern.sketch.win_id.max()) >= tst.N_WINDOWS
    if c.get("partial"):
        assert bool((kern.sketch.key_count % 32 != 0).any())


def hold_sketched(kern, plain, bare) -> int:
    """Every field of the kernel's sketch state identical to the plain
    version's, and every other output identical to the unsketched
    kernel's.  Returns the completions the sketch counted."""
    for f in tst.SketchState._fields:
        assert torch.equal(getattr(kern.sketch, f).cpu(),
                           getattr(plain.sketch, f).cpu()), f
    assert bare.sketch is None
    for f, a in kern._asdict().items():
        b = getattr(bare, f)
        if f == "sketch" or (a is None and b is None):
            continue
        if f == "rings":
            for fa, fb in zip(a, b):
                assert torch.equal(fa, fb), f
        else:
            assert torch.equal(a, b), f
    done = int(kern.sketch.win_done_count.sum())
    assert done > 0
    return done


@pytest.mark.cuda
@pytest.mark.parametrize("case", SKETCH_CASES, ids=[c[0] for c in SKETCH_CASES])
def test_sketched_kernel_matches_plain(cuda_device, case):
    before = tes.sim_lanes.sketch_launches
    kern, plain, bare = sketch_pair(case, cuda_device)
    assert tes.sim_lanes.sketch_launches == before + 1
    hold_sketched(kern, plain, bare)
    hold_sketch_case(case, kern)
    if case[1] in ("flows", "tiers") or case[2].get("flows"):
        assert int(kern.sketch.key_count.min()) > 0


def long_disk_network(mpl):
    """A miss that alternates two queues sixteen times and then fetches
    from a 4-deep disk (34 visits), or a hit that visits one queue:
    coalescing on a route longer than a warp (deterministic service)."""
    stations = (Station("think", THINK, 2.0), Station("a", QUEUE, 0.05),
                Station("b", QUEUE, 0.04, servers=2),
                Station("disk", QUEUE, 3.0, servers=4))
    branches = (Branch("hit", lambda p: p, ("think", "a")),
                Branch("miss", lambda p: 1.0 - p,
                       ("think",) + ("a", "b") * 16 + ("disk",)))
    return ClosedNetwork("long miss", stations, branches, mpl)


# (id, mode, config, deterministic service): the traced coalescing,
# open-loop and tiered instantiations (kTrace 2 at every route length):
# register slots and shared memory, uniform and Zipf flows, bursts, a pool
# that drops arrivals, routes over 32 visits, and rings that overflow
# (cap below the completions) and that do not
TRACE_EXT_CASES = [
    ("flows-lru-mpl24-F1", "flows",
     dict(net=lambda: _lru(24, True), flows=1, cap=1024), True),
    ("flows-lru-mpl72-F16-zipf-overflow", "flows",
     dict(net=lambda: _lru(72, True), flows=16, theta=0.99, cap=64), True),
    ("flows-2disk-mpl144-F16", "flows",
     dict(net=lambda: _two(144, True), flows=16, cap=2048), True),
    ("flows-lru-mpl300-F16", "flows",
     dict(net=lambda: _lru(300, True), flows=16, cap=2048), True),
    ("flows-exp-mpl48-F16-overflow", "flows",
     dict(net=lambda: _lru(48, False, 8), flows=16, cap=100), False),
    ("flows-34-visits-mpl24-F4", "flows",
     dict(net=lambda: det_network(long_disk_network(24)), flows=4, cap=256,
          requests=120), True),
    ("open-N128-F16", "open",
     dict(net=lambda: _lru(1, True, 8), slots=128, flows=16, cap=1024), True),
    ("open-N300-burst-overflow", "open",
     dict(net=lambda: _lru(1, True, 8), slots=300, burst=(0.6, 200.0),
          cap=64), True),
    ("open-N40-F1-burst", "open",
     dict(net=lambda: _lru(1, True, 8), slots=40, flows=1, burst=(0.5, 100.0),
          cap=512), True),
    ("open-N4-F4-drops", "open",
     dict(net=lambda: _lru(1, True, 8), slots=4, flows=4, cap=512), True),
    ("open-41-visits-N64", "open",
     dict(net=lambda: det_network(long_route_network(1)), slots=64, cap=512,
          requests=120), True),
    ("open-exp-N256-F16", "open",
     dict(net=lambda: _lru(1, False, 8), slots=256, flows=16, cap=512), False),
    ("tiers-small-mpl16-F2", "tiers",
     dict(kind="small", mpl=16, flows=2, ps=(0.2, 0.8393), cap=1024), True),
    ("tiers-small-mpl48-F4-zipf-overflow", "tiers",
     dict(kind="small", mpl=48, flows=4, theta=0.99, ps=(0.3, 0.7), cap=32),
     True),
    ("tiers-fig-mpl96-F4", "tiers",
     dict(kind="fig", mpl=96, flows=4, ps=(0.55,), cap=1024), True),
    ("tiers-small-mpl300-F4", "tiers",
     dict(kind="small", mpl=300, flows=4, ps=(0.5,), cap=2048), True),
    ("tiers-exp-small-mpl192-F8", "tiers",
     dict(kind="small", mpl=192, flows=8, ps=(0.4,), cap=1024), False),
    ("tiers-refill-mpl1-F1", "tiers",
     dict(kind="refill", mpl=1, flows=1, ps=(0.5,), cap=16), True),
]

# the launch counter of each traced mode
TRACE_EXT_COUNTERS = {"flows": (tes.sim_lanes, "traced_flows_launches"),
                      "open": (tes.sim_open_lanes, "traced_launches"),
                      "tiers": (tes.sim_lanes, "traced_tiers_launches")}


def trace_ext_lanes(case, device, n_requests=300):
    """``(kernel wrapper, plain version, spec, seeds, kwargs)`` of a
    ``TRACE_EXT_CASES`` case, traced into rings of its ``cap``: its network
    at two p_hits x two seeds (the tiered cases at their own p_hits; the
    open loop at ``OPEN_RATES``), ``n_requests`` requests (the case's own
    count on its long routes) and at least enough for one measured
    completion per job."""
    _, mode, c, det = case
    n_requests = c.get("requests", n_requests)
    if mode == "open":
        spec, seeds, kw = tes.open_lanes(c["net"](), np.array([0.5, 0.8]),
                                         OPEN_RATES, n_requests, (0, 1), 0.25,
                                         c["slots"], burst=c.get("burst"),
                                         coalesce_flows=c.get("flows", 0),
                                         device=device, trace=c["cap"])
        return tes.sim_open_lanes, tes.sim_open_lanes_plain, spec, seeds, kw
    tiers, ps = None, np.array([0.3, 0.7])
    if mode == "tiers":
        model = hierarchy_model(c["kind"], c["mpl"])
        net, tiers, ps = model.network, model.mshr, np.array(c["ps"])
        net = det_network(net) if det else net
    else:
        net = c["net"]()
    n_requests = max(n_requests, math.ceil(net.mpl / 0.75))
    spec, seeds, kw = tes.grid_lanes(net, ps, n_requests, (0, 1), 0.25, device,
                                     trace=c["cap"], coalesce_flows=c["flows"],
                                     coalesce_theta=c.get("theta", 0.0),
                                     tiers=tiers)
    return tes.sim_lanes, tes.sim_lanes_plain, spec, seeds, kw


def trace_ext_pair(case, device, n_requests=300):
    """The traced kernel, the traced plain version and the untraced kernel
    on a ``TRACE_EXT_CASES`` case."""
    kern_fn, plain_fn, spec, seeds, kw = trace_ext_lanes(case, device,
                                                         n_requests)
    bare = {k: v for k, v in kw.items() if k != "trace_cap"}
    return (kern_fn(spec, seeds, **kw), plain_fn(spec, seeds, **kw),
            kern_fn(spec, seeds, **bare))


def hold_untraced(kern, bare) -> None:
    """Every output of the traced launch but its rings identical to the
    untraced launch's."""
    assert bare.rings is None and kern.rings is not None
    for f, a in kern._asdict().items():
        b = getattr(bare, f)
        if f == "rings" or (a is None and b is None):
            continue
        if f == "sketch":
            for fa, fb in zip(a, b):
                assert torch.equal(fa, fb), f
        else:
            assert torch.equal(a, b), f


def hold_trace_ext(kern, plain, bare, exact) -> float:
    """The traced kernel's rings against the traced plain version's (the
    scrap row left out): ``req``, ``branch``, ``cls`` and ``nvis``
    identical, one record per completion, the stamps and parked times
    identical on deterministic service, else within RTOL; and its other
    outputs identical to the untraced kernel's.  Returns max |d stamp|
    (µs)."""
    hold_untraced(kern, bare)
    assert torch.equal(kern.completed.cpu(), plain.completed.cpu())
    assert torch.equal(kern.events.cpu(), plain.events.cpu())
    assert torch.equal(kern.rings.n_count.cpu(), kern.completed.cpu())
    assert torch.equal(plain.rings.n_count.cpu(), plain.completed.cpu())
    for f in ("req", "branch", "cls", "nvis"):
        assert torch.equal(getattr(kern.rings, f)[:, :-1].cpu(),
                           getattr(plain.rings, f)[:, :-1].cpu()), f
    err = 0.0
    for f in ("parked_us", "enter_us", "leave_us"):
        a = getattr(kern.rings, f)[:, :-1].cpu()
        b = getattr(plain.rings, f)[:, :-1].cpu()
        if exact:
            assert torch.equal(a, b), f
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                       err_msg=f)
        err = max(err, float((a - b).abs().max()))
    return err


def hold_trace_sketch(both, sketched, traced) -> None:
    """The traced and sketched launch: its every output but the rings
    identical to the sketched launch's (the sketch state included), and
    its rings to the traced launch's."""
    hold_untraced(both, sketched)
    for fa, fb in zip(both.rings, traced.rings):
        assert torch.equal(fa, fb)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRACE_EXT_CASES,
                         ids=[c[0] for c in TRACE_EXT_CASES])
def test_traced_ext_kernel_matches_plain(cuda_device, case):
    fn, counter = TRACE_EXT_COUNTERS[case[1]]
    before = getattr(fn, counter)
    kern, plain, bare = trace_ext_pair(case, cuda_device)
    assert getattr(fn, counter) == before + 1
    hold_trace_ext(kern, plain, bare, exact=case[-1])
    if case[1] == "open":
        hold_open(kern, plain, exact=case[-1])
    elif case[1] == "tiers":
        hold_tiered(kern, plain, exact=case[-1])
    else:
        hold_coalesced(kern, plain, exact=case[-1])
    if case[2].get("flows") and case[2].get("mpl", 2) > 1:
        assert int((kern.rings.cls == 2).sum()) > 0  # delayed records


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRACE_EXT_CASES[::3],
                         ids=[c[0] for c in TRACE_EXT_CASES[::3]])
def test_traced_ext_kernel_with_the_sketch(cuda_device, case):
    kern_fn, _, spec, seeds, kw = trace_ext_lanes(case, cuda_device)
    sk = dict(kw, sketch_cap=8, window_us=20.0)
    before = tes.sim_lanes.sketch_launches
    both = kern_fn(spec, seeds, **sk)
    assert tes.sim_lanes.sketch_launches == before + 1
    hold_trace_sketch(both, kern_fn(spec, seeds, **{
        k: v for k, v in sk.items() if k != "trace_cap"}),
        kern_fn(spec, seeds, **kw))


# (id, stream length, key space, theta, sketch_cap, window_us, hits, form):
# the sketch_trace kernel's lanes; form None is sketch_trace_form's (the
# register ladder, packed), else (S, packed) forced: the unpacked form at
# S 1, 4 and 16, and S = 0 (the table in device memory) at a cap of 96
SKETCH_TRACE_CASES = [
    ("zipf-cap64", 3000, 256, 0.9, 64, 500.0, True, None),
    ("zipf-cap512-nohits", 2000, 512, 0.55, 512, 100.0, False, None),
    ("uniform-cap5", 1500, 64, 0.0, 5, 7.0, True, None),
    ("zipf-cap33", 2000, 256, 0.9, 33, 100.0, True, None),
    ("zipf-cap96", 3000, 512, 0.9, 96, 500.0, True, None),
    ("zipf-cap600-nohits", 2000, 1024, 0.9, 600, 100.0, False, None),
    ("uniform-cap5-unpacked", 1500, 64, 0.0, 5, 7.0, True, (1, False)),
    ("zipf-cap96-unpacked", 3000, 512, 0.9, 96, 500.0, True, (4, False)),
    ("zipf-cap512-unpacked", 2000, 512, 0.55, 512, 100.0, False, (16, False)),
    ("zipf-cap96-device-table", 2000, 512, 0.9, 96, 100.0, True, (0, False)),
]
# a stream too long for the packed form (sketch_trace_form picks three
# reductions by its length alone), at fig_drift A's cap
SKETCH_TRACE_LONG = 4_194_304


def sketch_trace_inputs(case, device, n_lanes=2):
    """(L, n) keys, times and hits of a ``SKETCH_TRACE_CASES`` case: a
    Zipf (or uniform) key stream per lane from numpy seeds, one event per
    µs, random hits."""
    _, n, key_space, theta, _, _, hits, _ = case
    rng = np.random.default_rng(7)
    w = (np.arange(1, key_space + 1, dtype=np.float64) ** -theta)
    keys = rng.choice(key_space, size=(n_lanes, n), p=w / w.sum())
    t = np.tile(np.arange(n, dtype=np.float32), (n_lanes, 1))
    h = (rng.random((n_lanes, n)) < 0.6) if hits else np.zeros((n_lanes, n))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (keys.astype(np.int32), t, h.astype(np.int32)))


def hold_sketch_trace(kern, plain, keys, t, hits, cap, window) -> None:
    """The kernel's state identical to the plain version's in every field,
    and its decode equal to the exact twin's in every windowed counter."""
    for f in tst.SketchState._fields:
        assert torch.equal(getattr(kern, f).cpu(), getattr(plain, f).cpu()), f
    for lane in range(keys.shape[0]):
        est = tst.decode_sketch_grid(kern, keys.shape[0], 1, window)[lane][0]
        py = tst.sketch_trace_py(keys[lane].cpu().numpy(),
                                 t_us=t[lane].cpu().numpy(),
                                 hits=hits[lane].cpu().numpy(),
                                 sketch_cap=cap, window_us=window)
        assert np.array_equal(est.window_id, py.window_id)
        assert np.array_equal(est.win_done_count, py.win_done_count)
        assert np.array_equal(est.win_arrival_rate, py.win_arrival_rate)
        assert np.allclose(est.win_hit_frac, py.win_hit_frac, equal_nan=True)
        assert est.key_count == py.key_count
        probe = np.arange(int(keys.max()) + 1)
        assert np.all(est.cm_estimate(probe) >= py.cm_estimate(probe))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SKETCH_TRACE_CASES,
                         ids=[c[0] for c in SKETCH_TRACE_CASES])
def test_sketch_trace_kernel_matches_plain(cuda_device, case):
    keys, t, hits = sketch_trace_inputs(case, cuda_device)
    cap, window, form = case[4], case[5], case[7]
    before = tsk.sketch_trace_lanes.launches
    kern = tsk.sketch_trace_lanes(keys, t, hits, sketch_cap=cap,
                                  window_us=window, form=form)
    assert tsk.sketch_trace_lanes.launches == before + 1
    plain = tsk.sketch_trace_plain(keys.cpu(), t.cpu(), hits.cpu(),
                                   sketch_cap=cap, window_us=window)
    hold_sketch_trace(kern, plain, keys, t, hits, cap, window)


@pytest.mark.cuda
def test_sketch_trace_unpacked_by_length(cuda_device):
    """A stream of ``SKETCH_TRACE_LONG`` keys takes the unpacked register
    form by its length; its state equals the S = 0 instantiation's (the
    table in device memory, held against the plain version above) in every
    field.  The plain version itself, some 0.5 ms a key, would take over
    half an hour here, so the table is also replayed by an exact
    SpaceSaving (stream_key's rule: the lowest matching slot, else the
    lowest slot of the least count, which passes its count on as err)."""
    n, cap = SKETCH_TRACE_LONG, 96
    assert tsk.sketch_trace_form(cap, n) == (4, False)
    rng = np.random.default_rng(11)
    w = np.arange(1, 513, dtype=np.float64) ** -0.9
    keys = rng.choice(512, size=n, p=w / w.sum()).astype(np.int32)
    ins = (torch.from_numpy(keys)[None].to(cuda_device),
           torch.arange(n, dtype=torch.float32, device=cuda_device)[None],
           torch.from_numpy((keys % 3 == 0).astype(np.int32))[None]
           .to(cuda_device))
    kw = dict(sketch_cap=cap, window_us=500.0)
    kern = tsk.sketch_trace_lanes(*ins, **kw)
    dev_table = tsk.sketch_trace_lanes(*ins, **kw, form=(0, False))
    for f in tst.SketchState._fields:
        assert torch.equal(getattr(kern, f), getattr(dev_table, f)), f
    ss_key, ss_cnt, ss_err = (np.full(cap, -1), np.zeros(cap, np.int64),
                              np.zeros(cap, np.int64))
    where = {}
    for k in keys.tolist():
        j = where.get(k)
        if j is None:
            j = int(np.argmin(ss_cnt))
            where.pop(int(ss_key[j]), None)
            where[k] = j
            ss_key[j], ss_err[j] = k, ss_cnt[j]
        ss_cnt[j] += 1
    for name, want in (("ss_key", ss_key), ("ss_count", ss_cnt),
                       ("ss_err_count", ss_err)):
        assert np.array_equal(getattr(kern, name)[0, :cap].cpu().numpy(),
                              want), name
    assert int(kern.ss_count[0].sum()) == n == int(kern.key_count[0])


# the traced modes through the entry points: simulate_network with
# coalescing, the open loop (coalescing; bursts) and the tiered tables,
# simulate_cluster and simulate_hierarchy with coalescing
TRACED_ENTRY_MODES = ["coalescing", "open", "open-burst", "tiered", "cluster",
                      "hierarchy"]


def traced_entry_run(mode, device, n_requests=400, cap=512):
    """``trace=cap`` through the entry point of ``mode`` on ``device``: two
    p_hits x two seeds on deterministic service, rings no lane fills."""
    from repro_torch.cluster.sim import simulate_cluster
    from repro_torch.core.simulator import simulate_network
    from repro_torch.hierarchy.sim import simulate_hierarchy

    kw = dict(n_requests=n_requests, seeds=(0, 1), trace=cap, device=device)
    ps = [0.3, 0.7]
    if mode == "coalescing":
        return simulate_network(_lru(48, True, 8), ps, coalesce_flows=16, **kw)
    if mode == "open":
        return simulate_network(_lru(1, True, 8), ps, arrival_rate=0.3,
                                coalesce_flows=16, max_in_system=128, **kw)
    if mode == "open-burst":
        return simulate_network(_lru(1, True, 8), ps, arrival_rate=0.3,
                                burst=(0.6, 200.0), max_in_system=128, **kw)
    if mode == "cluster":
        model = cluster_model(4, 48)
        return simulate_cluster(dataclasses.replace(
            model, network=det_network(model.network)), ps, coalesce_flows=8,
            **kw)
    model = hierarchy_model("small")
    model = dataclasses.replace(model, network=det_network(model.network))
    if mode == "tiered":
        return simulate_network(model.network, ps, coalesce_flows=2,
                                tiers=model.mshr, **kw)
    return simulate_hierarchy(model, ps, coalesce_flows=2, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", TRACED_ENTRY_MODES)
def test_traced_entry_points_match_plain(cuda_device, mode):
    """The decoded ``traces`` of a traced entry-point run on the card are
    the same run's on the CPU (the plain version), every field, one record
    per completion, and so is its throughput (deterministic service)."""
    kern = traced_entry_run(mode, "cuda")
    plain = traced_entry_run(mode, "cpu")
    assert np.array_equal(kern.throughput, plain.throughput)
    assert len(kern.traces) == 2 and all(len(row) == 2 for row in kern.traces)
    for a, b in zip(sum(kern.traces, []), sum(plain.traces, [])):
        assert a.n_emitted == b.n_emitted >= 400 and a.n_dropped == 0
        for f in ("req", "branch", "cls", "nvis", "station", "parked_us",
                  "enter_us", "leave_us"):
            assert np.array_equal(getattr(a, f), getattr(b, f),
                                  equal_nan=True), f
