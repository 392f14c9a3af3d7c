"""The port's event-sim engine against ``repro.kernels.event_sim``.

The counter RNG is bit-identical; a network with deterministic service
replays the same event sequence (identical ``completed`` and ``events``,
throughput equal up to float32 summation order); networks with
exponential / Pareto service agree within the bound the reference uses
for its own engines (rtol 0.06) and, on the same uniforms and float32
formulas, within 1e-5.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lru_network as jlru_network
from repro.core import s3fifo_network as js3fifo_network
from repro.core import slru_network as jslru_network
from repro.core.simulator import simulate_network as jsimulate_network
from repro.core.simspec import compile_network as jcompile
from repro.kernels import event_sim as jes
from repro_torch.convert import spec_from_numpy
from repro_torch.core import policy_models as tpm
from repro_torch.core.simspec import compile_network as tcompile
from repro_torch.core.simulator import simulate_network
from repro_torch.kernels import event_sim as tes


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


def _jax_u01(seed, ctr):
    # the three lines of the reference's u01 closure in _sim_lane
    base = jes._mix(jnp.uint32(seed) + jes._GOLDEN)
    z = jes._mix(base + jnp.asarray(ctr).astype(jnp.uint32) * jes._GOLDEN)
    u = (z >> np.uint32(8)).astype(jnp.float32) * jes._INV24
    return jnp.clip(u, 1e-7, 1.0 - 1e-7)


@pytest.mark.parametrize("seed", [0, 2001, -7])
def test_u01_stream_bit_identical(seed):
    ctr = np.arange(100_000, dtype=np.int32)
    j = np.asarray(jax.jit(_jax_u01)(np.int32(seed), ctr))
    base = tes.lane_base(torch.tensor([seed], dtype=torch.int32))
    t = tes.u01(base, torch.from_numpy(ctr)).numpy()
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))


def test_compiled_specs_identical():
    net = jlru_network(disk_us=100.0)
    for p in (0.3, 0.9):
        j = jax.tree.map(np.asarray, jcompile(net, p))
        t = tcompile(tpm.lru_network(disk_us=100.0), p, device="cpu")
        c = spec_from_numpy(j, device="cpu")
        for f in t._fields[:-1]:
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)), err_msg=f)
            assert torch.equal(getattr(t, f), getattr(c, f)), f
        assert t.mpl == c.mpl == net.mpl


def _lane_outputs(net, p, n_requests, seeds):
    spec, seed_v, kw = tes.grid_lanes(net, np.asarray(p), n_requests, seeds,
                                      0.25, torch.device("cpu"))
    return tes.sim_lanes(spec, seed_v, **kw)


def test_det_network_exact():
    p = np.array([0.5, 0.9])
    jnet = _det(jlru_network(disk_us=20.0, mpl=24))
    tnet = _det(tpm.lru_network(disk_us=20.0, mpl=24))
    n_req, seeds = 600, (0, 1)
    jspec = jax.tree.map(np.asarray, jcompile(jnet, 0.5))
    n_l = len(p) * len(seeds)
    warmup, max_events = int(n_req * 0.25), n_req * (jspec.visits.shape[-1] + 2) * 3
    specs = [jcompile(jnet, float(q)) for q in p]
    arrays = tuple(jnp.concatenate([jnp.stack([getattr(s, f) for s in specs])] * 2)
                   for f in jspec._fields[:7])
    seed_v = jnp.asarray([s * 1000 + i for s in seeds for i in range(len(p))],
                         jnp.int32)
    jx, jc, je, jt = jes._twin_grid(arrays, seed_v, n_requests=n_req,
                                    warmup=warmup, mpl=24,
                                    max_events=max_events)
    out = _lane_outputs(tnet, p, n_req, seeds)
    assert out.x.shape == (n_l,)
    np.testing.assert_array_equal(out.completed.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(out.events.numpy(), np.asarray(je))
    np.testing.assert_allclose(out.t_measured.numpy(), np.asarray(jt),
                               rtol=1e-6)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(jx), rtol=1e-6)

    res_t = simulate_network(tnet, p, n_requests=n_req, seeds=seeds,
                             device="cpu")
    res_j = jes.simulate_grid_pallas(jnet, p, n_requests=n_req, seeds=seeds)
    np.testing.assert_allclose(res_t.throughput, res_j.throughput, rtol=1e-6)
    np.testing.assert_allclose(res_t.ci95, res_j.ci95, rtol=1e-4, atol=1e-9)


def test_lru_network_statistics_match():
    """Pareto head + exponential disk: within the reference's 6% bound
    and, drawing the same uniforms, within 1e-5; the hit-ratio inversion
    survives."""
    p = np.array([0.7, 0.9, 0.99])
    t = simulate_network(tpm.lru_network(disk_us=100.0), p, n_requests=1500,
                         seeds=(0, 1), device="cpu")
    j = jes.simulate_grid_pallas(jlru_network(disk_us=100.0), p,
                                 n_requests=1500, seeds=(0, 1))
    np.testing.assert_allclose(t.throughput, j.throughput, rtol=0.06)
    # same uniforms, same float32 formulas: the same trajectory
    np.testing.assert_allclose(t.throughput, j.throughput, rtol=1e-5)
    assert t.throughput[2] < t.throughput[1]


def _no_marks(net):
    """An MshrSpec of ``net`` that acquires and releases nothing."""
    from repro_torch.core.simspec import MshrSpec

    shape = tuple(tcompile(net, 0.5, device="cpu").visits.shape)
    none = np.full(shape, -1, np.int32)
    return MshrSpec(none, none, none, n_groups=1, max_held=1)


def test_options_outside_the_slice_raise():
    net = tpm.lru_network()
    # tracing runs in every mode: tiered, coalescing, the open loop
    for kw in ({"tiers": _no_marks(net), "coalesce_flows": 4, "trace": 8},
               {"coalesce_flows": 4, "trace": 8},
               {"arrival_rate": 0.1, "trace": 8}):
        res = simulate_network(net, [0.5], n_requests=100, seeds=(0,),
                               device="cpu", **kw)
        assert len(res.traces) == 1 and len(res.traces[0]) == 1
        assert len(res.traces[0][0]) == 8
    # the tiered tables run the closed loop only, as in the reference
    with pytest.raises(ValueError, match="closed loop"):
        simulate_network(net, [0.5], device="cpu", tiers=_no_marks(net),
                         coalesce_flows=4, arrival_rate=0.1)
    # a sketch needs its window, as in the reference
    with pytest.raises(ValueError, match="window_us"):
        simulate_network(net, [0.5], device="cpu", sketch_cap=16)
    # tracing and the sketch ride along together in the closed loop, and
    # neither changes the simulated system
    kw = dict(n_requests=200, seeds=(0,), device="cpu")
    both = simulate_network(net, [0.5], sketch_cap=16, window_us=20.0,
                            trace=8, **kw)
    traced = simulate_network(net, [0.5], trace=8, **kw)
    bare = simulate_network(net, [0.5], **kw)
    np.testing.assert_array_equal(both.throughput, bare.throughput)
    assert both.sketches[0][0].win_done_count.sum() == 200
    assert np.array_equal(both.traces[0][0].req, traced.traces[0][0].req)
    # bursts belong to the open loop, as in the reference
    with pytest.raises(ValueError, match="arrival_rate"):
        simulate_network(net, [0.5], device="cpu", burst=(0.5, 10.0))


def test_reference_keywords_accepted():
    """simulate_network takes every keyword of the reference's signature,
    with the reference's defaults, backend apart (the port's one engine
    is the reference's "pallas" engine)."""
    ref = inspect.signature(jsimulate_network).parameters
    port = inspect.signature(simulate_network).parameters
    assert set(ref) <= set(port)
    for name, par in ref.items():
        if name != "backend":
            assert port[name].default == par.default, name
    assert port["backend"].default == "pallas"


@pytest.mark.parametrize("kw,item", [
    ({"tiers": _no_marks(tpm.lru_network()), "coalesce_flows": 4,
      "trace": 8}, "item 8"),
    ({"coalesce_flows": 4, "trace": 8}, "item 8"),
    ({"window_us": 5.0}, None),
])
def test_unported_reference_keywords_raise(kw, item):
    """Every keyword of the reference runs (``item`` names the ROADMAP
    item that brought it): tracing with coalescing, tiered or not,
    returns ``[seed][p]`` records; ``window_us`` without a sketch runs,
    as in the reference, and changes nothing."""
    run = dict(n_requests=200, seeds=(0,), device="cpu")
    res = simulate_network(tpm.lru_network(), [0.5], **kw, **run)
    np.testing.assert_array_equal(
        res.throughput,
        simulate_network(tpm.lru_network(), [0.5], **{
            k: v for k, v in kw.items() if k not in ("trace", "window_us")},
            **run).throughput)
    if item is None:
        assert res.sketches is None and res.traces is None
        return
    assert len(res.traces) == 1 and len(res.traces[0]) == 1
    assert res.traces[0][0].n_emitted >= 200 and len(res.traces[0][0]) == 8


def test_backend_keyword():
    net = tpm.lru_network(disk_us=100.0, mpl=24)
    with pytest.raises(ValueError, match="threefry.*backend='pallas'"):
        simulate_network(net, [0.5], backend="jax", device="cpu")
    with pytest.raises(ValueError, match="unknown backend 'cuda'"):
        simulate_network(net, [0.5], backend="cuda", device="cpu")
    kw = dict(n_requests=200, seeds=(0,), device="cpu")
    base = simulate_network(net, [0.5, 0.9], **kw)
    given = simulate_network(net, [0.5, 0.9], backend="pallas",
                             coalesce_theta=0.0, max_in_system=128,
                             window_us=0.0, **kw)
    np.testing.assert_array_equal(given.throughput, base.throughput)


def _alone(spec, seed, n_req, **over):
    """One compiled spec simulated alone, in its own unpadded lane."""
    lane, seeds, kw = tes.pad_lanes([spec], [seed], n_req, 0.25)
    kw.update(over)
    return tes.sim_lanes(lane, seeds, **kw)


def _assert_lane_equal(grid, i, alone):
    for f in ("x", "completed", "events", "t_measured"):
        assert torch.equal(getattr(grid, f)[i:i + 1], getattr(alone, f)), f


def _three_networks(det=False):
    nets = [tpm.lru_network(disk_us=100.0, mpl=24),
            tpm.s3fifo_network(disk_us=100.0, mpl=24),
            tpm.slru_network(disk_us=100.0, mpl=24, disk_servers=2)]
    return [_det(n) for n in nets] if det else nets


def test_padded_grid_matches_each_network_alone():
    """Three networks of unequal K, B and Lr padded into one grid: lane
    for lane, the outputs of each network simulated alone, bit for bit."""
    specs = [tcompile(n, p, device="cpu")
             for n, p in zip(_three_networks(), (0.6, 0.8, 0.9))]
    shapes = [(s.svc_ns.shape[0], *s.visits.shape) for s in specs]
    assert all(len(set(dim)) == 3 for dim in zip(*shapes)), shapes
    seeds = [0, 7, 2001]
    lane, seed_v, kw = tes.pad_lanes(specs, seeds, 400, 0.25)
    assert tuple(lane.visits.shape) == (3, *map(max, list(zip(*shapes))[1:]))
    grid = tes.sim_lanes(lane, seed_v, **kw)
    assert grid.completed.tolist() == [400] * 3
    for i, (spec, seed) in enumerate(zip(specs, seeds)):
        _assert_lane_equal(grid, i, _alone(spec, seed, 400))


def test_padded_grid_matches_reference_lanes():
    """The same padded grid with deterministic service against the
    reference's twin engine running each network alone: the same events."""
    p, n_req, seeds = (0.6, 0.8, 0.9), 300, [0, 7, 2001]
    nets_t = _three_networks(det=True)
    nets_j = [_det(jlru_network(disk_us=100.0, mpl=24)),
              _det(js3fifo_network(disk_us=100.0, mpl=24)),
              _det(jslru_network(disk_us=100.0, mpl=24, disk_servers=2))]
    specs = [tcompile(n, q, device="cpu") for n, q in zip(nets_t, p)]
    lane, seed_v, kw = tes.pad_lanes(specs, seeds, n_req, 0.25)
    grid = tes.sim_lanes(lane, seed_v, **kw)
    for i, (net, q) in enumerate(zip(nets_j, p)):
        js = jcompile(net, q)
        arrays = tuple(jnp.asarray(getattr(js, f))[None]
                       for f in js._fields[:7])
        jx, jc, je, jt = jes._twin_grid(
            arrays, jnp.asarray([seeds[i]], jnp.int32), n_requests=n_req,
            warmup=int(n_req * 0.25), mpl=24,
            max_events=n_req * (js.visits.shape[-1] + 2) * 3)
        assert int(grid.completed[i]) == int(jc[0])
        assert int(grid.events[i]) == int(je[0])
        np.testing.assert_allclose(float(grid.x[i]), float(jx[0]), rtol=1e-6)


def test_branch_clamp_survives_padding():
    """A hand-made lane whose cumulative branch law ends at 0.5: a draw
    above it picks branch B = 2, which reads the last real route (JAX's
    clamped gather).  Padded beside a wider network, whose padding puts
    a copy of that route at row 2, the lane is bit for bit the lane alone,
    its trace records included; about half its requests take the clamp."""
    lru = tcompile(tpm.lru_network(disk_us=100.0, mpl=24), 0.7, device="cpu")
    hand = lru._replace(branch_cum=torch.tensor([0.3, 0.5]))
    wide = tcompile(tpm.s3fifo_network(disk_us=100.0, mpl=24), 0.8,
                    device="cpu")
    lane, seed_v, kw = tes.pad_lanes([hand, wide], [3, 4], 400, 0.25)
    assert lane.visits.shape[1] == 4
    assert torch.equal(lane.visits[0, 2:], lane.visits[0, 1:2].expand(2, 7))
    miss = tes.branch_miss(hand)  # the padded rows copy the last one
    bmiss = torch.from_numpy(np.stack(
        [np.r_[miss, miss[-1:], miss[-1:]], tes.branch_miss(wide)]
    ).astype(np.int32))
    grid = tes.sim_lanes(lane, seed_v, trace_cap=512, bmiss=bmiss, **kw)
    alone = _alone(hand, 3, 400, trace_cap=512, bmiss=bmiss[:1, :2])
    _assert_lane_equal(grid, 0, alone)
    _assert_lane_equal(grid, 1, _alone(wide, 4, 400))
    for f in ("req", "branch", "cls", "nvis"):
        assert torch.equal(getattr(grid.rings, f)[0],
                           getattr(alone.rings, f)[0]), f
    for f in ("enter_us", "leave_us"):
        assert torch.equal(getattr(grid.rings, f)[0, :, :4],
                           getattr(alone.rings, f)[0]), f
    clamped = float((alone.rings.branch[0, :400] == 2).float().mean())
    assert 0.4 < clamped < 0.6, clamped


def test_per_lane_event_budget():
    """Each lane keeps its own network's budget; a lane whose budget runs
    out before n_requests stops there, and its neighbour does not."""
    specs = [tcompile(tpm.lru_network(disk_us=100.0, mpl=24), 0.7,
                      device="cpu"),
             tcompile(tpm.slru_network(disk_us=100.0, mpl=24), 0.9,
                      device="cpu")]
    lane, seed_v, kw = tes.pad_lanes(specs, [0, 1], 400, 0.25)
    assert kw["max_events"].tolist() == [400 * (4 + 2) * 3, 400 * (5 + 2) * 3]
    kw["max_events"] = torch.tensor([300, kw["max_events"][1]],
                                    dtype=torch.int32)
    grid = tes.sim_lanes(lane, seed_v, **kw)
    assert int(grid.events[0]) == 300 and int(grid.completed[0]) < 400
    assert int(grid.completed[1]) == 400
    assert int(grid.events[1]) < int(kw["max_events"][1])
    _assert_lane_equal(grid, 0, _alone(
        specs[0], 0, 400, max_events=torch.tensor([300], dtype=torch.int32)))
    _assert_lane_equal(grid, 1, _alone(specs[1], 1, 400))


def test_padded_grid_needs_one_mpl():
    specs = [tcompile(tpm.lru_network(mpl=24), 0.7, device="cpu"),
             tcompile(tpm.lru_network(mpl=48), 0.7, device="cpu")]
    with pytest.raises(ValueError, match="one mpl"):
        tes.pad_lanes(specs, [0, 1], 100, 0.25)
    with pytest.raises(ValueError, match="2 specs but 1 seeds"):
        tes.pad_lanes(specs[:1] * 2, [0], 100, 0.25)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    p = np.array([0.5, 0.9])
    net = _det(tpm.lru_network(disk_us=20.0, mpl=24))
    spec, seed_v, kw = tes.grid_lanes(net, p, 1200, (0, 1), 0.25,
                                      torch.device(cuda_device))
    before = tes.sim_lanes.launches
    k = tes.sim_lanes(spec, seed_v, **kw)
    assert tes.sim_lanes.launches == before + 1
    c = _lane_outputs(net, p, 1200, (0, 1))
    np.testing.assert_array_equal(k.completed.cpu().numpy(), c.completed.numpy())
    np.testing.assert_array_equal(k.events.cpu().numpy(), c.events.numpy())
    np.testing.assert_allclose(k.x.cpu().numpy(), c.x.numpy(), rtol=1e-6)
