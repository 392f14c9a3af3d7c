"""The port's event-sim engine against ``repro.kernels.event_sim``.

The counter RNG is bit-identical; a network with deterministic service
replays the same event sequence (identical ``completed`` and ``events``,
throughput equal up to float32 summation order); networks with
exponential / Pareto service agree within the bound the reference uses
for its own engines (rtol 0.06) and, on the same uniforms and float32
formulas, within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lru_network as jlru_network
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


def test_options_outside_the_slice_raise():
    net = tpm.lru_network()
    for kw in ({"coalesce_flows": 4}, {"arrival_rate": 0.1},
               {"burst": (0.5, 10.0)}, {"tiers": object()},
               {"sketch_cap": 16}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            simulate_network(net, [0.5], device="cpu", **kw)
    # tracing is ported; the sketches that may ride along are not
    with pytest.raises(NotImplementedError, match="sketch_cap.*ROADMAP"):
        simulate_network(net, [0.5], device="cpu", sketch_cap=16, trace=8)


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
