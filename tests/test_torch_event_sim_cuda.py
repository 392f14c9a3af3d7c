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
"""

import numpy as np
import pytest
import torch

from repro_torch.core import policy_models as tpm
from repro_torch.core.queueing import QUEUE, THINK, Branch, ClosedNetwork, Station
from repro_torch.core.simspec import compile_network
from repro_torch.kernels import event_sim as tes

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
