"""The WKV6 kernels against their plain version, on the card.

These tests import neither jax nor the JAX package, so they run where the
card is (``python -m pytest -m cuda tests/test_torch_wkv_cuda.py``);
without a card they skip.  The shapes are the reference's ``WKV_CASES``
(``tests/test_kernels.py``) from a zero state, then the kernels with a
random initial state (y and the final state, updated in place), one
decode step (T = 1) and the model path's types (bf16 r/k/v, float32 w and
y); the tolerances are the reference's: 2e-4 in float32, 2e-2 in bf16.
T >= 64 takes the chunked kernel (split-TF32 products on the tensor
cores), T < 64 the sequential one; the chunked cases cover every type
combination and head width, ragged T, the model's decays exp(-exp(x))
with x in [-8, 4], and decays of exactly 0 and 1, and each asserts the
route it took.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import linear_scan as tscan
from repro_torch.kernels import ops

WKV_CASES = [
    # (B, T, H, dh, chunk, dtype)
    (2, 128, 2, 32, 32, torch.float32),
    (1, 256, 4, 64, 128, torch.float32),
    (1, 100, 2, 32, 32, torch.float32),
    (2, 64, 2, 64, 64, torch.bfloat16),
]
STATE_CASES = [
    # (B, T, H, dh, r/k/v dtype, w dtype)
    (2, 48, 2, 16, torch.float32, torch.float32),
    (1, 100, 4, 32, torch.float32, torch.float32),
    (2, 70, 4, 64, torch.bfloat16, torch.float32),
    (4, 1, 8, 64, torch.bfloat16, torch.float32),
    (3, 1, 2, 32, torch.float32, torch.float32),
]
# the chunked kernel: every (r/k/v, w, y) combination at every head width,
# T = 130 (a ragged third chunk), model decays, a state in and out
CHUNKED_CASES = [(combo, dh) for combo in tscan.TYPE_COMBOS
                 for dh in tscan.HEAD_DIMS]
RAGGED_T = (64, 65, 127, 2047)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(
        rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return "cuda"


def decays(rng, shape, kind):
    """w of ``shape`` (numpy float32): "sigmoid" of a normal (the reference's
    test); "model", exp(-exp(x)) with x uniform in [-8, 4] (the model's
    clip); "exact", sigmoid with a tenth of the entries exactly 0 and a
    tenth exactly 1."""
    if kind == "model":
        return np.exp(-np.exp(rng.uniform(-8.0, 4.0, shape))).astype(np.float32)
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)
    if kind == "exact":
        pick = rng.random(shape)
        w[pick < 0.1] = 0.0
        w[pick > 0.9] = 1.0
    return w


def _inputs(B, T, H, dh, io, wt, device, seed=0, decay="sigmoid"):
    rng = np.random.default_rng(seed)

    def t(a, dtype):
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=dtype)

    r, k, v = (t(rng.standard_normal((B, T, H, dh)), io) for _ in range(3))
    w = t(decays(rng, (B, T, H, dh), decay), wt)
    u = t(rng.standard_normal((H, dh)), torch.float32)
    return r, k, v, w, u


def _launches():
    return tscan.wkv6_scan.launches, tscan.wkv6_scan.chunked_launches


def _hold_with_state(cuda_device, B, T, H, dh, io, wt, yt, decay, seed):
    """The kernel from a random state, updated in place, against the plain
    version: y within 2e-4 (2e-2 where y is bf16), the state within 2e-4.
    Returns the route's launch counts (all, chunked) it added."""
    r, k, v, w, u = _inputs(B, T, H, dh, io, wt, cuda_device, seed=seed,
                            decay=decay)
    g = torch.Generator(device=cuda_device).manual_seed(seed + 1)
    s0 = torch.randn((B, H, dh, dh), generator=g, device=cuda_device)
    state = s0.clone()
    before = _launches()
    got_s, got_y = tscan.wkv6_scan(r, k, v, w, u, state, y_dtype=yt)
    after = _launches()
    assert got_s is state and got_y.dtype == yt
    want_s, want_y = tscan.wkv6_scan_plain(r, k, v, w, u, s0.clone())
    np.testing.assert_allclose(got_y.float().cpu().numpy(),
                               want_y.to(yt).float().cpu().numpy(), **_tol(yt))
    np.testing.assert_allclose(got_s.cpu().numpy(), want_s.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    return after[0] - before[0], after[1] - before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv_kernel_matches_plain_on_card(cuda_device, case):
    B, T, H, dh, chunk, dtype = case
    r, k, v, w, u = _inputs(B, T, H, dh, dtype, dtype, cuda_device)
    before = tscan.wkv6_scan.launches
    got = ops.wkv6_scan(r, k, v, w, u.to(dtype), chunk=chunk)
    assert tscan.wkv6_scan.launches == before + 1
    want = tscan.wkv6_scan_plain(r, k, v, w, u.to(dtype))[1].to(dtype)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("case", STATE_CASES, ids=str)
def test_wkv_kernel_with_state_matches_plain_on_card(cuda_device, case):
    B, T, H, dh, io, wt = case
    r, k, v, w, u = _inputs(B, T, H, dh, io, wt, cuda_device, seed=1)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    s0 = torch.randn((B, H, dh, dh), generator=g, device=cuda_device)
    state = s0.clone()
    got_s, got_y = tscan.wkv6_scan(r, k, v, w, u, state)
    assert got_s is state
    want_s, want_y = tscan.wkv6_scan_plain(r, k, v, w, u, s0.clone())
    for a, b in ((got_y, want_y), (got_s, want_s)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("combo,dh", CHUNKED_CASES, ids=str)
def test_chunked_kernel_matches_plain_on_card(cuda_device, combo, dh):
    io, wt, yt = combo
    assert tscan.route_for(130) == "chunked"
    assert _hold_with_state(cuda_device, 2, 130, 3, dh, io, wt, yt, "model",
                            seed=3) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("T", RAGGED_T)
def test_chunked_kernel_ragged_T_on_card(cuda_device, T):
    assert _hold_with_state(cuda_device, 1, T, 4, 64, torch.bfloat16,
                            torch.float32, torch.float32, "model",
                            seed=T) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("combo", tscan.TYPE_COMBOS, ids=str)
@pytest.mark.parametrize("T", (65, 33))
def test_exact_decays_on_card(cuda_device, combo, T):
    """w of exactly 0 and exactly 1, on both routes."""
    io, wt, yt = combo
    chunked = int(tscan.route_for(T) == "chunked")
    assert _hold_with_state(cuda_device, 2, T, 2, 32, io, wt, yt, "exact",
                            seed=11) == (1, chunked)


@pytest.mark.cuda
def test_route_follows_T_on_card(cuda_device):
    """T < 64 takes the sequential kernel (the decode step among them),
    T >= 64 the chunked one; both count on the wrapper, and so does a
    direct ``launch``."""
    for T, route in ((1, "sequential"), (63, "sequential"), (64, "chunked"),
                     (200, "chunked")):
        assert tscan.route_for(T) == route
        r, k, v, w, u = _inputs(4, T, 2, 64, torch.bfloat16, torch.float32,
                                cuda_device)
        before = _launches()
        tscan.launch(r, k, v, w, u, None, torch.float32)
        after = _launches()
        assert (after[0] - before[0], after[1] - before[1]) == (
            1, int(route == "chunked"))
    with pytest.raises(ValueError, match="route"):
        tscan.launch(r, k, v, w, u, None, torch.float32, route="fast")


@pytest.mark.cuda
def test_both_routes_agree_on_card(cuda_device):
    """The same call through each kernel: within 2e-4 of each other."""
    r, k, v, w, u = _inputs(2, 150, 4, 64, torch.bfloat16, torch.float32,
                            cuda_device, decay="model")
    seq = tscan.launch(r, k, v, w, u, None, torch.float32, route="sequential")
    chk = tscan.launch(r, k, v, w, u, None, torch.float32, route="chunked")
    for a, b in zip(seq, chk):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_chunked_route_takes_unaligned_views_on_card(cuda_device):
    """Contiguous views that start 4 bytes into their storage (the chunked
    kernel copies 16 bytes at a time): the same y and state, the state
    still updated in place."""
    r, k, v, w, u = _inputs(2, 96, 2, 32, torch.float32, torch.float32,
                            cuda_device, decay="model")
    s0 = torch.randn((2, 2, 32, 32), device=cuda_device)

    def offset(a):
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
        view = buf[1:].view(a.shape)
        view.copy_(a)
        return view

    want_s, want_y = tscan.wkv6_scan(r, k, v, w, u, s0.clone())
    state = offset(s0)
    got_s, got_y = tscan.wkv6_scan(*(offset(a) for a in (r, k, v, w)), u, state)
    assert got_s is state and state.data_ptr() % 16
    assert torch.equal(got_y, want_y) and torch.equal(got_s, want_s)
