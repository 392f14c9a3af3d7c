"""The WKV6 kernel against its plain version, on the card.

These tests import neither jax nor the JAX package, so they run where the
card is (``python -m pytest -m cuda tests/test_torch_wkv_cuda.py``);
without a card they skip.  The shapes are the reference's ``WKV_CASES``
(``tests/test_kernels.py``) from a zero state, then the kernel with a
random initial state (y and the final state, updated in place), one
decode step (T = 1) and the model path's types (bf16 r/k/v, float32 w and
y); the tolerances are the reference's: 2e-4 in float32, 2e-2 in bf16.
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


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(
        rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return "cuda"


def _inputs(B, T, H, dh, io, wt, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dtype):
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=dtype)

    r, k, v = (t(rng.standard_normal((B, T, H, dh)), io) for _ in range(3))
    w = t(1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, dh)))), wt)
    u = t(rng.standard_normal((H, dh)), torch.float32)
    return r, k, v, w, u


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
