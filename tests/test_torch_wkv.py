"""The port's WKV6 scan against ``repro.kernels.ops.wkv6_scan`` and the
reference model's ``_wkv_scan``, on the same inputs.

On the CPU the wrapper runs the kernel's plain version
(``linear_scan.wkv6_scan_plain``), a loop over T step for step the
reference's ``_wkv_scan``.  The shapes are the reference's ``WKV_CASES``
(``tests/test_kernels.py``, T = 100 its padding path), the JAX side runs
its Pallas kernel in interpret mode, and the tolerances are the
reference's: 2e-4 in float32, 2e-2 in bfloat16.  With a nonzero initial
state the plain scan returns y and the final state of ``_wkv_scan``
within 2e-4.

The chunked kernel's algorithm in float32
(``linear_scan.wkv6_scan_chunked_plain``) is held to the same 2e-4: against
``_wkv_scan`` and the step-by-step plain version with a random state in
and out, over T across the chunk and sub-chunk edges, every head width,
the model's decays exp(-exp(x)) (x uniform in [-8, 4]) and sigmoid decays
with entries of exactly 0 and 1; against ``ops.wkv6_scan`` (interpret
mode) on ``WKV_CASES``; and against itself at chunks of 32 and 64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import rwkv as jrwkv
from repro_torch.kernels import linear_scan as tscan
from repro_torch.kernels import ops

WKV_CASES = [
    # (B, T, H, dh, chunk, dtype)
    (2, 128, 2, 32, 32, "float32"),
    (1, 256, 4, 64, 128, "float32"),
    (1, 100, 2, 32, 32, "float32"),  # the reference's padding path
    (2, 64, 2, 64, 64, "bfloat16"),
]
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-4, atol=2e-4))


def _inputs(B, T, H, dh, seed=4):
    """float32 numpy r, k, v, w (sigmoid of a normal, as the reference's
    test) and u."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, dh), dtype=np.float32)
               for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, dh),
                                                  dtype=np.float32)))
    u = rng.standard_normal((H, dh), dtype=np.float32)
    return r, k, v, w.astype(np.float32), u


def _decays(rng, shape, kind):
    """"model": exp(-exp(x)), x uniform in [-8, 4] (the model's clip);
    "exact": sigmoid of a normal with a tenth of the entries exactly 0 and
    a tenth exactly 1."""
    if kind == "model":
        return np.exp(-np.exp(rng.uniform(-8.0, 4.0, shape))).astype(np.float32)
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)
    pick = rng.random(shape)
    w[pick < 0.1] = 0.0
    w[pick > 0.9] = 1.0
    return w


def _chunked_inputs(B, T, H, dh, decay, seed):
    """float32 numpy r, k, v, w (``decay``), u and a random state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, dh), dtype=np.float32)
               for _ in range(3))
    w = _decays(rng, (B, T, H, dh), decay)
    u = rng.standard_normal((H, dh), dtype=np.float32)
    s0 = rng.standard_normal((B, H, dh, dh), dtype=np.float32)
    return r, k, v, w, u, s0


def _both(arrays, dtype):
    """The same values as torch and as jax arrays of ``dtype`` (bf16 rounded
    once, by torch, and handed to jax bit for bit)."""
    ts = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays]
    js = [jnp.asarray(t.float().numpy()).astype(JAX[dtype]) for t in ts]
    return ts, js


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_ops_wkv6_scan_matches_reference(case):
    B, T, H, dh, chunk, dtype = case
    ts, js = _both(_inputs(B, T, H, dh), dtype)
    want = jops.wkv6_scan(*js, chunk=chunk, interpret=True)
    got = ops.wkv6_scan(*ts, chunk=chunk)
    assert got.dtype == TORCH[dtype] and got.shape == (B, T, H, dh)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_plain_scan_matches_reference(case):
    B, T, H, dh, chunk, dtype = case
    ts, js = _both(_inputs(B, T, H, dh, seed=5), dtype)
    want = jops.wkv6_scan(*js, chunk=chunk, interpret=True)
    state, y = tscan.wkv6_scan_plain(*ts)
    assert y.dtype == torch.float32 and state.shape == (B, H, dh, dh)
    np.testing.assert_allclose(y.to(TORCH[dtype]).float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("B,T,H,dh,io", [
    (2, 48, 2, 16, "float32"),
    (1, 100, 4, 32, "float32"),
    (2, 33, 2, 64, "bfloat16"),  # the model path: bf16 r/k/v, float32 w
    (3, 1, 2, 64, "float32"),    # one decode step
])
def test_plain_scan_with_state_matches_model_scan(B, T, H, dh, io):
    r, k, v, w, u = _inputs(B, T, H, dh, seed=6)
    s0 = np.random.default_rng(7).standard_normal((B, H, dh, dh),
                                                  dtype=np.float32)
    (tr, tk, tv), (jr, jk, jv) = _both((r, k, v), io)
    want_s, want_y = jrwkv._wkv_scan(jr, jk, jv, jnp.asarray(w), jnp.asarray(u),
                                     jnp.asarray(s0))
    state = torch.from_numpy(s0.copy())
    got_s, got_y = tscan.wkv6_scan(tr, tk, tv, torch.from_numpy(w),
                                   torch.from_numpy(u), state)
    assert got_s is state  # updated in place
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=2e-4, atol=2e-4)


def test_scan_in_pieces_equals_one_scan():
    """Prefill then steps, carrying the state: the same y and final state
    as one scan over the whole sequence (the recurrence is sequential, so
    the plain version gives them bit for bit)."""
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(2, 40, 2, 16))
    s_all, y_all = tscan.wkv6_scan(r, k, v, w, u)
    state = torch.zeros_like(s_all)
    ys = []
    for a, b in ((0, 30), (30, 31), (31, 40)):
        ys.append(tscan.wkv6_scan(r[:, a:b], k[:, a:b], v[:, a:b], w[:, a:b],
                                  u, state)[1])
    assert torch.equal(torch.cat(ys, 1), y_all)
    assert torch.equal(state, s_all)


def test_chunk_changes_no_result():
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(1, 100, 2, 32))
    want = ops.wkv6_scan(r, k, v, w, u)
    for chunk in (1, 32, 100, 4096):
        assert torch.equal(ops.wkv6_scan(r, k, v, w, u, chunk=chunk), want)
    with pytest.raises(ValueError, match="chunk"):
        ops.wkv6_scan(r, k, v, w, u, chunk=0)


def test_cpu_wrapper_launches_nothing_and_checks_inputs():
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 16))
    before = tscan.wkv6_scan.launches
    state, y = tscan.wkv6_scan(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u)
    assert tscan.wkv6_scan.launches == before
    assert y.dtype == torch.float32 and state.dtype == torch.float32
    with pytest.raises(ValueError, match="no WKV kernel"):
        tscan.wkv6_scan(r, k, v, w.bfloat16(), u)  # f32 r/k/v with bf16 w
    with pytest.raises(ValueError, match="no WKV kernel"):
        tscan.wkv6_scan(r, k, v, w, u, y_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one dtype"):
        tscan.wkv6_scan(r, k.bfloat16(), v, w, u)
    with pytest.raises(ValueError, match="one shape"):
        tscan.wkv6_scan(r, k[:, :4], v, w, u)
    with pytest.raises(ValueError, match="u of shape"):
        tscan.wkv6_scan(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="state"):
        tscan.wkv6_scan(r, k, v, w, u, torch.zeros(1, 2, 16, 16,
                                                   dtype=torch.float64))
    with pytest.raises(ValueError, match="no WKV kernel"):  # w not bf16
        ops.wkv6_scan(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u)


CHUNK_T = (1, 15, 16, 17, 63, 64, 65, 130, 200)
CHUNK_CASES = [(T, dh, decay) for T in CHUNK_T for dh in tscan.HEAD_DIMS
               for decay in ("model", "exact")]


@pytest.mark.parametrize("T,dh,decay", CHUNK_CASES, ids=str)
def test_chunked_plain_matches_model_scan(T, dh, decay):
    r, k, v, w, u, s0 = _chunked_inputs(1, T, 2, dh, decay, seed=T + dh)
    want_s, want_y = jrwkv._wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    state = torch.from_numpy(s0.copy())
    got_s, got_y = tscan.wkv6_scan_chunked_plain(
        *(torch.from_numpy(a) for a in (r, k, v, w, u)), state)
    assert got_s is state and got_y.shape == (1, T, 2, dh)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("T,dh,decay", CHUNK_CASES, ids=str)
def test_chunked_plain_matches_plain_scan(T, dh, decay):
    arrays = [torch.from_numpy(a) for a in
              _chunked_inputs(2, T, 2, dh, decay, seed=100 + T + dh)]
    *inputs, s0 = arrays
    want_s, want_y = tscan.wkv6_scan_plain(*inputs, s0.clone())
    got_s, got_y = tscan.wkv6_scan_chunked_plain(*inputs, s0.clone())
    np.testing.assert_allclose(got_y.numpy(), want_y.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_chunked_plain_matches_ops_reference(case):
    """From a zero state against the Pallas kernel in interpret mode, in
    float32 (the bf16 case's inputs rounded to bf16 first)."""
    B, T, H, dh, chunk, dtype = case
    ts, js = _both(_inputs(B, T, H, dh, seed=8), dtype)
    want = jops.wkv6_scan(*js, chunk=chunk, interpret=True)
    state, y = tscan.wkv6_scan_chunked_plain(*ts)
    assert y.dtype == torch.float32 and state.shape == (B, H, dh, dh)
    np.testing.assert_allclose(y.to(TORCH[dtype]).float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("T", (33, 64, 100, 200))
@pytest.mark.parametrize("decay", ("model", "exact"))
def test_chunked_plain_chunk_sizes_agree(T, decay):
    *inputs, s0 = (torch.from_numpy(a) for a in
                   _chunked_inputs(2, T, 2, 32, decay, seed=T))
    s32, y32 = tscan.wkv6_scan_chunked_plain(*inputs, s0.clone(), chunk=32)
    s64, y64 = tscan.wkv6_scan_chunked_plain(*inputs, s0.clone(), chunk=64)
    np.testing.assert_allclose(y32.numpy(), y64.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s32.numpy(), s64.numpy(), rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="chunk"):
        tscan.wkv6_scan_chunked_plain(*inputs, chunk=24)


def test_route_follows_T_alone():
    assert [tscan.route_for(T) for T in (1, 63, 64, 2048)] == [
        "sequential", "sequential", "chunked", "chunked"]
