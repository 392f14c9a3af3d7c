"""WKV6 linear-attention scan: the RWKV6 recurrence with a ``(dh x dh)`` state
per (batch, head).

Port of ``repro.kernels.linear_scan`` (the Pallas ``_wkv_kernel``) and of the
reference model's ``_wkv_scan`` (``repro.models.rwkv``), of which the TPU
kernel is the zero-state case.  Per (b, h), i the key index and j the value
index, in float32::

    y_t[j]  = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
    S[i, j] <- w_t[i] * S[i, j] + k_t[i] * v_t[j]

:func:`wkv6_scan` is the kernel wrapper: on CUDA tensors it launches one of
two hand-written kernels of ``csrc/linear_scan.cu``, picked from T alone
(:func:`route_for`): for T < ``CHUNK`` the sequential kernel (one block per
(b, h), one thread per value column holding ``S[:, j]`` in registers), for
T >= ``CHUNK`` the chunked kernel (the recurrence once per chunk of 64
steps, the work inside a chunk as matrix products on the tensor cores in
split TF32); a failure raises, with no fallback.  On CPU tensors it runs
the plain version, :func:`wkv6_scan_plain`, a loop over T step for step the
reference's ``_wkv_scan``.  :func:`wkv6_scan_chunked_plain` is the chunked
kernel's algorithm in float32, for the tests.

All take an optional initial state and return the final one.  A state
that is given is updated in place (each (b, h) touches only its own
state), which is how the model writes a cache's state; without one the
scan starts from zero and the final state is a new tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)  # the kernels' instantiations
CHUNK = 64  # T from which the chunked kernel runs; its chunk of timesteps
SUB = 16    # the chunked kernel's sub-chunk: its diagonal blocks' size
# (r/k/v, w, y) element types the kernel is built for: one type throughout
# (the ops path), or the model path's bf16 r/k/v with float32 w and y
TYPE_COMBOS = ((torch.float32, torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32, torch.float32))


def wkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor,
                    state: torch.Tensor | None = None):
    """The kernel's plain PyTorch version, step for step the reference's
    ``_wkv_scan``.  r, k, v, w ``(B, T, H, dh)``; u ``(H, dh)``; state
    ``(B, H, dh, dh)`` float32 or None (zero).  Returns ``(state, y)``: the
    final state (``state`` itself, updated in place, when given) and y
    ``(B, T, H, dh)`` in float32."""
    B, T, H, dh = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    S = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    y = torch.empty((B, T, H, dh), dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B, H, dh, dh)
        y[:, t] = torch.einsum("bhi,bhij->bhj", rf[:, t], S + uf * kv)
        S = wf[:, t, :, :, None] * S + kv
    if state is None:
        return S, y
    state.copy_(S)
    return state, y


def _decay_products(w: torch.Tensor):
    """Running products of w over each sub-chunk (axis -2 of
    ``(..., n_sub, sub, dh)``): the exclusive prefix Q[t] = prod_{tau < t}
    w_tau, the exclusive suffix P[s] = prod_{tau > s} w_tau and the total G.
    No division, no logarithm: every factor is at most 1."""
    ones = torch.ones_like(w[..., :1, :])
    pre = torch.cumprod(w, dim=-2)
    suf = torch.cumprod(w.flip(-2), dim=-2).flip(-2)
    return (torch.cat([ones, pre[..., :-1, :]], -2),
            torch.cat([suf[..., 1:, :], ones], -2), pre[..., -1, :])


def wkv6_scan_chunked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            w: torch.Tensor, u: torch.Tensor,
                            state: torch.Tensor | None = None, *,
                            chunk: int = CHUNK):
    """The chunked kernel's algorithm in float32 (float32 products where the
    kernel splits TF32), for the tests; never on a path.  Same arguments and
    result as :func:`wkv6_scan_plain`; ``chunk`` a multiple of ``SUB``.

    T is padded to a multiple of ``chunk`` with w = 1 and r = k = v = 0,
    which leaves the state unchanged.  For a chunk from state S0, t in
    sub-chunk a and s in sub-chunk b, D(x, y) = prod_{x <= tau < y} w_tau:
    b < a: D(s+1, t) = P_s prod_{b < c < a} G_c Q_t (the kernel's
    off-diagonal products); b = a: the block cut at its midpoint m, the
    lower-left quadrant D(s+1, m) D(m, t) (a product in the kernel), the
    two diagonal quadrants running products along t per s (its CUDA-core
    part); D(0, t) = prod_{c < a} G_c Q_t for the inter-chunk term and
    D(s+1, C) = P_s prod_{c > b} G_c for the state."""
    if chunk <= 0 or chunk % SUB:
        raise ValueError(f"chunk must be a positive multiple of {SUB}, got {chunk}")
    B, T, H, dh = r.shape
    ns = chunk // SUB
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T

    def prep(a, fill):  # (B, T, H, dh) -> (n_chunks, B, H, ns, SUB, dh) float32
        a = a.float().permute(0, 2, 1, 3)
        a = torch.cat([a, torch.full((B, H, pad, dh), fill, device=a.device)], 2)
        return a.reshape(B, H, n_chunks, ns, SUB, dh).permute(2, 0, 1, 3, 4, 5)

    rc, kc, vc, wc = prep(r, 0.0), prep(k, 0.0), prep(v, 0.0), prep(w, 1.0)
    uf = u.float()[None, :, None, :]  # (1, H, 1, dh)
    S = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
         if state is None else state.float().clone())
    steps = torch.arange(SUB, device=r.device)
    half = SUB // 2
    # [t, s]: s < t in the same half of the sub-chunk
    near = (steps[:, None] > steps[None, :]) & (steps[:, None] // half
                                                == steps[None, :] // half)
    y = torch.empty((n_chunks, B, H, ns, SUB, dh), dtype=torch.float32,
                    device=r.device)
    for c in range(n_chunks):
        R, K, V, W = rc[c], kc[c], vc[c], wc[c]
        Q, P, G = _decay_products(W)
        Rq, Kp = R * Q, K * P
        # the diagonal quadrants: D(s+1, t) as running products along t per s
        run = torch.ones_like(W)  # (B, H, ns, SUB(s), dh)
        dd = torch.zeros(W.shape[:3] + (SUB, SUB, dh), device=W.device)
        for t in range(SUB):
            dd[:, :, :, t] = torch.where(near[t][:, None], run, 0.0)
            run = torch.where(near[t][:, None], run * W[:, :, :, t, None], run)
        diag = torch.einsum("bhati,bhatsi,bhasi->bhats", R, dd, K)
        bonus = torch.einsum("bhati,bhati->bhat", R * uf[:, :, None], K)
        diag = diag + torch.diag_embed(bonus)
        # the lower-left quadrant: D(s+1, t) = D(s+1, m) D(m, t)
        Qh, Ph, _ = _decay_products(W.reshape(W.shape[:3] + (2, half, dh)))
        R2 = R[:, :, :, half:] * Qh[:, :, :, 1]
        K2 = K[:, :, :, :half] * Ph[:, :, :, 0]
        diag[:, :, :, half:, :half] = R2 @ K2.transpose(-1, -2)
        for a in range(ns):
            h_a = torch.prod(G[:, :, :a], dim=2)
            ya = torch.einsum("bhti,bhij->bhtj", Rq[:, :, a] * h_a[:, :, None], S)
            ya = ya + diag[:, :, a] @ V[:, :, a]
            for b in range(a):
                mid = torch.prod(G[:, :, b + 1:a], dim=2)
                A = (Rq[:, :, a] * mid[:, :, None]) @ Kp[:, :, b].transpose(-1, -2)
                ya = ya + A @ V[:, :, b]
            y[c, :, :, a] = ya
        S = torch.prod(G, dim=2)[..., None] * S
        for b in range(ns):
            tail = torch.prod(G[:, :, b + 1:], dim=2)
            S = S + (Kp[:, :, b] * tail[:, :, None]).transpose(-1, -2) @ V[:, :, b]
    y = y.permute(1, 2, 0, 3, 4, 5).reshape(B, H, n_chunks * chunk, dh)
    y = y[:, :, :T].permute(0, 2, 1, 3).contiguous()
    if state is None:
        return S, y
    state.copy_(S)
    return state, y


def _check(r, k, v, w, u, state, y_dtype):
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"want r, k, v, w of one shape (B, T, H, dh); got "
                         f"{[tuple(a.shape) for a in (r, k, v, w)]}")
    B, T, H, dh = r.shape
    if tuple(u.shape) != (H, dh):
        raise ValueError(f"want u of shape {(H, dh)}, got {tuple(u.shape)}")
    if state is not None and (tuple(state.shape) != (B, H, dh, dh)
                              or state.dtype != torch.float32):
        raise ValueError(f"want a float32 state of shape {(B, H, dh, dh)}, "
                         f"got {state.dtype} {tuple(state.shape)}")
    if not (r.dtype == k.dtype == v.dtype):
        raise ValueError("r, k and v must share one dtype")
    if (r.dtype, w.dtype, y_dtype) not in TYPE_COMBOS:
        raise ValueError(f"no WKV kernel for (r/k/v, w, y) = {(r.dtype, w.dtype, y_dtype)}; "
                         f"built for {TYPE_COMBOS}")
    devices = {a.device for a in (r, k, v, w, u)}
    if state is not None:
        devices.add(state.device)
    if len(devices) != 1:
        raise ValueError("all inputs must be on one device")


def route_for(T: int) -> str:
    """The kernel a CUDA call over T timesteps runs: "chunked" for T >=
    ``CHUNK``, else "sequential" (the decode step, short admissions)."""
    return "chunked" if T >= CHUNK else "sequential"


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state: torch.Tensor | None = None, *,
              y_dtype: torch.dtype = torch.float32):
    """The WKV6 scan: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.

    r, k, v ``(B, T, H, dh)`` in one dtype; w ``(B, T, H, dh)``; u
    ``(H, dh)``; state ``(B, H, dh, dh)`` float32, updated in place, or None
    (start from zero).  ``(r/k/v, w, y_dtype)`` is one of ``TYPE_COMBOS``.
    Returns ``(state, y)``, y ``(B, T, H, dh)`` in ``y_dtype``.
    """
    _check(r, k, v, w, u, state, y_dtype)
    dev = r.device
    if dev.type == "cpu":
        S, y = wkv6_scan_plain(r, k, v, w, u, state)
        return S, y.to(y_dtype)
    if dev.type != "cuda":
        raise ValueError(f"no WKV kernel for device {dev}")
    return launch(r.contiguous(), k.contiguous(), v.contiguous(), w.contiguous(),
                  u.float().contiguous(), state, y_dtype)


wkv6_scan.launches = 0          # kernel launches, both routes (CUDA path only)
wkv6_scan.chunked_launches = 0  # of which the chunked kernel's


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it in new (aligned) storage where its data does
    not start on 16 bytes (a view into a larger tensor)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
           u: torch.Tensor, state: torch.Tensor | None, y_dtype: torch.dtype,
           route: str | None = None):
    """Launch a kernel on inputs :func:`wkv6_scan` has validated
    (contiguous CUDA tensors, u float32); no host synchronisation.  The
    route is :func:`route_for` T unless given ("sequential" or "chunked").
    Counts the launch on :func:`wkv6_scan` once the kernel is queued.
    Returns ``(state, y)``."""
    B, T, H, dh = r.shape
    if dh not in HEAD_DIMS or T < 1:
        raise ValueError(f"the WKV kernel is built for head widths {HEAD_DIMS} "
                         f"and T >= 1; got dh {dh}, T {T}")
    if state is not None and not state.is_contiguous():
        raise ValueError("the state is updated in place and must be contiguous")
    route = route_for(T) if route is None else route
    if route not in ("sequential", "chunked"):
        raise ValueError(f"no WKV kernel route {route!r}")
    lib = _build.load_library()
    fn = lib.wkv6_chunked_launch if route == "chunked" else lib.wkv6_launch
    if route == "chunked":  # its copies move 16 bytes at a time
        r, k, v, w = (_aligned(a) for a in (r, k, v, w))
    y = torch.empty((B, T, H, dh), dtype=y_dtype, device=r.device)
    out = state if state is not None else torch.empty(
        (B, H, dh, dh), dtype=torch.float32, device=r.device)
    work = _aligned(out) if route == "chunked" else out
    with torch.cuda.device(r.device):
        err = fn(
            DTYPE_CODES[r.dtype], DTYPE_CODES[w.dtype], DTYPE_CODES[y_dtype],
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if state is None else work.data_ptr(), work.data_ptr(),
            y.data_ptr(), B, T, H, dh, torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"WKV6 {route} kernel launch")
    wkv6_scan.launches += 1
    wkv6_scan.chunked_launches += route == "chunked"
    if work is not out:
        out.copy_(work)
    return out, y
