"""WKV6 linear-attention scan: the RWKV6 recurrence with a ``(dh x dh)``
state per (batch, head).

Port of ``repro.kernels.linear_scan`` (the Pallas ``_wkv_kernel``) and of the
reference model's ``_wkv_scan`` (``repro.models.rwkv``), of which the TPU
kernel is the zero-state case.  Per (b, h), i the key index and j the value
index, in float32::

    y_t[j]  = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
    S[i, j] <- w_t[i] * S[i, j] + k_t[i] * v_t[j]

:func:`wkv6_scan` is the kernel wrapper: on CUDA tensors it launches the
hand-written kernel (``csrc/linear_scan.cu``: one block per (b, h), one
thread per value column holding ``S[:, j]`` in registers, r/k/v/w staged in
shared memory a tile of timesteps at a time) or raises; on CPU tensors it
runs the plain version, :func:`wkv6_scan_plain`, a loop over T step for
step the reference's ``_wkv_scan``.

Both take an optional initial state and return the final one.  A state
that is given is updated in place (each (b, h) touches only its own
state), which is how the model writes a cache's state; without one the
scan starts from zero and the final state is a new tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)  # the kernel's instantiations: S[:, j] in registers
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
    out = launch(r.contiguous(), k.contiguous(), v.contiguous(), w.contiguous(),
                 u.float().contiguous(), state, y_dtype)
    wkv6_scan.launches += 1
    return out


wkv6_scan.launches = 0  # kernel launches (CUDA path only)


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
           u: torch.Tensor, state: torch.Tensor | None, y_dtype: torch.dtype):
    """Launch the kernel on inputs :func:`wkv6_scan` has validated
    (contiguous CUDA tensors, u float32); no host synchronisation.  Returns
    ``(state, y)``."""
    B, T, H, dh = r.shape
    if dh not in HEAD_DIMS or T < 1:
        raise ValueError(f"the WKV kernel is built for head widths {HEAD_DIMS} "
                         f"and T >= 1; got dh {dh}, T {T}")
    if state is not None and not state.is_contiguous():
        raise ValueError("the state is updated in place and must be contiguous")
    lib = _build.load_library()
    y = torch.empty((B, T, H, dh), dtype=y_dtype, device=r.device)
    out = state if state is not None else torch.empty(
        (B, H, dh, dh), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        err = lib.wkv6_launch(
            DTYPE_CODES[r.dtype], DTYPE_CODES[w.dtype], DTYPE_CODES[y_dtype],
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if state is None else state.data_ptr(), out.data_ptr(),
            y.data_ptr(), B, T, H, dh, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "WKV6 kernel launch")
    return out, y
