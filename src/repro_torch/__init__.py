"""repro_torch — the PyTorch/CUDA port of :mod:`repro`.

The package mirrors ``src/repro/`` module for module (``cache/``, ``core/``,
``kernels/``) and imports ``torch`` and numpy only: nothing of ``jax`` and
nothing of ``repro``.  Every public entry point takes ``device=`` and runs
on the card unless the caller asks for the CPU.  On a CUDA tensor each
kernel wrapper launches its hand-written kernel (or raises); on a CPU
tensor it runs the kernel's plain PyTorch version.  The JAX package's
``backend=`` switch is this device choice.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless told otherwise.

    Raises when CUDA is asked for and there is none — an entry point never
    quietly runs on the CPU.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (want cuda or cpu)")
    return dev


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    The reference's ``elapsed_us + t * 1e-3`` and its streaming EWMA steps
    (``s * decay + a``) are compiled by XLA's CPU backend into fused
    multiply-adds, and the CUDA kernels compute them with ``__fmaf_rn``.
    Here the product of two float32 values is exact in float64; the
    float64 sum is made round-to-odd (its error, from TwoSum, picks the odd
    neighbour), which then rounds to the same float32 as the exact
    ``a * b + c``.
    """
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - c
    err = (c - (s - bb)) + (p - bb)
    bits = s.view(torch.int64)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & (bits & 1 == 0), bits + toward, bits)
    return bits.view(torch.float64).to(torch.float32)
