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
