"""Public wrappers around the port's kernels (port of ``repro.kernels.ops``).

This slice carries the batched LRU update only; the attention and WKV
wrappers come with the model wing (ROADMAP queue 2, items 4-6).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.cache_update import lru_update


def lru_batch_update(timestamps: torch.Tensor, accessed: torch.Tensor, now,
                     *, tile: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """timestamps: (C,) int32; accessed: (N,) int32 slot ids (pad with -1);
    now: an int32 value.  Returns ``(new_timestamps, victim_slot)``.

    victim = the least-recently-used slot AFTER the batch is applied (the
    first index of the minimum).  ``tile`` was the TPU kernel's slot tile
    and changes no result; it must be > 0.  The kernel runs where the
    tensors are (the card, or the plain version on the CPU).
    """
    if int(tile) <= 0:
        raise ValueError(f"tile must be > 0, got {tile}")
    return lru_update(timestamps, accessed, now)
