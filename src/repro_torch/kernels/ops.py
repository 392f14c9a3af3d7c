"""Public wrappers around the port's kernels (port of ``repro.kernels.ops``).

The batched LRU update, flash attention, paged decode attention and the
WKV6 scan.  Each runs where its tensors are: the hand-written kernel on the
card, its plain version on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import linear_scan as _scan
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels.cache_update import lru_update


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``(B, T, H, dh) x (B, S, KV, dh) -> (B, T, H, dh)`` (model layout).

    The reference's ``bq``/``bk`` TPU tiles have no counterpart: bf16 at
    d_head 64/128 runs the tensor-core kernel on 128 x 128 tiles, float32
    and the other head widths the split-TF32 kernel on 128-row q tiles
    and 64- (32 above d_head 128) column K/V tiles
    (``flash_attention.kernel_for``).  Causal attention needs T == S.
    """
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def paged_attention(q: torch.Tensor, pages_k: torch.Tensor,
                    pages_v: torch.Tensor, block_table: torch.Tensor,
                    seq_lens: torch.Tensor) -> torch.Tensor:
    """q ``(B, H, dh)``, pages ``(P, page, KV, dh)``, block_table
    ``(B, n_pages)`` int32 (pad with 0), seq_lens ``(B,)`` int32 ->
    ``(B, H, dh)``."""
    return _paged.paged_attention(q, pages_k, pages_v, block_table, seq_lens)


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """r, k, v, w: ``(B, T, H, dh)`` in one dtype (float32 or bfloat16); u:
    ``(H, dh)``.  Returns y ``(B, T, H, dh)`` in r's dtype, the scan started
    from a zero state.

    ``chunk`` was the TPU kernel's time tile: the reference pads T to a
    multiple of it with w = 1 and k = v = 0, which leaves the state exactly
    unchanged.  The kernel needs no padding, so ``chunk`` changes no result;
    it must be > 0.
    """
    if int(chunk) <= 0:
        raise ValueError(f"chunk must be > 0, got {chunk}")
    return _scan.wkv6_scan(r, k, v, w, u, y_dtype=r.dtype)[1]


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
