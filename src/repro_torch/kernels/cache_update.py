"""Batched LRU metadata update: ``timestamps[a] = now`` for every accessed
slot, then the LRU victim.

Port of ``repro.kernels.cache_update`` (the Pallas ``_sweep_kernel``).  The
paper's LRU serializes a delink and a head update per hit; the batched
variant keeps a recency timestamp per slot and applies a whole batch of
accesses as one sweep, whose victim is the first index of the minimum
timestamp.

:func:`lru_update` is the kernel wrapper: on CUDA tensors it launches the
hand-written kernel (``csrc/cache_update.cu``: a chunk of slots per block
with the batch's ids marked in a shared-memory bitmap, then a one-block
argmin over the blocks' minima) or raises; on CPU tensors it runs the plain
version, :func:`lru_update_plain` (``index_fill_`` then ``argmin``).  Both
return exactly the reference's ``ref.lru_batch_update_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_INT32_MAX = 2**31 - 1


def lru_update_plain(timestamps: torch.Tensor, accessed: torch.Tensor,
                     now: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: ``(new_timestamps, victim)``,
    victim a 0-d int32 tensor (the first index of the minimum)."""
    new_ts = timestamps.clone()
    new_ts.index_fill_(0, accessed[accessed >= 0].long(), now)
    return new_ts, torch.argmin(new_ts).to(torch.int32)


def lru_update(timestamps: torch.Tensor, accessed: torch.Tensor,
               now: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply one access batch: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.

    ``timestamps`` is (C,) int32, ``accessed`` (N,) int32 slot ids (-1 or
    any negative id pads and is skipped; duplicates are harmless), ``now``
    an int32 value.  Raises on an id >= C, which the reference would let
    hit a padding sentinel.
    """
    if timestamps.dim() != 1 or timestamps.dtype != torch.int32:
        raise ValueError("timestamps must be (C,) int32")
    if accessed.dim() != 1 or accessed.dtype != torch.int32:
        raise ValueError("accessed must be (N,) int32")
    if accessed.device != timestamps.device:
        raise ValueError(f"accessed on {accessed.device}, timestamps on "
                         f"{timestamps.device}")
    n_slots, n_acc = timestamps.shape[0], accessed.shape[0]
    if not 0 < n_slots <= 2**30:
        raise ValueError(f"capacity must be in [1, 2**30], got {n_slots}")
    now = int(now)
    if not -_INT32_MAX - 1 <= now <= _INT32_MAX:
        raise ValueError(f"now={now} is not an int32")
    if n_acc and int(accessed.max()) >= n_slots:
        raise ValueError(f"accessed slot {int(accessed.max())} >= capacity "
                         f"{n_slots}")
    dev = timestamps.device
    if dev.type == "cpu":
        return lru_update_plain(timestamps, accessed, now)
    if dev.type != "cuda":
        raise ValueError(f"no LRU-update kernel for device {dev}")
    out = launch(timestamps.contiguous(), accessed.contiguous(), now)
    lru_update.launches += 1
    return out


lru_update.launches = 0  # kernel launches (CUDA path only)


def launch(ts: torch.Tensor, accessed: torch.Tensor,
           now: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on inputs :func:`lru_update` has validated
    (contiguous CUDA int32, every id < C); no host synchronisation."""
    lib = _build.load_library()
    dev = ts.device
    new_ts = torch.empty_like(ts)
    part = torch.empty(2 * lib.lru_update_blocks(ts.shape[0]),
                       dtype=torch.int32, device=dev)
    victim = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lru_update_launch(
            ts.data_ptr(), accessed.data_ptr(), new_ts.data_ptr(),
            part.data_ptr(), victim.data_ptr(), ts.shape[0],
            accessed.shape[0], now, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "LRU-update kernel launch")
    return new_ts, victim
