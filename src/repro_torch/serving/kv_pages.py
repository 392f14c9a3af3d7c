"""Device-side KV page pool + host-side allocator.

Port of ``repro.serving.kv_pages``.  The pool mirrors the stage-stacked
cache structure of :mod:`repro_torch.models.transformer`, one entry per
stage and pattern position.  For attention, pages hold ``page_size`` tokens
of K/V: a :class:`KVPool` (K and V, each ``(g, n_pages, page, KV, dh)``), so
``pool.k[i]`` is layer ``i``'s ``(P, page, KV, dh)`` pool, the layout the
paged-attention kernel reads.  (The reference's pool tree carries ``None``
at the caches' index leaves; the port keeps K and V pools only.)  For a
recurrent state (rwkv6), a page holds one snapshot of every state leaf:
the cache's own state type with each leaf ``(g, n_pages, *state)``.  The
prefix cache is the sole owner of pool pages: admission *gathers* hit pages
(or restores a snapshot) into the request's decode-cache slot, so pages are
never referenced by in-flight requests and eviction is always safe.

The copies are in place (the reference returns new arrays).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch


class PageAllocator:
    """Host-side free list over page ids [0, n_pages)."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages))

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("page pool exhausted")
        return self._free.pop()

    def free(self, page_id: int) -> None:
        self._free.append(page_id)

    @property
    def n_free(self) -> int:
        return len(self._free)


class KVPool(NamedTuple):
    k: torch.Tensor  # (g, n_pages, page, KV, dh)
    v: torch.Tensor


def make_kv_pool_leaf(leaf: torch.Tensor, n_pages: int, page_size: int,
                      is_kv: bool = True) -> torch.Tensor:
    """Pool array for one cache leaf.

    K/V leaves (g, B, S, KV, dh) -> chunk pages (g, n_pages, page, KV, dh);
    recurrent-state leaves (g, B, *state) -> snapshots (g, n_pages, *state).
    """
    g = leaf.shape[0]
    if is_kv:
        _, _, _, kvh, dh = leaf.shape
        shape = (g, n_pages, page_size, kvh, dh)
    else:
        shape = (g, n_pages) + tuple(leaf.shape[2:])
    return torch.zeros(shape, dtype=leaf.dtype, device=leaf.device)


def store_chunk(pool_leaf: torch.Tensor, cache_leaf: torch.Tensor, slot: int,
                start: int, page_id: int) -> None:
    """pool[page_id] <- cache[slot, start : start+page] (one K/V leaf)."""
    page = pool_leaf.shape[2]
    if start + page > cache_leaf.shape[2]:
        raise ValueError(f"chunk [{start}, {start + page}) runs past the cache")
    pool_leaf[:, page_id] = cache_leaf[:, slot, start:start + page]


def gather_pages(cache_leaf: torch.Tensor, pool_leaf: torch.Tensor, slot: int,
                 page_ids) -> None:
    """cache[slot, 0 : n*page] <- pool[page_ids] (one K/V leaf)."""
    ids = torch.as_tensor(page_ids, dtype=torch.long, device=pool_leaf.device)
    pages = pool_leaf[:, ids]  # (g, n, page, KV, dh)
    g, n, page = pages.shape[:3]
    if n * page > cache_leaf.shape[2]:
        raise ValueError(f"{n} pages of {page} tokens run past the cache")
    cache_leaf[:, slot, :n * page] = pages.reshape(g, n * page, *pages.shape[3:])


def store_state(pool_leaf: torch.Tensor, state_leaf: torch.Tensor, slot: int,
                page_id: int) -> None:
    """Snapshot pool[page_id] <- state[slot] (one recurrent-state leaf)."""
    pool_leaf[:, page_id] = state_leaf[:, slot]


def restore_state(state_leaf: torch.Tensor, pool_leaf: torch.Tensor, slot: int,
                  page_id: int) -> None:
    """state[slot] <- pool[page_id] (one recurrent-state leaf)."""
    state_leaf[:, slot] = pool_leaf[:, page_id]
