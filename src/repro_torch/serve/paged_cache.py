"""Paged BFP KV-cache plumbing for the serving engine (port of
`repro.serve.paged_cache`, DESIGN.md §14).

`PagePool` is the host-side free-list allocator with per-request
ownership. `insert_prefix`, `clear_pages` and `set_page_table` are the
cache-structure ops; they dispatch on the cache's type (`KVCache` /
`PagedKVCache`), not on key names, and write the cache tensors in place.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.attention import KVCache, PagedKVCache


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


class PagePool:
    """Free-list allocator over `n_pages` device pool pages."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._owned: Dict[int, List[int]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def occupancy(self) -> float:
        return self.used_pages / self.n_pages

    def alloc(self, rid: int, n: int) -> Optional[List[int]]:
        """Take `n` pages for request `rid`; None (nothing taken) when the
        pool cannot satisfy it."""
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(rid, []).extend(got)
        return got

    def free(self, rid: int) -> List[int]:
        """Return all of `rid`'s pages to the free list; returns the ids."""
        got = self._owned.pop(rid, [])
        self._free.extend(got)
        return got


def _insert_slab(c: KVCache, p: KVCache, lane: int) -> KVCache:
    """Overwrite lane `lane` with the full-capacity prefix slab, so a reused
    lane never keeps a previous tenant's tail."""
    for big, small in zip(c, p):
        if small is not None:
            big[:, lane:lane + 1] = small.to(big.dtype)
    return c


def _insert_pages(c: PagedKVCache, p: KVCache, lane: int,
                  page_ids) -> PagedKVCache:
    """Scatter the prefix slab into the lane's pool pages and bind its
    page-table row; `page_ids` is the full NP-entry row, -1 beyond the
    allocated prefix pages (those writes drop)."""
    L, P, ps = c.slot_pos.shape
    NP = c.page_table.shape[2]
    ids = torch.as_tensor(np.asarray(page_ids), dtype=torch.long,
                          device=c.k.device)
    ok = ids >= 0
    dst = ids[ok]
    # [L, 1, Hkv, C, ...] -> [L, NP, Hkv, ps, ...]: page axis before heads
    paged_h = lambda t: t[:, 0].reshape(
        L, t.shape[2], NP, ps, *t.shape[4:]).transpose(1, 2)[:, ok]
    c.k[:, dst] = paged_h(p.k).to(c.k.dtype)
    c.v[:, dst] = paged_h(p.v).to(c.v.dtype)
    c.slot_pos[:, dst] = p.slot_pos[:, 0].reshape(L, NP, ps)[:, ok]
    if c.k_exp is not None:
        c.k_exp[:, dst] = paged_h(p.k_exp)
        c.v_exp[:, dst] = paged_h(p.v_exp)
    c.page_table[:, lane] = ids.to(torch.int32)
    return c


def insert_prefix(cache, prefix, lane: int, page_ids=None):
    """Insert a prefill-produced prefix cache (B=1, full lane capacity)
    into lane `lane`: `KVCache` takes the whole-lane slab write,
    `PagedKVCache` the page scatter (`page_ids` required)."""
    out = {}
    for key, c in cache.items():
        if isinstance(c, PagedKVCache):
            if page_ids is None:
                raise ValueError("paged cache insert needs page_ids")
            out[key] = _insert_pages(c, prefix[key], lane, page_ids)
        else:
            out[key] = _insert_slab(c, prefix[key], lane)
    return out


def clear_pages(cache, page_ids):
    """Return freed pages to the empty state: slot maps -1 and payloads
    zeroed, so a recycled page gathers exactly like an untouched slab slot
    (the paged == slab contract). Entries of -1 are skipped."""
    for c in cache.values():
        if isinstance(c, PagedKVCache):
            ids = torch.as_tensor([i for i in page_ids if i >= 0],
                                  dtype=torch.long, device=c.k.device)
            if ids.numel() == 0:
                continue
            for t in (c.k, c.v, c.k_exp, c.v_exp):
                if t is not None:
                    t[:, ids] = 0
            c.slot_pos[:, ids] = -1
    return cache


def set_page_table(cache, table):
    """Rebind the device page table from the host mirror [B, NP] on every
    layer."""
    for c in cache.values():
        if isinstance(c, PagedKVCache):
            t = torch.as_tensor(np.asarray(table), dtype=torch.int32)
            c.page_table.copy_(t.to(c.page_table.device).expand_as(
                c.page_table))
    return cache
