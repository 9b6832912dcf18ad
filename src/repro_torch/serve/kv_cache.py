"""Paged/blocked KV cache bookkeeping, counterpart of the reference's
``serve/kv_cache.py``.

The physical KV store is a pool of fixed-size *pages* shared by every
sequence -- per layer ``{"k","v"}: (n_pages + 1, page_size, K, hd)`` device
tensors owned by :class:`PagedKVCache` (the extra page takes dropped writes,
see :mod:`repro_torch.models.layers`) -- and each lane (batch slot) owns an
ordered *block table* of page ids.  Logical token position ``p`` of a lane
lives at physical slot ``table[p // page_size] * page_size + p % page_size``.

This module is host-side bookkeeping (numpy block tables + a free-list
allocator); the block tables go to the device each step.

Invariants the tests pin down:

* a page is either on the free list or owned by exactly one lane;
* double-free and foreign-page frees raise;
* after every sequence of a trace is released the allocator is fully free
  (no leaked pages).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class OutOfPages(RuntimeError):
    """The free list is empty (admission control should prevent this)."""


class PageAllocator:
    """LIFO free-list over ``n_pages`` page ids with ownership checks."""

    def __init__(self, n_pages: int):
        if n_pages <= 0:
            raise ValueError(f"n_pages must be positive, got {n_pages}")
        self.n_pages = n_pages
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        self._owner: dict[int, int] = {}  # page id -> lane

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, owner: int) -> int:
        if not self._free:
            raise OutOfPages(f"all {self.n_pages} pages allocated")
        page = self._free.pop()
        self._owner[page] = owner
        return page

    def free(self, page: int, owner: int) -> None:
        if page not in self._owner:
            raise ValueError(f"page {page} is not allocated (double free?)")
        if self._owner[page] != owner:
            raise ValueError(
                f"page {page} owned by lane {self._owner[page]}, "
                f"freed by lane {owner}"
            )
        del self._owner[page]
        self._free.append(page)

    def pages_of(self, owner: int) -> list[int]:
        return sorted(p for p, o in self._owner.items() if o == owner)

    def assert_all_free(self) -> None:
        if self._owner:
            raise AssertionError(f"leaked pages: {sorted(self._owner)}")


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    n_pages: int
    page_size: int
    max_batch: int          # number of lanes
    max_blocks: int         # block-table length = max context / page_size

    @property
    def max_context(self) -> int:
        return self.max_blocks * self.page_size

    def blocks_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` (worst case for admission)."""
        return -(-n_tokens // self.page_size)


class PagedKVCache:
    """Device page pool + host block tables for up to ``max_batch`` lanes.

    ``pages`` is the model's per-layer pool from
    :meth:`DecoderLM.init_paged_cache`, updated in place by the decode and
    prefill steps.  ``block_tables`` is a (max_batch, max_blocks) int32 array,
    -1 meaning unallocated, copied to ``device`` each call (a few KB).
    """

    def __init__(self, model, config: PagedCacheConfig, device: torch.device | str = "cpu"):
        self.config = config
        self.device = torch.device(device)
        self.allocator = PageAllocator(config.n_pages)
        self.pages = model.init_paged_cache(config.n_pages, config.page_size)
        self.block_tables = np.full(
            (config.max_batch, config.max_blocks), -1, np.int32
        )
        self._n_blocks = np.zeros(config.max_batch, np.int32)

    # ------------------------------------------------------------- capacity
    def ensure_capacity(self, lane: int, n_tokens: int) -> None:
        """Grow lane's block table so positions ``[0, n_tokens)`` are backed
        by pages, allocating from the free list as needed."""
        cfg = self.config
        if n_tokens > cfg.max_context:
            raise ValueError(
                f"{n_tokens} tokens exceed max context {cfg.max_context}"
            )
        need = cfg.blocks_for(n_tokens)
        while self._n_blocks[lane] < need:
            page = self.allocator.alloc(lane)
            self.block_tables[lane, self._n_blocks[lane]] = page
            self._n_blocks[lane] += 1

    def release(self, lane: int) -> None:
        """Return all of lane's pages to the free list (page *recycling*;
        the stale KV values in them are dead -- any future owner overwrites
        slots before its masks expose them)."""
        for i in range(int(self._n_blocks[lane])):
            self.allocator.free(int(self.block_tables[lane, i]), lane)
        self.block_tables[lane, :] = -1
        self._n_blocks[lane] = 0

    def n_blocks(self, lane: int) -> int:
        return int(self._n_blocks[lane])

    # ---------------------------------------------------------- device views
    def device_block_tables(self) -> torch.Tensor:
        return torch.tensor(self.block_tables, device=self.device)

    def lane_table(self, lane: int) -> torch.Tensor:
        return torch.tensor(self.block_tables[lane], device=self.device)
