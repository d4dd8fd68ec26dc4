"""Block-table paged KV cache with shared-prefix reuse (the JAX
package's ``generation/paged_cache.py``: full-width and int8 pools).

- **PagedKVCache**: ``k, v`` pools of shape ``[layers, n_pages,
  page_size, heads, head_dim]``, a per-row int32 ``page_table [batch,
  pages_per_row]`` and the per-row ``kv_len``. As the port's
  ``KVCache``, it is updated IN PLACE: ``update``, ``install_row``,
  ``install_span``, ``reset_rows`` and ``with_kv_len`` overwrite the
  tensors and return the same object. Every write resolves its
  destination page through the table on the device, so no write needs a
  host sync. The paged decode kernel reads a layer's pool slice
  ``k[layer]`` through the table in place.
- **QuantPagedKVCache**: the int8 pool, with bf16 scale pools
  ``k_scale``/``v_scale [layers, n_pages, page_size, heads]`` and the
  ``clips`` counter. The scales live in the page, so prefix sharing,
  copy-on-write and reclaim carry them with the values.
- **Page 0 is the reserved null page**: masked install positions,
  out-of-table positions and idle engine lanes (``kv_len == 0``) all
  write there, and nothing reads it unmasked. So a parked slot with a
  stale table is harmless while its pages belong to another row.
- **PageAllocator** (host only): free list, per-page refcounts and a
  prompt-prefix registry hashed at page granularity. An admission whose
  leading full pages hash-match a registered prompt references those
  pages instead of storing a copy; a prompt that diverges inside the
  page after a fully matched prefix gets a private copy-on-write page at
  admission. Registered pages with refcount 0 stay cached for later
  prefix hits and are reclaimed LRU when the free list runs dry.
"""
from __future__ import annotations

import collections
import hashlib
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .kv_cache import KVCache, quantize_kv, validate_cache_dtype

__all__ = ["PagedKVCache", "QuantPagedKVCache", "PageAllocator",
           "AdmissionPlan"]


class PagedKVCache:
    """Paged K/V pool + per-row page tables + per-row valid lengths.

    Implements the decode half of the KV-cache protocol (``update``,
    ``positions``, ``with_kv_len``, ``reset_rows``, ``kv_len``) so the
    model drives it unchanged; prefill stays on the dense batch-1 row
    cache, which ``install_row`` then scatters into the pool through the
    table."""

    __slots__ = ("k", "v", "page_table", "kv_len")

    def __init__(self, k, v, page_table, kv_len):
        self.k = k
        self.v = v
        self.page_table = page_table
        self.kv_len = kv_len

    # ------------------------------------------------------------- shape
    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def batch(self) -> int:
        return self.page_table.shape[0]

    @property
    def pages_per_row(self) -> int:
        return self.page_table.shape[1]

    @property
    def max_len(self) -> int:
        """Logical per-row capacity (the dense cache's ``max_len``)."""
        return self.pages_per_row * self.page_size

    @property
    def cache_dtype(self):
        """The low-bit storage mode (None = full width)."""
        return None

    # ---------------------------------------------------------- creation
    @classmethod
    def create(cls, num_layers: int, batch: int, n_pages: int,
               page_size: int, pages_per_row: int, num_heads: int,
               head_dim: int, dtype=torch.float32, device=None,
               cache_dtype=None) -> "PagedKVCache":
        """A zeroed pool; ``cache_dtype="int8"`` gives a
        :class:`QuantPagedKVCache`."""
        shape = (num_layers, n_pages, page_size, num_heads, head_dim)
        table = torch.zeros((batch, pages_per_row), dtype=torch.int32,
                            device=device)
        kv_len = torch.zeros((batch,), dtype=torch.int32, device=device)
        if validate_cache_dtype(cache_dtype) is not None:
            sshape = shape[:-1]
            return QuantPagedKVCache(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device), table,
                kv_len,
                torch.zeros(sshape, dtype=torch.bfloat16, device=device),
                torch.zeros(sshape, dtype=torch.bfloat16, device=device),
                torch.zeros((), dtype=torch.int32, device=device))
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), table,
                   kv_len)

    # ------------------------------------------------------------ update
    def _write_pages(self, pos):
        """(page, offset) destinations for per-row write positions
        ``pos`` ([batch, s] int64): resolve through the table, routing
        idle lanes (row write base 0: the engine pins finished slots'
        kv_len to 0) and out-of-table positions to the null page 0."""
        slot = pos // self.page_size
        page = torch.gather(self.page_table.long(), 1,
                            slot.clamp(max=self.pages_per_row - 1))
        dead = (pos[:, 0:1] == 0) | (slot >= self.pages_per_row)
        return page.masked_fill(dead, 0), pos % self.page_size

    def _update_pages(self, b: int, s: int, pos):
        """(page, offset) [b, s] destinations of ``s`` writes per row
        starting at ``pos`` ([batch] int tensor or an int)."""
        pos = torch.as_tensor(pos, device=self.k.device)
        if pos.dim() == 0:
            pos = pos.expand(b)
        positions = pos.long()[:, None] + \
            torch.arange(s, device=self.k.device)[None, :]
        return self._write_pages(positions)

    def update(self, layer: int, k_new, v_new, pos) -> "PagedKVCache":
        """Write ``k_new``/``v_new`` ([batch, s, heads, head_dim]) into
        ``layer`` at per-row start position ``pos`` through the page
        table, in place. A live row's ``pos`` (its ``kv_len``) is >= 1,
        so a row writing at position 0 is an idle engine lane and lands
        on the null page. Does NOT advance ``kv_len``."""
        page, off = self._update_pages(k_new.shape[0], k_new.shape[1], pos)
        self.k[layer][page, off] = k_new.to(self.k.dtype)
        self.v[layer][page, off] = v_new.to(self.v.dtype)
        return self

    def _row_pages(self, src: KVCache, table_row, start):
        """(table row, page, offset) of every position of the batch-1
        dense cache ``src``: positions ``[start, src.kv_len[0])`` go to
        the pool pages named by ``table_row``, every other one to the
        null page."""
        dev = self.k.device
        table_row = torch.as_tensor(table_row, device=dev).long()
        start = torch.as_tensor(start, device=dev)
        pos = torch.arange(src.max_len, device=dev)
        page_slot = pos // self.page_size
        page = table_row[page_slot.clamp(max=self.pages_per_row - 1)]
        valid = (pos >= start) & (pos < src.kv_len[0]) & \
            (page_slot < self.pages_per_row)
        page = torch.where(valid, page, torch.zeros_like(page))
        return table_row, page, pos % self.page_size

    def _scatter_row(self, src: KVCache, table_row, start):
        """Scatter positions ``[start, src.kv_len[0])`` of ``src`` into
        the pool pages named by ``table_row`` (every layer); returns the
        table row."""
        table_row, page, off = self._row_pages(src, table_row, start)
        self.k[:, page, off] = src.k[:, 0].to(self.k.dtype)
        self.v[:, page, off] = src.v[:, 0].to(self.v.dtype)
        return table_row

    def install_row(self, src: KVCache, slot: int, table_row,
                    start) -> "PagedKVCache":
        """Slot admission: scatter the batch-1 dense prefill cache
        ``src`` into the pool pages named by ``table_row``
        ([pages_per_row] int), then install the table row and ``kv_len``
        at ``slot``. Positions below ``start`` are covered by shared
        prefix pages and are NOT written; positions at or past
        ``src.kv_len[0]`` go to the null page."""
        table_row = self._scatter_row(src, table_row, start)
        self.page_table[slot] = table_row.to(torch.int32)
        self.kv_len[slot] = src.kv_len[0]
        return self

    def install_span(self, src: KVCache, table_row,
                     start) -> "PagedKVCache":
        """Chunked-prefill incremental install: scatter positions
        ``[start, src.kv_len[0])`` of the batch-1 chunk cache ``src``
        into the pages named by ``table_row`` WITHOUT installing the
        table row or ``kv_len``: the slot stays parked (kv_len 0) until
        the final chunk's ``install_row`` installs both."""
        self._scatter_row(src, table_row, start)
        return self

    def positions(self, s: int):
        """Absolute positions of ``s`` appended tokens per row (the
        decode position offsets, as the dense cache's)."""
        return self.kv_len.long()[:, None] + \
            torch.arange(s, device=self.k.device)[None, :]

    # -------------------------------------------------------- slot reuse
    def reset_rows(self, rows) -> "PagedKVCache":
        """Free rows for reuse: zero ``kv_len`` AND null the page-table
        row (a row index, a list of them, or a [batch] bool mask). The
        host allocator returns the pages themselves; this only severs
        the row's pointers, so a stale lane can never write through them
        once the pages belong to another row."""
        if isinstance(rows, torch.Tensor) and rows.dtype == torch.bool:
            rows = rows.to(self.kv_len.device)
            self.kv_len.masked_fill_(rows, 0)
            self.page_table.masked_fill_(rows[:, None], 0)
        else:
            self.kv_len[rows] = 0
            self.page_table[rows] = 0
        return self

    def with_kv_len(self, kv_len) -> "PagedKVCache":
        """Set every row's valid length (an int or a [batch] tensor),
        in place."""
        kv_len = torch.as_tensor(kv_len, device=self.k.device)
        self.kv_len.copy_(kv_len.to(torch.int32).expand(self.batch))
        return self

    def occupancy(self) -> float:
        """Host-side fraction of the LOGICAL per-row capacity in use
        (max over rows): the gen.cache_occupancy gauge; page-level
        occupancy is the allocator's ``page_occupancy``. Reads kv_len
        on the host, so callers read it only at a poll."""
        return float(int(self.kv_len.max())) / self.max_len

    def __repr__(self):
        return (f"PagedKVCache(layers={self.num_layers}, "
                f"batch={self.batch}, pages={self.n_pages}x"
                f"{self.page_size}, per_row={self.pages_per_row}, "
                f"dtype={self.k.dtype})")


class QuantPagedKVCache(PagedKVCache):
    """Int8 page pool: K/V pages int8 with per-(slot, head) bf16 scales in
    the scale pools ``k_scale``/``v_scale`` ([layers, n_pages,
    page_size, heads]) and the 0-d int32 ``clips`` counter. The scales
    live IN the page, so everything the allocator does at page
    granularity (prefix sharing, copy-on-write, reclaim) carries them
    with the values: a shared page dequantizes alike for every sharer,
    and a copy-on-write page gets values and scales together."""

    __slots__ = ("k_scale", "v_scale", "clips")

    def __init__(self, k, v, page_table, kv_len, k_scale, v_scale,
                 clips):
        super().__init__(k, v, page_table, kv_len)
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.clips = clips

    @property
    def cache_dtype(self):
        return "int8"

    def update(self, layer: int, k_new, v_new,
               pos) -> "QuantPagedKVCache":
        """Quantize the fresh k/v per (token, head) and write int8 values
        and bf16 scales through the page table, with the wide pool's
        null-page routing; saturated values add to ``clips``."""
        page, off = self._update_pages(k_new.shape[0], k_new.shape[1], pos)
        kq, ks, kc = quantize_kv(k_new)
        vq, vs, vc = quantize_kv(v_new)
        self.k[layer][page, off] = kq
        self.v[layer][page, off] = vq
        self.k_scale[layer][page, off] = ks
        self.v_scale[layer][page, off] = vs
        self.clips += kc + vc
        return self

    def _scatter_row(self, src, table_row, start):
        """Scatter a batch-1 :class:`QuantKVCache` row's int8 values AND
        scales verbatim (no requantization): the installed pages decode
        bitwise equal to the dense row."""
        table_row, page, off = self._row_pages(src, table_row, start)
        for name in ("k", "v", "k_scale", "v_scale"):
            getattr(self, name)[:, page, off] = getattr(src, name)[:, 0]
        return table_row

    def install_row(self, src, slot: int, table_row,
                    start) -> "QuantPagedKVCache":
        """Slot admission from a batch-1 :class:`QuantKVCache` prefill
        row (see the wide pool's); ``src.clips`` folds in once. The
        inherited ``install_span`` does NOT fold it: the final
        ``install_row`` of a chunked admission adds the side cache's
        counter once, which per-span folding would count again for
        every earlier chunk."""
        super().install_row(src, slot, table_row, start)
        self.clips += src.clips
        return self

    def __repr__(self):
        return (f"QuantPagedKVCache(layers={self.num_layers}, "
                f"batch={self.batch}, pages={self.n_pages}x"
                f"{self.page_size}, per_row={self.pages_per_row}, "
                f"dtype=int8+bf16-scales)")


class AdmissionPlan:
    """One admission's page plan (host only): the shared prefix pages to
    reference, how many private pages to allocate, and whether the
    divergence point sits inside a shared page (copy-on-write)."""

    __slots__ = ("shared_pages", "shared_len", "n_private", "cow",
                 "total_pages", "keys")

    def __init__(self, shared_pages, shared_len, n_private, cow,
                 total_pages, keys):
        self.shared_pages = shared_pages    # List[int]
        self.shared_len = shared_len        # tokens covered by sharing
        self.n_private = n_private          # pages to allocate
        self.cow = cow                      # divergence inside a shared
        #                                     page -> private copy made
        self.total_pages = total_pages
        self.keys = keys                    # full-page registry keys


class PageAllocator:
    """Host-side page bookkeeping: free list, refcounts, and the
    prompt-prefix registry. Page 0 is reserved (the null page) and is
    never allocated. All state is host ints: no device tensors, no
    syncs. The engine calls ``plan``/``commit`` at admission,
    ``register`` after install, and ``free_row`` at completion or
    eviction. ``assert_conserved`` is the drain-time invariant: every
    page is exactly one of {null, free, referenced, cached}."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the "
                             "reserved null page)")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}          # page -> live row refs
        # prefix registry: full-page key -> page id (insertion order is
        # the LRU order; re-registration moves to the back)
        self._prefix: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        self._page_key: Dict[int, bytes] = {}   # page -> its registry key
        self.stats = dict(pages_allocated=0, pages_freed=0,
                          prefix_hits=0, shared_pages=0, cow_copies=0,
                          reclaimed=0)
        # bumped on every state mutation: the engine caches a blocked
        # queue head's failed plan against it, so a saturated pool is
        # re-planned only when something changed
        self.version = 0

    # ---------------------------------------------------------- hashing
    def _page_keys(self, ids: np.ndarray) -> List[bytes]:
        """Chained per-page digests of the prompt's FULL pages: key i
        commits to every token in pages 0..i, so a match at page i
        implies the whole prefix matches."""
        keys, h = [], hashlib.blake2b(digest_size=16)
        ps = self.page_size
        for i in range(len(ids) // ps):
            h.update(np.ascontiguousarray(
                ids[i * ps:(i + 1) * ps]).tobytes())
            keys.append(h.digest())
        return keys

    # ------------------------------------------------------- accounting
    def free_pages(self) -> int:
        """Pages allocatable right now: the free list plus cached
        (registered, refcount-0) pages the reclaimer may take."""
        with self._lock:
            return len(self._free) + sum(
                1 for p in self._prefix.values() if not self._ref.get(p))

    def used_pages(self) -> int:
        return len(self._ref)

    def page_occupancy(self) -> float:
        """Referenced pages / allocatable universe (excludes null)."""
        return len(self._ref) / max(1, self.n_pages - 1)

    # -------------------------------------------------------- admission
    def plan(self, ids: np.ndarray, extra_tokens: int) -> AdmissionPlan:
        """Plan one admission: prompt ``ids`` plus ``extra_tokens`` of
        decode budget. Pure read: commits nothing."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        ps = self.page_size
        plen = int(ids.size)
        total = -(-(plen + int(extra_tokens)) // ps)
        keys = self._page_keys(ids)
        shared: List[int] = []
        with self._lock:
            for key in keys:
                page = self._prefix.get(key)
                if page is None:
                    break
                shared.append(page)
        shared_len = len(shared) * ps
        # copy-on-write: the prompt diverges INSIDE a page whose prefix
        # is shared (its full pages all matched and a partial tail
        # remains); the install privatizes that page's content
        cow = bool(shared) and shared_len == (plen // ps) * ps \
            and plen % ps != 0
        return AdmissionPlan(shared, shared_len, total - len(shared),
                             cow, total, keys)

    def commit(self, plan: AdmissionPlan) -> Optional[List[int]]:
        """Acquire the plan's pages: reference the shared prefix pages
        and allocate the private ones (reclaiming cached prefix pages
        LRU if the free list runs dry). Returns the row's full page
        list (shared + private, position order), or None when the pool
        cannot cover it; the caller leaves the request queued."""
        with self._lock:
            if plan.n_private > len(self._free):
                self._reclaim(plan.n_private - len(self._free),
                              protect=set(plan.shared_pages))
            if plan.n_private > len(self._free):
                return None
            private = [self._free.pop() for _ in range(plan.n_private)]
            for p in private:
                self._ref[p] = 1
            for p in plan.shared_pages:
                self._ref[p] = self._ref.get(p, 0) + 1
            self.version += 1
            self.stats["pages_allocated"] += len(private)
            if plan.shared_pages:
                self.stats["prefix_hits"] += 1
                self.stats["shared_pages"] += len(plan.shared_pages)
            if plan.cow:
                self.stats["cow_copies"] += 1
            return plan.shared_pages + private

    def register(self, plan: AdmissionPlan, pages: List[int]):
        """Register the admitted prompt's FULL pages for later prefix
        hits (key i -> pages[i]). Safe because full prompt pages are
        never written after install: decode appends at the row's kv_len,
        past the last full prompt page. Re-registering a shared page
        refreshes its LRU position."""
        with self._lock:
            for i, key in enumerate(plan.keys):
                old = self._prefix.pop(key, None)
                if old is not None and old != pages[i]:
                    # the key was installed onto another page while the
                    # old one still exists: drop the old binding
                    self._page_key.pop(old, None)
                    self._maybe_release(old)
                self._prefix[key] = pages[i]
                self._page_key[pages[i]] = key
            if plan.keys:
                self.version += 1

    def free_row(self, pages: List[int]):
        """Release one row's page references (completion, eviction).
        Unreferenced unregistered pages return to the free list;
        unreferenced REGISTERED pages stay cached for later prefix hits
        until reclaimed."""
        with self._lock:
            for p in pages:
                n = self._ref.get(p, 0) - 1
                if n > 0:
                    self._ref[p] = n
                else:
                    self._ref.pop(p, None)
                    self._maybe_release(p)
            self.version += 1

    def _maybe_release(self, page: int):
        # caller holds self._lock
        if page in self._ref or page in self._page_key:
            return
        self._free.append(page)
        self.stats["pages_freed"] += 1

    def _reclaim(self, need: int, protect=frozenset()):
        """Evict cached (refcount-0, registered) prefix pages LRU-first
        until ``need`` pages were freed or nothing reclaimable is left.
        Caller holds self._lock."""
        for key in list(self._prefix):
            if need <= 0:
                break
            page = self._prefix[key]
            if self._ref.get(page) or page in protect:
                continue
            del self._prefix[key]
            del self._page_key[page]
            self._free.append(page)
            self.version += 1
            self.stats["pages_freed"] += 1
            self.stats["reclaimed"] += 1
            need -= 1

    def drop_registry(self):
        """Forget every cached prefix (refcount-0 registered pages go
        back to the free list); a test and diagnostic hook."""
        with self._lock:
            self._reclaim(len(self._prefix))
            # still-referenced registered pages lose their registry entry
            for key in list(self._prefix):
                page = self._prefix.pop(key)
                self._page_key.pop(page, None)
            self.version += 1

    # ------------------------------------------------------ invariants
    def assert_conserved(self):
        """Every page is exactly one of {null, free, referenced,
        cached}: no leaks, no double frees."""
        with self._lock:
            free = set(self._free)
            if len(free) != len(self._free):
                raise AssertionError("double-freed page(s): free list has "
                                     "duplicates")
            refd = set(self._ref)
            cached = {p for p in self._page_key if p not in refd}
            if free & refd or free & cached:
                raise AssertionError(
                    f"page in two states: free∩ref={sorted(free & refd)} "
                    f"free∩cached={sorted(free & cached)}")
            if 0 in free or 0 in refd or 0 in cached:
                raise AssertionError("reserved null page 0 was allocated")
            total = 1 + len(free) + len(refd) + len(cached)
            if total != self.n_pages:
                raise AssertionError(
                    f"page leak: null+free({len(free)})+referenced"
                    f"({len(refd)})+cached({len(cached)}) = {total} != "
                    f"pool {self.n_pages}")

    def __repr__(self):
        return (f"PageAllocator(pages={self.n_pages}x{self.page_size}, "
                f"free={len(self._free)}, used={len(self._ref)}, "
                f"cached={len(self._prefix)})")
