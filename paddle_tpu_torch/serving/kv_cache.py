"""Paged KV-cache pool (counterpart: paddle_tpu/serving/kv_cache.py:147).

One bf16 ``[num_pages, page_size, kv_heads, head_dim]`` tensor pair per
layer on the device — the JAX engine's pool is bf16 even for an fp32
model (engine.py:201-208) — or, with ``quantized=True``, one
``QuantizedKV`` pair per layer: int8 codes ``[num_pages, page_size,
kv_heads, head_dim]`` and fp32 absmax scales ``[num_pages, page_size,
kv_heads]`` (kv_cache.py:150-215). Requests own pages through int32
block tables. On top of the allocator sits automatic prefix caching:
pages are reference counted, full pages are indexed by a chained
blake2b content hash, released pages stay resident as refcount-0
cached pages on an LRU, and a partially filled page is shared only
copy-on-write (``cow_into``).

Invariants (as in the JAX pool):
- page 0 is the scratch page: never handed out; inactive slots and
  padded rows write it, and masked reads of it contribute exactly 0;
- ``alloc`` is all-or-nothing;
- a page with refcount > 0 is written only by its single owner and
  never scrubbed; evicted and quarantined pages are zeroed before reuse
  (masked garbage is always zero).

The JAX pool replaces its arrays functionally; this one updates the
tensors in place (``cow_into``, ``scrub``, ``rewind`` and the engine's
steps), so ``pools`` always names the live tensors. Every operation on
page content touches a quantized page's codes and its scales together.

Not ported: the host spill tier, the stacked and sharded layouts,
export/inject for snapshots, and fault sites.
"""

from __future__ import annotations

import hashlib
import math
import struct
from collections import OrderedDict
from dataclasses import dataclass, field

import torch

from ..core import resolve_device
from ..quantization.serving import QuantizedKV
from .errors import PoolExhaustedError

__all__ = ["KVCachePool", "PoolExhaustedError", "PrefixMatch"]

# chain roots of the page-content hash (kv_cache.py:66-70): an int8 pool
# chains from another root, so the same tokens in the two storage
# formats never share a key
_HASH_ROOT = b"\x00" * 16
_HASH_ROOT_INT8 = hashlib.blake2b(b"paddle_tpu.kv.int8",
                                  digest_size=16).digest()


def _parts(arr) -> tuple:
    """The tensors that hold a pool's content: codes and scales of a
    QuantizedKV, else the one tensor."""
    return tuple(arr) if isinstance(arr, QuantizedKV) else (arr,)


def _page_hash(parent: bytes, tokens) -> bytes:
    """Chained page-content key H(parent, page_tokens), blake2b-128 over
    the exact token bytes (kv_cache.py:99)."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(struct.pack(f"<{len(tokens)}q", *tokens))
    return h.digest()


@dataclass
class PrefixMatch:
    """Longest cached prefix at page granularity: ``full_pages`` map
    directly; ``partial_page`` (if any) is reused only through
    ``cow_into`` a fresh page."""
    full_pages: list[int] = field(default_factory=list)
    partial_page: int | None = None
    partial_len: int = 0
    cached_tokens: int = 0

    @property
    def hit(self) -> bool:
        return self.cached_tokens > 0


class KVCachePool:
    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int, device=None,
                 quantized: bool = False):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the "
                             "reserved scratch page)")
        self.device = resolve_device(device)
        self.num_layers = num_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.quantized = quantized
        self.dtype = torch.int8 if quantized else torch.bfloat16
        shape = (num_pages, page_size, num_kv_heads, head_dim)

        def _zeros():
            if quantized:
                return QuantizedKV(
                    torch.zeros(shape, dtype=torch.int8, device=self.device),
                    torch.zeros(shape[:-1], dtype=torch.float32,
                                device=self.device))
            return torch.zeros(shape, dtype=torch.bfloat16,
                               device=self.device)
        self.pools = [(_zeros(), _zeros()) for _ in range(num_layers)]
        self._hash_root = _HASH_ROOT_INT8 if quantized else _HASH_ROOT
        self._free = list(range(num_pages - 1, 0, -1))  # LIFO, page 0 kept
        # pages known to hold zeros (audit's scrubbed-means-zero check)
        self._scrubbed: set[int] = set(range(1, num_pages))
        self._ref: dict[int, int] = {}                  # page -> refcount
        self._full_index: dict[bytes, int] = {}
        self._partial_index: dict[bytes, int] = {}
        self._page_key: dict[int, tuple[str, bytes]] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._scrub_on_zero: set[int] = set()
        self.counters: dict[str, int] = {
            "prefix_lookups": 0, "prefix_hits": 0, "prefix_hit_pages": 0,
            "prefix_partial_hits": 0, "prefix_evictions": 0,
            "prefix_cow_copies": 0, "prefix_pages_registered": 0,
            "rewound_tokens": 0,
        }

    @classmethod
    def from_config(cls, config, num_pages: int, page_size: int,
                    device=None, quantized: bool = False) -> "KVCachePool":
        """Build from a LlamaConfig-shaped config (kv_cache.py:253)."""
        return cls(config.num_hidden_layers, num_pages, page_size,
                   config.num_key_value_heads, config.head_dim,
                   device=device, quantized=quantized)

    # ---- accounting ----

    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_available(self) -> int:
        return len(self._free) + len(self._lru)

    @property
    def num_in_use(self) -> int:
        return self.capacity - len(self._free) - len(self._lru)

    def utilization(self) -> float:
        return self.num_in_use / self.capacity

    def pages_for(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.page_size))

    def kv_bytes_per_token(self) -> int:
        """Device bytes one cached token position costs across all
        layers, K and V (kv_cache.py:300): int8 codes plus one fp32
        scale per kv-head row when quantized, else bf16 elements."""
        kvh, d = self.num_kv_heads, self.head_dim
        per = kvh * d + kvh * 4 if self.quantized else kvh * d * 2
        return 2 * self.num_layers * per

    def stats(self) -> dict:
        """Occupancy and format (a subset of kv_cache.py:323's keys)."""
        return {"num_pages": self.num_pages, "page_size": self.page_size,
                "capacity": self.capacity, "in_use": self.num_in_use,
                "cached": len(self._lru), "free": self.num_free,
                "utilization": self.utilization(),
                "indexed_pages": len(self._page_key),
                "kv_quant": int(self.quantized),
                "kv_bytes_per_token": self.kv_bytes_per_token()}

    # ---- alloc / free ----

    def alloc(self, n: int) -> list[int]:
        """Grab n pages, all or nothing (kv_cache.py:354). The free list
        goes first; then refcount-0 cached pages are evicted LRU-oldest,
        deregistered and scrubbed to zero."""
        if n > self.num_available:
            raise PoolExhaustedError(
                f"need {n} pages, {len(self._free)} free + "
                f"{len(self._lru)} cached (capacity {self.capacity})")
        evicted: list[int] = []
        while len(self._free) < n and self._lru:
            page, _ = self._lru.popitem(last=False)
            self._deregister(page)
            evicted.append(page)
            self._free.append(page)
        if evicted:
            self.scrub(evicted)
            self.counters["prefix_evictions"] += len(evicted)
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
            self._scrubbed.discard(p)
        return pages

    # ---- reference counting ----

    def acquire(self, pages: list[int]) -> None:
        """One more reference per page; a cached page leaves the LRU."""
        for p in pages:
            r = self._ref.get(p, 0)
            if r == 0:
                self._lru.pop(p, None)
            self._ref[p] = r + 1

    def release(self, pages: list[int]) -> None:
        """One reference fewer per page. At refcount 0 a page is
        scrubbed and freed (quarantined), stays cached (indexed), or is
        freed."""
        scrub: list[int] = []
        for p in pages:
            r = self._ref.get(p, 0) - 1
            if r > 0:
                self._ref[p] = r
                continue
            self._ref.pop(p, None)
            if p in self._scrub_on_zero:
                self._scrub_on_zero.discard(p)
                self._deregister(p)
                scrub.append(p)
                self._free.append(p)
            elif p in self._page_key:
                self._lru[p] = None
                self._lru.move_to_end(p)
            else:
                self._deregister(p)
                self._free.append(p)
        if scrub:
            self.scrub(scrub)

    def quarantine(self, pages: list[int]) -> None:
        """Pages that may hold non-finite values leave the prefix index
        now and are scrubbed when their last holder lets go."""
        todo = []
        for p in set(pages):
            self._deregister(p)
            if self._ref.get(p, 0) > 0:
                self._scrub_on_zero.add(p)
            elif p in self._lru:
                self._lru.pop(p)
                todo.append(p)
                self._free.append(p)
        if todo:
            self.scrub(todo)

    # ---- the prefix index ----

    def match_prefix(self, tokens, max_tokens: int | None = None
                     ) -> PrefixMatch:
        """Longest cached prefix of ``tokens`` (kv_cache.py:503): full
        pages by the chained hash, then the longest indexed partial
        continuation. Takes no references."""
        limit = len(tokens) if max_tokens is None else min(max_tokens,
                                                           len(tokens))
        m = PrefixMatch()
        if limit <= 0:
            return m
        ps = self.page_size
        parent = self._hash_root
        pos = 0
        while pos + ps <= limit:
            key = _page_hash(parent, tokens[pos:pos + ps])
            page = self._full_index.get(key)
            if page is None:
                break
            m.full_pages.append(page)
            parent = key
            pos += ps
        for q in range(min(limit - pos, ps - 1), 0, -1):
            page = self._partial_index.get(
                _page_hash(parent, tokens[pos:pos + q]))
            if page is not None:
                m.partial_page, m.partial_len = page, q
                break
        m.cached_tokens = pos + m.partial_len
        return m

    def count_match(self, m: PrefixMatch) -> None:
        self.counters["prefix_lookups"] += 1
        if m.hit:
            self.counters["prefix_hits"] += 1
            self.counters["prefix_hit_pages"] += (
                len(m.full_pages) + (m.partial_page is not None))
            if m.partial_page is not None:
                self.counters["prefix_partial_hits"] += 1

    def register_prefix(self, tokens, pages: list[int],
                        include_partial: bool = True) -> int:
        """Index a materialized prefix (kv_cache.py:578): page i holds
        ``tokens[i*ps:(i+1)*ps]``; the trailing partial page only with
        ``include_partial`` (its content must be frozen). First writer
        wins. Returns the number of newly registered pages."""
        ps = self.page_size
        n_full = min(len(tokens) // ps, len(pages))
        parent = self._hash_root
        registered = 0
        for i in range(n_full):
            key = _page_hash(parent, tokens[i * ps:(i + 1) * ps])
            if self._indexable(pages[i]) and key not in self._full_index:
                self._full_index[key] = pages[i]
                self._page_key[pages[i]] = ("full", key)
                registered += 1
            parent = key
        q = len(tokens) - n_full * ps
        if include_partial and 0 < q < ps and n_full < len(pages):
            key = _page_hash(parent, tokens[n_full * ps:])
            page = pages[n_full]
            if self._indexable(page) and key not in self._partial_index:
                self._partial_index[key] = page
                self._page_key[page] = ("partial", key)
                registered += 1
        self.counters["prefix_pages_registered"] += registered
        return registered

    def _indexable(self, page: int) -> bool:
        return (page not in self._page_key and self._ref.get(page, 0) > 0
                and page not in self._scrub_on_zero)

    def _deregister(self, page: int) -> None:
        kind_key = self._page_key.pop(page, None)
        if kind_key is None:
            return
        kind, key = kind_key
        index = self._full_index if kind == "full" else self._partial_index
        if index.get(key) == page:
            del index[key]

    # ---- device-side page ops (in place) ----

    @torch.no_grad()
    def cow_into(self, src: int, dst: int) -> None:
        """Copy page ``src`` into the fresh page ``dst`` (kv_cache.py:926),
        codes with their scales; the cached source is never written."""
        for pair in self.pools:
            for arr in pair:
                for t in _parts(arr):
                    t[dst].copy_(t[src])
        self.counters["prefix_cow_copies"] += 1

    @torch.no_grad()
    def scrub(self, pages: list[int]) -> None:
        """Zero whole pages (eviction, quarantine), codes and scales: a
        NaN scale left behind would poison the page's next tenant."""
        if not pages:
            return
        idx = torch.tensor(sorted(set(pages)), dtype=torch.long,
                           device=self.device)
        for pair in self.pools:
            for arr in pair:
                for t in _parts(arr):
                    t[idx] = 0
        self._scrubbed.update(int(p) for p in pages)

    @torch.no_grad()
    def rewind(self, pages: list[int], start: int, stop: int) -> None:
        """Zero cache positions ``[start, stop)`` of a block table
        (kv_cache.py:947): token-granular rollback."""
        if stop <= start:
            return
        ps = self.page_size
        pg = torch.tensor([pages[p // ps] for p in range(start, stop)],
                          dtype=torch.long, device=self.device)
        off = torch.tensor([p % ps for p in range(start, stop)],
                           dtype=torch.long, device=self.device)
        for pk, pv in self.pools:
            self._pos_zero(pk, pg, off)
            self._pos_zero(pv, pg, off)
        self.counters["rewound_tokens"] += stop - start

    @staticmethod
    def _pos_zero(arr, pages: torch.Tensor, offs: torch.Tensor) -> None:
        """Zero individual (page, offset) rows in place (kv_cache.py:972),
        codes and scales of a QuantizedKV."""
        for t in _parts(arr):
            t[pages, offs] = 0

    # ---- invariant audit ----

    def audit(self, block_tables=None) -> dict:
        """Check the host-side accounting (kv_cache.py:987): free-list
        hygiene, page conservation, refcounts (against ``block_tables``,
        one page list per live request, when given), index agreement,
        and that every free page believed scrubbed reads back all zero. Raises AssertionError listing every
        violation; returns a small accounting dict otherwise."""
        problems: list[str] = []
        free_list = self._free
        free, cached, held = set(free_list), set(self._lru), set(self._ref)
        all_pages = set(range(1, self.num_pages))
        if len(free) != len(free_list):
            problems.append("duplicate pages on the free list")
        if 0 in free or 0 in cached or 0 in held:
            problems.append("scratch page 0 entered the accounting")
        for a, b, name in ((free, cached, "free∩cached"),
                           (free, held, "free∩held"),
                           (cached, held, "cached∩held")):
            if a & b:
                problems.append(f"{name} not disjoint: {sorted(a & b)}")
        union = free | cached | held
        if union != all_pages:
            problems.append(f"page conservation broken: leaked="
                            f"{sorted(all_pages - union)} phantom="
                            f"{sorted(union - all_pages)}")
        for p, r in self._ref.items():
            if r <= 0:
                problems.append(f"page {p} held with refcount {r} <= 0")
        if block_tables is not None:
            holders: dict[int, int] = {}
            for table in block_tables:
                for p in table:
                    holders[p] = holders.get(p, 0) + 1
            for p, r in self._ref.items():
                if holders.get(p, 0) != r:
                    problems.append(f"page {p} refcount {r} != "
                                    f"{holders.get(p, 0)} block-table "
                                    f"holders")
            for p in holders:
                if p not in self._ref:
                    problems.append(f"page {p} appears in a block table "
                                    f"but holds no reference")
        for page, (kind, key) in self._page_key.items():
            index = (self._full_index if kind == "full"
                     else self._partial_index)
            if index.get(key) != page:
                problems.append(f"page {page} claims {kind} key "
                                f"{key.hex()[:8]} but the index maps it to "
                                f"{index.get(key)}")
            if page in free:
                problems.append(f"registered page {page} is on the free "
                                f"list")
        for kind, index in (("full", self._full_index),
                            ("partial", self._partial_index)):
            for key, page in index.items():
                if self._page_key.get(page) != (kind, key):
                    problems.append(f"{kind} index entry {key.hex()[:8]} -> "
                                    f"{page} has no matching back-pointer")
        for p in cached:
            if p not in self._page_key:
                problems.append(f"cached (LRU) page {p} is not registered")
        for p in self._scrub_on_zero:
            if p not in held:
                problems.append(f"scrub-on-zero page {p} has no holder")
            if p in self._page_key:
                problems.append(f"quarantined page {p} is still indexed")
        zeroed = sorted(free & self._scrubbed)
        if zeroed:
            idx = torch.tensor(zeroed, dtype=torch.long, device=self.device)
            for li, (pk, pv) in enumerate(self.pools):
                # codes and scales alike (a NaN is != 0 too)
                bad = [name for name, arr in (("k", pk), ("v", pv))
                       if any(bool((t[idx] != 0).any())
                              for t in _parts(arr))]
                if bad:
                    problems.append(f"scrubbed free page holds nonzero "
                                    f"{'/'.join(bad)} content in layer {li}")
                    break
        if problems:
            raise AssertionError("KV pool audit failed:\n- "
                                 + "\n- ".join(problems))
        return {"pages": self.num_pages - 1, "free": len(free),
                "cached": len(cached), "held": len(held)}
