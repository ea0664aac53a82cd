"""Paged KV-cache bookkeeping — the port's own copy of
``ray_tpu/llm/cache.py`` (which imports ``jax.numpy``).

A refcounted free-list page allocator over the device-resident page
pool, plus a hash-indexed prefix cache over full KV pages (vLLM-style
automatic prefix caching). Page 0 is reserved as the scratch target for
inactive batch slots and padding tokens.

Prefix cache design (as in the JAX package):
  - a prompt's FULL token blocks (page_size tokens each) are keyed by a
    chain hash (block i's key folds in block i-1's), seeded with the KV
    storage scheme, so only page-aligned prefixes under the same scheme
    are shared;
  - a cached page referenced by a live sequence is read-only by
    refcount: sequences write below their prompt length only through
    copy-on-write;
  - pages whose ONLY reference is the cache's are evictable, LRU order.
"""

from __future__ import annotations

import collections
import logging
import os
from typing import Dict, List, Optional, Tuple

import torch

from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.ops.int8 import KV_SCALE_DTYPE

logger = logging.getLogger(__name__)

SCRATCH_PAGE = 0


class DoubleFreeError(RuntimeError):
    """A page was freed more times than it was referenced."""


class PageAllocator:
    """Refcounted page allocator.

    ``alloc`` hands out pages at refcount 1; ``incref`` adds sharers;
    ``free`` DECREMENTS and only returns the page to the free list when
    the count hits zero. Freeing an unreferenced page is a double free:
    raise under pytest, log-and-skip in production (``strict_free``
    overrides the default).
    """

    def __init__(self, total_pages: int,
                 strict_free: Optional[bool] = None):
        if total_pages < 2:
            raise ValueError("need at least 2 pages (one is scratch)")
        self._free: List[int] = list(range(1, total_pages))
        self._ref: Dict[int, int] = {}
        self.total_pages = total_pages
        if strict_free is None:
            strict_free = bool(os.environ.get("PYTEST_CURRENT_TEST"))
        self.strict_free = strict_free

    @property
    def num_free(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        out, self._free = self._free[:n], self._free[n:]
        for p in out:
            self._ref[p] = 1
        return out

    def incref(self, pages: List[int]) -> None:
        for p in pages:
            if p == SCRATCH_PAGE:
                continue
            if self._ref.get(p, 0) <= 0:
                raise ValueError(f"incref of unallocated page {p}")
            self._ref[p] += 1

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p == SCRATCH_PAGE:
                continue
            ref = self._ref.get(p, 0)
            if ref <= 0:
                if self.strict_free:
                    raise DoubleFreeError(f"double free of page {p}")
                logger.warning("double free of page %d ignored", p)
                continue
            if ref == 1:
                del self._ref[p]
                self._free.append(p)
            else:
                self._ref[p] = ref - 1


def hash_token_blocks(prompt: List[int], page_size: int,
                      kv_tag: str = "") -> List[int]:
    """Chain hashes of the prompt's FULL token blocks, seeded with
    ``kv_tag`` (the KV storage scheme): equal hashes mean equal
    page-aligned prefixes stored the same way."""
    out: List[int] = []
    h = hash((0x9E3779B9, kv_tag))
    for i in range(len(prompt) // page_size):
        block = tuple(prompt[i * page_size:(i + 1) * page_size])
        h = hash((h, block))
        out.append(h)
    return out


class PrefixCache:
    """Hash-indexed table of full KV pages, with LRU eviction of pages
    no live sequence references. The cache holds ONE allocator reference
    per published page; ``match`` increfs hit pages for the caller."""

    def __init__(self, allocator: PageAllocator, page_size: int,
                 kv_tag: str = ""):
        self.allocator = allocator
        self.page_size = page_size
        self.kv_tag = kv_tag
        self._pages: Dict[int, int] = {}          # block hash -> page id
        self._hash_of: Dict[int, int] = {}        # page id -> block hash
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.evictions = 0

    @property
    def num_cached(self) -> int:
        return len(self._pages)

    @property
    def num_evictable(self) -> int:
        return len(self._lru)

    def match(self, prompt: List[int]) -> Tuple[List[int], int, bool]:
        """Longest cached page-aligned prefix of ``prompt``:
        ``(pages, matched_tokens, cow_needed)``, pages INCREF'd.
        ``matched_tokens`` is capped at ``len(prompt) - 1``; when that cap
        cuts into the last matched page, ``cow_needed`` is True."""
        self.lookups += 1
        pages: List[int] = []
        for h in hash_token_blocks(prompt, self.page_size, self.kv_tag):
            p = self._pages.get(h)
            if p is None:
                break
            pages.append(p)
        if not pages:
            return [], 0, False
        matched = len(pages) * self.page_size
        cow = False
        if matched >= len(prompt):
            matched = len(prompt) - 1
            cow = True
        self.hits += 1
        self.hit_tokens += matched
        for p in pages:
            self._lru.pop(p, None)   # referenced again: not evictable
        self.allocator.incref(pages)
        return pages, matched, cow

    def register(self, prompt: List[int], pages: List[int]) -> None:
        """Publish a fully-prefilled prompt's full pages under their chain
        hashes (one cache reference per newly published page)."""
        for i, h in enumerate(hash_token_blocks(prompt, self.page_size,
                                                self.kv_tag)):
            if i >= len(pages):
                break
            if h in self._pages:
                continue
            p = pages[i]
            if p in self._hash_of:
                continue
            self._pages[h] = p
            self._hash_of[p] = h
            self.allocator.incref([p])

    def note_release(self, pages: List[int]) -> None:
        """After ``allocator.free``: cached pages whose only reference is
        the cache's become LRU-evictable."""
        for p in pages:
            if p in self._hash_of and self.allocator.refcount(p) == 1:
                self._lru[p] = None
                self._lru.move_to_end(p)

    def evict(self, n: int) -> int:
        """Drop up to ``n`` least-recently-used unreferenced cached pages
        back to the allocator; returns how many were freed."""
        freed = 0
        while freed < n and self._lru:
            p, _ = self._lru.popitem(last=False)
            h = self._hash_of.pop(p)
            self._pages.pop(h, None)
            self.allocator.free([p])
            freed += 1
            self.evictions += 1
        return freed


def make_kv_cache(cfg: LlamaConfig, total_pages: int, page_size: int,
                  dtype=None, kv_dtype: Optional[str] = None,
                  device="cuda", devices=None):
    """Paged KV pool as a dict of stacked tensors on ``device``.

    {"k", "v"}: [n_layers, total_pages, Hkv, page_size, D]; with
    ``kv_dtype="int8"`` the pools are int8 and {"k_scale", "v_scale"}
    [n_layers, total_pages, Hkv, page_size] bf16 dequant scales ride
    alongside. ``kv_dtype`` in {None/"model" (cfg dtype), "int8"}.

    With ``devices`` (a tensor-parallel engine's shards, ``llm/tp.py``)
    a list of such dicts, one per shard on its device, each holding
    Hkv / len(devices) heads of every page in tensors of its own.
    """
    if kv_dtype not in (None, "model", "int8"):
        raise ValueError(f"kv_dtype must be 'model' or 'int8', "
                         f"got {kv_dtype!r}")
    if devices is not None:
        heads = cfg.n_kv_heads // len(devices)
        return [_pool(cfg, total_pages, page_size, heads, dtype, kv_dtype,
                      d) for d in devices]
    return _pool(cfg, total_pages, page_size, cfg.n_kv_heads, dtype,
                 kv_dtype, device)


def _pool(cfg, total_pages, page_size, heads, dtype, kv_dtype, device):
    shape = (cfg.n_layers, total_pages, heads, page_size, cfg.head_dim)
    if kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=KV_SCALE_DTYPE,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=KV_SCALE_DTYPE,
                                       device=device)}
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_tag(cfg: LlamaConfig, kv_dtype: Optional[str]) -> str:
    """The PrefixCache hash seed for a pool config, the same strings as
    the JAX package ("bfloat16", "float32", "int8")."""
    if kv_dtype == "int8":
        return "int8"
    return str(cfg.dtype).removeprefix("torch.")


class SequenceState:
    """Per-request paging state."""

    def __init__(self, request_id: str, prompt: List[int],
                 max_new_tokens: int, enqueue_ts: float = 0.0):
        self.request_id = request_id
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.generated: List[int] = []
        self.pages: List[int] = []
        self.slot: Optional[int] = None     # decode batch slot
        self.done = False
        self.enqueue_ts = enqueue_ts        # admission age (HOL fairness)
        # chunked-prefill progress: prompt tokens whose KV is in pages;
        # prefilling=True keeps the sequence out of the decode batch
        self.num_computed = 0
        self.cached_tokens = 0              # served from the prefix cache
        self.prefilling = False
        # recompute preemption: generated tokens fold into the prompt for
        # the re-prefill; n_prompt marks the original boundary
        self.n_prompt = len(self.prompt)
        self.preempt_count = 0
        self.restore_generated: List[int] = []
        self.record = None                  # flight-recorder RequestRecord

    @property
    def num_tokens(self) -> int:
        return len(self.prompt) + len(self.generated)

    def pages_needed(self, page_size: int, headroom: int = 0) -> int:
        return -(-(self.num_tokens + headroom) // page_size)
