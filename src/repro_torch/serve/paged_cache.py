"""Paged KV-cache block pool with a prefix cache (port of
``repro/serve/paged_cache.py:140-233`` and ``:240-519``).

Vocabulary as in the JAX package: a *page* is a physical ``block_size``-token
slab of the pooled page stores (page 0 is the reserved trash page that table
padding points at); a *block* is a request's logical ``block_size``-token run,
its *block table* mapping block i to the page holding it; a *slot* is one of
``max_requests`` per-request entries (admission needs one free); an *intern
chain* is the prefix registry's token-exact key structure.

The pool owns the page stores: one dict of (num_blocks, block_size, ...)
tensors per layer, from ``model.init_cache`` — ``{"k", "v"}`` for GQA,
MLA's latents ``{"c", "k_rope"}``. Both write new tokens into them in place
through the block tables. GQA reads its pages in place too, through the
paged kernels. MLA gathers each row's whole padded envelope of latents at
every step and layer (``pages[tables]``) and lays the chunk's latents over
it, as the JAX gather path does. Zeroing and copy-on-write treat every
store of a layer alike.

**Prefix caching** (``prefix_cache=True``): blocks are refcounted and a
registry maps *full* blocks of committed tokens to their pages, so a new
request whose prompt shares a block-aligned prefix with anything served
before reuses those pages instead of recomputing them (``alloc(...,
tokens=)`` returns how many prefix tokens were cached). Registry keys are
intern chains — interned ``(parent_prefix, block_tokens)`` ids — so lookups
are token-exact. When a request frees, registered blocks with no remaining
references park in an LRU of *cached* blocks instead of the free list;
allocation evicts from that LRU only under pool pressure. Shared blocks are
never written: writes target the block holding the request's next
position, which ``extend`` makes exclusive by copy-on-write (``fork``
shares a whole table, e.g. best-of-n; the first write to the shared tail
block copies it, one in-place page ``copy_`` per store).

The host-side accounting is the JAX pool's, line for line, and so are its
``pool_*`` registry series (``registry=``: the owning engine's, a private
one standalone), of which ``stats`` is a view. What the port leaves out:
the recurrent-state slot stores (the port serves only pure-attention LMs, so
``fork`` copies no state slot), ``CacheLayout.probe`` and the gather/scatter
oracle path. ``scatter_prefill`` writes a per-request prefill's contiguous
cache (a vlm request with its vision prefix) into the request's pages.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import trace
from repro_torch.obs.metrics import Registry

_ROOT = -1                      # parent id of a prefix chain's first block


class BlockPool:
    """Refcounted block allocator + pooled page stores for one model.

    Page 0 is reserved as trash; ``alloc``/``extend``/``fork``/``truncate``/
    ``free`` manage the host-side accounting; newly claimed pages are zeroed
    and copy-on-write copies pages, both in place on the page stores."""

    def __init__(self, model, *, num_blocks: int, block_size: int,
                 max_requests: int, dtype=torch.float32,
                 prefix_cache: bool = False, registry=None):
        if num_blocks < 2 or block_size < 1:
            raise ValueError("need num_blocks >= 2 and block_size >= 1")
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_requests = max_requests
        self.prefix_cache = prefix_cache
        self.device = model.device
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))  # 0 = trash
        self._tables: Dict[int, List[int]] = {}
        self._slots: Dict[int, int] = {}
        self._free_slots: List[int] = list(range(max_requests - 1, -1, -1))
        # --- prefix registry (all empty / inert when prefix_cache=False) ---
        self._ref: Dict[int, int] = {}          # live block -> refcount (>= 1)
        self._intern: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        self._pid_parent: Dict[int, int] = {}   # prefix id -> parent id
        self._next_pid = 0                      # ids never reused (sweeps)
        self._intern_sweep_at = max(8 * num_blocks, 256)
        self._registry: Dict[int, int] = {}     # prefix id -> block holding it
        self._block_pid: Dict[int, int] = {}    # inverse of _registry
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()           # cached refcount-0 blocks
        self._chain: Dict[int, List[int]] = {}  # req -> prefix ids committed
        reg = registry if registry is not None else Registry()
        self.registry = reg
        self._c_cow = reg.counter("pool_cow_copies_total",
                                  "copy-on-write block copies")
        self._c_evict = reg.counter("pool_prefix_evictions_total",
                                    "prefix-cache blocks LRU-evicted")
        # the callbacks hold the (never rebound) containers, not the pool:
        # a pool <-> registry cycle would leave the page stores to the
        # cyclic collector
        reg.gauge("pool_free_blocks", "blocks on the free list",
                  fn=lambda free=self._free: len(free))
        reg.gauge("pool_cached_blocks",
                  "evictable prefix-cache blocks (refcount 0)",
                  fn=lambda lru=self._lru: len(lru))
        self.pages = model.init_cache(num_blocks, block_size, dtype=dtype)

    # ------------------------------------------------------------ accounting
    @property
    def stats(self) -> Dict[str, int]:
        """The JAX pool's ``stats`` dict, read from the registry series."""
        return {"cow_copies": int(self._c_cow.value),
                "evictions": int(self._c_evict.value)}

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1             # page 0 reserved as trash

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Registered blocks no live request references (evictable)."""
        return len(self._lru)

    @property
    def available_blocks(self) -> int:
        """Blocks an allocation may claim: truly free + LRU-evictable."""
        return len(self._free) + len(self._lru)

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    def ref_count(self, block: int) -> int:
        return self._ref.get(block, 0)

    def cached_block_ids(self) -> Tuple[int, ...]:
        return tuple(self._lru)

    def free_block_ids(self) -> Tuple[int, ...]:
        return tuple(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.block_size)

    # ------------------------------------------------------- block lifecycle
    def _incref(self, block: int) -> None:
        if self._ref.get(block, 0) == 0:
            self._lru.pop(block, None)       # cached -> live again
        self._ref[block] = self._ref.get(block, 0) + 1

    def _decref(self, block: int) -> None:
        n = self._ref[block] - 1
        if n < 0:
            raise RuntimeError(f"refcount underflow on block {block}")
        if n:
            self._ref[block] = n
            return
        del self._ref[block]
        if block in self._block_pid:         # registered: park in the LRU
            self._lru[block] = None
        else:
            self._free.append(block)

    def _deregister(self, block: int) -> None:
        pid = self._block_pid.pop(block)
        del self._registry[pid]

    def _take_block(self) -> int:
        """Claim a block: the free list first, then LRU-evict a cached one."""
        if self._free:
            return self._free.pop()
        if self._lru:
            block, _ = self._lru.popitem(last=False)     # least recently freed
            self._deregister(block)
            self._c_evict.inc()
            trace.instant("pool.prefix_evict", block=block)
            return block
        raise MemoryError("block pool exhausted")

    def _claim(self, n: int) -> List[int]:
        """``n`` fresh blocks, zeroed, each with refcount 1."""
        blks = [self._take_block() for _ in range(n)]
        self._zero(blks)
        for b in blks:
            self._ref[b] = 1
        return blks

    def _zero(self, blks: List[int]) -> None:
        # reused pages must read as zeros, not stale KV of a freed request
        if not blks:
            return
        ids = torch.as_tensor(blks, dtype=torch.long, device=self.device)
        for layer in self.pages:
            for store in layer.values():
                store.index_fill_(0, ids, 0)

    # ------------------------------------------------------- prefix registry
    def _lookup(self, tokens) -> Tuple[List[int], List[int]]:
        """Longest chain of registered full blocks matching ``tokens``
        exactly, capped so at least one token is left to prefill."""
        bs = self.block_size
        max_blocks = (len(tokens) - 1) // bs
        parent, blocks, pids = _ROOT, [], []
        for i in range(max_blocks):
            key = (parent, tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
            pid = self._intern.get(key)
            if pid is None or pid not in self._registry:
                break
            blocks.append(self._registry[pid])
            pids.append(pid)
            parent = pid
        return blocks, pids

    def _sweep_intern(self) -> None:
        """Bound the intern table: drop prefix ids that are neither in a
        live request's chain, nor registered, nor an ancestor of either
        (ancestors keep evicted-then-recommitted chains revivable under
        their original ids)."""
        keep = set(self._registry)
        for chain in self._chain.values():
            keep.update(chain)
        for pid in list(keep):
            p = self._pid_parent.get(pid, _ROOT)
            while p != _ROOT and p not in keep:
                keep.add(p)
                p = self._pid_parent.get(p, _ROOT)
        for key, pid in list(self._intern.items()):
            if pid not in keep:
                del self._intern[key]
                self._pid_parent.pop(pid, None)
        # re-arm so a legitimately large working set doesn't sweep per commit
        self._intern_sweep_at = max(2 * len(self._intern),
                                    8 * self.num_blocks, 256)

    def probe_prefix(self, tokens) -> int:
        """Cached-prefix tokens a lookup would hit right now (no acquire)."""
        if not self.prefix_cache or tokens is None:
            return 0
        return len(self._lookup(tokens)[0]) * self.block_size

    def commit(self, req_id: int, tokens) -> None:
        """Register the request's newly completed full blocks of ``tokens``
        (its committed prompt+generated stream) in the prefix registry."""
        if not self.prefix_cache or req_id not in self._tables:
            return
        bs = self.block_size
        table = self._tables[req_id]
        chain = self._chain.setdefault(req_id, [])
        n_full = min(len(tokens) // bs, len(table))
        while len(chain) < n_full:
            i = len(chain)
            parent = chain[-1] if chain else _ROOT
            key = (parent, tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
            pid = self._intern.get(key)
            if pid is None:
                pid = self._next_pid
                self._next_pid += 1
                self._intern[key] = pid
                self._pid_parent[pid] = parent
                if len(self._intern) > self._intern_sweep_at:
                    self._sweep_intern()
            chain.append(pid)
            # first committer wins; duplicates stay unregistered and return
            # to the free list when their request ends
            if pid not in self._registry and table[i] not in self._block_pid:
                self._registry[pid] = table[i]
                self._block_pid[table[i]] = pid

    # ------------------------------------------------------- request tables
    def alloc(self, req_id: int, n_tokens: int, tokens=None) -> int:
        """Reserve blocks covering ``n_tokens`` and a slot.

        With ``prefix_cache`` and the request's token stream in ``tokens``,
        the longest registered block-aligned prefix is reused (refcounted)
        instead of freshly allocated. Returns the number of cached prefix
        tokens (0 without caching); the caller prefills only the suffix."""
        if req_id in self._tables:
            raise ValueError(f"request {req_id} already allocated")
        hit_blocks: List[int] = []
        hit_pids: List[int] = []
        if self.prefix_cache and tokens is not None and len(tokens) > 1:
            hit_blocks, hit_pids = self._lookup(tokens)
        need = self.blocks_for(n_tokens) - len(hit_blocks)
        for b in hit_blocks:                 # pin hits before any eviction
            self._incref(b)
        if need > self.available_blocks or not self._free_slots:
            for b in hit_blocks:
                self._decref(b)
            raise MemoryError(
                f"pool exhausted: need {need} blocks / 1 slot, have "
                f"{self.available_blocks} blocks / "
                f"{len(self._free_slots)} slots")
        self._tables[req_id] = hit_blocks + self._claim(need)
        self._slots[req_id] = self._free_slots.pop()
        self._chain[req_id] = list(hit_pids)
        return len(hit_blocks) * self.block_size

    def extend(self, req_id: int, n_tokens: int, *,
               write_start: Optional[int] = None) -> None:
        """Grow the request's table to cover ``n_tokens`` total tokens and
        make the written span exclusively owned (copy-on-write if shared
        with another request). By default only the block holding token
        ``n_tokens - 1`` is made writable (single-token decode);
        ``write_start`` widens that to every block covering
        ``[write_start, n_tokens - 1]``."""
        table = self._tables[req_id]
        need = self.blocks_for(n_tokens) - len(table)
        if need > self.available_blocks:
            raise MemoryError(f"pool exhausted extending request {req_id}")
        if need > 0:
            table.extend(self._claim(need))
        lo = n_tokens - 1 if write_start is None else \
            max(0, min(write_start, n_tokens - 1))
        for i in range(lo // self.block_size,
                       (n_tokens - 1) // self.block_size + 1):
            self._ensure_writable(req_id, i * self.block_size
                                  if i * self.block_size > lo else lo)

    def truncate(self, req_id: int, n_tokens: int) -> None:
        """Roll back the request's table to cover only ``n_tokens`` tokens,
        releasing blocks past that point (a registered or fork-shared block
        is decref'd, not clobbered)."""
        table = self._tables[req_id]
        keep = self.blocks_for(n_tokens)
        while len(table) > keep:
            self._decref(table.pop())
        chain = self._chain.get(req_id)
        if chain is not None and len(chain) > len(table):
            del chain[len(table):]

    def _ensure_writable(self, req_id: int, pos: int) -> None:
        """Copy-on-write: the block containing ``pos`` must have refcount 1.
        Only uncommitted (partial) blocks are ever written, so the registry
        is never invalidated by a write."""
        table = self._tables[req_id]
        i = pos // self.block_size
        blk = table[i]
        if self._ref[blk] <= 1:
            return
        with trace.span("pool.cow_copy", req_id=req_id, block=blk):
            new = self._take_block()
            self._copy_page(blk, new)
            self._ref[new] = 1
            self._decref(blk)
            table[i] = new
            self._c_cow.inc()

    def _copy_page(self, src: int, dst: int) -> None:
        """Page ``src`` into page ``dst`` in every store of every layer (a
        slice-to-slice ``copy_``: ``index_copy_`` refuses a source that
        shares the store's memory)."""
        for layer in self.pages:
            for store in layer.values():
                store[dst].copy_(store[src])

    def fork(self, parent_id: int, child_id: int) -> None:
        """Share the parent's whole table with ``child_id`` (copy-on-write:
        the first divergent write mid-block copies that block). The port's
        models keep no recurrent state, so there is no state slot to copy."""
        if child_id in self._tables:
            raise ValueError(f"request {child_id} already allocated")
        if not self._free_slots:
            raise MemoryError("no free slot to fork into")
        table = list(self._tables[parent_id])
        for b in table:
            self._incref(b)
        self._tables[child_id] = table
        self._slots[child_id] = self._free_slots.pop()
        self._chain[child_id] = list(self._chain.get(parent_id, []))

    def free(self, req_id: int) -> None:
        for b in self._tables.pop(req_id):
            self._decref(b)
        self._free_slots.append(self._slots.pop(req_id))
        self._chain.pop(req_id, None)

    def scatter_prefill(self, req_ids, cache, n_tokens: int) -> None:
        """Write positions [0, n_tokens) of a freshly prefilled contiguous
        cache (``LM.init_contiguous_cache``; row i for ``req_ids[i]``) into
        the rows' pages, every store of every layer, with ``index_put_``
        (``repro/serve/paged_cache.py:573-581``; the rest of the last page
        stays as the claim zeroed it)."""
        p = torch.arange(n_tokens, device=self.device)
        for i, rid in enumerate(req_ids):
            table = torch.as_tensor(self._tables[rid], device=self.device)
            idx = (table[p // self.block_size], p % self.block_size)
            for stores, layer in zip(self.pages, cache):
                for name, store in stores.items():
                    store.index_put_(idx, layer[name][i, :n_tokens].to(
                        store.dtype))

    def table(self, req_id: int) -> List[int]:
        return list(self._tables[req_id])

    def max_table_blocks(self, req_ids) -> int:
        return max((len(self._tables[r]) for r in req_ids), default=0)

    def padded_tables(self, req_ids, *, rows: Optional[int] = None,
                      blocks: Optional[int] = None) -> np.ndarray:
        """(rows, blocks) int32 block tables on the host (a step packs them
        with its other inputs into one copy to the device). Ragged rows are
        padded with the trash page; extra rows (batch-bucket padding) are
        all-trash."""
        nb = self.max_table_blocks(req_ids)
        nb = max(blocks or nb, nb)
        b = max(rows or len(req_ids), len(req_ids))
        out = np.zeros((b, nb), np.int32)
        for i, r in enumerate(req_ids):
            t = self._tables[r]
            out[i, :len(t)] = t
        return out
