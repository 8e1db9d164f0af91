"""Paged KV-cache block pool (port of ``repro/serve/paged_cache.py:140-233``
and ``:347-519``).

Vocabulary as in the JAX package: a *page* is a physical ``block_size``-token
slab of the pooled page stores (page 0 is the reserved trash page that table
padding points at); a *block* is a request's logical ``block_size``-token run,
its *block table* mapping block i to the page holding it; a *slot* is one of
``max_requests`` per-request entries (admission needs one free).

The pool owns the page stores: one ``{"k", "v"}`` pair of
(num_blocks, block_size, Hkv, hd) tensors per layer, from
``model.init_cache``. The paged attention path writes new tokens into them
in place and reads them through the block tables, so there is no gather or
scatter of the cache. The prefix registry, copy-on-write ``fork``,
``truncate``, the recurrent-state slot stores, ``CacheLayout.probe`` and the
gather path wait for later slices.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


class BlockPool:
    """Free-list block allocator + pooled page stores for one model.

    Page 0 is reserved as trash; ``alloc``/``extend``/``free`` manage the
    host-side accounting, and newly claimed pages are zeroed."""

    def __init__(self, model, *, num_blocks: int, block_size: int,
                 max_requests: int, dtype=torch.float32):
        if num_blocks < 2 or block_size < 1:
            raise ValueError("need num_blocks >= 2 and block_size >= 1")
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_requests = max_requests
        self.device = model.device
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))  # 0 = trash
        self._tables: Dict[int, List[int]] = {}
        self._slots: Dict[int, int] = {}
        self._free_slots: List[int] = list(range(max_requests - 1, -1, -1))
        self.pages = model.init_cache(num_blocks, block_size, dtype=dtype)

    # ------------------------------------------------------------ accounting
    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1             # page 0 reserved as trash

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.block_size)

    # ------------------------------------------------------- block lifecycle
    def _take(self, n: int) -> List[int]:
        blks = [self._free.pop() for _ in range(n)]
        self._zero(blks)
        return blks

    def _zero(self, blks: List[int]) -> None:
        # reused pages must read as zeros, not stale KV of a freed request
        if not blks:
            return
        ids = torch.as_tensor(blks, dtype=torch.long, device=self.device)
        for layer in self.pages:
            for store in layer.values():
                store.index_fill_(0, ids, 0)

    def alloc(self, req_id: int, n_tokens: int) -> int:
        """Reserve blocks covering ``n_tokens`` and a slot. Returns the
        number of cached prefix tokens, always 0 without a prefix cache."""
        if req_id in self._tables:
            raise ValueError(f"request {req_id} already allocated")
        need = self.blocks_for(n_tokens)
        if need > len(self._free) or not self._free_slots:
            raise MemoryError(
                f"pool exhausted: need {need} blocks / 1 slot, have "
                f"{len(self._free)} blocks / "
                f"{len(self._free_slots)} slots")
        self._tables[req_id] = self._take(need)
        self._slots[req_id] = self._free_slots.pop()
        return 0

    def extend(self, req_id: int, n_tokens: int) -> None:
        """Grow the request's table to cover ``n_tokens`` total tokens."""
        table = self._tables[req_id]
        need = self.blocks_for(n_tokens) - len(table)
        if need > len(self._free):
            raise MemoryError(f"pool exhausted extending request {req_id}")
        if need > 0:
            table.extend(self._take(need))

    def free(self, req_id: int) -> None:
        self._free.extend(self._tables.pop(req_id))
        self._free_slots.append(self._slots.pop(req_id))

    def table(self, req_id: int) -> List[int]:
        return list(self._tables[req_id])

    def max_table_blocks(self, req_ids) -> int:
        return max((len(self._tables[r]) for r in req_ids), default=0)

    def padded_tables(self, req_ids, *, rows: Optional[int] = None,
                      blocks: Optional[int] = None) -> torch.Tensor:
        """(rows, blocks) int32 block tables on the pool's device. Ragged
        rows are padded with the trash page; extra rows (batch-bucket
        padding) are all-trash."""
        nb = self.max_table_blocks(req_ids)
        nb = max(blocks or nb, nb)
        b = max(rows or len(req_ids), len(req_ids))
        out = np.zeros((b, nb), np.int32)
        for i, r in enumerate(req_ids):
            t = self._tables[r]
            out[i, :len(t)] = t
        return torch.as_tensor(out, device=self.device)
