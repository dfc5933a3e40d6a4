"""Paged decode attention: decode reads K/V straight from the block pool.

Counterpart of ``repro/serve/paged_attn.py``.  The decode PE's pool row IS
the decode-side KV cache, indexed per slot through block tables:

- **assemble** — gathers every slot's table-mapped payload rows from the
  decode PE's pool row with the K3 kernel (``kernels/ishmem_device.py``;
  unmapped table entries read zeros) and rebuilds each paged leaf
  ``(reps, B, W, nkv, hd)`` exactly as a dense cache would hold it, so the
  decode step is bitwise the dense one;
- **writeback** — stores each active slot's freshly projected K/V token
  into its owning block (a local store on the decode PE); a ring wraps at
  ``pos % W``, and its ``kpos`` stays with the slot bank's tail leaves;
- **attach** zeroes a request's never-migrated growth blocks at admission;
- **copy-on-write** — a slot whose table maps blocks shared with another
  request never writes them: the first write into one copies its payload
  into the slot's reserved private block (``rma.put``, so K1 on the card),
  remaps the table entry and drops the shared reference, so shared rows
  stay pristine at every PE;
- **detach_keep** disarms a preempted slot but keeps its un-fired
  reserves, which travel with the request and re-arm at resume.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import rma
from repro_torch.core.heap import TORCH_DTYPES
from repro_torch.kernels import ishmem_device
from repro_torch.serve.kvpool import KVPool


@dataclasses.dataclass
class _SlotMap:
    """Host-side per-slot decode state: which request, which COW targets."""
    req_id: int
    cow: Dict[int, int]          # table index -> reserved private block id


class PagedDecodeView:
    """Per-decode-PE window onto the pool: block tables and copy-on-write
    bookkeeping.  Control plane only; the data plane is the decode PE's
    pool row."""

    def __init__(self, pool: KVPool, pe: int, num_slots: int):
        self.pool = pool
        self.pe = pe
        self.num_slots = num_slots
        self.slots: Dict[int, _SlotMap] = {}
        self.cow_copies = 0

    # ------------------------------------------------------------ lifecycle
    def attach(self, heap, slot: int, req_id: int, *, fresh_ids: List[int],
               cow: Optional[Dict[int, int]] = None):
        """Arm a slot at admission and zero its growth blocks on this PE's
        row, so an assembled leaf is byte-identical to a virgin dense
        cache.  ``cow`` maps the table indices decode will write whose
        blocks are shared to their reserved private targets."""
        self.slots[slot] = _SlotMap(req_id=req_id, cow=dict(cow or {}))
        for bid in fresh_ids:
            ptr = self.pool.block_ptr(bid)
            heap = heap.write(ptr, self.pe, torch.zeros(
                ptr.size, dtype=TORCH_DTYPES[ptr.dtype], device=heap.device))
        return heap

    def detach(self, slot: int) -> int:
        """Disarm a finished slot and release its COW reserves that never
        fired (the table's references are the scheduler's to release).
        Returns the number of reserve blocks freed."""
        sm = self.slots.pop(slot, None)
        if sm is None:
            return 0
        return self.pool.release_ids(list(sm.cow.values()))

    def detach_keep(self, slot: int) -> Dict[int, int]:
        """Disarm a preempted slot WITHOUT releasing its un-fired COW
        reserves: the request decodes again later, so the reserves (and
        their references) travel with it and re-arm at resume through
        ``attach(cow=...)``.  Returns that cow map."""
        sm = self.slots.pop(slot, None)
        return {} if sm is None else dict(sm.cow)

    def table_of(self, slot: int) -> List[int]:
        return self.pool.blocks_of(self.slots[slot].req_id)

    def table(self) -> np.ndarray:
        """(num_slots, blocks_per_request) int32 block table; unmapped
        entries hold ``num_blocks`` (K3's zero row)."""
        nb = self.pool.layout.blocks_per_request
        table = np.full((self.num_slots, nb), self.pool.num_blocks, np.int32)
        for s, sm in self.slots.items():
            ids = self.pool.blocks_of(sm.req_id)
            table[s, :len(ids)] = ids
        return table

    # ------------------------------------------------------------- assemble
    def assemble(self, heap, cache):
        """Rebuild every paged leaf of the batched decode cache from the
        pool row through the slot block tables.  Non-paged leaves pass
        through from ``cache``."""
        lay = self.pool.layout
        if not lay.paged:
            return cache
        data = heap.read(self.pool.data, self.pe).reshape(
            self.pool.num_blocks, lay.block_words)
        # a host table: checked on the host, one non-blocking copy
        pay = ishmem_device.paged_gather(data, self.table())  # (B, nb, words)
        offs = ishmem_device._leaf_offsets(lay)
        cache = dict(cache)
        blocks = [dict(e) for e in cache["blocks"]]
        for pl in lay.paged:
            leaf = ishmem_device._extract_leaf(
                pay, lay, pl, self.num_slots, offs[(pl.unit_idx, pl.key)])
            ref = blocks[pl.unit_idx][pl.key]
            blocks[pl.unit_idx][pl.key] = leaf.to(ref.dtype)
        cache["blocks"] = blocks
        return cache

    def strip(self, cache):
        """Zero the paged leaves of a post-step cache: the pool row is the
        single source of truth, and the slot bank never re-grows a dense
        copy."""
        lay = self.pool.layout
        cache = dict(cache)
        blocks = [dict(e) for e in cache["blocks"]]
        for pl in lay.paged:
            blocks[pl.unit_idx][pl.key] = torch.zeros_like(
                blocks[pl.unit_idx][pl.key])
        cache["blocks"] = blocks
        return cache

    # ------------------------------------------------------------ writeback
    def writeback(self, ctx, heap, new_cache, pos, active):
        """Store each active slot's just-written K/V token column into its
        owning pool block.  ``pos`` is the PRE-step cursor.  Copy-on-write
        fires here, before the first store into a shared block."""
        lay = self.pool.layout
        if not lay.paged:
            return heap
        T, W = lay.block_tokens, lay.cache_width
        pos = pos.tolist()
        for s in range(self.num_slots):
            if not active[s] or s not in self.slots:
                continue
            idx = pos[s] % W if lay.ring else pos[s]
            if idx >= W:        # dense overrun: the dense write drops it
                continue
            b, t = divmod(idx, T)
            heap = self._cow(ctx, heap, s, b)
            ptr = self.pool.block_ptr(self.table_of(s)[b])
            payload = heap.read(ptr, self.pe)
            parts = []
            off = 0
            for pl in lay.paged:
                n = pl.words_per_token * T
                sl = payload[off:off + n].reshape(pl.reps, T, pl.nkv,
                                                  pl.hd).clone()
                col = new_cache["blocks"][pl.unit_idx][pl.key][:, s, idx]
                sl[:, t] = col.to(sl.dtype)
                parts.append(sl.reshape(-1))
                off += n
            heap = heap.write(ptr, self.pe, torch.cat(parts))
        return heap

    def _cow(self, ctx, heap, slot: int, b: int):
        """First write into table index ``b`` of a shared block: copy its
        payload into the reserved private block (a local put on this PE),
        remap the table, drop the shared reference."""
        sm = self.slots[slot]
        priv = sm.cow.pop(b, None)
        if priv is None:
            return heap
        src = self.pool.blocks_of(sm.req_id)[b]
        payload = heap.read(self.pool.block_ptr(src), self.pe)
        heap = rma.put(ctx, heap, self.pool.block_ptr(priv), payload,
                       self.pe, src_pe=self.pe)
        self.pool.remap(sm.req_id, b, priv)
        self.cow_copies += 1
        return heap
