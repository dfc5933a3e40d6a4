"""Paged decode attention: decode reads K/V straight from the block pool.

Counterpart of ``repro/serve/paged_attn.py``.  The decode PE's pool row IS
the decode-side KV cache, indexed per slot through block tables.  A step's
**gather** (:meth:`PagedDecodeView.gather`) takes every slot's
table-mapped blocks from the decode PE's pool row with the K3 kernel
(``kernels/ishmem_device.py``; unmapped table entries read zeros) in one
of two forms, which the view picks (:meth:`PagedDecodeView.form`),
records for its writeback and counts (:class:`PagedDecodeTally`):

- **payload form**, where the layout allows it (not a ring, every paged
  leaf a bf16 ``k`` or ``v``, the cache width a whole number of blocks):
  the gathered blocks are copied once into a persistent ``(B, nb,
  block_words)`` buffer (:func:`payload_buffer`), which the engine's
  captured decode graph reads; each layer's K and V are
  ``KVLayout.leaf_view`` views of it, where decode attention
  (``kernels/decode_attn.py``) stores the new column and attends in place;
- **leaf form** otherwise: **assemble** rebuilds each paged leaf ``(reps,
  B, W, nkv, hd)`` exactly as a dense cache would hold it, so the decode
  step is bitwise the dense one, in persistent buffers
  (:func:`leaf_buffers`).

Either way the slot bank holds no paged leaf (:meth:`PagedDecodeView.
unpaged`).

- **writeback** — stores each active slot's freshly projected K/V token
  into its owning block (a local store on the decode PE): in payload form
  the slot's gathered block, which holds it already, in one store; in leaf
  form the block reread with the token's column set; a ring wraps at
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
from repro_torch.serve.kvpool import KVLayout, KVPool


@dataclasses.dataclass
class _SlotMap:
    """Host-side per-slot decode state: which request, which COW targets."""
    req_id: int
    cow: Dict[int, int]          # table index -> reserved private block id


@dataclasses.dataclass
class PagedDecodeTally:
    """How the paged decode step read the pool: steps in payload form, and
    steps in leaf form by the reason :meth:`PagedDecodeView.form` gave."""
    payload_steps: int = 0
    leaf_steps: Dict[str, int] = dataclasses.field(default_factory=dict)

    def count(self, reason: Optional[str]) -> None:
        if reason is None:
            self.payload_steps += 1
        else:
            self.leaf_steps[reason] = self.leaf_steps.get(reason, 0) + 1

    @classmethod
    def total(cls, tallies) -> "PagedDecodeTally":
        """The sum of ``tallies`` (the decode PEs' views')."""
        out = cls()
        for t in tallies:
            out.payload_steps += t.payload_steps
            for reason, n in t.leaf_steps.items():
                out.leaf_steps[reason] = out.leaf_steps.get(reason, 0) + n
        return out

    def counter(self) -> dict:
        """The tally as a trace counter's numbers."""
        out = {"payload_steps": self.payload_steps,
               "leaf_steps": sum(self.leaf_steps.values())}
        out.update({f"leaf_{r}": n for r, n in self.leaf_steps.items()})
        return out


def leaf_buffers(layout: KVLayout, num_slots: int, device) -> dict:
    """One dense buffer ``(reps, num_slots, nb * T, nkv, hd)`` a paged leaf,
    keyed ``(unit index, key)``, for ``assemble`` to rebuild the leaves in.
    Every word is written by each assemble, so they start empty."""
    nbt = layout.blocks_per_request * layout.block_tokens
    dtype = TORCH_DTYPES[layout.kv_dtype]
    return {pl.path: torch.empty(
        (pl.reps, num_slots, nbt, pl.nkv, pl.hd), dtype=dtype, device=device)
        for pl in layout.paged}


def payload_buffer(layout: KVLayout, num_slots: int, device) -> torch.Tensor:
    """The ``(num_slots, nb, block_words)`` buffer the payload form copies
    the gathered blocks into; every word is written each step."""
    return torch.empty((num_slots, layout.blocks_per_request,
                        layout.block_words),
                       dtype=TORCH_DTYPES[layout.kv_dtype], device=device)


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
        self.forms = PagedDecodeTally()   # the steps gather took, by form
        self.payload = None       # the payload form's buffer, None in leaf

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

    def form(self) -> Optional[str]:
        """None where the step takes the payload form; else why it takes
        the leaf form: ``ring``, or ``layout`` (no paged leaf, a paged leaf
        other than ``k`` / ``v``, a cache other than bf16, or a width that
        is not a whole number of blocks)."""
        lay = self.pool.layout
        if lay.ring:
            return "ring"
        if not lay.paged or lay.kv_dtype != "bfloat16" or \
                any(pl.key not in ("k", "v") for pl in lay.paged) or \
                lay.cache_width != lay.blocks_per_request * lay.block_tokens:
            return "layout"
        return None

    # --------------------------------------------------------------- gather
    def _k3(self, heap):
        """K3 over this PE's pool row: ``(num_slots, nb, block_words)``."""
        lay = self.pool.layout
        data = heap.read(self.pool.data, self.pe).reshape(
            self.pool.num_blocks, lay.block_words)
        # a host table: checked on the host, one non-blocking copy
        return ishmem_device.paged_gather(data, self.table())

    def gather(self, heap, cache, buffers=None):
        """The step's batched decode cache in the form :meth:`form` gives,
        counted on :attr:`forms` and recorded for :meth:`writeback`.
        Payload form: the gathered blocks copied into the payload buffer
        and each paged leaf a ``(reps, B, nb, T, nkv, hd)`` view of it;
        leaf form: :meth:`assemble` into the leaf buffers.  ``buffers`` is
        a dict the caller keeps from step to step, where the buffers of
        this bank shape and form are made on first use (the engine shares
        one among its decode PEs, so a captured graph reads fixed
        addresses); without it the step gathers into new tensors.
        Non-paged leaves pass through from ``cache``."""
        reason = self.form()
        self.forms.count(reason)
        lay = self.pool.layout
        out = None
        if buffers is not None:
            key = ("payload" if reason is None else "leaves", self.num_slots,
                   lay)
            if key not in buffers:
                make = payload_buffer if reason is None else leaf_buffers
                buffers[key] = make(lay, self.num_slots, heap.device)
            out = buffers[key]
        if reason is not None:
            return self.assemble(heap, cache, out=out)
        pay = self._k3(heap)
        self.payload = pay if out is None else out.copy_(pay)
        blocks = [dict(e) for e in cache["blocks"]]
        for pl in lay.paged:
            blocks[pl.unit_idx][pl.key] = lay.leaf_view(
                self.payload, pl).permute(2, 0, 1, 3, 4, 5)
        return dict(cache, blocks=blocks)

    def assemble(self, heap, cache, out=None):
        """Leaf form: rebuild every paged leaf of the batched decode cache
        from the pool row through the slot block tables, into ``out``
        (from :func:`leaf_buffers`) where given, else into new tensors.
        Non-paged leaves pass through from ``cache``."""
        self.payload = None
        lay = self.pool.layout
        if not lay.paged:
            return cache
        pay = self._k3(heap)                            # (B, nb, words)
        blocks = [dict(e) for e in cache["blocks"]]
        for pl in lay.paged:
            blocks[pl.unit_idx][pl.key] = lay.gathered_leaf(
                pay, pl, out=None if out is None else out[pl.path])
        return dict(cache, blocks=blocks)

    def unpaged(self, cache):
        """A post-step cache without its paged leaves, for the slot bank:
        the pool row is the single source of truth, and the bank never
        holds a dense copy."""
        paged = self.pool.layout.paged_keys
        return dict(cache, blocks=[
            {key: leaf for key, leaf in entry.items()
             if (ui, key) not in paged}
            for ui, entry in enumerate(cache["blocks"])])

    # ------------------------------------------------------------ writeback
    def writeback(self, ctx, heap, new_cache, pos, active):
        """Store each active slot's just-written K/V token column into its
        owning pool block.  ``pos`` is the PRE-step cursor.  Copy-on-write
        fires here, before the first store into a shared block.  In the
        payload form (:attr:`payload` set by :meth:`gather`) the store is
        the slot's gathered block, which the step wrote the column into;
        in the leaf form the block is reread and the column set from
        ``new_cache``'s leaves."""
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
            if self.payload is not None:
                heap = heap.write(ptr, self.pe, self.payload[s, b])
                continue
            payload = heap.read(ptr, self.pe)
            parts = []
            for pl in lay.paged:
                sl = lay.leaf_view(payload, pl).clone()
                col = new_cache["blocks"][pl.unit_idx][pl.key][:, s, idx]
                sl[:, t] = col.to(sl.dtype)
                parts.append(sl.reshape(-1))
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
