"""Device-resident symmetric heap (paper §III-E).

Counterpart of ``repro/core/heap.py``.  The PGAS address space is one
``(npes, words)`` tensor per dtype on one device: every PE sees an
identically laid-out row, and a :class:`SymPtr` ``(dtype, offset, shape)`` is
valid at every PE.  Allocation metadata lives host-side.

The heap is memory that is stored into, as an OpenSHMEM symmetric heap is:
:meth:`write` and :meth:`write_all` store into the live pool's rows through
the K1 copy kernel (``kernels/rma_copy.py``; its plain version for a CPU
pool), :meth:`calloc` zeroes its span in place, and each returns the heap
itself, so ``heap = heap.write(...)`` threads one mutable object.  (The
reference's heap is functional, JAX arrays being immutable; no caller reads
a heap superseded by a later store.)  A value that can outlive a later store
is owned: the RMA, AMO, signal and device-side fetches return payload-sized
copies, and :meth:`read` / :meth:`read_all` views serve readers that consume
them at once.  A store whose source overlaps its own destination copies the
source first, so K1 never reads bytes it writes.  A deferred (nbi) put
holds a copy of its payload until it lands (:meth:`staged`).  Pool growth
in :meth:`malloc` is the one place a new pool tensor is made.  A
:class:`HeapTally` counts the bytes the heap copies and stores.  64-bit
dtypes narrow to 32-bit, as JAX does with x64 off, so pointer dtypes and
byte counts match the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import _devices
from repro_torch.kernels import rma_copy

ALIGN = 128  # allocation grid (the reference's TPU lane width)

# the pools K1 stores into (bitwise); other dtypes come with the slices
# that need them
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int32": torch.int32}
_NARROW = {"int64": "int32", "float64": "float32"}


def canonical_dtype(dtype) -> str:
    """Heap dtype name of ``dtype`` (str, numpy or torch), 64-bit narrowed."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif str(dtype) == "bfloat16":
        name = "bfloat16"
    else:
        name = np.dtype(dtype).name
    name = _NARROW.get(name, name)
    if name not in TORCH_DTYPES:
        raise TypeError(f"no symmetric pool for dtype {dtype!r}")
    return name


def _aligned(n: int) -> int:
    return max(ALIGN, -(-n // ALIGN) * ALIGN)


class SymPtr(NamedTuple):
    dtype: str
    offset: int
    shape: tuple

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n

    @property
    def nbytes(self) -> int:
        return self.size * TORCH_DTYPES[self.dtype].itemsize

    def index(self, i: int) -> "SymPtr":
        """Pointer to element i of a flattened buffer."""
        if not 0 <= i < self.size:
            raise IndexError(i)
        return SymPtr(self.dtype, self.offset + i, ())


@dataclasses.dataclass
class HeapTally:
    """Cumulative counts of one heap's data movement: ``copy_bytes``, the
    bytes copied besides the stores themselves (a pool's old contents at
    growth, a self-overlapping store's source, a deferred put's staged
    payload and the completion queue's merged run of them);
    ``store_bytes``, the bytes its data ops (``write``, ``write_all``,
    ``calloc``) store; ``writes``, those calls."""
    copy_bytes: int = 0
    store_bytes: int = 0
    writes: int = 0

    def add(self, store_bytes: int) -> None:
        self.store_bytes += store_bytes
        self.writes += 1


@dataclasses.dataclass
class SymmetricHeap:
    """Symmetric heap.  Data ops store in place and return the heap."""

    npes: int
    pools: dict                    # dtype str -> (npes, words) tensor
    device: torch.device
    _cursor: dict = dataclasses.field(default_factory=dict)
    _free: dict = dataclasses.field(default_factory=dict)
    words_per_pool: int = 1 << 20
    tally: HeapTally = dataclasses.field(default_factory=HeapTally)

    # ----------------------------------------------------------- allocation
    def malloc(self, shape, dtype) -> SymPtr:
        """shmem_malloc: symmetric, host-side.  A reused free-list region
        keeps a freed buffer's bytes (the OpenSHMEM contract)."""
        dt = canonical_dtype(dtype)
        shape = tuple(int(s) for s in shape)
        n = 1
        for s in shape:
            n *= s
        n_aligned = _aligned(n)
        for i, (off, sz) in enumerate(self._free.get(dt, [])):   # first fit
            if sz >= n_aligned:
                self._free[dt].pop(i)
                if sz > n_aligned:
                    self._free[dt].append((off + n_aligned, sz - n_aligned))
                return SymPtr(dt, off, shape)
        cur = self._cursor.get(dt, 0)
        if dt not in self.pools:
            self.pools[dt] = torch.zeros((self.npes, self.words_per_pool),
                                         dtype=TORCH_DTYPES[dt],
                                         device=self.device)
        words = self.pools[dt].shape[1]
        if cur + n_aligned > words:                 # grow by doubling
            pad = torch.zeros((self.npes, max(words * 2, cur + n_aligned)
                               - words), dtype=TORCH_DTYPES[dt],
                              device=self.device)
            old = self.pools[dt]
            self.pools[dt] = torch.cat([old, pad], dim=1)
            self.tally.copy_bytes += old.numel() * old.element_size()
        self._cursor[dt] = cur + n_aligned
        return SymPtr(dt, cur, shape)

    def calloc(self, shape, dtype) -> SymPtr:
        """shmem_calloc: like malloc, but the whole aligned span reads zero
        at every PE, zeroed in place."""
        ptr = self.malloc(shape, dtype)
        pool = self.pools[ptr.dtype]
        n = _aligned(ptr.size)
        pool[:, ptr.offset:ptr.offset + n].zero_()
        self.tally.add(self.npes * n * pool.element_size())
        return ptr

    def free(self, ptr: SymPtr) -> None:
        """Return the aligned span to the free list, coalescing neighbours."""
        entries = sorted(self._free.setdefault(ptr.dtype, [])
                         + [(ptr.offset, _aligned(ptr.size))])
        merged = [entries[0]]
        for off, sz in entries[1:]:
            last_off, last_sz = merged[-1]
            if last_off + last_sz == off:
                merged[-1] = (last_off, last_sz + sz)
            else:
                merged.append((off, sz))
        self._free[ptr.dtype] = merged

    def stats(self) -> dict:
        """Allocator accounting per dtype pool and in total."""
        per_dtype = {}
        tot_used = tot_free = tot_reserved = 0
        for dt, pool in self.pools.items():
            item = TORCH_DTYPES[dt].itemsize
            cursor = self._cursor.get(dt, 0)
            free_spans = self._free.get(dt, [])
            free_words = sum(sz for _, sz in free_spans)
            largest = max((sz for _, sz in free_spans), default=0)
            used_words = cursor - free_words
            per_dtype[dt] = {
                "bytes_in_use": used_words * item,
                "bytes_free": free_words * item,
                "bytes_reserved": cursor * item,
                "capacity_bytes": pool.shape[1] * item,
                "free_extents": len(free_spans),
                "largest_free_bytes": largest * item,
                "fragmentation": (1.0 - largest / free_words
                                  if free_words else 0.0),
            }
            tot_used += used_words * item
            tot_free += free_words * item
            tot_reserved += cursor * item
        return {"npes": self.npes, "bytes_in_use": tot_used,
                "bytes_free": tot_free, "bytes_reserved": tot_reserved,
                "pools": per_dtype}

    # ----------------------------------------------------------- access
    def coerce(self, ptr: SymPtr, value) -> torch.Tensor:
        """``value`` as a flat contiguous tensor of the pointer's dtype on
        the heap's device (a view when it already is one)."""
        t = torch.as_tensor(value, dtype=TORCH_DTYPES[ptr.dtype],
                            device=self.device)
        return t.reshape(ptr.size).contiguous()

    def staged(self, ptr: SymPtr, value) -> torch.Tensor:
        """An owned copy of ``value``, coerced for ``ptr``: the payload a
        deferred store holds until it lands, counted in ``copy_bytes``."""
        value = self.coerce(ptr, value).clone()
        self.tally.copy_bytes += value.numel() * value.element_size()
        return value

    def read(self, ptr: SymPtr, pe: int) -> torch.Tensor:
        """Local load of the buffer as seen at PE ``pe``: a view of the
        live pool, which a later store changes."""
        flat = self.pools[ptr.dtype][pe, ptr.offset:ptr.offset + ptr.size]
        return flat.reshape(ptr.shape)

    def write(self, ptr: SymPtr, pe: int, value) -> "SymmetricHeap":
        """Store ``value`` at PE ``pe``'s row with K1, in place; returns
        this heap."""
        value = self._unaliased(ptr, [pe], self.coerce(ptr, value))
        rma_copy.copy_into(self.pools[ptr.dtype][pe], value, ptr.offset)
        self.tally.add(value.numel() * value.element_size())
        return self

    def read_all(self, ptr: SymPtr) -> torch.Tensor:
        """(npes, *shape) view of the buffer across every PE."""
        flat = self.pools[ptr.dtype][:, ptr.offset:ptr.offset + ptr.size]
        return flat.reshape((self.npes,) + ptr.shape)

    def write_all(self, ptr: SymPtr, values) -> "SymmetricHeap":
        """Store row ``pe`` of ``values`` at every PE ``pe`` with K1, in
        place; returns this heap."""
        values = torch.as_tensor(values, dtype=TORCH_DTYPES[ptr.dtype],
                                 device=self.device).reshape(self.npes, -1)
        values = self._unaliased(ptr, range(self.npes), values)
        pool = self.pools[ptr.dtype]
        for pe in range(self.npes):
            rma_copy.copy_into(pool[pe], values[pe].contiguous(), ptr.offset)
        self.tally.add(values.numel() * values.element_size())
        return self

    def _unaliased(self, ptr: SymPtr, pes, src: torch.Tensor) -> torch.Tensor:
        """``src``, or a copy of it where its bytes overlap ``ptr``'s span
        at one of ``pes``, the bytes a store of it writes: K1 never reads
        bytes it is writing."""
        if not src.numel():
            return src
        pool = self.pools[ptr.dtype]
        item = pool.element_size()
        lo = src.data_ptr()
        hi = lo + item * (1 + sum((n - 1) * st for n, st in
                                  zip(src.shape, src.stride())))
        for pe in pes:
            start = pool[pe].data_ptr() + ptr.offset * item
            if lo < start + ptr.size * item and start < hi:
                self.tally.copy_bytes += src.numel() * item
                return src.clone()
        return src


def create(npes: int, words_per_pool: int = 1 << 20,
           device=None) -> SymmetricHeap:
    """shmemx_heap_create analogue; pools live on ``device`` (CUDA unless
    the caller asks for another)."""
    return SymmetricHeap(npes, {}, _devices.resolve(device), {}, {},
                         words_per_pool)
