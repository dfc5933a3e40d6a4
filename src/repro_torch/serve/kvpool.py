"""Paged KV-cache block pool on the symmetric heap.

Counterpart of ``repro/serve/kvpool.py``.  Every request's decode state is
stored in fixed-size blocks carved out of one symmetric allocation, so a
prefill PE hands a finished request to a decode PE with one-sided
``put_signal_nbi``: the layout is identical on every PE, which makes a
block id a cluster-wide address.

- **paged leaves** — the self-attention K/V tensors (and latent
  attention's ``ckv`` rows), split along the token axis into blocks of
  ``block_tokens``; block *b* holds ``[b*T, (b+1)*T)``
  of every paged leaf, flattened and concatenated in a fixed order.  A
  dense cache migrates ``ceil(S/T)`` blocks for a prompt of S tokens; a
  ring (SWA window) always moves all ``ceil(W/T)``, since occupied slots
  wrap, and never grows.
- **tail** — every other cache leaf (recurrent states, a ring's ``kpos``,
  cross and encoder K/V), packed losslessly into one float32 vector per
  slot (f32 as is, bf16 upcast exactly, int32 bit-cast with
  ``Tensor.view``: a ``kpos`` of -1 rides as a NaN bit pattern, so every
  hop copies its bits and none computes on them).
- **header** — 4 int32 words per slot ``(req_id, prompt_len,
  first_token, n_blocks)``.
- **signal** — one int32 word per slot, the admission target.
- **stream signals** — ``max_streams`` int32 words, allocated right after
  the slot signals as the reference does, so a chunked migration ramps a
  signal while it is parked: its blocks land before any decode slot is
  bound, and the slot binds only at ``stream_close``.

Block metadata (free list, ref counts, tables) is host-side.  Shared
prefixes map another request's blocks by reference (``alloc_with_prefix``,
``incref``); copy-on-write targets are anonymous reserves (``reserve``)
that ``remap`` moves into a table or ``release_ids`` returns.
``insert_blocks`` rebuilds a dense slot cache for the dense-rehydrate mode.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, FrozenSet, List, Optional, Tuple

import torch

from repro_torch.core.heap import TORCH_DTYPES, SymPtr, SymmetricHeap
from repro_torch.models import kvcache

HEADER_WORDS = 4            # (req_id, prompt_len, first_token, n_blocks)
#: cache leaves paged over their token axis: self-attention K and V, and
#: latent attention's one row a token (``ckv``)
PAGED_KEYS = ("k", "v", "ckv")


# ---------------------------------------------------------------------------
# Layout derivation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PagedLeaf:
    """One K or V tensor paged over its token axis: stacked
    ``(reps, B, W, nkv, hd)``; a block contributes ``reps*T*nkv*hd`` words."""
    unit_idx: int
    key: str
    reps: int
    width: int
    nkv: int
    hd: int

    @property
    def words_per_token(self) -> int:
        return self.reps * self.nkv * self.hd

    @property
    def path(self) -> tuple:
        """``(unit index, key)``, its place in a cache's ``blocks``."""
        return self.unit_idx, self.key


@dataclasses.dataclass(frozen=True)
class TailLeaf:
    """One non-paged cache leaf, packed into the f32 tail vector."""
    unit_idx: int
    key: str
    shape: tuple             # per-request shape (reps, 1, ...)
    dtype: str
    words: int


@dataclasses.dataclass(frozen=True)
class KVLayout:
    """Block/tail geometry for one (cfg, max_len, block_tokens) triple."""
    block_tokens: int
    blocks_per_request: int
    block_words: int
    tail_words: int
    kv_dtype: str
    cache_width: int
    ring: bool
    paged: Tuple[PagedLeaf, ...]
    tail: Tuple[TailLeaf, ...]

    @property
    def block_bytes(self) -> int:
        return self.block_words * TORCH_DTYPES[self.kv_dtype].itemsize

    # ------------------------------------------------------ block format
    @functools.cached_property
    def paged_keys(self) -> FrozenSet[tuple]:
        """The ``(unit index, key)`` of every paged leaf."""
        return frozenset(pl.path for pl in self.paged)

    @functools.cached_property
    def leaf_offsets(self) -> Dict[tuple, int]:
        """Each paged leaf's word offset in a block, by ``path``: the leaves
        lie in ``paged`` order, as :func:`pack_blocks` concatenates them."""
        offs, off = {}, 0
        for pl in self.paged:
            offs[pl.path] = off
            off += pl.words_per_token * self.block_tokens
        return offs

    def leaf_view(self, payload: torch.Tensor, pl: PagedLeaf) -> torch.Tensor:
        """``pl``'s tokens inside ``payload``, whose last axis is one
        block's ``block_words``: a ``(..., reps, T, nkv, hd)`` view."""
        off = self.leaf_offsets[pl.path]
        n = pl.words_per_token * self.block_tokens
        return payload[..., off:off + n].unflatten(
            -1, (pl.reps, self.block_tokens, pl.nkv, pl.hd))

    def gathered_leaf(self, pay: torch.Tensor, pl: PagedLeaf,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Leaf ``pl`` ``(reps, B, width, nkv, hd)``, bitwise a dense
        cache's, from ``pay`` ``(B, n, block_words)``, each row's first n
        blocks in table order as K3 gathers them, copied into ``out``
        (``(reps, B, n * T, nkv, hd)``) where given; the leaf is its first
        ``width`` positions (fewer where n blocks hold fewer)."""
        blocks = self.leaf_view(pay, pl).permute(2, 0, 1, 3, 4, 5)
        if out is None:
            out = blocks.flatten(2, 3)
        else:
            out.unflatten(2, blocks.shape[2:4]).copy_(blocks)
        return out[:, :, :pl.width]

    def blocks_for_prompt(self, prompt_len: int) -> int:
        """Blocks that migrate for a prompt: a dense cache fills slots
        [0, S); a ring wraps, so every block is live."""
        if self.ring:
            return self.blocks_per_request
        need = -(-min(prompt_len, self.cache_width) // self.block_tokens)
        return max(1, need)

    def blocks_for_decode(self, prompt_len: int, max_new: int) -> int:
        """Block-table length through the whole decode: the prompt blocks
        plus the growth blocks generated tokens are written into.  Decode
        consumes out[0..max_new-2], so the last K/V write lands at
        prompt_len + max_new - 2.  A ring wraps in place and never grows.
        THE table-size formula: staging and the scheduler's headroom check
        both use it."""
        if self.ring:
            return self.blocks_per_request
        last = min(prompt_len + max(max_new - 1, 0), self.cache_width) - 1
        return max(self.blocks_for_prompt(prompt_len),
                   last // self.block_tokens + 1)


def build_layout(cfg, max_len: int, *, block_tokens: int = 16) -> KVLayout:
    """Classify every leaf of the model's cache (shapes computed directly)."""
    struct = kvcache.cache_shapes(cfg, 1, max_len)
    W = kvcache.self_cache_len(cfg, max_len)
    ring = kvcache.is_ring(cfg, max_len)
    block_tokens = min(block_tokens, W)
    paged: List[PagedLeaf] = []
    tail: List[TailLeaf] = []
    kv_dtype = None
    for ui, entry in enumerate(struct["blocks"]):
        for key in sorted(entry):
            shape, dt = entry[key]
            if key in PAGED_KEYS and len(shape) == 5 and shape[2] == W:
                paged.append(PagedLeaf(ui, key, shape[0], shape[2],
                                       shape[3], shape[4]))
                kv_dtype = dt if kv_dtype is None else kv_dtype
                if dt != kv_dtype:
                    raise ValueError("mixed paged dtypes unsupported")
            else:
                if dt not in ("float32", "int32", "bfloat16"):
                    raise ValueError(f"unpackable tail dtype {dt}")
                n = 1
                for s in shape:
                    n *= s
                tail.append(TailLeaf(ui, key, tuple(shape), dt, n))
    nb = -(-W // block_tokens) if paged else 1
    return KVLayout(block_tokens=block_tokens, blocks_per_request=nb,
                    block_words=max(1, sum(p.words_per_token for p in paged)
                                    * block_tokens),
                    tail_words=max(1, sum(t.words for t in tail)),
                    kv_dtype=kv_dtype or "float32", cache_width=W,
                    ring=ring, paged=tuple(paged), tail=tuple(tail))


# ---------------------------------------------------------------------------
# Lossless tail packing
# ---------------------------------------------------------------------------


def _pack_leaf_f32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return x.reshape(-1)
    if x.dtype == torch.bfloat16:
        return x.float().reshape(-1)                    # exact upcast
    if x.dtype == torch.int32:
        return x.contiguous().view(torch.float32).reshape(-1)   # bit-cast
    raise ValueError(f"unpackable tail dtype {x.dtype}")


def _unpack_leaf_f32(flat: torch.Tensor, shape, dtype: str) -> torch.Tensor:
    flat = flat.float().reshape(shape)
    if dtype == "float32":
        return flat
    if dtype == "bfloat16":
        return flat.to(torch.bfloat16)                  # exact downcast
    if dtype == "int32":
        return flat.contiguous().view(torch.int32)
    raise ValueError(f"unpackable tail dtype {dtype}")


# ---------------------------------------------------------------------------
# Cache <-> block payload conversion
# ---------------------------------------------------------------------------


def pack_blocks(layout: KVLayout, cache, *, batch_idx: int = 0,
                n_blocks: Optional[int] = None,
                start: int = 0) -> List[torch.Tensor]:
    """Slice one request out of a cache into ``n_blocks`` flat
    ``(block_words,)`` payloads covering token blocks
    [start, start + n_blocks); shared-prefix staging skips the blocks
    another request staged by passing ``start``."""
    if n_blocks is None:
        n_blocks = layout.blocks_per_request - start
    T = layout.block_tokens
    dtype = TORCH_DTYPES[layout.kv_dtype]
    payloads = []
    for b in range(start, start + n_blocks):
        parts = []
        for pl in layout.paged:
            leaf = cache["blocks"][pl.unit_idx][pl.key]
            sl = leaf[:, batch_idx, b * T:(b + 1) * T]      # (reps,T,nkv,hd)
            if sl.shape[1] < T:                             # ragged last block
                sl = torch.nn.functional.pad(
                    sl, (0, 0, 0, 0, 0, T - sl.shape[1]))
            parts.append(sl.reshape(-1))
        if not parts:
            parts = [torch.zeros(layout.block_words, dtype=dtype)]
        payloads.append(torch.cat(parts).to(dtype))
    return payloads


def pack_tail(layout: KVLayout, cache, *, batch_idx: int = 0,
              device=None) -> torch.Tensor:
    """Pack the non-paged remainder of one request into a f32 vector."""
    parts = [_pack_leaf_f32(cache["blocks"][tl.unit_idx][tl.key]
                            [:, batch_idx:batch_idx + 1])
             for tl in layout.tail]
    if not parts:
        return torch.zeros(layout.tail_words, dtype=torch.float32,
                           device=device)
    return torch.cat(parts)


def insert_blocks(layout: KVLayout, cache, slot: int,
                  payloads: List[torch.Tensor]):
    """Scatter migrated block payloads into slot ``slot`` of a batched
    decode cache (inverse of :func:`pack_blocks`; the dense-rehydrate
    admission).  Returns a new cache dict; leaves it writes are cloned
    first."""
    blocks = [dict(e) for e in cache["blocks"]]
    pay = torch.stack([p.reshape(-1) for p in payloads])[None]
    for pl in layout.paged:
        leaf = blocks[pl.unit_idx][pl.key].clone()
        sl = layout.gathered_leaf(pay, pl)[:, 0]
        leaf[:, slot, :sl.shape[1]] = sl.to(leaf.dtype)
        blocks[pl.unit_idx][pl.key] = leaf
    return dict(cache, blocks=blocks)


def insert_tail(layout: KVLayout, cache, slot: int, tail_vec):
    """Scatter a migrated tail vector into slot ``slot`` (inverse of
    :func:`pack_tail`).  Returns a new cache dict; leaves it writes are
    cloned first."""
    cache = dict(cache)
    blocks = [dict(e) for e in cache["blocks"]]
    off = 0
    for tl in layout.tail:
        sl = _unpack_leaf_f32(tail_vec[off:off + tl.words], tl.shape,
                              tl.dtype)
        off += tl.words
        leaf = blocks[tl.unit_idx][tl.key].clone()
        leaf[:, slot:slot + 1] = sl.to(leaf.dtype)
        blocks[tl.unit_idx][tl.key] = leaf
    cache["blocks"] = blocks
    return cache


# ---------------------------------------------------------------------------
# The pool: symmetric allocation + host-side block accounting
# ---------------------------------------------------------------------------


class KVPool:
    """Ref-counted paged block pool over one symmetric heap allocation."""

    def __init__(self, heap: SymmetricHeap, layout: KVLayout, *,
                 num_blocks: int, max_slots: int, max_streams: int = 16):
        self.layout = layout
        self.num_blocks = num_blocks
        self.max_slots = max_slots
        self.max_streams = max_streams
        self.data = heap.calloc((num_blocks * layout.block_words,),
                                layout.kv_dtype)
        self.tails = heap.calloc((max_slots * layout.tail_words,), "float32")
        self.headers = heap.calloc((max_slots * HEADER_WORDS,), "int32")
        self.signals = heap.calloc((max_slots,), "int32")
        self.stream_sigs = heap.calloc((max(1, max_streams),), "int32")
        self._stream_free: List[int] = list(range(max_streams - 1, -1, -1))
        self._refcnt: List[int] = [0] * num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self.block_tables: Dict[int, List[int]] = {}
        # block id -> PE whose heap row holds the staged payload (the wire
        # source; growth and copy-on-write blocks have no home and never
        # travel)
        self._home: Dict[int, int] = {}

    @classmethod
    def create(cls, heap: SymmetricHeap, cfg, max_len: int, *,
               num_blocks: int, max_slots: int, block_tokens: int = 16,
               max_streams: int = 16) -> "KVPool":
        layout = build_layout(cfg, max_len, block_tokens=block_tokens)
        return cls(heap, layout, num_blocks=num_blocks, max_slots=max_slots,
                   max_streams=max_streams)

    # ---------------------------------------------------------- addressing
    def block_ptr(self, block_id: int) -> SymPtr:
        if not 0 <= block_id < self.num_blocks:
            raise IndexError(block_id)
        w = self.layout.block_words
        return SymPtr(self.layout.kv_dtype,
                      self.data.offset + block_id * w, (w,))

    def _check_slot(self, slot: int) -> int:
        if not 0 <= slot < self.max_slots:
            raise IndexError(f"slot {slot} outside pool of {self.max_slots}")
        return slot

    def tail_ptr(self, slot: int) -> SymPtr:
        w = self.layout.tail_words
        return SymPtr("float32",
                      self.tails.offset + self._check_slot(slot) * w, (w,))

    def header_ptr(self, slot: int) -> SymPtr:
        return SymPtr("int32", self.headers.offset
                      + self._check_slot(slot) * HEADER_WORDS,
                      (HEADER_WORDS,))

    def sig_ptr(self, slot: int) -> SymPtr:
        return SymPtr("int32", self.signals.offset + self._check_slot(slot),
                      ())

    def stream_sig_ptr(self, stream_id: int) -> SymPtr:
        if not 0 <= stream_id < self.max_streams:
            raise IndexError(
                f"stream {stream_id} outside pool of {self.max_streams}")
        return SymPtr("int32", self.stream_sigs.offset + stream_id, ())

    def alloc_stream_sig(self) -> Optional[int]:
        """Reserve a parked-stream signal word, or None when every word is
        carried by an in-flight stream."""
        return self._stream_free.pop() if self._stream_free else None

    def free_stream_sig(self, stream_id: int) -> None:
        if stream_id in self._stream_free:
            raise ValueError(f"double free of stream signal {stream_id}")
        self._stream_free.append(stream_id)

    # ---------------------------------------------------------- accounting
    def _alloc_free(self, n_blocks: int) -> Optional[List[int]]:
        """Pop ``n_blocks`` ids (refcount 1 each) off the tail of the LIFO
        free list, or None.  Sorted so heap-contiguous blocks end up
        queue-adjacent for write combining."""
        if n_blocks < 0:
            raise ValueError(f"negative block count {n_blocks}")
        if n_blocks > len(self._free):
            return None
        if n_blocks == 0:
            return []
        ids = sorted(self._free[-n_blocks:])
        del self._free[-n_blocks:]
        for i in ids:
            self._refcnt[i] = 1
        return ids

    def alloc(self, req_id: int, n_blocks: int) -> Optional[List[int]]:
        """Reserve ``n_blocks`` blocks for a request in token-block order,
        or None when the pool cannot satisfy it."""
        if req_id in self.block_tables:
            raise ValueError(f"request {req_id} already has blocks")
        ids = self._alloc_free(n_blocks)
        if ids is None:
            return None
        self.block_tables[req_id] = ids
        return ids

    def alloc_with_prefix(self, req_id: int, shared_ids: List[int],
                          n_total: int) -> Optional[List[int]]:
        """Shared-prefix table: map ``shared_ids`` (incref'd in place) and
        allocate the other ``n_total - len(shared_ids)`` fresh.  All or
        nothing: a failed allocation takes no references."""
        if req_id in self.block_tables:
            raise ValueError(f"request {req_id} already has blocks")
        fresh = self._alloc_free(n_total - len(shared_ids))
        if fresh is None:
            return None
        self.incref(shared_ids)
        self.block_tables[req_id] = list(shared_ids) + fresh
        return self.block_tables[req_id]

    def reserve(self, n_blocks: int) -> Optional[List[int]]:
        """Anonymous refcounted blocks outside any table: copy-on-write
        targets, moved into a table by :meth:`remap` or returned unused by
        :meth:`release_ids`."""
        return self._alloc_free(n_blocks)

    def incref(self, block_ids: List[int]) -> None:
        for i in block_ids:
            if self._refcnt[i] <= 0:
                raise ValueError(f"incref on free block {i}")
            self._refcnt[i] += 1

    def _decref(self, i: int) -> int:
        self._refcnt[i] -= 1
        if self._refcnt[i] < 0:
            raise ValueError(f"double free of block {i}")
        if self._refcnt[i] == 0:
            self._free.append(i)
            self._home.pop(i, None)
            return 1
        return 0

    def release(self, req_id: int) -> int:
        """Drop a request's references; returns the number of blocks freed."""
        ids = self.block_tables.pop(req_id, [])
        return sum(self._decref(i) for i in ids)

    def release_ids(self, block_ids: List[int]) -> int:
        """Drop one reference each on table-less blocks (unused COW
        reserves, a dead prefix entry).  Returns the number freed."""
        return sum(self._decref(i) for i in block_ids)

    def remap(self, req_id: int, index: int, new_id: int) -> int:
        """Copy-on-write: table entry ``index`` becomes ``new_id`` (the
        caller's reserve reference moves into the table) and this table's
        reference on the old, shared block is dropped.  Returns the old
        id."""
        table = self.block_tables[req_id]
        old = table[index]
        table[index] = new_id
        self._decref(old)
        return old

    def blocks_of(self, req_id: int) -> List[int]:
        return list(self.block_tables[req_id])

    def refcount(self, block_id: int) -> int:
        return self._refcnt[block_id]

    def free_blocks(self) -> int:
        return len(self._free)

    def set_home(self, block_ids: List[int], pe: int) -> None:
        """Record which PE's row holds these blocks' staged payloads."""
        for i in block_ids:
            self._home[i] = pe

    def home_of(self, block_id: int) -> Optional[int]:
        return self._home.get(block_id)

    def stats(self, heap: Optional[SymmetricHeap] = None) -> dict:
        used = self.num_blocks - len(self._free)
        out = {
            "blocks_total": self.num_blocks,
            "blocks_in_use": used,
            "blocks_free": len(self._free),
            "block_bytes": self.layout.block_bytes,
            "bytes_in_use": used * self.layout.block_bytes,
            "utilization": used / self.num_blocks if self.num_blocks else 0.0,
            "requests_resident": len(self.block_tables),
            "blocks_shared": sum(1 for r in self._refcnt if r > 1),
            "streams_active": self.max_streams - len(self._stream_free),
        }
        if heap is not None:
            out["heap"] = heap.stats()
        return out
