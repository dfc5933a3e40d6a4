"""KV-cache migration engine: prefill PE -> decode PE over the SHMEM stack.

Counterpart of ``repro/serve/kvxfer.py``, whole-prefill protocol:

1. **stage** — the prefill PE packs the request's cache into pool blocks
   and writes them into its own row of the symmetric pool (local blocking
   puts).  Shared-prefix blocks another request staged are mapped, not
   re-packed; growth blocks, reserved for decode to write generated tokens
   into, carry no payload and never travel.
2. **migrate** — the staged blocks go to the decode PE as
   ``put_signal_nbi`` traffic: block ids sorted so heap-contiguous runs are
   queue-adjacent, every block of a run a deferred put read from its home
   row, the run's last block carrying ``SIGNAL_ADD(run_len)``.  The
   completion queue write-combines each run into ONE transfer.  Blocks
   already resident at the destination (``skip``) never travel.  The tail
   and the 4-word header follow, each signal-bearing.
3. **admit** — the decode PE polls ``signal_wait_until(sig >= n_blocks +
   2)``.  Queue order makes the signal the last update to land, so
   observing it proves every byte of the request is resident.

**Chunked streaming** (``open_stream``, ``stream_chunk``, ``stream_flush``,
``stream_close``) cuts the same wire protocol across scheduler steps: each
installment goes out mid-prefill on one monotonically ramping signal, and
``stream_flush`` drains the previous installment while the next one's
prefill runs.  A stream may ramp a pool stream-signal word with no decode
slot bound (parked); the slot binds only before ``stream_close``, which
sends the tail and header.  ``gather`` reads an admitted request's payloads
back for the dense-rehydrate mode.

The fused protocol (``migrate_fused``, ``try_admit_fused``,
``consume_blocks``) inverts the wire order: tail and header first, then
one work-group ``put_signal_nbi`` per block, so the decode PE admits on the
first block's signal and consumes the rest through device waits that each
force only the minimal queue prefix.

Cross-pod migrations (the ``dcn`` tier) route through a
:class:`~repro_torch.core.proxy.HostProxy` at flush when the migrator has
one: every completion point (``flush``, ``stream_flush``, ``try_admit``,
``try_admit_fused``) drains exactly the queue prefix it needs through the
ring, and each drained put lands through ``heap.write`` (K1 on the card).
``MigrationReport.bytes_dcn`` counts the wire bytes that crossed pods.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.core import cutover, device as device_mod, rma, \
    signal as signal_mod
from repro_torch.core.heap import SymPtr
from repro_torch.serve.kvpool import HEADER_WORDS, KVPool, pack_blocks, \
    pack_tail

#: signal increments beyond the data blocks: the tail's and the header's
EXTRA_SIGNALS = 2


def expected_signal(n_blocks: int) -> int:
    return n_blocks + EXTRA_SIGNALS


def fused_admit_signal(n_wire: int) -> int:
    """Fused-protocol admission threshold: tail + header + the FIRST wire
    block (or just tail + header when nothing travels)."""
    return EXTRA_SIGNALS + min(1, n_wire)


@dataclasses.dataclass
class MigrationReport:
    """What one request's migration put on the wire."""
    req_id: int
    slot: int
    src_pe: int
    dst_pe: int
    tier: str
    n_blocks: int               # staged (payload-bearing) blocks
    n_wire: int                 # blocks sent (resident blocks skipped)
    n_runs: int                 # contiguous block runs
    bytes_paged: int            # wire bytes (skipped blocks excluded)
    bytes_tail: int
    bytes_skipped: int          # shared blocks already resident at dst
    expected_signal: int
    chunks: int = 1             # wire installments (1 = whole-prefill)
    bytes_dcn: int = 0          # wire bytes that crossed pods
    fused: bool = False         # per-block signal protocol (migrate_fused)

    @property
    def bytes_total(self) -> int:
        return self.bytes_paged + self.bytes_tail + HEADER_WORDS * 4


@dataclasses.dataclass
class StreamState:
    """One in-flight chunked migration.  ``slot`` is -1 while the stream
    is parked: its blocks ramp ``sig`` (a pool stream-signal word) and the
    slot is bound just before ``stream_close`` sends the tail + header."""
    req_id: int
    src_pe: int
    dst_pe: int
    slot: int
    prompt_len: int
    first_token: int
    pending: List[int]          # staged blocks not yet on the wire
    n_staged: int               # payload-bearing blocks (header n_blocks)
    n_skipped: int              # resident-at-dst blocks never sent
    sig: Optional[SymPtr] = None  # admission signal word
    sent: int = 0               # wire blocks issued so far
    chunks: int = 0
    runs: int = 0               # contiguous runs issued across all chunks
    final_wire: int = 0         # signal increments of the closing chunk
    bytes_dcn: int = 0          # cross-pod wire bytes so far

    @property
    def expected(self) -> int:
        """Admission threshold once the stream closes."""
        return self.sent + len(self.pending) + EXTRA_SIGNALS


def _contiguous_runs(ids: List[int]) -> List[List[int]]:
    runs: List[List[int]] = []
    for i in sorted(ids):
        if runs and i == runs[-1][-1] + 1:
            runs[-1].append(i)
        else:
            runs.append([i])
    return runs


class KVMigrator:
    """Streams paged KV blocks between PEs with signal-carried completion."""

    def __init__(self, ctx, pool: KVPool, *, proxy=None,
                 work_items: Optional[int] = None):
        self.ctx = ctx
        self.pool = pool
        self.proxy = proxy          # HostProxy for dcn-tier flushes (optional)
        self.work_items = (ctx.tuning.work_group_size
                           if work_items is None else work_items)
        self._staged_tails = {}     # req_id -> packed tail vector

    def _tracer(self):
        tr = self.ctx.tracer
        return tr if tr.enabled else None

    def _track(self, pe: int) -> tuple:
        return f"pod{self.ctx.node_of(pe)}", f"pe{pe}"

    # ------------------------------------------------------------- staging
    def stage(self, heap, req_id: int, cache, *, prompt_len: int,
              src_pe: int, batch_idx: int = 0, max_new: int = 0,
              shared_ids: Optional[List[int]] = None):
        """Allocate a finished prefill's block table ``[shared prefix |
        private prompt | growth]`` and write the private prompt payloads
        into the prefill PE's own pool row; ``shared_ids`` map another
        request's staged prefix blocks (incref'd, not re-packed).  Returns
        (heap, ids), or (heap, None) when the pool is exhausted."""
        lay = self.pool.layout
        shared_ids = list(shared_ids or [])
        n_prompt = lay.blocks_for_prompt(prompt_len)
        n_table = lay.blocks_for_decode(prompt_len, max_new)
        if shared_ids:
            ids = self.pool.alloc_with_prefix(req_id, shared_ids, n_table)
        else:
            ids = self.pool.alloc(req_id, n_table)
        if ids is None:
            return heap, None
        start = len(shared_ids)
        payloads = pack_blocks(lay, cache, batch_idx=batch_idx,
                               n_blocks=n_prompt - start, start=start)
        for bid, payload in zip(ids[start:n_prompt], payloads):
            heap = rma.put(self.ctx, heap, self.pool.block_ptr(bid), payload,
                           src_pe, src_pe=src_pe, work_items=self.work_items)
        self.pool.set_home(ids[start:n_prompt], src_pe)
        self._staged_tails[req_id] = pack_tail(lay, cache,
                                               batch_idx=batch_idx,
                                               device=heap.device)
        tr = self._tracer()
        if tr is not None:
            pid, tid = self._track(src_pe)
            tr.instant("stage", "kvx", pid, tid, rid=req_id,
                       blocks=n_prompt - start, shared=len(shared_ids))
        return heap, ids

    def _wire_plan(self, req_id: int, skip) -> tuple:
        """(send_ids, n_staged, n_skipped): the staged blocks to put on the
        wire.  Growth blocks have no home and never travel; ``skip`` holds
        shared blocks already resident at the destination."""
        staged = [i for i in self.pool.blocks_of(req_id)
                  if self.pool.home_of(i) is not None]
        send = [i for i in staged if i not in skip]
        return send, len(staged), len(staged) - len(send)

    # ----------------------------------------------------------- migration
    def _send_runs(self, heap, ids: List[int], sig, dst_pe: int) -> tuple:
        """One signal-bearing deferred transfer per contiguous run, each
        block read from its home row.  Returns (heap, n_runs, dcn_bytes)."""
        runs = _contiguous_runs(ids)
        dcn = 0
        for run in runs:
            for bid in run:
                ptr = self.pool.block_ptr(bid)
                home = self.pool.home_of(bid)
                if bid == run[-1]:
                    heap = signal_mod.put_signal_nbi(
                        self.ctx, heap, ptr, heap.read(ptr, home), sig,
                        len(run), signal_mod.SIGNAL_ADD, dst_pe, src_pe=home,
                        work_items=self.work_items)
                else:
                    heap = rma.put_nbi(self.ctx, heap, ptr,
                                       heap.read(ptr, home), dst_pe,
                                       src_pe=home,
                                       work_items=self.work_items)
                self._note_block(ptr.nbytes, home, dst_pe)
                if self.ctx.tier(home, dst_pe) == "dcn":
                    dcn += ptr.nbytes
        return heap, len(runs), dcn

    def _send_tail_header(self, heap, req_id: int, slot: int, src_pe: int,
                          dst_pe: int, prompt_len: int, first_token: int,
                          n_staged: int, sig=None):
        """Signal-bearing tail then header; the header's increment is the
        last queue entry, i.e. the admission threshold.  ``sig`` overrides
        the slot's signal word (a parked stream ramps a stream signal).
        The packed tail stays retained until the request evicts."""
        if sig is None:
            sig = self.pool.sig_ptr(slot)
        heap = signal_mod.put_signal_nbi(
            self.ctx, heap, self.pool.tail_ptr(slot),
            self._staged_tails[req_id], sig, 1, signal_mod.SIGNAL_ADD,
            dst_pe, src_pe=src_pe, work_items=self.work_items)
        hdr = torch.tensor([req_id, prompt_len, first_token, n_staged],
                           dtype=torch.int32)
        return signal_mod.put_signal_nbi(
            self.ctx, heap, self.pool.header_ptr(slot), hdr, sig, 1,
            signal_mod.SIGNAL_ADD, dst_pe, src_pe=src_pe,
            work_items=self.work_items)

    def migrate(self, heap, req_id: int, *, src_pe: int, dst_pe: int,
                slot: int, prompt_len: int, first_token: int,
                skip=frozenset()) -> tuple:
        """Stream one staged request to ``dst_pe`` as deferred
        ``put_signal_nbi`` traffic (the whole-prefill form); nothing lands
        until a completion point.  Returns ``(heap, MigrationReport)``."""
        lay = self.pool.layout
        send, n_staged, n_skipped = self._wire_plan(req_id, skip)
        tier = self.ctx.tier(src_pe, dst_pe)
        heap, n_runs, dcn = self._send_runs(heap, send,
                                            self.pool.sig_ptr(slot), dst_pe)
        heap = self._send_tail_header(heap, req_id, slot, src_pe, dst_pe,
                                      prompt_len, first_token, n_staged)
        if tier == "dcn":
            dcn += lay.tail_words * 4 + HEADER_WORDS * 4
        report = MigrationReport(
            req_id=req_id, slot=slot, src_pe=src_pe, dst_pe=dst_pe,
            tier=tier, n_blocks=n_staged, n_wire=len(send), n_runs=n_runs,
            bytes_paged=len(send) * lay.block_bytes,
            bytes_tail=lay.tail_words * 4,
            bytes_skipped=n_skipped * lay.block_bytes,
            expected_signal=expected_signal(len(send)), bytes_dcn=dcn)
        tr = self._tracer()
        if tr is not None:
            pid, tid = self._track(src_pe)
            tr.instant("migrate", "kvx", pid, tid, rid=req_id,
                       dst_pe=dst_pe, tier=tier, runs=n_runs,
                       bytes=report.bytes_total, bytes_dcn=dcn)
            tr.flow_start(req_id, "migration", pid, tid)
        return heap, report

    def migrate_fused(self, heap, req_id: int, *, src_pe: int, dst_pe: int,
                      slot: int, prompt_len: int, first_token: int,
                      skip=frozenset()) -> tuple:
        """Per-block-signal migration for the fused decode path: tail and
        header FIRST (each ``SIGNAL_ADD(1)``), then every wire block
        individually, in table order, as a work-group ``put_signal_nbi``
        from its home PE with its own ``SIGNAL_ADD(1)``.  No run coalescing:
        block k is resident once ``sig >= EXTRA_SIGNALS + k``, so the decode
        PE admits on the first block's signal.  Total increments are
        unchanged (``n_wire + 2``).  Returns ``(heap, MigrationReport)``."""
        lay = self.pool.layout
        send, n_staged, n_skipped = self._wire_plan(req_id, skip)
        tier = self.ctx.tier(src_pe, dst_pe)
        sig = self.pool.sig_ptr(slot)
        heap = self._send_tail_header(heap, req_id, slot, src_pe, dst_pe,
                                      prompt_len, first_token, n_staged)
        dcn = lay.tail_words * 4 + HEADER_WORDS * 4 if tier == "dcn" else 0
        for bid in send:
            ptr = self.pool.block_ptr(bid)
            home = self.pool.home_of(bid)
            wg = device_mod.work_group(self.ctx, size=self.work_items,
                                       pe=home)
            heap = device_mod.put_signal_nbi(
                wg, heap, ptr, heap.read(ptr, home), sig, 1,
                signal_mod.SIGNAL_ADD, dst_pe)
            if self.ctx.tier(home, dst_pe) == "dcn":
                dcn += ptr.nbytes
        report = MigrationReport(
            req_id=req_id, slot=slot, src_pe=src_pe, dst_pe=dst_pe,
            tier=tier, n_blocks=n_staged, n_wire=len(send),
            n_runs=len(send), bytes_paged=len(send) * lay.block_bytes,
            bytes_tail=lay.tail_words * 4,
            bytes_skipped=n_skipped * lay.block_bytes,
            expected_signal=expected_signal(len(send)), bytes_dcn=dcn,
            fused=True)
        tr = self._tracer()
        if tr is not None:
            pid, tid = self._track(src_pe)
            tr.instant("migrate_fused", "kvx", pid, tid, rid=req_id,
                       dst_pe=dst_pe, tier=tier, blocks=len(send),
                       bytes=report.bytes_total, bytes_dcn=dcn)
            tr.flow_start(req_id, "migration", pid, tid)
        return heap, report

    # ----------------------------------------------------- chunked streaming
    def open_stream(self, req_id: int, *, src_pe: int, dst_pe: int,
                    slot: int, prompt_len: int, first_token: int,
                    skip=frozenset(), sig_ptr=None) -> StreamState:
        """Begin a chunked migration of a staged request: the wire plan
        only, nothing is issued.  ``sig_ptr`` (a pool stream-signal word)
        with ``slot=-1`` opens a parked stream; its slot binds before
        ``stream_close``."""
        send, n_staged, n_skipped = self._wire_plan(req_id, skip)
        if sig_ptr is None:
            sig_ptr = self.pool.sig_ptr(slot)
        return StreamState(req_id=req_id, src_pe=src_pe, dst_pe=dst_pe,
                           slot=slot, prompt_len=prompt_len,
                           first_token=first_token, pending=send,
                           n_staged=n_staged, n_skipped=n_skipped,
                           sig=sig_ptr)

    def stream_chunk(self, heap, st: StreamState, chunk_blocks: int):
        """Put the next ``chunk_blocks`` staged blocks on the wire as
        signal-bearing runs; ``SIGNAL_ADD`` keeps one word ramping toward
        the admission threshold across installments."""
        take, st.pending = (st.pending[:chunk_blocks],
                            st.pending[chunk_blocks:])
        heap, n_runs, dcn = self._send_runs(heap, take, st.sig, st.dst_pe)
        st.sent += len(take)
        st.runs += n_runs
        st.chunks += 1
        st.bytes_dcn += dcn
        tr = self._tracer()
        if tr is not None:
            pid, tid = self._track(st.src_pe)
            tr.instant("stream_chunk", "kvx", pid, tid, rid=st.req_id,
                       chunk=st.chunks, blocks=len(take),
                       remaining=len(st.pending))
        return heap

    def stream_flush(self, heap, st: StreamState):
        """Complete exactly the queue prefix this stream's signal depends
        on (its installments so far); other requests' traffic stays
        deferred."""
        return self.ctx.pending.flush_dependency(
            self.ctx, heap, st.sig, st.dst_pe, proxy=self.proxy)

    def stream_close(self, heap, st: StreamState) -> tuple:
        """Final installment: any remaining blocks, then tail + header,
        whose increment completes the threshold ``sent + 2``.  A parked
        stream must have its slot bound (``st.slot``) by now.  Returns
        ``(heap, MigrationReport)``."""
        lay = self.pool.layout
        if st.slot < 0:
            raise ValueError("stream_close before a decode slot was bound")
        st.final_wire = len(st.pending) + EXTRA_SIGNALS
        if st.pending:
            heap = self.stream_chunk(heap, st, len(st.pending))
        heap = self._send_tail_header(heap, st.req_id, st.slot, st.src_pe,
                                      st.dst_pe, st.prompt_len,
                                      st.first_token, st.n_staged, sig=st.sig)
        tier = self.ctx.tier(st.src_pe, st.dst_pe)
        if tier == "dcn":
            st.bytes_dcn += lay.tail_words * 4 + HEADER_WORDS * 4
        report = MigrationReport(
            req_id=st.req_id, slot=st.slot, src_pe=st.src_pe,
            dst_pe=st.dst_pe, tier=tier, n_blocks=st.n_staged,
            n_wire=st.sent, n_runs=st.runs,
            bytes_paged=st.sent * lay.block_bytes,
            bytes_tail=lay.tail_words * 4,
            bytes_skipped=st.n_skipped * lay.block_bytes,
            expected_signal=expected_signal(st.sent),
            chunks=st.chunks, bytes_dcn=st.bytes_dcn)
        tr = self._tracer()
        if tr is not None:
            pid, tid = self._track(st.src_pe)
            tr.instant("stream_close", "kvx", pid, tid, rid=st.req_id,
                       dst_pe=st.dst_pe, chunks=st.chunks,
                       bytes=report.bytes_total, bytes_dcn=st.bytes_dcn)
            tr.flow_start(st.req_id, "migration", pid, tid)
        return heap, report

    def _note_block(self, nbytes: int, src_pe: int, dst_pe: int) -> None:
        """Advisory per-block cutover record: the path the cutover engine
        would pick for one block.  The bytes are charged when the flush
        prices the coalesced transfer, so the modeled comm clock excludes
        the ``kvxfer_block`` buckets."""
        tier = self.ctx.tier(src_pe, dst_pe)
        if tier == "dcn":
            path = "proxy"
        else:
            path = cutover.choose_path(nbytes, work_items=self.work_items,
                                       tier=tier, hw=self.ctx.hw,
                                       tuning=self.ctx.tuning)
        self.ctx.record("kvxfer_block", nbytes, path, tier, self.work_items)

    # ---------------------------------------------------------- completion
    def flush(self, heap):
        """Explicit completion point (quiet); dcn-tier traffic drains
        through the host-proxy ring when one is attached."""
        return rma.quiet(self.ctx, heap, proxy=self.proxy)

    def pending_ops(self) -> int:
        return len(self.ctx.pending)

    # ----------------------------------------------------------- admission
    def try_admit(self, heap, slot: int, dst_pe: int, expected: int, *,
                  sig_ptr=None):
        """Signal-gated admission: returns ``(heap, header|None)``.  The
        wait is the completion point: observing ``sig >= expected`` forces
        the queue prefix the signal depends on, which includes every data
        block of this request.  ``sig_ptr`` overrides the slot's signal
        for a parked stream."""
        if sig_ptr is None:
            sig_ptr = self.pool.sig_ptr(slot)
        if self.proxy is not None:
            # cross-pod: complete ONLY the queue prefix this signal depends
            # on, through the ring; other requests' traffic stays deferred
            heap = self.ctx.pending.flush_dependency(
                self.ctx, heap, sig_ptr, dst_pe, proxy=self.proxy)
        heap, _, ok = signal_mod.signal_wait_until(
            self.ctx, heap, sig_ptr, dst_pe, "ge", expected)
        if not ok:
            return heap, None
        hdr = heap.read(self.pool.header_ptr(slot), dst_pe).tolist()
        tr = self._tracer()
        if tr is not None:
            pid, tid = self._track(dst_pe)
            tr.instant("admit", "kvx", pid, tid, rid=hdr[0], slot=slot,
                       expected_signal=expected)
            tr.flow_end(hdr[0], "migration", pid, tid)
        return heap, {"req_id": hdr[0], "prompt_len": hdr[1],
                      "first_token": hdr[2], "n_blocks": hdr[3]}

    def try_admit_fused(self, heap, slot: int, dst_pe: int, n_wire: int):
        """First-block admission for a ``migrate_fused`` hand-off: the
        decode-side work-group waits for ``fused_admit_signal(n_wire)``
        through the minimal-prefix device wait, so the modeled comm clock
        charges one block of wire time instead of the whole request.
        Returns ``(heap, header|None, blocks_resident)``."""
        sig_ptr = self.pool.sig_ptr(slot)
        if self.proxy is not None:
            # cross-pod wire traffic drains through the ring, which drains
            # whole: fused admission degrades to the dependency flush there
            heap = self.ctx.pending.flush_dependency(
                self.ctx, heap, sig_ptr, dst_pe, proxy=self.proxy)
        wg = device_mod.work_group(self.ctx, size=self.work_items, pe=dst_pe)
        heap, cur, ok = device_mod.signal_wait_until(
            wg, heap, sig_ptr, dst_pe, "ge", fused_admit_signal(n_wire))
        resident = max(0, int(cur) - EXTRA_SIGNALS)
        if not ok:
            return heap, None, resident
        hdr = heap.read(self.pool.header_ptr(slot), dst_pe).tolist()
        tr = self._tracer()
        if tr is not None:
            pid, tid = self._track(dst_pe)
            tr.instant("admit_fused", "kvx", pid, tid, rid=hdr[0], slot=slot,
                       expected_signal=fused_admit_signal(n_wire),
                       resident=resident)
            tr.flow_end(hdr[0], "migration", pid, tid)
        return heap, {"req_id": hdr[0], "prompt_len": hdr[1],
                      "first_token": hdr[2], "n_blocks": hdr[3]}, resident

    def consume_blocks(self, heap, slot: int, dst_pe: int, have: int,
                       need: int, *, rid: Optional[int] = None):
        """Per-block device waits: block k of a fused migration is readable
        once ``sig >= EXTRA_SIGNALS + k``.  Waits blocks ``have+1 .. need``
        in order, each forcing only the minimal queue prefix that delivers
        it.  Returns ``(heap, blocks_now_resident)``."""
        sig_ptr = self.pool.sig_ptr(slot)
        wg = device_mod.work_group(self.ctx, size=self.work_items, pe=dst_pe)
        resident = have
        for k in range(have + 1, need + 1):
            heap, _, ok = device_mod.signal_wait_until(
                wg, heap, sig_ptr, dst_pe, "ge", EXTRA_SIGNALS + k)
            if not ok:
                break
            resident = k
        tr = self._tracer()
        if tr is not None and rid is not None and resident > have:
            pid, tid = self._track(dst_pe)
            tr.instant("consume", "kvx", pid, tid, rid=rid,
                       blocks=resident - have, resident=resident)
        return heap, resident

    def gather_tail(self, heap, slot: int, pe: int):
        """Decode-side read of an admitted request's tail vector."""
        return heap.read(self.pool.tail_ptr(slot), pe)

    def gather(self, heap, req_id: int, slot: int, pe: int):
        """Decode-side read of an admitted request's block payloads (token
        order) and tail from this PE's own pool row: the dense-rehydrate
        admission.  Paged decode reads the blocks in place instead."""
        payloads = [heap.read(self.pool.block_ptr(i), pe)
                    for i in self.pool.blocks_of(req_id)]
        return payloads, heap.read(self.pool.tail_ptr(slot), pe)

    def release_tail(self, req_id: int) -> None:
        self._staged_tails.pop(req_id, None)

    def has_tail(self, req_id: int) -> bool:
        return req_id in self._staged_tails

    def reset_slot(self, heap, slot: int, pe: int):
        """Re-arm a slot: zero its signal word (a local store)."""
        return self.reset_signal(heap, self.pool.sig_ptr(slot), pe)

    def reset_signal(self, heap, sig_ptr, pe: int):
        """Zero a signal word (a recycled parked-stream signal too)."""
        return rma.p(self.ctx, heap, sig_ptr, 0, pe, src_pe=pe)
