"""Online invariant auditors: the serving protocol's rules, checked against
a *live* fleet every N steps.

Counterpart of ``repro/obs/audit.py`` (the rules of its DESIGN.md
§8-§13), rule for rule.  On the card the heap's pools stay there: a pass
gathers the signal words it reads with one index op on the int32 pool and
one transfer, and compares resident prefix blocks with their home rows on
the device (``torch.equal``), so it never copies a whole pool to the host.

Each auditor is a pure read of host-side control-plane state (plus signal
words and — optionally — resident block bytes off the symmetric heap); it
never mutates anything, so auditing on cannot perturb outputs.  Violations
come back as structured :class:`AuditViolation` records; the fleet driver's
``Obs(audit_period=N)`` hook raises them bundled in an :class:`AuditError`
(after triggering a flight-recorder postmortem dump when one is armed).

Auditor families:

- **heap** — free-extent sanity on every dtype pool: sorted, positive,
  non-overlapping, coalesced, inside the allocation cursor.
- **refcount** — block-reference conservation over the KV pool: every
  block's refcount equals (tables mapping it) + (1 if a prefix entry owns
  it) + (COW reserves targeting it, in views or parked ``cow_plan``s); the
  free list is exactly the refcount-zero set; entry ``refs`` equals its
  live mappers.
- **signal** — signal-ledger vs CompletionQueue consistency: folding the
  pending SIGNAL ops over a word's current value must land exactly on what
  the migration protocol issued (slot words: ``expected_signal``; stream
  words: blocks sent so far), and the *current* value never exceeds it —
  i.e. no block is readable before its signal.
- **residency** — prefix-index residency agreement: every (PE, block) the
  index claims resident is an entry block, still referenced, and (deep
  mode) its bytes at that PE equal the home PE's staged payload.
- **slots** — slot-bank vs scheduler-state agreement: slot ownership,
  bank ``active`` masks, and paged-view attachments all tell one story.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

__all__ = ["AuditViolation", "AuditError", "FleetAuditor", "AUDITORS"]

#: auditor family names, in run order
AUDITORS = ("heap", "refcount", "signal", "residency", "slots")


@dataclasses.dataclass(frozen=True)
class AuditViolation:
    """One broken invariant: which auditor, which rule, where, and what."""
    auditor: str                  # family (see AUDITORS)
    rule: str                     # short invariant id, e.g. "refcount-conservation"
    detail: str                   # human-readable account
    subject: dict                 # structured locus ({"block": 5}, {"pe", "slot"}, ...)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class AuditError(RuntimeError):
    """Raised by the enforcing hook when an audit pass found violations."""

    def __init__(self, violations: List[AuditViolation]):
        self.violations = list(violations)
        heads = "; ".join(f"[{v.auditor}/{v.rule}] {v.detail}"
                          for v in self.violations[:3])
        more = ("" if len(self.violations) <= 3
                else f" (+{len(self.violations) - 3} more)")
        super().__init__(
            f"{len(self.violations)} invariant violation(s): {heads}{more}")


def _v(auditor: str, rule: str, detail: str, **subject) -> AuditViolation:
    return AuditViolation(auditor=auditor, rule=rule, detail=detail,
                          subject=subject)


def _read_words(heap, reads) -> List[int]:
    """Current values of scalar heap words, ``reads`` a list of ``(ptr,
    pe)``: one gather and one transfer per dtype pool touched, so a pass
    never syncs the device once per word nor copies a pool whole."""
    out: List[int] = [0] * len(reads)
    by_dtype: Dict[str, List[int]] = {}
    for i, (ptr, _) in enumerate(reads):
        by_dtype.setdefault(ptr.dtype, []).append(i)
    for dt, idx in by_dtype.items():
        pool = heap.pools[dt]
        rows = torch.tensor([int(reads[i][1]) for i in idx],
                            device=pool.device)
        cols = torch.tensor([reads[i][0].offset for i in idx],
                            device=pool.device)
        for i, v in zip(idx, pool[rows, cols].tolist()):
            out[i] = int(v)
    return out


class FleetAuditor:
    """Run every auditor family against a live Fleet.

    ``deep_residency`` additionally compares resident block *bytes* against
    the home PE's staged payload (exact, but touches heap rows — leave on
    for CI-sized pools, off for large production sweeps).
    """

    def __init__(self, *, deep_residency: bool = True):
        self.deep_residency = deep_residency
        self.checks = 0               # audit passes run
        self.violation_count = 0      # total violations across passes
        self.audit_seconds = 0.0      # host time spent auditing (bench gate)

    # ------------------------------------------------------------- driving
    def audit(self, fleet) -> List[AuditViolation]:
        """One full pass; returns (and counts) violations, never raises."""
        t0 = time.perf_counter()
        out: List[AuditViolation] = []
        out += self.audit_heap(fleet.heap)
        out += self.audit_refcounts(fleet)
        out += self.audit_signals(fleet)
        out += self.audit_residency(fleet)
        out += self.audit_slots(fleet)
        self.checks += 1
        self.violation_count += len(out)
        self.audit_seconds += time.perf_counter() - t0
        return out

    def enforce(self, fleet) -> None:
        """Audit and raise :class:`AuditError` on any violation."""
        violations = self.audit(fleet)
        if violations:
            raise AuditError(violations)

    def summary(self) -> dict:
        return {"checks": self.checks,
                "violations": self.violation_count,
                "audit_seconds": self.audit_seconds,
                "deep_residency": self.deep_residency}

    # ------------------------------------------------- heap extent sanity
    def audit_heap(self, heap) -> List[AuditViolation]:
        """Free-list extents per dtype pool: sorted, positive, disjoint,
        coalesced (``free`` always merges adjacent spans), and inside the
        allocation cursor — the §III-E allocator's conservation law."""
        out: List[AuditViolation] = []
        for dt, extents in getattr(heap, "_free", {}).items():
            cursor = heap._cursor.get(dt, 0)
            prev_end = None
            for off, sz in extents:
                if sz <= 0:
                    out.append(_v("heap", "heap-extent-empty",
                                  f"pool {dt}: zero/negative free extent "
                                  f"({off}, {sz})", dtype=dt, offset=off))
                if prev_end is not None and off < prev_end:
                    out.append(_v("heap", "heap-extent-overlap",
                                  f"pool {dt}: free extents overlap/unsorted "
                                  f"at offset {off} (prev end {prev_end})",
                                  dtype=dt, offset=off))
                elif prev_end is not None and off == prev_end:
                    out.append(_v("heap", "heap-extent-uncoalesced",
                                  f"pool {dt}: adjacent free extents never "
                                  f"merged at offset {off}",
                                  dtype=dt, offset=off))
                if off + sz > cursor:
                    out.append(_v("heap", "heap-extent-bounds",
                                  f"pool {dt}: free extent ({off}, {sz}) "
                                  f"past allocation cursor {cursor}",
                                  dtype=dt, offset=off))
                prev_end = off + sz if prev_end is None else max(prev_end,
                                                                 off + sz)
        return out

    # ------------------------------------------- block refcount conservation
    def audit_refcounts(self, fleet) -> List[AuditViolation]:
        """§9's ownership law: ``refcnt[b] == tables(b) + entry_own(b) +
        cow_holds(b)``, and the free list is exactly ``{b: refcnt == 0}``."""
        from repro_torch.serve.scheduler import TERMINAL

        out: List[AuditViolation] = []
        pool = fleet.pool
        expected = [0] * pool.num_blocks
        for ids in pool.block_tables.values():
            for b in ids:
                expected[b] += 1
        for entry in fleet.prefix_index.values():
            for b in entry.block_ids:
                expected[b] += 1                 # the entry's own reference
        for pod in fleet.pods:
            sched = pod.sched
            for req in sched.requests.values():
                if req.state in TERMINAL:
                    continue
                for tgt in req.cow_plan.values():
                    expected[tgt] += 1           # parked COW reservation
            for view in getattr(sched, "views", {}).values():
                for sm in view.slots.values():
                    for tgt in sm.cow.values():
                        expected[tgt] += 1       # armed COW reservation
        for b in range(pool.num_blocks):
            if pool._refcnt[b] != expected[b]:
                out.append(_v("refcount", "refcount-conservation",
                              f"block {b}: refcount {pool._refcnt[b]} but "
                              f"{expected[b]} accounted reference(s)",
                              block=b, refcount=pool._refcnt[b],
                              expected=expected[b]))
        free = set(pool._free)
        if len(free) != len(pool._free):
            out.append(_v("refcount", "free-list-duplicate",
                          "free list holds duplicate block ids",
                          free_len=len(pool._free)))
        zero = {b for b in range(pool.num_blocks) if pool._refcnt[b] == 0}
        for b in sorted(free - zero):
            out.append(_v("refcount", "free-list-referenced",
                          f"block {b} on the free list with refcount "
                          f"{pool._refcnt[b]}", block=b))
        for b in sorted(zero - free):
            out.append(_v("refcount", "free-list-leak",
                          f"block {b} has refcount 0 but never returned to "
                          f"the free list", block=b))
        # prefix entry refs == live (non-terminal) mappers
        mappers: Dict[tuple, int] = {}
        for pod in fleet.pods:
            for req in pod.sched.requests.values():
                if req.prefix_key is not None and req.state not in TERMINAL:
                    mappers[req.prefix_key] = mappers.get(req.prefix_key,
                                                          0) + 1
        for key, entry in fleet.prefix_index.items():
            live = mappers.get(key, 0)
            if entry.refs != live:
                out.append(_v("refcount", "prefix-refs",
                              f"prefix entry {key!r:.40}: refs "
                              f"{entry.refs} but {live} live mapper(s)",
                              refs=entry.refs, mappers=live))
        return out

    # --------------------------------------------- signal ledger vs queue
    @staticmethod
    def _eventual(ctx, ptr, pe: int, cur: int) -> tuple:
        """(current, eventual) value of a signal word: ``cur``, its value
        now, and the value after every pending SIGNAL op targeting it is
        applied in queue order, the ledger the protocol issued."""
        from repro_torch.core import pending as pending_mod

        val = torch.tensor(cur, dtype=torch.int64)
        for op in ctx.pending.ops:
            if (op.kind == pending_mod.SIGNAL and op.pe == pe
                    and op.ptr.dtype == ptr.dtype
                    and op.ptr.offset == ptr.offset):
                val = op.apply(val)
        return cur, int(val)

    def audit_signals(self, fleet) -> List[AuditViolation]:
        """§10/§12's data-before-flag law, host-checkable form: for every
        live signal word, ``current + pending == issued`` (no lost or
        duplicated signal) and ``current <= issued`` (the word never
        advances past what the migrator sent — a block readable before its
        signal would show up as exactly that overrun).  The words are
        gathered first, in one read per pool, then checked in the
        reference's order."""
        from repro_torch.serve.scheduler import (DECODING, MIGRATING, PARKED,
                                                 STREAMING, TERMINAL)

        ctx, heap, pool = fleet.ctx, fleet.heap, fleet.pool
        # (kind, pod, pe, slot or request, rid, issued, ptr)
        words = []
        for pod in fleet.pods:
            sched = pod.sched
            streaming_mode = sched.stream_chunks > 0
            for pe in sched.decode_pes:
                for slot, rid in enumerate(sched.slot_req[pe]):
                    req = (sched.requests.get(rid)
                           if rid is not None else None)
                    if req is None or streaming_mode:
                        # free slot — or stream mode, where the wire rides
                        # the stream word and the slot word stays zero
                        issued = 0
                    elif req.preemptions > 0:
                        # a resumed request re-binds a slot WITHOUT
                        # re-migration (its blocks never left the pool):
                        # the preempt path consumed every in-flight block
                        # and re-armed the word, so nothing was issued
                        # against this binding
                        issued = 0
                    else:
                        issued = req.expected_sig
                    words.append(("slot", pod, pe, slot, rid, issued,
                                  pool.sig_ptr(slot)))
            # stream words of slot-less in-flight requests
            for req in sched.requests.values():
                if req.state in TERMINAL or req.park_sig < 0:
                    continue
                if req.state in (STREAMING, PARKED):
                    issued = req.stream.sent if req.stream is not None else 0
                elif req.state == MIGRATING:
                    issued = req.expected_sig
                elif req.state == DECODING:
                    continue                      # word recycled at admit
                else:
                    continue
                words.append(("stream", pod, req.decode_pe, req, req.rid,
                              issued, pool.stream_sig_ptr(req.park_sig)))
        values = _read_words(heap, [(w[6], w[2]) for w in words])
        out: List[AuditViolation] = []
        for (kind, pod, pe, where, rid, issued, ptr), now in zip(words,
                                                                 values):
            cur, ev = self._eventual(ctx, ptr, pe, now)
            if kind == "slot":
                slot = where
                if ev != issued:
                    out.append(_v(
                        "signal", "signal-ledger",
                        f"{pod.name} pe{pe} slot {slot}: signal word "
                        f"reads {cur} (+pending -> {ev}) but the "
                        f"protocol issued {issued}",
                        pod=pod.name, pe=pe, slot=slot, current=cur,
                        eventual=ev, issued=issued, rid=rid))
                elif cur > issued:
                    out.append(_v(
                        "signal", "signal-overrun",
                        f"{pod.name} pe{pe} slot {slot}: signal word "
                        f"at {cur} exceeds the {issued} issued — block "
                        f"readable before its signal",
                        pod=pod.name, pe=pe, slot=slot, current=cur,
                        issued=issued, rid=rid))
                continue
            req = where
            if ev != issued:
                out.append(_v(
                    "signal", "signal-ledger",
                    f"{pod.name} rid {req.rid} stream word "
                    f"{req.park_sig}@pe{pe}: reads {cur} (+pending -> "
                    f"{ev}) but the stream issued {issued}",
                    pod=pod.name, pe=pe, stream=req.park_sig,
                    current=cur, eventual=ev, issued=issued,
                    rid=req.rid))
            elif cur > issued:
                out.append(_v(
                    "signal", "signal-overrun",
                    f"{pod.name} rid {req.rid} stream word "
                    f"{req.park_sig}@pe{pe}: at {cur}, past the "
                    f"{issued} issued", pod=pod.name, pe=pe,
                    stream=req.park_sig, current=cur, issued=issued,
                    rid=req.rid))
        return out

    # ------------------------------------------ prefix residency agreement
    def audit_residency(self, fleet) -> List[AuditViolation]:
        """§9.4's per-(PE, block) residency law: everything the prefix
        index claims resident is an entry block, still live, and actually
        carries the home PE's staged bytes (deep mode)."""
        out: List[AuditViolation] = []
        pool, heap = fleet.pool, fleet.heap
        for key, entry in fleet.prefix_index.items():
            ids = set(entry.block_ids)
            for pe, blocks in entry.resident.items():
                for b in sorted(blocks):
                    if b not in ids:
                        out.append(_v(
                            "residency", "residency-foreign-block",
                            f"prefix entry {key!r:.40}: block {b} recorded "
                            f"resident at pe{pe} but is not an entry block",
                            pe=pe, block=b))
                        continue
                    if pool.refcount(b) <= 0:
                        out.append(_v(
                            "residency", "residency-freed-block",
                            f"prefix entry {key!r:.40}: resident block {b} "
                            f"at pe{pe} has refcount "
                            f"{pool.refcount(b)}", pe=pe, block=b))
                        continue
                    if self.deep_residency and pe != entry.home_pe:
                        # the two rows compared where they lie: on the
                        # card, one flag comes back, not the block
                        ptr = pool.block_ptr(b)
                        if not torch.equal(heap.read(ptr, entry.home_pe),
                                           heap.read(ptr, pe)):
                            out.append(_v(
                                "residency", "residency-bytes",
                                f"prefix entry {key!r:.40}: block {b} "
                                f"recorded resident at pe{pe} but its bytes "
                                f"differ from home pe{entry.home_pe}",
                                pe=pe, block=b, home_pe=entry.home_pe))
        return out

    # --------------------------------------- slot bank / scheduler agreement
    def audit_slots(self, fleet) -> List[AuditViolation]:
        """§8's occupancy law: ``slot_req``, the engine slot bank's
        ``active`` mask, the paged view's attachments, and each request's
        (state, decode_pe, slot) all agree."""
        from repro_torch.serve.scheduler import DECODING, MIGRATING, PREEMPTED

        out: List[AuditViolation] = []
        for pod in fleet.pods:
            sched = pod.sched
            views = getattr(sched, "views", {})
            for pe in sched.decode_pes:
                bank = sched.banks[pe]
                view = views.get(pe)
                for slot, rid in enumerate(sched.slot_req[pe]):
                    active = bool(bank.active[slot])
                    if rid is None:
                        if active:
                            out.append(_v(
                                "slots", "slot-ghost-active",
                                f"{pod.name} pe{pe} slot {slot}: bank "
                                f"active with no owning request",
                                pod=pod.name, pe=pe, slot=slot))
                        if view is not None and slot in view.slots:
                            out.append(_v(
                                "slots", "slot-stale-view",
                                f"{pod.name} pe{pe} slot {slot}: paged view "
                                f"still attached (rid "
                                f"{view.slots[slot].req_id}) on a free slot",
                                pod=pod.name, pe=pe, slot=slot))
                        continue
                    req = sched.requests.get(rid)
                    if req is None:
                        out.append(_v("slots", "slot-unknown-owner",
                                      f"{pod.name} pe{pe} slot {slot}: "
                                      f"owner rid {rid} unknown",
                                      pod=pod.name, pe=pe, slot=slot,
                                      rid=rid))
                        continue
                    if req.slot != slot or req.decode_pe != pe:
                        out.append(_v(
                            "slots", "slot-owner-mismatch",
                            f"{pod.name} pe{pe} slot {slot}: owner rid "
                            f"{rid} believes it is at pe{req.decode_pe} "
                            f"slot {req.slot}", pod=pod.name, pe=pe,
                            slot=slot, rid=rid))
                    if req.state == DECODING and not active:
                        out.append(_v(
                            "slots", "slot-inactive-decoding",
                            f"{pod.name} pe{pe} slot {slot}: rid {rid} is "
                            f"DECODING but the bank slot is inactive",
                            pod=pod.name, pe=pe, slot=slot, rid=rid))
                    elif req.state == MIGRATING and active:
                        out.append(_v(
                            "slots", "slot-active-premature",
                            f"{pod.name} pe{pe} slot {slot}: rid {rid} "
                            f"still MIGRATING but the bank slot is active",
                            pod=pod.name, pe=pe, slot=slot, rid=rid))
                    elif req.state not in (DECODING, MIGRATING):
                        out.append(_v(
                            "slots", "slot-nonresident-owner",
                            f"{pod.name} pe{pe} slot {slot}: owner rid "
                            f"{rid} in state {req.state!r} cannot hold a "
                            f"slot", pod=pod.name, pe=pe, slot=slot,
                            rid=rid, state=req.state))
                    if (view is not None and req.state == DECODING
                            and sched.paged):
                        sm = view.slots.get(slot)
                        if sm is None or sm.req_id != rid:
                            out.append(_v(
                                "slots", "slot-view-mismatch",
                                f"{pod.name} pe{pe} slot {slot}: paged view "
                                f"maps {getattr(sm, 'req_id', None)!r}, "
                                f"scheduler says rid {rid}",
                                pod=pod.name, pe=pe, slot=slot, rid=rid))
            # the reverse direction: every slot-holding request is registered
            for req in sched.requests.values():
                if req.state == DECODING:
                    if (req.slot < 0
                            or sched.slot_req[req.decode_pe][req.slot]
                            != req.rid):
                        out.append(_v(
                            "slots", "slot-unregistered",
                            f"{pod.name} rid {req.rid} DECODING but not "
                            f"registered at pe{req.decode_pe} slot "
                            f"{req.slot}", pod=pod.name, rid=req.rid))
                elif req.state == PREEMPTED and req.slot != -1:
                    out.append(_v(
                        "slots", "slot-preempted-holding",
                        f"{pod.name} rid {req.rid} PREEMPTED but still "
                        f"holds slot {req.slot}", pod=pod.name,
                        rid=req.rid, slot=req.slot))
        return out
