"""KV-block recovery after a PE or pod failure (DESIGN.md §14).

Counterpart of ``repro/serve/recovery.py``: control plane only, over the
port's scheduler, pool and migrator, so the code is the reference's.

The failure model is fail-stop: a dead PE's heap row is garbage (the fleet
poisons it — ``serve.fault.scramble_rows``) and every pending op touching it
cancels with an error (``CompletionQueue.cancel_pe``).  Recovery is pure
control plane over the *surviving* rows:

- **decode-PE death** (:func:`recover_decode_pe`) — every request whose
  decode destination died loses the resident KV copies on that row, but the
  staged payloads on the prefill *home* rows are pristine (decode writeback
  is a local store on the decode row only).  A victim **re-migrates** when
  its retained staged tail, a live home for every prompt block, and a live
  prefill source still exist; otherwise it **recomputes** from the prompt.
  Either way the tokens decoded before the fault become a *replay target*:
  decode re-derives them and ``DisaggScheduler._emit_token`` asserts each
  one equal instead of appending — the surviving stream stays
  bitwise-identical to the no-fault run (greedy decoding).

- **prefill-PE death** (:func:`recover_prefill_pe`) — the staged payloads
  themselves died.  Requests still depending on that row's bytes (waiting
  states with blocks homed there, or a parked prefill cache) recompute;
  DECODING/PREEMPTED requests survive untouched — their KV is already
  resident at a live decode PE.  Prefix-index entries homed on the casualty
  are dropped (entry-owned refs released, every surviving mapper's
  ``prefix_key`` cleared) so no future migration reads the poisoned row.

- **whole-pod death** (:func:`adopt_pod`) — the pod's live requests are
  *adopted*: each non-terminal record is fully released, marked RECOVERED
  (terminal on the dead pod), and re-submitted on a surviving pod with its
  decoded-so-far tokens as the new record's replay target.  Frontend
  placements re-point to the adopting pod, so ``Fleet.outputs()`` keeps
  serving every spec.

Ledger contract: every path here keeps the invariants the reference's
auditors check true mid-failure — slot words are reset only on live rows
(dead rows leave the audited set when the PE leaves ``decode_pes``),
``preemptions`` is cleared on recovered requests (the signal audit treats a
preempted request's slot word as re-armed), residency claims for dead PEs
are purged, and refcounts stay exact through entry drops because the entry
own-ref and each mapper's table refs are released by their owners.
"""
from __future__ import annotations

from repro_torch.serve.scheduler import (DECODING, MIGRATING, PARKED,
                                         PREEMPTED, QUEUED, RECOVERED,
                                         RECOVERING, STAGED, STREAMING,
                                         TERMINAL)

#: waiting states whose KV still depends on prefill-side home rows — a dead
#: home forces these back through recompute (RECOVERING included so a second
#: fault mid-recovery re-classifies the victim instead of missing it)
_WAITING = (STAGED, STREAMING, PARKED, MIGRATING, RECOVERING)


# ---------------------------------------------------------------------------
# per-request teardown
# ---------------------------------------------------------------------------


def full_release(fleet, sched, req, heap):
    """Release every resource a request holds — block-table refs, COW
    reserves, prefix-entry ref, decode slot, stream signal, retained staged
    tail — resetting heap words only on live rows.  Refcount-exact: every
    pool invariant holds immediately after.  Returns the heap."""
    fault = fleet.ctx.fault
    pool, mig = sched.pool, sched.migrator
    pe, slot = req.decode_pe, req.slot
    if slot >= 0 and pe in sched.slot_req:
        view = sched.views.get(pe)
        if view is not None:
            sm = view.slots.get(slot)
            if sm is not None and sm.req_id == req.rid:
                # fold un-triggered COW reserves back for the release below
                req.cow_plan = {**view.detach_keep(slot), **req.cow_plan}
        if fault.alive(pe):
            heap = mig.reset_slot(heap, slot, pe)
            sched.banks[pe] = sched.engine.evict_slot(sched.banks[pe], slot)
        if sched.slot_req[pe][slot] == req.rid:
            sched.slot_req[pe][slot] = None
    if req.cow_plan:
        pool.release_ids(list(req.cow_plan.values()))
        req.cow_plan = {}
    pool.release(req.rid)
    if req.prefix_key is not None:
        entry = sched.prefix_index.get(req.prefix_key)
        if entry is not None:
            entry.refs -= 1
            if entry.refs <= 0:
                pool.release_ids(entry.block_ids)
                del sched.prefix_index[req.prefix_key]
        req.prefix_key = None
    req.shared_ids = []
    if req.park_sig >= 0:
        if fault.alive(req.decode_pe):
            heap = mig.reset_signal(
                heap, pool.stream_sig_ptr(req.park_sig), req.decode_pe)
        pool.free_stream_sig(req.park_sig)
        req.park_sig = -1
    mig.release_tail(req.rid)
    req.stream = None
    req.prefill_cache = None
    req.park_tail = None
    req.resume_pos = req.resume_tok = -1
    req.slot = -1
    req.decode_pe = -1
    req.prefill_pe = -1
    req.expected_sig = 0
    req.wire_blocks = 0
    req.fused_pending = 0
    req.first_block_step = -1
    req.preemptions = 0
    return heap


def _drop_waiting(sched, req) -> None:
    """Remove a victim from whichever scheduler container holds it."""
    for bag in (sched.streaming, sched.parked, sched.preempted,
                sched.migrating, sched.recovering, sched.staged,
                sched.queue):
        if req in bag:
            bag.remove(req)


def _mark_recovering(sched, req, step: int) -> None:
    """Park a victim for ``_phase_recover``: decoded-so-far tokens become
    the replay target and the recovery TTFD clock starts at ``step``."""
    req.replay_target = len(req.out)
    req.replayed = 0
    req.recoveries += 1
    req.recover_step = step
    req.state = RECOVERING
    sched.recovering.append(req)
    sched._trace_phase(req, "recovering",
                       end_args={"outcome": "fault"},
                       replay=req.replay_target)


# ---------------------------------------------------------------------------
# decode-PE death
# ---------------------------------------------------------------------------


def _can_remigrate(fleet, sched, req) -> bool:
    """A decode-death victim can re-send its staged KV iff every byte it
    needs still lives on a live row: the retained staged tail, a live home
    for every prompt block (a ``None`` home inside the prompt range means a
    fired COW whose only copy was the dead decode row), and a live prefill
    source PE for the tail/header sends.  Anything else recomputes."""
    if not sched.paged:
        return False                    # dense KV lived in the dead slot bank
    if not sched.migrator.has_tail(req.rid):
        return False
    if not fleet.ctx.fault.alive(req.prefill_pe):
        return False
    table = sched.pool.block_tables.get(req.rid)
    if not table:
        return False
    n_prompt = sched.pool.layout.blocks_for_prompt(req.prompt_len)
    for i, b in enumerate(table[:n_prompt]):
        home = sched.pool.home_of(b)
        if home is None or not fleet.ctx.fault.alive(home):
            return False
    return True


def recover_decode_pe(fleet, pod, pe: int, *, step: int) -> dict:
    """Retire a dead decode PE from its pod and recover every request whose
    decode destination it was.  Victims keep their block tables (and COW
    reserves) when re-migration is safe; otherwise they are fully released
    and recompute from the prompt.  Growth blocks are zeroed at re-attach
    and the replay rewrites every decode-position K/V, so the re-migrated
    stream is bitwise-identical (module docstring)."""
    sched = pod.sched
    heap = fleet.heap
    victims = [r for r in sched.requests.values()
               if r.decode_pe == pe
               and r.state in (STREAMING, PARKED, MIGRATING, DECODING,
                               PREEMPTED)]
    remigrated = recomputed = 0
    for req in victims:
        _drop_waiting(sched, req)
        view = sched.views.get(pe)
        if req.slot >= 0 and view is not None:
            sm = view.slots.get(req.slot)
            if sm is not None and sm.req_id == req.rid:
                req.cow_plan = {**view.detach_keep(req.slot), **req.cow_plan}
        if _can_remigrate(fleet, sched, req):
            # staged payloads + tail survive on live home rows: drop only
            # what was pinned to the dead row and let _phase_recover re-stage
            if req.park_sig >= 0:
                # the signal word lives on the dead row — no reset (the row
                # leaves the audited set); the id is safe to recycle because
                # a future stream targets a live row's word
                sched.pool.free_stream_sig(req.park_sig)
                req.park_sig = -1
            req.stream = None
            req.park_tail = None
            req.resume_pos = req.resume_tok = -1
            req.slot = -1
            req.decode_pe = -1
            req.expected_sig = 0
            req.wire_blocks = 0
            req.fused_pending = 0
            req.first_block_step = -1
            req.preemptions = 0
            remigrated += 1
        else:
            heap = full_release(fleet, sched, req, heap)
            recomputed += 1
        _mark_recovering(sched, req, step)
    sched.decode_pes.remove(pe)
    sched.banks.pop(pe, None)
    sched.slot_req.pop(pe, None)
    sched.views.pop(pe, None)
    for entry in sched.prefix_index.values():
        entry.resident.pop(pe, None)
    fleet.heap = heap
    return {"victims": len(victims), "remigrate": remigrated,
            "recompute": recomputed}


# ---------------------------------------------------------------------------
# prefill-PE death
# ---------------------------------------------------------------------------


def _sweep_dead_homes(fleet, dead_pes, *, step: int) -> int:
    """Cluster-wide sweep after prefill-side rows died: drop prefix-index
    entries whose payloads lived there, clear every surviving mapper's key,
    and recompute every waiting request whose table still depends on a dead
    home (the shared index spans pods, so victims can be anywhere).
    Returns the number of requests sent back through recovery."""
    dead = {int(p) for p in dead_pes}
    pool = fleet.pool
    doomed = [k for k, e in fleet.prefix_index.items()
              if e.home_pe in dead
              or any(pool.home_of(b) in dead for b in e.block_ids)]
    for k in doomed:
        entry = fleet.prefix_index.pop(k)
        pool.release_ids(entry.block_ids)
    if doomed:
        for pod in fleet.pods:
            for r in pod.sched.requests.values():
                if (r.prefix_key is not None
                        and r.prefix_key not in fleet.prefix_index):
                    r.prefix_key = None
                    r.shared_ids = []
    hit = 0
    for pod in fleet.pods:
        sched = pod.sched
        for r in list(sched.requests.values()):
            if r.state in _WAITING:
                table = pool.block_tables.get(r.rid) or []
                if (r.prefill_pe in dead
                        or any(pool.home_of(b) in dead for b in table)):
                    _drop_waiting(sched, r)
                    fleet.heap = full_release(fleet, sched, r, fleet.heap)
                    _mark_recovering(sched, r, step)
                    hit += 1
            elif (r.state == QUEUED and r.prefill_cache is not None
                    and r.prefill_pe in dead):
                # parked prefill result lived on the dead PE: re-run it
                r.prefill_cache = None
                r.prefill_pe = -1
    return hit


def recover_prefill_pe(fleet, pod, pe: int, *, step: int) -> dict:
    """Retire a dead prefill PE and recompute everything that still needed
    its row: staged payloads homed there (any pod — the prefix index is
    shared) and parked prefill caches.  DECODING/PREEMPTED requests ride
    through untouched: their KV is resident at a live decode PE."""
    pod.sched.prefill_pes.remove(pe)
    hit = _sweep_dead_homes(fleet, [pe], step=step)
    return {"victims": hit, "remigrate": 0, "recompute": hit}


# ---------------------------------------------------------------------------
# whole-pod adoption
# ---------------------------------------------------------------------------


def adopt_pod(fleet, dead_pod, *, step: int) -> int:
    """A whole pod died: surviving pods adopt its live requests.

    Every non-terminal record on the dead pod is fully released, marked
    RECOVERED (terminal — the adopted copy lives on under a new rid), and
    re-submitted on the least-loaded surviving pod with its original
    arrival time, SLO class, and decoded-so-far tokens as the new record's
    replay target.  Frontend placements re-point, so ``Fleet.outputs()``
    and the goodput report keep covering every spec.  Returns the number
    of requests adopted (shed-on-adoption rejections excluded)."""
    survivors = [p for p in fleet.pods if p is not dead_pod]
    if not survivors:
        raise RuntimeError(
            "whole-fleet failure: no surviving pod to adopt requests")
    dead_pes = [int(p) for p in dead_pod.team.pes()]
    sched = dead_pod.sched
    fleet.pods.remove(dead_pod)
    fleet.dead_pods.append(dead_pod)
    if dead_pod in fleet.router.pods:
        fleet.router.remove_pod(dead_pod)
    back = {(pn, rid): idx for idx, (pn, rid) in fleet.placements.items()}
    adopted = 0
    for old in list(sched.requests.values()):
        if old.state in TERMINAL:
            continue
        fleet.heap = full_release(fleet, sched, old, fleet.heap)
        old.state = RECOVERED
        old.finish_step = sched._step
        sched._trace_phase(old, None, end_args={"outcome": "recovered"})
        target = fleet.router._least_loaded()
        new_rid = target.sched.submit(
            old.batch, max_new=old.max_new, prefix_len=old.prefix_len,
            arrival_step=old.arrival_step, t_arrival=old.t_arrival,
            slo=old.slo)
        new = target.sched.requests[new_rid]
        if new.state not in TERMINAL:
            new.out = list(old.out)
            new.replay_target = len(old.out)
            new.replayed = 0
            new.recoveries = old.recoveries + 1
            new.recover_step = step
            adopted += 1
        idx = back.get((dead_pod.name, old.rid))
        if idx is not None:
            fleet.placements[idx] = (target.name, new_rid)
    # the dead scheduler never steps again: empty its live containers so
    # nothing aliases the adopted records (its request map stays for
    # report()/outputs() of pre-fault finishes)
    sched.queue.clear()
    sched.staged.clear()
    sched.streaming.clear()
    sched.parked.clear()
    sched.preempted.clear()
    sched.migrating.clear()
    sched.recovering.clear()
    # surviving pods may still map blocks homed on the dead pod's prefill
    # rows (shared prefixes travel cross-pod) — recompute those victims
    _sweep_dead_homes(fleet, dead_pes, step=step)
    for entry in fleet.prefix_index.values():
        for pe in dead_pes:
            entry.resident.pop(pe, None)
    return adopted
