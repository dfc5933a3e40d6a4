"""Disaggregated continuous-batching scheduler.

Counterpart of ``repro/serve/scheduler.py`` in its default mode: a FCFS
request queue feeding a fleet of prefill PEs, whole-prefill paged-KV
migration to decode PEs (``serve/kvxfer.py``), signal-threshold-gated
admission into decode slots, paged decode straight out of the block pool
(``serve/paged_attn.py``), slot rotation and eviction back to the pool.

Request states: QUEUED --prefill+stage--> STAGED --migrate(nbi)-->
MIGRATING --signal >= threshold--> DECODING --max_new/eos--> FINISHED.

One ``step()`` advances every stage once, in the order prefill, admit,
decode: a migration issued this step stays pending (deferred nbi traffic)
while decode keeps stepping resident requests, and only pays its flush when
its slot admits.

``fused_attn=True`` switches to the device-initiated fused protocol:
migrations send tail + header first and then one signal per block
(``KVMigrator.migrate_fused``), admission gates on the FIRST resident block
(``try_admit_fused``), and before each decode step the decode PE consumes
the blocks still on the wire through per-block device waits
(``consume_blocks``).  Decode reads the same bytes, so its tokens equal the
barrier protocol's; the first block is observed resident earlier
(``SchedStats.ttfd_first_block_steps``).

Other modes of the reference raise ``NotImplementedError`` naming the
ROADMAP item that brings them: chunked streaming, shared prefixes, dense
rehydrate, admission policies, preemption and recovery.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve import kvpool as kvpool_mod
from repro_torch.serve.engine import Engine, ServeConfig, seeded
from repro_torch.serve.kvxfer import EXTRA_SIGNALS, KVMigrator, \
    fused_admit_signal
from repro_torch.serve.paged_attn import PagedDecodeView

QUEUED, STAGED, MIGRATING, DECODING, FINISHED = (
    "queued", "staged", "migrating", "decoding", "finished")


@dataclasses.dataclass
class Request:
    rid: int
    batch: dict                     # {"tokens": (1,S)}
    max_new: int
    state: str = QUEUED
    prefill_pe: int = -1
    decode_pe: int = -1
    slot: int = -1
    first_token: int = -1
    expected_sig: int = 0
    out: List[int] = dataclasses.field(default_factory=list)
    submit_step: int = -1
    arrival_step: int = -1
    prefill_step: int = -1
    migrate_step: int = -1
    admit_step: int = -1
    finish_step: int = -1
    admit_ready_step: int = 0       # modeled wire latency gate
    # prefill result parked here while the request waits for pool blocks
    prefill_cache: Optional[dict] = None
    # fused protocol: wire blocks sent, blocks the decode side has still to
    # consume per signal, and the first step the first block was observed
    # resident (-1 = not yet)
    wire_blocks: int = 0
    fused_pending: int = 0
    first_block_step: int = -1
    # modeled comm clock at arrival / migration issue / admission
    t_arrival: float = 0.0
    t_submit: float = 0.0
    t_admit: float = 0.0
    trace_phase: Optional[str] = None

    @property
    def prompt_len(self) -> int:
        return int(self.batch["tokens"].shape[1])


@dataclasses.dataclass
class SchedStats:
    prefills: int = 0
    migrations: int = 0
    admissions: int = 0
    evictions: int = 0
    decode_steps: int = 0
    decode_tokens: int = 0
    bytes_migrated: int = 0
    bytes_cross_pod: int = 0
    stalled_on_pool: int = 0        # prefills deferred because no free blocks
    stalled_on_slots: int = 0       # migrations deferred because no free slot
    ttfd_steps: List[int] = dataclasses.field(default_factory=list)
    ttfd_model_s: List[float] = dataclasses.field(default_factory=list)
    ttfd_first_block_steps: List[int] = dataclasses.field(
        default_factory=list)
    queue_delay_steps: List[int] = dataclasses.field(default_factory=list)
    ttfd_arrival_steps: List[int] = dataclasses.field(default_factory=list)
    ttfd_arrival_model_s: List[float] = dataclasses.field(
        default_factory=list)
    e2e_steps: List[int] = dataclasses.field(default_factory=list)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, "
                              f"item {item})")


class DisaggScheduler:
    """Drives prefill PEs, the migration engine, and decode slot banks."""

    def __init__(self, ctx, heap, engine: Engine, pool, migrator: KVMigrator,
                 *, prefill_pes: List[int], decode_pes: List[int],
                 num_slots: int, scfg: ServeConfig = ServeConfig(),
                 prefills_per_step: Optional[int] = None,
                 admit_delay_steps: int = 0, paged: bool = True,
                 stream_chunks: int = 0, fused_attn: bool = False,
                 shared_prefix: bool = False, policy=None):
        if fused_attn and not paged:
            raise ValueError("fused_attn requires paged decode (the fused "
                             "kernel gathers K/V straight from the pool)")
        if fused_attn and stream_chunks > 0:
            raise ValueError(
                "fused_attn and chunked streaming are mutually exclusive — "
                "per-block signals already stream at block granularity")
        if not paged:
            _not_ported("dense-rehydrate admission", "5b")
        if stream_chunks:
            _not_ported("chunked prefill streaming", "5b")
        if shared_prefix:
            _not_ported("shared-prefix block reuse", "5b")
        if policy is not None:
            _not_ported("admission policies and preemption", "10")
        if num_slots > pool.max_slots:
            raise ValueError(
                f"num_slots ({num_slots}) exceeds the pool's per-PE slot "
                f"regions (max_slots={pool.max_slots})")
        self.ctx = ctx
        self.heap = heap
        self.engine = engine
        self.pool = pool
        self.migrator = migrator
        self.prefill_pes = list(prefill_pes)
        self.decode_pes = list(decode_pes)
        self.scfg = scfg
        self.prefills_per_step = (len(self.prefill_pes)
                                  if prefills_per_step is None
                                  else prefills_per_step)
        # modeled wire latency in scheduler steps: a migration issued at
        # step N is first polled at step N + delay
        self.admit_delay_steps = admit_delay_steps
        self.fused_attn = fused_attn
        self.views: Dict[int, PagedDecodeView] = {
            pe: PagedDecodeView(pool, pe, num_slots) for pe in decode_pes}
        self.queue: deque = deque()
        self.requests: Dict[int, Request] = {}
        self.staged: deque = deque()            # blocks held, awaiting a slot
        self.migrating: List[Request] = []
        self.banks = {pe: engine.init_slots(num_slots) for pe in decode_pes}
        self.slot_req: Dict[int, List[Optional[int]]] = {
            pe: [None] * num_slots for pe in decode_pes}
        self.stats = SchedStats()
        self._rr_prefill = 0
        self._rr_decode = 0
        self._step = 0
        self._next_rid = 0
        self._trace_pid = f"pod{ctx.node_of(self.prefill_pes[0])}"

    # ------------------------------------------------------------- tracing
    def _tracer(self):
        tr = self.ctx.tracer
        return tr if tr.enabled else None

    def _trace_phase(self, req: Request, phase: Optional[str],
                     end_args: Optional[dict] = None, **begin_args) -> None:
        """Close the request's open lifeline span and open ``phase``."""
        tr = self._tracer()
        if tr is None:
            return
        if req.trace_phase is not None:
            tr.async_end(req.trace_phase, "req", req.rid, self._trace_pid,
                         "requests", **(end_args or {}))
        req.trace_phase = phase
        if phase is not None:
            tr.async_begin(phase, "req", req.rid, self._trace_pid,
                           "requests", **begin_args)

    # ------------------------------------------------------------- intake
    def submit(self, batch: dict, *, max_new: Optional[int] = None) -> int:
        """Enqueue one request ({"tokens": (1,S)})."""
        if max_new is None:
            max_new = self.scfg.max_new_tokens
        S = int(batch["tokens"].shape[1])
        if S + max_new > self.engine.max_len + 1:
            raise ValueError(
                f"prompt ({S}) + max_new ({max_new}) exceeds the decode "
                f"cache (max_len={self.engine.max_len})")
        need = self.pool.layout.blocks_for_decode(S, max_new)
        if need > self.pool.num_blocks:
            raise ValueError(
                f"request needs {need} KV blocks but the pool holds only "
                f"{self.pool.num_blocks} — no schedule can ever admit it")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, batch=batch, max_new=max_new)
        req.submit_step = req.arrival_step = self._step
        req.t_arrival = self._comm_clock()
        self.requests[rid] = req
        self.queue.append(req)
        self._trace_phase(req, "queued", prompt_len=S, max_new=max_new)
        return rid

    def _comm_clock(self) -> float:
        """Modeled comm seconds, excluding the migrator's advisory
        per-block records (the flush charges the real transfer)."""
        advisory = sum(
            b.time_total for k, b in self.ctx.telemetry.buckets.items()
            if k[0] == "kvxfer_block")
        return self.ctx.total_time() - advisory

    # -------------------------------------------------------------- phases
    def _next_prefill_pe(self) -> int:
        pe = self.prefill_pes[self._rr_prefill % len(self.prefill_pes)]
        self._rr_prefill += 1
        return pe

    def _phase_prefill(self) -> None:
        """Retry slot assignment for staged requests, then prefill queued
        requests (FCFS) on prefill PEs round-robin, staging and migrating
        each."""
        for _ in range(len(self.staged)):
            self._try_migrate(self.staged.popleft())
        for _ in range(self.prefills_per_step):
            if not self.queue:
                return
            req = self.queue.popleft()
            if req.prefill_cache is None:            # not prefilled yet
                pe = self._next_prefill_pe()
                req.prefill_pe = pe
                req.prefill_step = self._step
                self.stats.queue_delay_steps.append(
                    self._step - req.arrival_step)
                self._trace_phase(
                    req, "prefill",
                    end_args={"queue_steps": self._step - req.arrival_step},
                    pe=pe)
                tr = self._tracer()
                if tr is not None:
                    tr.begin("prefill", "sched", self._trace_pid, f"pe{pe}",
                             rid=req.rid, prompt_len=req.prompt_len)
                gen = (seeded(self.engine.device, self.scfg.seed, req.rid)
                       if self.scfg.temperature > 0 else None)
                req.first_token, _, req.prefill_cache = \
                    self.engine.prefill_request(req.batch, gen,
                                                self.scfg.temperature)
                self.stats.prefills += 1
                if tr is not None:
                    tr.end("prefill", "sched", self._trace_pid, f"pe{pe}")
            if not self._stage(req):                 # pool exhausted: park
                self.stats.stalled_on_pool += 1      # the prefilled request
                self.queue.appendleft(req)
                return

    def _stage(self, req: Request) -> bool:
        """Stage a prefilled request into the pool, all or nothing."""
        n_table = self.pool.layout.blocks_for_decode(req.prompt_len,
                                                     req.max_new)
        if n_table > self.pool.free_blocks():
            return False
        self.heap, ids = self.migrator.stage(
            self.heap, req.rid, req.prefill_cache,
            prompt_len=req.prompt_len, src_pe=req.prefill_pe,
            max_new=req.max_new)
        assert ids is not None       # free-list headroom checked above
        req.prefill_cache = None                 # staged in the pool now
        req.state = STAGED
        self._trace_phase(req, "staged", pe=req.prefill_pe)
        self._try_migrate(req)
        return True

    def _pick_slot(self):
        """Next (decode_pe, slot) with no resident request, round-robin."""
        n = len(self.decode_pes)
        for k in range(n):
            pe = self.decode_pes[(self._rr_decode + k) % n]
            for s, owner in enumerate(self.slot_req[pe]):
                if owner is None:
                    self._rr_decode += k + 1
                    return pe, s
        return None, None

    def _try_migrate(self, req: Request) -> None:
        """Put a staged request on the wire into a free (decode PE, slot)."""
        pe, slot = self._pick_slot()
        if slot is None:
            self.stats.stalled_on_slots += 1
            self.staged.append(req)
            return
        req.decode_pe, req.slot = pe, slot
        self.slot_req[pe][slot] = req.rid
        send = (self.migrator.migrate_fused if self.fused_attn
                else self.migrator.migrate)
        self.heap, report = send(
            self.heap, req.rid, src_pe=req.prefill_pe, dst_pe=pe, slot=slot,
            prompt_len=req.prompt_len, first_token=req.first_token)
        delay = self.admit_delay_steps
        if self.fused_attn:
            # the modeled wire window covers only what admission waits for:
            # tail + header + the first block
            total = report.n_wire + EXTRA_SIGNALS
            delay = delay * fused_admit_signal(report.n_wire) // total
        req.expected_sig = report.expected_signal
        req.wire_blocks = report.n_wire
        req.state = MIGRATING
        req.migrate_step = self._step
        req.admit_ready_step = self._step + delay
        req.t_submit = self._comm_clock()
        self._trace_phase(req, "migrating", src_pe=report.src_pe,
                          dst_pe=report.dst_pe, tier=report.tier,
                          bytes=report.bytes_total, bytes_dcn=report.bytes_dcn,
                          wire_steps=delay,
                          protocol="fused" if self.fused_attn else "barrier")
        self.migrating.append(req)
        self.stats.migrations += 1
        self.stats.bytes_migrated += report.bytes_total
        self.stats.bytes_cross_pod += report.bytes_dcn

    # ----------------------------------------------------------- admission
    def _poll_first_block(self, req: Request) -> None:
        """Record the first step the request's first wire block is
        provably resident: a non-forcing read of the signal word (another
        admission's flush may have completed this request's prefix).  Wire
        order sets the threshold: barrier migrations send blocks first
        (``sig >= 1``), fused ones tail + header first
        (``sig >= EXTRA_SIGNALS + 1``)."""
        if req.first_block_step >= 0 or req.wire_blocks == 0:
            return
        cur = self.heap.read(self.pool.sig_ptr(req.slot), req.decode_pe)
        thr = EXTRA_SIGNALS + 1 if self.fused_attn else 1
        if int(cur) >= thr:
            req.first_block_step = self._step

    def _phase_admit(self) -> None:
        """A MIGRATING request enters its decode slot once
        ``signal_wait_until`` observes its threshold: the whole request's
        under the barrier protocol, the first block's in fused mode."""
        still = []
        for req in self.migrating:
            self._poll_first_block(req)
            if self._step < req.admit_ready_step:
                still.append(req)               # wire still "in flight"
                continue
            if self.fused_attn:
                self.heap, hdr, resident = self.migrator.try_admit_fused(
                    self.heap, req.slot, req.decode_pe, req.wire_blocks)
                if hdr is not None:
                    req.fused_pending = req.wire_blocks - resident
            else:
                self.heap, hdr = self.migrator.try_admit(
                    self.heap, req.slot, req.decode_pe, req.expected_sig)
            if hdr is None:
                still.append(req)
                continue
            if hdr["req_id"] != req.rid:
                raise RuntimeError(f"slot {req.slot} header names request "
                                   f"{hdr['req_id']}, expected {req.rid}")
            # the pool row IS the decode KV cache: only the non-paged tail
            # enters the slot bank
            bank = self.banks[req.decode_pe]
            tail = self.migrator.gather_tail(self.heap, req.slot,
                                             req.decode_pe)
            bank = dataclasses.replace(bank, cache=kvpool_mod.insert_tail(
                self.pool.layout, bank.cache, req.slot, tail))
            growth = [i for i in self.pool.blocks_of(req.rid)
                      if self.pool.home_of(i) is None]
            self.heap = self.views[req.decode_pe].attach(
                self.heap, req.slot, req.rid, fresh_ids=growth)
            self.banks[req.decode_pe] = self.engine.activate_slot(
                bank, req.slot, pos=hdr["prompt_len"],
                token=hdr["first_token"])
            req.state = DECODING
            req.out.append(hdr["first_token"])
            req.admit_step = self._step
            req.t_admit = self._comm_clock()
            if req.first_block_step < 0:
                req.first_block_step = self._step
            self.stats.ttfd_first_block_steps.append(
                req.first_block_step - req.arrival_step)
            self._trace_phase(
                req, "decoding",
                end_args={"wire_model_s": req.t_admit - req.t_submit,
                          "ttfd_steps": req.admit_step - req.arrival_step},
                pe=req.decode_pe, slot=req.slot)
            self.stats.admissions += 1
            self.stats.ttfd_steps.append(req.admit_step - req.submit_step)
            self.stats.ttfd_model_s.append(req.t_admit - req.t_submit)
            self.stats.ttfd_arrival_steps.append(
                req.admit_step - req.arrival_step)
            self.stats.ttfd_arrival_model_s.append(
                req.t_admit - req.t_arrival)
            self._maybe_finish(req)
        self.migrating = still

    def _consume_fused(self, pe: int) -> None:
        """Per-block device waits for every fused-admitted slot on this PE
        with blocks still on the wire.  Decode attends over the whole
        prompt, so every pending block is consumed before the gather reads
        it; each wait forces only the minimal queue prefix that delivers
        its block."""
        for rid in self.slot_req[pe]:
            if rid is None:
                continue
            req = self.requests[rid]
            if req.state != DECODING or req.fused_pending <= 0:
                continue
            have = req.wire_blocks - req.fused_pending
            self.heap, resident = self.migrator.consume_blocks(
                self.heap, req.slot, pe, have, req.wire_blocks, rid=rid)
            req.fused_pending = req.wire_blocks - resident
            if req.fused_pending > 0:
                raise RuntimeError(
                    f"rid {rid}: {req.fused_pending} fused blocks never "
                    f"landed — decode would read unmigrated bytes")

    def _phase_decode(self) -> None:
        """One decode step over every decode PE with an active slot."""
        stepped = False
        tr = self._tracer()
        for pe in self.decode_pes:
            bank = self.banks[pe]
            if not bank.active.any():
                continue
            if self.fused_attn:
                self._consume_fused(pe)
            if tr is not None:
                tr.begin("decode", "sched", self._trace_pid, f"pe{pe}",
                         slots=int(bank.active.sum()))
            gen = (seeded(self.engine.device, self.scfg.seed,
                          10_000 + self._step, pe)
                   if self.scfg.temperature > 0 else None)
            bank, toks, self.heap = self.engine.decode_slots_paged(
                bank, gen, self.ctx, self.heap, self.views[pe],
                self.scfg.temperature)
            self.banks[pe] = bank
            stepped = True
            if tr is not None:
                tr.end("decode", "sched", self._trace_pid, f"pe{pe}")
            toks = toks.tolist()
            for s, rid in enumerate(self.slot_req[pe]):
                if rid is None or self.requests[rid].state != DECODING:
                    continue
                req = self.requests[rid]
                req.out.append(toks[s])
                self.stats.decode_tokens += 1
                self._maybe_finish(req)
        if stepped:
            self.stats.decode_steps += 1

    def _maybe_finish(self, req: Request) -> None:
        eos_hit = (self.scfg.eos_id >= 0
                   and req.out and req.out[-1] == self.scfg.eos_id)
        if len(req.out) >= req.max_new or eos_hit:
            # same output contract as Engine.generate: eos is emitted, the
            # remainder zero-pads to max_new
            req.out = (req.out[:req.max_new]
                       + [0] * (req.max_new - len(req.out)))
            req.state = FINISHED
            req.finish_step = self._step
            self.stats.e2e_steps.append(req.finish_step - req.arrival_step)
            self._trace_phase(
                req, None,
                end_args={"outcome": "finished",
                          "decode_steps": req.finish_step - req.admit_step,
                          "tokens": len(req.out)})
            self._evict(req)

    def _evict(self, req: Request) -> None:
        """Return the request's blocks, re-arm its slot signal, free the
        slot."""
        self.views[req.decode_pe].detach(req.slot)
        self.pool.release(req.rid)
        self.heap = self.migrator.reset_slot(self.heap, req.slot,
                                             req.decode_pe)
        self.migrator.release_tail(req.rid)
        self.banks[req.decode_pe] = self.engine.evict_slot(
            self.banks[req.decode_pe], req.slot)
        self.slot_req[req.decode_pe][req.slot] = None
        self.stats.evictions += 1

    # --------------------------------------------------------------- drive
    def step(self) -> None:
        """Advance every pipeline stage once."""
        tr = self._tracer()
        if tr is not None:
            tr.clock.set_step(self._step)
        self._phase_prefill()
        self._phase_admit()
        self._phase_decode()
        self._step += 1

    def done(self) -> bool:
        return (not self.queue and not self.staged and not self.migrating
                and all(r.state == FINISHED for r in self.requests.values()))

    def run(self, *, max_steps: int = 10_000) -> Dict[int, np.ndarray]:
        """Drive until every submitted request finishes; returns
        {rid: generated token ids}."""
        while not self.done():
            if self._step >= max_steps:
                raise RuntimeError(f"scheduler wedged after {max_steps} steps")
            self.step()
        return {rid: np.asarray(r.out, np.int32)
                for rid, r in self.requests.items()}
