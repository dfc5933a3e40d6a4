"""Disaggregated continuous-batching scheduler.

Counterpart of ``repro/serve/scheduler.py``: a request queue feeding a
fleet of prefill PEs, paged-KV migration to decode PEs
(``serve/kvxfer.py``), whole-prefill or chunked-streaming, signal-threshold
gated admission into decode slots, paged decode straight out of the block
pool (``serve/paged_attn.py``), shared-prefix block reuse with
copy-on-write, slot rotation, preemption and refcount-correct eviction.

Request states::

    QUEUED --prefill+stage--> STAGED --migrate(nbi)-----------> MIGRATING
        |                       \\--open_stream--> STREAMING --> PARKED
        |                                 (chunks drain slot-less;   |
        |                                  slot binds at close ------/
        |                                  tail+header -> MIGRATING)
        |--policy shed--> SHED
    MIGRATING --signal >= threshold--> DECODING --max_new/eos--> FINISHED
                 |   ^
        policy   v   | slot frees
             PREEMPTED (KV parked in the pool, slot surrendered)

Fault victims pass through RECOVERING (``serve/recovery.py``); a request
adopted by another pod after its pod died ends here as RECOVERED.

Admission is pluggable: shed-at-submit, which queued request prefills,
the order slot waiters bind and whether a decoding request is preempted
to free a slot all ask an :class:`AdmissionPolicy` (FCFS by default, with
no shedding and no preemption; ``serve/frontend/slo.py`` is the deadline
policy).  Preemption parks a DECODING request back into the pool: its
paged KV is already there, so only the non-paged tail is snapshotted, and
it resumes on the same decode PE at its exact cursor, so its tokens stay
bitwise an uninterrupted run's.

One ``step()`` advances every stage once, in the order recover, stream,
prefill, admit, resume, decode: a migration issued this step stays pending
(deferred nbi traffic) while decode keeps stepping resident requests, and a
streaming request's previous installment drains while its next one
"computes".
Streams are slot-less while draining (their blocks park in the pool against
a stream-signal word), so the admission flush pays only for the close's
tail + header: the ``ttfd_model_s`` win.

``shared_prefix=True`` maps the blocks of a prompt prefix that another
request registered (``submit(prefix_len=...)``) instead of staging and
sending them again; the first decode write into a shared block copies it
(copy-on-write).  ``paged=False`` is the dense-rehydrate A/B control:
admission gathers the payloads into the slot bank's dense cache and decode
reads that (``Engine.decode_slots``), so no block-table gather runs.

``fused_attn=True`` switches to the device-initiated fused protocol:
migrations send tail + header first and then one signal per block
(``KVMigrator.migrate_fused``), admission gates on the FIRST resident block
(``try_admit_fused``), and before each decode step the decode PE consumes
the blocks still on the wire through per-block device waits
(``consume_blocks``).  Decode reads the same bytes, so its tokens equal the
barrier protocol's; the first block is observed resident earlier
(``SchedStats.ttfd_first_block_steps``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.models.decode_graph import DecodeGraphTally
from repro_torch.obs import layerspans
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serve import kvpool as kvpool_mod
from repro_torch.serve.engine import Engine, ServeConfig, seeded
from repro_torch.serve.kvxfer import EXTRA_SIGNALS, KVMigrator, StreamState, \
    fused_admit_signal
from repro_torch.serve.paged_attn import PagedDecodeTally, PagedDecodeView

(QUEUED, STAGED, STREAMING, PARKED, MIGRATING, DECODING, PREEMPTED,
 FINISHED, SHED, RECOVERING, RECOVERED) = (
    "queued", "staged", "streaming", "parked", "migrating",
    "decoding", "preempted", "finished", "shed", "recovering", "recovered")

#: terminal states (``done()`` waits for every request to reach one);
#: RECOVERED is a record adopted by another pod, live there under a new rid
TERMINAL = (FINISHED, SHED, RECOVERED)


@dataclasses.dataclass
class Request:
    rid: int
    batch: dict                     # {"tokens": (1,S)} + frontend embeds
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
    slo: Optional[object] = None    # frontend deadline class (policy-owned)
    # prefill result parked here while the request waits for pool blocks
    prefill_cache: Optional[dict] = None
    # shared-prefix state: the declared prefix, its index key, the blocks
    # mapped from it, and the COW reserves (table index -> block) until
    # admission hands them to the decode view
    prefix_len: int = 0
    prefix_key: Optional[tuple] = None
    shared_ids: List[int] = dataclasses.field(default_factory=list)
    cow_plan: Dict[int, int] = dataclasses.field(default_factory=dict)
    stream: Optional[StreamState] = None
    park_sig: int = -1              # pool stream-signal id while slot-less
    # preemption snapshot: decode cursor and the non-paged tail (the paged
    # KV stays in the pool)
    resume_pos: int = -1
    resume_tok: int = -1
    park_tail: Optional[object] = None
    preemptions: int = 0
    # recovery: tokens decoded before a fault are replayed (held equal, not
    # appended) until ``replayed`` reaches ``replay_target``
    replay_target: int = 0
    replayed: int = 0
    recoveries: int = 0
    recover_step: int = -1          # fleet step of the fault
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
class PrefixEntry:
    """One registered shareable prefix: its blocks, where their staged
    payload lives, and which of them each decode PE already holds.
    Residency is per (PE, block): a shorter-prefix mapper carries only the
    entry's whole blocks, so a whole-prompt mapper admitted to the same PE
    later must still send the boundary block."""
    key: tuple
    block_ids: List[int]
    whole_prompt: bool              # ids include the partial boundary block
    home_pe: int
    resident: Dict[int, set]        # decode PE -> entry block ids landed there
    refs: int = 0                   # live requests mapping these blocks


class AdmissionPolicy:
    """Pluggable admission policy: the strict FCFS baseline, which never
    sheds, never reorders and never preempts.  The scheduler calls these
    hooks at every choice point (``serve/frontend/slo.py`` overrides
    them)."""

    def admit(self, req: Request, queue_len: int) -> bool:
        """Gate at submit time; False sheds the request (state SHED)."""
        return True

    def select(self, queue) -> int:
        """Index into the queue of the next request to prefill."""
        return 0

    def waiting_order(self, reqs: List[Request]) -> List[Request]:
        """Order in which slot waiters (parked streams, preempted
        requests) try to bind freed slots."""
        return list(reqs)

    def preempt_victim(self, req: Request,
                       decoding: List[Request]) -> Optional[Request]:
        """A slot-starved ``req`` may evict one of ``decoding``; return the
        victim or None.  Only paged decode can preempt."""
        return None


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
    stalled_on_streams: int = 0     # stream signals exhausted
    stream_chunks: int = 0          # mid-prefill wire installments issued
    prefix_hits: int = 0            # requests that mapped an existing prefix
    blocks_prefix_shared: int = 0   # physical blocks reused via incref
    bytes_wire_saved: int = 0       # resident-at-dst blocks never re-sent
    cow_copies: int = 0             # divergent writes that copied a block
    sheds: int = 0                  # requests rejected by the policy
    preempts: int = 0               # decoding requests parked back to pool
    resumes: int = 0                # preempted requests re-bound to a slot
    remigrated: int = 0             # recoveries served by re-sending staged KV
    recomputed: int = 0             # recoveries that re-ran prefill
    replayed_tokens: int = 0        # pre-fault tokens re-derived bitwise
    recovery_steps: List[int] = dataclasses.field(default_factory=list)
    ttfd_steps: List[int] = dataclasses.field(default_factory=list)
    ttfd_model_s: List[float] = dataclasses.field(default_factory=list)
    ttfd_first_block_steps: List[int] = dataclasses.field(
        default_factory=list)
    queue_delay_steps: List[int] = dataclasses.field(default_factory=list)
    ttfd_arrival_steps: List[int] = dataclasses.field(default_factory=list)
    ttfd_arrival_model_s: List[float] = dataclasses.field(
        default_factory=list)
    e2e_steps: List[int] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        # the port's own tally, outside the fields the reference's
        # SchedStats shares: how often the decode step replayed a graph, and
        # how often it read the gathered block payload in place
        self.decode_graph = DecodeGraphTally()
        self.paged_decode = PagedDecodeTally()


class DisaggScheduler:
    """Drives prefill PEs, the migration engine, and decode slot banks."""

    def __init__(self, ctx, heap, engine: Engine, pool, migrator: KVMigrator,
                 *, prefill_pes: List[int], decode_pes: List[int],
                 num_slots: int, scfg: ServeConfig = ServeConfig(),
                 prefills_per_step: Optional[int] = None,
                 admit_delay_steps: int = 0, paged: bool = True,
                 stream_chunks: int = 0, fused_attn: bool = False,
                 shared_prefix: bool = False,
                 policy: Optional[AdmissionPolicy] = None,
                 prefix_index: Optional[Dict[tuple, PrefixEntry]] = None,
                 rid_base: int = 0):
        if fused_attn and not paged:
            raise ValueError("fused_attn requires paged decode (the fused "
                             "kernel gathers K/V straight from the pool)")
        if fused_attn and stream_chunks > 0:
            raise ValueError(
                "fused_attn and chunked streaming are mutually exclusive — "
                "per-block signals already stream at block granularity")
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
        # step N is first polled at step N + delay; a streamed close scales
        # it by the final installment's share of the wire
        self.admit_delay_steps = admit_delay_steps
        self.paged = paged
        self.stream_chunks = stream_chunks      # blocks per installment; 0=off
        self.fused_attn = fused_attn
        self.shared_prefix = shared_prefix
        self.policy = policy if policy is not None else AdmissionPolicy()
        self.views: Dict[int, PagedDecodeView] = (
            {pe: PagedDecodeView(pool, pe, num_slots) for pe in decode_pes}
            if paged else {})
        self.queue: deque = deque()
        self.requests: Dict[int, Request] = {}
        self.staged: deque = deque()            # blocks held, awaiting a slot
        self.streaming: List[Request] = []      # chunked migrations in flight
        self.parked: List[Request] = []         # streams drained, no slot yet
        self.preempted: List[Request] = []      # evicted mid-decode, resumable
        self.migrating: List[Request] = []
        self.recovering: List[Request] = []     # fault victims awaiting redo
        # a fleet shares ONE prefix index across its pods' schedulers, so a
        # request routed anywhere can map blocks any pod staged
        self.prefix_index: Dict[tuple, PrefixEntry] = (
            {} if prefix_index is None else prefix_index)
        self.banks = {pe: engine.init_slots(num_slots, paged=paged)
                      for pe in decode_pes}
        self.slot_req: Dict[int, List[Optional[int]]] = {
            pe: [None] * num_slots for pe in decode_pes}
        self.stats = SchedStats()
        self._rr_prefill = 0
        self._rr_decode = 0
        self._step = 0
        self._next_rid = rid_base
        self._trace_pid = f"pod{ctx.node_of(self.prefill_pes[0])}"
        # KV sizes for the profiler's scope labels (bytes a block, a token)
        lay = pool.layout
        self._block_bytes = lay.block_bytes
        self._token_bytes = lay.block_bytes // max(1, lay.block_tokens)

    # ------------------------------------------------------------- tracing
    def _tracer(self):
        tr = self.ctx.tracer
        return tr if tr.enabled else None

    def _stream_flush(self, st) -> None:
        """Drain a stream's queue prefix in a ``stream_flush`` scope."""
        tier = self.ctx.tier(st.src_pe, st.dst_pe)
        with self.ctx.prof.scope(
                "stream_flush", nbytes=st.sent * self._block_bytes,
                path="proxy" if tier == "dcn" else "direct", tier=tier,
                work_items=self.migrator.work_items) as ps:
            self.heap = ps(self.migrator.stream_flush(self.heap, st))

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
    def submit(self, batch: dict, *, max_new: Optional[int] = None,
               prefix_len: int = 0, arrival_step: Optional[int] = None,
               t_arrival: Optional[float] = None,
               slo: Optional[object] = None) -> int:
        """Enqueue one request ({"tokens": (1,S)} [+ frontend embeds]).
        ``prefix_len`` declares its first N prompt tokens shareable with
        other requests declaring the same tokens (``shared_prefix`` mode).
        ``arrival_step`` / ``t_arrival`` carry the frontend's arrival time,
        so latencies include queue delay (default: now); ``slo`` is an
        opaque deadline class the admission policy reads."""
        if max_new is None:
            max_new = self.scfg.max_new_tokens
        S = int(batch["tokens"].shape[1])
        if S + max_new > self.engine.max_len + 1:
            raise ValueError(
                f"prompt ({S}) + max_new ({max_new}) exceeds the decode "
                f"cache (max_len={self.engine.max_len})")
        if not 0 <= prefix_len <= S:
            raise ValueError(f"prefix_len {prefix_len} outside [0, {S}]")
        lay = self.pool.layout
        need = (lay.blocks_for_decode(S, max_new) if self.paged
                else lay.blocks_for_prompt(S))
        if self._needs_boundary_cow(batch, prefix_len, S):
            need += 1
        if need > self.pool.num_blocks:
            raise ValueError(
                f"request needs {need} KV blocks but the pool holds only "
                f"{self.pool.num_blocks} — no schedule can ever admit it")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, batch=batch, max_new=max_new,
                      prefix_len=prefix_len if self.shared_prefix else 0,
                      slo=slo)
        req.submit_step = self._step
        req.arrival_step = (self._step if arrival_step is None
                            else arrival_step)
        req.t_arrival = (self._comm_clock() if t_arrival is None
                         else t_arrival)
        self.requests[rid] = req
        if not self.policy.admit(req, len(self.queue)):
            req.state = SHED
            req.finish_step = self._step
            self.stats.sheds += 1
            self._trace_phase(req, "shed", prompt_len=S,
                              queue_depth=len(self.queue))
            self._trace_phase(req, None, end_args={"outcome": "shed"})
            return rid
        self.queue.append(req)
        self._trace_phase(req, "queued", prompt_len=S, max_new=max_new,
                          arrival_step=req.arrival_step)
        return rid

    def _comm_clock(self) -> float:
        """Modeled comm seconds, excluding the migrator's advisory
        per-block records (the flush charges the real transfer)."""
        advisory = sum(
            b.time_total for k, b in self.ctx.telemetry.buckets.items()
            if k[0] == "kvxfer_block")
        return self.ctx.total_time() - advisory

    # ------------------------------------------------------ prefix sharing
    def _sharable(self, batch: dict, prefix_len: int) -> bool:
        """A batch shares only in shared-prefix mode, with a prefix, on a
        layout that is not a ring (its occupied slots wrap through every
        block, so no block is suffix-independent), and with tokens alone:
        other inputs (frontend embeds) condition K/V beyond the token
        prefix, which a token-keyed index cannot see."""
        return (self.shared_prefix and prefix_len > 0
                and not self.pool.layout.ring
                and not any(k != "tokens" for k in batch))

    def _needs_boundary_cow(self, batch: dict, prefix_len: int,
                            prompt_len: int) -> bool:
        """True when staging this request reserves a private block for a
        whole-prompt prefix's partial boundary block: the extra demand
        submit()'s feasibility check must charge."""
        return (self.paged and self._sharable(batch, prefix_len)
                and prefix_len == prompt_len
                and prefix_len % self.pool.layout.block_tokens != 0)

    def _prefix_plan(self, req: Request):
        """(shared_ids, key, n_entry): the table prefix this request maps
        from the index (hit) or will register (miss).  Whole blocks inside
        the declared prefix are sharable, and the partial boundary block
        too when the prefix is the whole prompt (its first decode write
        copies it)."""
        if not self._sharable(req.batch, req.prefix_len):
            return [], None, 0
        P, S, T = req.prefix_len, req.prompt_len, self.pool.layout.block_tokens
        whole = P == S
        n_own = P // T + (1 if whole and P % T else 0)
        if n_own == 0:
            return [], None, 0      # prefix shorter than one block
        key = tuple(int(t) for t in req.batch["tokens"][0, :P].tolist())
        entry = self.prefix_index.get(key)
        if entry is None:
            return [], key, n_own   # miss: register after staging
        usable = (entry.block_ids if (whole and entry.whole_prompt)
                  else entry.block_ids[:P // T])
        if not usable:
            return [], None, 0
        return list(usable), key, len(usable)

    def _cow_range(self, req: Request, n_entry: int):
        """Table indices decode will write that map prefix-entry blocks:
        at most the boundary block of a whole-prompt prefix."""
        if not self.paged or n_entry == 0:
            return range(0)
        return range(req.prompt_len // self.pool.layout.block_tokens,
                     n_entry)

    # -------------------------------------------------------------- phases
    def _next_prefill_pe(self) -> Optional[int]:
        """Round-robin over prefill PEs not occupied by a chunked stream (a
        streaming PE is still computing; parked streams free their PE)."""
        busy = {r.prefill_pe for r in self.streaming}
        for _ in range(len(self.prefill_pes)):
            pe = self.prefill_pes[self._rr_prefill % len(self.prefill_pes)]
            self._rr_prefill += 1
            if pe not in busy:
                return pe
        return None

    def _phase_stream(self) -> None:
        """Advance every chunked migration one installment: drain the
        previous installment's queue prefix, then issue the next or park
        the stream (all blocks issued, waiting slot-less).  Parked streams
        keep draining and bind a slot the moment one frees."""
        for req in list(self.streaming):
            st = req.stream
            self._stream_flush(st)
            if st.pending:
                self.heap = self.migrator.stream_chunk(self.heap, st,
                                                       self.stream_chunks)
            if not st.pending:
                self.streaming.remove(req)
                req.state = PARKED
                self.parked.append(req)
                self._trace_phase(req, "parked",
                                  end_args={"chunks": st.chunks,
                                            "blocks_sent": st.sent})
        for req in self.policy.waiting_order(list(self.parked)):
            self._stream_flush(req.stream)
            self._try_bind(req)

    def _phase_prefill(self) -> None:
        """Advance streams, retry slot assignment for staged requests, then
        prefill queued requests on free prefill PEs round-robin, staging
        and migrating each.  The policy picks which queued request runs
        next (FCFS: the head)."""
        self._phase_stream()
        for _ in range(len(self.staged)):
            self._try_migrate(self.staged.popleft())
        for _ in range(self.prefills_per_step):
            if not self.queue:
                return
            idx = self.policy.select(self.queue)
            req = self.queue[idx]
            if req.prefill_cache is None:            # not prefilled yet
                pe = self._next_prefill_pe()
                if pe is None:                       # every PE mid-stream
                    return
                del self.queue[idx]
                req.prefill_pe = pe
                req.prefill_step = self._step
                self.stats.queue_delay_steps.append(
                    self._step - req.arrival_step)
                self._trace_phase(
                    req, "prefill",
                    end_args={"queue_steps": self._step - req.arrival_step},
                    pe=pe)
                tr, track = self.ctx.tracer, (self._trace_pid, f"pe{pe}")
                gen = (seeded(self.engine.device, self.scfg.seed, req.rid)
                       if self.scfg.temperature > 0 else None)
                with tr.span("prefill", "sched", *track, rid=req.rid,
                             prompt_len=req.prompt_len), \
                        self.ctx.prof.scope(
                            "serve_prefill",
                            nbytes=req.prompt_len * self._token_bytes,
                            path="engine", tier="local") as ps, \
                        layerspans.use(layerspans.LayerSpans.make(
                            "prefill", tr, track)):
                    req.first_token, _, req.prefill_cache = ps(
                        self.engine.prefill_request(req.batch, gen,
                                                    self.scfg.temperature))
                self.stats.prefills += 1
            else:
                del self.queue[idx]
            if not self._stage(req):                 # pool exhausted: park
                self.stats.stalled_on_pool += 1      # the prefilled request
                self.queue.appendleft(req)
                return

    def _stage(self, req: Request) -> bool:
        """Stage a prefilled request into the pool: prefix mapping, payload
        staging, prefix registration and COW reserves, all or nothing
        against the free list."""
        lay = self.pool.layout
        shared_ids, key, n_entry = self._prefix_plan(req)
        max_new = req.max_new if self.paged else 0
        n_table = lay.blocks_for_decode(req.prompt_len, max_new)
        n_cow = len(self._cow_range(req, n_entry))
        if n_table - len(shared_ids) + n_cow > self.pool.free_blocks():
            return False
        self.heap, ids = self.migrator.stage(
            self.heap, req.rid, req.prefill_cache,
            prompt_len=req.prompt_len, src_pe=req.prefill_pe,
            max_new=max_new, shared_ids=shared_ids)
        assert ids is not None       # free-list headroom checked above
        req.shared_ids = shared_ids
        if key is not None:
            if key not in self.prefix_index:
                self.prefix_index[key] = PrefixEntry(
                    key=key, block_ids=ids[:n_entry],
                    whole_prompt=req.prefix_len == req.prompt_len,
                    home_pe=req.prefill_pe, resident={})
                # the entry holds its own reference: its blocks outlive
                # every mapper that copies-on-write away, until the entry
                # itself dies with its last mapper
                self.pool.incref(self.prefix_index[key].block_ids)
            entry = self.prefix_index[key]
            entry.refs += 1
            req.prefix_key = key
            if shared_ids:
                self.stats.prefix_hits += 1
                self.stats.blocks_prefix_shared += len(shared_ids)
        for b in self._cow_range(req, n_entry):
            req.cow_plan[b] = self.pool.reserve(1)[0]
        req.prefill_cache = None                 # staged in the pool now
        req.state = STAGED
        self._trace_phase(req, "staged", pe=req.prefill_pe,
                          shared_blocks=len(shared_ids))
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
        """Put a staged request on the wire: as a slot-less stream
        (streaming mode) or whole-prefill into a free (decode PE, slot),
        preempting a victim the policy offers when none is free."""
        if self.stream_chunks > 0:
            self._open_stream(req)
            return
        pe, slot = self._pick_slot()
        if slot is None:
            pe, slot = self._preempt_for(req)
        if slot is None:
            self.stats.stalled_on_slots += 1
            self.staged.append(req)
            return
        req.decode_pe, req.slot = pe, slot
        self.slot_req[pe][slot] = req.rid
        skip = self._resident_skip(req, pe)
        send = (self.migrator.migrate_fused if self.fused_attn
                else self.migrator.migrate)
        self.heap, report = send(
            self.heap, req.rid, src_pe=req.prefill_pe, dst_pe=pe, slot=slot,
            prompt_len=req.prompt_len, first_token=req.first_token,
            skip=skip)
        delay = self.admit_delay_steps
        if self.fused_attn:
            # the modeled wire window covers only what admission waits for:
            # tail + header + the first block
            total = report.n_wire + EXTRA_SIGNALS
            delay = delay * fused_admit_signal(report.n_wire) // total
        self._finish_migrate(req, report, delay=delay)

    def _open_stream(self, req: Request) -> None:
        """Open a slot-less chunked stream: pick the decode PE now (the
        wire needs a destination), ramp a pool stream-signal word, and put
        the first installment out.  The slot binds at close."""
        sig_id = self.pool.alloc_stream_sig()
        if sig_id is None:                       # every stream word carried
            self.stats.stalled_on_streams += 1
            self.staged.append(req)
            return
        pe = self._pick_stream_pe()
        req.decode_pe = pe
        req.park_sig = sig_id
        st = self.migrator.open_stream(
            req.rid, src_pe=req.prefill_pe, dst_pe=pe, slot=-1,
            prompt_len=req.prompt_len, first_token=req.first_token,
            skip=self._resident_skip(req, pe),
            sig_ptr=self.pool.stream_sig_ptr(sig_id))
        req.stream = st
        if not st.pending:
            # a fully resident prefix: nothing to stream, park now and bind
            # this step if a slot is free (tail + header only)
            req.state = PARKED
            self._trace_phase(req, "parked", dst_pe=pe, resident=True)
            self.parked.append(req)
            self._try_bind(req)
            return
        req.state = STREAMING
        self._trace_phase(req, "streaming", dst_pe=pe,
                          blocks=len(st.pending))
        self.streaming.append(req)
        # the first installment leaves the step its blocks fill
        self.heap = self.migrator.stream_chunk(self.heap, st,
                                               self.stream_chunks)

    def _pick_stream_pe(self) -> int:
        """Decode PE for a new stream: most free slots wins, ties resolved
        round-robin (load balancing: no slot exists yet)."""
        n = len(self.decode_pes)
        best, best_free = None, -1
        for k in range(n):
            pe = self.decode_pes[(self._rr_decode + k) % n]
            free = sum(1 for o in self.slot_req[pe] if o is None)
            if free > best_free:
                best, best_free = pe, free
        self._rr_decode += 1
        return best

    def _try_bind(self, req: Request) -> None:
        """Bind a parked stream to a free slot on its decode PE and close
        the stream (tail + header, the only wire left), preempting a
        policy-chosen victim on that PE when it is full."""
        pe = req.decode_pe
        slot = next((s for s, o in enumerate(self.slot_req[pe])
                     if o is None), None)
        if slot is None:
            _, slot = self._preempt_for(req, pe=pe)
        if slot is None:
            self.stats.stalled_on_slots += 1
            return
        st = req.stream
        st.slot = slot
        req.slot = slot
        self.slot_req[pe][slot] = req.rid
        self.parked.remove(req)
        self.heap, report = self.migrator.stream_close(self.heap, st)
        # the modeled wire latency scaled by the close's share of the
        # stream: for a parked stream just tail + header, which rounds DOWN,
        # so the admission poll may run the step the slot binds
        total = st.sent + EXTRA_SIGNALS
        delay = self.admit_delay_steps * st.final_wire // total
        self._finish_migrate(req, report, delay=delay)

    def _resident_skip(self, req: Request, dst_pe: int) -> frozenset:
        """Shared blocks an earlier request already migrated to this decode
        PE never travel again (COW keeps them pristine there).  Only the
        intersection with the blocks recorded resident at this PE: skipping
        an absent block would admit stale pool bytes."""
        if req.prefix_key is None or not req.shared_ids:
            return frozenset()
        resident = self.prefix_index[req.prefix_key].resident.get(
            dst_pe, frozenset())
        return frozenset(req.shared_ids) & frozenset(resident)

    def _finish_migrate(self, req: Request, report, *, delay: int) -> None:
        req.expected_sig = report.expected_signal
        req.wire_blocks = report.n_wire
        req.state = MIGRATING
        req.migrate_step = self._step
        req.admit_ready_step = self._step + delay
        req.t_submit = self._comm_clock()
        self._trace_phase(req, "migrating", src_pe=report.src_pe,
                          dst_pe=report.dst_pe, tier=report.tier,
                          bytes=report.bytes_total,
                          bytes_dcn=report.bytes_dcn, chunks=report.chunks,
                          wire_steps=delay,
                          protocol=("stream" if req.park_sig >= 0
                                    else "fused" if self.fused_attn
                                    else "barrier"))
        self.migrating.append(req)
        self.stats.migrations += 1
        self.stats.bytes_migrated += report.bytes_total
        self.stats.bytes_cross_pod += report.bytes_dcn
        self.stats.bytes_wire_saved += report.bytes_skipped
        if self.stream_chunks > 0:
            self.stats.stream_chunks += report.chunks

    # ---------------------------------------------------------- preemption
    def _preempt_for(self, req: Request, pe: Optional[int] = None):
        """Ask the policy for a victim among the decoding slot owners
        (optionally of one decode PE) and park it; returns the freed (pe,
        slot) or (None, None).  Dense-rehydrate mode cannot preempt: its KV
        lives in the slot bank, not the pool."""
        if not self.paged:
            return None, None
        decoding = [self.requests[rid]
                    for p in ([pe] if pe is not None else self.decode_pes)
                    for rid in self.slot_req[p] if rid is not None]
        decoding = [r for r in decoding if r.state == DECODING]
        victim = self.policy.preempt_victim(req, decoding)
        if victim is None:
            return None, None
        if victim.state != DECODING:
            raise RuntimeError(f"policy picked request {victim.rid} in "
                               f"state {victim.state}, not decoding")
        vpe, vslot = victim.decode_pe, victim.slot
        self._preempt(victim)
        return vpe, vslot

    def _preempt(self, req: Request) -> None:
        """Park a DECODING request back into the pool: snapshot its decode
        cursor and non-paged tail (the paged KV is written back to its
        blocks every step), surrender the slot and keep every block
        reference, un-fired COW reserves included, until resume."""
        pe, slot = req.decode_pe, req.slot
        if self.fused_attn and req.fused_pending > 0:
            # admitted but not yet decoded: its fused blocks are still on
            # the wire; consume them before the slot signal is re-armed, or
            # they would land against the NEXT request
            have = req.wire_blocks - req.fused_pending
            self.heap, resident = self.migrator.consume_blocks(
                self.heap, slot, pe, have, req.wire_blocks, rid=req.rid)
            req.fused_pending = req.wire_blocks - resident
        bank = self.banks[pe]
        req.resume_pos = int(bank.pos[slot])
        req.resume_tok = int(bank.tok[slot])
        req.park_tail = kvpool_mod.pack_tail(self.pool.layout, bank.cache,
                                             batch_idx=slot,
                                             device=self.heap.device)
        req.cow_plan = self.views[pe].detach_keep(slot)
        self.banks[pe] = self.engine.evict_slot(bank, slot)
        self.heap = self.migrator.reset_slot(self.heap, slot, pe)
        self.slot_req[pe][slot] = None
        req.slot = -1
        req.state = PREEMPTED
        req.preemptions += 1
        self._trace_phase(req, "preempted",
                          end_args={"decode_pos": req.resume_pos,
                                    "tokens_out": len(req.out)},
                          pe=pe)
        self.preempted.append(req)
        self.stats.preempts += 1

    def _phase_resume(self) -> None:
        """Re-bind preempted requests onto freed slots of their decode PE
        (their blocks never moved).  Runs after admissions, so waiting
        higher-priority requests take slots first."""
        for req in self.policy.waiting_order(list(self.preempted)):
            slot = next((s for s, o in enumerate(self.slot_req[req.decode_pe])
                         if o is None), None)
            if slot is None:
                continue
            self.preempted.remove(req)
            self._resume(req, slot)

    def _resume(self, req: Request, slot: int) -> None:
        """Inverse of :meth:`_preempt`: restore the tail into the new slot,
        re-arm the view (no block is zeroed: all carry live KV) and decode
        on from the saved cursor."""
        pe = req.decode_pe
        bank = self.banks[pe]
        bank = dataclasses.replace(bank, cache=kvpool_mod.insert_tail(
            self.pool.layout, bank.cache, slot, req.park_tail))
        self.heap = self.views[pe].attach(self.heap, slot, req.rid,
                                          fresh_ids=[], cow=req.cow_plan)
        req.cow_plan = {}
        req.park_tail = None
        self.banks[pe] = self.engine.activate_slot(
            bank, slot, pos=req.resume_pos, token=req.resume_tok)
        self.slot_req[pe][slot] = req.rid
        req.slot = slot
        req.state = DECODING
        self._trace_phase(req, "decoding", pe=pe, slot=slot, resumed=True)
        self.stats.resumes += 1

    # ------------------------------------------------------------ recovery
    def _emit_token(self, req: Request, tok: int) -> None:
        """Append a decoded token, unless the request is replaying after a
        fault: then the token must equal the pre-fault one (greedy decode
        over the same KV) and is not appended again, so ``len(req.out)``
        holds at ``replay_target`` and ``_maybe_finish`` cannot fire
        early."""
        if req.replayed < req.replay_target:
            if req.out[req.replayed] != tok:
                raise RuntimeError(
                    f"rid {req.rid}: replay diverged at token {req.replayed}"
                    f" ({req.out[req.replayed]} != {tok}): recovery is not "
                    f"bitwise")
            req.replayed += 1
            self.stats.replayed_tokens += 1
            return
        req.out.append(tok)

    def _phase_recover(self) -> None:
        """Dispatch fault victims parked by ``serve/recovery.py``: one
        whose blocks survived on live home rows re-enters STAGED and
        re-migrates; one whose KV died with its PE goes to the queue head
        and recomputes from the prompt.  Decoded-so-far tokens replay
        through :meth:`_emit_token` either way."""
        if not self.recovering:
            return
        for req in self.recovering:
            if self.pool.block_tables.get(req.rid):
                req.state = STAGED
                self.staged.append(req)
                self.stats.remigrated += 1
                self._trace_phase(req, "staged", recovered=True,
                                  replay=req.replay_target)
            else:
                req.state = QUEUED
                self.queue.appendleft(req)
                self.stats.recomputed += 1
                self._trace_phase(req, "queued", recovered=True,
                                  replay=req.replay_target)
        self.recovering = []

    # ----------------------------------------------------------- admission
    def _poll_first_block(self, req: Request) -> None:
        """Record the first step the request's first wire block is
        provably resident: a non-forcing read of the signal word (another
        admission's flush may have completed this request's prefix).  Wire
        order sets the threshold: barrier migrations send blocks first
        (``sig >= 1``), fused ones tail + header first
        (``sig >= EXTRA_SIGNALS + 1``)."""
        if req.first_block_step >= 0 or req.slot < 0 or req.wire_blocks == 0:
            return
        cur = self.heap.read(self.pool.sig_ptr(req.slot), req.decode_pe)
        thr = EXTRA_SIGNALS + 1 if self.fused_attn else 1
        if int(cur) >= thr:
            req.first_block_step = self._step

    def _phase_admit(self) -> None:
        """A MIGRATING request enters its decode slot once
        ``signal_wait_until`` observes its threshold: the whole request's
        under the barrier protocol (on the stream signal for a parked
        stream), the first block's in fused mode."""
        still = []
        for req in self.migrating:
            if req.park_sig < 0:
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
                sig_ptr = (self.pool.stream_sig_ptr(req.park_sig)
                           if req.park_sig >= 0 else None)
                self.heap, hdr = self.migrator.try_admit(
                    self.heap, req.slot, req.decode_pe, req.expected_sig,
                    sig_ptr=sig_ptr)
            if hdr is None:
                still.append(req)
                continue
            if hdr["req_id"] != req.rid:
                raise RuntimeError(f"slot {req.slot} header names request "
                                   f"{hdr['req_id']}, expected {req.rid}")
            if req.park_sig >= 0:
                # admission observed the parked stream's signal: recycle
                # the word (zeroed on the decode PE's row)
                self.heap = self.migrator.reset_signal(
                    self.heap, self.pool.stream_sig_ptr(req.park_sig),
                    req.decode_pe)
                self.pool.free_stream_sig(req.park_sig)
                req.park_sig = -1
            bank = self.banks[req.decode_pe]
            lay = self.pool.layout
            if self.paged:
                # the pool row IS the decode KV cache: only the non-paged
                # tail enters the slot bank
                tail = self.migrator.gather_tail(self.heap, req.slot,
                                                 req.decode_pe)
                bank = dataclasses.replace(bank, cache=kvpool_mod.insert_tail(
                    lay, bank.cache, req.slot, tail))
                growth = [i for i in self.pool.blocks_of(req.rid)
                          if self.pool.home_of(i) is None]
                self.heap = self.views[req.decode_pe].attach(
                    self.heap, req.slot, req.rid, fresh_ids=growth,
                    cow=req.cow_plan)
                req.cow_plan = {}
            else:
                payloads, tail = self.migrator.gather(
                    self.heap, req.rid, req.slot, req.decode_pe)
                cache = kvpool_mod.insert_blocks(lay, bank.cache, req.slot,
                                                 payloads)
                bank = dataclasses.replace(bank, cache=kvpool_mod.insert_tail(
                    lay, cache, req.slot, tail))
            self.banks[req.decode_pe] = self.engine.activate_slot(
                bank, req.slot, pos=hdr["prompt_len"],
                token=hdr["first_token"])
            if req.prefix_key is not None:
                # the admission wait proved every block this request maps
                # landed at its decode PE (sent or skipped as resident);
                # COW has not fired yet, so the table still maps the
                # shared ids
                entry = self.prefix_index[req.prefix_key]
                entry.resident.setdefault(req.decode_pe, set()).update(
                    set(entry.block_ids) & set(self.pool.blocks_of(req.rid)))
            req.state = DECODING
            self._emit_token(req, hdr["first_token"])
            if req.recoveries > 0 and req.recover_step >= 0:
                # recovery TTFD: fault step -> first (re-)decoded token
                self.stats.recovery_steps.append(
                    self._step - req.recover_step)
                req.recover_step = -1
            req.admit_step = self._step
            req.t_admit = self._comm_clock()
            if req.first_block_step < 0:
                req.first_block_step = self._step
            self.stats.ttfd_first_block_steps.append(
                req.first_block_step - req.arrival_step)
            self._trace_phase(
                req, "decoding",
                end_args={"wire_model_s": req.t_admit - req.t_submit,
                          "ttfd_steps": req.admit_step - req.arrival_step,
                          "ttfd_model_s": req.t_admit - req.t_arrival,
                          "first_block_step": req.first_block_step},
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
        tr, pf = self.ctx.tracer, self.ctx.prof
        wall = tr if tr.timed else NULL_TRACER
        for pe in self.decode_pes:
            bank = self.banks[pe]
            if not bank.active.any():
                continue
            if self.fused_attn:
                self._consume_fused(pe)
            track = (self._trace_pid, f"pe{pe}")
            gen = (seeded(self.engine.device, self.scfg.seed,
                          10_000 + self._step, pe)
                   if self.scfg.temperature > 0 else None)
            # KV bytes the step reads: its context tokens (read back, a host
            # sync, only when profiling) at the per-token KV size
            kv_bytes = int(bank.pos.cpu().numpy()[bank.active].sum()) \
                * self._token_bytes if pf.enabled else 0
            with tr.span("decode", "sched", *track,
                         slots=int(bank.active.sum())), \
                    pf.scope("serve_decode", nbytes=kv_bytes, path="engine",
                             tier="local",
                             work_items=int(bank.active.sum())) as ps:
                bank, toks = self._decode(pe, bank, gen)
                toks = ps(toks)
            self.banks[pe] = bank
            stepped = True
            with wall.span("decode.readback", "sched", *track):
                toks = toks.tolist()
            for s, rid in enumerate(self.slot_req[pe]):
                if rid is None or self.requests[rid].state != DECODING:
                    continue
                req = self.requests[rid]
                self._emit_token(req, toks[s])
                self.stats.decode_tokens += 1
                self._maybe_finish(req)
        if stepped:
            self.stats.decode_steps += 1

    def _decode(self, pe: int, bank, gen):
        """One decode step of ``pe``'s bank: ``(bank, tokens)``."""
        if self.paged:
            bank, toks, self.heap = self.engine.decode_slots_paged(
                bank, gen, self.ctx, self.heap, self.views[pe],
                self.scfg.temperature, track=(self._trace_pid, f"pe{pe}"),
                tally=self.stats.decode_graph)
            self.stats.paged_decode = PagedDecodeTally.total(
                v.forms for v in self.views.values())
            return bank, toks
        return self.engine.decode_slots(bank, gen, self.scfg.temperature,
                                        tally=self.stats.decode_graph)

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
                          "e2e_steps": req.finish_step - req.arrival_step,
                          "tokens": len(req.out),
                          "preemptions": req.preemptions})
            self._evict(req)

    def _evict(self, req: Request) -> None:
        """Refcount-correct teardown: the view releases the COW reserves
        that never fired, then the table's references go (a shared block
        frees only with its last mapper), and the prefix entry dies with its
        last mapper, dropping its own reference.  Then the slot's signal is
        re-armed and the slot freed."""
        if self.paged:
            self.views[req.decode_pe].detach(req.slot)
            self.stats.cow_copies = sum(v.cow_copies
                                        for v in self.views.values())
        self.pool.release(req.rid)
        if req.prefix_key is not None:
            entry = self.prefix_index.get(req.prefix_key)
            if entry is not None:
                entry.refs -= 1
                if entry.refs <= 0:
                    self.pool.release_ids(entry.block_ids)
                    del self.prefix_index[req.prefix_key]
            req.prefix_key = None
        self.heap = self.migrator.reset_slot(self.heap, req.slot,
                                             req.decode_pe)
        self.migrator.release_tail(req.rid)
        self.banks[req.decode_pe] = self.engine.evict_slot(
            self.banks[req.decode_pe], req.slot)
        self.slot_req[req.decode_pe][req.slot] = None
        self.stats.evictions += 1

    # --------------------------------------------------------------- drive
    def step(self) -> None:
        """Advance every pipeline stage once (streams advance inside the
        prefill phase)."""
        tr = self._tracer()
        if tr is not None:
            # monotonic: a fleet already advanced the shared clock
            tr.clock.set_step(self._step)
        self.ctx.prof.set_step(self._step)
        self._phase_recover()
        self._phase_prefill()
        self._phase_admit()
        self._phase_resume()
        self._phase_decode()
        self._step += 1

    def done(self) -> bool:
        return (not self.queue and not self.staged and not self.streaming
                and not self.parked and not self.preempted
                and not self.migrating and not self.recovering
                and all(r.state in TERMINAL for r in self.requests.values()))

    def run(self, *, max_steps: int = 10_000) -> Dict[int, np.ndarray]:
        """Drive until every submitted request finishes (or was shed);
        returns {rid: generated token ids} (shed requests: empty)."""
        while not self.done():
            if self._step >= max_steps:
                raise RuntimeError(f"scheduler wedged after {max_steps} steps")
            self.step()
        return {rid: np.asarray(r.out, np.int32)
                for rid, r in self.requests.items()}
