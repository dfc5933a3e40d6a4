"""Disaggregated serving: the window drives
``serve/scheduler.py::DisaggScheduler.step()``, built as
``launch/serve.py::_build_disagg`` builds it (``context.init``, a
``KVPool``, a ``KVMigrator``, an ``Engine``, the prefill and decode PEs of
``teams.disagg_partition``), greedy, with no eos: every request runs to
its ``max_new``.

The harness submits a request when its due time passes (or, for a
backlog, whenever fewer than ``backlog_per_slot`` x slots wait), and
stamps each token on the host clock when it enters ``req.out``, after the
step that produced it has synchronised.  The first token enters at
admission, so time to first token holds queueing, prefill, KV migration
and admission.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import arrivals, stats, weights
from perfbench.probes import Probes

FINISHED, SHED = "finished", "shed"
WARMUP_INDEX = 1 << 20
WARMUP_REQUESTS = 2     # an open loop's set-up serves these to the end


def build(cfg, params, mix: dict, seed: int, device):
    """(scheduler, kv_blocks, max_len) for the mix's serving shape."""
    from repro_torch.core import context, teams
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.kvpool import KVPool, build_layout
    from repro_torch.serve.kvxfer import KVMigrator
    from repro_torch.serve.scheduler import DisaggScheduler

    sv = mix["serving"]
    n_pre, n_dec, slots = sv["prefill_pes"], sv["decode_pes"], \
        sv["slots_per_pe"]
    max_prompt, max_new = arrivals.max_prompt(mix), arrivals.max_output(mix)
    max_len = max_prompt + max_new
    npes = n_pre + n_dec
    ctx, heap = context.init(npes=npes, node_size=npes, device=device)
    pre, dec = teams.disagg_partition(teams.world(npes), n_pre)
    lay = build_layout(cfg, max_len, block_tokens=sv["block_tokens"])
    # the in-flight need: every decode slot and the staged reserve at the
    # mix's largest request
    kv_blocks = ((n_dec * slots + sv["staged_reserve"])
                 * lay.blocks_for_decode(max_prompt, max_new))
    eng = Engine(cfg, params, max_len=max_len, device=device)
    pool = KVPool.create(heap, cfg, max_len, num_blocks=kv_blocks,
                         max_slots=slots, block_tokens=sv["block_tokens"])
    sched = DisaggScheduler(
        ctx, heap, eng, pool, KVMigrator(ctx, pool),
        prefill_pes=pre.pes(), decode_pes=dec.pes(), num_slots=slots,
        scfg=ServeConfig(max_new_tokens=max_new, temperature=0.0,
                         seed=seed))
    return sched, kv_blocks, max_len


class Served:
    """The host-side record of every request the harness submitted."""

    def __init__(self, sched, traffic, device, probes=None):
        self.sched = sched
        self.traffic = traffic
        self.device = device
        self.probes = probes
        self.next = 0            # the backlog's next traffic index
        self.spec = {}           # rid -> Arrival
        self.due = {}            # rid -> absolute due time
        self.stamps = {}         # rid -> [token times]
        self.live = {}           # rid -> request, until it finishes
        self.step_start = []     # host stamp at the start of step k

    def submit(self, i: int, t_due: float, fill=None) -> None:
        """Submit traffic request ``i``, due at host time ``t_due``;
        ``fill`` = (k, n) submits it as the k-th of n slots filled at
        once in a backlog's set-up (``arrivals.Traffic.residual``)."""
        a = self.traffic.get(i)
        if fill is not None:
            a = self.traffic.residual(a, *fill)
        tokens = torch.from_numpy(a.tokens.astype(np.int64)).to(self.device)
        rid = self.sched.submit({"tokens": tokens}, max_new=a.max_new)
        if self.probes is not None:
            self.probes.batch_rid[id(tokens)] = rid
        self.spec[rid] = a
        self.due[rid] = t_due
        self.stamps[rid] = []
        self.live[rid] = self.sched.requests[rid]

    def waiting(self) -> int:
        return len(self.sched.queue)

    def step(self) -> float:
        """One scheduler step, synchronised; stamps its tokens."""
        self.step_start.append(time.perf_counter())
        self.sched.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        done = []
        for rid, req in self.live.items():
            ts = self.stamps[rid]
            while len(ts) < len(req.out):
                ts.append(t)
            if req.state in (FINISHED, SHED):
                done.append(rid)
        for rid in done:
            del self.live[rid]
        return t

    def decoding(self) -> int:
        return sum(1 for r in self.live.values() if r.state == "decoding")


def run(job) -> dict:
    """Set-up, the window, then the check; returns the observation the
    metric readers take."""
    mix, cfg, dev = job.mix, job.cfg, job.device
    params = weights.make(cfg, job.seed, dev)
    traffic = arrivals.Traffic(mix, job.seed, cfg.vocab_size)
    sched, kv_blocks, max_len = build(cfg, params, mix, job.seed, dev)
    probes = Probes(dev) if job.trace else None
    if probes is not None:
        probes.install_serving(sched)
    srv = Served(sched, traffic, dev, probes)
    sv = mix["serving"]
    slots_total = sv["decode_pes"] * sv["slots_per_pe"]
    backlog = mix["arrivals"] == "backlog"
    keep = sv.get("backlog_per_slot", 0) * slots_total

    # ---- set-up: a backlog fills every slot, the first requests with a
    # residual share of their outputs so that requests finish at the
    # steady rate from the window's first step; an open loop serves its
    # warm-up requests to the end, so every kernel is built and warm
    if backlog:
        while srv.decoding() < slots_total:
            while srv.waiting() < keep:
                fill = ((srv.next, slots_total)
                        if srv.next < slots_total else None)
                srv.submit(srv.next, time.perf_counter(), fill)
                srv.next += 1
            srv.step()
    else:
        # warm-up requests take traffic indices no window reaches
        for k in range(WARMUP_REQUESTS):
            srv.submit(WARMUP_INDEX + k, time.perf_counter())
        while srv.live:
            srv.step()
    warm = set(srv.spec)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # what set-up made lives through the window: keep it out of the
    # collector's generations, so full collections do not walk it
    gc.collect()
    gc.freeze()
    t_open = time.perf_counter()
    n_setup_steps = len(srv.step_start)
    prefills0, admissions0 = sched.stats.prefills, sched.stats.admissions
    if probes is not None:
        probes.window = True
    job.setup_s = t_open - job.t_process
    job.log(f"set-up {job.setup_s:.1f} s; {len(warm)} requests; "
            f"{kv_blocks} KV blocks, max_len {max_len}")

    # ---- the window
    t_end = t_open + job.seconds
    # a traced run's profiler: started at the open doing nothing, warmed
    # up (CUPTI's set-up, seconds) WARMUP_LEAD s before it records, and
    # recording the window's last trace_seconds until the close
    prof = prof_t0 = None
    if probes is not None:
        prof = torch.profiler.profile(activities=_activities(dev),
                                      schedule=_profiler_schedule)
        prof.start()
    warm_at = t_end - job.trace_seconds - WARMUP_LEAD
    record_at = t_end - job.trace_seconds
    t_close = t_open
    steps = 0
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if backlog:
            while srv.waiting() < keep:
                srv.submit(srv.next, now)
                srv.next += 1
        else:
            while t_open + traffic.due(srv.next) <= now:
                srv.submit(srv.next, t_open + traffic.due(srv.next))
                srv.next += 1
        if prof is not None:
            if prof.step_num == 0 and now >= warm_at:
                prof.step()                 # -> warm-up
            if prof.step_num == 1 and now >= record_at:
                prof.step()                 # -> recording
                probes.recording = True
                prof_t0 = time.perf_counter()
        if sched.done():
            nxt = t_open + traffic.due(srv.next)
            time.sleep(max(0.0, min(nxt, t_end) - now))
            t_close = time.perf_counter()
            continue
        t_close = srv.step()
        steps += 1
    slice_wall = 0.0
    if prof is not None:
        slice_wall = t_close - prof_t0 if prof_t0 is not None else 0.0
        prof.stop()
        probes.recording = False
    if probes is not None:
        probes.window = False
    window = t_close - t_open
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    st = sched.stats
    durs = [b - a for a, b in zip(srv.step_start[n_setup_steps:],
                                  srv.step_start[n_setup_steps + 1:])]
    job.log(f"window {window:.2f} s, {steps} steps (median "
            f"{1e3 * stats.percentile(durs, 50) if durs else 0:.0f} ms, "
            f"p90 {1e3 * stats.percentile(durs, 90) if durs else 0:.0f} "
            f"ms); in the window {st.prefills - prefills0} prefills, "
            f"{st.admissions - admissions0} admissions")

    obs = _observe(job, srv, warm, t_open, t_close)
    obs["memory_peak_bytes"] = memory_peak
    if probes is not None:
        probes.remove()
        obs.update(_observe_trace(probes, prof, prof_t0, slice_wall, srv,
                                  warm, t_open, t_close))

    # ---- the check, once the program's state is freed
    # every request whose last token the window served, whenever it came
    finished = [(srv.spec[rid].tokens[0], list(req.out))
                for rid, req in sched.requests.items()
                if req.state == FINISHED
                and t_open < srv.stamps[rid][-1] <= t_close]
    worked = {rid for rid, ts in srv.stamps.items()
              if any(t_open < t <= t_close for t in ts)}
    worked |= {rid for rid, t in srv.due.items()
               if rid not in warm and t <= t_close}
    obs["attempted"] = len(worked)
    obs["failed"] = sum(1 for rid in worked
                        if sched.requests[rid].state == SHED)
    del sched, srv, probes
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    obs["check"] = job.checker(params, finished)
    return obs


WARMUP_LEAD = 10.0


def _profiler_schedule(step: int):
    """Step 0 does nothing, 1 warms up, 2 on records until the stop."""
    from torch.profiler import ProfilerAction
    return (ProfilerAction.NONE, ProfilerAction.WARMUP)[step] if step < 2 \
        else ProfilerAction.RECORD


def _activities(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _observe(job, srv, warm, t_open, t_close) -> dict:
    """The host-clock numbers of the window."""
    from perfbench import yardstick
    stamps = srv.stamps
    first = {rid: ts[0] for rid, ts in stamps.items() if ts}
    due = {rid: t for rid, t in sorted(srv.due.items(), key=lambda x: x[1])
           if rid not in warm}
    window = t_close - t_open
    arch, layers = job.arch, job.layers
    # the model FLOPs of the work the window completed: each token
    # emitted in it was one decode (at its context) or, for a first
    # token, one prefill
    flops = 0.0
    for rid, ts in stamps.items():
        S = srv.spec[rid].prompt_len
        for j, t in enumerate(ts):
            if t_open < t <= t_close:
                flops += (yardstick.prefill_flops(arch, S, layers) if j == 0
                          else yardstick.decode_flops(arch, S + j, layers))
    return {
        "window_s": window, "setup_s": job.setup_s,
        "tokens": stats.tokens_in(stamps, t_open, t_close),
        "gaps": stats.token_gaps(stamps, t_open, t_close),
        "ttfts": stats.ttfts(due, first, t_open, t_close),   # in due order
        "waiting_at_close": len(srv.sched.queue) + len(srv.sched.staged),
        "model_flops": flops,
    }


def _observe_trace(probes, prof, prof_t0, slice_wall, srv, warm, t_open,
                   t_close) -> dict:
    """The traced run's per-layer readings."""
    from perfbench.devtrace import Slice
    out = {"decode_step_ms": Probes.elapsed_ms(probes.decode_events)}
    pre = [(ms, S) for ms, (_, _, S) in
           zip(Probes.elapsed_ms(probes.prefill_events),
               probes.prefill_events)]
    out["prefill_ms_tokens"] = pre
    waits, migr = [], []
    for rid, req in srv.sched.requests.items():
        if rid in warm or not t_open <= srv.due[rid] <= t_close:
            continue
        if 0 <= req.prefill_step < len(srv.step_start):
            waits.append(srv.step_start[req.prefill_step] - srv.due[rid])
        if rid in probes.prefill_end and rid in probes.admitted:
            migr.append(probes.admitted[rid] - probes.prefill_end[rid])
    out["queue_wait_s"] = waits
    out["migrate_s"] = migr
    if prof is not None and slice_wall > 0:
        sl = Slice(prof, slice_wall)
        out["slice"] = sl
        out["slice_tokens"] = stats.tokens_in(srv.stamps, prof_t0,
                                              prof_t0 + slice_wall)
        out["gather_calls"] = probes.gather_calls
        out["flash_calls"] = probes.flash_calls
    return out
