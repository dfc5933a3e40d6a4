"""Cluster fleet: pods + router + SLO admission over one SHMEM world.

Counterpart of ``repro/serve/frontend/fleet.py``.  Topology: ``n_pods``
contiguous pods of ``prefill_per_pod + decode_per_pod`` PEs each.
``node_size`` is the pod size, so intra-pod migration is ici tier and
anything crossing pods is dcn, routed through ONE shared
:class:`~repro_torch.core.proxy.HostProxy` ring, as the paper's
reverse-offloaded inter-node ops are.  All pods share:

- one symmetric heap and one :class:`~repro_torch.serve.kvpool.KVPool`
  (block ids are cluster-wide addresses, which is what makes cross-pod
  prefix pulls possible at all);
- one prefix index, so the router's affinity policy sees which pod staged
  a shared prompt;
- one :class:`~repro_torch.serve.engine.Engine` (the weights; per-pod slot
  banks live in each scheduler).

The fleet runs a straight open-loop clock: at every step it fires the fault
plan's events for that step, submits the arrivals the traffic schedule put
there (routing each through the
:class:`~repro_torch.serve.frontend.router.Router`), then advances every
pod's scheduler one step.  After the schedule runs out it drains until
every request is terminal and rolls the report up through
``frontend/metrics.py``.  The fleet runs on the current CUDA device unless
the engine or ``device`` says otherwise.

``obs=`` takes a :class:`repro_torch.obs.Obs` bundle: it is attached to
the shared context, driven around every step (metrics, re-fit, auditors,
burn-rate alerts), dumps a postmortem at every fault site and on a crash
when its flight recorder is armed, and adds ``doc["obs"]`` to the report.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.core import context, teams
from repro_torch.core.proxy import HostProxy
from repro_torch.serve import fault as fault_mod
from repro_torch.serve import recovery as recovery_mod
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.frontend import metrics as metrics_mod
from repro_torch.serve.frontend import slo as slo_mod
from repro_torch.serve.frontend.router import Pod, Router
from repro_torch.serve.frontend.traffic import RequestSpec
from repro_torch.serve.kvpool import KVPool
from repro_torch.serve.kvxfer import KVMigrator
from repro_torch.serve.scheduler import RECOVERED, AdmissionPolicy, \
    DisaggScheduler

#: rid namespace stride per pod: block tables and request maps are fleet-
#: global (shared pool), so request ids must never collide across pods
RID_STRIDE = 1_000_000


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    arch: str = "qwen3-4b"
    n_pods: int = 2
    prefill_per_pod: int = 1
    decode_per_pod: int = 2
    num_slots: int = 2
    kv_blocks: int = 96
    block_tokens: int = 4
    max_streams: int = 32
    max_len: int = 24               # decode cache length (prompt + max_new)
    max_new: int = 4                # default decode budget
    temperature: float = 0.0
    stream_chunks: int = 1          # 0 = whole-prefill migration
    fused_attn: bool = False        # fused-admission decode (excl. streaming)
    shared_prefix: bool = True
    admit_delay: int = 1
    admission: str = "slo"          # "slo" | "fcfs"
    queue_bound: int = 12           # per-pod SLO shed bound
    router: str = "affinity"        # router.POLICIES
    proxy_slots: int = 128          # host-proxy ring capacity (power of 2)
    seed: int = 0

    @property
    def pod_size(self) -> int:
        return self.prefill_per_pod + self.decode_per_pod

    @property
    def npes(self) -> int:
        return self.n_pods * self.pod_size


class Fleet:
    """A running cluster frontend: build once, feed it arrival schedules."""

    def __init__(self, fcfg: FleetConfig, *, arch_cfg=None, params=None,
                 engine: Optional[Engine] = None,
                 classes: Optional[Dict[str, slo_mod.SLOClass]] = None,
                 obs=None, fault_plan=None, device=None):
        self.fcfg = fcfg
        self.classes = slo_mod.CLASSES if classes is None else classes
        if engine is not None:
            self.cfg = engine.cfg
            self.engine = engine
        else:
            from repro_torch.configs import base as cfgbase
            from repro_torch.models import model
            self.cfg = (arch_cfg if arch_cfg is not None
                        else cfgbase.reduced(cfgbase.get_config(fcfg.arch)))
            if params is None:
                params = model.init_params(self.cfg, seed=0, device=device)
            self.engine = Engine(self.cfg, params, max_len=fcfg.max_len,
                                 device=params["embed"].device)
        # one world: pods are nodes, inter-pod traffic is dcn via the proxy
        self.ctx, self.heap = context.init(npes=fcfg.npes,
                                           node_size=fcfg.pod_size,
                                           device=self.engine.device)
        # observability bundle (repro_torch.obs.Obs): installs the span
        # tracer (and profiler) on the shared context, arms the re-fit loop
        self.obs = obs
        if obs is not None:
            obs.attach(self.ctx)
        self.pool = KVPool.create(
            self.heap, self.cfg, fcfg.max_len, num_blocks=fcfg.kv_blocks,
            max_slots=fcfg.num_slots, block_tokens=fcfg.block_tokens,
            max_streams=fcfg.max_streams)
        self.proxy = (HostProxy(self.ctx, slots=fcfg.proxy_slots)
                      if fcfg.n_pods > 1 else None)
        self.prefix_index: Dict = {}
        world = teams.world(fcfg.npes)
        pod_teams = teams.pods_partition(
            world, [fcfg.pod_size] * fcfg.n_pods)
        self.pods: List[Pod] = []
        for i, pod_team in enumerate(pod_teams):
            pre, dec = teams.disagg_partition(pod_team, fcfg.prefill_per_pod)
            mig = KVMigrator(self.ctx, self.pool, proxy=self.proxy)
            sched = DisaggScheduler(
                self.ctx, self.heap, self.engine, self.pool, mig,
                prefill_pes=pre.pes(), decode_pes=dec.pes(),
                num_slots=fcfg.num_slots,
                scfg=ServeConfig(max_new_tokens=fcfg.max_new,
                                 temperature=fcfg.temperature,
                                 seed=fcfg.seed),
                admit_delay_steps=fcfg.admit_delay,
                stream_chunks=fcfg.stream_chunks,
                fused_attn=fcfg.fused_attn,
                shared_prefix=fcfg.shared_prefix,
                policy=self._make_policy(),
                prefix_index=self.prefix_index,
                rid_base=i * RID_STRIDE)
            self.pods.append(Pod(name=f"pod{i}", team=pod_team, prefill=pre,
                                 decode=dec, sched=sched))
        self.router = Router(self.pods, policy=fcfg.router,
                             prefix_index=self.prefix_index, seed=fcfg.seed)
        self.placements: Dict[int, tuple] = {}   # spec.idx -> (pod name, rid)
        self.elapsed_steps = 0
        # a FaultPlan (or its spec string) arms an injector that fires at
        # the top of step(); dead pods leave self.pods but stay here so
        # report() and outputs() keep their pre-fault finishes
        if isinstance(fault_plan, str):
            fault_plan = fault_mod.FaultPlan.parse(fault_plan)
        self.injector = (fault_mod.FaultInjector(fault_plan)
                         if fault_plan is not None and fault_plan.events
                         else None)
        self.dead_pods: List[Pod] = []

    def _make_policy(self) -> AdmissionPolicy:
        if self.fcfg.admission == "slo":
            return slo_mod.SLOPolicy(queue_bound=self.fcfg.queue_bound,
                                     classes=self.classes)
        if self.fcfg.admission == "fcfs":
            return AdmissionPolicy()
        raise ValueError(
            f"unknown admission policy {self.fcfg.admission!r} "
            f"(one of 'slo', 'fcfs')")

    # ---------------------------------------------------------------- drive
    def _submit(self, spec: RequestSpec, step: int) -> None:
        pod = self.router.route(spec)
        tracer = self.ctx.tracer
        if tracer.enabled:
            tracer.instant("route", "fleet", "fleet", "router",
                           idx=spec.idx, pod=pod.name,
                           policy=self.fcfg.router, slo=str(spec.slo))
        tokens = torch.from_numpy(spec.tokens).long().to(self.engine.device)
        rid = pod.sched.submit(
            {"tokens": tokens}, max_new=spec.max_new,
            prefix_len=spec.prefix_len, arrival_step=step, slo=spec.slo)
        self.placements[spec.idx] = (pod.name, rid)

    def done(self) -> bool:
        return all(pod.sched.done() for pod in self.pods)

    def step(self, arrivals: Optional[List[RequestSpec]] = None) -> None:
        """One fleet step: fire the plan's faults, submit this step's
        arrivals, advance every pod.  The heap is threaded through the
        pods: there is one symmetric memory, but each scheduler evolves its
        ``heap`` functionally, and the completion queue is fleet-shared, so
        a flush driven by pod B may complete ops pod A submitted.  Handing
        each pod the canonical heap and taking its result back lands those
        flushes in the memory every other pod reads."""
        if self.obs is not None:
            self.obs.begin_step(self.elapsed_steps)
        if self.injector is not None:
            # faults fire before this step's arrivals, deterministically
            self.injector.apply(self, self.elapsed_steps)
        for spec in arrivals or ():
            self._submit(spec, self.elapsed_steps)
        for pod in self.pods:
            pod.sched.heap = self.heap
            pod.sched.step()
            self.heap = pod.sched.heap
        for pod in self.pods:
            # drop the older snapshots: on the card each holds a pool
            pod.sched.heap = self.heap
        self.elapsed_steps += 1
        if self.obs is not None:
            self.obs.end_step(self)

    def run(self, specs: List[RequestSpec], *,
            max_steps: int = 10_000) -> dict:
        """Open-loop drive: play the arrival schedule, drain, report."""
        specs = sorted(specs, key=lambda s: (s.step, s.idx))
        i = 0
        try:
            while i < len(specs) or not self.done():
                if self.elapsed_steps >= max_steps:
                    raise RuntimeError(
                        f"fleet wedged after {max_steps} steps "
                        f"({len(specs) - i} arrivals unplayed)")
                batch = []
                while i < len(specs) and specs[i].step <= self.elapsed_steps:
                    batch.append(specs[i])
                    i += 1
                self.step(batch)
        except Exception as exc:
            # the flight recorder's last window becomes a postmortem trace
            # before the exception propagates; an AuditError already dumped
            # where it was found (Obs.end_step)
            from repro_torch.obs.audit import AuditError
            if self.obs is not None and not isinstance(exc, AuditError):
                self.obs.crash_dump(type(exc).__name__)
            raise
        return self.report()

    # ------------------------------------------------------ fault surface
    def _pod(self, name: str) -> Pod:
        pod = next((p for p in self.pods if p.name == name), None)
        if pod is None:
            raise ValueError(f"no live pod named {name!r} "
                             f"(live: {[p.name for p in self.pods]})")
        return pod

    def _fault_dump(self, reason: str) -> None:
        """Postmortem at the fault site: with a flight recorder armed the
        dump names the fault in ``otherData.postmortem.reason``."""
        rec = getattr(self.obs, "recorder", None) if self.obs else None
        if rec is not None:
            rec.dump(reason=reason, step=self.elapsed_steps)

    def kill_pe(self, pe: int) -> None:
        """Fail-stop one PE.  Pending ops touching it cancel with an error,
        its requests recover (re-migrate or recompute,
        ``serve/recovery.py``) and its heap rows are poisoned.  Killing a
        pod's only prefill or only decode PE escalates to whole-pod
        adoption.  Killing a dead PE (or a PE of a dead pod) is a no-op."""
        pe = int(pe)
        if not self.ctx.fault.alive(pe):
            return
        pod = next((p for p in self.pods if pe in p.team.pes()), None)
        if pod is None:
            if any(pe in p.team.pes() for p in self.dead_pods):
                return
            raise ValueError(f"pe {pe} is not a PE of any pod")
        s = pod.sched
        is_prefill = pe in s.prefill_pes
        lone = ((is_prefill and len(s.prefill_pes) == 1)
                or (not is_prefill and len(s.decode_pes) == 1))
        if lone:
            self.kill_pod(pod.name)
            return
        self.ctx.fault.kill(pe)
        self.ctx.pending.cancel_pe(self.ctx, pe)
        if is_prefill:
            recovery_mod.recover_prefill_pe(self, pod, pe,
                                            step=self.elapsed_steps)
        else:
            recovery_mod.recover_decode_pe(self, pod, pe,
                                           step=self.elapsed_steps)
        self.heap = fault_mod.scramble_rows(self.heap, [pe])
        self._fault_dump(f"fault:kill_pe:{pe}")

    def kill_pod(self, name: str) -> None:
        """Fail-stop a whole pod; its live requests are adopted by the
        surviving pods (full replay of decoded-so-far tokens).  Killing a
        dead pod is a no-op."""
        if any(p.name == name for p in self.dead_pods):
            return
        pod = self._pod(name)
        dead_pes = [int(p) for p in pod.team.pes()]
        for pe in dead_pes:
            if self.ctx.fault.alive(pe):
                self.ctx.fault.kill(pe)
                self.ctx.pending.cancel_pe(self.ctx, pe)
        recovery_mod.adopt_pod(self, pod, step=self.elapsed_steps)
        self.heap = fault_mod.scramble_rows(self.heap, dead_pes)
        self._fault_dump(f"fault:kill_pod:{name}")

    def partition(self) -> None:
        """Partition the inter-pod (dcn) fabric: cross-pod ops stay queued,
        neither lost nor delivered, until :meth:`heal`."""
        self.ctx.fault.dcn_down = True
        self._fault_dump("fault:partition")

    def heal(self) -> None:
        """Heal a dcn partition; queued cross-pod traffic drains at the
        next completion point."""
        self.ctx.fault.dcn_down = False

    def drain(self, name: str) -> None:
        """Administratively drain a pod: the router stops placing arrivals
        there, queued-but-unstarted requests re-route, and in-flight work
        finishes in place.  Draining a dead pod is a no-op."""
        if any(p.name == name for p in self.dead_pods):
            return
        pod = self._pod(name)
        if pod not in self.router.pods:
            return
        self.router.remove_pod(pod)
        sched = pod.sched
        back = {(pn, rid): idx for idx, (pn, rid) in self.placements.items()}
        for req in [r for r in list(sched.queue) if r.prefill_cache is None]:
            sched.queue.remove(req)
            req.state = RECOVERED
            req.finish_step = sched._step
            sched._trace_phase(req, None, end_args={"outcome": "rerouted"})
            target = self.router._least_loaded()
            new_rid = target.sched.submit(
                req.batch, max_new=req.max_new, prefix_len=req.prefix_len,
                arrival_step=req.arrival_step, t_arrival=req.t_arrival,
                slo=req.slo)
            idx = back.get((pod.name, req.rid))
            if idx is not None:
                self.placements[idx] = (target.name, new_rid)
        self._fault_dump(f"fault:drain:{name}")

    def join(self, name: str) -> None:
        """Re-admit a drained pod to the router rotation (a dead pod cannot
        rejoin: a no-op)."""
        if any(p.name == name for p in self.dead_pods):
            return
        pod = self._pod(name)
        if pod not in self.router.pods:
            self.router.add_pod(pod)

    def report(self) -> dict:
        doc = metrics_mod.collect(self.pods + self.dead_pods,
                                  classes=self.classes,
                                  elapsed_steps=self.elapsed_steps)
        doc["router"] = dict(self.router.stats)
        if self.proxy is not None:
            doc["proxy"] = {
                "ring_slots": self.proxy.ring.slots,
                "backpressure": self.proxy.backpressure,
                "delivered": len(self.proxy.ring.delivered),
            }
        if self.obs is not None:
            doc["obs"] = self.obs.summary()
        if (self.injector is not None or self.dead_pods
                or self.ctx.fault.dead_pes or self.ctx.pending.errors):
            doc["fault"] = {
                "dead_pes": sorted(self.ctx.fault.dead_pes),
                "dead_pods": [p.name for p in self.dead_pods],
                "dcn_down": self.ctx.fault.dcn_down,
                "events": (list(self.injector.fired)
                           if self.injector is not None else []),
                "cancelled_ops": self.ctx.pending.stats.cancelled,
            }
        return doc

    def outputs(self) -> Dict[int, object]:
        """spec.idx -> generated token list (shed requests: empty)."""
        out = {}
        by_pod = {pod.name: pod for pod in self.pods + self.dead_pods}
        for idx, (pod_name, rid) in self.placements.items():
            out[idx] = list(by_pod[pod_name].sched.requests[rid].out)
        return out
