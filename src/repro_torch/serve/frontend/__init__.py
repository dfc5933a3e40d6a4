"""Cluster serving frontend: open-loop traffic, multi-pod routing, SLO
admission and fleet metrics over the disaggregated SHMEM serve stack.

Counterpart of ``repro/serve/frontend``.  The pieces compose as

    TrafficEngine.schedule() --> Fleet.run() --> metrics report
                                   |-- Router (per arrival)
                                   |-- DisaggScheduler per pod
                                   |       '-- SLOPolicy / FCFS hooks
                                   '-- shared KVPool / prefix index / proxy
"""
from repro_torch.serve.frontend.env import FleetEnv, load_fleet_env
from repro_torch.serve.frontend.fleet import Fleet, FleetConfig
from repro_torch.serve.frontend.metrics import collect, percentile
from repro_torch.serve.frontend.router import POLICIES, Pod, Router
from repro_torch.serve.frontend.slo import CLASSES, SLOClass, SLOPolicy, \
    resolve
from repro_torch.serve.frontend.traffic import RequestSpec, TenantSpec, \
    TrafficEngine

__all__ = [
    "CLASSES", "Fleet", "FleetConfig", "FleetEnv", "POLICIES", "Pod",
    "RequestSpec", "Router", "SLOClass", "SLOPolicy", "TenantSpec",
    "TrafficEngine", "collect", "load_fleet_env", "percentile", "resolve",
]
