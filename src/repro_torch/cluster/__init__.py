"""Cluster serving layer: SLO-aware multi-replica routing, co-simulated
replicas, and goodput-driven autoscaling on top of ``ServeEngine``."""

from repro_torch.cluster.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.cluster.engine import ClusterEngine, Replica
from repro_torch.cluster.router import (JoinShortestQueueRouter,
                                  LeastKVPressureRouter,
                                  PrefixAffinityRouter, ROUTERS,
                                  RoundRobinRouter, Router, SLOMarginRouter,
                                  make_router)

__all__ = [
    "Autoscaler", "AutoscalerConfig", "ClusterEngine", "Replica",
    "Router", "RoundRobinRouter", "JoinShortestQueueRouter",
    "LeastKVPressureRouter", "SLOMarginRouter", "PrefixAffinityRouter",
    "ROUTERS", "make_router",
]
