"""Cluster serving tier: routed engine replicas behind one global queue.

Counterpart of ``repro.serving.cluster``.

See :mod:`repro_torch.serving.cluster.cluster` for the stepping model,
:mod:`repro_torch.serving.cluster.router` for the routing policies, and
:mod:`repro_torch.serving.cluster.stats` for the aggregate metrics.
"""
from repro_torch.serving.cluster.cluster import ROLES, Cluster, parse_roles
from repro_torch.serving.cluster.router import ROUTE_POLICIES, Router, RouterStats
from repro_torch.serving.cluster.stats import ClusterStats, ReplicaStats

__all__ = [
    "Cluster",
    "Router",
    "RouterStats",
    "ROLES",
    "ROUTE_POLICIES",
    "ClusterStats",
    "ReplicaStats",
    "parse_roles",
]
