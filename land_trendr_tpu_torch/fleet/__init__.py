"""Serving fleet: warm-affinity router, tenant fair share, autoscaling.

The horizontal-scale layer over :mod:`land_trendr_tpu_torch.serve` — one
:class:`FleetRouter` front door owns N ``lt serve`` replicas (spawned or
adopted), routes repeat shapes to warm replicas, schedules tenants
fairly under quotas, re-routes around replica death, and scales the
pool on the fleet telemetry plane's SLO burn-rate signal.  See
``README.md`` §Serving fleet.
"""

from land_trendr_tpu_torch.fleet.autoscale import Autoscaler
from land_trendr_tpu_torch.fleet.config import RouterConfig, parse_tenant_weights
from land_trendr_tpu_torch.fleet.journal import AdmissionJournal, JournalError
from land_trendr_tpu_torch.fleet.router import DOWN_REASONS, FleetRouter, RouterJob

__all__ = [
    "AdmissionJournal",
    "Autoscaler",
    "DOWN_REASONS",
    "FleetRouter",
    "JournalError",
    "RouterConfig",
    "RouterJob",
    "parse_tenant_weights",
]
