"""Continuous-batching serving: ``ServingEngine``, its request handles,
and the fleet router.

``FleetRouter`` fronts N replicas with health-scored admission,
per-replica circuit breakers, bounded re-routing and zero-drop rolling
deploys; ``InProcessFleet`` runs N replicas in one process.
"""
from .engine import ServingEngine  # noqa: F401
from .request import (QueueFull, Request, RequestFailed,  # noqa: F401
                      RequestParams, RequestStatus)
from .router import (CircuitBreaker, FleetRouter,  # noqa: F401
                     InProcessFleet, RouterRequest)

__all__ = [
    "CircuitBreaker", "FleetRouter", "InProcessFleet", "QueueFull",
    "Request", "RequestFailed", "RequestParams", "RequestStatus",
    "RouterRequest", "ServingEngine",
]
