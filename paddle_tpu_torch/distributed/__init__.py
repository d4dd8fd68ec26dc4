"""Distributed runtime pieces of the port. So far the preemption half of
``resilience`` (the JAX package's ``distributed/resilience.py``): the
``GracefulShutdown`` context the serving engine drains on; the
collectives, the store and the rest of resilience come with ROADMAP
A11."""
from . import resilience  # noqa: F401
