"""Fault-tolerant serving: the fault taxonomy and seeded fault injection.

The port's counterpart of the JAX package's ``resilience/``, its fault half
(``faults.py``): what can go wrong and whether it is retryable, plus a
seeded, reproducible :class:`FaultPlan` the engine consults at its build
and dispatch sites. The scheduler's batch bisection (``engine/scheduler.py``)
is what the taxonomy serves today: ``is_payload_fault`` tells a poisoned
request from a systemic outage.

The recovery policy (``policy.py``: retries, circuit breakers, the
degradation ladders) is not ported yet (ROADMAP.md, queue A 4b).
"""

from .faults import (
    CompileFaultError,
    DeviceFaultError,
    FaultAction,
    FaultError,
    FaultPlan,
    FaultSpec,
    ResourceExhaustedError,
    ResultIntegrityError,
    is_payload_fault,
    is_rejection,
    out_of_memory_as_exhausted,
    parse_fault_spec,
    refuse_nonfinite,
)

__all__ = [
    "FaultPlan",
    "FaultSpec",
    "FaultAction",
    "parse_fault_spec",
    "FaultError",
    "DeviceFaultError",
    "CompileFaultError",
    "ResourceExhaustedError",
    "ResultIntegrityError",
    "is_payload_fault",
    "is_rejection",
    "out_of_memory_as_exhausted",
    "refuse_nonfinite",
]
