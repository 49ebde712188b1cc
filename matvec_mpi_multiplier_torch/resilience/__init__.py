"""Fault-tolerant serving: the fault taxonomy, seeded fault injection, and
the recovery policy.

The port's counterpart of the JAX package's ``resilience/``, in two layers:

* ``faults.py`` — the **fault taxonomy** (what can go wrong, and whether
  it is retryable) plus a seeded, reproducible :class:`FaultPlan` the
  engine consults at its build and dispatch sites;
* ``policy.py`` — the **recovery policy**: bounded exponential-backoff
  retries for retryable dispatch faults, and a per-ExecKey
  :class:`CircuitBreaker` (closed→open→half-open) that stops hammering a
  failing config and lets the engine reroute through its degradation
  ladder, probing back to the preferred config once the breaker's
  cooldown elapses.

The engine's integration lives in ``engine/core.py`` (the ladders, the
breakers and ``health()``) and ``engine/scheduler.py`` (coalesced-batch
bisection: ``is_payload_fault`` tells a poisoned request from a systemic
outage). ``bench/serve.py --fault-spec`` drives the whole stack under
seeded chaos.
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
    is_injected,
    is_payload_fault,
    is_rejection,
    out_of_memory_as_exhausted,
    parse_fault_spec,
    refuse_nonfinite,
)
from .policy import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    CircuitBreaker,
    ResiliencePolicy,
    RetryPolicy,
    classify_failure,
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
    "is_injected",
    "is_payload_fault",
    "is_rejection",
    "out_of_memory_as_exhausted",
    "refuse_nonfinite",
    "RetryPolicy",
    "CircuitBreaker",
    "ResiliencePolicy",
    "classify_failure",
    "BREAKER_CLOSED",
    "BREAKER_OPEN",
    "BREAKER_HALF_OPEN",
]
