"""Error types for the framework (the port's own copy).

Same names and messages as the JAX package's ``utils/errors.py``, so callers
and tests can treat the two packages alike. The reference has no exception
system: MPI failures are decoded and printed by ``process_error``
(``src/utils.c:10-23``) and invalid configurations print a message and
``return 0`` (``src/multiplier_rowwise.c:74``, quirk Q9 in SURVEY.md).

Two reference bugs stay fixed:

* Q2 — ``src/multiplier_colwise.c:151-153`` guards ``n_cols % comm_sz`` but the
  error message names ``n_rows``. Our message names the dimension actually
  checked.
* Q3 — ``src/multiplier_blockwise.c:275-281`` only checks
  ``(n_rows*n_cols) % comm_sz``; the correct condition is
  ``n_rows % grid_rows == 0 and n_cols % grid_cols == 0``.
"""

from __future__ import annotations


class MatvecError(Exception):
    """Base class for all framework errors."""


class ShardingError(MatvecError):
    """A matrix/vector shape is incompatible with the requested sharding."""


class DataFileError(MatvecError):
    """A data file is missing or malformed.

    Reference analog: the "Unable to locate matrix/vector file" path at
    ``src/multiplier_rowwise.c:110-129`` (which exits with status 0, Q9).
    """


class ConfigError(MatvecError):
    """Invalid benchmark / sweep configuration."""


class DeadlineExceededError(MatvecError):
    """A serving request's ``deadline_ms`` elapsed before dispatch.

    Raised by ``MatvecFuture.result()`` when the engine's backpressure gate
    (``engine/core.py``) held the request past its deadline: dispatching
    stale work would burn device time on an answer nobody is waiting for,
    so the future fails instead. The dispatch never happened — the request
    can be retried."""


class AdmissionRejectedError(MatvecError):
    """A scheduler's admission refused a request before any dispatch.

    A rejection is a *scheduling* outcome, distinct from a fault: no device
    work ran, and the request can be retried. Availability accounting keeps
    the two apart (``resilience.is_rejection``; rejected ≠ failed). Raised
    through a failed future by the global scheduler's predicted-time
    admission (``engine/global_scheduler.py``)."""


class TenantQuotaError(MatvecError):
    """A tenant's admission quota refused a request before dispatch.

    Raised by ``MatvecFuture.result()`` when the matrix registry's
    per-tenant admission gate (``engine/registry.py``) found the tenant
    at its ``max_in_flight`` quota: the request was never dispatched (no
    device work, no eviction pressure on other tenants) and can be
    retried once the tenant's outstanding work drains. Quota refusal is
    the isolation mechanism — one tenant's burst must fail ITS requests,
    not evict or degrade its neighbors'."""


class SolverDivergedError(MatvecError):
    """A served iterative solve hit its iteration cap without meeting its
    tolerance.

    Raised by ``SolverFuture.result()`` (``engine/core.py``) when the solver
    loop (``solvers/``) exhausted ``maxiter`` with its convergence predicate
    still false, or produced a non-finite answer. The partial iterate is
    NOT returned: an unconverged ``x`` is a silently wrong answer, and the
    contract is converged-or-typed-failure. Retry with a larger
    ``maxiter``, a looser ``rtol``, another op, or (for chebyshev) a
    corrected spectral interval."""


class ResidencyError(MatvecError):
    """A dispatch needed the resident ``A`` operand while it was evicted
    and the engine holds no host copy to restore it from.

    Registry-managed engines (``retain_host=True``) never raise this —
    they re-place the retained host payload transparently; it marks a
    caller evicting a plain engine's residency without having opted into
    host retention."""


class TimingError(MatvecError):
    """A timing measurement failed to produce a usable number.

    Raised instead of emitting a clamped/garbage value: a benchmark row that
    cannot be measured must be absent, never present-but-wrong
    (``src/multiplier_rowwise.c:135-151`` is the contract this protects).
    """


def check_divisible(value: int, divisor: int, what: str, by_what: str) -> None:
    """Raise ShardingError unless ``value % divisor == 0``.

    Mirrors the reference's divisibility guards (``src/multiplier_rowwise.c:72-75``,
    ``src/multiplier_colwise.c:151-154``, ``src/multiplier_blockwise.c:275-281``)
    but raises instead of printing + ``return 0``, and always names the correct
    dimension (fixing Q2).
    """
    if divisor <= 0:
        raise ShardingError(f"{by_what} must be positive, got {divisor}")
    if value % divisor != 0:
        raise ShardingError(
            f"{what} ({value}) is not divisible by {by_what} ({divisor}); "
            f"the {what} axis cannot be evenly sharded"
        )
