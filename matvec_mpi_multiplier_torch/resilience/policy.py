"""Retry/fallback policy: bounded backoff retries + per-config breakers.

The port's copy of the JAX package's ``resilience/policy.py``.

**Retries** (:class:`RetryPolicy`) apply to *retryable* dispatch faults
only (the taxonomy in ``faults.py``): exponential backoff with
deterministic seeded jitter — the delay for (retry ordinal, attempt) is a
pure function of the seed, so a chaos test's timing behavior replays
exactly. Build failures and resource exhaustion are never retried at the
same config: the first is deterministic, the second needs a *smaller*
program, and both are the degradation ladder's job (``engine/core.py``).

**Circuit breakers** (:class:`CircuitBreaker`) exist because a config
that failed five times in a row will, with high probability, fail the
sixth — and every attempt burns a build or a dispatch that a healthy
fallback could have served. One breaker per ExecKey:

::

            failure_threshold consecutive failures
    CLOSED ────────────────────────────────────────▶ OPEN
      ▲                                               │
      │ probe succeeds                                │ reset_timeout_s
      │                                               ▼
      └──────────────────────────────────────── HALF_OPEN
                         probe fails ▶ OPEN     (one probe at a time)

While a key's breaker is open the engine skips that ladder level
entirely (no attempt, no wasted work); once the cooldown elapses the
next request *probes* the preferred config — exactly one in-flight probe,
so a recovering config is not stampeded — and a success closes the
breaker and restores the preferred config.

The clock and the backoff's sleep are ``time.monotonic`` and
``time.sleep``; no caller of the port sets others, so they are not
parameters. Tests set the private attributes (``breaker._clock``,
``policy._clock``, ``policy._sleep``) before the first breaker is made.

:func:`classify_failure` is the one place dispatch exceptions are read:
injected taxonomy errors carry their own flags; real errors are classified
by type and message.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import torch

from ..utils.errors import ConfigError
from .faults import FaultError, ResourceExhaustedError, _unit_hash

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

# Error-message fragments → classification, for real (uninjected) dispatch
# exceptions. Conservative: only statuses that are transient by contract
# retry; everything unknown fails fast. The XLA/gRPC spellings are the JAX
# package's; the port's own exhaustion is torch.cuda.OutOfMemoryError, which
# the engine raises as ResourceExhaustedError, or its message.
_EXHAUSTED_FRAGMENTS = ("RESOURCE_EXHAUSTED", "CUDA out of memory")
_TRANSIENT_FRAGMENTS = ("UNAVAILABLE", "ABORTED", "DEADLINE_EXCEEDED")
# A CUDA error a launch raised: PyTorch's (``torch.AcceleratorError`` where
# the installed version has it, else a RuntimeError reading "CUDA error"),
# or the port's wrappers' "kernel launch failed ... (cudaError N)". The
# context may be unusable afterwards: never retried at the same config.
_CUDA_ERROR_FRAGMENTS = ("CUDA error", "(cudaError ")
_ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", None)


def classify_failure(exc: BaseException) -> tuple[bool, bool]:
    """``(retryable, resource_exhausted)`` for one dispatch/build
    exception — taxonomy errors by their flags, CUDA errors as not
    retryable, other errors by message fragment."""
    if isinstance(exc, ResourceExhaustedError):
        return False, True
    if isinstance(exc, FaultError):
        return exc.retryable, False
    text = f"{type(exc).__name__}: {exc}"
    if any(f in text for f in _EXHAUSTED_FRAGMENTS):
        return False, True
    if (_ACCELERATOR_ERROR is not None and isinstance(exc, _ACCELERATOR_ERROR)) or any(
            f in text for f in _CUDA_ERROR_FRAGMENTS):
        return False, False
    return any(f in text for f in _TRANSIENT_FRAGMENTS), False


class RetryPolicy:
    """Bounded exponential backoff with deterministic seeded jitter.

    ``max_attempts`` counts the first try: 3 means "one try, up to two
    retries". ``delay_s(serial, attempt)`` is
    ``backoff_ms · multiplier^(attempt-1) · (1 + jitter·u)`` capped at
    ``max_backoff_ms``, with ``u`` a hash of (seed, serial, attempt) —
    two engines with the same seed back off identically, and no retry
    storm synchronizes across keys (each serial draws its own jitter).
    """

    def __init__(
        self,
        max_attempts: int = 3,
        backoff_ms: float = 1.0,
        multiplier: float = 2.0,
        max_backoff_ms: float = 50.0,
        jitter: float = 0.5,
        seed: int = 0,
    ):
        if max_attempts < 1:
            raise ConfigError(
                f"retry max_attempts must be >= 1, got {max_attempts}"
            )
        if backoff_ms < 0 or max_backoff_ms < 0:
            raise ConfigError("retry backoff must be >= 0 ms")
        if not (0.0 <= jitter <= 1.0):
            raise ConfigError(f"retry jitter must be in [0, 1], got {jitter}")
        self.max_attempts = int(max_attempts)
        self.backoff_ms = float(backoff_ms)
        self.multiplier = float(multiplier)
        self.max_backoff_ms = float(max_backoff_ms)
        self.jitter = float(jitter)
        self.seed = int(seed)

    def delay_s(self, serial: int, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based) of retry-sequence
        ``serial`` — deterministic in (seed, serial, attempt), drawn from
        the same seeded unit hash the fault plan uses."""
        base = self.backoff_ms * self.multiplier ** max(0, attempt - 1)
        u = _unit_hash(self.seed, serial, attempt)
        return min(base * (1.0 + self.jitter * u), self.max_backoff_ms) / 1e3


class CircuitBreaker:
    """Per-config failure gate: closed → open → half-open (one probe).

    ``allow()`` answers "may this request attempt the config now?" —
    True while closed, False while open (pre-cooldown), and True for
    exactly one caller at a time once half-open. Outcomes feed back via
    ``record_success``/``record_failure``; transitions fire the optional
    ``on_open``/``on_close`` callbacks (counter hooks) outside the lock.
    The cooldown reads ``time.monotonic`` (tests set ``_clock``).
    """

    def __init__(
        self,
        failure_threshold: int = 3,
        reset_timeout_s: float = 30.0,
        on_open: Callable[[], None] | None = None,
        on_close: Callable[[], None] | None = None,
    ):
        if failure_threshold < 1:
            raise ConfigError(
                f"breaker failure_threshold must be >= 1, got "
                f"{failure_threshold}"
            )
        if reset_timeout_s < 0:
            raise ConfigError(
                f"breaker reset_timeout_s must be >= 0, got {reset_timeout_s}"
            )
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = time.monotonic
        self._on_open = on_open
        self._on_close = on_close
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._consecutive_failures = 0
        self._opened_at: float | None = None
        self._probe_in_flight = False
        self._failures_total = 0
        self._successes_total = 0
        self._opens_total = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._observable_state_locked(self._clock())

    def _observable_state_locked(self, now: float) -> str:
        """OPEN reads as HALF_OPEN once the cooldown has elapsed (the
        transition itself happens lazily in ``allow``)."""
        if (
            self._state == BREAKER_OPEN
            and self._opened_at is not None
            and now - self._opened_at >= self.reset_timeout_s
        ):
            return BREAKER_HALF_OPEN
        return self._state

    def allow(self) -> bool:
        with self._lock:
            now = self._clock()
            if self._state == BREAKER_OPEN:
                if (
                    self._opened_at is not None
                    and now - self._opened_at >= self.reset_timeout_s
                ):
                    self._state = BREAKER_HALF_OPEN
                    self._probe_in_flight = False
                else:
                    return False
            if self._state == BREAKER_HALF_OPEN:
                if self._probe_in_flight:
                    return False  # one probe at a time
                self._probe_in_flight = True
                return True
            return True  # closed

    def record_success(self) -> None:
        closed = False
        with self._lock:
            if self._state != BREAKER_CLOSED:
                self._state = BREAKER_CLOSED
                closed = True
            self._consecutive_failures = 0
            self._probe_in_flight = False
            self._opened_at = None
            self._successes_total += 1
        if closed and self._on_close is not None:
            self._on_close()

    def record_inconclusive(self) -> None:
        """The attempt failed for a reason that says nothing about the
        CONFIG's health — a payload-poisoned request (``faults.py::
        is_payload_fault``). Releases a half-open probe slot without
        transitioning (the next request may probe again) and leaves the
        consecutive-failure count alone: a stream of bad requests must
        not open a healthy config's breaker."""
        with self._lock:
            self._probe_in_flight = False

    def record_failure(self) -> None:
        opened = False
        with self._lock:
            self._failures_total += 1
            self._probe_in_flight = False
            if self._state == BREAKER_HALF_OPEN:
                self._state = BREAKER_OPEN  # failed probe: back to cooldown
                self._opened_at = self._clock()
                self._opens_total += 1
                opened = True
            else:
                self._consecutive_failures += 1
                if (
                    self._state == BREAKER_CLOSED
                    and self._consecutive_failures >= self.failure_threshold
                ):
                    self._state = BREAKER_OPEN
                    self._opened_at = self._clock()
                    self._opens_total += 1
                    opened = True
        if opened and self._on_open is not None:
            self._on_open()

    def snapshot(self) -> dict:
        """State + tallies for ``engine.health()``."""
        with self._lock:
            now = self._clock()
            return {
                "state": self._observable_state_locked(now),
                "consecutive_failures": self._consecutive_failures,
                "failures_total": self._failures_total,
                "successes_total": self._successes_total,
                "opens_total": self._opens_total,
                "open_for_s": (
                    round(now - self._opened_at, 6)
                    if self._opened_at is not None else None
                ),
            }


class ResiliencePolicy:
    """The engine's recovery configuration: one retry policy plus the
    breaker parameters every per-ExecKey breaker is minted with.

    Breaker cooldowns read ``time.monotonic`` and retry backoffs sleep with
    ``time.sleep``; no caller of the port sets others, so neither is a
    parameter. Tests set ``_clock`` and ``_sleep`` on the policy before the
    engine makes its first breaker.
    """

    def __init__(
        self,
        retry: RetryPolicy | None = None,
        breaker_failure_threshold: int = 3,
        breaker_reset_s: float = 30.0,
    ):
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker_failure_threshold = int(breaker_failure_threshold)
        self.breaker_reset_s = float(breaker_reset_s)
        self._clock = time.monotonic
        self._sleep = time.sleep

    def sleep(self, seconds: float) -> None:
        """The retry backoff (on the dispatch thread, under the swap
        fence: bounded by the retry policy's ``max_backoff_ms``)."""
        self._sleep(seconds)

    def make_breaker(
        self,
        on_open: Callable[[], None] | None = None,
        on_close: Callable[[], None] | None = None,
    ) -> CircuitBreaker:
        breaker = CircuitBreaker(
            failure_threshold=self.breaker_failure_threshold,
            reset_timeout_s=self.breaker_reset_s,
            on_open=on_open,
            on_close=on_close,
        )
        breaker._clock = self._clock
        return breaker
