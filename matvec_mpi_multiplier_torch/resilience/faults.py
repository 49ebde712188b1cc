"""Fault taxonomy and deterministic, seeded fault injection.

The port's copy of the JAX package's ``resilience/faults.py``, the fault
half of ``resilience/`` (the recovery policy waits: ROADMAP.md, queue A 4b).

**Taxonomy.** Every serving-path failure the engine reports is one of:

========================  =========  ========================================
error                     retryable  what it stands for
========================  =========  ========================================
CompileFaultError         no         a program failed to build or capture
DeviceFaultError          yes*       transient device error at dispatch
ResourceExhaustedError    no         the program does not fit the card's
                                     memory: a ``torch.cuda.OutOfMemoryError``
                                     raised in a dispatch maps to it
                                     (:func:`out_of_memory_as_exhausted`)
ResultIntegrityError      no         NaN/Inf in a result, caught by the
                                     integrity gate at materialization
========================  =========  ========================================

(*) a payload-poisoned DeviceFaultError is persistent by construction, so
those are marked non-retryable.

**Injection.** A :class:`FaultPlan` is a seeded list of :class:`FaultSpec`
rules the engine consults at its two fault sites — ``compile`` (just before
an uncached ExecKey's program is built and captured) and ``dispatch`` (just
before a program runs). Scoping is by ExecKey pattern (``fnmatch`` over the
key's ``op:strategy:kernel:combine:bucket:dtype`` label), by payload poison
signature, by match ordinal (``after``/``times``) and by probability. The
probability draw is a **hash of (seed, spec index, match ordinal)**, not a
stateful RNG, so a plan replayed over the same sequence of matching events
makes the same decisions as the JAX package's, whatever the clock or the
thread that asks.

Kinds and what the engine does with the returned :class:`FaultAction`:

* ``compile_error`` / ``device_error`` / ``resource_exhausted`` — raise the
  matching taxonomy error at the site;
* ``latency`` — sleep ``latency_ms`` on the dispatch path (a straggler);
* ``nan`` — mark the dispatch's result part corrupt: materialization plants
  a NaN in the host copy, which the integrity gate (when on) turns into a
  :class:`ResultIntegrityError`.

The poison check reads row 0 of the request as the host holds it, before
any copy to the card; a request already on the card never matches a poison
spec (reading it would wait for the card). This module is a leaf: it
imports nothing from ``engine/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
from fnmatch import fnmatchcase

import numpy as np
import torch

from ..utils.errors import ConfigError, MatvecError

FAULT_SITES = ("compile", "dispatch")
FAULT_KINDS = (
    "compile_error", "device_error", "resource_exhausted", "nan", "latency",
)


class FaultError(MatvecError):
    """Base of the injectable serving-fault taxonomy. ``retryable`` says
    whether re-running the same dispatch may succeed; ``injected`` marks
    errors a :class:`FaultPlan` raised (vs. classified real ones);
    ``payload_fault`` marks failures caused by the REQUEST's payload
    (a poisoned block) rather than the config or the device — those are
    exactly what batch bisection exists to isolate."""

    default_retryable = False

    def __init__(self, message: str, *, retryable: bool | None = None,
                 injected: bool = False, payload_fault: bool = False):
        super().__init__(message)
        self.retryable = (
            self.default_retryable if retryable is None else retryable
        )
        self.injected = injected
        self.payload_fault = payload_fault


class DeviceFaultError(FaultError):
    """A device error surfacing at dispatch — transient by default,
    persistent when payload-poisoned."""

    default_retryable = True


class CompileFaultError(FaultError):
    """A program failed to build or capture. Deterministic for a given
    (config, shape): never retried."""


class ResourceExhaustedError(FaultError):
    """The program's footprint does not fit the card's memory, at build or
    dispatch (the JAX package's RESOURCE_EXHAUSTED; a
    ``torch.cuda.OutOfMemoryError`` in the port). Not retryable at the same
    shape."""


class ResultIntegrityError(MatvecError):
    """The materialize-time integrity gate found NaN/Inf in a result
    block. The dispatch *succeeded* — this is silent corruption caught at
    the last host boundary before the caller."""


@contextlib.contextmanager
def out_of_memory_as_exhausted(where: str):
    """Raise :class:`ResourceExhaustedError` for a
    ``torch.cuda.OutOfMemoryError`` raised inside the block (the port's
    counterpart of XLA's RESOURCE_EXHAUSTED), chained to the original."""
    try:
        yield
    except torch.cuda.OutOfMemoryError as e:
        raise ResourceExhaustedError(
            f"out of device memory at {where}: {e}"
        ) from e


def refuse_nonfinite(
    out, counter, context: str
) -> ResultIntegrityError | None:
    """The integrity gate's ONE implementation (used by the engine's
    whole-block gate and the scheduler's per-slice gate): None when
    ``out`` (a host tensor or array, already materialized) is finite;
    otherwise count the refusal and return the error for the caller to
    cache on its future and raise."""
    if bool(torch.isfinite(torch.as_tensor(out)).all()):
        return None
    counter.inc()
    return ResultIntegrityError(
        f"non-finite values in {context} (the integrity gate refuses to "
        "serve corrupt data; re-submit the request)"
    )


def is_rejection(exc: BaseException) -> bool:
    """True when a failure is a SCHEDULING rejection, not a fault: an
    admission refused the request before any dispatch
    (``AdmissionRejectedError``). Availability accounting keeps the two
    apart — **rejected ≠ failed**: a typed pre-dispatch refusal consumed
    no device time, poisoned no batch, and is retryable by design,
    whereas a fault failure is downtime."""
    from ..utils.errors import AdmissionRejectedError

    return isinstance(exc, AdmissionRejectedError)


def is_injected(exc: BaseException) -> bool:
    """True when a :class:`FaultPlan` raised ``exc``: the only failures the
    engine's degradation ladder routes around (a real error reaches the
    caller, ``engine/core.py``)."""
    return isinstance(exc, FaultError) and exc.injected


def is_payload_fault(exc: BaseException) -> bool:
    """True when a failure is scoped to the request's PAYLOAD, not the
    config or the device: a poisoned injected fault, or an
    integrity-gate refusal (the corruption travels with the result
    slice). Payload faults never read as a systemic outage to the
    scheduler's batch bisection (``engine/scheduler.py``)."""
    if isinstance(exc, ResultIntegrityError):
        return True
    return bool(getattr(exc, "payload_fault", False))


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection rule.

    site : ``"compile"`` or ``"dispatch"``.
    kind : one of :data:`FAULT_KINDS`.
    key : ``fnmatch`` pattern over the ExecKey label
        (``op:strategy:kernel:combine:bucket:dtype``); ``"*"`` = all.
    p : injection probability per matching event (hash-derived, see
        module docstring).
    times : stop injecting after this many injections (None = unlimited).
    after : skip the first ``after`` matching events (lets a plan spare
        warmup traffic, or stage faults mid-run).
    latency_ms : for ``kind="latency"``: the injected stall.
    poison : payload signature — the rule matches only dispatches whose
        host block carries this exact value (cast to the block's dtype) in
        row 0 of any column (a request that deterministically crashes the
        kernel, the bisection test's "genuinely poisoned request").
        Poisoned device errors are persistent, hence non-retryable.
    retryable : override the kind's default retryability.
    """

    site: str
    kind: str
    key: str = "*"
    p: float = 1.0
    times: int | None = None
    after: int = 0
    latency_ms: float = 0.0
    poison: float | None = None
    retryable: bool | None = None

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ConfigError(
                f"fault site must be one of {FAULT_SITES}, got {self.site!r}"
            )
        if self.kind not in FAULT_KINDS:
            raise ConfigError(
                f"fault kind must be one of {FAULT_KINDS}, got {self.kind!r}"
            )
        if not (0.0 <= self.p <= 1.0):
            raise ConfigError(f"fault probability must be in [0, 1], got {self.p}")
        if self.times is not None and self.times < 0:
            raise ConfigError(f"fault times must be >= 0, got {self.times}")
        if self.after < 0:
            raise ConfigError(f"fault after must be >= 0, got {self.after}")
        if self.kind == "latency" and self.latency_ms <= 0:
            raise ConfigError(
                "latency faults need latency_ms > 0, got "
                f"{self.latency_ms}"
            )


@dataclasses.dataclass(frozen=True)
class FaultAction:
    """What the engine should do for one fired spec: raise ``error``,
    sleep ``latency_ms``, or mark the result part ``corrupt``."""

    kind: str
    spec_index: int
    error: FaultError | None = None
    latency_ms: float = 0.0
    corrupt: bool = False


def _poisoned(block, poison: float) -> bool:
    """Whether row 0 of a host payload carries ``poison`` in some column.
    A payload on the card never matches: reading it would wait for the
    card on the dispatch path."""
    if block is None:
        return False
    if isinstance(block, torch.Tensor):
        if block.device.type != "cpu":
            return False
        row0 = block[0] if block.dim() > 1 else block[:1]
        return bool((row0 == torch.tensor(poison, dtype=block.dtype)).any())
    block = np.asarray(block)
    row0 = block[0] if block.ndim > 1 else block[:1]
    return bool(np.any(row0 == block.dtype.type(poison)))


def _unit_hash(seed: int, spec_index: int, serial: int) -> float:
    """Deterministic uniform draw in [0, 1) from (seed, spec, ordinal) —
    stable across processes and thread interleavings of *other* specs."""
    digest = hashlib.sha256(
        f"{seed}:{spec_index}:{serial}".encode()
    ).digest()
    return int.from_bytes(digest[:8], "big") / 2.0**64


class FaultPlan:
    """A seeded set of injection rules, consulted per fault-site event.

    ``check(site, key_label, block=)`` walks the specs in order; the
    first spec that matches AND fires wins (one fault per event). The
    per-spec match/injected tallies (``summary()``) are the ground truth
    a test asserts against.

    Thread-safe: the tallies sit behind one small mutex (the engine may
    serve from many client threads). Determinism is per matching-event
    *sequence* — a single-threaded replay of the same traffic makes
    identical decisions; concurrent submitters can permute which request
    draws which ordinal, but the injected *count* statistics stay
    seed-stable.
    """

    def __init__(self, specs, seed: int = 0):
        self.specs = tuple(specs)
        if not self.specs:
            raise ConfigError("a FaultPlan needs at least one FaultSpec")
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._armed = True
        self._matched = [0] * len(self.specs)
        self._injected = [0] * len(self.specs)

    def disarm(self) -> None:
        """Stop injecting (and tallying) until :meth:`arm`: a caller
        disarms the plan across warmup so the steady phase's event
        ordinals start at zero, whatever warmup dispatched."""
        with self._lock:
            self._armed = False

    def arm(self) -> None:
        with self._lock:
            self._armed = True

    def _fire_locked(self, i: int, spec: FaultSpec) -> bool:
        """Tally one matching event for spec ``i`` and decide injection
        (caller holds the lock)."""
        serial = self._matched[i]
        self._matched[i] += 1
        if serial < spec.after:
            return False
        if spec.times is not None and self._injected[i] >= spec.times:
            return False
        if spec.p < 1.0 and _unit_hash(self.seed, i, serial) >= spec.p:
            return False
        self._injected[i] += 1
        return True

    def check(
        self, site: str, key_label: str, block=None,
        base_label: str | None = None,
    ) -> FaultAction | None:
        """One fault-site event: None (no fault) or the action to apply.
        ``block`` is the request payload (a tensor or array; row 0 is the
        signature row of poison-scoped specs, read only where the payload
        is on the host). ``base_label`` is the un-prefixed ExecKey label a
        TENANT-scoped engine also answers to: the multi-tenant registry
        prefixes ``key_label`` with ``"<tenant>/"`` so a spec can target
        one tenant (``key="tenant-7/*"``), while a spec written against the
        classic label grammar (``key="*psum*"``, ``key="gemm:*"``) keeps
        matching every tenant via the base label — scoping is additive,
        never a silent pattern break."""
        with self._lock:
            if not self._armed:
                return None
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if spec.key != "*" and not (
                    fnmatchcase(key_label, spec.key)
                    or (base_label is not None
                        and fnmatchcase(base_label, spec.key))
                ):
                    continue
                if spec.poison is not None and not _poisoned(block, spec.poison):
                    continue
                if not self._fire_locked(i, spec):
                    continue
                return self._action(i, spec)
        return None

    def _action(self, i: int, spec: FaultSpec) -> FaultAction:
        if spec.kind == "latency":
            return FaultAction(
                "latency", i, latency_ms=spec.latency_ms
            )
        if spec.kind == "nan":
            return FaultAction("nan", i, corrupt=True)
        where = f"{spec.site} of key matching {spec.key!r}"
        if spec.kind == "compile_error":
            err: FaultError = CompileFaultError(
                f"injected compile failure at {where} (spec {i}, "
                f"seed {self.seed})",
                retryable=spec.retryable, injected=True,
            )
        elif spec.kind == "resource_exhausted":
            err = ResourceExhaustedError(
                f"injected RESOURCE_EXHAUSTED at {where} (spec {i}, "
                f"seed {self.seed})",
                retryable=spec.retryable, injected=True,
            )
        else:  # device_error
            retryable = spec.retryable
            if retryable is None and spec.poison is not None:
                retryable = False  # payload-poisoned: persistent fault
            err = DeviceFaultError(
                f"injected device error at {where} (spec {i}, "
                f"seed {self.seed})"
                + (" [poisoned payload]" if spec.poison is not None else ""),
                retryable=retryable, injected=True,
                payload_fault=spec.poison is not None,
            )
        return FaultAction(spec.kind, i, error=err)

    def summary(self) -> dict:
        """Per-spec tallies (what a test asserts against)."""
        with self._lock:
            return {
                "seed": self.seed,
                "specs": [
                    {
                        "site": s.site,
                        "kind": s.kind,
                        "key": s.key,
                        "p": s.p,
                        "times": s.times,
                        "matched": self._matched[i],
                        "injected": self._injected[i],
                    }
                    for i, s in enumerate(self.specs)
                ],
            }

    @property
    def total_injected(self) -> int:
        with self._lock:
            return sum(self._injected)


_SPEC_FIELD_PARSERS = {
    "key": str,
    "p": float,
    "times": int,
    "after": int,
    "latency_ms": float,
    "poison": float,
    "retryable": lambda v: bool(int(v)),
}


def parse_fault_spec(text: str, seed: int = 0) -> FaultPlan:
    """Parse the JAX serve bench's ``--fault-spec`` grammar into a plan.

    Grammar: specs joined by ``;``, each
    ``site:kind[:field=value[,field=value...]]`` — e.g.::

        dispatch:device_error:p=0.05
        compile:compile_error:key=*psum_scatter*,times=4
        dispatch:latency:latency_ms=5,p=0.1;dispatch:nan:times=2

    Fields: ``key`` (fnmatch over the ExecKey label), ``p``, ``times``,
    ``after``, ``latency_ms``, ``poison``, ``retryable`` (0/1). Raises
    :class:`ConfigError` on anything malformed — a run with a half-parsed
    plan would measure the wrong thing.
    """
    specs = []
    for clause in text.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":", 2)
        if len(parts) < 2:
            raise ConfigError(
                f"fault spec clause {clause!r} must be site:kind[:fields]"
            )
        site, kind = parts[0].strip(), parts[1].strip()
        fields: dict = {}
        if len(parts) == 3 and parts[2].strip():
            for item in parts[2].split(","):
                if "=" not in item:
                    raise ConfigError(
                        f"fault spec field {item!r} must be name=value "
                        f"(in clause {clause!r})"
                    )
                name, value = (s.strip() for s in item.split("=", 1))
                parser = _SPEC_FIELD_PARSERS.get(name)
                if parser is None:
                    raise ConfigError(
                        f"unknown fault spec field {name!r}; expected one "
                        f"of {sorted(_SPEC_FIELD_PARSERS)}"
                    )
                try:
                    fields[name] = parser(value)
                except ValueError as e:
                    raise ConfigError(
                        f"bad value for fault spec field {name!r}: {e}"
                    ) from e
        specs.append(FaultSpec(site=site, kind=kind, **fields))
    if not specs:
        raise ConfigError(f"fault spec {text!r} contains no clauses")
    return FaultPlan(specs, seed=seed)
