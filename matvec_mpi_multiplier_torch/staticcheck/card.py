"""The card twins of two static gates: they run on a CUDA device only.

The AST layer proves what the source says; these gates watch what the card
does, at full width, where only a card can tell:

* :func:`sync_audit` — the dispatch-path sync audit, the twin of
  ``engine-host-sync``. ``torch.cuda.set_sync_debug_mode("error")`` stays
  on around a steady stream of ``submit`` calls on a warmed engine (every
  dispatch, never ``result()``; the stream stays under the engine's
  in-flight window, so backpressure never waits): any synchronizing CUDA
  call on the dispatch path raises there. The paths a ``sync-ok`` marker
  covers (materialization, backpressure, reshard, close) are the only ones
  allowed to synchronize, and the stream reaches none of them.
  :func:`seeded_sync_red` plants one ``.item()`` on that path and shows the
  same mode raising on it: the gate can go red.
* :func:`peak_audit` — the twin of the JAX package's peak-liveness gate
  (``hlo.PEAK_LIVENESS_CEILING``). For each quantized-storage cell it
  measures, with ``torch.cuda.max_memory_allocated``, the device memory a
  matvec holds at its peak (the resident leaves plus every transient above
  what was allocated before the call), and holds the ratio to the native
  counterpart's peak under the ceilings. ``dequant_first=True`` runs
  ``ops.quantize.matvec_quantized_dequant_first`` in the kernel's place,
  which must break them. The JAX package estimates the peak from a
  lowering; the port measures it on the card.

Without a CUDA device every entry point raises ``ConfigError``: there is no
CPU fallback.
"""

from __future__ import annotations

import gc

import torch

from ..utils.errors import ConfigError
from .hlo import (
    PEAK_LIVENESS_CEILING,
    AuditConfig,
    audit_operands,
    build_config,
    native_counterpart,
    resident_bytes,
)


def require_card(device=None) -> torch.device:
    """The CUDA device the twins run on, or ``ConfigError``."""
    if not torch.cuda.is_available():
        raise ConfigError(
            "the staticcheck card twins run on a CUDA device, and none is "
            "visible; the CPU has the AST, lock-graph, keyspace and census "
            "layers"
        )
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if device.type != "cuda":
        raise ConfigError(f"the staticcheck card twins need a CUDA device, got {device}")
    return device


def _stream(engine, widths, seed: int):
    """Host requests of ``widths`` columns (a width of 1 is a vector), seeded,
    in the engine's dtype."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for w in widths:
        shape = (engine.k,) if w == 1 else (engine.k, w)
        out.append(torch.rand(shape, generator=gen).to(engine.dtype))
    return out


def sync_audit(engine, widths=tuple(range(1, 33)), *, seed: int = 0) -> dict:
    """Submit one request of each width with the sync debug mode at
    ``"error"``; any synchronizing call on the dispatch path raises out of
    here. Returns ``{"submits": n, "dispatches": d}``; the futures are
    materialized after the mode is off."""
    device = require_card(engine.mesh.devices[0])
    if engine.max_in_flight is not None and len(widths) > engine.max_in_flight:
        raise ConfigError(
            f"the sync audit's stream of {len(widths)} requests would reach the "
            f"engine's in-flight window of {engine.max_in_flight}, where "
            "backpressure waits by contract"
        )
    requests = _stream(engine, widths, seed)
    before = engine.stats.dispatches
    torch.cuda.synchronize(device)
    futures = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x in requests:
            futures.append(engine.submit(x))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for f in futures:
        f.result()
    return {"submits": len(futures), "dispatches": engine.stats.dispatches - before}


def seeded_sync_red(engine, *, seed: int = 0) -> str:
    """Plant one ``.item()`` on the engine's dispatch path (around its
    ``_run``), submit under the sync debug mode, and return the error the
    mode raised; ``ConfigError`` if it raised nothing (the gate is blind)."""
    device = require_card(engine.mesh.devices[0])
    real = engine._run
    probe = torch.ones((), device=device)

    def seeded(key, build, rhs, trace, call=None, **attrs):
        probe.item()  # the seeded host sync: a device value read back
        return real(key, build, rhs, trace, call, **attrs)

    (x,) = _stream(engine, (1,), seed)
    engine._run = seeded
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.submit(x)
    except RuntimeError as exc:
        return str(exc).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
        del engine._run
    raise ConfigError("the sync debug mode raised nothing on a seeded .item(): "
                      "the dispatch-path sync audit is blind")


def measure_peak(fn, a, x, device) -> tuple[int, torch.Tensor]:
    """Device bytes one call ``fn(a, x)`` holds at its peak: ``a``'s resident
    leaves plus the most allocated above what was allocated before the
    call. Returns ``(peak, y)``."""
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    y = fn(a, x)
    torch.cuda.synchronize(device)
    transient = torch.cuda.max_memory_allocated(device) - before
    return resident_bytes(a) + transient, y


def peak_audit(cells, mesh, *, m: int, k: int, dtype: str = "float32", seed: int = 0,
               dequant_first: bool = False, kernel: str = "cuda") -> dict:
    """Peak device bytes of each quantized cell in ``cells`` and of its
    native counterpart, on ``mesh`` (logical shards of one card), at
    (m, k) ``dtype``; one seeded native A serves every cell. Returns
    ``{cell key: {"peak_bytes", "native_peak_bytes", "peak_ratio",
    "ceiling", "under_ceiling", "peak_bytes_ratio", "a_bytes_ratio",
    "dequant_first": {...}}}`` (the last with ``dequant_first``);
    ``peak_bytes_ratio`` and ``a_bytes_ratio`` (the resident leaves)
    normalize by the native A's bytes."""
    from ..ops.quantize import matvec_quantized_dequant_first

    device = require_card(mesh.devices[0])
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand((m, k), generator=gen, device=device, dtype=getattr(torch, dtype))
    native_bytes = a.numel() * a.element_size()
    native_peaks: dict[str, int] = {}
    out: dict[str, dict] = {}
    for cell in cells:
        cell = cell._replace(kernel=kernel)
        base = native_counterpart(cell)
        if base.key not in native_peaks:
            pa, px = audit_operands(base, mesh, m=m, k=k, dtype=dtype, seed=seed, a=a)
            native_peaks[base.key], y = measure_peak(build_config(base, mesh), pa, px, device)
            del pa, px, y
            _release(device)
        qa, qx = audit_operands(cell, mesh, m=m, k=k, dtype=dtype, seed=seed, a=a)
        peak, y = measure_peak(build_config(cell, mesh), qa, qx, device)
        del y
        entry = _peak_entry(cell, peak, native_peaks[base.key], native_bytes)
        entry["a_bytes_ratio"] = resident_bytes(qa) / native_bytes
        if dequant_first:
            bad, y = measure_peak(build_config(cell, mesh, matvec_quantized_dequant_first),
                                  qa, qx, device)
            del y
            entry["dequant_first"] = _peak_entry(cell, bad, native_peaks[base.key],
                                                 native_bytes)
        del qa, qx
        _release(device)
        out[cell.key] = entry
    del a
    _release(device)
    return out


def _peak_entry(cell: AuditConfig, peak: int, native_peak: int, native_bytes: int) -> dict:
    ceiling = PEAK_LIVENESS_CEILING[cell.storage]
    ratio = peak / native_peak
    return {"peak_bytes": peak, "native_peak_bytes": native_peak, "peak_ratio": ratio,
            "ceiling": ceiling, "under_ceiling": ratio <= ceiling,
            "peak_bytes_ratio": peak / native_bytes}


def _release(device) -> None:
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
