"""The card's idle time by what the launching thread was doing: the
program's own spans (``engine/*``, ``solver/*``) on the device trace's
clock.

A traced run writes its Chrome trace at ``runner.trace_path(workload,
seed)``; :func:`this_run` finds it through the ``--workload`` and
``--seed`` that ``run.py`` parsed from the command line, and
:func:`attribute` reduces it. Within the ``cellbench.window`` span, with the
device categories and union of ``devtrace.summarize``, each idle gap is
handed to one host thread: the thread whose runtime call launched the
device op that ends the gap (the op's ``args.correlation`` names the call:
``cudaLaunchKernel``, ``cudaGraphLaunch``, ``cudaMemcpyAsync``), or, where
that is missing, the thread whose launch call started last before the gap
ends. Each instant of the gap goes to the innermost program span open on
that thread at that instant, to ``(outside)`` where none is open, and the
whole gap to ``(unattributed)`` where no thread launched anything. So the
categories sum to the window's idle time.

A profiler records the spans of the threads it profiles: the program's
spans on the serve and solve cells' client threads reach the trace only
when the window's profiler records every thread
(``_ExperimentalConfig(profile_all_threads=True)``). A span that the trace
does not hold reads as absent: :meth:`ProgramIdle.idle_share_under` and
:meth:`ProgramIdle.count` return None, never 0.

Nothing here imports the program.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

from .devtrace import DEVICE_CATS, WINDOW_SPAN, _union
from .runner import trace_path

PROGRAM_PREFIXES = ("engine/", "solver/")
OUTSIDE = "(outside)"
UNATTRIBUTED = "(unattributed)"
# Host events of the CUDA runtime and driver, and the calls among them that
# put work on the card.
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
                "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")


@dataclass
class ProgramIdle:
    window_s: float
    idle_s: float
    # innermost program span open on the launching thread, (outside) or
    # (unattributed) -> idle seconds; the values sum to idle_s
    by_span: dict = field(default_factory=dict)
    # program span name -> idle seconds while it is open anywhere on the
    # launching thread's stack
    under: dict = field(default_factory=dict)
    # program span name -> spans that began in the window, any thread
    begun: dict = field(default_factory=dict)

    def idle_share_under(self, name: str) -> float | None:
        """Percent of the window the card idled while ``name`` was open on
        the launching thread; None where the trace holds no such span."""
        if not self.begun.get(name):
            return None
        return 100.0 * self.under.get(name, 0.0) / self.window_s

    def count(self, name: str) -> int | None:
        """Spans of ``name`` begun in the window; None where there is none."""
        return self.begun.get(name) or None


def this_run(argv: list[str] | None = None) -> Path | None:
    """The trace file of this process's run, from ``--workload`` and
    ``--seed`` on the command line; None where either or the file is
    missing."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    args, _ = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    if args.workload is None or args.seed is None:
        return None
    path = trace_path(args.workload, args.seed)
    return path if path.is_file() else None


def read_this_run(argv: list[str] | None = None) -> ProgramIdle | None:
    """:func:`attribute` of this run's trace, or None."""
    path = this_run(argv)
    return None if path is None else attribute(json.loads(path.read_text()))


def _thread(e: dict) -> tuple:
    return (e.get("pid"), e.get("tid"))


def _segments(spans: list) -> tuple[list, list]:
    """A thread's timeline cut where any of its program spans begins or
    ends: ``(starts, [(start, end, names open, innermost)])``, only where
    some span is open; innermost is the open span that began last."""
    edges = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(spans)])
    open_: dict = {}
    segs = []
    t_prev = None
    for t, kind, i in edges:
        if open_ and t_prev is not None and t > t_prev:
            inner = max(open_, key=lambda j: (spans[j][0], -spans[j][1]))
            segs.append((t_prev, t, frozenset(spans[j][2] for j in open_), spans[inner][2]))
        t_prev = t
        if kind:
            open_[i] = True
        else:
            open_.pop(i, None)
    return [s[0] for s in segs], segs


def attribute(trace: dict) -> ProgramIdle:
    """Reduce a Chrome trace (``export_chrome_trace``'s JSON): the window's
    idle time by the program span open on the launching thread."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events
               if e.get("name") == WINDOW_SPAN and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])

    launcher = {}  # correlation -> thread of the runtime call
    launches = []  # (start, thread) of every launch call
    device = []    # (start, end, correlation), clipped to the window
    spans = defaultdict(list)
    begun: dict = defaultdict(int)
    for e in events:
        cat = e.get("cat")
        ts = float(e["ts"])
        end = ts + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            s, t = max(ts, w0), min(end, w1)
            if t > s:
                device.append((s, t, e.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launcher[corr] = (ts, _thread(e))
            if e["name"].startswith(LAUNCH_CALLS):
                launches.append((ts, _thread(e)))
        elif cat == "user_annotation" and e["name"].startswith(PROGRAM_PREFIXES):
            spans[_thread(e)].append((ts, end, e["name"]))
            if w0 <= ts < w1:
                begun[e["name"]] += 1
    launches = sorted(set(launches) | {launcher[c] for _, _, c in device if c in launcher})
    launch_starts = [t for t, _ in launches]
    timelines = {th: _segments(ss) for th, ss in spans.items()}

    busy = _union([(s, t) for s, t, _ in device])
    # The op that starts where each busy stretch starts, earliest-launched
    # first: it ends the gap before that stretch.
    first_at: dict = {}
    for s, _, c in sorted(device, key=lambda d: (d[0], launcher.get(d[2], (0.0,))[0])):
        first_at.setdefault(s, c)

    by_span: dict = defaultdict(float)
    under: dict = defaultdict(float)
    edges = [w0] + [x for s, t in busy for x in (s, t)] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        corr = first_at.get(g1)
        thread = launcher[corr][1] if corr in launcher else None
        if thread is None:
            i = bisect.bisect_left(launch_starts, g1) - 1
            thread = launches[i][1] if i >= 0 else None
        if thread is None:
            by_span[UNATTRIBUTED] += (g1 - g0) * 1e-6
            continue
        covered = 0.0
        starts, segs = timelines.get(thread, ([], []))
        j = max(0, bisect.bisect_right(starts, g0) - 1)
        while j < len(segs) and segs[j][0] < g1:
            s, t, names, inner = segs[j]
            overlap = min(t, g1) - max(s, g0)
            if overlap > 0:
                by_span[inner] += overlap * 1e-6
                for name in names:
                    under[name] += overlap * 1e-6
                covered += overlap
            j += 1
        if g1 - g0 > covered:
            by_span[OUTSIDE] += (g1 - g0 - covered) * 1e-6
    busy_us = sum(t - s for s, t in busy)
    return ProgramIdle(window_s=(w1 - w0) * 1e-6, idle_s=(w1 - w0 - busy_us) * 1e-6,
                       by_span=dict(by_span), under=dict(under), begun=dict(begun))
