"""The traced window: ``torch.profiler`` over the window of a ``--trace 1``
run, its Chrome trace written under ``TMPDIR``, and the reduction of that
trace to what the per-layer readers and the ``breakdown`` read.

Device time comes from the profiler's CUPTI records (kernels, copies and
sets on the cards), over all the cards and card by card (by each record's
``args.device``, or a peer copy's ``args.inDevice``); the window from the
harness's own ``cellbench.window`` annotation; what the host was doing in
an idle gap from the innermost host event (an annotation, an operator or a
runtime call) open when the gap began.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "cellbench.window"
# How far back the search for the host event around a gap looks.
HOST_LOOKBACK = 2000


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float                       # union of device intervals, all cards
    kernel_s: float                     # sum of kernel durations, all cards
    kernels: int                        # kernels started in the window
    by_kernel: dict = field(default_factory=dict)    # name -> seconds
    idle_by_host: dict = field(default_factory=dict)  # host activity -> seconds
    busy_s_by_card: dict = field(default_factory=dict)    # card -> its busy_s
    kernel_s_by_card: dict = field(default_factory=dict)  # card -> its kernel_s

    def breakdown(self, top: int = 10) -> dict:
        def head(d: dict) -> list:
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": head(self.by_kernel), "idle_gaps": head(self.idle_by_host)}


class Tracer:
    """Profiles the window when enabled; ``span(name)`` marks a harness phase
    either way (a ``record_function`` when enabled, nothing otherwise)."""

    def __init__(self, enabled: bool, path: Path | None = None):
        self.enabled = enabled
        self.path = path
        self._prof = None

    def span(self, name: str):
        if self.enabled:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def __enter__(self):
        if self.enabled:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    def summary(self) -> TraceSummary | None:
        if self._prof is None:
            return None
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        self._prof = None
        return summarize(json.loads(self.path.read_text()))


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(trace: dict) -> TraceSummary:
    """Reduce a Chrome trace (``export_chrome_trace``'s JSON) to the
    window's device time, kernels and idle gaps."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events
               if e.get("name") == WINDOW_SPAN and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])

    def clip(e):
        s = max(float(e["ts"]), w0)
        return s, min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)

    device, by_kernel = [], defaultdict(float)
    kernel_us, kernels = 0.0, 0
    device_by_card, kernel_us_by_card = defaultdict(list), defaultdict(float)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = clip(e)
        if t <= s:
            continue
        card = _card(e.get("args", {}))
        device.append((s, t))
        device_by_card[card].append((s, t))
        if e["cat"] == "kernel":
            kernel_us += t - s
            kernel_us_by_card[card] += t - s
            kernels += 1
        by_kernel[e["name"]] += (t - s) * 1e-6
    busy = _union(device)
    busy_us = sum(t - s for s, t in busy)

    host = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
        for e in events
        if e.get("cat") in HOST_CATS and e.get("name") != WINDOW_SPAN)
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    edges = [w0] + [x for s, t in busy for x in (s, t)] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        idle[_host_at(host, starts, g0)] += (g1 - g0) * 1e-6
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
        kernel_s=kernel_us * 1e-6, kernels=kernels,
        by_kernel=dict(by_kernel), idle_by_host=dict(idle),
        busy_s_by_card={card: sum(t - s for s, t in _union(spans)) * 1e-6
                        for card, spans in device_by_card.items()},
        kernel_s_by_card={card: us * 1e-6 for card, us in kernel_us_by_card.items()})


def _card(args: dict):
    """The card a device record ran on: its ``device``, or for a copy
    between cards (CUPTI's ``Memcpy PtoP``, which names ``fromDevice``,
    ``toDevice`` and ``inDevice``) the card that ran the copy."""
    return args["device"] if "device" in args else args.get("inDevice")


def _host_at(host: list, starts: list, t: float) -> str:
    """The innermost host event open at ``t``: the latest-starting one that
    has not ended."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - HOST_LOOKBACK), -1):
        if host[j][1] > t:
            return host[j][2]
    return "(no host event)"
