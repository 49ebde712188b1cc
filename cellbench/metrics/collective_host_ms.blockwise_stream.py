"""collective_host_ms.blockwise_stream (strategy layer): host milliseconds a
matvec inside the mesh's ``mesh/psum`` and ``mesh/gather`` spans
(``parallel/mesh.py``), on the stream's thread (the one that opened the
window and the profiler), within the traced window. The trace is this
run's, found by ``program_spans.this_run()``; a program without the spans
reads None."""

import json

from cellbench.harness import program_spans
from cellbench.harness.devtrace import WINDOW_SPAN

SPANS = ("mesh/psum", "mesh/gather")


def read(ctx):
    path = program_spans.this_run()
    calls = len(ctx.record.index)
    if ctx.trace is None or path is None or calls == 0:
        return None
    events = [e for e in json.loads(path.read_text()).get("traceEvents", [])
              if e.get("ph") == "X"]
    window = next(e for e in events
                  if e.get("name") == WINDOW_SPAN and e.get("cat") == "user_annotation")
    w0 = float(window["ts"])
    w1 = w0 + float(window["dur"])
    thread = (window.get("pid"), window.get("tid"))
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in SPANS
             and (e.get("pid"), e.get("tid")) == thread and w0 <= float(e["ts"]) < w1]
    if not spans:
        return None
    return sum(min(t, w1) - s for s, t in spans) * 1e-3 / calls
