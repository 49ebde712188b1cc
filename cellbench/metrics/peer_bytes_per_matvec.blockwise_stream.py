"""peer_bytes_per_matvec.blockwise_stream (strategy layer): the bytes of the
copies from one card to another that began in the traced window (CUPTI's
``Memcpy PtoP`` records, their ``args.bytes``), over the matvecs called in
it. The trace is this run's, found by ``program_spans.this_run()``."""

import json

from cellbench.harness import program_spans
from cellbench.harness.devtrace import WINDOW_SPAN

PEER_COPY = "Memcpy PtoP"


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
    sizes = [e.get("args", {}).get("bytes") for e in events
             if e.get("cat") == "gpu_memcpy" and e["name"].startswith(PEER_COPY)
             and w0 <= float(e["ts"]) < w1]
    if not sizes or None in sizes:
        return None
    return sum(int(b) for b in sizes) / calls
