"""submit_host_ms.serve (engine layer): mean host milliseconds a request
spends inside MatvecEngine.submit, by the harness's clock around the call."""


def read(ctx):
    rec = ctx.record
    if not rec.submitted:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1 in zip(rec.start, rec.submitted)) / len(rec.submitted)
