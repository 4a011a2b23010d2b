"""Mean milliseconds from a request's send to its admission, the
engine's ``RequestMetrics.started_at`` stamp, over the window."""
from bench.harness.stats import mean


def read(run):
    waits = [r.started - r.sent for r in run.done if r.started is not None]
    return mean(waits) * 1e3 if waits else None
