"""95th percentile over every request of the window, from when it was
due (a closed loop: sent) to its output being ready; a request still
waiting past the traffic's cap counts at its age (host clock).  In a
closed loop that keeps the engine full it is clients over the rate plus
the stalls, so it is a per-layer reading beside ``img_per_s``."""
from bench.harness.stats import percentile


def read(run):
    if not run.latencies_s:
        return None
    return percentile(run.latencies_s, 95) * 1e3
