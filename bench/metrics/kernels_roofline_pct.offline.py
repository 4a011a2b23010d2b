"""The least time the card needs for a request's work (its FLOPs at the
f32-accurate peak, or its byte floor at HBM's rate, the larger) over the
summed device time of every operation in the traced slice per request
served in it, in percent."""
from bench.harness.work import bound_s


def read(run):
    s, ph = run.summary, run.trace
    if s is None or ph is None or not ph.served or s.device_s <= 0:
        return None
    bound = bound_s(run.flops_per_request, run.bytes_per_request, run.kind)
    if bound is None:
        return None
    return bound / (s.device_s / len(ph.served)) * 100
