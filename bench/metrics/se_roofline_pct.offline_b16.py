"""The least time the card needs for a request's SE gates (their FLOPs at
the f32-accurate peak, or their byte floor at HBM's rate, the larger:
``se_work`` of the configuration's reference) over the summed device time
per request of the traced slice's operations whose names hold an SE
kernel's name, in percent.  Nothing to read where the slice's largest
operations hold no SE kernel."""
from bench.harness.work import bound_s

#: the SE kernels' names in ``csrc/se_gate.cu``
KERNELS = ("se_gate_kernel", "se_scale_kernel")


def se_device_s(summary) -> float:
    """Device seconds of the slice's SE operations."""
    return sum(s for name, s in summary.ops
               if any(k in name for k in KERNELS))


def read(run):
    s, ph = run.summary, run.trace
    if s is None or ph is None or not ph.served:
        return None
    dev = se_device_s(s)
    if dev <= 0:
        return None
    cfg = run.cell.config
    ref = run.cell.part("reference", cfg["reference"])
    flops, nbytes = ref.se_work(ref.layers(cfg), run.cell.traffic["batch"])
    bound = bound_s(flops, nbytes, run.kind)
    if bound is None:
        return None
    return bound / (dev / len(ph.served)) * 100
