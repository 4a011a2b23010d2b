"""The SE kernels' share of the traced slice's summed device time (every
operation's), in percent.  Nothing to read where the slice's largest
operations hold no SE kernel."""
from pathlib import Path

from bench.harness.cell import load_file


def read(run):
    s = run.summary
    if s is None or s.device_s <= 0:
        return None
    roofline = load_file(Path(__file__).with_name(
        "se_roofline_pct.offline_b16.py"))
    dev = roofline.se_device_s(s)
    return dev / s.device_s * 100 if dev > 0 else None
