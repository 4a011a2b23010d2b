"""``latency_p95_ms.offline``'s reading, for the cells of batch 16."""
from pathlib import Path

from bench.harness.cell import load_file


def read(run):
    path = Path(__file__).with_name("latency_p95_ms.offline.py")
    return load_file(path).read(run)
