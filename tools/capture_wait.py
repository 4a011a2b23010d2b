"""Does a CUDA graph capture wait for the card?

    python3 tools/capture_wait.py

Holds the card with a sleep kernel of about a second on one stream, then,
on a side stream, captures a graph whose body launches without
allocating, and one whose body allocates new device memory; prints the
host time of each capture and whether the sleep had ended by then.  A
capture that waited for the card takes about as long as the sleep: the
reason ``DualCoreRunner``'s lanes are made at warm-up.  Nothing in the
package calls it; it needs a card.
"""
from __future__ import annotations

import json
import sys
import time

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("capture_wait: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    hold, side = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    x = torch.ones(1 << 20, device=dev)
    out = {}
    for name, body in (("launch only", lambda: x.mul_(2)),
                       ("allocates 40 MB", lambda: torch.zeros(
                           10_000_000, device=dev) + 1)):
        torch.cuda.synchronize()
        with torch.cuda.stream(hold):
            for _ in range(2):               # a sleep takes an int32
                torch.cuda._sleep(1_000_000_000)
            slept = torch.cuda.Event()
            slept.record(hold)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            graph.capture_begin()
            body()
            graph.capture_end()
        ms = (time.perf_counter() - t0) * 1e3
        out[name] = dict(capture_ms=ms, sleep_over=slept.query())
        torch.cuda.synchronize()
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
