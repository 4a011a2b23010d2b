"""Host time to enqueue one launch of K1, K2 and K4 at path shapes.

    python3 tools/launch_cost.py [TREE]

Builds the kernel library of TREE (a checkout of this repository, by
default the one holding this script), then for each of a few calls of the
CNN paths queues 200 launches behind a 200 ms sleep kernel, so that no
launch waits on the device, and prints the host's time a launch (best of
5).  Run it on two trees in one call to compare their wrappers' host
cost.  A measurement for the card only: nothing in the package calls it.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1
            else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch.kernels.util as util  # noqa: E402

CALLS = [
    dict(kernel="matmul_bias_act", m=1568, k=32, n=128, act="relu"),
    dict(kernel="matmul_bias_act", m=392, k=384, n=64, act=None),
    dict(kernel="matmul_bias_act", m=2, k=1280, n=1000, act=None),
    dict(kernel="depthwise_conv2d", n=2, h=14, w=14, c=576, k=3, stride=1,
         pad=1, act="relu6"),
    dict(kernel="fused_dw_pw_conv", n=2, h=14, w=14, c=96, co=96, k=3,
         stride=1, pad=1, dw_act="relu6", pw_act=None, res=False),
]
LAUNCHES = 200
SLEEP_MS = 200


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_cost: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}; tree {ROOT}")
    util.timed_build()
    gen = np.random.default_rng(0)
    for c in CALLS:
        case = cs.make_case(c, gen)
        for _ in range(5):
            case["kernel"]()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(5):
            torch.cuda._sleep(SLEEP_MS * util.SLEEP_CYCLES_PER_MS)
            t0 = time.perf_counter()
            for _ in range(LAUNCHES):
                case["kernel"]()
            best = min(best, (time.perf_counter() - t0) / LAUNCHES * 1e6)
            torch.cuda.synchronize()
        print(f"{c['kernel']} {cs._shape_str(c)}: host {best:.2f} us a "
              f"launch")
    return 0


if __name__ == "__main__":
    sys.exit(main())
