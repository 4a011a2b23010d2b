"""The CNN serving walls of one tree, for comparing two trees in turns.

    python3 tools/serve_walls.py [TREE]

Builds the kernel library of TREE (a checkout of this repository, by
default the one holding this script) and, for MobileNet v2, MobileNet v1
and SqueezeNet under ``balanced`` (8 requests of batch 2 at 224 px, as
``chip_smoke.py`` serves them), prints one JSON line: the pipelined and
the sequential wall (best of 3, in turns, after a warm-up run of each) and
the host's enqueue time a request (``chip_smoke.host_enqueue_ms``), on
compiled groups and, as ``eager_host_enqueue_ms``, on eager ones
(``jit_groups=False``: every launch through the ops and their plan
lookup).  No
check is made here: ``chip_smoke.py`` holds the same paths to their
plain versions.  Run it on two trees alternately, several times, in one
call: the walls are host-bound and spread widely from run to run.  A
measurement for the card only: nothing in the package calls it.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1
            else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_walls: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.arch import DUAL_BASELINE, BoardModel
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.dualcore.runtime import DualCoreRunner
    from repro_torch.kernels.util import timed_build
    from repro_torch.models.cnn import build_model
    timed_build()
    gen = np.random.default_rng(0)
    out = dict(tree=ROOT.name)
    for model in cs.SERVED:
        params, _, graph = build_model(model, seed=0, device="cuda")
        sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), cs.SCHEME)
        runner = DualCoreRunner(model, params, sched, device="cuda")
        images = [cs.rand(gen, (cs.BATCH, cs.IMAGE, cs.IMAGE, 3))
                  for _ in range(cs.REQUESTS)]
        walls = {"pipelined": [], "sequential": []}
        for mode in ("pipelined", "sequential") * 4:     # the first: warm-up
            walls[mode].append(runner.timed(images, mode)[1] * 1e3)
        eager = DualCoreRunner(model, params, sched, device="cuda",
                               jit_groups=False)
        eager.run_sequential(images[:1])                 # warm-up
        out[model] = dict(pipelined_ms=min(walls["pipelined"][1:]),
                          sequential_ms=min(walls["sequential"][1:]),
                          host_enqueue_ms=cs.host_enqueue_ms(runner, images),
                          eager_host_enqueue_ms=cs.host_enqueue_ms(eager,
                                                                   images))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
