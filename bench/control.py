"""The output check's control, read on the card at a cell's own size.

For each seed it draws the run's weights and pool of images exactly as
``run.py`` does, and prints the ``logit_err`` that the reference computed
in TF32 gets against the reference in float32, over every batch of the
pool: emulated (``precision="tf32"``, operands rounded to TF32) and by the
library's own TF32 products (cuBLAS and cuDNN with TF32 allowed).  A
limit is sound only where the control reads above it.

    python3 bench/control.py --workload <name> --seeds 1 2 3

The benchmark's own runs never run it.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device) -> dict:
    """The control's ``logit_err`` readings for ``seed``."""
    from bench.harness.check import forward_of, logit_err, reference_logits
    from bench.harness.inputs import make_inputs

    reference = cell.part("reference", cell.config["reference"])
    table = reference.layers(cell.config)
    forward = forward_of(reference)
    params, pool = make_inputs(table, cell.config, cell.traffic, seed,
                               device)
    idx = range(len(pool))
    ref = reference_logits(forward, table, params, pool, idx)
    emulated = reference_logits(forward, table, params, pool, idx, "tf32")
    library = reference_logits(forward, table, params, pool, idx,
                               "tf32_library")
    return {"seed": seed,
            "tf32_emulated": max(logit_err(emulated[i], ref[i])
                                 for i in idx),
            "tf32_library": max(logit_err(library[i], ref[i]) for i in idx)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from bench.harness.cell import load_cell

    if not torch.cuda.is_available():
        print("error: the control is read on a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload,
                          **readings(cell, seed, torch.device("cuda", 0))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
