"""Run one cell of ``BENCHMARK.json`` once on the card and print its
result as the last line of standard output.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout; it needs a CUDA card and never falls
back to the CPU.  With ``--trace 0`` the result holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the
device's busy time and the breakdown.  The numbers the output check
compared, each beside its limit, are the last lines of standard error
and the result's last key.  Exit codes: 0 a result, 2 no card or not
enough cards, 3 JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list[str]:
    """Top-level names of ``names`` (default: ``sys.modules``) that are in
    ``FORBIDDEN``, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from bench.harness.cell import load_cell
    from bench.harness.measure import log, run_cell

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"error: {args.workload} needs {cell.chips} CUDA card(s), "
            f"{n} found; the benchmark does not run on the CPU")
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, T_START)
    bad = forbidden_modules()
    if bad:
        log(f"error: the run loaded {', '.join(bad)}")
        return 3
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(device),
                        **result["device"]}
    result["check"] = result.pop("check")          # the last key
    for name, v in result["check"].items():
        log(f"check: {name} {v['value']} limit {v['limit']}")
    log(f"correct: {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
