"""K4 and K5 at every CNN path shape on the card, and under every tiling.

    PYTHONPATH=src python tools/fused_sweep.py [--reps 20] [--sweep]
                                               [--out fused_sweep.json]

Builds the kernel library from ``src/repro_torch/csrc`` and prints the
``-Xptxas -v`` registers and spills of K4 and K5.  At every K4 and K5
call of the CNN paths that ``chip_smoke.py`` drives (batch 2, 224 px) and
at its edge cases, it holds the kernel against the plain version
(rtol = atol = 1e-4, TF32 off in PyTorch) and times it on the device
(``cuda_time_ms``) beside the PyTorch library chain, with the planner's
tiling.  Per path it prints the sums.

``--sweep`` also times every tiling the planner considers
(``plan.candidates``) at each path shape, and prints the planner's pick
beside the fastest.  Then, for each choice a kernel is compiled for (K5's
64-channel expand step, its passes of 2 and of 4 chunks), it prints per
path the sum of the fastest tilings with and without that choice, and of
the planner's picks with and without it: what the choice buys.  The fastest tiling of each shape is timed twice, and the
largest difference of the two is printed as the sweep's noise.

Rows go to ``chiprun_out/<--out>``.  Exits 1 if a kernel misses the
tolerance anywhere.  A measurement for the card only: nothing in the
package calls it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import repro_torch.kernels.util as util  # noqa: E402

# the compiled choices a sweep prices: name -> the tilings that lack it
WITHOUT = {
    "kc 64": lambda p: p.kc != 64,
    "group 2": lambda p: p.group != 2,
    "group 4": lambda p: p.group != 4,
    "groups 2 and 4": lambda p: p.group == 1,
}


def main(argv=None) -> int:
    """Check and time K4 and K5 at the path shapes; return the exit
    code."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default="fused_sweep.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}")
    print(f"kernels built and loaded in {util.timed_build():.1f} s")
    for name in cs.FUSED_KERNELS:
        for line in util.ptxas_report(name):
            print(f"ptxas {name}: {line}")

    gen = np.random.default_rng(0)
    paths_calls = {p: [c for c in calls if c["kernel"] in cs.FUSED_KERNELS]
                   for p, calls in cs.cnn_paths().items()}
    distinct: dict[str, dict] = {}
    for calls in paths_calls.values():
        for c in calls:
            distinct.setdefault(json.dumps(c, sort_keys=True), c)
    edges = [c for c in cs.edge_calls() if c["kernel"] in cs.FUSED_KERNELS]
    rows, worst, missed = {}, 0.0, False
    for key, c in [*distinct.items(), *((None, c) for c in edges)]:
        case = cs.make_case(c, gen)
        got = case["kernel"]()
        want = case["plain"]()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=cs.KERNEL_TOL,
                            atol=cs.KERNEL_TOL)
        worst, missed = max(worst, err), missed or not ok
        row = dict(c, plan=cs.fused_plan(c), err=err, ok=ok)
        if key is not None:
            row["ms"] = util.cuda_time_ms(case["kernel"], reps=args.reps)
            row["library_ms"] = util.cuda_time_ms(case["library"],
                                                  reps=args.reps)
            rows[key] = row
        print(f"{c['kernel']:<20} {cs._shape_str(c):<46} plan "
              f"{row['plan']['tile']} x{row['plan']['cluster']} "
              f"({row['plan']['blocks']} blocks)  err {err:.1e}"
              f"{'' if ok else ' MISS'}"
              + (f"  {row['ms']:.4f} ms  library {row['library_ms']:.4f} ms"
                 if key else ""))
    if args.sweep:
        for key, c in distinct.items():
            rows[key]["sweep"] = sweep(c, gen)
    sums = {}
    for p, calls in paths_calls.items():
        for c in calls:
            r = rows[json.dumps(c, sort_keys=True)]
            s = sums.setdefault(f"{p}: {c['kernel']}",
                                dict(calls=0, ms=0.0, library_ms=0.0))
            s["calls"] += 1
            s["ms"] += r["ms"]
            s["library_ms"] += r["library_ms"]
            if args.sweep:
                for name, t in best_times(r["sweep"]).items():
                    s[name] = s.get(name, 0.0) + t
    for name, s in sums.items():
        print(f"per request, {name} x{s['calls']}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in s.items()
                          if k != "calls"))
    if args.sweep:
        noise = max(abs(r["sweep"][0]["ms"] - r["sweep"][0]["again_ms"])
                    for r in rows.values())
        print(f"sweep noise: the fastest tiling timed twice differs by up "
              f"to {noise:.4f} ms a call")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / args.out).write_text(json.dumps(dict(
        card=cs.card_line(), rows=list(rows.values()), sums=sums),
        indent=1))
    print(f"largest error {worst:.2e} (rtol = atol = "
          f"{cs.KERNEL_TOL}){'; MISSED' if missed else ''}")
    return 1 if missed else 0


def best_times(sweep_rows: list[dict]) -> dict[str, float]:
    """The fastest tiling's time, the planner's pick's, and for each
    compiled choice of ``WITHOUT`` the fastest tiling without it and the
    planner's pick without it (a K4 call has none of them: its own)."""
    out = dict(best_ms=sweep_rows[0]["ms"],
               picked_ms=next(r["ms"] for r in sweep_rows if r["picked"]))
    for name, keep in WITHOUT.items():
        out[f"without {name} ms"] = next(
            r["ms"] for r in sweep_rows if keep(argparse.Namespace(**r)))
        out[f"picked without {name} ms"] = next(
            r["ms"] for r in sweep_rows if name in r["picked_without"])
    return out


def sweep(call: dict, gen) -> list[dict]:
    """The kernel's time at ``call`` under every candidate tiling, fastest
    first (the fastest timed again as ``again_ms``); prints the planner's
    pick and the three fastest."""
    import repro_torch.kernels.fused_block.kernel as kmod
    from repro_torch.kernels.fused_block import plan as fplan
    c = call
    k4 = c["kernel"] == "fused_dw_pw_conv"
    ho, wo = fplan.out_size(c["h"], c["w"], c["k"], c["k"], c["stride"],
                            c["pad"])
    cands = fplan.candidates("k4" if k4 else "k5", c["n"], ho, wo,
                             0 if k4 else c["ci"], c["c"] if k4 else c["cm"],
                             c["co"], c["k"], c["k"], c["stride"])
    pick = min(cands, key=lambda kp: kp[0])[1]
    case = cs.make_case(c, gen)
    name = "plan_k4" if k4 else "plan_k5"
    real = getattr(kmod, name)

    def timed(p):
        setattr(kmod, name, lambda *a: p)
        return util.cuda_time_ms(case["kernel"], reps=10, warmup=2)
    try:
        timings = sorted(((timed(p), i) for i, (_k, p) in enumerate(cands)))
        again = timed(cands[timings[0][1]][1])
    finally:
        setattr(kmod, name, real)
    # the planner's pick were it to lack each choice
    pick_without = {
        name: min((kp for kp in cands if keep(kp[1])),
                  key=lambda kp: kp[0])[1]
        for name, keep in WITHOUT.items()}
    out = [dict(tile=f"{p.th}x{p.tw}", cluster=p.cluster, blocks=p.blocks,
                stages=p.stages, kc=p.kc, group=p.group, smem=p.smem_bytes,
                picked=p == pick, ms=ms,
                picked_without=[n for n, q in pick_without.items()
                                if q == p])
           for ms, i in timings for p in (cands[i][1],)]
    out[0]["again_ms"] = again
    rank = next(i for i, r in enumerate(out) if r["picked"])

    def show(r):
        return (f"{r['tile']} x{r['cluster']} ({r['blocks']} blocks, "
                f"{r['stages']} stages, kc {r['kc']}, g {r['group']}, "
                f"{r['smem']} B) {r['ms']:.4f}")
    print(f"  sweep {cs._shape_str(c)}: picked {show(out[rank])} (rank "
          f"{rank + 1} of {len(out)}); fastest "
          + "; ".join(show(r) for r in out[:3]) + "; "
          + ", ".join(f"{k} {v:.4f}" for k, v in best_times(out).items()))
    return out


if __name__ == "__main__":
    sys.exit(main())
