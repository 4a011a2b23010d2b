"""K7 flash's backward under every plan, and K6's backward, at the
training path's calls on the card.

    PYTHONPATH=src python tools/bwd_sweep.py [--reps 20]

At the calls ``chip_smoke.train_calls()`` names (Qwen2-0.5B's step: K7
flash's backward at B 8, Hq 14, Hkv 2, S 512, D 64, causal; K6's at 4096 x
896) it holds every plan ``plan_flash_bwd`` weighs against the plain
version (rtol = atol = 1e-4) and times it (``cuda_time_ms``), with each
pass's device time under the profiler (``chip_smoke.pass_ms``); prints
the planner's pick beside the fastest plan, and the fastest plan timed a
second time as the sweep's noise.  K6's backward is timed at its one
plan, with its passes.  Rows go to ``chiprun_out/bwd_sweep.json``.
Exits 1 if a plan misses the tolerance.  A measurement for the card
only: nothing in the package calls it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import repro_torch.kernels.attention.kernel as k7  # noqa: E402
from repro_torch.kernels.attention.plan import (  # noqa: E402
    flash_bwd_candidates, plan_flash_bwd)
from repro_torch.kernels.util import cuda_time_ms, resolve_device  # noqa: E402


def plan_id(p) -> str:
    return (f"q{p.q_warps}w/r{p.q_ring} kv{p.kv_warps}w/r{p.kv_ring}"
            f"{'/pair' if p.pair else ''}/cl{p.cluster}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[bwd_sweep] {cs.card_line()}")
    gen = np.random.default_rng(26)
    calls = {c["kernel"]: c for c in cs.train_calls()}
    out = dict(device=torch.cuda.get_device_name(0), card=cs.card_line(),
               rows=[])
    ok = True

    c = calls["rmsnorm_bwd"]
    case = cs._train_case(c, gen)
    ms = cuda_time_ms(case["kernel"], reps=args.reps)
    passes = cs.pass_ms(case["kernel"], reps=args.reps)
    print(f"[bwd_sweep] rmsnorm_bwd {cs._shape_str(c)}: {ms:.4f} ms; "
          f"plan {cs.bwd_plan(c)}; passes "
          + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()))
    out["rows"].append(dict(kernel="rmsnorm_bwd", ms=ms, passes_ms=passes,
                            plan=cs.bwd_plan(c)))

    c = calls["flash_attention_bwd"]
    case = cs._train_case(c, gen)
    want = case["plain"]()
    shape = tuple(c[k] for k in ("b", "hq", "hkv", "sq", "sk", "d", "causal",
                                 "q_offset", "sk_valid"))
    pick = plan_flash_bwd(*shape)
    saved = k7.plan_flash_bwd
    rows = []
    try:
        for key, plan in flash_bwd_candidates(*shape):
            k7.plan_flash_bwd = lambda *a, p=plan: p
            got = case["kernel"]()
            torch.cuda.synchronize()
            good = all(torch.allclose(g, w, rtol=cs.BWD_TOL, atol=cs.BWD_TOL)
                       for g, w in zip(got, want))
            ok &= good
            ms = cuda_time_ms(case["kernel"], reps=args.reps)
            passes = cs.pass_ms(case["kernel"], reps=args.reps)
            rows.append(dict(plan=dataclasses.asdict(plan), id=plan_id(plan),
                             ms=ms, passes_ms=passes, ok=good,
                             model=[key[0], plan.q_makespan,
                                    plan.kv_makespan], pick=plan == pick))
            print(f"[bwd_sweep] {plan_id(plan):<26} {ms:.4f} ms  passes "
                  + ", ".join(f"{k} {v:.4f}" for k, v in passes.items())
                  + f"  model q {plan.q_makespan:.3f} kv "
                    f"{plan.kv_makespan:.3f}"
                  + ("  <- pick" if plan == pick else "")
                  + ("" if good else "  MISSES 1e-4"))
        best = min(rows, key=lambda r: r["ms"])
        k7.plan_flash_bwd = lambda *a: flash_bwd_plan(best)
        again = cuda_time_ms(case["kernel"], reps=args.reps)
    finally:
        k7.plan_flash_bwd = saved
    mine = next(r for r in rows if r["pick"])
    print(f"[bwd_sweep] flash_attention_bwd {cs._shape_str(c)}: the pick "
          f"{mine['id']} {mine['ms']:.4f} ms, the fastest {best['id']} "
          f"{best['ms']:.4f} ms (again {again:.4f}: noise "
          f"{abs(again - best['ms']):.4f})")
    out["rows"] += rows
    out["fastest_again_ms"] = again
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "bwd_sweep.json").write_text(json.dumps(out, indent=1))
    return 0 if ok else 1


def flash_bwd_plan(row: dict):
    from repro_torch.kernels.attention.plan import FlashBwdPlan
    return FlashBwdPlan(**row["plan"])


if __name__ == "__main__":
    sys.exit(main())
