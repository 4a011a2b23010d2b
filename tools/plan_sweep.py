"""K1, K2, K3, K7 flash and K7 decode at their path shapes on the card, and
under every tiling.

    PYTHONPATH=src python tools/plan_sweep.py [--reps 20] [--sweep]
                                              [--kernel NAME ...]
                                              [--out plan_sweep.json]
    PYTHONPATH=src python tools/plan_sweep.py --fit chiprun_out/plan_sweep.json

Builds the kernel library from ``src/repro_torch/csrc`` and prints the
``-Xptxas -v`` registers and spills of K1 (``matmul_bias_act``), K2
(``depthwise_conv2d``), K3 (``conv2d_implicit_gemm``), K7
(``flash_attention``) and K6 (``rmsnorm``).  At every K1, K2 and K3 call of
the CNN paths that
``chip_smoke.py`` drives (batch 2, 224 px) and at its edge cases, and at K7
decode's calls on the Qwen2-0.5B path (every 8th cache length, 513 to
575) and at the other dense configs' head geometry, and at K7 flash's
prefill of the Qwen2-0.5B path (2 x 512) and that geometry, it holds the
kernel against the plain version (rtol = atol = 1e-4, TF32 off in PyTorch) and
times it on the device (``cuda_time_ms``) beside the PyTorch library call,
with the planner's plan.  Per path it prints the sums.

``--sweep`` also runs every plan the planner considers (K1 and K2's
tilings, K3's with ``plan.k3_candidates``, K7 decode's cluster sizes with
``attention/plan.candidates``, K7 flash's rows, rings and key splits with
``attention/plan.flash_candidates``) at each path shape, holds each against
the plain version and times it, and prints the planner's pick beside the
fastest;
the fastest is timed twice, and the largest difference of the two is
printed as the sweep's noise.  Per path it prints the sum of the fastest
tilings and of the planner's picks, and for each compiled choice of K1's
warp tiles (``plan.COMPILED``) and K2's outputs a thread (``plan.OWS``),
the sum of the fastest tilings without it: what the choice buys.

``--fit FILE`` runs on any machine: it reads a sweep's rows and fits K1's
and K2's cost constants, coordinate by coordinate over a grid of factors,
to the least summed time of the picks a request makes, then prints the
constants and the picks' sum before and after.

Rows go to ``chiprun_out/<--out>``.  Exits 1 if a kernel misses the
tolerance anywhere.  A measurement for the card only: nothing in the
package calls it.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import repro_torch.kernels.util as util  # noqa: E402
from repro_torch.kernels.attention import plan as k7plan  # noqa: E402
from repro_torch.kernels.conv_gemm import plan as k1plan  # noqa: E402
from repro_torch.kernels.depthwise import plan as k2plan  # noqa: E402

KERNELS = ("matmul_bias_act", "depthwise_conv2d", "conv2d_implicit_gemm",
           "flash_attention", "decode_attention")
SOURCES = ("matmul_bias_act", "depthwise_conv2d", "conv2d_implicit_gemm",
           "flash_attention", "rmsnorm")
# K7 decode's cache lengths on the LM path that the tool visits
DECODE_SKS = range(cs.LM_PROMPT + 1, cs.LM_PROMPT + cs.LM_GEN, 8)
# each planner's fitted constants
CONSTS = {
    "matmul_bias_act": (k1plan, ("STEP_NS", "FLOP_PER_NS", "BYTES_PER_NS",
                                 "REDUCE_BYTES_PER_NS", "PAIR_SHARE",
                                 "BLOCK_NS", "DRAM_BYTES_PER_NS")),
    "depthwise_conv2d": (k2plan, ("BLOCK_NS", "BYTES_PER_NS", "OUTPUT_NS",
                                  "DRAM_BYTES_PER_NS")),
}
FACTORS = (0.25, 0.5, 0.7, 0.85, 1.0, 1.2, 1.4, 2.0, 4.0)


def candidates(call: dict) -> list:
    """The planner's (key, plan) candidates at ``call``."""
    c = call
    if c["kernel"] == "matmul_bias_act":
        return k1plan.candidates(c["m"], c["k"], c["n"])
    if c["kernel"] == "conv2d_implicit_gemm":
        return k1plan.k3_candidates(c["n"], c["h"], c["w"], c["ci"],
                                    c["co"], c["k"], c["k"], c["stride"],
                                    c["pad"], c["ci"] % 4 == 0)
    if c["kernel"] == "decode_attention":
        return k7plan.candidates(c["b"], c["hq"], c["hkv"], c["sk"], c["d"])
    if c["kernel"] == "flash_attention":
        return k7plan.flash_candidates(c["b"], c["hq"], c["hkv"], c["sq"],
                                       c["sk"], c["d"], c["causal"],
                                       c["q_offset"], c["sk_valid"])
    ho = (c["h"] + 2 * c["pad"] - c["k"]) // c["stride"] + 1
    wo = (c["w"] + 2 * c["pad"] - c["k"]) // c["stride"] + 1
    return k2plan.candidates(c["n"], ho, wo, c["c"], c["k"], c["k"],
                             c["stride"])


def plan_id(p) -> str:
    """A tiling's name in the sweep's rows."""
    if isinstance(p, k1plan.GemmPlan):
        return f"{p.bm}x{p.bn} bk{p.bk} cl{p.cluster}"
    if isinstance(p, k7plan.DecodePlan):
        return f"cl{p.cluster} sl{p.slots}"
    if isinstance(p, k7plan.FlashPlan):
        return (f"{p.rows} rows ring{p.ring}"
                + (" key split" if p.kv_split == 2 else ""))
    return f"{p.th}x{p.tw} cq{p.cq} ow{p.ow}"


def main(argv=None) -> int:
    """Check and time K1 and K2 at the path shapes; return the exit code."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default="plan_sweep.json")
    ap.add_argument("--fit", metavar="FILE")
    ap.add_argument("--kernel", action="append", choices=KERNELS,
                    help="visit only this kernel (repeatable)")
    args = ap.parse_args(argv)
    kernels = tuple(args.kernel or KERNELS)
    if args.fit:
        return fit(json.loads(Path(args.fit).read_text()))
    if not torch.cuda.is_available():
        print("plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}")
    print(f"kernels built and loaded in {util.timed_build():.1f} s")
    for name in SOURCES:
        for line in util.ptxas_report(name):
            print(f"ptxas {name}: {line}")

    gen = np.random.default_rng(0)
    paths_calls = {p: [c for c in calls if c["kernel"] in kernels]
                   for p, calls in cs.cnn_paths().items()}
    distinct: dict[str, dict] = {}
    for calls in paths_calls.values():
        for c in calls:
            distinct.setdefault(json.dumps(c, sort_keys=True), c)
    decode = [c for c, _w in cs.lm_request_calls(max(cs.lm_group_sizes()))
              if c["kernel"] == "decode_attention" and c["sk"] in DECODE_SKS]
    decode += [c for c in cs.lm_geometry_calls()
               if c["kernel"] == "decode_attention"]
    decode = decode if "decode_attention" in kernels else []
    flash = [c for c, _w in cs.lm_request_calls(max(cs.lm_group_sizes()))
             if c["kernel"] == "flash_attention"]
    flash += [c for c in cs.lm_geometry_calls()
              if c["kernel"] == "flash_attention"]
    flash = flash if "flash_attention" in kernels else []
    for c in decode + flash:
        distinct.setdefault(json.dumps(c, sort_keys=True), c)
    edges = [c for c in cs.edge_calls() if c["kernel"] in kernels]
    rows, worst, missed = {}, 0.0, False
    for key, c in [*distinct.items(), *((None, c) for c in edges)]:
        case = cs.make_case(c, gen)
        err, ok = check(case)
        worst, missed = max(worst, err), missed or not ok
        row = dict(c, plan=cs.kernel_plan(c), err=err, ok=ok)
        if key is not None:
            row["ms"] = util.cuda_time_ms(case["kernel"], reps=args.reps)
            row["library_ms"] = util.cuda_time_ms(case["library"],
                                                  reps=args.reps)
            rows[key] = row
        print(f"{c['kernel']:<17} {cs._shape_str(c):<40} "
              f"{cs.plan_str(row['plan'])}  err {err:.1e}"
              f"{'' if ok else ' MISS'}"
              + (f"  {row['ms']:.4f} ms  library {row['library_ms']:.4f} ms"
                 if key else ""))
        if args.sweep:
            row["sweep"], bad = sweep(c, case, key is not None)
            missed = missed or bad
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
                for name, t in best_times(c["kernel"], r["sweep"]).items():
                    s[name] = s.get(name, 0.0) + t
    if args.sweep:
        for name, calls in (("K7 decode, Qwen2-0.5B path", decode[:-3]),
                            ("K7 decode, other geometries", decode[-3:]),
                            ("K7 flash, Qwen2-0.5B path", flash[:1]),
                            ("K7 flash, other geometries", flash[1:])):
            if not calls:
                continue
            picked = sum(next(x["ms"] for x in rows[json.dumps(
                c, sort_keys=True)]["sweep"] if x["picked"]) for c in calls)
            best = sum(rows[json.dumps(c, sort_keys=True)]["sweep"][0]["ms"]
                       for c in calls)
            sums[name] = dict(calls=len(calls), picked_ms=picked,
                              best_ms=best)
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
        card=cs.card_line(), rows=list(rows.values()), sums=sums,
        per_request=request_counts(paths_calls)), indent=1))
    print(f"largest error {worst:.2e} (rtol = atol = "
          f"{cs.KERNEL_TOL}){'; MISSED' if missed else ''}")
    return 1 if missed else 0


def check(case: dict) -> tuple[float, bool]:
    """The kernel against its plain version: (max |err|, within 1e-4)."""
    got = case["kernel"]()
    want = case["plain"]()
    torch.cuda.synchronize()
    return ((got - want).abs().max().item(),
            torch.allclose(got, want, rtol=cs.KERNEL_TOL, atol=cs.KERNEL_TOL))


def request_counts(paths_calls: dict) -> dict[str, int]:
    """How often a request of all the CNN paths makes each call."""
    return dict(Counter(json.dumps(c, sort_keys=True)
                        for calls in paths_calls.values() for c in calls))


def sweep(call: dict, case: dict, timing: bool) -> tuple[list[dict], bool]:
    """Every candidate tiling at ``call``, each held against the plain
    version and, if ``timing``, timed (fastest first, the fastest timed
    again as ``again_ms``); prints the planner's pick and the three
    fastest.  Returns the rows and whether any tiling missed."""
    import repro_torch.kernels.attention.kernel as k7mod
    import repro_torch.kernels.conv_gemm.kernel as k1mod
    import repro_torch.kernels.depthwise.kernel as k2mod
    mod, name = {"matmul_bias_act": (k1mod, "plan_k1"),
                 "depthwise_conv2d": (k2mod, "plan_k2"),
                 "conv2d_implicit_gemm": (k1mod, "plan_k3"),
                 "decode_attention": (k7mod, "plan_decode"),
                 "flash_attention": (k7mod, "plan_flash")}[call["kernel"]]
    gemm = call["kernel"] in ("matmul_bias_act", "conv2d_implicit_gemm")
    cands = candidates(call)
    pick = min(cands, key=lambda kp: kp[0])[1]
    real = getattr(mod, name)
    out, bad = [], False
    try:
        for _key, p in cands:
            setattr(mod, name, lambda *a, p=p: p)
            err, ok = check(case)
            bad = bad or not ok
            row = dict(name=plan_id(p), blocks=p.blocks, smem=p.smem_bytes,
                       picked=p == pick, err=err, ok=ok)
            if gemm:
                row.update(mi=p.mi, nj=p.nj, stages=p.stages)
            if timing:
                row["ms"] = util.cuda_time_ms(case["kernel"], reps=10,
                                              warmup=2)
            out.append(row)
        if timing:
            out.sort(key=lambda r: r["ms"])
            best = next(p for _k, p in cands if plan_id(p) == out[0]["name"])
            setattr(mod, name, lambda *a: best)
            out[0]["again_ms"] = util.cuda_time_ms(case["kernel"], reps=10,
                                                   warmup=2)
    finally:
        setattr(mod, name, real)
    if bad:
        print(f"  sweep {cs._shape_str(call)}: MISSED at "
              + ", ".join(r["name"] for r in out if not r["ok"]))
    if timing:
        rank = next(i for i, r in enumerate(out) if r["picked"])
        show = lambda r: f"{r['name']} ({r['blocks']} blocks) {r['ms']:.4f}"  # noqa: E731,E501
        print(f"  sweep {cs._shape_str(call)}: picked {show(out[rank])} "
              f"(rank {rank + 1} of {len(out)}); fastest "
              + "; ".join(show(r) for r in out[:3]))
    return out, bad


def best_times(kernel: str, rows: list[dict]) -> dict[str, float]:
    """The fastest tiling's time, the planner's pick's, and for each
    compiled choice the fastest tiling without it."""
    out = dict(best_ms=rows[0]["ms"],
               picked_ms=next(r["ms"] for r in rows if r["picked"]))
    if kernel in ("matmul_bias_act", "conv2d_implicit_gemm"):
        choices = {f"{mi}x{nj}": (lambda r, mi=mi, nj=nj:
                                  (r["mi"], r["nj"]) != (mi, nj))
                   for mi, nj in k1plan.COMPILED}
    elif kernel in ("decode_attention", "flash_attention"):
        choices = {}
    else:
        choices = {f"ow{ow}": (lambda r, ow=ow: not r["name"].endswith(
            f"ow{ow}")) for ow in k2plan.OWS}
    for name, keep in choices.items():
        kept = [r["ms"] for r in rows if keep(r)]
        out[f"without {name} ms"] = kept[0] if kept else float("inf")
    return out


# --------------------------------------------------------------------------
# fitting the cost constants to a sweep
# --------------------------------------------------------------------------
def fit(data: dict) -> int:
    """Fit each planner's constants to ``data`` (a ``--sweep`` run's rows);
    print them and the picks' summed time a request before and after."""
    counts = data["per_request"]
    for kernel, (mod, names) in CONSTS.items():
        shapes = []
        for r in data["rows"]:
            if r["kernel"] != kernel or "sweep" not in r:
                continue
            call = {k: v for k, v in r.items()
                    if k not in ("plan", "err", "ok", "ms", "library_ms",
                                 "sweep")}
            times = {s["name"]: s["ms"] for s in r["sweep"]}
            shapes.append((call, times, counts[json.dumps(call,
                                                          sort_keys=True)]))
        if not shapes:
            continue
        best = sum(w * min(t.values()) for _c, t, w in shapes)

        def cost() -> float:
            total = 0.0
            for call, times, w in shapes:
                p = min(candidates(call), key=lambda kp: kp[0])[1]
                total += w * times[plan_id(p)]
            return total

        start = {n: getattr(mod, n) for n in names}
        before = cost()
        now = before
        for _round in range(3):
            for n in names:
                base = getattr(mod, n)
                trials = []
                for f in FACTORS:
                    setattr(mod, n, base * f)
                    trials.append((cost(), abs(f - 1.0), base * f))
                now, _d, val = min(trials)
                setattr(mod, n, val)
        print(f"{kernel}: picks' sum a request {before:.4f} ms with the "
              f"constants in the source, {now:.4f} ms fitted; the fastest "
              f"tilings' sum {best:.4f} ms")
        for n in names:
            print(f"  {n} = {getattr(mod, n):.6g}  (was {start[n]:.6g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
