"""K6 and K7 at the Qwen2-0.5B path's shapes, and the LM step's device time,
for one checkout of this repository.

    python3 tools/lm_kernels.py [TREE] [--out NAME.json] [--no-model]

Builds the kernel library of TREE (a checkout of this repository, by
default the one holding this script) and, with TREE's own wrappers, holds
against the plain versions (rtol = atol = 1e-4) and times on the device
(``cuda_time_ms``):

- K7 flash at the path's prefill (batch 2, 14/2 heads, D 64, 512 tokens
  against a cache of 584) and at the other dense configs' head geometry
  (Qwen2.5-14B 40/8, Granite-20B 48/1, Command R+ 96/8, D 128), beside
  ``scaled_dot_product_attention``;
- K6 at the path's rows (2, 16 and 1024 of 896): back to back, and "after
  its producer", each call behind the residual add that writes its input,
  the add's own time taken off;
- K7 decode at the path's 16 rows and a cache of 544;
- unless ``--no-model``, Qwen2-0.5B at full width from seed 0: one decode
  step of 16 rows and one prefill forward of 2 x 512 tokens
  (``chip_smoke.lm_device_ms``).

Run it on a parent unpacked with ``git archive`` and on this tree in turns,
in one call, to compare the two on one card.  Rows go to
``chiprun_out/<--out>``.  Exits 1 if a kernel misses the tolerance.  A
measurement for the card only: nothing in the package calls it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ARGS.add_argument("tree", nargs="?",
                  default=str(Path(__file__).resolve().parents[1]))
ARGS.add_argument("--out", default="lm_kernels.json")
ARGS.add_argument("--no-model", action="store_true")
ARGS.add_argument("--reps", type=int, default=20)

ROOT = Path(ARGS.parse_known_args()[0].tree).resolve()
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch.kernels.util as util  # noqa: E402

K6_ROWS = (cs.LM_BATCH, cs.LM_BATCH * 8, cs.LM_BATCH * cs.LM_PROMPT)


def flash_calls() -> list[dict]:
    """The path's prefill call, then the other dense configs' geometry."""
    from repro_torch.configs.registry import get_arch
    out = [cs._flash(cs.LM_BATCH, cs.LM_PROMPT, cs.LM_PROMPT, cs.LM_MAX_LEN)]
    for name in cs.LM_GEOMETRY_ARCHS:
        cfg = get_arch(name)
        out.append(cs._flash(cs.LM_BATCH, cs.LM_PROMPT, cs.LM_PROMPT,
                             cs.LM_MAX_LEN, d=cfg.d_head, hq=cfg.n_heads,
                             hkv=cfg.n_kv_heads))
    return out


def check(case: dict) -> tuple[float, bool]:
    got = case["kernel"]()
    want = case["plain"]()
    torch.cuda.synchronize()
    return ((got - want).abs().max().item(),
            torch.allclose(got, want, rtol=cs.KERNEL_TOL, atol=cs.KERNEL_TOL))


def k6_after(rows: int, gen, reps: int) -> float:
    """K6 behind the add that writes its input, the add's time taken off."""
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    x, h = cs.rand(gen, (rows, 896)), cs.rand(gen, (rows, 896))
    w = cs.rand(gen, (896,), 0.5) + 1.0
    y = torch.empty_like(x)
    both = util.cuda_time_ms(lambda: rmsnorm(torch.add(x, h, out=y), w),
                             reps=reps)
    return both - util.cuda_time_ms(lambda: torch.add(x, h, out=y),
                                    reps=reps)


def main() -> int:
    args = ARGS.parse_args()
    if not torch.cuda.is_available():
        print("lm_kernels: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}; tree {ROOT}")
    print(f"kernels built and loaded in {util.timed_build():.1f} s")
    gen = np.random.default_rng(0)
    rows, missed = [], False
    calls = flash_calls() + [cs._decode(cs.LM_BATCH * 8, 544,
                                        cs.LM_MAX_LEN)]
    for c in calls:
        case = cs.make_case(c, gen)
        err, ok = check(case)
        missed = missed or not ok
        r = dict(c, err=err, ok=ok,
                 ms=util.cuda_time_ms(case["kernel"], reps=args.reps),
                 library_ms=util.cuda_time_ms(case["library"],
                                              reps=args.reps))
        rows.append(r)
        print(f"{c['kernel']:<16} {cs._shape_str(c):<52} ms {r['ms']:.4f} "
              f" library {r['library_ms']:.4f}  err {err:.1e}"
              f"{'' if ok else '  MISSED'}")
    for n in K6_ROWS:
        c = cs._k6(n)
        case = cs.make_case(c, gen)
        err, ok = check(case)
        missed = missed or not ok
        r = dict(c, err=err, ok=ok,
                 ms=util.cuda_time_ms(case["kernel"], reps=args.reps),
                 after_ms=k6_after(n, gen, args.reps),
                 library_ms=util.cuda_time_ms(case["library"],
                                              reps=args.reps))
        rows.append(r)
        print(f"rmsnorm          rows={n:<5} ms {r['ms']:.4f}  after its "
              f"producer {r['after_ms']:.4f}  library {r['library_ms']:.4f}"
              f"  err {err:.1e}{'' if ok else '  MISSED'}")
    model = {}
    if not args.no_model:
        from repro_torch.configs.registry import get_arch
        from repro_torch.lm.model import init_params, params_from_numpy
        cfg = get_arch(cs.LM_ARCH)
        params = params_from_numpy(init_params(cfg, seed=0), cs.DEV)
        step, prefill = cs.lm_device_ms(cfg, params, cs.LM_BATCH * 8)
        step2, prefill2 = cs.lm_device_ms(cfg, params, cs.LM_BATCH * 8)
        model = dict(decode_step_ms=[step, step2],
                     prefill_ms=[prefill, prefill2])
        print(f"qwen2_0_5b device ms: decode step (16 rows, cache "
              f"{cs.LM_PROMPT + cs.LM_GEN // 2}) {step:.3f}, {step2:.3f}; "
              f"prefill forward (2 x {cs.LM_PROMPT}) {prefill:.3f}, "
              f"{prefill2:.3f}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / args.out).write_text(json.dumps(dict(
        card=card, tree=str(ROOT), rows=rows, model=model), indent=1))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
