"""Where the LM serving path's time goes on the card, under torch.profiler.

  PYTHONPATH=src python tools/profile_lm.py [--requests 8] [--batch 2] \\
      [--prompt-len 512] [--gen 64] [--trace TRACE.json]

Serves Qwen2-0.5B at full width with seeded random weights through a
``DualMeshEngine`` on the card, as ``repro_torch.launch.serve lm`` does
with the planned group size, once to warm up and once under
``torch.profiler``.  Prints the kernels' device time summed over both
streams against the profiled run's wall (the device's busy share; the
profiler slows the host it measures, so the wall is longer than an
unprofiled run's) and the ops that take the most host time, and with
``--trace`` writes a Chrome trace.  A diagnostic for the card only:
nothing in the package calls it.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.dualmesh.partition import split_streams  # noqa: E402
from repro_torch.dualmesh.runtime import (DualMeshRunner,  # noqa: E402
                                          random_prompts)
from repro_torch.kernels.util import resolve_device  # noqa: E402
from repro_torch.lm.model import init_params, params_from_numpy  # noqa: E402
from repro_torch.serving.api import Request, replay  # noqa: E402
from repro_torch.serving.lm import DualMeshEngine  # noqa: E402


def main(argv=None) -> int:
    """Profile one served run and print its busy share and host ops."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--trace", default=None, metavar="TRACE.json")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("qwen2_0_5b")
    params = params_from_numpy(init_params(cfg, seed=0), dev)
    runner = DualMeshRunner(cfg, params, split_streams(dev, 0.5),
                            max_len=args.prompt_len + args.gen + 8)
    prompts = random_prompts(cfg, args.requests, args.batch,
                             args.prompt_len, seed=1, device=dev)
    gens = [args.gen] * args.requests
    group_size = runner.planned_group_size(prompts, gens)

    def run():
        engine = DualMeshEngine(runner, group_size=group_size)
        return replay(engine, [Request(p, gen_steps=args.gen)
                               for p in prompts])

    run()                                           # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run()
    events = prof.key_averages()
    wall_ms = res.stats["wall_s"] * 1e3
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    print(f"[profile] group_size {group_size}; wall {wall_ms:.1f} ms under "
          f"the profiler; kernels' device time, summed over both streams, "
          f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.3f} of the wall)")
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
