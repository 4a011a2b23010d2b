"""Serving launcher: the dual-core LM and CNN engines on one CUDA card.

Port of the ``lm`` and ``cnn`` subcommands of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve lm --arch qwen2_0_5b \\
      --requests 8 --batch 2 --prompt-len 512 --gen 64 [--theta 0.5] \\
      [--group-size G] [--prefill-chunk C] [--streams N] \\
      [--arrival-rate 1.0] [--max-queue 64] [--device cuda]

serves the published configuration with seeded random weights through a
``DualMeshEngine``: chunked prefills on the c-core, fused decode groups on
the p-core, the two cores two CUDA streams of the card; every RMSNorm
launches K6 and every attention K7.  Prints the admission plan (the card
cost model's group size and its projected tokens/s), tokens per second,
p50/p95 request latency, the fused decode batch sizes, and the per-stage
c/p trace with each stage's host enqueue time and its time on the
core's stream (idle gaps included).  The reference's
``--search``, ``--plan-chips`` and ``--smoke`` are not ported.

The ``cnn`` subcommand serves all three of the paper's models:

  PYTHONPATH=src python -m repro_torch.launch.serve cnn mobilenet_v1 \\
      --image-size 224 --requests 8 [--batch 2] [--scheme balanced] \\
      [--arrival-rate 1.0] [--max-queue 64] [--device cuda]

(``mobilenet_v2`` and ``squeezenet`` likewise).  Builds the dual-core
schedule and the exec plan, places the seeded weights on the card, and
streams the requests through a ``DualCoreEngine``: each scheduler slot
advances every in-flight image one exec group (the Fig.4b one-slot offset)
and refills the drained group-0 slot from the queue.  The c-core and the
p-core are two CUDA streams sharing all SMs of the card.  Prints the
plan's modelled two-batch latency T_b2 beside the instruction-level
simulator's cycles for two images (``core/simulator.py``, on the modelled
FPGA), images per second, p50/p95 request latency, and the strictly
sequential run's wall time beside the pipelined one.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.core.arch import DUAL_BASELINE, BoardModel
from repro_torch.core.scheduler import best_schedule, build_schedule
from repro_torch.core.simulator import simulate_dual_core
from repro_torch.dualcore.runtime import DualCoreRunner
from repro_torch.dualmesh.cost import CardModel
from repro_torch.dualmesh.partition import split_streams
from repro_torch.dualmesh.runtime import DualMeshRunner, random_prompts
from repro_torch.dualmesh.schedule import plan_admission
from repro_torch.kernels.util import resolve_device, timed_build
from repro_torch.lm.model import init_params, params_from_numpy
from repro_torch.models.cnn import build_model
from repro_torch.serving.api import Request, poisson_arrivals, replay
from repro_torch.serving.cnn import DualCoreEngine
from repro_torch.serving.lm import DualMeshEngine

CNN_MODELS = ("mobilenet_v1", "mobilenet_v2", "squeezenet")
CNN_SCHEMES = ("layer_type", "greedy", "round_robin", "balanced", "best")


def _arrivals(n: int, rate: float) -> list[int]:
    """Arrival trace for n requests: Poisson-ish at ``rate`` per slot, or
    everything at slot 0 when the rate is infinite."""
    if rate == float("inf"):
        return [0] * n
    return poisson_arrivals(n, rate=rate, seed=0)


def serve_lm(args) -> int:
    """``lm`` subcommand: dual-core continuous batching."""
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # full f32, as XLA
        print(f"[serve] kernels built and loaded in {timed_build():.1f} s")
    n = args.requests
    n_streams = args.streams or n
    dual = split_streams(dev, args.theta)
    plan = plan_admission(cfg, dual, CardModel(), args.batch,
                          args.prompt_len, args.gen, n_streams,
                          max_group=args.group_size)
    group_size = args.group_size or plan.group_size
    print(f"[serve] admission plan: group_size={group_size} (est "
          f"{plan.est_tokens_per_s:.0f} tok/s on the card cost model)")
    params = params_from_numpy(init_params(cfg, seed=0), dev)
    runner = DualMeshRunner(cfg, params, dual,
                            max_len=args.prompt_len + args.gen + 8)
    prompts = random_prompts(cfg, n, args.batch, args.prompt_len, seed=1,
                             device=dev)
    if dev.type == "cuda":                          # warm-up
        runner.serve(prompts[:1], gen_steps=2, group_size=1)
    engine = DualMeshEngine(runner, group_size=group_size,
                            prefill_chunk=args.prefill_chunk,
                            max_queue=args.max_queue)
    start = len(runner.trace)
    res = replay(engine, [Request(p, gen_steps=args.gen) for p in prompts],
                 _arrivals(n, args.arrival_rate))
    s = res.stats
    print(f"[serve] lm {cfg.name}: {n} requests x batch {args.batch}, "
          f"prompt {args.prompt_len}, {args.gen} generated, on "
          f"{runner.device}; {dual.cores.describe()}")
    print(f"[serve] {s['wall_s'] * 1e3:.1f} ms ({s['tokens_per_s']:.1f} "
          f"tok/s, {s['total_tokens']} tokens, fused decode batches "
          f"{s['fused_sizes']})")
    m = res.metrics
    print(f"[serve] latency: p50 {m.p50_ms():.1f} ms, p95 {m.p95_ms():.1f} "
          f"ms over {m.completed} requests")
    stream_ms = runner.trace_stream_ms()[start:]
    for (kind, core, t), sms in zip(res.trace, stream_ms):
        on_card = "" if sms is None else f", on its stream {sms:9.2f} ms"
        print(f"  {kind:<8} on {core}-core  host {t * 1e3:8.2f} ms{on_card}")
    return 0


def serve_cnn(args) -> int:
    """``cnn`` subcommand: streaming CNN serving on the c/p streams."""
    board = BoardModel()
    params, _, graph = build_model(args.model, device=args.device)
    if args.scheme == "best":
        sched = best_schedule(graph, DUAL_BASELINE, board)
    else:
        sched = build_schedule(graph, DUAL_BASELINE, board, args.scheme)
    runner = DualCoreRunner(args.model, params, sched, device=args.device)
    es = runner.plan.exec_schedule
    n = args.requests
    rng = np.random.default_rng(0)
    images = [torch.from_numpy(rng.standard_normal(
        (args.batch, args.image_size, args.image_size, 3),
        dtype=np.float32)).to(runner.device) for _ in range(n)]
    runner.run_sequential(images[:1])              # warm-up (kernel build)

    engine = DualCoreEngine(runner, max_queue=args.max_queue)
    res = replay(engine, [Request(x) for x in images],
                 _arrivals(n, args.arrival_rate))
    _, t_seq = runner.timed(images, "sequential", reps=2)

    sim = simulate_dual_core(es)
    print(f"[serve] cnn {args.model} scheme={sched.scheme}: "
          f"{len(es.groups)} exec groups; {runner.cores.describe()}")
    print(f"[serve] model-side: T_b2={es.t_b2():,} cyc "
          f"(sim {sim.cycles_two_images:,} cyc, "
          f"{board.cycles_to_seconds(sim.cycles_two_images)*1e3:.2f} ms "
          f"@{board.freq_mhz:.0f}MHz on the modelled FPGA), "
          f"pipeline speedup {2*sum(es.group_latencies)/es.t_b2():.2f}x")
    s = res.stats
    print(f"[serve] streamed {n} request(s) x batch {args.batch} @ "
          f"{args.image_size}px on {runner.device} in {s['slots']} slots: "
          f"{s['wall_s']*1e3:.1f} ms ({n*args.batch/s['wall_s']:.2f} img/s), "
          f"sequential {t_seq*1e3:.1f} ms ({t_seq/s['wall_s']:.2f}x)")
    m = res.metrics
    print(f"[serve] latency: p50 {m.p50_ms():.1f} ms, p95 {m.p95_ms():.1f} "
          f"ms over {m.completed} requests")
    return 0


def main(argv=None):
    """Parse the command line and run the subcommand."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="Serve the LM or a CNN through the dual-core streaming "
                    "engines on one CUDA card.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    lm = sub.add_parser("lm", help="dual-core LM continuous batching")
    lm.add_argument("--arch", choices=ARCH_IDS, required=True)
    lm.add_argument("--requests", type=int, default=2,
                    help="number of requests to serve (>= 1)")
    lm.add_argument("--batch", type=int, default=2)
    lm.add_argument("--arrival-rate", type=float, default=float("inf"),
                    help="Poisson-ish arrivals per scheduler slot "
                         "(default inf: everything at slot 0)")
    lm.add_argument("--max-queue", type=int, default=None,
                    help="bounded request queue (backpressure beyond it)")
    lm.add_argument("--prompt-len", type=int, default=16)
    lm.add_argument("--gen", type=int, default=8)
    lm.add_argument("--theta", type=float, default=0.5)
    lm.add_argument("--streams", type=int, default=None,
                    help="concurrent streams the planner optimizes for "
                         "(default: --requests)")
    lm.add_argument("--group-size", type=int, default=None,
                    help="decode fusion width (default: makespan-aware)")
    lm.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill slice in tokens")
    lm.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or "
                         "'cpu' (the plain versions)")
    lm.set_defaults(func=serve_lm)
    cnn = sub.add_parser("cnn", help="dual-core CNN streaming pipeline")
    cnn.add_argument("model", choices=CNN_MODELS)
    cnn.add_argument("--scheme", choices=CNN_SCHEMES, default="balanced",
                     help="dual-core allocation scheme")
    cnn.add_argument("--image-size", type=int, default=64,
                     help="input H=W (224 = paper size)")
    cnn.add_argument("--requests", type=int, default=2,
                     help="number of requests to serve (>= 1)")
    cnn.add_argument("--batch", type=int, default=2)
    cnn.add_argument("--arrival-rate", type=float, default=float("inf"),
                     help="Poisson-ish arrivals per scheduler slot "
                          "(default inf: everything at slot 0)")
    cnn.add_argument("--max-queue", type=int, default=None,
                     help="bounded request queue (backpressure beyond it)")
    cnn.add_argument("--device", default="cuda",
                     help="'cuda' (default; raises without a card) or "
                          "'cpu' (the plain versions)")
    cnn.set_defaults(func=serve_cnn)
    args = ap.parse_args(argv)
    if args.requests < 1:
        ap.error(f"--requests must be >= 1, got {args.requests}")
    if args.max_queue is not None and args.max_queue < 1:
        ap.error(f"--max-queue must be >= 1, got {args.max_queue}")
    if not args.arrival_rate > 0:
        ap.error(f"--arrival-rate must be > 0, got {args.arrival_rate}")
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
