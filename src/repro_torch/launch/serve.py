"""Serving launcher: the dual-core LM and CNN engines on one CUDA card.

Port of the ``lm`` and ``cnn`` subcommands of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve lm --arch qwen2_0_5b \\
      --requests 8 --batch 2 --prompt-len 512 --gen 64 [--smoke] \\
      [--theta 0.5 | --search [--plan-chips N]] \\
      [--group-size G] [--prefill-chunk C] [--streams N] \\
      [--arrival-rate 1.0] [--max-queue 64] [--device cuda]

serves the published configuration (``--smoke``: the reduced one) with
seeded random weights through a ``DualMeshEngine``: chunked prefills on
the c-core, fused decode groups on the p-core, the two cores two green
contexts on disjoint SMs of the card split at ``--theta``; every RMSNorm
launches K6 and every attention K7.  Every registered architecture serves
but Whisper (``whisper_small``: serving has no encoder input, a
``ValueError``); xLSTM and Zamba2 carry their SSM states in the decode
lanes, and Qwen2-VL serves text on RoPE, as the reference does.  With ``--search`` the §V-B design
flow picks theta first: a branch and bound over the card's SMs
(``dualmesh/search.py``; with ``--plan-chips N`` over N abstract cards,
as the reference plans), and the design-flow line prints the theta, both
cores' SMs, the planned makespan and tokens/s and which plan it was.
Prints the admission plan (the card cost model's group size and its
projected makespan and tokens/s, each core priced at its share of the
card's SMs), tokens per second, p50/p95 request latency, the fused
decode batch sizes, and the per-stage c/p trace with each stage's host
enqueue time and its time on the core's stream (idle gaps included).

The ``cnn`` subcommand serves all three of the paper's models:

  PYTHONPATH=src python -m repro_torch.launch.serve cnn mobilenet_v1 \\
      --image-size 224 --requests 8 [--batch 2] [--scheme balanced] \\
      [--arrival-rate 1.0] [--max-queue 64] [--device cuda]

(``mobilenet_v2`` and ``squeezenet`` likewise).  Builds the dual-core
schedule and the exec plan, places the seeded weights on the card, and
streams the requests through a ``DualCoreEngine``: each scheduler slot
advances every in-flight image one exec group (the Fig.4b one-slot offset)
and refills the drained group-0 slot from the queue.  The c-core and the
p-core are two green contexts on disjoint halves of the card's SMs.
Prints the plan's modelled two-batch latency T_b2 beside the instruction-level
simulator's cycles for two images (``core/simulator.py``, on the modelled
FPGA), images per second, p50/p95 request latency, and the strictly
sequential run's wall time beside the pipelined one.

The ``fleet`` subcommand serves several CNNs at once through one pool of
the card's two cores:

  PYTHONPATH=src python -m repro_torch.launch.serve fleet \\
      --models mobilenet_v1,mobilenet_v2,squeezenet --image-size 224 \\
      --batch 2 --requests 24 [--mix 2,1,1] [--policy weighted_fair] \\
      [--burst 4] [--co-dispatch N | --no-interleave] [--plan] \\
      [--pools N [--transport local|file [--spool DIR]]] \\
      [--workers N --transport socket [--kill-worker POOL@STEP] \\
       [--verify-replay]] \\
      [--faults PLAN.json] [--slo-ms X] [--adapt [--control-interval K]] \\
      [--trace PATH] [--metrics PATH [--metrics-every K]] [--device cuda]

builds one ``DualCoreEngine`` per model on the pool's leased split behind
a ``FleetEngine`` (or, with ``--pools N``, N such fleets behind a
``MultiPoolRouter`` that places each request on the least loaded pool),
streams model-tagged requests in the ``--mix`` proportions, and prints the
aggregate rate, per-model p50/p95, the host's enqueue time per fleet slot
and, with ``--plan``, the Table VII planner's predicted rows beside the
measured ones.  With ``--workers N --transport socket`` each pool is a
worker process of its own (``python -m repro_torch.fleet.worker``, one
CUDA context and one split of the card's SMs each, at the pool's default
theta 0.5) behind the same router, over framed sockets; ``--kill-worker
POOL@STEP`` SIGKILLs one mid-run, the ``exactly-once:`` line counts the
retired requests, and ``--verify-replay`` replays the collected streams
on fresh in-process fleets (exit 1 if either check fails).

``--adapt`` attaches a closed-loop controller
(``repro_torch.fleet.ControlLoop``) to each pool's fleet: every
``--control-interval`` slots it observes the sliding completion window
and injects SET_PARAM / REBALANCE instructions, re-weighting member
shares toward the observed arrival mix, narrowing or widening retunable
engines' fusion width on p95 SLO breaches (needs ``--slo-ms``), and
re-splitting the card's SMs at a re-planned theta on sustained shedding
(the planner's host search runs inside the slot, ``--plan-evals`` deep).
The summary reports the decisions taken; the injected instructions land
in the recorded stream, so the run replays bitwise without the
controller.  ``--adapt`` runs in process: with ``--workers`` it is a
usage error (exit 2).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_arch, get_smoke
from repro_torch.core.arch import DUAL_BASELINE, BoardModel
from repro_torch.core.scheduler import best_schedule, build_schedule
from repro_torch.core.simulator import simulate_dual_core
from repro_torch.dualcore.runtime import DualCoreRunner
from repro_torch.dualmesh.partition import split_streams
from repro_torch.dualmesh.runtime import (DualMeshRunner, check_servable,
                                          random_prompts)
from repro_torch.dualmesh.schedule import plan_admission, request_stages
from repro_torch.dualmesh.search import card_model, search
from repro_torch.fleet import (POLICY_NAMES, ControlLoop, FaultInjector,
                               FaultPlan, FileTransport, FleetEngine,
                               MultiPoolRouter, RecoveryConfig,
                               build_cnn_fleet, connect, make_policy,
                               mix_schedule, normalize_mix, plan_fleet,
                               plan_rows, start_workers, stop_workers,
                               stream_signature)
from repro_torch.fleet.trace import (host_enqueue_ms, roofline_model,
                                     write_chrome_trace)
from repro_torch.kernels.util import resolve_device, timed_build
from repro_torch.lm.model import load_params
from repro_torch.models.cnn import build_model
from repro_torch.obs import write_metrics
from repro_torch.serving.api import (QueueFull, Request, ShedPolicy,
                                     poisson_arrivals, replay)
from repro_torch.serving.cnn import DualCoreEngine
from repro_torch.serving.lm import DualMeshEngine

CNN_MODELS = ("mobilenet_v1", "mobilenet_v2", "squeezenet")
CNN_SCHEMES = ("layer_type", "greedy", "round_robin", "balanced", "best")
MODEL_ALIASES = {"mbv1": "mobilenet_v1", "mbv2": "mobilenet_v2",
                 "sqz": "squeezenet", **{m: m for m in CNN_MODELS}}


def _fail(msg: str) -> None:
    """Usage error: one line on stderr and exit code 2."""
    print(f"repro_torch.launch.serve: error: {msg}", file=sys.stderr)
    raise SystemExit(2)


def _arrivals(n: int, rate: float) -> list[int]:
    """Arrival trace for n requests: Poisson-ish at ``rate`` per slot, or
    everything at slot 0 when the rate is infinite."""
    if rate == float("inf"):
        return [0] * n
    return poisson_arrivals(n, rate=rate, seed=0)


def serve_lm(args) -> int:
    """``lm`` subcommand: dual-core continuous batching."""
    if args.plan_chips is not None and (not args.search
                                        or args.plan_chips < 2):
        _fail("--plan-chips N takes --search and N >= 2")
    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    check_servable(cfg)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # full f32, as XLA
        print(f"[serve] kernels built and loaded in {timed_build():.1f} s")
    n = args.requests
    n_streams = args.streams or n
    theta = args.theta
    res = None
    hw = card_model(dev)
    if args.search:
        stages = request_stages(cfg, [(args.batch, args.prompt_len,
                                       args.gen)])
        res = search(stages, cfg, n_devices=args.plan_chips, hw=hw,
                     max_evals=10, n_streams=n_streams)
        theta = res.theta
    dual = split_streams(dev, theta)
    if res is not None:
        split = res.dual
        card = "the card" if dev.type == "cuda" else "a modelled H100"
        where = (f"on {args.plan_chips} abstract cards (c {split.c_chips}, "
                 f"p {split.p_chips} chips)" if args.plan_chips else
                 f"on {card}'s {res.sms} SMs (c {split.c_sms}, p "
                 f"{split.p_sms})")
        served = (f"c {dual.cores.sms('c')} SMs, p {dual.cores.sms('p')}"
                  if dual.cores.sm_split else dual.cores.describe())
        print(f"[serve] design flow: theta={theta:.4f} tp=({res.tp_c},"
              f"{res.tp_p}) n_streams={n_streams} planned makespan="
              f"{res.makespan * 1e3:.1f} ms tokens/s={res.tokens_per_s:.0f}"
              f" {where}{' (nothing fits: relaxed)' if res.relaxed else ''}"
              f"; visited {', '.join(f'{t:.4f}' for t in res.visited)}; "
              f"served at theta {dual.theta:.4f}: {served}")
    plan = plan_admission(cfg, dual, hw, args.batch,
                          args.prompt_len, args.gen, n_streams,
                          max_group=args.group_size)
    group_size = args.group_size or plan.group_size
    print(f"[serve] admission plan: group_size={group_size} (est makespan "
          f"{plan.est_makespan * 1e3:.1f} ms, {plan.est_tokens_per_s:.0f} "
          f"tok/s on the card cost model, the c-core priced at "
          f"{dual.c_share:.4f} of the card and the p-core at "
          f"{dual.p_share:.4f})")
    params = load_params(cfg, seed=0, device=dev)
    runner = DualMeshRunner(cfg, params, dual,
                            max_len=args.prompt_len + args.gen + 8)
    prompts = random_prompts(cfg, n, args.batch, args.prompt_len, seed=1,
                             device=dev)
    if dev.type == "cuda":
        # warm-up, untimed: builds the kernels and captures a decode graph
        # for each width the queue's fused groups take
        for width in sorted({min(group_size, n - i)
                             for i in range(0, n, group_size)}):
            runner.serve(prompts[:width], gen_steps=2, group_size=width)
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
    # warm-up, untimed: builds the kernels and, on the card, captures the
    # exec groups' graphs on as many lanes as the traffic holds at once
    runner.run_pipelined(images)

    engine = DualCoreEngine(runner, max_queue=args.max_queue)
    res = replay(engine, [Request(x) for x in images],
                 _arrivals(n, args.arrival_rate))
    _, t_seq = runner.timed(images, "sequential", reps=2)

    sim = simulate_dual_core(es)
    print(f"[serve] cnn {args.model} scheme={sched.scheme}: "
          f"{len(es.groups)} exec groups; {runner.cores.describe()}")
    if runner.lanes.count:
        print(f"[serve] compiled groups: {runner.lanes.count} lane(s) of "
              f"{len(es.groups)} CUDA graphs captured in "
              f"{runner.capture_s * 1e3:.1f} ms before serving")
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


class _MetricsSink:
    """``--metrics PATH`` / ``--metrics-every K``: without K the final
    registry snapshot is written once (``-`` = Prometheus text on
    stdout, ``.json`` = JSON, else Prometheus text); with K one
    ``{"step", "snapshot"}`` JSON line every K steps plus a final one."""

    def __init__(self, path: str | None, every: int | None):
        self.path = path
        self.every = every
        self.registry = None      # set once the engine or router exists
        self._started = False

    def on_step(self, step: int) -> None:
        """``replay``'s per-step hook."""
        if self.registry is not None and self.every \
                and (step + 1) % self.every == 0:
            self._append(step)

    def _append(self, step: int) -> None:
        line = json.dumps({"step": step,
                           "snapshot": self.registry.snapshot()},
                          sort_keys=True)
        if self.path == "-":
            print(line)
            return
        with open(self.path, "a" if self._started else "w") as f:
            f.write(line + "\n")
        self._started = True

    def finish(self, steps: int) -> None:
        """Write the final snapshot (or the last series line)."""
        if self.registry is None or self.path is None:
            return
        if self.every:
            self._append(steps)
            return
        fmt = write_metrics(self.registry, self.path)
        if self.path != "-":
            print(f"[serve] wrote {fmt} metrics to {self.path}")


def _parse_fleet_mix(args) -> dict[str, float]:
    """``--models``/``--mix`` -> normalized {model: share}."""
    names = []
    for tok in args.models.split(","):
        tok = tok.strip()
        if tok not in MODEL_ALIASES:
            _fail(f"unknown model {tok!r} in --models; one of "
                  f"{sorted(MODEL_ALIASES)}")
        names.append(MODEL_ALIASES[tok])
    if len(set(names)) != len(names):
        _fail(f"duplicate models in --models: {names}")
    shares = [1.0] * len(names)
    if args.mix is not None:
        try:
            shares = [float(t) for t in args.mix.split(",")]
        except ValueError:
            _fail(f"--mix must be comma-separated numbers "
                  f"(got {args.mix!r})")
        if len(shares) != len(names):
            _fail(f"{len(names)} models in --models but {len(shares)} "
                  f"shares in --mix")
    try:
        return normalize_mix(dict(zip(names, shares)))
    except ValueError as e:
        _fail(str(e))


def _parse_kill(args) -> tuple[str, int] | None:
    """``--kill-worker POOL@STEP`` -> (pool, router step), checked against
    the ``--workers`` pools' names."""
    if args.kill_worker is None:
        return None
    pool, sep, at = args.kill_worker.partition("@")
    if not sep or not at.isdigit():
        _fail(f"--kill-worker wants POOL@STEP (e.g. pool1@3), got "
              f"{args.kill_worker!r}")
    pools = [f"pool{p}" for p in range(args.workers)]
    if pool not in pools:
        _fail(f"--kill-worker pool {pool!r} is not one of {pools}")
    return pool, int(at)


def _serve_fleet_workers(args, mix, kill, build, requests, arrivals) -> int:
    """``fleet --workers N --transport socket``: each pool is a worker
    process (``python -m repro_torch.fleet.worker``) hosting the same CNN
    fleet; this process drives them over the socket transport through the
    standard ``MultiPoolRouter`` placement, migration and crash recovery.
    Each worker loads the kernel library this process built."""
    pools = [f"pool{p}" for p in range(args.workers)]
    wargs = ["--models", ",".join(mix),
             "--image-size", str(args.image_size),
             "--batch", str(args.batch), "--device", args.device,
             "--scheme", args.scheme, "--policy", args.policy,
             "--burst", str(args.burst)]
    co = 0 if args.no_interleave else args.co_dispatch
    if co is not None:
        wargs += ["--co-dispatch", str(co)]
    if args.max_queue is not None:
        wargs += ["--max-queue", str(args.max_queue)]

    recovery = RecoveryConfig()
    print(f"[serve] spawning {args.workers} worker process(es): python -m "
          f"repro_torch.fleet.worker --pool <name> {' '.join(wargs)}")
    procs = start_workers({p: list(wargs) for p in pools})
    print("[serve] workers ready (spawn to READY): "
          + ", ".join(f"{p} {procs[p].ready_s:.1f} s" for p in pools))
    sink = _MetricsSink(args.metrics, args.metrics_every)
    fleets = {}
    try:
        fleets = connect(procs, heartbeat_s=recovery.heartbeat_s)
        router = MultiPoolRouter(fleets, recovery=recovery)
        sink.registry = router.obs

        def collect_telemetry():
            for ex in router.executors.values():
                if ex._handle.lost is None:
                    ex._handle.collect(ex)

        addrs = ", ".join(f"{p}={procs[p].address}" for p in pools)
        print(f"[serve] fleet {'+'.join(mix)} x {args.workers} workers "
              f"over SocketTransport ({addrs})")
        # replay()'s open loop, plus the mid-run SIGKILL
        order = sorted(range(len(requests)), key=lambda i: arrivals[i])
        refused, nxt, step = [], 0, 0
        while nxt < len(order) or refused or router.has_work:
            if kill is not None and step >= kill[1]:
                print(f"[serve] SIGKILL worker {kill[0]} at router "
                      f"step {step}")
                procs[kill[0]].kill()
                kill = None
            due, refused = refused, []
            while nxt < len(order) and arrivals[order[nxt]] <= step:
                due.append(order[nxt])
                nxt += 1
            for i in due:
                try:
                    router.submit(requests[i])
                except QueueFull:
                    refused.append(i)
            router.step()
            if args.metrics:
                # pull each worker's cumulative snapshot every step so a
                # SIGKILL loses at most the last unshipped window
                collect_telemetry()
                sink.on_step(step)
            step += 1
        if args.metrics:
            collect_telemetry()
        res = router.result()
        st = res.stats
        streams = router.streams()
        placements = list(router.placements)
        events = list(router.events)
    finally:
        stop_workers(fleets, procs)

    n = len(requests)
    sink.finish(st["steps"])
    print(f"[serve] streamed {n} request(s) x batch {args.batch} @ "
          f"{args.image_size}px over {args.workers} workers in "
          f"{st['steps']} router steps: {st['wall_s'] * 1e3:.1f} ms, "
          f"{n * args.batch / st['wall_s']:.2f} img/s")
    for pname, pp in st["pools"].items():
        served = ", ".join(f"{m}:{c}" for m, c in pp["served"].items())
        print(f"  {pname:<8} {pp['slots']} slots {pp['dispatches']} "
              f"dispatches  served {served or '-'}")
    for name, pm in st["per_model"].items():
        print(f"  {name:<14} {pm['completed']} done  p50 "
              f"{pm['p50_ms']:.2f} ms  p95 {pm['p95_ms']:.2f} ms  "
              f"{pm['requests_per_s'] * args.batch:.2f} img/s")
    done = len(res.completions)
    print(f"[serve] exactly-once: {done}/{n} retired, "
          f"{st['duplicates_dropped']} duplicates dropped, "
          f"{st['failed']} failed, {st['recovered']} recovered, "
          f"dead workers {st['dead'] or '-'}")
    if done != n or st["duplicates_dropped"] or st["failed"]:
        print("repro_torch.launch.serve: error: exactly-once retirement "
              "violated", file=sys.stderr)
        return 1
    if args.verify_replay:
        fresh = MultiPoolRouter({p: build()[0] for p in pools})
        fresh.replay(streams, placements, requests, events)
        for p, recs in streams.items():
            if stream_signature(recs) != stream_signature(
                    fresh.executors[p].records):
                print(f"repro_torch.launch.serve: error: replay diverged "
                      f"on {p}", file=sys.stderr)
                return 1
        print(f"[serve] replay verified: "
              f"{sum(len(r) for r in streams.values())} records across "
              f"{len(streams)} pool(s) replay bitwise on fresh in-process "
              f"fleets")
    if args.trace:
        events_n, _ = write_chrome_trace(streams, args.trace)
        print(f"[serve] wrote {events_n} trace events to {args.trace} "
              f"(host windows; open in chrome://tracing)")
    return 0


def serve_fleet(args) -> int:
    """``fleet`` subcommand: several CNNs over one pool of the card's
    two cores, ``--pools N`` in-process pools behind a router, or
    ``--workers N`` worker processes behind ``--transport socket``."""
    mix = _parse_fleet_mix(args)
    if args.pools < 1:
        _fail(f"--pools must be >= 1, got {args.pools}")
    if args.workers < 0:
        _fail(f"--workers must be >= 0, got {args.workers}")
    if args.workers:
        if args.transport != "socket":
            _fail(f"--workers {args.workers} puts each pool in its own "
                  f"process; only --transport socket crosses process "
                  f"boundaries ({args.transport!r} is an in-process "
                  f"mailbox binding: use --pools for it)")
        if args.pools != 1:
            _fail("--workers and --pools are mutually exclusive: "
                  "workers are processes, pools are in this process")
        if args.faults is not None:
            _fail("--faults is in-process fault injection; with "
                  "--workers, kill a process instead "
                  "(--kill-worker POOL@STEP)")
        if args.adapt:
            _fail("--adapt runs a per-pool in-process controller; it is "
                  "not supported over --workers")
        if args.slo_ms is not None:
            _fail("--slo-ms attaches in-process shed policies; it is "
                  "not supported over --workers")
        if args.plan:
            _fail("--plan is not supported over --workers (each worker "
                  "builds its own fleet from the model list)")
    elif args.transport == "socket":
        _fail("--transport socket needs --workers N (worker processes "
              "to talk to)")
    elif args.transport == "file" and args.pools < 2:
        _fail("--transport file is the multi-pool spool mailbox; it "
              "needs --pools >= 2")
    if args.spool is not None and args.transport != "file":
        _fail("--spool only applies to --transport file")
    if args.kill_worker is not None and not args.workers:
        _fail("--kill-worker needs --workers")
    if args.verify_replay and not args.workers:
        _fail("--verify-replay needs --workers (the in-process paths "
              "have replay tests of their own)")
    kill = _parse_kill(args)
    if args.slo_ms is not None and not args.slo_ms > 0:
        _fail(f"--slo-ms must be > 0, got {args.slo_ms}")
    if args.control_interval < 1:
        _fail(f"--control-interval must be >= 1, got "
              f"{args.control_interval}")
    if args.metrics_every is not None and not args.metrics:
        _fail("--metrics-every needs --metrics PATH")
    if args.metrics_every is not None and args.metrics_every < 1:
        _fail(f"--metrics-every must be >= 1, got {args.metrics_every}")
    fault_plan = None
    if args.faults is not None:
        try:
            fault_plan = FaultPlan.load(args.faults)
        except (OSError, ValueError) as e:
            _fail(f"--faults {args.faults!r}: {e}")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"[serve] kernels built and loaded in {timed_build():.1f} s")
    admission = None
    if args.slo_ms is not None:
        admission = {m: ShedPolicy(slo_s=args.slo_ms / 1e3, clock="wall")
                     for m in mix}
    plan = None
    if args.plan:
        plan = plan_fleet(mix, max_evals=args.plan_evals)
        print(f"[serve] fleet plan: config={plan.config} "
              f"theta={plan.theta:.2f} predicted aggregate "
              f"{plan.aggregate_fps:.1f} fps on the modelled FPGA")

    def build():
        return build_cnn_fleet(
            list(mix), device=dev, plan=plan, scheme=args.scheme,
            policy=make_policy(args.policy), weights=mix,
            admission=admission, max_queue=args.max_queue,
            co_dispatch=0 if args.no_interleave else args.co_dispatch,
            burst=args.burst)

    n = args.requests
    rng = np.random.default_rng(0)
    # requests to worker processes cross the wire from the host
    at = torch.device("cpu") if args.workers else dev
    images = [torch.from_numpy(rng.standard_normal(
        (args.batch, args.image_size, args.image_size, 3),
        dtype=np.float32)).to(at) for _ in range(n)]
    requests = [Request(x, model=t)
                for x, t in zip(images, mix_schedule(mix, n))]
    arrivals = _arrivals(n, args.arrival_rate)
    if args.workers:
        return _serve_fleet_workers(args, mix, kill, build, requests,
                                    arrivals)
    sink = _MetricsSink(args.metrics, args.metrics_every)
    injector = FaultInjector(fault_plan) if fault_plan is not None else None
    if args.pools == 1:
        engine = build()[0]
        engine.executor.injector = injector
        fleets = {"pool0": engine}
    else:
        fleets = {f"pool{p}": build()[0] for p in range(args.pools)}
        transport = None
        if args.transport == "file":
            spool = args.spool or tempfile.mkdtemp(prefix="repro_spool_")
            transport = FileTransport(spool)
            print(f"[serve] inter-pool migration spooled through {spool}")
        engine = MultiPoolRouter(fleets, injector=injector,
                                 transport=transport)
    controllers = ({name: ControlLoop(fl, interval=args.control_interval,
                                      slo_ms=args.slo_ms,
                                      plan_evals=args.plan_evals)
                    for name, fl in fleets.items()} if args.adapt else {})
    for fl in fleets.values():
        # warm-up: one untimed pass over the same runners builds the
        # kernels, fills the caching allocator's pools of the new streams
        # and captures each member's per-group graphs on the lanes the
        # traffic holds at once
        replay(FleetEngine({m.name: DualCoreEngine(m.engine.runner)
                            for m in fl.members}, burst=args.burst),
               [Request(r.payload, model=r.model) for r in requests])
    pool_desc = next(iter(fleets.values())).pool.cores.describe()
    print(f"[serve] fleet {'+'.join(mix)} x {args.pools} pool(s) "
          f"policy={args.policy} burst={args.burst}; {pool_desc}")
    sink.registry = engine.executor.obs if args.pools == 1 else engine.obs
    res = replay(engine, requests, arrivals, on_step=sink.on_step)
    st = res.stats
    steps = st["slots"] if args.pools == 1 else st["steps"]
    streams = {name: fl.executor.records for name, fl in fleets.items()}
    host = [host_enqueue_ms(recs) for recs in streams.values()]
    print(f"[serve] streamed {n} request(s) x batch {args.batch} @ "
          f"{args.image_size}px on {dev} in {steps} "
          f"{'fleet slots' if args.pools == 1 else 'router steps'}: "
          f"{st['wall_s'] * 1e3:.1f} ms, {n * args.batch / st['wall_s']:.2f}"
          f" img/s; host enqueue a fleet slot "
          + ", ".join(f"{h:.3f}" for h in host) + " ms")
    for name, pm in st["per_model"].items():
        print(f"  {name:<14} {pm['completed']} done  p50 "
              f"{pm['p50_ms']:.2f} ms  p95 {pm['p95_ms']:.2f} ms  "
              f"{pm['requests_per_s'] * args.batch:.2f} img/s")
    if args.pools > 1:
        for pname, pp in st["pools"].items():
            served = ", ".join(f"{m}:{c}" for m, c in pp["served"].items())
            print(f"  {pname:<8} {pp['slots']} slots {pp['dispatches']} "
                  f"dispatches  served {served or '-'}")
    if plan is not None:
        measured = {m: v["requests_per_s"] * args.batch
                    for m, v in st["per_model"].items()}
        print("[serve] Table VII rows: model-side and predicted fps on the "
              "modelled FPGA, measured img/s on the device:")
        for name, share, fps, pred, meas in plan_rows(
                plan, measured, n * args.batch / st["wall_s"]):
            print(f"  {name:<14} share={share:.2f} model-side={fps:8.1f} "
                  f"predicted={pred:8.1f} measured="
                  + (f"{meas:8.2f}" if meas is not None else "     n/a"))
    if args.slo_ms is not None or fault_plan is not None:
        m = res.metrics
        print(f"[serve] goodput {m.goodput_fps() * args.batch:.2f} img/s "
              f"(shed {m.count('shed')}, failed {m.count('failed')}, "
              f"recovered {m.count('recovered')})")
    for pname, ctl in controllers.items():
        cs = ctl.stats()
        weights = ", ".join(f"{mm.name}={mm.weight:.2f}"
                            for mm in fleets[pname].members)
        print(f"[serve] control{'' if args.pools == 1 else ' ' + pname}: "
              f"{cs['observations']} observations, {cs['decisions']} "
              f"decisions {cs['by_kind'] or '{}'}; final weights {weights}")
    sink.finish(steps)
    if args.trace:
        events, _ = write_chrome_trace(streams, args.trace,
                                       roofline=roofline_model(engine))
        print(f"[serve] wrote {events} trace events to {args.trace} (host "
              f"windows; open in chrome://tracing)")
    return 0


def main(argv=None):
    """Parse the command line and run the subcommand."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="Serve the LM, a CNN or a fleet of CNNs through the "
                    "dual-core streaming engines on one CUDA card.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    lm = sub.add_parser("lm", help="dual-core LM continuous batching")
    lm.add_argument("--arch", choices=ARCH_IDS, required=True)
    lm.add_argument("--smoke", action="store_true",
                    help="the reduced configuration (get_smoke)")
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
    lm.add_argument("--search", action="store_true",
                    help="run the design-flow search for theta first "
                         "(on the card's SMs)")
    lm.add_argument("--plan-chips", type=int, default=None, metavar="N",
                    help="with --search: plan on N abstract cards, as the "
                         "reference does, instead of the card's SMs")
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
    fleet = sub.add_parser("fleet", help="several CNNs over one pool of "
                                         "the card's two cores")
    fleet.add_argument("--models", default="mbv1,mbv2,squeezenet",
                       help="comma-separated member models "
                            "(aliases: mbv1, mbv2, sqz)")
    fleet.add_argument("--mix", default=None,
                       help="comma-separated qps shares aligned with "
                            "--models (default: equal)")
    fleet.add_argument("--policy", choices=POLICY_NAMES,
                       default="weighted_fair",
                       help="cross-engine step scheduling policy")
    fleet.add_argument("--scheme", choices=CNN_SCHEMES, default="balanced",
                       help="per-model allocation scheme (without --plan)")
    fleet.add_argument("--plan", action="store_true",
                       help="co-schedule the mix through the design-space "
                            "search first and serve under its PE config")
    fleet.add_argument("--plan-evals", type=int, default=8,
                       help="search budget for --plan")
    fleet.add_argument("--image-size", type=int, default=64,
                       help="input H=W (224 = paper size)")
    fleet.add_argument("--requests", type=int, default=2,
                       help="number of requests to serve (>= 1)")
    fleet.add_argument("--batch", type=int, default=2)
    fleet.add_argument("--arrival-rate", type=float, default=float("inf"),
                       help="Poisson-ish arrivals per scheduler slot "
                            "(default inf: everything at slot 0)")
    fleet.add_argument("--max-queue", type=int, default=None,
                       help="bounded queue per member")
    fleet.add_argument("--co-dispatch", type=int, default=None,
                       help="max members co-dispatched per slot beyond "
                            "the primary (default: all with work)")
    fleet.add_argument("--burst", type=int, default=4,
                       help="consecutive slots each member advances per "
                            "fleet step (1: strict slot interleaving)")
    fleet.add_argument("--no-interleave", action="store_true",
                       help="one policy-picked member per slot (same as "
                            "--co-dispatch 0)")
    fleet.add_argument("--pools", type=int, default=1,
                       help="in-process pools; > 1 serves through a "
                            "MultiPoolRouter")
    fleet.add_argument("--transport", default="local",
                       choices=("local", "file", "socket"),
                       help="inter-pool mailbox: 'local' (in memory), "
                            "'file' (spool directory, see --spool) or "
                            "'socket' (framed envelopes to --workers "
                            "processes)")
    fleet.add_argument("--spool", default=None, metavar="DIR",
                       help="spool directory for --transport file "
                            "(default: a fresh temporary directory)")
    fleet.add_argument("--faults", default=None, metavar="PLAN.json",
                       help="arm a FaultPlan (v1) on the executors")
    fleet.add_argument("--slo-ms", type=float, default=None,
                       help="per-request wall-clock SLO: shed requests "
                            "past it and report goodput")
    fleet.add_argument("--trace", default=None, metavar="PATH",
                       help="write the executed streams as Chrome-tracing "
                            "JSON")
    fleet.add_argument("--metrics", default=None, metavar="PATH",
                       help="write the telemetry registry: '-' = "
                            "Prometheus text on stdout, *.json = JSON, "
                            "else Prometheus text")
    fleet.add_argument("--metrics-every", type=int, default=None,
                       metavar="K",
                       help="with --metrics: one JSON snapshot line every "
                            "K steps")
    fleet.add_argument("--workers", type=int, default=0, metavar="N",
                       help="serve over N worker processes (python -m "
                            "repro_torch.fleet.worker), one pool each, "
                            "behind --transport socket; exclusive with "
                            "--pools > 1")
    fleet.add_argument("--kill-worker", default=None, metavar="POOL@STEP",
                       help="SIGKILL the named worker process at the "
                            "given router step (needs --workers)")
    fleet.add_argument("--verify-replay", action="store_true",
                       help="after a --workers run, replay the collected "
                            "streams and placement log on fresh "
                            "in-process fleets and check them bitwise")
    fleet.add_argument("--adapt", action="store_true",
                       help="attach a closed-loop controller to each "
                            "pool: observe the completion window every "
                            "--control-interval slots and inject "
                            "SET_PARAM/REBALANCE: reweight members toward "
                            "the observed mix, retune fusion width on p95 "
                            "breaches (with --slo-ms), re-split the SMs "
                            "at a re-planned theta on sustained shedding")
    fleet.add_argument("--control-interval", type=int, default=8,
                       metavar="K",
                       help="fleet slots between controller observations "
                            "(with --adapt; default 8)")
    fleet.add_argument("--device", default="cuda",
                       help="'cuda' (default; raises without a card) or "
                            "'cpu' (the plain versions)")
    fleet.set_defaults(func=serve_fleet)
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
