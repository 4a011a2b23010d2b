"""Worker process: one pool of a fleet served across processes.

Port of ``repro/fleet/net/worker.py``.

``python -m repro_torch.fleet.worker --pool p1 --listen tcp:127.0.0.1:0``
hosts one ``FleetEngine`` + ``PoolExecutor`` behind a framed-envelope
control channel and executes what the coordinator streams at it:
``submit`` enqueues a request, ``step`` runs one fleet slot, ``inject``
runs one out-of-band instruction (SEND/RECV migration, REBALANCE,
SET_PARAM).  Every ``step``/``inject`` carries the router-wide seq
watermark; the worker stamps its records from it and ships them back, so
the coordinator's collected streams replay bitwise in one process, on
either package.

SEND/RECV payloads never shortcut through worker memory: the executor's
transport is a :class:`~repro_torch.fleet.net.transport.SocketTransport`,
whose ``migrate_*`` upcalls ride the same channel back to the
coordinator's mailbox; a worker only ever sees its own pool.

Members are either real CNN fleets (``--models``, built as ``serve
fleet`` builds a pool: on the card by default, the pool's two cores two
green contexts on disjoint SMs of it, each member's exec groups CUDA
graphs; ``--device cpu`` runs the plain versions) or deterministic
simulation members (``--sim name:core:steps[:opaque]``) for transport
tests, member-for-member identical to the reference's, so that an
in-process replay fleet of either package can be built from the same
spec.  A CNN worker loads the kernel library, builds its members and
captures every member's lanes before its READY line, so no ``step`` RPC
waits for a build or a capture; it then counts its kernels' launches
from 0 and writes them as one ``REPRO_WORKER_LAUNCHES`` line on stderr
when it shuts down.  A worker that cannot reach its device, or make its
pool's split of the card, exits non-zero before its READY line.
"""
from __future__ import annotations

import argparse
import json
import socket
import sys
import time

from repro_torch.fleet.faults import PoolCrash
from repro_torch.fleet.instructions import (SCHEMA_VERSION, instr_from_dict,
                                            stream_to_json)
from repro_torch.fleet.net import wire
from repro_torch.fleet.net.transport import SocketTransport
from repro_torch.serving.api import (EngineBase, FixedRateAdmission,
                                     QueueFull, ShedPolicy)

READY_PREFIX = "REPRO_WORKER_READY "
#: stderr line a CNN worker writes at shutdown: its pool and its kernels'
#: launches since its warm-up, as JSON
LAUNCHES_PREFIX = "REPRO_WORKER_LAUNCHES "


# --------------------------------------------------------------------------
# deterministic simulation members
# --------------------------------------------------------------------------
class SimEngine(EngineBase):
    """Batched simulation member: serves any payload in ``service_steps``
    slots with the CNN engine's two-phase advance/retire split and a
    fixed dominant core.  Deterministic by construction: the unit the
    transport tests replay bitwise across processes."""

    def __init__(self, *, capacity: int = 2, service_steps: int = 1,
                 core: str = "c", max_queue: int | None = None,
                 service_cost_s: float = 0.0):
        super().__init__(max_queue=max_queue)
        self.policy = FixedRateAdmission(1)
        self.capacity = capacity
        self.service_steps = service_steps
        self.service_cost_s = service_cost_s
        self._core = core
        self._flight: list[list] = []       # [remaining, rid, payload]

    @property
    def in_flight(self) -> int:
        """Admitted, unfinished requests."""
        return len(self._flight)

    @property
    def has_work(self) -> bool:
        """Queued or in-flight work exists."""
        return bool(self._pending or self._flight)

    @property
    def next_core(self) -> str | None:
        """Dominant core of the next dispatch (None when idle)."""
        return self._core if self.has_work else None

    def advance(self) -> list:
        """Tick in-flight work one slot and admit into freed capacity."""
        self._start_clock()
        if self.service_cost_s and self._flight:
            time.sleep(self.service_cost_s)     # modeled compute per slot
        for f in self._flight:
            f[0] -= 1
        finished = [f for f in self._flight if f[0] <= 0]
        self._flight = [f for f in self._flight if f[0] > 0]
        n = self.policy.admit(queued=len(self._pending),
                              in_flight=len(self._flight),
                              capacity=self.capacity)
        for _ in range(max(0, min(n, len(self._pending),
                                  self.capacity - len(self._flight)))):
            popped = self._pop_admission()      # None: the rest was shed
            if popped is None:
                break
            req, _t = popped
            self._metrics[req.rid].started_at = time.perf_counter()
            self._flight.append([self.service_steps, req.rid,
                                 req.payload])
        return finished

    def retire(self, finished) -> list:
        """Materialize completions for finished flights (+ sheds)."""
        out = self._take_shed()
        out.extend(self._finish(rid, payload)
                   for _, rid, payload in finished)
        return out

    def step(self) -> list:
        """One fused slot (advance + retire)."""
        return self.retire(self.advance())


class OpaqueSimEngine(EngineBase):
    """Opaque simulation member: only ``step()`` exists (dispatch and
    block fused), the shape of the LM engine: the fleet compiles RUNs
    against it with ``fused=True`` and no deferred FREE."""

    def __init__(self, *, capacity: int = 2, service_steps: int = 1,
                 core: str = "p", max_queue: int | None = None,
                 service_cost_s: float = 0.0):
        super().__init__(max_queue=max_queue)
        self.policy = FixedRateAdmission(1)
        self._capacity = capacity
        self._steps = service_steps
        self.service_cost_s = service_cost_s
        self._core = core
        self._flight: list[list] = []

    @property
    def in_flight(self) -> int:
        """Admitted, unfinished requests."""
        return len(self._flight)

    @property
    def has_work(self) -> bool:
        """Queued or in-flight work exists."""
        return bool(self._pending or self._flight)

    @property
    def next_core(self) -> str | None:
        """Dominant core of the next dispatch (None when idle)."""
        return self._core if self.has_work else None

    def step(self) -> list:
        """One fused slot: tick, admit, retire."""
        self._start_clock()
        if self.service_cost_s and self._flight:
            time.sleep(self.service_cost_s)     # modeled compute per slot
        for f in self._flight:
            f[0] -= 1
        finished = [f for f in self._flight if f[0] <= 0]
        self._flight = [f for f in self._flight if f[0] > 0]
        n = self.policy.admit(queued=len(self._pending),
                              in_flight=len(self._flight),
                              capacity=self._capacity)
        for _ in range(max(0, min(n, len(self._pending),
                                  self._capacity - len(self._flight)))):
            popped = self._pop_admission()
            if popped is None:
                break
            req, _t = popped
            self._metrics[req.rid].started_at = time.perf_counter()
            self._flight.append([self._steps, req.rid, req.payload])
        out = self._take_shed()
        out.extend(self._finish(rid, payload)
                   for _, rid, payload in finished)
        return out


def parse_sim_spec(spec: str) -> list[tuple[str, str, int, bool]]:
    """Parse ``name:core:steps[:opaque]`` comma-list member specs."""
    out = []
    for tok in spec.split(","):
        parts = tok.strip().split(":")
        if len(parts) not in (3, 4) or (len(parts) == 4
                                        and parts[3] != "opaque"):
            raise ValueError(
                f"bad --sim member {tok!r}; want name:core:steps or "
                f"name:core:steps:opaque")
        name, core, steps = parts[0], parts[1], int(parts[2])
        if core not in ("c", "p"):
            raise ValueError(f"bad --sim core {core!r} in {tok!r}; "
                             f"'c' or 'p'")
        if steps < 1:
            raise ValueError(f"--sim steps must be >= 1 in {tok!r}")
        out.append((name, core, steps, len(parts) == 4))
    return out


def build_sim_fleet(spec: str, *, policy: str = "round_robin",
                    co_dispatch: int | None = None, burst: int = 1,
                    max_queue: int | None = None, shed: bool = False,
                    service_cost_s: float = 0.0):
    """Build a deterministic sim fleet from a ``--sim`` spec: the same
    function the in-process replay side calls, so worker and replay
    fleets are member-for-member identical.  ``service_cost_s`` adds a
    wall-clock sleep per occupied slot (modeled compute); it never changes
    scheduling decisions or records."""
    from repro_torch.fleet.engine import FleetEngine
    from repro_torch.fleet.router import make_policy

    members = {}
    for name, core, steps, opaque in parse_sim_spec(spec):
        cls = OpaqueSimEngine if opaque else SimEngine
        members[name] = cls(service_steps=steps, core=core,
                            max_queue=max_queue,
                            service_cost_s=service_cost_s)
    fleet = FleetEngine(members, policy=make_policy(policy),
                        co_dispatch=co_dispatch, burst=burst)
    if shed:
        for m in fleet.members:     # slot-clock SLO shedding at admission
            m.engine.policy = ShedPolicy(inner=m.engine.policy)
    return fleet


def build_cnn_worker_fleet(models: list[str], *, image_size: int,
                           batch: int, device: str, scheme: str,
                           policy: str, burst: int,
                           co_dispatch: int | None,
                           max_queue: int | None):
    """Build a real CNN fleet for this worker, as ``serve fleet`` builds
    each pool (``build_cnn_fleet``: compiled groups, the pool's split of
    the card), and warm it: load the kernel library (built by the parent
    from the same sources), then stream as many ``batch`` x
    ``image_size`` images through each member as it holds in flight at
    once, which runs each chain eagerly once and captures the member's
    lanes.  Then every launch count starts from 0."""
    import numpy as np
    import torch

    from repro_torch.fleet.engine import build_cnn_fleet
    from repro_torch.fleet.router import make_policy
    from repro_torch.kernels.util import COUNTED, resolve_device, timed_build

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # full f32
        timed_build()
    fleet, pool = build_cnn_fleet(
        models, device=dev, scheme=scheme, policy=make_policy(policy),
        burst=burst, co_dispatch=co_dispatch, max_queue=max_queue)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch, image_size, image_size, 3), dtype=np.float32))
    for m in fleet.members:
        m.engine.runner.run_pipelined([x] * m.engine.capacity)
    pool.cores.synchronize()
    for fn in COUNTED.values():
        fn.launches = 0
    return fleet


# --------------------------------------------------------------------------
# the serving loop
# --------------------------------------------------------------------------
class WorkerServer:
    """Serve one coordinator connection over one fleet."""

    def __init__(self, pool: str, fleet, chan: wire.Channel):
        self.pool = pool
        self.fleet = fleet
        self.chan = chan
        self.ex = fleet.executor
        self.ex.name = pool
        self.ex.transport = SocketTransport(chan)
        self.chan.obs = self.ex.obs      # worker-side net_* counters ship
        #                                  with the telemetry snapshot

    def _state(self) -> dict:
        f = self.fleet
        return {"queued": f.queued, "in_flight": f.in_flight,
                "has_work": f.has_work, "slot": f._slot,
                "dispatches": f._dispatches, "retries": self.ex.retries,
                "timeouts": self.ex.timeouts}

    def _error(self, etype: str, msg: str, **extra) -> None:
        self.chan.send({"kind": "error", "etype": etype, "msg": msg,
                        **extra})

    def serve(self) -> None:
        """Handshake, then answer RPCs until shutdown or disconnect."""
        env = self.chan.recv()
        if env["kind"] != "hello":
            self._error("WireError", f"expected hello, got "
                                     f"{env['kind']!r}")
            return
        if env["pool"] != self.pool:
            self._error("WireError", f"this worker is pool "
                                     f"{self.pool!r}, not "
                                     f"{env['pool']!r}")
            return
        self.chan.send({"kind": "hello_ack", "pool": self.pool,
                        "schema": SCHEMA_VERSION,
                        "members": [{"name": m.name, "weight": m.weight}
                                    for m in self.fleet.members],
                        "state": self._state()})
        while True:
            try:
                env = self.chan.recv()
            except wire.WireClosed:
                return              # coordinator went away: exit quietly
            kind = env["kind"]
            if kind == "shutdown":
                self.chan.send({"kind": "bye"})
                return
            if kind == "ping":
                self.chan.send({"kind": "pong", "state": self._state()})
            elif kind == "telemetry":
                # cumulative snapshot: the coordinator's absorb() replaces
                # the last one, so a kill loses at most this window
                self.chan.send({"kind": "telemetry_snap",
                                "snapshot": self.ex.obs.snapshot()})
            elif kind == "submit":
                self._submit(env)
            elif kind in ("step", "inject"):
                if not self._exec(env, step=(kind == "step")):
                    return          # the pool crashed: nothing to serve
            else:
                self._error("WireError",
                            f"unexpected envelope {kind!r}")

    def _submit(self, env: dict) -> None:
        try:
            ticket = self.fleet.submit(wire.decode_request(env["req"]))
        except QueueFull as e:
            self._error("QueueFull", str(e), state=self._state())
            return
        except KeyError as e:
            self._error("KeyError", str(e), state=self._state())
            return
        self.chan.send({"kind": "submit_ack", "rid": ticket.rid,
                        "records": [], "completions": [],
                        "state": self._state()})

    def _exec(self, env: dict, *, step: bool) -> bool:
        # the coordinator's seq watermark is the base every record this
        # RPC produces stamps from: the shared-counter contract that keeps
        # the collected streams replayable
        self.ex._seq.n = env["seq"]
        base = len(self.ex.records)
        seen = set(self.fleet._completions)
        try:
            if step:
                done = self.fleet.step()
            else:
                done = self.ex.inject(instr_from_dict(env["instr"]))
        except PoolCrash as e:
            # ship the fatal step's partial records and its unharvested
            # completions: the coordinator mirrors in-process crash
            # semantics (records stamped, completions harvestable)
            self._error(
                "PoolCrash", str(e),
                records=stream_to_json(self.ex.records[base:])["records"],
                completions=[wire.encode_completion(c)
                             for frid, c in self.fleet._completions.items()
                             if frid not in seen],
                state=self._state())
            return False
        except (KeyError, ValueError, TypeError, RuntimeError) as e:
            self._error(
                type(e).__name__, str(e),
                records=stream_to_json(self.ex.records[base:])["records"],
                state=self._state())
            return True
        # each completion's output was waited for on its core's ready
        # event when the engine filed it, so the copy to the host reads
        # finished bytes
        self.chan.send({
            "kind": "step_done" if step else "inject_done",
            "records": stream_to_json(self.ex.records[base:])["records"],
            "completions": [wire.encode_completion(c) for c in done],
            "state": self._state()})
        return True


# --------------------------------------------------------------------------
# entrypoint
# --------------------------------------------------------------------------
def _listen(address: str) -> tuple[socket.socket, str]:
    """Bind a listening socket for ``tcp:HOST:PORT`` (port 0 picks an
    ephemeral port) or ``unix:PATH``; returns (socket, actual address)."""
    kind, _, rest = address.partition(":")
    if kind == "tcp":
        host, _, port = rest.rpartition(":")
        srv = socket.create_server((host, int(port)))
        got = srv.getsockname()
        return srv, f"tcp:{got[0]}:{got[1]}"
    if kind == "unix":
        srv = socket.socket(socket.AF_UNIX)
        srv.bind(rest)
        srv.listen(1)
        return srv, address
    raise ValueError(f"unknown --listen scheme in {address!r}; "
                     f"use tcp:HOST:PORT or unix:PATH")


def main(argv=None) -> int:
    """CLI: host one fleet pool behind a wire-protocol control channel."""
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet.worker",
        description="Fleet worker process: hosts one pool and executes "
                    "the coordinator's instruction stream.")
    p.add_argument("--pool", required=True,
                   help="this pool's name in the fleet topology")
    p.add_argument("--listen", default="tcp:127.0.0.1:0",
                   help="tcp:HOST:PORT (port 0 = ephemeral) or unix:PATH")
    kind = p.add_mutually_exclusive_group(required=True)
    kind.add_argument("--sim", metavar="SPEC",
                      help="simulation members, name:core:steps[:opaque] "
                           "comma-list (deterministic; for tests)")
    kind.add_argument("--models", metavar="LIST",
                      help="comma-list of CNN members (mbv1,mbv2,sqz or "
                           "full names)")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--batch", type=int, default=2,
                   help="images a request: the shape the lanes are "
                        "captured for before READY")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; exits non-zero without a card) "
                        "or 'cpu' (the plain versions)")
    p.add_argument("--scheme", default="balanced")
    p.add_argument("--policy", default="round_robin")
    p.add_argument("--burst", type=int, default=1)
    p.add_argument("--co-dispatch", type=int, default=None)
    p.add_argument("--max-queue", type=int, default=None)
    p.add_argument("--shed", action="store_true",
                   help="wrap member admission in a slot-clock ShedPolicy "
                        "(sim fleets only)")
    p.add_argument("--sim-cost-us", type=int, default=0,
                   help="modeled compute: microseconds each sim member "
                        "sleeps per occupied slot (sim fleets only)")
    args = p.parse_args(argv)

    if args.sim:
        try:
            fleet = build_sim_fleet(args.sim, policy=args.policy,
                                    co_dispatch=args.co_dispatch,
                                    burst=args.burst,
                                    max_queue=args.max_queue,
                                    shed=args.shed,
                                    service_cost_s=args.sim_cost_us / 1e6)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
    else:
        if args.shed or args.sim_cost_us:
            print("--shed/--sim-cost-us apply to --sim fleets only",
                  file=sys.stderr)
            return 2
        from repro_torch.launch.serve import MODEL_ALIASES
        try:
            models = [MODEL_ALIASES[t.strip()]
                      for t in args.models.split(",")]
        except KeyError as e:
            print(f"unknown model {e.args[0]!r}; one of "
                  f"{sorted(MODEL_ALIASES)}", file=sys.stderr)
            return 2
        fleet = build_cnn_worker_fleet(
            models, image_size=args.image_size, batch=args.batch,
            device=args.device, scheme=args.scheme, policy=args.policy,
            burst=args.burst, co_dispatch=args.co_dispatch,
            max_queue=args.max_queue)

    srv, address = _listen(args.listen)
    print(READY_PREFIX + json.dumps({"pool": args.pool,
                                     "address": address}), flush=True)
    conn, _peer = srv.accept()
    srv.close()
    WorkerServer(args.pool, fleet, wire.Channel(conn)).serve()
    if args.models:
        from repro_torch.kernels.util import launch_counts
        print(LAUNCHES_PREFIX + json.dumps({"pool": args.pool,
                                            "launches": launch_counts()}),
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
