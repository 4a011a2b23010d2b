"""Coordinator side of a fleet served across processes.

Port of ``repro/fleet/net/coordinator.py``.

The :class:`~repro_torch.fleet.executor.MultiPoolRouter` drives pools
through two duck-typed surfaces (``fleet.submit/step`` and
``executor.inject`` plus recorded ``executor.records``), so distribution
needs no router changes: :class:`RemoteFleet`/:class:`RemoteExecutor`
implement those surfaces over a :class:`WorkerHandle` RPC channel to one
worker process, and the router's placement, least-outstanding, migration,
REBALANCE and crash-recovery logic runs unchanged against them.

Sequencing is what keeps replay bitwise: every ``step``/``inject`` RPC
carries the router-wide seq watermark as its base; the worker stamps its
records from it and the reply's records advance the shared counter, so
the collected per-worker streams, the placement log and the recovery
events are exactly what a process-local run would have recorded, and
``MultiPoolRouter.replay`` re-executes them on a fresh single-process
fleet of either package.

Crash detection is connection loss or heartbeat (read) timeout on any
RPC: the handle raises :class:`~repro_torch.fleet.faults.PoolCrash`, which
the router's ``_fail_pool`` path turns into journal-driven re-routes onto
survivors with at-most-once retirement.  A worker that crashes
*gracefully* (an injected fault escalating in-process) replies with its
partial records and unharvested completions first, so the coordinator's
recorded view matches in-process crash semantics record for record.

Each worker is a fresh interpreter (``python -m repro_torch.fleet.worker``
started by :func:`start_workers`), never a fork of this process: on the
card each one makes its own CUDA context and its own split of the card's
SMs.
"""
from __future__ import annotations

import dataclasses
import json
import os
import selectors
import socket
import subprocess
import sys
import time
import types

from repro_torch.fleet.executor import SeqCounter
from repro_torch.fleet.faults import PoolCrash
from repro_torch.fleet.instructions import (SCHEMA_VERSION, instr_to_dict,
                                            stream_from_json)
from repro_torch.fleet.net import wire
from repro_torch.serving.api import QueueFull, Request, Ticket

#: stdout line a worker prints once it is listening and warmed
READY_PREFIX = "REPRO_WORKER_READY "

_UPCALLS = frozenset({"migrate_out", "migrate_drop", "migrate_req",
                      "migrate_map"})


def dial(address: str, *, timeout_s: float | None = None) -> socket.socket:
    """Connect to a worker address (``tcp:HOST:PORT`` | ``unix:PATH``)."""
    kind, _, rest = address.partition(":")
    if kind == "tcp":
        host, _, port = rest.rpartition(":")
        return socket.create_connection((host, int(port)),
                                        timeout=timeout_s)
    if kind == "unix":
        sock = socket.socket(socket.AF_UNIX)
        sock.settimeout(timeout_s)
        sock.connect(rest)
        return sock
    raise ValueError(f"unknown address scheme in {address!r}; "
                     f"use tcp:HOST:PORT or unix:PATH")


class WorkerHandle:
    """RPC client for one worker process: framed request-reply with the
    worker's ``migrate_*`` upcalls answered inline, and any transport
    failure escalated to :class:`PoolCrash` (the recovery entry point)."""

    def __init__(self, pool: str, channel: wire.Channel):
        self.pool = pool
        self.chan = channel
        self.ex = None          # RemoteExecutor back-ref (set on build)
        self.lost: str | None = None
        self.state: dict = {}
        self.members: list[dict] = []
        self._hello()

    def _hello(self) -> None:
        self.chan.send({"kind": "hello", "pool": self.pool})
        ack = self.chan.recv()
        if ack["kind"] == "error":
            raise RuntimeError(f"worker {self.pool!r} refused hello: "
                               f"{ack.get('msg')}")
        if ack["kind"] != "hello_ack" or ack["pool"] != self.pool:
            raise wire.WireError(f"bad hello_ack from {self.pool!r}: "
                                 f"{ack}")
        if ack["schema"] != SCHEMA_VERSION:
            raise wire.WireError(
                f"worker {self.pool!r} speaks stream schema "
                f"{ack['schema']}, coordinator speaks {SCHEMA_VERSION}")
        self.members = ack["members"]
        self.state = ack["state"]

    # ------------------------------------------------------------------
    @property
    def _router(self):
        # the router reaches us through ex.fleet; we reach it back
        # through the transport it bound (LocalTransport.bind)
        router = getattr(self.ex.transport, "router", None)
        if router is None:
            raise RuntimeError(f"worker {self.pool!r} issued a migrate "
                               f"upcall before a MultiPoolRouter adopted "
                               f"its RemoteFleet")
        return router

    def _upcall(self, env: dict) -> None:
        """Answer one worker upcall against the coordinator's mailbox and
        the router's accounting hooks, as LocalTransport does in one
        process."""
        router = self._router
        transport = router.transport
        kind = env["kind"]
        if kind == "migrate_out":
            pairs = [(frid, wire.decode_request(doc))
                     for frid, doc in env["pairs"]]
            try:
                n = transport.send(env["src"], env["dst"], pairs)
            except KeyError as e:
                self.chan.send({"kind": "error", "etype": "KeyError",
                                "msg": str(e)})
                return
            self.chan.send({"kind": "migrate_ack", "n": n})
        elif kind == "migrate_drop":
            pairs = [(frid, wire.decode_request(doc))
                     for frid, doc in env["pairs"]]
            n = transport.drop_send(env["src"], env["dst"], pairs,
                                    seq=env["seq"], live=env["live"])
            self.chan.send({"kind": "migrate_ack", "n": n})
        elif kind == "migrate_req":
            items = transport.take(env["src"], env["dst"], env["count"])
            self.chan.send({"kind": "migrate_deliver",
                            "items": [[rid, wire.encode_request(req)]
                                      for rid, req in items]})
        elif kind == "migrate_map":
            for rid, frid in env["mapped"]:
                router.on_recv(env["dst"], rid, frid)
            self.chan.send({"kind": "migrate_map_ack",
                            "n": len(env["mapped"])})

    def rpc(self, env: dict) -> dict:
        """One request-reply exchange; upcalls are served in between.
        Raises :class:`PoolCrash` on connection loss or heartbeat
        timeout (and on every call after one)."""
        if self.lost is not None:
            raise PoolCrash(f"worker {self.pool!r} is gone: {self.lost}")
        obs = self._obs
        if self.chan.obs is None and obs is not None:
            self.chan.obs = obs      # coordinator-side net_* counters
        try:
            self.chan.send(env)
            while True:
                reply = self.chan.recv()
                if reply["kind"] in _UPCALLS:
                    self._upcall(reply)
                    continue
                return reply
        except (wire.WireError, OSError) as e:
            self.lost = str(e) or type(e).__name__
            self.chan.close()
            if obs is not None:
                # wall domain: a silent or vanished worker is a fact
                # about the transport, never the stream
                obs.counter("net_heartbeat_misses_total",
                            "RPCs lost to worker silence/disconnect",
                            "wall").inc(labels={"pool": self.pool})
            raise PoolCrash(f"worker {self.pool!r} connection lost "
                            f"({self.lost})") from e

    def call(self, ex, kind: str, **fields) -> dict:
        """One executor-sequenced RPC: ship the shared seq watermark,
        absorb the reply's records/completions/state, advance the
        counter, and map error envelopes back to their exceptions."""
        base = ex._seq.n
        reply = self.rpc({"kind": kind, "seq": base, **fields})
        self._absorb(ex, reply, base)
        if reply["kind"] == "error":
            raise _map_error(reply)
        return reply

    def _absorb(self, ex, reply: dict, base: int) -> None:
        recs = reply.get("records")
        if recs:
            ex.records.extend(stream_from_json(
                {"version": SCHEMA_VERSION, "pool": self.pool,
                 "records": recs}))
            ex._seq.n = base + len(recs)
        state = reply.get("state")
        if state is not None:
            self.state = state
            ex.retries = state["retries"]
            ex.timeouts = state["timeouts"]
        if reply["kind"] == "error":
            # a graceful crash ships the fatal step's unharvested
            # completions; mirror them so _fail_pool's harvest works
            for doc in reply.get("completions") or ():
                c = wire.decode_completion(doc)
                ex.fleet._completions[c.ticket.rid] = c

    @property
    def _obs(self):
        """The adopting router's registry (None before adoption)."""
        return getattr(self.ex, "obs", None)

    def ping(self) -> dict:
        """Heartbeat probe; returns the worker's state snapshot."""
        t0 = time.perf_counter()
        reply = self.rpc({"kind": "ping"})
        if reply["kind"] != "pong":
            raise wire.WireError(f"expected pong, got {reply['kind']!r}")
        obs = self._obs
        if obs is not None:
            obs.histogram("net_rtt_seconds",
                          "ping round-trip time, per worker").observe(
                time.perf_counter() - t0, labels={"pool": self.pool})
        self.state = reply["state"]
        return reply["state"]

    def collect(self, ex) -> dict | None:
        """Pull the worker's cumulative telemetry snapshot and absorb it
        into ``ex.obs`` under this pool's name.  Best-effort: a worker
        that died since the last collect just keeps its previous
        snapshot (at most one unshipped window is lost)."""
        obs = self._obs
        if obs is None or not obs.enabled:
            return None
        try:
            reply = self.rpc({"kind": "telemetry"})
        except PoolCrash:
            return None
        if reply["kind"] != "telemetry_snap":
            raise wire.WireError(f"expected telemetry_snap, got "
                                 f"{reply['kind']!r}")
        snap = reply["snapshot"]
        obs.absorb(snap, source=self.pool)
        return snap

    def shutdown(self) -> None:
        """Ask the worker to exit cleanly; best-effort."""
        if self.lost is not None:
            return
        try:
            self.chan.send({"kind": "shutdown"})
            while self.chan.recv()["kind"] != "bye":
                pass
        except (wire.WireError, OSError):
            pass
        finally:
            self.lost = "shut down"
            self.chan.close()


def _map_error(env: dict) -> Exception:
    etype, msg = env.get("etype"), env.get("msg", "")
    if etype == "PoolCrash":
        return PoolCrash(msg)
    if etype == "QueueFull":
        return QueueFull(msg)
    if etype == "KeyError":
        return KeyError(msg)
    if etype in ("ValueError", "TypeError"):
        return {"ValueError": ValueError, "TypeError": TypeError}[etype](msg)
    return RuntimeError(f"{etype}: {msg}")


# --------------------------------------------------------------------------
# router-facing proxies
# --------------------------------------------------------------------------
@dataclasses.dataclass
class RemoteMember:
    """Coordinator mirror of one worker fleet member (name and weight are
    what placement and REBALANCE accounting read)."""

    name: str
    weight: float


class RemoteExecutor:
    """``PoolExecutor`` stand-in: records mirror the worker's executed
    stream; ``inject`` runs one out-of-band instruction remotely."""

    remote = True   # the router pushes weight resets as SET_PARAM

    def __init__(self, handle: WorkerHandle):
        self._handle = handle
        handle.ex = self
        self.name = handle.pool
        self.fleet = None           # RemoteFleet back-ref
        self.transport = None       # router installs its mailbox binding
        self.records = []
        self.retries = handle.state.get("retries", 0)
        self.timeouts = handle.state.get("timeouts", 0)
        self.injector = None
        self.recovery = None
        self._seq = SeqCounter()    # router replaces with the shared one

    def inject(self, instr):
        """Execute one out-of-band instruction on the worker."""
        reply = self._handle.call(self, "inject",
                                  instr=instr_to_dict(instr))
        return [wire.decode_completion(c) for c in reply["completions"]]


class RemoteFleet:
    """``FleetEngine`` stand-in over one worker process.  State reads
    (queued / in_flight / has_work / slot / dispatches) come from the
    snapshot every RPC reply carries: exact, because a worker's state
    only moves inside an RPC."""

    def __init__(self, handle: WorkerHandle):
        self._handle = handle
        self.executor = RemoteExecutor(handle)
        self.executor.fleet = self
        self.pool = None            # no local DevicePool: the worker owns
        #                             its device; drift checks skip
        self.controller = None
        self._completions: dict = {}    # filled from graceful-crash
        #                                 replies for _fail_pool's harvest
        self.members = [RemoteMember(m["name"], m["weight"])
                        for m in handle.members]
        self.router = types.SimpleNamespace(
            names=[m.name for m in self.members])

    # state mirror ------------------------------------------------------
    @property
    def queued(self) -> int:
        """Queued requests on the worker (last snapshot)."""
        return self._handle.state["queued"]

    @property
    def in_flight(self) -> int:
        """Admitted requests on the worker (last snapshot)."""
        return self._handle.state["in_flight"]

    @property
    def has_work(self) -> bool:
        """Whether the worker holds work (last snapshot)."""
        return self._handle.state["has_work"]

    @property
    def _slot(self) -> int:
        return self._handle.state["slot"]

    @property
    def _dispatches(self) -> int:
        return self._handle.state["dispatches"]

    # engine surface ----------------------------------------------------
    def submit(self, request) -> Ticket:
        """Submit one request to the worker; its fleet-rid comes back."""
        req = (request if isinstance(request, Request)
               else Request(request))
        reply = self._handle.call(self.executor, "submit",
                                  req=wire.encode_request(req))
        return Ticket(rid=reply["rid"],
                      submitted_at=time.perf_counter())

    def step(self):
        """One fleet slot on the worker; completions come back decoded
        (outputs as CPU tensors)."""
        reply = self._handle.call(self.executor, "step")
        return [wire.decode_completion(c) for c in reply["completions"]]


# --------------------------------------------------------------------------
# worker process lifecycle
# --------------------------------------------------------------------------
@dataclasses.dataclass
class WorkerProc:
    """One spawned worker process, the address it listens on, and the
    seconds from its spawn to its READY line."""

    pool: str
    address: str
    proc: subprocess.Popen
    ready_s: float = 0.0

    def kill(self) -> None:
        """SIGKILL the worker (the crash lever of fault tests)."""
        self.proc.kill()


def start_workers(specs: dict, *, python: str = sys.executable,
                  ready_timeout_s: float = 180.0,
                  env: dict | None = None,
                  stderr=None) -> dict[str, WorkerProc]:
    """Spawn one worker process per pool.  ``specs`` maps pool name ->
    extra ``repro_torch.fleet.worker`` CLI args (e.g. ``["--sim",
    "cnn:c:2"]``); each worker is a fresh interpreter with an ephemeral
    localhost port, awaited until it prints its READY line (listening,
    members built, kernels loaded and lanes captured).  ``stderr`` goes
    to every worker (default: this process's).  A worker that exits
    before its READY line, or misses the deadline, raises, and every
    worker is killed."""
    run_env = dict(os.environ if env is None else env)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))))
    run_env["PYTHONPATH"] = (src + os.pathsep + run_env["PYTHONPATH"]
                             if run_env.get("PYTHONPATH") else src)
    procs: dict[str, WorkerProc] = {}
    spawned: dict[str, float] = {}
    try:
        for pool, extra in specs.items():
            cmd = [python, "-m", "repro_torch.fleet.worker", "--pool",
                   pool, "--listen", "tcp:127.0.0.1:0", *extra]
            spawned[pool] = time.perf_counter()
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=stderr, env=run_env)
            procs[pool] = WorkerProc(pool=pool, address="", proc=proc)
        _await_ready(procs, spawned, time.monotonic() + ready_timeout_s)
    except BaseException:
        for wp in procs.values():
            wp.proc.kill()
            wp.proc.wait()
            wp.proc.stdout.close()
        raise
    return procs


def _await_ready(procs: dict[str, WorkerProc], spawned: dict[str, float],
                 deadline: float) -> None:
    """Read every worker's stdout at once until each has printed its
    READY line; set each one's address and its time from ``spawned``."""
    bufs = {pool: b"" for pool in procs}
    with selectors.DefaultSelector() as sel:
        for pool, wp in procs.items():
            sel.register(wp.proc.stdout, selectors.EVENT_READ, pool)
        while bufs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"workers {sorted(bufs)} not ready in "
                                   f"time")
            for key, _ in sel.select(left):
                pool, wp = key.data, procs[key.data]
                chunk = os.read(wp.proc.stdout.fileno(), 65536)
                if not chunk:
                    raise RuntimeError(
                        f"worker {pool!r} exited before its READY line "
                        f"(rc={wp.proc.wait()})")
                bufs[pool] += chunk
                for raw in bufs[pool].split(b"\n")[:-1]:   # whole lines
                    line = raw.decode(errors="replace")
                    if not line.startswith(READY_PREFIX):
                        continue
                    doc = json.loads(line[len(READY_PREFIX):])
                    if doc["pool"] != pool:
                        raise RuntimeError(f"worker announced pool "
                                           f"{doc['pool']!r}, expected "
                                           f"{pool!r}")
                    wp.address = doc["address"]
                    wp.ready_s = time.perf_counter() - spawned[pool]
                    sel.unregister(wp.proc.stdout)
                    del bufs[pool]
                    break


def connect(procs: dict[str, WorkerProc], *,
            heartbeat_s: float | None = 30.0,
            dial_timeout_s: float = 30.0) -> dict[str, RemoteFleet]:
    """Dial every worker and return ``{pool: RemoteFleet}``, the mapping
    ``MultiPoolRouter(fleets)`` takes.  ``heartbeat_s`` is the read
    deadline on every RPC: a worker silent past it is declared crashed."""
    fleets: dict[str, RemoteFleet] = {}
    for pool, wp in procs.items():
        sock = dial(wp.address, timeout_s=dial_timeout_s)
        chan = wire.Channel(sock, timeout_s=heartbeat_s)
        fleets[pool] = RemoteFleet(WorkerHandle(pool, chan))
    return fleets


def stop_workers(fleets: dict[str, RemoteFleet],
                 procs: dict[str, WorkerProc] | None = None,
                 *, timeout_s: float = 10.0) -> None:
    """Shut every worker down (best-effort) and reap the processes."""
    for fleet in fleets.values():
        fleet._handle.shutdown()
    for wp in (procs or {}).values():
        try:
            wp.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            wp.proc.kill()
            wp.proc.wait()
        wp.proc.stdout.close()
