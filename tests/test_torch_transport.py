"""The port's fleet across processes against the reference's, on the CPU.

Mirrors ``tests/test_transport.py`` against the port: the sim members and
their spec parser equal the reference's; ``Channel`` frames envelopes over
a socket byte for byte as the reference's does; two port worker processes
(``python -m repro_torch.fleet.worker --sim``) serve a forced migration and
survive a real SIGKILL with every request retired exactly once, and the
collected streams replay bitwise on fresh in-process fleets of either
package, as the reference's socket-fleet streams replay on the port's;
the router's slot-domain telemetry after ``collect`` is dict-equal to the
reference's for the same run; ``Registry.absorb`` merges as the
reference's; a worker refuses a wrong pool at the handshake; the serve
CLI's bad flag combinations and the worker CLI's usage errors exit 2; two
CNN workers on ``--device cpu`` give an in-process fleet's outputs; and a
worker that cannot reach the card exits before its READY line.
"""
import dataclasses
import json
import os
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.fleet import MultiPoolRouter as RefRouter
from repro.fleet import instructions as ref_instr
from repro.fleet.net import wire as ref_wire
from repro.fleet.net.coordinator import connect as ref_connect
from repro.fleet.net.coordinator import start_workers as ref_start_workers
from repro.fleet.net.coordinator import stop_workers as ref_stop_workers
from repro.fleet.net.worker import build_sim_fleet as ref_build_sim_fleet
from repro.fleet.net.worker import parse_sim_spec as ref_parse_sim_spec
from repro.obs import Registry as RefRegistry
from repro.serving import Request as RefRequest
from repro_torch.fleet import (MultiPoolRouter, build_cnn_fleet, connect,
                               instructions, make_policy, mix_schedule,
                               start_workers, stop_workers)
from repro_torch.fleet.net import Channel, SocketTransport, wire
from repro_torch.fleet.net import coordinator
from repro_torch.fleet.net.worker import (LAUNCHES_PREFIX, READY_PREFIX,
                                          OpaqueSimEngine, SimEngine,
                                          build_sim_fleet, parse_sim_spec)
from repro_torch.fleet.net.worker import main as worker_main
from repro_torch.obs import Registry
from repro_torch.serving.api import Request, replay

SPEC = "cnn:c:2,lm:p:3:opaque"
ROOT = Path(__file__).resolve().parents[1]
_ENV = {**os.environ, "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": os.pathsep.join(
            [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}


def _requests(req_cls, n):
    return [req_cls(payload=i, model=("cnn" if i % 2 == 0 else "lm"))
            for i in range(n)]


def _sig(records):
    """A stream's signature in package-neutral form: (seq, slot, the
    instruction's JSON record, advances)."""
    return [(r.seq, r.slot, dict(op=r.instr.op, **dataclasses.asdict(
        r.instr)), r.advances) for r in records]


def _statuses(router, n):
    return {rid: router._metrics[rid].status for rid in range(n)}


# --------------------------------------------------------------------------
# sim members and their spec
# --------------------------------------------------------------------------
def test_parse_sim_spec_matches_reference():
    assert parse_sim_spec(SPEC) == ref_parse_sim_spec(SPEC) == [
        ("cnn", "c", 2, False), ("lm", "p", 3, True)]
    for bad in ("", "a:q:1", "a:c:0", "a:c:1:weird", "a:c"):
        with pytest.raises(ValueError):
            parse_sim_spec(bad)
        with pytest.raises(ValueError):
            ref_parse_sim_spec(bad)


@pytest.mark.parametrize("kw", [{}, dict(policy="weighted_fair", burst=3,
                                         co_dispatch=0, max_queue=4,
                                         shed=True)])
def test_build_sim_fleet_matches_reference(kw):
    """Member for member: names, kinds, cores, steps, capacity and the
    fleet's policy, burst and co-dispatch, and the same completions."""
    port, ref = build_sim_fleet(SPEC, **kw), ref_build_sim_fleet(SPEC, **kw)

    def shape(fleet):
        return (type(fleet.policy).__name__, fleet.burst, fleet.co_dispatch,
                [(m.name, type(m.engine).__name__, m.engine.next_core,
                  type(m.engine.policy).__name__,
                  vars(m.engine).get("capacity",
                                     vars(m.engine).get("_capacity")))
                 for m in fleet.members])

    assert shape(port) == shape(ref)
    assert [type(m.engine) for m in port.members] == [SimEngine,
                                                      OpaqueSimEngine]
    for fleet, req_cls in ((port, Request), (ref, RefRequest)):
        for r in _requests(req_cls, 6):
            fleet.submit(r)
    a, b = port.drain(), ref.drain()
    assert [(c.ticket.rid, c.output) for c in a.completions] == \
        [(c.ticket.rid, c.output) for c in b.completions]


# --------------------------------------------------------------------------
# Channel
# --------------------------------------------------------------------------
def test_channel_round_trip_and_counters():
    a, b = socket.socketpair()
    left, right = Channel(a, timeout_s=10.0), Channel(b, timeout_s=10.0)
    left.obs = Registry()
    try:
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        sent_env = {"kind": "submit", "seq": 3,
                    "req": wire.encode_request(Request(x, model="m"))}
        left.send(sent_env)
        env = right.recv()
        assert env["kind"] == "submit" and env["seq"] == 3
        got = wire.decode_request(env["req"])
        assert torch.equal(got.payload, x) and got.model == "m"
        right.send({"kind": "migrate_ack", "n": 2})
        assert left.recv() == {"v": wire.WIRE_VERSION,
                               "kind": "migrate_ack", "n": 2}
        snap = left.obs.snapshot(domain="wall")["counters"]
        assert snap["net_envelopes_total"]["series"] == {
            "dir=in,kind=migrate_ack": 1, "dir=out,kind=submit": 1}
        sent = snap["net_bytes_total"]["series"]["dir=out"]
        assert sent == len(wire.pack_env(sent_env))
        right.close()
        with pytest.raises(wire.WireClosed):
            left.recv()
    finally:
        left.close()
        right.close()


def test_channel_bytes_equal_the_reference():
    """The port's frames are the reference's: each side reads the other's
    envelope, and a tensor payload frames to the same bytes as the numpy
    array does on the reference."""
    a, b = socket.socketpair()
    port, ref = Channel(a, timeout_s=10.0), ref_wire.Channel(b,
                                                             timeout_s=10.0)
    try:
        arr = np.random.default_rng(0).standard_normal((2, 4, 4, 3),
                                                       dtype=np.float32)
        env = {"kind": "submit", "seq": 7,
               "req": wire.encode_request(Request(torch.from_numpy(arr),
                                                  model="m"))}
        ref_env = {"kind": "submit", "seq": 7,
                   "req": ref_wire.encode_request(RefRequest(arr,
                                                             model="m"))}
        assert wire.pack_env(env) == ref_wire.pack_env(ref_env)
        port.send(env)
        got = ref.recv()
        np.testing.assert_array_equal(
            ref_wire.decode_request(got["req"]).payload, arr)
        ref.send({"kind": "pong", "state": {"queued": 1}})
        assert port.recv()["state"] == {"queued": 1}
    finally:
        port.close()
        ref.close()


def test_channel_read_deadline_is_the_heartbeat():
    a, b = socket.socketpair()
    chan = Channel(a, timeout_s=0.05)
    try:
        with pytest.raises(TimeoutError):
            chan.recv()
    finally:
        chan.close()
        b.close()


def test_socket_transport_upcalls_on_the_channel():
    """SEND/RECV from a worker's executor become ``migrate_*`` upcalls,
    answered inline by the other end."""
    a, b = socket.socketpair()
    worker, coord = Channel(a, timeout_s=10.0), Channel(b, timeout_s=10.0)
    t = SocketTransport(worker)
    try:
        coord_replies = [{"kind": "migrate_ack", "n": 2},
                         {"kind": "migrate_deliver",
                          "items": [[9, wire.encode_request(Request(5))]]},
                         {"kind": "migrate_map_ack", "n": 1}]
        for r in coord_replies:
            coord.send(r)
        assert t.send("p0", "p1", [(0, Request(1)), (1, Request(2))]) == 2
        up = coord.recv()
        assert up["kind"] == "migrate_out" and len(up["pairs"]) == 2
        submitted = []

        def submit(req):
            submitted.append(req.payload)
            return type("T", (), {"rid": 4})()

        assert t.recv("p1", "p0", None, submit) == 1
        assert submitted == [5]
        assert coord.recv()["kind"] == "migrate_req"
        assert coord.recv()["mapped"] == [[9, 4]]
        coord.send({"kind": "error", "etype": "KeyError", "msg": "nope"})
        with pytest.raises(KeyError):
            t.send("p0", "px", [(0, Request(1))])
    finally:
        worker.close()
        coord.close()


# --------------------------------------------------------------------------
# Registry.absorb (tests/test_obs.py's case, on both packages)
# --------------------------------------------------------------------------
def test_absorb_replaces_per_source_and_merges():
    snaps = {}
    for name, reg_cls in (("port", Registry), ("ref", RefRegistry)):
        worker = reg_cls()
        worker.counter("n_total", "n", "slot").inc(3, labels={"pool": "w0"})
        worker.histogram("h", "h", bounds=(1.0,)).observe(0.5)
        coord = reg_cls()
        coord.counter("n_total", "n", "slot").inc(labels={"pool": "co"})
        coord.absorb(worker.snapshot(), source="w0")
        merged = coord.snapshot()
        assert merged["counters"]["n_total"]["series"] == {
            "pool=co": 1, "pool=w0": 3}
        assert merged["histograms"]["h"]["series"][""]["n"] == 1
        # a later cumulative snapshot replaces the source's contribution
        worker.counter("n_total").inc(2, labels={"pool": "w0"})
        coord.absorb(worker.snapshot(), source="w0")
        assert coord.snapshot()["counters"]["n_total"]["series"] == {
            "pool=co": 1, "pool=w0": 5}
        assert coord.sources == ["w0"]
        assert coord.snapshot(sources=False)["counters"]["n_total"][
            "series"] == {"pool=co": 1}
        snaps[name] = (coord.snapshot(), coord.snapshot(domain="slot"),
                       coord.snapshot(domain="wall"))
    assert snaps["port"] == snaps["ref"]


# --------------------------------------------------------------------------
# sim workers over SocketTransport, port and reference
# --------------------------------------------------------------------------
def _socket_run(pkg: str, *, kill: bool):
    """Two sim workers of ``pkg`` behind its router: 10 requests and a
    forced migration after 2 steps, or 12 requests and a SIGKILL of pool1
    after 2 steps; telemetry collected every step."""
    start, conn, stop, router_cls, req_cls = (
        (start_workers, connect, stop_workers, MultiPoolRouter, Request)
        if pkg == "port" else
        (ref_start_workers, ref_connect, ref_stop_workers, RefRouter,
         RefRequest))
    procs = start({f"pool{i}": ["--sim", SPEC] for i in range(2)},
                  env=_ENV, ready_timeout_s=300.0)
    fleets = {}
    try:
        fleets = conn(procs, heartbeat_s=60.0)
        router = router_cls(fleets)
        n = 12 if kill else 10
        for r in _requests(req_cls, n):
            router.submit(r)
        for _ in range(2):
            router.step()
        moved = 0
        if kill:
            procs["pool1"].kill()                       # real SIGKILL
        else:
            moved = router.migrate("pool0", "pool1")    # forced migration
        while router.has_work:
            router.step()
            for ex in router.executors.values():
                if ex._handle.lost is None:
                    ex._handle.collect(ex)
        res = router.result()
    finally:
        stop(fleets, procs)
    return dict(router=router, res=res, n=n, moved=moved,
                statuses=_statuses(router, n),
                streams=router.streams(), placements=list(router.placements),
                events=list(router.events))


@pytest.fixture(scope="module")
def port_migration():
    return _socket_run("port", kill=False)


@pytest.fixture(scope="module")
def port_sigkill():
    return _socket_run("port", kill=True)


@pytest.fixture(scope="module")
def ref_migration():
    return _socket_run("ref", kill=False)


def _exactly_once(run):
    res, router, n = run["res"], run["router"], run["n"]
    assert len(res.completions) == n
    assert len({c.ticket.rid for c in res.completions}) == n
    assert router.duplicates_dropped == 0
    assert res.metrics.count("failed") == 0


def _replay_on(pkg: str, run):
    """Replay ``run``'s streams, placements and recovery events on fresh
    in-process sim fleets of ``pkg``: the same records and statuses."""
    instr, router_cls, build, req_cls = (
        (instructions, MultiPoolRouter, build_sim_fleet, Request)
        if pkg == "port" else
        (ref_instr, RefRouter, ref_build_sim_fleet, RefRequest))
    src = ref_instr if isinstance(run["router"], RefRouter) else instructions
    streams = {p: instr.stream_from_json(json.loads(json.dumps(
        src.stream_to_json(recs, pool=p))))
        for p, recs in run["streams"].items()}
    fresh = router_cls({p: build(SPEC) for p in streams})
    fresh.replay(streams, run["placements"], _requests(req_cls, run["n"]),
                 run["events"])
    for p, recs in run["streams"].items():
        assert _sig(recs) == _sig(fresh.executors[p].records), p
    assert _statuses(fresh, run["n"]) == run["statuses"]


def test_socket_fleet_migration_exactly_once_and_replays(port_migration):
    assert port_migration["moved"] > 0
    _exactly_once(port_migration)
    _replay_on("port", port_migration)


def test_socket_fleet_sigkill_recovers_and_replays(port_sigkill):
    router, res = port_sigkill["router"], port_sigkill["res"]
    assert list(router.dead) == ["pool1"]
    assert [e[0] for e in router.events].count("fail") == 1
    assert res.metrics.count("recovered") > 0
    _exactly_once(port_sigkill)
    _replay_on("port", port_sigkill)


@pytest.mark.parametrize("which", ["migration", "sigkill"])
def test_port_socket_streams_replay_on_the_reference(which, port_migration,
                                                     port_sigkill):
    _replay_on("ref", port_migration if which == "migration"
               else port_sigkill)


def test_reference_socket_streams_replay_on_the_port(ref_migration):
    _exactly_once(ref_migration)
    _replay_on("port", ref_migration)


def test_socket_fleet_matches_the_reference_run(port_migration,
                                                ref_migration):
    """The same run on either package's workers: the same decisions,
    streams and outputs, and after ``collect`` the same slot-domain
    telemetry, the workers' absorbed snapshots included."""
    port, ref = port_migration["router"], ref_migration["router"]
    assert port_migration["moved"] == ref_migration["moved"]
    assert port.placements == ref.placements
    for p in ("pool0", "pool1"):
        assert _sig(port.streams()[p]) == _sig(ref.streams()[p])
    assert port_migration["statuses"] == ref_migration["statuses"]
    assert [(c.ticket.rid, c.output)
            for c in port_migration["res"].completions] == \
        [(c.ticket.rid, c.output) for c in ref_migration["res"].completions]
    assert port.obs.sources == ref.obs.sources == ["pool0", "pool1"]
    snap = port.obs.snapshot(domain="slot")
    assert snap == ref.obs.snapshot(domain="slot")
    assert snap["counters"]["fleet_sent_total"]["series"]
    assert port.obs.snapshot(domain="wall")["counters"]["net_bytes_total"]


def test_worker_rejects_wrong_pool_handshake():
    procs = start_workers({"pool0": ["--sim", SPEC]}, env=_ENV,
                          ready_timeout_s=300.0)
    try:
        chan = Channel(coordinator.dial(procs["pool0"].address,
                                        timeout_s=30.0), timeout_s=30.0)
        chan.send({"kind": "hello", "pool": "poolX"})
        reply = chan.recv()
        assert reply["kind"] == "error"
        assert "poolX" in reply["msg"]
        chan.close()
    finally:
        for wp in procs.values():
            wp.kill()
            wp.proc.wait()
            wp.proc.stdout.close()


# --------------------------------------------------------------------------
# CLI usage errors (exit 2) and the worker entry point's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("flags", [
    ("--workers", "2", "--transport", "local"),
    ("--workers", "2", "--transport", "file"),
    ("--transport", "socket"),
    ("--transport", "file"),                # needs --pools >= 2
    ("--workers", "2", "--transport", "socket", "--pools", "2"),
    ("--workers", "2", "--transport", "socket", "--adapt"),
    ("--workers", "2", "--transport", "socket", "--slo-ms", "5"),
    ("--spool", "/tmp/x"),                  # only with --transport file
    ("--kill-worker", "pool0@1"),           # needs --workers
    ("--verify-replay",),                   # needs --workers
    ("--workers", "2", "--transport", "socket",
     "--kill-worker", "nope"),              # wants POOL@STEP
])
def test_serve_fleet_bad_combos_exit_2(flags, capsys):
    """The reference's bad flag combinations: each an error on stderr and
    exit 2, before any worker is spawned or any device is touched."""
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit) as e:
        main(["fleet", "--models", "mbv1", "--requests", "1", *flags])
    assert e.value.code == 2
    assert "error:" in capsys.readouterr().err


def test_serve_fleet_kill_worker_names_a_worker(capsys):
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit) as e:
        main(["fleet", "--models", "mbv1", "--workers", "2", "--transport",
              "socket", "--kill-worker", "pool2@1"])
    assert e.value.code == 2
    assert "pool2" in capsys.readouterr().err


def test_worker_cli_usage_errors_exit_2(capsys):
    assert worker_main(["--pool", "p0", "--sim", "a:q:1"]) == 2
    assert worker_main(["--pool", "p0", "--models", "mbv1",
                        "--shed"]) == 2      # --shed is sim-only
    assert worker_main(["--pool", "p0", "--models", "warpnet9"]) == 2
    with pytest.raises(SystemExit) as e:     # --sim or --models, not both
        worker_main(["--pool", "p0", "--sim", SPEC, "--models", "mbv1"])
    assert e.value.code == 2


# --------------------------------------------------------------------------
# CNN workers on the CPU, and a worker without its card
# --------------------------------------------------------------------------
CNN_MODELS = ["mobilenet_v1", "squeezenet"]


def test_cnn_workers_on_the_cpu_match_an_in_process_fleet(tmp_path):
    """Two CNN workers on ``--device cpu`` at 32 px serve 6 requests with
    a forced migration: every request retires once, each output equal to
    an in-process fleet's, and each worker reports its launch counts (0
    on the CPU) at shutdown."""
    n = 6
    mix = {m: 0.5 for m in CNN_MODELS}
    rng = np.random.default_rng(0)
    requests = [Request(torch.from_numpy(rng.standard_normal(
        (1, 32, 32, 3), dtype=np.float32)), model=t)
        for t in mix_schedule(mix, n)]
    fleet, _ = build_cnn_fleet(CNN_MODELS, device="cpu",
                               policy=make_policy("weighted_fair"), burst=4)
    want = replay(fleet, requests).outputs
    wargs = ["--models", "mbv1,sqz", "--image-size", "32", "--batch", "1",
             "--device", "cpu", "--policy", "weighted_fair", "--burst", "4"]
    log = tmp_path / "workers.err"
    with open(log, "w") as err:
        procs = start_workers({p: wargs for p in ("pool0", "pool1")},
                              env=_ENV, stderr=err, ready_timeout_s=300.0)
        fleets = {}
        try:
            assert all(wp.ready_s > 0 for wp in procs.values())
            fleets = connect(procs, heartbeat_s=120.0)
            router = MultiPoolRouter(fleets)
            for r in requests:
                router.submit(r)
            router.step()
            router.migrate("pool1", "pool0", count=1)
            res = router.drain()
        finally:
            stop_workers(fleets, procs)
    assert [c.status for c in res.completions] == ["ok"] * n
    assert len({c.ticket.rid for c in res.completions}) == n
    assert router.duplicates_dropped == 0
    for got, exp in zip(res.outputs, want):
        assert got.device.type == "cpu" and torch.equal(got, exp)
    lines = [ln for ln in log.read_text().splitlines()
             if ln.startswith(LAUNCHES_PREFIX)]
    docs = [json.loads(ln[len(LAUNCHES_PREFIX):]) for ln in lines]
    assert sorted(d["pool"] for d in docs) == ["pool0", "pool1"]
    assert all(set(d["launches"].values()) == {0} for d in docs)


def test_worker_without_its_card_fails_its_start(tmp_path):
    """A CNN worker on the default device with no visible card exits
    non-zero before its READY line, and ``start_workers`` raises:
    nothing falls back to the CPU."""
    log = tmp_path / "worker.err"
    with open(log, "w") as err:
        with pytest.raises(RuntimeError, match="exited before its READY"):
            start_workers({"pool0": ["--models", "sqz", "--image-size",
                                     "32"]},
                          env={**_ENV, "CUDA_VISIBLE_DEVICES": ""},
                          stderr=err, ready_timeout_s=300.0)
    text = log.read_text()
    assert "no CUDA device" in text and READY_PREFIX not in text


def test_serve_fleet_workers_need_the_card(monkeypatch):
    """``serve fleet --workers`` on the default device raises without a
    card before it spawns a worker."""
    from repro_torch.launch import serve
    from repro_torch.launch.serve import main

    def spawn(*args, **kwargs):
        raise AssertionError("a worker was spawned")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(serve, "start_workers", spawn)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["fleet", "--models", "sqz", "--image-size", "32",
              "--workers", "2", "--transport", "socket"])


def test_serve_fleet_workers_on_the_cpu(capsys):
    """The acceptance run: 8 requests over two CPU workers, pool1
    SIGKILLed at router step 2, every request retired exactly once and the
    streams replayed bitwise."""
    from repro_torch.launch.serve import main

    rc = main(["fleet", "--models", "mbv1,sqz", "--requests", "8",
               "--image-size", "32", "--workers", "2", "--transport",
               "socket", "--kill-worker", "pool1@2", "--verify-replay",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "exactly-once: 8/8 retired" in out
    assert "dead workers ['pool1']" in out
    assert "replay verified" in out
