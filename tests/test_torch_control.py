"""The port's closed-loop fleet controller against the reference's, on the
CPU.

Each case of the reference's ``tests/test_control.py`` runs here on the
port's fleet with stub members (one stub class per package, below):
SET_PARAM's schema and execution, ``MetricsWindow``, the mix-flip
reweight, the p95 retune and its recovery, the hysteresis of all three
actions with the cooldown and the recovery interlock, the decision log,
bitwise replay of a controlled run with no controller attached, and the
compiler's refusal.  Then across packages: the same observations give
the same ``(action, reason)`` lists in both ``ControlLoop``\\ s, the
flip trace's decision log is byte-identical as JSON, and a controlled
stream recorded by either package replays on the other's uncontrolled
fleet with an equal signature and outputs, its decision log verifying
there.  Last, ``serve fleet --adapt`` on ``--device cpu`` and its usage
errors.
"""
import dataclasses
import importlib
import json
import time
from types import SimpleNamespace

import pytest

import repro.fleet as ref_fleet
import repro.fleet.control as ref_control
import repro.fleet.planner as ref_planner
import repro.serving.api as ref_api
import repro_torch.fleet as port_fleet
import repro_torch.fleet.control as port_control
import repro_torch.fleet.planner as port_planner
import repro_torch.serving.api as port_api
from repro_torch.fleet import (ControlLoop, Decision, ExecRecord,
                               Rebalance, RebalanceTheta, Retune, Reweight,
                               SetParam, WeightedFair, compile_fleet,
                               decisions_from_json, decisions_to_json,
                               dump_decisions, load_decisions, lower_action,
                               stream_from_json, stream_signature,
                               stream_to_json, verify_decisions)
from repro_torch.fleet.compiler import CompileError
from repro_torch.fleet.instructions import Run
from repro_torch.serving.api import (Completion, MetricsWindow, Request,
                                     RequestMetrics, replay)

PKGS = {"port": (port_fleet, port_control, port_planner, port_api),
        "ref": (ref_fleet, ref_control, ref_planner, ref_api)}


# --------------------------------------------------------------------------
# stub members, one class per package
# --------------------------------------------------------------------------
def _stub_classes(api):
    class StubEngine(api.EngineBase):
        """Serves any payload in ``service_steps`` slots on a fixed
        dominant core, with the CNN engine's advance/retire split, and
        records its dispatch order into a shared ``trace`` list."""

        def __init__(self, *, capacity=2, service_steps=1, core="c",
                     max_queue=None, policy=None, name=None, trace=None):
            super().__init__(max_queue=max_queue)
            self.policy = policy or api.FixedRateAdmission(1)
            self.capacity = capacity
            self.service_steps = service_steps
            self._core = core
            self._name = name
            self._trace = trace
            self._flight = []               # [remaining, rid, payload]

        @property
        def in_flight(self):
            return len(self._flight)

        @property
        def has_work(self):
            return bool(self._pending or self._flight)

        @property
        def next_core(self):
            return self._core if self.has_work else None

        def advance(self):
            self._start_clock()
            if self._trace is not None:
                self._trace.append(self._name)
            for f in self._flight:
                f[0] -= 1
            finished = [f for f in self._flight if f[0] <= 0]
            self._flight = [f for f in self._flight if f[0] > 0]
            n = self.policy.admit(queued=len(self._pending),
                                  in_flight=len(self._flight),
                                  capacity=self.capacity)
            for _ in range(max(0, min(n, len(self._pending),
                                      self.capacity - len(self._flight)))):
                popped = self._pop_admission()
                if popped is None:
                    break
                req, _t = popped
                self._metrics[req.rid].started_at = time.perf_counter()
                self._flight.append([self.service_steps, req.rid,
                                     req.payload])
            return finished

        def retire(self, finished):
            out = self._take_shed()
            out.extend(self._finish(rid, payload)
                       for _, rid, payload in finished)
            return out

        def step(self):
            return self.retire(self.advance())

    class StubTunable(StubEngine):
        """A stub member exposing the LM engine's retune surface."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.group_size = 8
            self.retunes = []

        def retune(self, *, group_size=None):
            if group_size is not None:
                if group_size < 1:
                    raise ValueError(f"group_size must be >= 1 (got "
                                     f"{group_size})")
                self.group_size = int(group_size)
                self.retunes.append(int(group_size))
            return {"group_size": self.group_size}

    return StubEngine, StubTunable


STUBS = {pkg: _stub_classes(mods[3]) for pkg, mods in PKGS.items()}


def _stub_fleet(cores=("c", "p"), names=None, weights=None, policy=None,
                co_dispatch=None, trace=None, pkg="port", **stub_kw):
    fleet_mod = PKGS[pkg][0]
    stub = STUBS[pkg][0]
    names = names or [f"m{i}" for i in range(len(cores))]
    members = {n: stub(core=c, name=n, trace=trace, **stub_kw)
               for n, c in zip(names, cores)}
    return fleet_mod.FleetEngine(members, weights=weights, policy=policy,
                                 co_dispatch=co_dispatch)


def _obs(slot=0, arrivals=None, queued=None, window=None, shed_rate=0.0,
         weights=None, pkg="port"):
    return PKGS[pkg][1].Observation(
        slot=slot, arrivals=arrivals or {}, queued=queued or {},
        window=window or {}, shed_rate=shed_rate, weights=weights or {})


def _win(p95):
    return {"n": 8, "served": 8, "shed": 0, "shed_rate": 0.0, "p95_ms": p95}


# --------------------------------------------------------------------------
# the mix-flip trace shared by the convergence and replay tests
# --------------------------------------------------------------------------
_W0 = {"a": 0.75, "b": 0.25}


def _flip_fleet(trace=None, pkg="port"):
    policy = PKGS[pkg][0].WeightedFair()
    return _stub_fleet(cores=("c", "p"), names=list(_W0), weights=_W0,
                       policy=policy, co_dispatch=0, trace=trace, pkg=pkg)


def _flip_trace(pkg="port"):
    """48 one-per-slot arrivals whose mix flips 3:1 -> 1:3 at step 24."""
    tags = ["a", "a", "a", "b"] * 6 + ["b", "b", "b", "a"] * 6
    reqs = [PKGS[pkg][3].Request(i, model=t) for i, t in enumerate(tags)]
    return reqs, list(range(len(reqs)))


# --------------------------------------------------------------------------
# SET_PARAM schema + executor semantics
# --------------------------------------------------------------------------
def test_set_param_round_trip_and_v1_compat():
    rec = [ExecRecord(instr=SetParam(member="a", param="weight",
                                     value=0.6),
                      slot=1, seq=0, advances=0)]
    rt = stream_from_json(stream_to_json(rec))
    assert rt[0].instr == rec[0].instr
    # v1 streams (no SET_PARAM) still load...
    v1 = stream_to_json([ExecRecord(instr=Run(member="a"), slot=0, seq=0)])
    v1["version"] = 1
    assert stream_from_json(v1)[0].instr == Run(member="a")
    # ...but a v1 doc carrying a v2-only op is schema drift, not data
    drift = stream_to_json(rec)
    drift["version"] = 1
    with pytest.raises(ValueError, match="schema drift"):
        stream_from_json(drift)


def test_set_param_execution_paths():
    fleet = _flip_fleet()
    fleet.executor.inject(SetParam(member="b", param="weight", value=0.9))
    assert fleet._by_name["b"].weight == pytest.approx(0.9)
    with pytest.raises(KeyError, match="unknown member"):
        fleet.executor.inject(SetParam(member="zz", param="weight",
                                       value=0.5))
    with pytest.raises(RuntimeError, match="retune"):
        fleet.executor.inject(SetParam(member="a", param="group_size",
                                       value=4))   # StubEngine: no retune


def test_metrics_window_stats():
    win = MetricsWindow(4)

    def done(model, status, lat_s):
        m = RequestMetrics(rid=0, model=model, submitted_at=0.0,
                           status=status)
        if status in ("ok", "recovered"):
            m.finished_at = lat_s
        return Completion(ticket=SimpleNamespace(rid=0), output=None,
                          metrics=m)
    win.observe([done("a", "ok", 0.010), done("a", "shed", 0.0),
                 done("b", "ok", 0.020)])
    assert win.stats("a") == {"n": 2, "served": 1, "shed": 1,
                              "shed_rate": 0.5, "p95_ms": 10.0}
    assert win.stats()["n"] == 3
    assert set(win.by_model()) == {"a", "b"}
    # bounded: a 4th + 5th entry evict the oldest two
    win.observe([done("b", "ok", 0.030), done("b", "ok", 0.030)])
    assert len(win) == 4 and win.stats("a")["n"] == 1
    assert win.stats("zzz") == {"n": 0, "served": 0, "shed": 0,
                                "shed_rate": 0.0, "p95_ms": None}
    with pytest.raises(ValueError, match="window size"):
        MetricsWindow(0)


# --------------------------------------------------------------------------
# reweight: convergence on a seeded mix flip, deadband hysteresis
# --------------------------------------------------------------------------
def test_mix_flip_reweights_to_new_mix():
    fleet = _flip_fleet()
    ctl = ControlLoop(fleet, interval=8, reweight_deadband=0.15)
    reqs, arr = _flip_trace()
    res = replay(fleet, reqs, arr)
    assert res.metrics.completed == len(reqs)

    rw = [d for d in ctl.decisions if d.action.kind == "reweight"]
    # one clean flip: exactly one reweight per member, at the first
    # observation whose window saw the new mix, none before or after
    assert len(rw) == 2
    assert {m.name: m.weight for m in fleet.members} == \
        pytest.approx({"a": 0.25, "b": 0.75})
    for d in rw:
        assert d.observed["arrivals"] == {"a": 2, "b": 6}
    # post-decision dispatch share follows the new entitlement
    seq0 = max(d.seq for d in rw)
    picks = [r.instr.member for r in fleet.stream
             if r.seq > seq0 and isinstance(r.instr, Run) and r.instr.primary]
    assert picks.count("b") > picks.count("a")
    assert res.stats["control"]["by_kind"] == {"reweight": 2}
    assert res.stats["control"]["decisions"] == 2


def test_reweight_deadband_rides_out_wobble():
    """A mix oscillating inside the deadband must emit nothing."""
    fleet = _stub_fleet(cores=("c", "p"), names=["a", "b"],
                        weights={"a": 0.5, "b": 0.5},
                        policy=WeightedFair(), co_dispatch=0)
    ctl = ControlLoop(fleet, interval=5, reweight_deadband=0.2)
    tags = (["a", "a", "a", "b", "b"] + ["b", "b", "b", "a", "a"]) * 4
    reqs = [Request(i, model=t) for i, t in enumerate(tags)]
    replay(fleet, reqs, list(range(len(reqs))))
    assert ctl.decisions == []
    assert ctl.observations > 0
    assert {m.name: m.weight for m in fleet.members} == {"a": 0.5,
                                                         "b": 0.5}


# --------------------------------------------------------------------------
# retune: p95 breach narrows the fusion width, recovery widens it back
# --------------------------------------------------------------------------
def _tunable_fleet(pkg="port"):
    stub, tunable = STUBS[pkg]
    members = {"lm": tunable(core="c", name="lm"),
               "cnn": stub(core="p", name="cnn")}
    fleet_mod = PKGS[pkg][0]
    return fleet_mod.FleetEngine(members, policy=fleet_mod.WeightedFair(),
                                 co_dispatch=0)


def test_p95_breach_retunes_and_recovers():
    fleet = _tunable_fleet()
    ctl = ControlLoop(fleet, interval=4, slo_ms=100.0, band=(0.5, 1.0))
    lm = fleet._by_name["lm"].engine
    hot, cool = _obs(window={"lm": _win(150.0)}), \
        _obs(window={"lm": _win(40.0)})

    def run(obs):
        acts = ctl.decide(obs)
        for a, r in acts:
            ctl._apply(a, r, obs)
        return [a for a, _ in acts]

    assert run(hot) == [Retune(member="lm", param="group_size", value=4)]
    assert lm.group_size == 4
    assert run(hot) == [Retune(member="lm", param="group_size", value=2)]
    assert run(hot) == [Retune(member="lm", param="group_size", value=1)]
    assert run(hot) == [] and lm.group_size == 1       # min_group floor
    assert run(_obs(window={"lm": _win(70.0)})) == []  # the band gap
    assert run(cool) == [Retune(member="lm", param="group_size", value=2)]
    assert run(cool) == [Retune(member="lm", param="group_size", value=4)]
    assert run(cool) == [Retune(member="lm", param="group_size", value=8)]
    assert lm.group_size == 8 and lm.retunes == [4, 2, 1, 2, 4, 8]
    assert run(cool) == []
    assert [r.instr for r in fleet.executor.records] == \
        [SetParam(member="lm", param="group_size", value=v)
         for v in (4, 2, 1, 2, 4, 8)]
    verify_decisions(fleet.executor.records, ctl.decisions)


# --------------------------------------------------------------------------
# shed-rate rebalance: sustain, re-arm, cooldown, and the interlock
# --------------------------------------------------------------------------
def _stub_planner(monkeypatch, module, theta=0.625):
    monkeypatch.setattr(module, "plan_fleet",
                        lambda mix, max_evals=4:
                        SimpleNamespace(theta=theta))


def test_shed_rebalance_hysteresis_and_cooldown(monkeypatch):
    _stub_planner(monkeypatch, port_planner)
    fleet = _flip_fleet()
    fleet.pool = object()           # decide() only checks for a pool
    ctl = ControlLoop(fleet, interval=4, shed_high=0.25, shed_low=0.05,
                      sustain=2, cooldown=3)
    hot = _obs(shed_rate=0.4, weights={"a": 0.5, "b": 0.5})
    cool, mid = _obs(shed_rate=0.01), _obs(shed_rate=0.15)

    assert ctl.decide(hot) == []                     # streak 1 < sustain
    fired = ctl.decide(hot)                          # streak 2: fires
    assert fired == [(RebalanceTheta(theta=0.625), fired[0][1])]
    assert "shed rate 0.400" in fired[0][1]
    assert ctl.decide(hot) == [] and ctl.decide(hot) == []
    assert ctl.decide(mid) == []                     # between the bands
    ctl._cooldown_left = 0                           # cooldown elapsed
    assert ctl.decide(hot) == []                     # still disarmed
    assert ctl.decide(cool) == []                    # re-arm
    assert ctl.decide(hot) == []
    assert len(ctl.decide(hot)) == 1

    ctl._shed_armed, ctl._shed_streak = True, 5
    ctl._cooldown_left = 2
    assert ctl.decide(hot) == []                     # cooldown blocks


def test_foreign_rebalance_restarts_cooldown():
    """A recovery (or drift) REBALANCE in the stream must push the
    controller's own rebalance trigger into cooldown."""
    fleet = _flip_fleet()
    ctl = ControlLoop(fleet, interval=4, cooldown=3)
    ex = fleet.executor
    assert ctl._cooldown_left == 0
    ex.records.append(ExecRecord(instr=Rebalance(theta=0.5),
                                 slot=fleet._slot, seq=next(ex._seq),
                                 advances=0))
    ctl.observe()
    assert ctl._cooldown_left == 3


# --------------------------------------------------------------------------
# the decision log
# --------------------------------------------------------------------------
def test_decision_log_round_trip_and_errors(tmp_path):
    ds = [Decision(seq=3, slot=2,
                   action=Reweight(member="a", weight=0.25),
                   reason="drift", observed={"shed_rate": 0.0}),
          Decision(seq=9, slot=8, action=RebalanceTheta(theta=0.7),
                   reason="shed")]
    rt = decisions_from_json(decisions_to_json(ds))
    assert rt == ds
    dump_decisions(ds, tmp_path / "d.json")
    assert load_decisions(tmp_path / "d.json") == ds
    with pytest.raises(ValueError, match="decision log version"):
        decisions_from_json({"version": 99, "decisions": []})
    with pytest.raises(ValueError, match="unknown decision kind"):
        decisions_from_json({"version": 1, "decisions":
                             [{"seq": 0, "slot": 0, "kind": "overclock",
                               "action": {}}]})
    recs = [ExecRecord(instr=lower_action(ds[0].action), slot=2, seq=3)]
    verify_decisions(recs, ds[:1])
    with pytest.raises(ValueError, match="no matching stream record"):
        verify_decisions(recs, ds[1:])
    bad = [ExecRecord(instr=SetParam(member="a", param="weight",
                                     value=0.99), slot=2, seq=3)]
    with pytest.raises(ValueError, match="lowered to"):
        verify_decisions(bad, ds[:1])


# --------------------------------------------------------------------------
# replay: controlled runs replay bitwise with no controller attached
# --------------------------------------------------------------------------
def test_controlled_run_replays_bitwise():
    trace_live = []
    live = _flip_fleet(trace_live)
    ctl = ControlLoop(live, interval=8, reweight_deadband=0.15)
    reqs, arr = _flip_trace()
    res_live = replay(live, reqs, arr)
    assert any(isinstance(r.instr, SetParam) for r in live.stream)
    verify_decisions(live.stream, ctl.decisions)

    rt = stream_from_json(stream_to_json(live.stream, pool="pool0"))
    log = decisions_from_json(decisions_to_json(ctl.decisions))
    trace_rep = []
    fresh = _flip_fleet(trace_rep)
    assert fresh.controller is None
    res_rep = fresh.executor.replay(rt, _flip_trace()[0], arr)

    assert stream_signature(fresh.stream) == stream_signature(live.stream)
    assert trace_rep == trace_live
    assert res_rep.outputs == res_live.outputs
    assert [c.ticket.rid for c in res_rep.completions] == \
        [c.ticket.rid for c in res_live.completions]
    verify_decisions(fresh.stream, log)
    assert {m.name: m.weight for m in fresh.members} == \
        pytest.approx({"a": 0.25, "b": 0.75})


def test_v1_stream_replays_bitwise():
    """Streams of schema v1 (no SET_PARAM) stay loadable + replayable."""
    trace_live = []
    live = _flip_fleet(trace_live)          # no controller: v1-shaped run
    reqs, arr = _flip_trace()
    res_live = replay(live, reqs, arr)
    doc = stream_to_json(live.stream)
    doc["version"] = 1
    rt = stream_from_json(doc)
    trace_rep = []
    fresh = _flip_fleet(trace_rep)
    res_rep = fresh.executor.replay(rt, _flip_trace()[0], arr)
    assert stream_signature(fresh.stream) == stream_signature(live.stream)
    assert trace_rep == trace_live
    assert res_rep.outputs == res_live.outputs


def test_compile_refuses_controlled_fleet():
    fleet = _flip_fleet()
    ControlLoop(fleet, interval=8)
    with pytest.raises(CompileError, match="ControlLoop"):
        compile_fleet(fleet, _flip_trace()[0])


def test_control_loop_validates_args():
    with pytest.raises(ValueError, match="interval"):
        ControlLoop(_flip_fleet(), interval=0)
    with pytest.raises(ValueError, match="band"):
        ControlLoop(_flip_fleet(), band=(1.0, 0.5))
    with pytest.raises(ValueError, match="shed_low"):
        ControlLoop(_flip_fleet(), shed_high=0.1, shed_low=0.2)


# --------------------------------------------------------------------------
# across packages
# --------------------------------------------------------------------------
def _neutral(decided):
    """``(action, reason)`` pairs in package-neutral form."""
    return [(a.kind, dataclasses.asdict(a), r) for a, r in decided]


def test_same_observations_decide_as_the_reference(monkeypatch):
    """Reweight, retune (narrow, the band gap, widen) and rebalance
    (sustain, disarm, cooldown, re-arm) from one observation sequence:
    both packages' loops give the same actions with the same reasons."""
    seq = [dict(arrivals={"lm": 6, "cnn": 2}, window={"lm": _win(150.0)},
                weights={"lm": 0.5, "cnn": 0.5}),
           dict(shed_rate=0.4, window={"lm": _win(150.0)}),
           dict(shed_rate=0.4, arrivals={"lm": 1, "cnn": 3},
                weights={"lm": 0.75, "cnn": 0.25}),
           dict(shed_rate=0.3, window={"lm": _win(70.0)}),
           dict(shed_rate=0.01, window={"lm": _win(20.0)}),
           dict(shed_rate=0.5, arrivals={"lm": 4, "cnn": 4},
                weights={"lm": 0.5, "cnn": 0.5}),
           dict(shed_rate=0.5, window={"lm": _win(20.0),
                                       "cnn": _win(300.0)}),
           dict(shed_rate=0.5), dict(shed_rate=0.5),
           dict(shed_rate=0.02), dict(shed_rate=0.3), dict(shed_rate=0.3)]
    decided = {}
    for pkg, (_, _, planner, _) in PKGS.items():
        _stub_planner(monkeypatch, planner, theta=0.4375)
        fleet = _tunable_fleet(pkg)
        fleet.pool = object()
        ctl = PKGS[pkg][1].ControlLoop(fleet, interval=4, slo_ms=100.0,
                                       sustain=2, cooldown=2)
        out = []
        for i, kw in enumerate(seq):
            ctl._cooldown_left = max(0, ctl._cooldown_left - 1)
            obs = _obs(slot=4 * i, pkg=pkg, **kw)
            acts = ctl.decide(obs)
            for a, r in acts:
                if a.kind != "rebalance":       # the pool is a stand-in
                    ctl._apply(a, r, obs)
            out.append(_neutral(acts))
        decided[pkg] = out
    assert decided["port"] == decided["ref"]
    kinds = {k for step in decided["port"] for k, _, _ in step}
    assert kinds == {"reweight", "retune", "rebalance"}


def _controlled_flip_run(pkg):
    live = _flip_fleet(pkg=pkg)
    ctl = PKGS[pkg][1].ControlLoop(live, interval=8, reweight_deadband=0.15)
    reqs, arr = _flip_trace(pkg)
    res = PKGS[pkg][3].replay(live, reqs, arr)
    return live, ctl, res


def test_flip_trace_decision_log_is_byte_identical(tmp_path):
    runs = {pkg: _controlled_flip_run(pkg) for pkg in PKGS}
    docs = {pkg: json.dumps(PKGS[pkg][1].decisions_to_json(ctl.decisions))
            for pkg, (_, ctl, _) in runs.items()}
    assert docs["port"] == docs["ref"]
    assert len(runs["port"][1].decisions) == 2
    port_control.dump_decisions(runs["port"][1].decisions, tmp_path / "a")
    ref_control.dump_decisions(runs["ref"][1].decisions, tmp_path / "b")
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    assert ref_control.load_decisions(tmp_path / "a") == \
        runs["ref"][1].decisions


@pytest.mark.parametrize("src,dst", [("port", "ref"), ("ref", "port")])
def test_controlled_stream_replays_on_the_other_package(src, dst, tmp_path):
    """A controlled flip-trace stream recorded by ``src`` replays on a
    fresh, uncontrolled ``dst`` fleet: equal signature, outputs and rids,
    the reweight re-applied, and ``src``'s decision log verifying
    against the replayed stream."""
    live, ctl, res_live = _controlled_flip_run(src)
    fleet_src, control_src = PKGS[src][0], PKGS[src][1]
    fleet_dst, control_dst = PKGS[dst][0], PKGS[dst][1]
    fleet_src.dump_stream(live.stream, tmp_path / "s.json", pool="pool0")
    control_src.dump_decisions(ctl.decisions, tmp_path / "d.json")
    fresh = _flip_fleet(pkg=dst)
    assert fresh.controller is None
    res_rep = fresh.executor.replay(fleet_dst.load_stream(
        tmp_path / "s.json"), _flip_trace(dst)[0], _flip_trace(dst)[1])
    neutral = [(r.seq, r.slot, r.instr.op,
                dataclasses.asdict(r.instr), r.advances)
               for r in fresh.stream]
    assert neutral == [(r.seq, r.slot, r.instr.op,
                        dataclasses.asdict(r.instr), r.advances)
                       for r in live.stream]
    assert res_rep.outputs == res_live.outputs
    assert [c.ticket.rid for c in res_rep.completions] == \
        [c.ticket.rid for c in res_live.completions]
    control_dst.verify_decisions(
        fresh.stream, control_dst.load_decisions(tmp_path / "d.json"))
    assert {m.name: m.weight for m in fresh.members} == \
        pytest.approx({"a": 0.25, "b": 0.75})


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------
def test_serve_fleet_adapt_on_cpu(capsys):
    """``serve fleet --adapt`` on the CPU: a 3:1 mix against equal
    weights reweights at the first observation, and the summary's
    ``control:`` line reports it."""
    serve = importlib.import_module("repro_torch.launch.serve")
    assert serve.main(["fleet", "--device", "cpu", "--models", "mbv1,sqz",
                       "--mix", "3,1", "--image-size", "16", "--batch",
                       "1", "--requests", "8", "--arrival-rate", "1",
                       "--adapt", "--control-interval", "2"]) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("[serve] control:"))
    assert "observations" in line and "final weights" in line


@pytest.mark.parametrize("flags,what", [
    (["--adapt", "--workers", "2", "--transport", "socket"], "--workers"),
    (["--adapt", "--control-interval", "0"], "--control-interval"),
    (["--control-interval", "-1"], "--control-interval"),
])
def test_serve_fleet_adapt_usage_errors(flags, what, capsys):
    """Usage errors exit 2 with one line on stderr naming the flag;
    nothing is served."""
    serve = importlib.import_module("repro_torch.launch.serve")
    with pytest.raises(SystemExit) as e:
        serve.main(["fleet", "--device", "cpu", *flags])
    assert e.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and what in err[0]
