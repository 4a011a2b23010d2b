"""The port's fleet against the reference's, on the CPU.

The port runs with ``device="cpu"`` (every kernel wrapper takes its plain
version); the reference runs as its own fleet tests run it:
``build_cnn_fleet(..., use_pallas=False, fuse=False)`` at 32 px, batch 1,
MobileNet v1 + SqueezeNet.  Both fleets get the same seeded numpy weights
(the port's ``init_params``, handed to the reference as ``jnp`` arrays)
and the same numpy images.

Held here: the design-space search, the area model and the Table VII
planner to 1e-12; the scheduling policies pick for pick; instruction
streams (schema v2), fault plans (v1) and wire envelopes (v2) dump to the
same JSON and load across packages; a stream recorded by either fleet
replays on the other with an equal signature, outputs within 1e-3 of the
reference's (each layer agrees to 1e-4, compounding through up to 30
layers, as in ``test_torch_model.py``) and bit-equal to the port's own
live run, for one pool and with a REBALANCE mid-run; a 2-pool
``MultiPoolRouter`` run with a forced migration, over the in-memory and
the spool-file mailbox, completes every request with a slot-domain
telemetry snapshot dict-equal to the reference's.  Members that are not
networks are the stub engines below, one class per package.
"""
import dataclasses
import importlib
import inspect
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.cnn as ref_cnn
from repro.core import area as ref_area
from repro.core.arch import (DUAL_BASELINE as REF_DUAL,
                             DUAL_MULTI as REF_MULTI, DUAL_SQZ as REF_SQZ,
                             BoardModel as RefBoard)
from repro.fleet import (FaultInjector as RefInjector,
                         FaultPlan as RefFaultPlan, FleetEngine as RefFleet,
                         MultiPoolRouter as RefRouter,
                         Rebalance as RefRebalance,
                         build_cnn_fleet as ref_build_cnn_fleet,
                         compile_fleet as ref_compile_fleet,
                         make_policy as ref_make_policy,
                         mix_schedule as ref_mix_schedule,
                         normalize_mix as ref_normalize_mix,
                         plan_fleet as ref_plan_fleet,
                         plan_rows as ref_plan_rows)
from repro.fleet import instructions as ref_instr
from repro.fleet.net import wire as ref_wire
from repro.fleet.router import MemberView as RefView
from repro.dualmesh import DualMeshRunner as RefLMRunner
from repro.dualmesh import split_mesh
from repro.fleet import ControlLoop as RefControlLoop
from repro.fleet.trace import chrome_trace as ref_chrome_trace
from repro.lm import model as ref_lm_model
from repro.models.zoo import get_graph as ref_get_graph
from repro.obs import to_prometheus as ref_to_prometheus
from repro.serving import DualMeshEngine as RefLMEngine
from repro.serving import EngineBase as RefEngineBase
from repro.serving import FixedRateAdmission as RefFixedRate
from repro.serving import QueueFull as RefQueueFull
from repro.serving import Request as RefRequest
from repro.serving import poisson_arrivals as ref_poisson_arrivals
from repro.serving import replay as ref_replay
from repro_torch.configs.registry import get_smoke
from repro_torch.core import area, search
from repro_torch.core.arch import (DUAL_BASELINE, DUAL_MULTI, DUAL_SQZ,
                                   BoardModel)
from repro_torch.dualmesh.partition import split_streams
from repro_torch.dualmesh.runtime import DualMeshRunner
from repro_torch.fleet import (POLICY_NAMES, ControlLoop, DevicePool,
                               FaultInjector, FaultPlan, FileTransport,
                               FleetEngine, MultiPoolRouter, Rebalance,
                               SetParam, build_cnn_fleet, compile_fleet,
                               make_policy, mix_schedule, normalize_mix,
                               plan_fleet, plan_rows, stream_signature,
                               validate_stream, verify_decisions)
from repro_torch.fleet import instructions
from repro_torch.fleet.net import wire
from repro_torch.fleet.router import MemberView
from repro_torch.fleet.trace import chrome_trace
from repro_torch.lm import model as lm_model
from repro_torch.models.cnn import init_params
from repro_torch.models.zoo import get_graph
from repro_torch.obs import to_prometheus
from repro_torch.serving import api as serving_api
from repro_torch.serving.api import (EngineBase, FixedRateAdmission,
                                     QueueFull, Request, poisson_arrivals,
                                     replay)
from repro_torch.serving.lm import DualMeshEngine

ref_search = importlib.import_module("repro.core.search")
ref_serving_api = importlib.import_module("repro.serving.api")

MODELS = ["mobilenet_v1", "squeezenet"]
SIZE = 32
TOL = dict(rtol=1e-3, atol=1e-3)
EXACT = dict(rel=1e-12, abs=1e-12)


# --------------------------------------------------------------------------
# fleets and requests for both packages
# --------------------------------------------------------------------------
def _jnp(params):
    return {n: {k: jnp.asarray(v) for k, v in p.items()}
            for n, p in params.items()}


def _ref_build_model(name, key=None, dtype=None):
    """The reference's ``build_model`` with the port's seeded weights."""
    return (_jnp(init_params(get_graph(name), seed=0)),
            ref_cnn.FORWARDS[name], ref_get_graph(name))


def ref_fleet(models=MODELS, **kw):
    """The reference CNN fleet, as its tests build it, on our weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_cnn, "build_model", _ref_build_model)
        return ref_build_cnn_fleet(models, use_pallas=False, fuse=False,
                                   **kw)


def port_fleet(models=MODELS, **kw):
    """The port's CNN fleet on the CPU (weights from seed 0)."""
    return build_cnn_fleet(models, device="cpu", **kw)


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
            for _ in range(n)]


def _tags(n):
    return mix_schedule({m: 0.5 for m in MODELS}, n)


def ref_requests(n=4, seed=0):
    """Model-tagged reference requests over numpy-seeded images."""
    return [RefRequest(jnp.asarray(x), model=t)
            for x, t in zip(_images(n, seed), _tags(n))]


def port_requests(n=4, seed=0):
    """The same requests for the port (CPU tensors)."""
    return [Request(torch.from_numpy(x), model=t)
            for x, t in zip(_images(n, seed), _tags(n))]


def _sig(records):
    """A stream's signature in package-neutral form: (seq, slot, the
    instruction's JSON record, advances)."""
    return [(r.seq, r.slot, dict(op=r.instr.op, **dataclasses.asdict(
        r.instr)), r.advances) for r in records]


def _close(port_outs, ref_outs):
    assert len(port_outs) == len(ref_outs)
    for a, b in zip(port_outs, ref_outs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _equal(outs_a, outs_b):
    assert len(outs_a) == len(outs_b)
    for a, b in zip(outs_a, outs_b):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# stub members, one per package
# --------------------------------------------------------------------------
def _stub_class(base, fixed_rate):
    class StubEngine(base):
        """Serves any payload in ``service_steps`` slots on a fixed
        dominant core, with the CNN engine's advance/retire split."""

        def __init__(self, *, capacity=2, service_steps=1, core="c",
                     max_queue=None, policy=None):
            super().__init__(max_queue=max_queue)
            self.policy = policy or fixed_rate(1)
            self.capacity = capacity
            self.service_steps = service_steps
            self._core = core
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

    return StubEngine


PortStub = _stub_class(EngineBase, FixedRateAdmission)
RefStub = _stub_class(RefEngineBase, RefFixedRate)


def _stub_router(pkg, injector=None, policy=None):
    """Two pools of two stub members each (``a`` on the c-core, ``b`` on
    the p-core), weighted-fair; ``policy()`` makes each member's
    admission policy."""
    stub, fleet, router, make = (
        (PortStub, FleetEngine, MultiPoolRouter, make_policy)
        if pkg == "port" else (RefStub, RefFleet, RefRouter, ref_make_policy))

    def pool():
        members = {n: stub(core=c, service_steps=2, max_queue=16,
                           policy=policy() if policy else None)
                   for n, c in (("a", "c"), ("b", "p"))}
        return fleet(members, policy=make("weighted_fair"))

    return router({"p0": pool(), "p1": pool()}, injector=injector)


def _drive(router, reqs, arrivals, qf, migrate_at=3):
    """The reference telemetry test's loop: arrivals, one migration of
    pool p1's queue onto p0 at ``migrate_at``, steps until idle."""
    order = sorted(range(len(reqs)), key=lambda i: arrivals[i])
    nxt, step, refused = 0, 0, []
    while nxt < len(order) or refused or router.has_work:
        due, refused = refused, []
        while nxt < len(order) and arrivals[order[nxt]] <= step:
            due.append(order[nxt])
            nxt += 1
        for i in due:
            try:
                router.submit(reqs[i])
            except qf:
                refused.append(i)
        if (step == migrate_at and not router.dead
                and router.executors["p1"].fleet.queued):
            router.migrate("p1", "p0")
        if router.has_work:
            router.step()
        step += 1


def _groups(sched):
    return [(g.core, [l.name for l in g.layers]) for g in sched.groups]


# --------------------------------------------------------------------------
# core: area, search
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["baseline", "sqz", "multi"])
def test_dual_core_area_matches_reference(name):
    port_cfg = {"baseline": DUAL_BASELINE, "sqz": DUAL_SQZ,
                "multi": DUAL_MULTI}[name]
    ref_cfg = {"baseline": REF_DUAL, "sqz": REF_SQZ, "multi": REF_MULTI}[name]
    a, r = area.dual_core_area(port_cfg), ref_area.dual_core_area(ref_cfg)
    assert (a.dsp, a.bram18k, a.lut, a.ff) == (r.dsp, r.bram18k, r.lut,
                                                r.ff)
    assert a.lut_equiv == pytest.approx(r.lut_equiv, **EXACT)
    assert area.pe_structure_lut_equiv(port_cfg.p) == pytest.approx(
        ref_area.pe_structure_lut_equiv(ref_cfg.p), **EXACT)


def test_evaluate_config_and_search_match_reference():
    """Without Alg.1's load balancing, which costs seconds a schedule
    (``test_torch_core.py`` holds ``best_schedule`` with it)."""
    board, ref_board = BoardModel(), RefBoard()
    graphs = [get_graph(m) for m in MODELS]
    ref_graphs = [ref_get_graph(m) for m in MODELS]
    obj, fps, scheds = search.evaluate_config(
        DUAL_MULTI, graphs, board, False, [0.7, 0.3])
    ref_obj, ref_fps, ref_scheds = ref_search.evaluate_config(
        REF_MULTI, ref_graphs, ref_board, False, [0.7, 0.3])
    assert obj == pytest.approx(ref_obj, **EXACT)
    assert fps == pytest.approx(ref_fps, **EXACT)
    for m in MODELS:
        assert _groups(scheds[m]) == _groups(ref_scheds[m])
    assert search.harmonic_mean([3.0, 5.0], [1.0, 2.0]) == pytest.approx(
        ref_search.harmonic_mean([3.0, 5.0], [1.0, 2.0]), **EXACT)
    kw = dict(max_evals=1, with_load_balance=False, weights=[0.7, 0.3])
    res = search.search(graphs, board, **kw)
    ref = ref_search.search(ref_graphs, ref_board, **kw)
    assert str(res.config) == str(ref.config)
    assert res.theta == pytest.approx(ref.theta, **EXACT)
    assert res.objective == pytest.approx(ref.objective, **EXACT)
    assert res.fps == pytest.approx(ref.fps, **EXACT)
    assert res.visited_thetas == pytest.approx(ref.visited_thetas, **EXACT)
    assert search.t_b2_lower_bound(graphs[0], 0.4, 1000, board) == \
        pytest.approx(ref_search.t_b2_lower_bound(ref_graphs[0], 0.4, 1000,
                                                  ref_board), **EXACT)


# --------------------------------------------------------------------------
# planner
# --------------------------------------------------------------------------
def test_plan_fleet_matches_reference():
    mix = {"mobilenet_v1": 2.0, "squeezenet": 1.0}
    plan = plan_fleet(mix, config=DUAL_MULTI, with_load_balance=False)
    ref = ref_plan_fleet(mix, config=REF_MULTI, with_load_balance=False)
    assert str(plan.config) == str(ref.config)
    assert plan.theta == pytest.approx(ref.theta, **EXACT)
    assert plan.mix == pytest.approx(ref.mix, **EXACT)
    assert plan.fps == pytest.approx(ref.fps, **EXACT)
    assert plan.predicted == pytest.approx(ref.predicted, **EXACT)
    assert plan.aggregate_fps == pytest.approx(ref.aggregate_fps, **EXACT)
    for m in MODELS:
        assert _groups(plan.schedules[m]) == _groups(ref.schedules[m])
    assert plan.summary() == ref.summary()
    rows = plan_rows(plan, {"squeezenet": 1.5}, 2.5)
    ref_rows = ref_plan_rows(ref, {"squeezenet": 1.5}, 2.5)
    assert [r[0] for r in rows] == [r[0] for r in ref_rows]
    for row, ref_row in zip(rows, ref_rows):
        assert row[1:4] == pytest.approx(ref_row[1:4], **EXACT)
        assert row[4] == ref_row[4]


def test_mix_helpers_match_reference():
    mix = {"mobilenet_v1": 3, "mobilenet_v2": 1, "squeezenet": 2}
    assert mix_schedule(mix, 17) == ref_mix_schedule(mix, 17)
    assert normalize_mix(mix) == pytest.approx(ref_normalize_mix(mix),
                                               **EXACT)
    with pytest.raises(ValueError, match="must be > 0"):
        normalize_mix({"a": 0})


# --------------------------------------------------------------------------
# router
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", POLICY_NAMES)
def test_policies_pick_as_the_reference(name):
    rng = np.random.default_rng(7)
    pol, ref_pol = make_policy(name), ref_make_policy(name)
    picks, ref_picks = [], []
    for step in range(40):
        rows = []
        for i in range(4):
            if rng.random() < 0.25:
                continue                    # no work this step
            rows.append(dict(
                index=i, name=f"m{i}", queued=int(rng.integers(0, 5)),
                in_flight=int(rng.integers(0, 3)),
                weight=float(rng.choice([0.1, 0.2, 0.3, 0.4])),
                dispatches=int(rng.integers(0, 10)),
                head_deadline=(None if rng.random() < 0.3
                               else float(rng.integers(0, 20))),
                next_core=str(rng.choice(["c", "p"])), has_work=True))
        if not rows:
            continue
        picks.append(pol.pick([MemberView(**r) for r in rows], step))
        ref_picks.append(ref_pol.pick([RefView(**r) for r in rows], step))
    assert len(picks) > 20
    assert picks == ref_picks
    with pytest.raises(ValueError, match="unknown scheduling policy"):
        make_policy("fifo")


# --------------------------------------------------------------------------
# serialized formats, both directions
# --------------------------------------------------------------------------
def _records(mod):
    instrs = [mod.Run(member="a", slots=3, core="c", primary=True),
              mod.Run(member="lm", fused=True), mod.Free(member="a"),
              mod.Send(peer="pool1", member="a", count=2),
              mod.Send(peer="pool1"), mod.Recv(peer="pool0", count=3),
              mod.Rebalance(theta=0.25),
              mod.SetParam(member="a", param="weight", value=0.5)]
    return [mod.ExecRecord(instr=x, slot=i // 3, seq=i, advances=i % 4,
                           t0=None if i % 2 else 1.5 + i, t1=None
                           if i % 2 else 2.0 + i, retries=i % 2)
            for i, x in enumerate(instrs)]


def test_instruction_stream_v2_dumps_and_loads_across_packages(tmp_path):
    doc = instructions.stream_to_json(_records(instructions), pool="p0")
    ref_doc = ref_instr.stream_to_json(_records(ref_instr), pool="p0")
    assert json.dumps(doc) == json.dumps(ref_doc)
    instructions.dump_stream(_records(instructions), tmp_path / "a.json",
                             pool="p0")
    ref_instr.dump_stream(_records(ref_instr), tmp_path / "b.json",
                          pool="p0")
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    port_of_ref = instructions.load_stream(tmp_path / "b.json")
    ref_of_port = ref_instr.load_stream(tmp_path / "a.json")
    assert _sig(port_of_ref) == _sig(ref_of_port) == _sig(
        _records(instructions))
    assert [(r.t0, r.t1, r.retries) for r in port_of_ref] == \
        [(r.t0, r.t1, r.retries) for r in _records(ref_instr)]
    # a v1 stream loads in both; a v1 stream carrying SET_PARAM is drift
    v1 = {"version": 1, "records": ref_doc["records"][:7]}
    assert _sig(instructions.stream_from_json(v1)) == _sig(
        ref_instr.stream_from_json(v1))
    drift = {"version": 1, "records": ref_doc["records"]}
    for load in (instructions.stream_from_json, ref_instr.stream_from_json):
        with pytest.raises(ValueError, match="schema drift"):
            load(drift)
        with pytest.raises(ValueError, match="unknown fleet instruction"):
            load({"version": 2, "records": [{"instr": {"op": "HALT"},
                                             "slot": 0}]})


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_plan_v1_dumps_and_loads_across_packages(seed, tmp_path):
    kw = dict(pools=["p0", "p1"], members=["a", "b"], n=4, max_slot=8)
    plan = FaultPlan.generate(seed, **kw)
    ref = RefFaultPlan.generate(seed, **kw)
    assert json.dumps(plan.to_json()) == json.dumps(ref.to_json())
    plan.dump(tmp_path / "a.json")
    ref.dump(tmp_path / "b.json")
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    assert FaultPlan.load(tmp_path / "b.json").to_json() == \
        RefFaultPlan.load(tmp_path / "a.json").to_json() == ref.to_json()
    for cls in (FaultPlan, RefFaultPlan):
        with pytest.raises(ValueError, match="unknown fields"):
            cls.from_json({"version": 1, "faults": [{"kind": "latency",
                                                     "skew": 1}]})


def test_wire_v2_envelopes_and_codec_match_reference(tmp_path):
    x = np.random.default_rng(0).standard_normal((1, 4, 4, 3)).astype(
        np.float32)
    payload = {"img": x, "tag": b"\x00\x01", "meta": [1, 2.5, None, "s"]}
    port_req = Request(payload={**payload, "img": torch.from_numpy(x)},
                       gen_steps=3, model="squeezenet", deadline=7.0,
                       priority=2)
    ref_req = RefRequest(payload=payload, gen_steps=3, model="squeezenet",
                         deadline=7.0, priority=2)
    env = {"kind": "frame", "src": "p0", "dst": "p1",
           "items": [[5, wire.encode_request(port_req)]]}
    ref_env = {"kind": "frame", "src": "p0", "dst": "p1",
               "items": [[5, ref_wire.encode_request(ref_req)]]}
    buf = wire.pack_env(env)
    assert buf == ref_wire.pack_env(ref_env)
    # read back across packages
    (tmp_path / "f").write_bytes(buf)
    with open(tmp_path / "f", "rb") as f:
        got = wire.decode_request(wire.read_env(f)["items"][0][1])
    with open(tmp_path / "f", "rb") as f:
        ref_got = ref_wire.decode_request(
            ref_wire.read_env(f)["items"][0][1])
    assert isinstance(got.payload["img"], torch.Tensor)
    assert got.payload["img"].device.type == "cpu"
    assert np.array_equal(got.payload["img"].numpy(), ref_got.payload["img"])
    assert got.payload["tag"] == ref_got.payload["tag"] == b"\x00\x01"
    assert (got.model, got.deadline, got.priority, got.gen_steps) == \
        (ref_got.model, ref_got.deadline, ref_got.priority, 3)
    # a completion of the port's encodes as the reference's does
    from repro.serving.api import Completion as RC, RequestMetrics as RM
    from repro.serving.api import Ticket as RT
    from repro_torch.serving.api import Completion, RequestMetrics, Ticket
    m = dict(rid=4, submitted_at=1.0, started_at=1.5, finished_at=2.0,
             model="squeezenet", status="ok", deadline=None, slo_ok=True)
    c = Completion(Ticket(4, 1.0), torch.from_numpy(x), RequestMetrics(**m))
    rc = RC(RT(4, 1.0), x, RM(**m))
    assert json.dumps(wire.encode_completion(c)) == json.dumps(
        ref_wire.encode_completion(rc))
    back = wire.decode_completion(ref_wire.encode_completion(rc))
    assert torch.equal(back.output, torch.from_numpy(x))
    # drift is refused by both readers
    for mod in (wire, ref_wire):
        with pytest.raises(mod.WireError, match="unknown fields"):
            mod.unpack_env(b'{"v": 2, "kind": "frame", "gpu": 1}')
        with pytest.raises(mod.WireError, match="v2-only"):
            mod.unpack_env(b'{"v": 1, "kind": "telemetry"}')


# --------------------------------------------------------------------------
# cross-replay: one pool, with and without a REBALANCE mid-run
# --------------------------------------------------------------------------
def _run_with_rebalance(fleet, reqs, rebalance_cls):
    for r in reqs:
        fleet.submit(r)
    fleet.step()
    fleet.step()                                # work now in flight
    fleet.executor.inject(rebalance_cls(theta=0.7))
    return fleet.drain()


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's live runs, recorded once: Poisson arrivals with a
    burst of 4, and a run with a REBALANCE injected mid-run."""
    arr = ref_poisson_arrivals(4, rate=1.0, seed=0)
    live, _ = ref_fleet(burst=4)
    compiled = ref_compile_fleet(live, ref_requests(), arr)
    res = ref_replay(live, ref_requests(), arr)
    rb, rb_pool = ref_fleet()
    rb_res = _run_with_rebalance(rb, ref_requests(4, seed=2), RefRebalance)
    assert rb_pool.theta == 0.7
    return {"plain": (live.stream, res, arr, compiled),
            "rebalance": (rb.stream, rb_res, None, None)}


@pytest.fixture(scope="module")
def port_runs():
    """The port's live runs of the same traffic."""
    arr = poisson_arrivals(4, rate=1.0, seed=0)
    live, _ = port_fleet(burst=4)
    compiled = compile_fleet(live, port_requests(), arr)
    res = replay(live, port_requests(), arr)
    rb, rb_pool = port_fleet()
    rb_res = _run_with_rebalance(rb, port_requests(4, seed=2), Rebalance)
    assert rb_pool.theta == 0.7 and rb_pool.cores.theta == 0.7
    assert rb_pool.stats()["leases"] == sorted(MODELS)     # re-leased
    assert all(m.engine.runner.cores is rb_pool.cores for m in rb.members)
    return {"plain": (live.stream, res, arr, compiled),
            "rebalance": (rb.stream, rb_res, None, None)}


@pytest.mark.parametrize("case", ["plain", "rebalance"])
def test_live_runs_agree_with_reference(case, ref_runs, port_runs):
    ref_stream, ref_res, _, ref_compiled = ref_runs[case]
    stream, res, _, compiled = port_runs[case]
    validate_stream(stream)
    assert _sig(stream) == _sig(ref_stream)
    assert res.metrics.completed == ref_res.metrics.completed == 4
    _close(res.outputs, ref_res.outputs)
    if compiled is not None:
        assert stream_signature(compiled) == stream_signature(stream)
        assert _sig(compiled) == _sig(ref_compiled)


def _port_replay(case, doc, seed):
    fresh, pool = port_fleet(burst=4 if case == "plain" else 1)
    arr = (poisson_arrivals(4, rate=1.0, seed=0) if case == "plain"
           else None)
    res = fresh.executor.replay(instructions.stream_from_json(doc),
                                port_requests(4, seed=seed), arr)
    return fresh, pool, res


@pytest.mark.parametrize("case", ["plain", "rebalance"])
def test_reference_stream_replays_on_the_port(case, ref_runs, port_runs):
    ref_stream, ref_res, _, _ = ref_runs[case]
    doc = json.loads(json.dumps(ref_instr.stream_to_json(ref_stream,
                                                         pool="pool0")))
    seed = 0 if case == "plain" else 2
    fresh, pool, res = _port_replay(case, doc, seed)
    assert _sig(fresh.stream) == _sig(ref_stream)
    assert res.metrics.completed == 4
    _close(res.outputs, ref_res.outputs)
    _equal(res.outputs, port_runs[case][1].outputs)    # bit for bit
    if case == "rebalance":
        assert pool.theta == 0.7


@pytest.mark.parametrize("case", ["plain", "rebalance"])
def test_port_stream_replays_on_the_reference(case, ref_runs, port_runs):
    stream, res, arr, _ = port_runs[case]
    doc = json.loads(json.dumps(instructions.stream_to_json(stream)))
    fresh, pool = ref_fleet(burst=4 if case == "plain" else 1)
    seed = 0 if case == "plain" else 2
    ref_res = fresh.executor.replay(ref_instr.stream_from_json(doc),
                                    ref_requests(4, seed=seed), arr)
    assert _sig(fresh.stream) == _sig(stream)
    assert ref_res.metrics.completed == 4
    _close(res.outputs, ref_res.outputs)
    for a, b in zip(ref_res.outputs, ref_runs[case][1].outputs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fleet_outputs_bit_equal_standalone_sequential(port_runs):
    """Sharing the pool's cores changes no bit: every fleet output equals
    its model's standalone sequential run on the same weights."""
    _, res, _, _ = port_runs["plain"]
    fleet, _ = port_fleet()
    for req, out in zip(port_requests(), res.outputs):
        runner = fleet._by_name[req.model].engine.runner
        (seq,) = runner.run_sequential([req.payload])
        assert torch.equal(out, seq)


def test_fleet_jit_groups_changes_nothing_on_the_cpu(port_runs):
    """``build_cnn_fleet`` takes ``jit_groups`` with the reference's
    default and hands it to every member's runner; on the CPU it changes
    nothing: the live run's outputs bit-equal with it off, and within 1e-3
    of the reference fleet's with it on."""
    assert (inspect.signature(build_cnn_fleet).parameters["jit_groups"]
            .default is inspect.signature(ref_build_cnn_fleet)
            .parameters["jit_groups"].default is True)
    _, res, arr, _ = port_runs["plain"]
    eager, _ = port_fleet(burst=4, jit_groups=False)
    assert not any(m.engine.runner.jit_groups for m in eager.members)
    _equal(replay(eager, port_requests(), arr).outputs, res.outputs)
    ref, _ = ref_fleet(burst=4, jit_groups=True)
    _close(res.outputs, ref_replay(ref, ref_requests(), arr).outputs)


def test_chrome_trace_matches_reference_layout(ref_runs, port_runs):
    doc = chrome_trace({"pool0": port_runs["rebalance"][0]})
    ref_doc = ref_chrome_trace({"pool0": ref_runs["rebalance"][0]})
    names = {"c-core": "c-submesh", "p-core": "p-submesh"}

    def shape(d):
        return [(e["ph"], e["tid"], e.get("cat"),
                 names.get(e["args"].get("name"), e["args"].get("name"))
                 if e["ph"] == "M" else e["name"].replace("-core",
                                                          "-submesh"))
                for e in d["traceEvents"]]

    assert shape(doc) == shape(ref_doc)


# --------------------------------------------------------------------------
# two pools: migration, REBALANCE, telemetry
# --------------------------------------------------------------------------
def _two_pools(fleet_fn, router_cls, reqs, rebalance, transport=None):
    e0, _ = fleet_fn()
    e1, _ = fleet_fn(["squeezenet"])
    kw = {} if transport is None else {"transport": transport}
    router = router_cls({"p0": e0, "p1": e1}, **kw)
    for r in reqs:
        router.submit(r)
    moved = router.drain_pool("p1")                 # the forced migration
    assert moved >= 1
    router.step()
    if rebalance:
        router.rebalance("p0", mix={m: 0.5 for m in MODELS}, theta=0.6)
    return router, router.drain()


@pytest.fixture(scope="module")
def ref_two_pools():
    """The reference's 2-pool run, recorded once."""
    return _two_pools(ref_fleet, RefRouter, ref_requests(6, seed=3), True)


@pytest.mark.parametrize("transport", ["local", "file"])
def test_two_pools_match_reference(transport, ref_two_pools, tmp_path):
    ref_router, ref_res = ref_two_pools
    tr = FileTransport(str(tmp_path / "spool")) if transport == "file" \
        else None
    router, res = _two_pools(port_fleet, MultiPoolRouter,
                             port_requests(6, seed=3), True, tr)
    assert res.metrics.completed == 6
    assert [c.status for c in res.completions] == ["ok"] * 6
    assert router.rebalances == [("p0", 0.6)]
    assert router.executors["p0"].fleet.pool.theta == 0.6
    assert router.placements == ref_router.placements
    for name in ("p0", "p1"):
        assert _sig(router.streams()[name]) == _sig(
            ref_router.streams()[name])
    _close(res.outputs, ref_res.outputs)
    snap = router.obs.snapshot(domain="slot")
    assert snap == ref_router.obs.snapshot(domain="slot")
    assert snap["counters"]["fleet_sent_total"]["series"]
    assert to_prometheus(snap) == ref_to_prometheus(snap)
    if transport == "file":
        assert router.obs.snapshot(domain="wall")["counters"][
            "net_bytes_total"]["series"]
        assert not list((tmp_path / "spool").iterdir())   # all consumed
    # the recording replays bitwise on fresh port pools
    e0, _ = port_fleet()
    e1, _ = port_fleet(["squeezenet"])
    fresh = MultiPoolRouter({"p0": e0, "p1": e1})
    rep = fresh.replay({n: instructions.stream_from_json(
        instructions.stream_to_json(r, pool=n))
        for n, r in router.streams().items()}, router.placements,
        port_requests(6, seed=3))
    assert stream_signature(fresh.stream()) == stream_signature(
        router.stream())
    _equal(rep.outputs, res.outputs)
    assert fresh.obs.snapshot(domain="slot") == snap


@pytest.mark.parametrize("seed", [None, 3, 11])
def test_stub_pools_slot_metrics_match_reference(seed):
    """Two stub pools under a seeded fault plan (crashes, retries,
    dropped SENDs recovered): the port's decisions, recovery log and
    slot-domain snapshot equal the reference's, and a replay of the
    port's recording is dict-equal to its live run."""
    n = 12
    arrivals = poisson_arrivals(n, rate=2.0, seed=seed or 0)
    assert arrivals == ref_poisson_arrivals(n, rate=2.0, seed=seed or 0)
    runs = {}
    for pkg, plan_cls, inj_cls, req_cls, qf in (
            ("port", FaultPlan, FaultInjector, Request, QueueFull),
            ("ref", RefFaultPlan, RefInjector, RefRequest, RefQueueFull)):
        injector = None
        if seed is not None:
            injector = inj_cls(plan_cls.generate(
                seed, pools=["p0", "p1"], members=["a", "b"], n=3,
                max_slot=6))
        router = _stub_router(pkg, injector=injector)
        _drive(router, [req_cls(i, model="ab"[i % 2]) for i in range(n)],
               arrivals, qf)
        runs[pkg] = router
    port, ref = runs["port"], runs["ref"]
    assert port.events == ref.events
    assert port.placements == ref.placements
    assert _sig(port.stream()) == _sig(ref.stream())
    res, ref_res = port.result(), ref.result()
    assert [(c.status, c.output) for c in res.completions] == \
        [(c.status, c.output) for c in ref_res.completions]
    assert port.obs.snapshot(domain="slot") == \
        ref.obs.snapshot(domain="slot")
    fresh = _stub_router("port")
    fresh.replay({k: instructions.stream_from_json(
        instructions.stream_to_json(v, pool=k))
        for k, v in port.streams().items()}, port.placements,
        [Request(i, model="ab"[i % 2]) for i in range(n)],
        events=port.events)
    assert fresh.obs.snapshot(domain="slot") == \
        port.obs.snapshot(domain="slot")


@pytest.mark.parametrize("admission", ["shed", "deadline", "priority"])
def test_admission_policies_as_the_reference(admission):
    """Deadlines on the slot clock (``ShedPolicy``: the same requests shed
    at the same fleet slots), earliest deadline and highest priority
    first: the same completion order and statuses, summaries, slot
    telemetry and sliding-window stats as the reference."""
    outs = {}
    for pkg, req_cls, mod in (("port", Request, serving_api),
                              ("ref", RefRequest, ref_serving_api)):
        pol = {"shed": lambda: mod.ShedPolicy(),
               "deadline": lambda: mod.DeadlineAdmission(),
               "priority": lambda: mod.PriorityAdmission()}[admission]
        router = _stub_router(pkg, policy=pol)
        window = mod.MetricsWindow(size=6)
        for i in range(10):
            router.submit(req_cls(i, model="ab"[i % 2], priority=i % 3,
                                  deadline=float((9 - i) // 3)))
        order = []
        while router.has_work:
            done = router.step()
            window.observe(done)
            order.extend((c.ticket.rid, c.status) for c in done)
        s = router.result().metrics.summary()
        outs[pkg] = (order, {k: s[k] for k in ("completed", "shed")},
                     router.obs.snapshot(domain="slot"),
                     {m: {k: v for k, v in st.items() if k != "p95_ms"}
                      for m, st in window.by_model().items()})
    assert outs["port"] == outs["ref"]
    statuses = {st for _, st in outs["port"][0]}
    assert statuses == ({"ok", "shed"} if admission == "shed" else {"ok"})


def test_pool_leases_and_resplit_keep_the_streams():
    pool = DevicePool("cpu", theta=0.5)
    cores = pool.lease("mobilenet_v1")
    assert pool.lease("squeezenet") is cores is pool.cores
    with pytest.raises(ValueError, match="already held"):
        pool.lease("mobilenet_v1")
    with pytest.raises(RuntimeError, match="revoke_all"):
        pool.resplit(0.7)
    assert pool.revoke_all() == ["mobilenet_v1", "squeezenet"]
    new = pool.resplit(0.7)
    assert new.streams == cores.streams and new.theta == 0.7
    assert cores.theta == 0.5                   # the old split unchanged
    assert pool.stats()["sm_split"] is False
    assert pool.stats()["degenerate"] is True      # one queue on the CPU
    with pytest.raises(KeyError):
        pool.release("never_leased")


# --------------------------------------------------------------------------
# LM members beside CNN members
# --------------------------------------------------------------------------
LM_ARCH = "qwen2_0_5b"


@pytest.fixture(scope="module")
def lm_weights():
    """``get_smoke("qwen2_0_5b")``'s reference parameters and the same
    parameters carried over to the port."""
    cfg = get_smoke(LM_ARCH)
    ref_params = ref_lm_model.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, ref_params, lm_model.params_from_numpy(
        jax.tree.map(np.asarray, ref_params), device="cpu")


def _lm_engine(pkg, lm_weights, **kw):
    cfg, ref_params, params = lm_weights
    if pkg == "ref":
        return RefLMEngine(RefLMRunner(cfg, ref_params,
                                       split_mesh(jax.devices()[:1], 0.5),
                                       max_len=16), **kw)
    return DualMeshEngine(DualMeshRunner(cfg, params, split_streams("cpu"),
                                         max_len=16), **kw)


def _cnn_engine(pkg, model="squeezenet"):
    fl, _ = (ref_fleet if pkg == "ref" else port_fleet)([model])
    return fl._by_name[model].engine


def _mixed(pkg, lm_weights, fleet_kw=None, **lm_kw):
    """An LM member and a SqueezeNet member in one fleet, as the
    reference's fleet tests build one."""
    return (RefFleet if pkg == "ref" else FleetEngine)(
        {"lm": _lm_engine(pkg, lm_weights, **lm_kw),
         "squeezenet": _cnn_engine(pkg)}, **(fleet_kw or {}))


def _lm_prompts(n, seed=1, plen=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, get_smoke(LM_ARCH).vocab, (1, plen))
            for _ in range(n)]


def _mixed_requests(pkg, plan):
    """Requests from ``plan``: ("lm", gen) or ("img", seed) each."""
    req = RefRequest if pkg == "ref" else Request
    to = jnp.asarray if pkg == "ref" else torch.from_numpy
    prompts = iter(_lm_prompts(sum(k == "lm" for k, _ in plan)))
    out = []
    for kind, v in plan:
        if kind == "lm":
            out.append(req(to(next(prompts)), gen_steps=v, model="lm"))
        else:
            out.append(req(to(_images(1, v)[0]), model="squeezenet"))
    return out


def _check_mixed(port_res, ref_res):
    """LM tokens equal, CNN logits within ``TOL``, statuses equal."""
    assert [c.status for c in port_res.completions] == \
        [c.status for c in ref_res.completions]
    for a, b in zip(port_res.outputs, ref_res.outputs):
        if a.dtype == torch.int64:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_fleet_with_lm_member_matches_reference(lm_weights):
    """The reference's LM + CNN fleet: a ``DualMeshEngine`` beside a
    ``DualCoreEngine`` behind one front end, its decode fused into RUNs;
    the same stream, tokens equal and logits within 1e-3 of the
    reference's."""
    plan = [("lm", 2), ("img", 2)]
    runs = {}
    for pkg in ("port", "ref"):
        eng = _mixed(pkg, lm_weights, group_size=1)
        for r in _mixed_requests(pkg, plan):
            eng.submit(r)
        runs[pkg] = (eng, eng.drain())
    (eng, res), (ref_eng, ref_res) = runs["port"], runs["ref"]
    assert res.metrics.completed == 2
    assert tuple(res.outputs[0].shape) == (1, 6)   # prompt + 2 generated
    assert tuple(res.outputs[1].shape) == (1, 1000)
    assert set(res.metrics.by_model()) == {"lm", "squeezenet"}
    _check_mixed(res, ref_res)
    assert _sig(eng.stream) == _sig(ref_eng.stream)
    assert any(r.instr.fused for r in eng.stream
               if r.instr.op == "RUN" and r.instr.member == "lm")


def test_controlled_mixed_fleet_retunes_and_replays(lm_weights):
    """A controlled LM + CNN fleet (an SLO far below any latency): the
    controller halves the LM member's fusion width; both packages emit
    the same actions and streams, tokens equal, logits within 1e-3; the
    port's recording replays bitwise on a fresh uncontrolled port fleet,
    its decision log verifying there, and with the same signature on the
    reference's."""
    plan = ([("lm", 4)] + [("img", s) for s in range(3)]
            + [("lm", 3)] * 3 + [("img", s) for s in range(3, 6)])
    arrivals = [0, 0, 1, 2, 5, 5, 5, 6, 7, 8]
    lm_kw = dict(group_size=4, quantum=2)
    fleet_kw = dict(burst=2)
    runs = {}
    for pkg, ctl_cls, rep in (("port", ControlLoop, replay),
                              ("ref", RefControlLoop, ref_replay)):
        eng = _mixed(pkg, lm_weights, fleet_kw, **lm_kw)
        ctl = ctl_cls(eng, interval=2, slo_ms=1e-3)
        res = rep(eng, _mixed_requests(pkg, plan), arrivals)
        runs[pkg] = (eng, ctl, res)
    (eng, ctl, res), (ref_eng, ref_ctl, ref_res) = runs["port"], runs["ref"]
    retunes = [d.action for d in ctl.decisions if d.action.kind == "retune"]
    assert [a.value for a in retunes] == [2, 1]
    assert [dataclasses.asdict(d.action) for d in ctl.decisions] == \
        [dataclasses.asdict(d.action) for d in ref_ctl.decisions]
    # the three later requests fuse 2 + 1 after the first halving (4 would
    # have fused all 3 at once)
    assert eng._by_name["lm"].engine.fused_sizes == [1, 2, 1] == \
        ref_eng._by_name["lm"].engine.fused_sizes
    assert res.stats["control"]["by_kind"]["retune"] == 2
    _check_mixed(res, ref_res)
    assert _sig(eng.stream) == _sig(ref_eng.stream)
    verify_decisions(eng.stream, ctl.decisions)

    doc = instructions.stream_to_json(eng.stream, pool="pool0")
    fresh = _mixed("port", lm_weights, fleet_kw, **lm_kw)
    assert fresh.controller is None
    rep = fresh.executor.replay(instructions.stream_from_json(doc),
                                _mixed_requests("port", plan), arrivals)
    assert stream_signature(fresh.stream) == stream_signature(eng.stream)
    _equal(rep.outputs, res.outputs)
    verify_decisions(fresh.stream, ctl.decisions)
    assert fresh._by_name["lm"].engine.group_size == 1
    ref_fresh = _mixed("ref", lm_weights, fleet_kw, **lm_kw)
    ref_rep = ref_fresh.executor.replay(ref_instr.stream_from_json(doc),
                                        _mixed_requests("ref", plan),
                                        arrivals)
    assert _sig(ref_fresh.stream) == _sig(eng.stream)
    _check_mixed(rep, ref_rep)
    assert any(isinstance(r.instr, SetParam) for r in fresh.stream)


def test_multipool_lm_cnn_round_trip_bitwise(lm_weights):
    """The reference's mixed-modality round trip: two pools, an LM member
    (fused RUNs) beside CNN members, a forced migration; recorded,
    serialized and replayed on fresh port pools bitwise, and on fresh
    reference pools with the same signature and outputs."""
    plan = [("lm", 2)] + [("img", s) for s in range(4)]

    def pools(pkg):
        fleet = RefFleet if pkg == "ref" else FleetEngine
        return {"p0": fleet({"lm": _lm_engine(pkg, lm_weights,
                                              group_size=1),
                             "squeezenet": _cnn_engine(pkg)}),
                "p1": fleet({"squeezenet": _cnn_engine(pkg)})}

    live = MultiPoolRouter(pools("port"))
    for r in _mixed_requests("port", plan):
        live.submit(r)
    assert live.drain_pool("p1") >= 1           # force SEND/RECV mid-run
    res = live.drain()
    assert res.metrics.completed == 5
    assert tuple(res.outputs[0].shape) == (1, 6)
    fused = [r for r in live.stream() if r.instr.op == "RUN"
             and r.instr.fused]
    assert fused and all(r.instr.member == "lm" for r in fused)
    docs = {name: instructions.stream_to_json(recs, pool=name)
            for name, recs in live.streams().items()}
    fresh = MultiPoolRouter(pools("port"))
    rep = fresh.replay({k: instructions.stream_from_json(v)
                        for k, v in docs.items()}, live.placements,
                       _mixed_requests("port", plan))
    assert stream_signature(fresh.stream()) == stream_signature(
        live.stream())
    _equal(rep.outputs, res.outputs)
    ref = RefRouter(pools("ref"))
    ref_rep = ref.replay({k: ref_instr.stream_from_json(v)
                          for k, v in docs.items()}, live.placements,
                         _mixed_requests("ref", plan))
    assert _sig(ref.stream()) == _sig(live.stream())
    _check_mixed(rep, ref_rep)
