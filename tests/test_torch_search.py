"""The LM design flow of the port (``repro_torch.dualmesh.schedule``'s
N-stream schedule and ``dualmesh/search.py``) against the reference's on
the CPU.

The reference's ``tests/test_nstream.py`` scenarios run on the port; on
abstract cards (the reference's semantics) ``best_schedule``,
``load_balance`` and ``search`` match the reference at its constants
(``REF_HW``: bf16 elements, 16 GiB a chip) to 1e-12 with the same visited
thetas; the plan on the card's SMs splits on the 8-SM granule, counts the
weights once, relaxes when nothing fits and makes no green context; and
``serve lm --search`` prints its design-flow line on the CPU.
"""
import dataclasses
import random

import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.configs.registry import get_smoke as ref_get_smoke
from repro.dualmesh import TpuModel
from repro.dualmesh import best_schedule as ref_best_schedule
from repro.dualmesh import build as ref_build
from repro.dualmesh import load_balance as ref_load_balance
from repro.dualmesh import request_stages as ref_request_stages
from repro.dualmesh import search as ref_search
from repro.dualmesh.partition import abstract_split as ref_abstract_split
from repro_torch.configs.registry import get_arch, get_smoke
from repro_torch.dualmesh import (ALLOCATIONS, CardModel, DualSchedule,
                                  DualMeshRunner, MeshGroup, abstract_split,
                                  best_schedule, build, card_memory,
                                  card_split, load_balance,
                                  makespan_lower_bound, plan_admission,
                                  request_stages, search, split_streams,
                                  wave_makespan)
from repro_torch.dualmesh.runtime import random_prompts
from repro_torch.kernels import green
from repro_torch.lm import model

# the reference's constants and its bf16 element and 16 GiB chips, handed
# to the port's card model
REF_HW = CardModel(peak_flops=197e12, mem_bw=819e9, link_bw=50e9,
                   mfu_ceiling=0.6, bw_ceiling=0.8, step_floor_base=25e-6,
                   step_floor_tp=8e-6, step_floor_dp=2e-6, elem_bytes=2,
                   mem_bytes=16 * 1024 ** 3)
ARCH = "qwen2_5_14b"
CFG = get_arch(ARCH)
DUAL = abstract_split(256, 0.5)
TRAFFIC = {"long": [(8, 4096, 64)], "two": [(8, 1024, 1024)] * 2,
           "path": [(2, 512, 64)], "many": [(8, 8192, 256)] * 4}


def _sched(n_streams, scheme="stage_type"):
    stages = request_stages(CFG, [(8, 4096, 64)])
    return build(stages, CFG, DUAL, REF_HW, scheme, n_streams=n_streams)


def _closed_form(t):
    """The corrected T_b2 two-stream closed form."""
    return t[0] + sum(max(t[i], t[i - 1])
                      for i in range(1, len(t))) + t[-1]


# --------------------------------------------------------------------------
# the reference's N-stream scenarios (tests/test_nstream.py) on the port
# --------------------------------------------------------------------------
def test_nstream_makespan_reduces_to_two_stream_recurrence():
    s2 = _sched(2)
    assert s2.makespan() == pytest.approx(_closed_form(s2.latencies()),
                                          rel=1e-12)
    stages = request_stages(CFG, TRAFFIC["many"])
    for scheme in ("stage_type", "round_robin"):
        s = build(stages, CFG, DUAL, REF_HW, scheme, n_streams=2)
        assert len(s.groups) > 2
        assert s.makespan() == pytest.approx(_closed_form(s.latencies()),
                                             rel=1e-12)


def test_two_stream_equivalence_on_random_chains():
    rng = random.Random(0)
    for _ in range(200):
        g = rng.randint(1, 9)
        lat = [rng.choice([1, 2, 3, 5, 8, 100]) * rng.random()
               for _ in range(g)]
        sched = DualSchedule(
            [MeshGroup("c" if i % 2 == 0 else "p", []) for i in range(g)],
            CFG, DUAL, REF_HW, n_streams=2)
        sched.latencies = lambda lat=lat: lat      # inject raw chain
        assert sched.makespan() == pytest.approx(_closed_form(lat),
                                                 rel=1e-9)


def test_single_stream_makespan_is_chain_sum():
    s = _sched(1)
    assert s.makespan() == pytest.approx(sum(s.latencies()))


def test_makespan_monotone_and_amortizing_in_n():
    s = _sched(2)
    ns = (1, 2, 4, 8, 16)
    spans = [s.makespan(n) for n in ns]
    assert all(b > a for a, b in zip(spans, spans[1:]))
    per_stream = [sp / n for sp, n in zip(spans, ns)]
    assert all(b <= a + 1e-12 for a, b in zip(per_stream, per_stream[1:]))
    thr = [s.throughput_tokens_per_s(n) for n in ns]
    assert all(b > a for a, b in zip(thr, thr[1:]))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_load_balance_never_worse_at_any_n(n):
    for scheme in ALLOCATIONS:
        s = _sched(n, scheme)
        lb = load_balance(s)
        assert lb.n_streams == n
        assert lb.makespan() <= s.makespan() + 1e-12


def test_best_schedule_throughput_nondecreasing_in_n():
    stages = request_stages(CFG, [(8, 4096, 64)])
    thr = [best_schedule(stages, CFG, DUAL, REF_HW,
                         n_streams=n).throughput_tokens_per_s()
           for n in (2, 4, 8, 16)]
    assert all(b >= a for a, b in zip(thr, thr[1:]))


def test_token_accounting_is_batch_and_n_aware():
    s = _sched(4)
    per_stream = 8 * 4096 + 8 * 64          # batch*(prompt + gen)
    assert s.stream_tokens() == per_stream
    assert s.total_tokens() == 4 * per_stream
    assert s.total_tokens(16) == 16 * per_stream


def test_runtime_tokens_match_schedule_accounting():
    """The schedule's token count equals what the port's runtime processes
    and emits for the same N x (batch, prompt, gen) workload."""
    cfg = get_smoke("qwen2_0_5b")
    params = model.load_params(cfg, 0, "cpu")
    r = DualMeshRunner(cfg, params, split_streams("cpu", 0.5), max_len=32)
    n, batch, plen, gen = 3, 2, 8, 4
    res = r.serve(random_prompts(cfg, n, batch, plen), gen_steps=gen)
    sched = build(request_stages(cfg, [(batch, plen, gen)]), cfg, DUAL,
                  REF_HW, "stage_type", n_streams=n)
    assert res.stats["total_tokens"] == sched.total_tokens()
    assert res.stats["prefill_tokens"] == n * batch * plen
    assert res.stats["decode_tokens"] == n * batch * gen


def test_admission_plan_beats_or_matches_extremes():
    for dual in (DUAL, card_split(0.5, CardModel().sm_count)):
        plan = plan_admission(CFG, dual, REF_HW, 8, 4096, 256, 8)
        assert 1 <= plan.group_size <= 8
        for g in (1, 8):
            assert plan.est_makespan <= wave_makespan(
                CFG, dual, REF_HW, 8, 4096, 256, 8, g) + 1e-12


def test_admission_respects_max_group():
    plan = plan_admission(CFG, DUAL, REF_HW, 8, 4096, 256, 16, max_group=2)
    assert plan.group_size <= 2


@pytest.mark.parametrize("on_card", [False, True])
def test_search_carries_n_streams(on_card):
    stages = request_stages(CFG, [(8, 4096, 64)])
    kw = {} if on_card else dict(n_devices=256, hw=REF_HW)
    res = search(stages, CFG, max_evals=4, n_streams=8, **kw)
    assert res.n_streams == 8
    assert res.schedule.n_streams == 8
    assert res.makespan == pytest.approx(res.schedule.makespan())


@pytest.mark.parametrize("on_card", [False, True])
def test_search_still_explores_theta(on_card):
    stages = request_stages(CFG, TRAFFIC["two"])
    kw = {} if on_card else dict(n_devices=256, hw=REF_HW)
    res = search(stages, CFG, max_evals=8, **kw)
    assert len(res.visited) > 1


# --------------------------------------------------------------------------
# abstract cards: the reference's numbers
# --------------------------------------------------------------------------
def _groups(sched):
    return [(g.mesh, [dataclasses.astuple(st) for st in g.stages])
            for g in sched.groups]


@pytest.mark.parametrize("n_devices", [8, 256])
@pytest.mark.parametrize("name", ["qwen2_0_5b", "qwen2_5_14b",
                                  "granite_20b", "qwen2_moe_a2_7b"])
def test_schedules_match_reference_on_abstract_cards(name, n_devices):
    """``build`` under each allocation, ``load_balance`` of it and
    ``best_schedule``, on the reference's abstract split, at 2 and 8
    streams: the same groups, latencies and makespans."""
    stages = request_stages(get_arch(name), TRAFFIC["many"])
    ref_stages = ref_request_stages(ref_get_arch(name), TRAFFIC["many"])
    for theta, tp_c, tp_p in ((0.5, 16, 4), (0.3, 4, 1)):
        mine = abstract_split(n_devices, theta, tp_c, tp_p)
        ref = ref_abstract_split(n_devices, theta, tp_c, tp_p)
        assert (mine.c_chips, mine.p_chips, mine.theta) == \
            (ref.c_chips, ref.p_chips, ref.theta)
        for n in (2, 8):
            pairs = []
            for scheme in ALLOCATIONS:
                a = build(stages, get_arch(name), mine, REF_HW, scheme, n)
                b = ref_build(ref_stages, ref_get_arch(name), ref,
                              TpuModel(), scheme, n)
                pairs += [(a, b), (load_balance(a), ref_load_balance(b))]
            pairs.append((best_schedule(stages, get_arch(name), mine,
                                        REF_HW, n_streams=n),
                          ref_best_schedule(ref_stages, ref_get_arch(name),
                                            ref, TpuModel(), n_streams=n)))
            for a, b in pairs:
                assert a.scheme == b.scheme
                assert _groups(a) == _groups(b)
                assert a.latencies() == pytest.approx(b.latencies(),
                                                      rel=1e-12)
                assert a.makespan() == pytest.approx(b.makespan(), rel=1e-12)
                assert a.throughput_tokens_per_s() == pytest.approx(
                    b.throughput_tokens_per_s(), rel=1e-12)


@pytest.mark.parametrize("name,n_devices,traffic,n_streams", [
    ("qwen2_0_5b", 8, "path", 8), ("qwen2_0_5b", 256, "two", 2),
    ("qwen2_5_14b", 8, "long", 8), ("qwen2_5_14b", 64, "two", 2),
    ("qwen2_5_14b", 256, "path", 8), ("granite_20b", 64, "long", 8),
    ("granite_20b", 256, "two", 2), ("command_r_plus_104b", 8, "path", 8),
    ("command_r_plus_104b", 256, "long", 8), ("qwen2_moe_a2_7b", 8, "two", 2),
    ("qwen2_moe_a2_7b", 64, "long", 8), ("qwen2_moe_a2_7b", 256, "path", 8)])
def test_search_matches_reference_on_abstract_cards(name, n_devices,
                                                     traffic, n_streams):
    """The reference's theta, TP pair, makespan, tokens/s and visited
    thetas, fits and relaxation (Command R+ fits nowhere) alike."""
    want = ref_search(ref_request_stages(ref_get_arch(name),
                                         TRAFFIC[traffic]),
                      ref_get_arch(name), n_devices=n_devices,
                      max_evals=16, n_streams=n_streams)
    got = search(request_stages(get_arch(name), TRAFFIC[traffic]),
                 get_arch(name), n_devices=n_devices, hw=REF_HW,
                 max_evals=16, n_streams=n_streams)
    assert got.visited == want.visited
    assert got.theta == want.theta
    assert (got.tp_c, got.tp_p) == (want.tp_c, want.tp_p)
    assert (got.dual.c_chips, got.dual.p_chips) == (want.dual.c_chips,
                                                    want.dual.p_chips)
    assert got.makespan == pytest.approx(want.makespan, rel=1e-12)
    assert got.tokens_per_s == pytest.approx(want.tokens_per_s, rel=1e-12)
    assert got.n_streams == want.n_streams
    assert got.sms is None
    assert got.relaxed == (name == "command_r_plus_104b")


def test_lower_bound_matches_reference_on_abstract_cards():
    from repro.dualmesh.search import makespan_lower_bound as ref_bound
    for name in ("qwen2_0_5b", "qwen2_5_14b"):
        for n, theta in ((2, 0.8), (8, 0.3), (256, 0.45)):
            want = ref_bound(ref_request_stages(ref_get_arch(name),
                                                TRAFFIC["two"]),
                             ref_get_arch(name), n, theta, TpuModel())
            got = makespan_lower_bound(
                request_stages(get_arch(name), TRAFFIC["two"]),
                get_arch(name), n, theta, REF_HW)
            assert got == pytest.approx(want, rel=1e-12)


# --------------------------------------------------------------------------
# the card's SMs
# --------------------------------------------------------------------------
@pytest.fixture
def no_split(monkeypatch):
    """``split_sms`` and the driver refuse: the card plan must not call
    them."""
    def refuse(*a, **k):
        raise AssertionError("the search made a split")

    monkeypatch.setattr(green, "split_sms", refuse)
    monkeypatch.setattr(green, "_make_split", refuse)
    monkeypatch.setattr(green, "driver", refuse)


@pytest.mark.parametrize("name", ["qwen2_0_5b", "qwen2_5_14b",
                                  "qwen2_moe_a2_7b", "granite_moe_3b_a800m"])
def test_card_plan_splits_on_the_granule(name, no_split):
    """Every visited theta is a split ``split_streams`` would make: its
    c-core SMs a multiple of 8, each split evaluated once; the result at
    TP 1 a core, priced at its shares, and the schedule its makespan."""
    cfg = get_arch(name)
    stages = request_stages(cfg, TRAFFIC["path"])
    res = search(stages, cfg, max_evals=10, n_streams=8)
    counts = [card_split(t, res.sms).c_sms for t in res.visited]
    assert len(set(counts)) == len(counts) > 1
    assert all(c % green.GRANULE == 0 for c in counts)
    assert res.sms == 132 and (res.tp_c, res.tp_p) == (1, 1)
    d = res.dual
    assert d.c_sms == green.split_count(res.theta, 132)
    assert d.c_sms + d.p_sms == 132
    assert (d.c_share, d.p_share) == (d.c_sms / 132, d.p_sms / 132)
    assert res.theta == d.c_sms / 132
    assert res.makespan == pytest.approx(res.schedule.makespan())
    assert not res.relaxed
    # the chosen split is the best of those visited
    for t in res.visited:
        alt = best_schedule(stages, cfg, card_split(t, 132),
                            CardModel(), n_streams=8)
        assert res.makespan <= alt.makespan() + 1e-12


def test_card_plan_repeated_split_is_not_a_visit():
    """0.4952 and 0.5 both ask 64 SMs: the split is evaluated once; the
    abstract plan counts both, as the reference does."""
    assert card_split(0.4952, 132).c_sms == card_split(0.5, 132).c_sms == 64
    stages = request_stages(CFG, TRAFFIC["path"])
    card = search(stages, CFG, max_evals=10, n_streams=8)
    pod = search(stages, CFG, n_devices=256, hw=REF_HW, max_evals=10,
                 n_streams=8)
    assert card.visited.count(0.5) == 1
    assert pod.visited[:2] == [0.5, 0.5]


def test_card_memory_counts_the_weights_once():
    """One HBM: the weights once and both cores' KV; the 14B fits the data
    sheet's 80 GB at f32 (the reference, a copy a submesh, would not fit
    it twice)."""
    hw = CardModel()
    stages = request_stages(CFG, TRAFFIC["path"])
    mem = card_memory(stages, CFG, hw)
    kv_one = 2.0 * CFG.n_layers * 2 * CFG.n_kv_heads * CFG.d_head * 512 * 4
    assert mem["weights"] == 4.0 * CFG.param_count()
    assert mem["kv"] == pytest.approx(2 * kv_one)
    assert mem["limit"] == 0.75 * 80e9
    assert 0 < mem["margin"] < 2 * 4.0 * CFG.param_count() - mem["limit"]
    assert mem["margin"] == pytest.approx(
        mem["limit"] - mem["weights"] - mem["kv"])
    assert not search(stages, CFG, max_evals=4, n_streams=8).relaxed


def test_card_plan_relaxes_when_nothing_fits(no_split):
    """Granite-20B (113 GB of f32) fits no split of one card: the plan at
    0.5 regardless, flagged, its 0.5 evaluated again as the reference's
    relaxation does."""
    cfg = get_arch("granite_20b")
    stages = request_stages(cfg, TRAFFIC["path"])
    assert card_memory(stages, cfg, CardModel())["margin"] < 0
    res = search(stages, cfg, max_evals=10, n_streams=8)
    assert res.relaxed
    assert res.visited[-1] == 0.5 and res.dual.c_sms == 64
    small = dataclasses.replace(CardModel(), mem_bytes=10 ** 9)
    assert search(request_stages(get_arch("qwen2_0_5b"), TRAFFIC["path"]),
                  get_arch("qwen2_0_5b"), hw=small, max_evals=4).relaxed


def test_card_plan_prices_each_core_at_its_share():
    """The card plan's lower bound and schedule price each core at its SM
    share: at the same theta, a model at share 1 on both cores bounds
    lower; and the search's theta moves with the traffic."""
    stages = request_stages(CFG, TRAFFIC["path"])
    plan = card_split(0.3, 132)
    lb = makespan_lower_bound(stages, CFG, 132, 0.3, CardModel(),
                              on_card=True)
    whole = dataclasses.replace(plan, c_share=1.0, p_share=1.0)
    s_split = best_schedule(stages, CFG, plan, CardModel(), n_streams=8)
    s_whole = best_schedule(stages, CFG, whole, CardModel(), n_streams=8)
    assert s_whole.makespan() < s_split.makespan()
    assert 0 < lb <= s_split.makespan(1) + 1e-12
    thetas = {search(request_stages(CFG, t), CFG, max_evals=10,
                     n_streams=8).theta
              for t in ([(2, 512, 64)], [(2, 64, 1024)])}
    assert len(thetas) == 2


def test_card_model_reads_the_card(monkeypatch):
    """On a card the plan takes its memory and SM count; on the CPU the
    data sheet's."""
    from repro_torch.dualmesh.search import card_model

    class Props:
        total_memory = 85_000_000_000
        multi_processor_count = 114

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    hw = card_model("cuda")
    assert (hw.mem_bytes, hw.sm_count) == (85_000_000_000, 114)
    assert card_model("cpu") == CardModel()
    stages = request_stages(CFG, TRAFFIC["path"])
    assert search(stages, CFG, hw=hw, max_evals=4).sms == 114


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------
@pytest.mark.parametrize("extra,where", [
    ([], "on a modelled H100's 132 SMs (c "),
    (["--plan-chips", "256"], "on 256 abstract cards (c ")])
def test_serve_lm_search_on_cpu(extra, where, capsys, no_split):
    """``serve lm --device cpu --smoke --search`` plans, prints the
    design-flow line and serves at the planned theta."""
    import repro_torch.launch.serve as serve

    assert serve.main(["lm", "--arch", "qwen2_moe_a2_7b", "--device", "cpu",
                       "--smoke", "--search", "--requests", "3", "--batch",
                       "1", "--prompt-len", "6", "--gen", "4", *extra]) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if "design flow:" in ln)
    assert "theta=" in line and "planned makespan=" in line
    assert "tokens/s=" in line and where in line and "visited" in line
    assert "qwen2_moe_a2_7b_smoke: 3 requests x batch 1" in out


def test_serve_lm_plan_chips_needs_search(capsys):
    import repro_torch.launch.serve as serve

    for extra in (["--plan-chips", "8"], ["--search", "--plan-chips", "1"]):
        with pytest.raises(SystemExit) as exc:
            serve.main(["lm", "--arch", "qwen2_0_5b", "--device", "cpu",
                        "--smoke", *extra])
        assert exc.value.code == 2
    assert "--plan-chips N takes --search" in capsys.readouterr().err


def test_serve_lm_smoke_takes_get_smoke(capsys):
    """``--smoke`` serves the reduced configuration, the reference's
    ``get_smoke``, with the same fields."""
    import repro_torch.launch.serve as serve

    assert dataclasses.asdict(get_smoke("granite_moe_3b_a800m")) == \
        dataclasses.asdict(ref_get_smoke("granite_moe_3b_a800m"))
    assert serve.main(["lm", "--arch", "granite_moe_3b_a800m", "--device",
                       "cpu", "--smoke", "--requests", "2", "--batch", "1",
                       "--prompt-len", "5", "--gen", "3"]) == 0
    assert "granite_moe_3b_a800m_smoke: 2 requests" in \
        capsys.readouterr().out
