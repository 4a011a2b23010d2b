"""The SSM, hybrid, encoder-decoder and M-RoPE families of the port against
the reference, on the CPU.

xLSTM (mLSTM blocks), Zamba2 (Mamba2 with a weight-shared attention
block), Whisper (encoder-decoder) and Qwen2-VL (M-RoPE), each at its smoke
width with the reference's own ``init_params`` carried over as numpy: the
parameter tree's shapes, ``forward``, ``encode``, ``init_cache`` and a
chunked prefill followed by decode steps, logits and every cache field at
``LM_TOL`` (1e-4: f32 on both sides, only the order of the sums differs).
The chunk of the SSM scan is monkeypatched to 4 in both packages, so the
prefills cross chunks.  Then serving: ``DualMeshEngine`` on the CPU gives
the reference runner's greedy tokens for xLSTM and Zamba2, ``serve lm``
runs the three configs the reference serves and refuses Whisper, and the
admission plan and the design-flow search match the reference's.  The
port runs on ``device="cpu"``, where every kernel wrapper takes its plain
version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.configs.registry import get_smoke as ref_get_smoke
from repro.dualmesh import DualMeshRunner as RefRunner
from repro.dualmesh import TpuModel
from repro.dualmesh import plan_admission as ref_plan_admission
from repro.dualmesh import request_stages as ref_request_stages
from repro.dualmesh import search as ref_search
from repro.dualmesh import split_mesh
from repro.lm import model as ref_model
from repro.lm import modules as ref_modules
from repro.lm import ssm as ref_ssm
from repro.serving import DualMeshEngine as RefEngine
from repro.serving import Request as RefRequest
from repro_torch.configs.registry import ARCH_IDS, get_arch, get_smoke
from repro_torch.dualmesh import (CardModel, DualMeshRunner, plan_admission,
                                  request_stages, search, split_streams)
from repro_torch.lm import model, modules, ssm
from repro_torch.serving.api import Request
from repro_torch.serving.lm import DualMeshEngine

LM_TOL = dict(rtol=1e-4, atol=1e-4)
BLOCKS = ("xlstm_350m", "zamba2_2_7b", "whisper_small", "qwen2_vl_72b")
#: the configs the reference serves: Whisper's cache needs encoder input
SERVED = ("xlstm_350m", "zamba2_2_7b", "qwen2_vl_72b")
# the reference's constants and its bf16 element and 16 GiB chips, handed
# to the port's card model
REF_HW = CardModel(peak_flops=197e12, mem_bw=819e9, link_bw=50e9,
                   mfu_ceiling=0.6, bw_ceiling=0.8, step_floor_base=25e-6,
                   step_floor_tp=8e-6, step_floor_dp=2e-6, elem_bytes=2,
                   mem_bytes=16 * 1024 ** 3)
BATCH, PROMPT, STEPS, MAX_LEN = 2, 8, 6, 16


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(ssm, "CHUNK", 4)
    monkeypatch.setattr(ref_ssm, "CHUNK", 4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **LM_TOL)


@pytest.fixture(scope="module", params=BLOCKS)
def blocks(request):
    """A smoke config, the reference's parameters, and the same parameters
    carried over to the port."""
    cfg = ref_get_smoke(request.param)
    ref_params = ref_model.init_params(cfg, jax.random.PRNGKey(3))
    params = model.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                     device="cpu")
    return request.param, cfg, ref_params, params


def _inputs(cfg, seq: int, seed: int = 5) -> dict:
    """Seeded model inputs of ``seq`` tokens: tokens, and for Qwen2-VL
    distinct t/h/w position streams and 3 patch embeddings, for Whisper
    the encoder's frame embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (BATCH, seq))}
    if cfg.mrope:
        t = np.arange(seq)
        out["positions3"] = np.stack(
            [np.broadcast_to(t, (BATCH, seq)),
             np.broadcast_to(t // 2, (BATCH, seq)),
             np.broadcast_to(t % 3 + t, (BATCH, seq))], axis=1)
        out["extra_embeds"] = (rng.standard_normal(
            (BATCH, 3, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.encoder_decoder:
        out["enc_input"] = (rng.standard_normal(
            (BATCH, cfg.enc_positions, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def _caches_close(pc, rc):
    """Every field of the port's cache against the reference's."""
    for f in model.ROW_FIELDS:
        mine, ref = getattr(pc, f), getattr(rc, f)
        assert (mine is None) == (ref is None), f
        if mine is not None:
            assert tuple(mine.shape) == ref.shape, f
            _close(mine, ref)
    assert pc.pos == int(pc.pos_dev) == int(rc.pos)


# --------------------------------------------------------------------------
# configs and parameters
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", BLOCKS)
def test_configs_match_reference(name):
    """``full()`` and ``smoke()``: the reference's fields, padded
    vocabulary and parameter count; registered and supported."""
    for mine, ref in ((get_arch(name), ref_get_arch(name)),
                      (get_smoke(name), ref_get_smoke(name))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.padded_vocab == ref.padded_vocab
        assert mine.param_count() == ref.param_count()
        model.check_supported(mine)
    assert name in ARCH_IDS


def test_init_params_has_the_reference_shapes(blocks):
    """The port's seeded tree has the reference's leaves and shapes; the
    loader gives it bit for bit."""
    name, cfg, ref_params, _ = blocks
    mine = model.init_params(get_smoke(name), seed=0)
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref_params)
    assert jax.tree.map(lambda a: tuple(a.shape), mine) == shapes
    loaded = model.load_params(get_smoke(name), seed=0, device="cpu")
    for a, b in zip(_flat({k: loaded[k] for k in mine}), _flat(mine)):
        assert np.array_equal(a.numpy(), b)


def _flat(tree) -> list:
    return [leaf for k in sorted(tree) for leaf in (
        _flat(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


# --------------------------------------------------------------------------
# forward, encode, the cache and decode
# --------------------------------------------------------------------------
def test_forward_matches_reference(blocks):
    """The forward's logits: Qwen2-VL with distinct t/h/w streams and patch
    embeddings, Whisper on its encoder's frames."""
    name, cfg, ref_params, params = blocks
    inp = _inputs(cfg, 12)
    want = ref_model.forward(ref_params, cfg, **{
        k: jnp.asarray(v) for k, v in inp.items()})
    got = model.forward(params, get_smoke(name), **{
        k: _t(v) for k, v in inp.items()})
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_encode_matches_reference(blocks):
    """Whisper's encoder output; the other families have none."""
    name, cfg, ref_params, params = blocks
    if not cfg.encoder_decoder:
        assert "enc_blocks" not in params and "enc_layers" not in params
        return
    enc = _inputs(cfg, 1)["enc_input"]
    want = ref_model.encode(ref_params, cfg, jnp.asarray(enc))
    got = model.encode(params, get_smoke(name), _t(enc))
    _close(got, want)


def _both_caches(name, cfg, ref_params, params):
    """Each package's empty cache: for Whisper with its own encoder's
    memory of the same frames."""
    kw, rkw = {}, {}
    if cfg.encoder_decoder:
        enc = _inputs(cfg, 1)["enc_input"]
        rkw = dict(memory=ref_model.encode(ref_params, cfg, jnp.asarray(enc)),
                   params=ref_params)
        kw = dict(memory=model.encode(params, get_smoke(name), _t(enc)),
                  params=params)
    return (model.init_cache(get_smoke(name), BATCH, MAX_LEN, device="cpu",
                             **kw),
            ref_model.init_cache(cfg, BATCH, MAX_LEN, **rkw))


def test_init_cache_matches_reference(blocks):
    """Every field: present where the reference's is, of its shape and
    values (Whisper's cross K/V projected from the memory)."""
    name, cfg, ref_params, params = blocks
    pc, rc = _both_caches(name, cfg, ref_params, params)
    _caches_close(pc, rc)
    if cfg.encoder_decoder:
        with pytest.raises(ValueError, match="memory"):
            model.init_cache(get_smoke(name), BATCH, MAX_LEN, device="cpu")


def test_prefill_and_decode_match_reference(blocks):
    """An 8-token prefill in two chunks (5 + 3), then 6 decode steps fed
    the reference's argmax (Qwen2-VL with its position streams running on
    past the prompt): the logits and every cache field at each step."""
    name, cfg, ref_params, params = blocks
    mine = get_smoke(name)
    pc, rc = _both_caches(name, cfg, ref_params, params)
    inp = _inputs(cfg, PROMPT + STEPS, seed=9)
    feeds = [(0, 5), (5, PROMPT)] + [(t, t + 1)
                                     for t in range(PROMPT, PROMPT + STEPS)]
    tokens = inp["tokens"][:, :PROMPT]
    for lo, hi in feeds:
        kw = {}
        if cfg.mrope:
            kw = dict(positions3=inp["positions3"][:, :, lo:hi])
        want, rc = ref_model.decode_step(ref_params, cfg,
                                         jnp.asarray(tokens[:, lo:hi]), rc,
                                         **{k: jnp.asarray(v)
                                            for k, v in kw.items()})
        got, pc = model.decode_step(params, mine, _t(tokens[:, lo:hi]), pc,
                                    **{k: _t(v) for k, v in kw.items()})
        _close(got, want)
        _caches_close(pc, rc)
        nxt = np.asarray(jnp.argmax(want[:, -1, :cfg.vocab], -1))[:, None]
        tokens = np.concatenate([tokens, nxt], axis=1)


# --------------------------------------------------------------------------
# M-RoPE
# --------------------------------------------------------------------------
@pytest.mark.parametrize("sections,d_head", [((2, 3, 3), 16),
                                             ((16, 24, 24), 128)])
def test_mrope_freqs_matches_reference_and_reduces_to_rope(sections, d_head):
    """Distinct streams against the reference; three equal streams give
    RoPE's cos and sin bit for bit."""
    rng = np.random.default_rng(2)
    p3 = rng.integers(0, 4000, (2, 3, 7))
    want = ref_modules.mrope_freqs(d_head, 1e6, jnp.asarray(p3), sections)
    got = modules.mrope_freqs(d_head, 1e6, _t(p3), sections)
    for a, b in zip(got, want):
        _close(a, b)
    same = np.broadcast_to(p3[:, :1], p3.shape)
    cos, sin = modules.mrope_freqs(d_head, 1e6, _t(same), sections)
    rcos, rsin = modules.rope_freqs(d_head, 1e6, _t(p3[:, 0]))
    assert torch.equal(cos, rcos) and torch.equal(sin, rsin)


def test_attention_modules_match_reference(blocks):
    """Layer 0's ``gqa_attention`` (on M-RoPE with distinct streams for
    Qwen2-VL, ``positions3`` passed in) and Whisper's ``cross_attention``
    against an encoder memory, each against the reference's."""
    name, cfg, ref_params, params = blocks
    if cfg.block_type != "transformer":
        assert "cross_layers" not in params
        return
    inp = _inputs(cfg, 7, seed=13)
    x = (np.random.default_rng(14).standard_normal((BATCH, 7, cfg.d_model))
         * 0.5).astype(np.float32)
    pos, p3 = np.arange(7), inp.get("positions3")
    lp = jax.tree.map(lambda a: a[0], ref_params["blocks"]["attn"])
    want, _ = ref_modules.gqa_attention(
        lp, jnp.asarray(x), cfg, jnp.asarray(pos),
        positions3=None if p3 is None else jnp.asarray(p3))
    got, _ = modules.gqa_attention(params["layers"][0]["attn"], _t(x), cfg,
                                   _t(pos), positions3=None if p3 is None
                                   else _t(p3))
    _close(got, want)
    if cfg.encoder_decoder:
        mem = inp["enc_input"]
        cp = jax.tree.map(lambda a: a[0], ref_params["cross_blocks"]["attn"])
        want = ref_modules.cross_attention(cp, jnp.asarray(x),
                                           jnp.asarray(mem), cfg)
        got = modules.cross_attention(params["cross_layers"][0]["attn"],
                                      _t(x), _t(mem), cfg)
        _close(got, want)


def test_text_forward_on_equal_streams_is_rope():
    """Qwen2-VL's text-only forward with three equal position streams is
    bit-equal to the same forward on RoPE (no ``positions3``)."""
    cfg = get_smoke("qwen2_vl_72b")
    params = model.params_from_numpy(model.init_params(cfg, seed=1), "cpu")
    tokens = _t(np.random.default_rng(4).integers(0, cfg.vocab, (2, 9)))
    p3 = torch.arange(9).expand(2, 3, 9)
    assert torch.equal(model.forward(params, cfg, tokens, positions3=p3),
                       model.forward(params, cfg, tokens))


def test_patch_prefill_by_decode_step_is_the_forward():
    """Qwen2-VL: a prompt of patch embeddings on a grid at t = 0 and text
    after it, prefilled by ``decode_step`` in two chunks (the patches go
    with the first), gives the forward's logits, and decode steps with
    three equal streams past the grid match the reference's."""
    cfg = get_smoke("qwen2_vl_72b")
    ref_params = ref_model.init_params(ref_get_smoke("qwen2_vl_72b"),
                                       jax.random.PRNGKey(6))
    params = model.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                     device="cpu")
    rng = np.random.default_rng(8)
    grid, text = 3, 5
    n = grid * grid
    tokens = _t(rng.integers(0, cfg.vocab, (BATCH, n + text)))
    patches = _t((rng.standard_normal((BATCH, n, cfg.d_model)) * 0.1
                  ).astype(np.float32))
    hw = torch.arange(n)
    after = grid + torch.arange(text)
    p3 = torch.stack([torch.cat([torch.zeros(n, dtype=torch.int64), after]),
                      torch.cat([hw // grid, after]),
                      torch.cat([hw % grid, after])]).expand(BATCH, 3, -1)
    want = model.forward(params, cfg, tokens, positions3=p3,
                         extra_embeds=patches)
    cache = model.init_cache(cfg, BATCH, MAX_LEN, device="cpu")
    first, cache = model.decode_step(params, cfg, tokens[:, :n + 2], cache,
                                     positions3=p3[:, :, :n + 2],
                                     extra_embeds=patches)
    rest, cache = model.decode_step(params, cfg, tokens[:, n + 2:], cache,
                                    positions3=p3[:, :, n + 2:])
    _close(torch.cat([first, rest], 1), want)
    rc = ref_model.init_cache(ref_get_smoke("qwen2_vl_72b"), BATCH, MAX_LEN)
    rc = rc._replace(kv_k=jnp.asarray(cache.kv_k.numpy()),
                     kv_v=jnp.asarray(cache.kv_v.numpy()),
                     pos=jnp.asarray(cache.pos, jnp.int32))
    nxt = torch.argmax(rest[:, -1:, :cfg.vocab], -1)
    for step in range(2):
        pos = grid + text + step
        s3 = torch.full((BATCH, 3, 1), pos)
        got, cache = model.decode_step(params, cfg, nxt, cache,
                                       positions3=s3)
        wanted, rc = ref_model.decode_step(
            ref_params, ref_get_smoke("qwen2_vl_72b"),
            jnp.asarray(nxt.numpy()), rc, positions3=jnp.asarray(s3.numpy()))
        _close(got, wanted)
        _caches_close(cache, rc)
        nxt = torch.argmax(got[:, -1:, :cfg.vocab], -1)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def _prompts(cfg, n=4, batch=2, plen=8):
    rng = np.random.default_rng(12)
    return [rng.integers(0, cfg.vocab, (batch, plen)) for _ in range(n)]


@pytest.mark.parametrize("name", ["xlstm_350m", "zamba2_2_7b"])
@pytest.mark.parametrize("chunk,group_size", [(None, 2), (3, 3)])
def test_engine_matches_reference_runner(name, chunk, group_size):
    """``DualMeshEngine`` on the CPU against the reference's engine over
    its ``DualMeshRunner``, the same parameters: the same greedy tokens,
    fused sizes, token counts and trace (fused groups carry every cache
    field, evictions take each field's rows)."""
    cfg = ref_get_smoke(name)
    ref_params = ref_model.init_params(cfg, jax.random.PRNGKey(0))
    params = model.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                     device="cpu")
    prompts = _prompts(cfg)
    gens = [6, 4, 6, 5]
    ref = RefEngine(RefRunner(cfg, ref_params,
                              split_mesh(jax.devices()[:1], 0.5),
                              max_len=24),
                    group_size=group_size, prefill_chunk=chunk)
    mine = DualMeshEngine(DualMeshRunner(get_smoke(name), params,
                                         split_streams("cpu"), max_len=24),
                          group_size=group_size, prefill_chunk=chunk)
    for p, g in zip(prompts, gens):
        ref.submit(RefRequest(jnp.asarray(p), gen_steps=g))
        mine.submit(Request(_t(p), gen_steps=g))
    want, got = ref.drain(), mine.drain()
    assert len(got.outputs) == len(prompts)
    for a, b, g in zip(want.outputs, got.outputs, gens):
        assert tuple(b.shape) == (2, 8 + g)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for key in ("fused_sizes", "prefill_tokens", "decode_tokens",
                "total_tokens"):
        assert got.stats[key] == want.stats[key], key
    assert [t[:2] for t in got.trace] == [t[:2] for t in want.trace]


@pytest.mark.parametrize("name", SERVED)
def test_serve_lm_smoke_runs(name, capsys):
    """``serve lm --smoke`` serves each config the reference serves."""
    from repro_torch.launch.serve import main
    assert main(["lm", "--arch", name, "--smoke", "--device", "cpu",
                 "--requests", "3", "--batch", "1", "--prompt-len", "6",
                 "--gen", "4", "--prefill-chunk", "4"]) == 0
    out = capsys.readouterr().out
    assert f"lm {name}_smoke: 3 requests x batch 1" in out
    assert "decode   on p-core" in out


def test_serve_lm_refuses_whisper_in_both_packages():
    """Serving has no encoder input: the port refuses Whisper with a
    ``ValueError`` before drawing weights; the reference's cache asserts
    on the missing memory."""
    from repro.launch.serve import main as ref_main
    from repro_torch.launch.serve import main
    args = ["lm", "--arch", "whisper_small", "--smoke", "--requests", "1",
            "--batch", "1", "--prompt-len", "4", "--gen", "2"]
    with pytest.raises(ValueError, match="no encoder input"):
        main(args + ["--device", "cpu"])
    with pytest.raises(ValueError, match="no encoder input"):
        DualMeshRunner(get_smoke("whisper_small"), {}, split_streams("cpu"))
    with pytest.raises(AssertionError):
        ref_main(args)


@pytest.mark.parametrize("name", SERVED)
@pytest.mark.parametrize("batch,plen,gen,n", [(2, 512, 64, 8),
                                              (4, 2048, 256, 6)])
def test_plan_admission_matches_reference(name, batch, plen, gen, n):
    """The admission plan at the published widths: the reference's group
    size and makespan (the SSM state priced as the reference prices it)."""
    want = ref_plan_admission(ref_get_arch(name),
                              split_mesh(jax.devices()[:1], 0.5),
                              TpuModel(), batch, plen, gen, n)
    got = plan_admission(get_arch(name), split_streams("cpu", 0.5), REF_HW,
                         batch, plen, gen, n)
    assert got.group_size == want.group_size
    assert got.est_makespan == pytest.approx(want.est_makespan, rel=1e-12)


@pytest.mark.parametrize("name", SERVED)
@pytest.mark.parametrize("n_devices,traffic,n_streams", [
    (8, [(2, 512, 64)], 8), (256, [(8, 1024, 1024)] * 2, 2)])
def test_search_matches_reference_on_abstract_cards(name, n_devices,
                                                     traffic, n_streams):
    """The design flow on abstract cards: the reference's visited thetas,
    theta, TP pair, chips, makespan and tokens/s."""
    want = ref_search(ref_request_stages(ref_get_arch(name), traffic),
                      ref_get_arch(name), n_devices=n_devices, max_evals=16,
                      n_streams=n_streams)
    got = search(request_stages(get_arch(name), traffic), get_arch(name),
                 n_devices=n_devices, hw=REF_HW, max_evals=16,
                 n_streams=n_streams)
    assert got.visited == want.visited
    assert got.theta == want.theta
    assert (got.tp_c, got.tp_p) == (want.tp_c, want.tp_p)
    assert got.makespan == pytest.approx(want.makespan, rel=1e-12)
    assert got.tokens_per_s == pytest.approx(want.tokens_per_s, rel=1e-12)
    assert (got.dual.c_chips, got.dual.p_chips) == (want.dual.c_chips,
                                                    want.dual.p_chips)
