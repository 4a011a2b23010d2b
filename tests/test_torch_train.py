"""Training on the port against the reference, on the CPU.

The port's training slice (``data/pipeline.py``, ``train/``,
``lm/steps.py``, ``launch/train.py``) on ``device="cpu"``, where every
kernel wrapper takes its plain version and the differentiable K6 and K7
flash wrappers run their plain backward versions (``rmsnorm_bwd_ref``,
``flash_attention_bwd_ref``) inside their ``torch.autograd.Function``s:

- the data pipeline's batches bit-equal to the reference's;
- AdamW, SGDM and the schedule against the reference on the same
  gradients;
- the reference's optimizer, data, checkpoint, runner and recovery tests
  (``tests/test_train_substrate.py``) on the port; its ``remesh`` test is
  left out: ``remesh`` re-shards onto a TPU mesh, and one card has none;
- the backward plain versions against autograd of the plain forwards in
  float64 (tolerance 1e-10: the same function in another order), and the
  differentiable wrappers against ``jax.grad`` of the reference's
  ``rmsnorm_ref`` and ``attention_scores`` in f32 (1e-5);
- for each architecture at its smoke width, the reference's initial state
  carried over by ``train_state_from_numpy``: the loss within 1e-5
  relative and every gradient within 1e-4 of its leaf's largest magnitude
  of ``jax.value_and_grad(lm_loss)``'s (f32 on both sides, sums in
  another order), every leaf's gradient nonzero, then one AdamW step on
  the reference's gradients against the reference's (rtol 1e-5, atol
  1e-8);
- microbatches, remat, checkpoints across the packages, the ``launch()``
  guard, ``moe_aux_loss`` and the CLI;
- the inference steps of ``lm/steps.py`` on the reference's serving tests
  (``tests/test_serving.py``): the greedy tokens equal to the reference's
  on the same weights and prompt, Whisper's one step's logits within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as ref_get_smoke
from repro.data import pipeline as ref_pipeline
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.lm import model as ref_model
from repro.lm import modules as ref_modules
from repro.lm import steps as ref_steps
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_optim
from repro_torch.configs.registry import ARCH_IDS, get_smoke
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.kernels.attention.kernel import (decode_attention,
                                                  flash_attention)
from repro_torch.kernels.attention.ref import (flash_attention_bwd_ref,
                                               flash_attention_ref)
from repro_torch.kernels.rmsnorm.kernel import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
from repro_torch.kernels.util import launch
from repro_torch.launch import train as train_cli
from repro_torch.lm import modules, steps
from repro_torch.lm.model import encode, init_cache, params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import SGDM, AdamW
from repro_torch.train.runner import FaultInjector, RunnerConfig, TrainRunner
from repro_torch.train.tree import leaves

KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4          # of the leaf's largest reference magnitude
F64_TOL = dict(rtol=1e-10, atol=1e-10)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _batch(cfg, B=2, S=16, seed=0):
    """A token batch (numpy), with ``positions3`` and ``enc_input`` where
    the config needs them, as ``test_arch_smoke._batch`` builds them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.mrope:
        batch["positions3"] = np.tile(np.arange(S)[None, None],
                                      (B, 3, 1)).astype(np.int32)
    if cfg.encoder_decoder:
        batch["enc_input"] = (rng.standard_normal(
            (B, cfg.enc_positions, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def _ref_state(arch, opt=None):
    cfg = ref_get_smoke(arch)
    init = ref_steps.make_init_state(cfg, opt or ref_optim.AdamW())
    return cfg, jax.jit(init)(KEY)


def _port_state(ref_state):
    return steps.train_state_from_numpy(jax.tree.map(np.asarray, ref_state),
                                        CPU)


# --------------------------------------------------------------------------
# Data pipeline
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,host,hosts",
                         [(0, 0, 0, 1), (3, 5, 0, 2), (3, 5, 1, 2),
                          (7, 1234, 3, 4), (11, 2, 0, 1)])
def test_synthetic_batches_bit_equal_reference(seed, step, host, hosts):
    kw = dict(vocab=151936, seq_len=48, global_batch=8, seed=seed)
    got = SyntheticLM(DataConfig(**kw), host, hosts).batch_at(step)
    want = ref_pipeline.SyntheticLM(ref_pipeline.DataConfig(**kw), host,
                                    hosts).batch_at(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_matches_reference_stream():
    cfg = DataConfig(vocab=97, seq_len=8, global_batch=2, seed=4)
    ref = ref_pipeline.SyntheticLM(ref_pipeline.DataConfig(
        vocab=97, seq_len=8, global_batch=2, seed=4))
    pf = Prefetcher(SyntheticLM(cfg), start_step=3)
    try:
        for want_step in (3, 4, 5):
            s, batch = pf.next()
            assert s == want_step
            np.testing.assert_array_equal(batch["tokens"],
                                          ref.batch_at(s)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# the reference's data tests, on the port
def test_data_deterministic_and_host_sharded():
    cfg = DataConfig(vocab=97, seq_len=32, global_batch=8, seed=3)
    a = SyntheticLM(cfg).batch_at(5)
    b = SyntheticLM(cfg).batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    h0 = SyntheticLM(cfg, host_id=0, num_hosts=2).batch_at(5)
    h1 = SyntheticLM(cfg, host_id=1, num_hosts=2).batch_at(5)
    assert h0["tokens"].shape == (4, 32)
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    assert a["tokens"].min() >= 1 and a["tokens"].max() < 97


def test_labels_are_shifted_tokens():
    cfg = DataConfig(vocab=97, seq_len=16, global_batch=2)
    b = SyntheticLM(cfg).batch_at(0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


# --------------------------------------------------------------------------
# Optimizers
# --------------------------------------------------------------------------
def _grad_trees(n, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2)}}

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        return (rng.standard_normal(tree) * scale).astype(np.float32)

    return draw(shapes), [draw(shapes) for _ in range(n)]


def _to_torch(tree):
    return jax.tree.map(_t, tree)


def _assert_tree_close(port, ref, **tol):
    pl, rl = leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol)


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_matches_reference(clip):
    kw = dict(lr=0.05, weight_decay=0.1, clip_norm=clip, warmup_steps=2,
              total_steps=6)
    p0, grads = _grad_trees(5)
    ref_opt, opt = ref_optim.AdamW(**kw), AdamW(**kw)
    rp = jax.tree.map(jnp.asarray, p0)
    rs = ref_opt.init(rp)
    pp = _to_torch(p0)
    ps = opt.init(pp)
    for g in grads:
        rp, rs, rn = ref_opt.apply(jax.tree.map(jnp.asarray, g), rs, rp)
        pp, ps, pn = opt.apply(_to_torch(g), ps, pp)
        np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
        assert int(ps.step) == int(rs.step)
    _assert_tree_close(pp, rp, rtol=1e-5, atol=1e-7)
    _assert_tree_close(ps.m, rs.m, rtol=1e-5, atol=1e-7)
    _assert_tree_close(ps.v, rs.v, rtol=1e-5, atol=1e-7)


def test_sgdm_matches_reference():
    p0, grads = _grad_trees(4, seed=1)
    ref_opt, opt = ref_optim.SGDM(lr=0.01), SGDM(lr=0.01)
    rp = jax.tree.map(jnp.asarray, p0)
    rs = ref_opt.init(rp)
    pp = _to_torch(p0)
    ps = opt.init(pp)
    for g in grads:
        rp, rs, rn = ref_opt.apply(jax.tree.map(jnp.asarray, g), rs, rp)
        pp, ps, pn = opt.apply(_to_torch(g), ps, pp)
        np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
    _assert_tree_close(pp, rp, rtol=1e-5, atol=1e-7)
    _assert_tree_close(ps.mom, rs.mom, rtol=1e-5, atol=1e-7)
    assert int(ps.step) == int(rs.step) == 4


def test_schedule_matches_reference():
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    opt, ref_opt = AdamW(**kw), ref_optim.AdamW(**kw)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(opt.schedule(s)),
                                   float(ref_opt.schedule(jnp.array(s))),
                                   rtol=1e-6)
    np.testing.assert_allclose(
        float(opt.schedule(torch.tensor(7, dtype=torch.int32))),
        float(ref_opt.schedule(jnp.array(7))), rtol=1e-6)


# the reference's optimizer tests, on the port
def test_adamw_reduces_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=100)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.apply(grads, state, params)
    assert float(params["w"].abs().max()) < 0.3


def test_adamw_grad_clipping():
    opt = AdamW(lr=0.0, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    _, _, gnorm = opt.apply({"w": torch.full((3,), 100.0)}, state, params)
    assert float(gnorm) > 100  # reported pre-clip norm


def test_schedule_warmup_cosine():
    opt = AdamW(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(opt.schedule(0)) < 0.2
    assert float(opt.schedule(10)) > 0.9
    assert 0.09 < float(opt.schedule(99)) < 0.2


# --------------------------------------------------------------------------
# The backward plain versions and the differentiable wrappers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 5, 16), (7, 33), (1, 896)])
def test_rmsnorm_bwd_ref_matches_autograd_f64(shape):
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal(shape), torch.float64).requires_grad_()
    w = _t(rng.standard_normal(shape[-1]) * 0.5 + 1,
           torch.float64).requires_grad_()
    dy = _t(rng.standard_normal(shape), torch.float64)
    want = torch.autograd.grad(rmsnorm_ref(x, w, 1e-6), (x, w), dy)
    got = rmsnorm_bwd_ref(x.detach(), w.detach(), dy, 1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **F64_TOL)


def test_rmsnorm_wrapper_matches_jax_grad():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = (rng.standard_normal(24) * 0.5 + 1).astype(np.float32)
    dy = rng.standard_normal((2, 9, 24)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_rmsnorm_ref(a, b, 1e-5), x, w)
    want = vjp(dy)
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    got = torch.autograd.grad(rmsnorm(xt, wt, eps=1e-5), (xt, wt), _t(dy))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), **F32_TOL)


#: (B, Hq, Hkv, Sq, Sk, D, causal, q_offset, sk_valid)
FLASH_EDGES = [
    (2, 4, 4, 12, 12, 16, True, 0, None),       # G 1, causal
    (1, 7, 1, 9, 9, 8, True, 0, None),          # G 7
    (2, 14, 2, 70, 70, 64, True, 0, None),      # Qwen2-0.5B's heads, 2 tiles
    (1, 4, 2, 11, 11, 16, False, 0, None),      # non-causal
    (1, 4, 2, 5, 13, 16, True, 8, None),        # a chunk: q_offset > 0
    (1, 4, 2, 13, 13, 16, True, 0, 7),          # sk_valid < Sk
    (2, 6, 2, 7, 20, 16, False, 0, None),       # Sq != Sk
    (1, 2, 1, 6, 6, 80, True, 0, None),         # D 80
    (1, 2, 1, 6, 6, 128, True, 0, None),        # D 128
]


def _flash_inputs(case, dtype, seed=3):
    b, hq, hkv, sq, sk, d = case[:6]
    rng = np.random.default_rng(seed)
    return [_t(rng.standard_normal(s), dtype)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                      (b, hq, sq, d))]


@pytest.mark.parametrize(
    "case", FLASH_EDGES + [(1, 4, 2, 6, 9, 16, True, 0, 0),
                           (1, 4, 2, 6, 9, 16, False, 0, 0)],
    ids=lambda c: "-".join(str(x) for x in c))
def test_flash_bwd_ref_matches_autograd_f64(case):
    """The last two cases: sk_valid 0, so no query row sees a key (its
    output and its gradients are 0)."""
    causal, off, skv = case[6:]
    q, k, v, dout = _flash_inputs(case, torch.float64)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out, lse = flash_attention_ref(q, k, v, causal=causal, q_offset=off,
                                   sk_valid=skv, with_lse=True)
    # with no key visible the output is 0 whatever the inputs: no graph
    want = (torch.autograd.grad(out, (q, k, v), dout) if out.requires_grad
            else [torch.zeros_like(t) for t in (q, k, v)])
    got = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                  out.detach(), dout, lse.detach(),
                                  causal=causal, q_offset=off, sk_valid=skv)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **F64_TOL)
    if skv == 0:
        assert torch.isinf(lse).all() and not out.detach().any()
        assert not any(t.any() for t in got)


@pytest.mark.parametrize("case", FLASH_EDGES,
                         ids=lambda c: "-".join(str(x) for x in c))
def test_flash_wrapper_matches_jax_grad(case):
    """The wrapper (the autograd Function over the plain versions on the
    CPU) against ``jax.vjp`` of the reference's ``attention_scores`` (the
    XLA attention its training runs), where every row sees a key."""
    b, causal, off, skv = case[0], *case[6:]
    q, k, v, dout = _flash_inputs(case, torch.float32)
    kv_valid = None if skv is None else jnp.full((b,), skv, jnp.int32)
    _, vjp = jax.vjp(lambda a, bb, c: ref_modules.attention_scores(
        a, bb, c, causal, q_offset=off, kv_valid=kv_valid),
        *(jnp.asarray(_np(t)) for t in (q, k, v)))
    want = vjp(jnp.asarray(_np(dout)))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(
        flash_attention(q, k, v, causal=causal, q_offset=off, sk_valid=skv),
        (q, k, v), dout)
    for a, bb in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(bb), **F32_TOL)


def test_decode_attention_refuses_a_gradient():
    q = torch.zeros((1, 2, 1, 8), requires_grad=True)
    k = torch.zeros((1, 1, 4, 8))
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q, k, k)
    with torch.no_grad():
        decode_attention(q, k, k)


def test_launch_guard_raises_on_a_grad_requiring_operand():
    """``launch`` refuses a grad-requiring tensor where autograd records,
    before it looks for the kernels (so here, on the CPU, it raises that
    and not the build's error); without the gradient, or under
    ``no_grad``, it goes on to the build, which this machine cannot do."""
    x = torch.zeros(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        launch("repro_rmsnorm", CPU, x, x.detach(), x.detach(), 1, 4, 1e-6,
               1)
    with torch.no_grad(), pytest.raises(RuntimeError) as e:
        launch("repro_rmsnorm", CPU, x, x.detach(), x.detach(), 1, 4, 1e-6,
               1)
    assert "requires grad" not in str(e.value)


def test_moe_aux_loss_matches_reference():
    cfg = ref_get_smoke("qwen2_moe_a2_7b")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    router = (rng.standard_normal((cfg.d_model, cfg.moe_experts))
              * 0.3).astype(np.float32)
    want = ref_modules.moe_aux_loss({"router": jnp.asarray(router)},
                                    jnp.asarray(x), cfg)
    got = modules.moe_aux_loss({"router": _t(router)}, _t(x),
                               get_smoke("qwen2_moe_a2_7b"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --------------------------------------------------------------------------
# Every architecture: loss and gradients, then one optimizer step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_grads_and_step_match_reference(arch):
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    ref_opt = ref_optim.AdamW(**kw)
    rcfg, rstate = _ref_state(arch, ref_opt)
    batch = _batch(rcfg)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_steps.lm_loss(p, rcfg, jax.tree.map(jnp.asarray,
                                                          batch))))(
        rstate.params)
    state = _port_state(rstate)
    cfg = get_smoke(arch)
    loss, grads = steps.loss_and_grads(state.params, cfg,
                                       steps.batch_to(batch, CPU))
    np.testing.assert_allclose(float(loss), float(rloss), rtol=LOSS_RTOL)
    gl, rl = leaves(grads), jax.tree.leaves(rgrads)
    assert len(gl) == len(rl) == len(leaves(state.params))
    for g, r in zip(gl, rl):
        r = np.asarray(r)
        top = float(np.abs(r).max())
        assert top > 0 and bool(g.any()), "a leaf got no gradient"
        assert float(np.abs(_np(g) - r).max()) <= GRAD_SHARE * top
    # one update on the reference's gradients, in both packages
    rp, rs, rn = jax.jit(ref_opt.apply)(rgrads, rstate.opt, rstate.params)
    pp, ps, pn = AdamW(**kw).apply(_to_torch(jax.tree.map(np.asarray,
                                                          rgrads)),
                                   state.opt, state.params)
    np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
    _assert_tree_close(pp, rp, rtol=1e-5, atol=1e-8)
    _assert_tree_close(ps.m, rs.m, rtol=1e-5, atol=1e-10)
    _assert_tree_close(ps.v, rs.v, rtol=1e-5, atol=1e-14)


def _two_states(arch="qwen2_0_5b"):
    _, rstate = _ref_state(arch)
    return _port_state(rstate), _port_state(rstate)


def test_microbatches_equal_one_batch():
    cfg = get_smoke("qwen2_0_5b")
    opt = AdamW(lr=1e-3)
    batch = _batch(cfg, B=8, S=12)
    s1, s4 = _two_states()
    s1, m1 = steps.make_train_step(cfg, opt, microbatches=1)(s1, batch)
    s4, m4 = steps.make_train_step(cfg, opt, microbatches=4)(s4, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m4["grad_norm"]), rtol=1e-4)
    for a, b in zip(leaves(s1.params), leaves(s4.params)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    assert int(s1.step) == int(s4.step) == 1


def test_remat_changes_nothing():
    """Recomputing each layer in the backward pass gives the same loss
    and gradients, bit for bit (the same operations on the CPU)."""
    cfg = get_smoke("qwen2_0_5b")
    state, _ = _two_states()
    batch = steps.batch_to(_batch(cfg), CPU)
    l0, g0 = steps.loss_and_grads(state.params, cfg, batch, remat=False)
    l1, g1 = steps.loss_and_grads(state.params, cfg, batch, remat=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))


def test_views_follow_in_place_updates():
    """The optimizer updates the stacked leaves in place: the per-layer
    views of the parameter tree still read them."""
    cfg = get_smoke("qwen2_0_5b")
    state, _ = _two_states()
    train_step = steps.make_train_step(cfg, AdamW(lr=1e-2, warmup_steps=1))
    before = state.params["layers"][1]["attn"]["wq"].clone()
    state, _ = train_step(state, _batch(cfg))
    now = state.params["layers"][1]["attn"]["wq"]
    assert not torch.equal(now, before)
    assert torch.equal(now, state.params["blocks"]["attn"]["wq"][1])


# --------------------------------------------------------------------------
# Checkpoints, across the packages
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "zamba2_2_7b",
                                  "whisper_small"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch):
    _, rstate = _ref_state(arch)
    ref_ckpt.save(str(tmp_path), rstate, 7)
    assert ckpt.latest_step(str(tmp_path)) == 7
    got = ckpt.restore(str(tmp_path), steps.state_shapes(get_smoke(arch)),
                       device=CPU)
    gl, rl = leaves(got), jax.tree.leaves(rstate)
    assert len(gl) == len(rl)
    for a, b in zip(gl, rl):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # the views of the restored tree read its stacked leaves
    key = "ln" if arch == "zamba2_2_7b" else "ln1"
    assert got.params["layers"][0][key].data_ptr() == \
        got.params["blocks"][key].data_ptr()


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "whisper_small"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, arch):
    cfg = get_smoke(arch)
    state = steps.make_init_state(cfg, AdamW(), CPU)(3)
    state, _ = steps.make_train_step(cfg, AdamW(lr=1e-2, warmup_steps=1))(
        state, _batch(cfg))
    ckpt.save(str(tmp_path), state, 1)
    rcfg = ref_get_smoke(arch)
    ref = jax.eval_shape(lambda: ref_steps.make_init_state(
        rcfg, ref_optim.AdamW())(KEY))
    got = ref_ckpt.restore(str(tmp_path), ref)
    assert int(got.step) == int(got.opt.step) == 1
    for a, b in zip(jax.tree.leaves(got), leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), _np(b))


# the reference's checkpoint tests, on the port
def test_checkpoint_roundtrip(tmp_path):
    cfg = get_smoke("qwen2_0_5b")
    state = steps.make_init_state(cfg, AdamW(), CPU)(0)
    ckpt.save(str(tmp_path), state, 7)
    assert ckpt.latest_step(str(tmp_path)) == 7
    restored = ckpt.restore(str(tmp_path), steps.state_shapes(cfg),
                            device=CPU)
    for a, b in zip(leaves(state), leaves(restored)):
        assert torch.equal(a, b)


def test_checkpoint_gc_keeps_last_k(tmp_path):
    cfg = get_smoke("xlstm_350m")
    state = steps.make_init_state(cfg, AdamW(), CPU)(0)
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), state, s, keep=2)
    dirs = sorted(d.name for d in tmp_path.iterdir()
                  if d.name.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]
    assert ckpt.latest_step(str(tmp_path)) == 4


# --------------------------------------------------------------------------
# The runner (the reference's tests, on the port; remesh has no
# counterpart on one card)
# --------------------------------------------------------------------------
def _runner(cfg, path, **kw):
    rkw = {k: kw.pop(k) for k in ("ckpt_every", "max_steps") if k in kw}
    return TrainRunner(cfg, RunnerConfig(ckpt_dir=str(path), **rkw),
                       device="cpu", **kw)


def test_runner_trains_and_checkpoints(tmp_path):
    cfg = get_smoke("qwen2_0_5b")
    r = _runner(cfg, tmp_path, ckpt_every=5, max_steps=10)
    out = r.run()
    assert out["final_step"] == 10
    assert np.isfinite(out["final_loss"])
    assert ckpt.latest_step(str(tmp_path)) == 10
    losses = [m["loss"] for m in out["metrics"]]
    assert losses[-1] < losses[0]
    assert [s["step"] for s in r.saves] == [0, 5, 10]
    # the last checkpoint is the live state, bit for bit
    back = ckpt.restore(str(tmp_path), steps.state_shapes(cfg), device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                 leaves(r.state)))


def test_runner_recovers_from_injected_fault(tmp_path):
    cfg = get_smoke("qwen2_0_5b")
    r = _runner(cfg, tmp_path, ckpt_every=5, max_steps=10,
                fault_injector=FaultInjector(fail_at=(7,)))
    out = r.run()
    assert out["final_step"] == 10
    assert out["recoveries"] == 1


def test_recovery_is_bit_identical(tmp_path):
    """A job that crashes and replays reaches the same state as one that
    never crashed: on the CPU the same bits (the reference's test asks
    rtol 1e-6 of the final loss)."""
    cfg = get_smoke("xlstm_350m")
    r1 = _runner(cfg, tmp_path / "a", ckpt_every=4, max_steps=8)
    out1 = r1.run()
    r2 = _runner(cfg, tmp_path / "b", ckpt_every=4, max_steps=8,
                 fault_injector=FaultInjector(fail_at=(6,)))
    out2 = r2.run()
    assert out2["recoveries"] == 1
    np.testing.assert_allclose(out1["final_loss"], out2["final_loss"],
                               rtol=1e-6)
    assert out1["final_loss"] == out2["final_loss"]
    assert all(torch.equal(a, b) for a, b in zip(leaves(r1.state),
                                                 leaves(r2.state)))


def test_resume_continues(tmp_path):
    cfg = get_smoke("xlstm_350m")
    _runner(cfg, tmp_path, ckpt_every=3, max_steps=6).run(steps=3)
    out = _runner(cfg, tmp_path, ckpt_every=3, max_steps=6).run()
    assert out["final_step"] == 6


def test_runner_resumes_a_reference_checkpoint(tmp_path):
    """A run the reference checkpointed at step 3 goes on in the port."""
    rcfg = ref_get_smoke("qwen2_0_5b")
    ref_opt = ref_optim.AdamW(total_steps=6)
    ref = ref_steps.make_init_state(rcfg, ref_opt)(KEY)
    ref_ckpt.save(str(tmp_path), ref, 3)
    r = _runner(get_smoke("qwen2_0_5b"), tmp_path, ckpt_every=3,
                max_steps=6)
    out = r.run()
    assert out["final_step"] == 6 and len(out["metrics"]) == 3
    assert int(r.state.step) == int(r.state.opt.step) == 3


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------
def test_train_cli_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen2_0_5b", "--smoke", "--steps", "3",
            "--global-batch", "2", "--seq-len", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
            "--metrics-out", str(tmp_path / "m.json")]
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "[train] arch=qwen2_0_5b_smoke device=cpu steps=3" in out
    assert ckpt.latest_step(str(tmp_path / "ck")) == 3
    assert (tmp_path / "m.json").is_file()


def test_train_cli_needs_a_card_without_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen2_0_5b", "--smoke", "--steps", "1",
                        "--ckpt-dir", str(tmp_path)])


def test_train_state_from_numpy_keeps_every_leaf():
    _, rstate = _ref_state("zamba2_2_7b")
    state = _port_state(rstate)
    assert state.params["layers"][0]["in_proj"].data_ptr() == \
        state.params["blocks"]["in_proj"].data_ptr()
    for a, b in zip(leaves(state), jax.tree.leaves(rstate)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_gradient_reaches_leaves_through_views_made_before():
    """``params_from_numpy`` still builds its views once; a forward makes
    its own, so a gradient reaches the stacked leaves even through a tree
    whose views predate ``requires_grad``."""
    cfg = get_smoke("qwen2_0_5b")
    _, rstate = _ref_state("qwen2_0_5b")
    params = params_from_numpy(jax.tree.map(np.asarray, rstate.params), CPU)
    wq = params["blocks"]["attn"]["wq"].requires_grad_()
    loss = steps.lm_loss(params, cfg, steps.batch_to(_batch(cfg), CPU))
    (g,) = torch.autograd.grad(loss, (wq,))
    assert g.shape == wq.shape and bool(g.any())


# --------------------------------------------------------------------------
# The inference steps (the reference's tests/test_serving.py cases)
# --------------------------------------------------------------------------
def _ref_params(arch):
    cfg = ref_get_smoke(arch)
    rp = ref_model.init_params(cfg, KEY)
    return cfg, rp, params_from_numpy(jax.tree.map(np.asarray, rp), CPU)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "zamba2_2_7b",
                                  "xlstm_350m"])
def test_generate_matches_reference(arch):
    """Greedy prefill then 6 steps: the reference's checks, and the tokens
    equal to the reference's on the same weights and prompt."""
    rcfg, rp, params = _ref_params(arch)
    cfg = get_smoke(arch)
    B, P, G = 2, 8, 6
    prompt = jax.random.randint(KEY, (B, P), 0, rcfg.vocab)
    want, rc = ref_steps.make_generate(rcfg, steps=G)(
        rp, prompt, ref_model.init_cache(rcfg, B, P + G + 2))
    toks, cache = steps.make_generate(cfg, steps=G)(
        params, _t(prompt, torch.int64),
        init_cache(cfg, B, P + G + 2, device=CPU))
    assert toks.shape == (B, G)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab
    assert int(cache.pos) == int(rc.pos) == P + G
    np.testing.assert_array_equal(_np(toks), np.asarray(want))


def test_generate_deterministic():
    _, _, params = _ref_params("qwen2_0_5b")
    cfg = get_smoke("qwen2_0_5b")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 8)))
    gen = steps.make_generate(cfg, steps=5)
    a, _ = gen(params, prompt, init_cache(cfg, 1, 16, device=CPU))
    b, _ = gen(params, prompt, init_cache(cfg, 1, 16, device=CPU))
    assert torch.equal(a, b)


def test_serve_step_on_whisper_memory_matches_reference():
    """One step over the encoder's memory: the logits within 1e-4 of the
    reference's, the same greedy token, the cache one position on."""
    rcfg, rp, params = _ref_params("whisper_small")
    cfg = get_smoke("whisper_small")
    enc = jax.random.normal(KEY, (2, rcfg.enc_positions, rcfg.d_model)) * 0.1
    rcache = ref_model.init_cache(rcfg, 2, 16,
                                  memory=ref_model.encode(rp, rcfg, enc),
                                  params=rp)
    want, wnext, _ = ref_steps.make_serve_step(rcfg)(
        rp, jnp.zeros((2, 1), jnp.int32), rcache)
    memory = encode(params, cfg, _t(enc))
    cache = init_cache(cfg, 2, 16, device=CPU, memory=memory, params=params)
    logits, nxt, cache = steps.make_serve_step(cfg)(
        params, torch.zeros((2, 1), dtype=torch.int64), cache)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert int(nxt.max()) < cfg.vocab
    assert int(cache.pos) == 1
    np.testing.assert_allclose(_np(logits), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(_np(nxt), np.asarray(wnext))
