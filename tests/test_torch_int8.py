"""The port's int8 KV cache, ``grad_dtype``, the ``meta`` branches and the
two names it lacked, against the JAX reference on the CPU.

- ``quantize_kv`` bit-equal to the reference's, rounding ties included;
- the plain int8 attention (``flash_attention_int8`` and
  ``decode_attention_int8`` on CPU tensors) against the reference's
  ``attention_scores`` over an int8 cache, as a prefill over the cache and
  as a decode, at G 1, 5 and 7: within 1e-6 on every row but those a
  probability's rounding tie flips (at most 0.1% of the rows);
- ``init_cache(kv_dtype=torch.int8)``'s fields, dtypes and shapes against
  the reference's on all ten smoke configs;
- ``make_generate`` with an int8 cache on the ``qwen2_5_14b`` smoke config,
  weights carried across: the reference's tokens, and the reference's own
  >= 0.5 agreement with the f32 cache (``tests/test_serving.py``);
- ``make_train_step(grad_dtype=torch.bfloat16)`` with 2 microbatches
  against the reference's one-step update;
- the LM kernels' ``meta`` branches: the CUDA branches' outputs, no
  values, the operations counted; ``resolve_device("meta")`` only when
  asked;
- the ``Engine`` protocol on the port's three engines, and
  ``run_pipelined`` against the reference's.

The wrappers run their plain versions here (CPU tensors); the kernels are
held against those on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as REF_ARCH_IDS
from repro.configs.registry import get_smoke as ref_get_smoke
from repro.core.arch import DUAL_BASELINE as REF_DUAL, BoardModel as RefBoard
from repro.core.scheduler import build_schedule as ref_build_schedule
from repro.lm import model as ref_model
from repro.lm import modules as ref_modules
from repro.lm import steps as ref_steps
from repro.models import cnn as ref_cnn
from repro.models.zoo import get_graph as ref_get_graph
from repro.train import optimizer as ref_optim
from repro_torch.configs.registry import get_smoke
from repro_torch.core.arch import DUAL_BASELINE, BoardModel
from repro_torch.core.scheduler import build_schedule
from repro_torch.dualcore.runtime import DualCoreRunner
from repro_torch.dualmesh import DualMeshRunner, split_streams
from repro_torch.fleet.engine import build_cnn_fleet
from repro_torch.kernels.attention.kernel import (decode_attention,
                                                  decode_attention_int8,
                                                  flash_attention,
                                                  flash_attention_bwd,
                                                  flash_attention_int8)
from repro_torch.kernels.attention.plan import (int8_smem_bytes,
                                                plan_decode_int8,
                                                plan_flash_int8)
from repro_torch.kernels.attention.ref import (decode_attention_int8_ref,
                                               flash_attention_int8_ref,
                                               visible, visible_pairs)
from repro_torch.kernels.rmsnorm.kernel import rmsnorm, rmsnorm_bwd
from repro_torch.kernels.util import meta_ops, resolve_device
from repro_torch.lm import model, modules, steps
from repro_torch.models.cnn import init_params as cnn_init_params
from repro_torch.models.cnn import params_from_numpy as cnn_params
from repro_torch.models.cnn import run_pipelined
from repro_torch.models.zoo import get_graph
from repro_torch.serving.api import Engine
from repro_torch.serving.cnn import DualCoreEngine
from repro_torch.serving.lm import DualMeshEngine
from repro_torch.train.optimizer import AdamW
from repro_torch.train.tree import leaves

KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
TOL = 1e-6                  # f32 division's last bit, no tie flipped
FLIP_SHARE = 1e-3           # rows a tie may flip, at most
TIE = 1e-4                  # p * 127 this close to a half is a tie


def _t(a):
    return torch.from_numpy(np.array(a))


def _int8(rng, shape):
    return np.clip(np.round(rng.standard_normal(shape) * 32), -127,
                   127).astype(np.int8)


# --------------------------------------------------------------------------
# quantize_kv and the plain int8 attention
# --------------------------------------------------------------------------
def test_quantize_kv_bit_equal_with_ties():
    rng = np.random.default_rng(0)
    ties = (np.arange(-300, 300) + 0.5) / modules.KV_SCALE   # x * 32 on .5
    x = np.concatenate([rng.standard_normal(4096) * 3, ties, [0.0, -0.0,
                        1e6, -1e6, 3.96875, -3.96875, 3.984375]]
                       ).astype(np.float32)
    want = np.asarray(ref_modules.quantize_kv(jnp.asarray(x)))
    got = modules.quantize_kv(_t(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (modules.KV_SCALE, modules.Q_SCALE, modules.P_SCALE) == (
        ref_modules.KV_SCALE, ref_modules.Q_SCALE, ref_modules.P_SCALE)


def _check_rows(got, want, p127):
    """Every row within TOL but those a tie in p * 127 touches, and those
    at most FLIP_SHARE of the rows, each off by no more than its ties'
    value rows could move it."""
    err = np.abs(got - want).max(axis=-1)                    # (B, H, Sq)
    frac = np.abs(p127 - np.floor(p127) - 0.5)
    ties = (frac < TIE).sum(axis=-1)                         # (B, H, Sq)
    bad = err > TOL
    assert not (bad & (ties == 0)).any(), float(err.max())
    assert bad.sum() <= FLIP_SHARE * bad.size
    return int(bad.sum())


@pytest.mark.parametrize("g,d", [(1, 64), (5, 128), (7, 64)])
def test_int8_attention_matches_reference(g, d):
    """A chunk of 24 query rows at q_offset 16 over a 40-row int8 cache
    (the reference's ``kv_valid`` = the chunk's end), and the decode of
    one row a head at ragged ``kv_len``, through the wrappers on the
    CPU."""
    rng = np.random.default_rng(g)
    b, hkv, sq, sk = 2, 2, 24, 40
    hq, off = g * hkv, sk - 24
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k, v = _int8(rng, (b, hkv, sk, d)), _int8(rng, (b, hkv, sk, d))
    want = np.asarray(ref_modules.attention_scores(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=off, kv_valid=jnp.full((b,), sk, jnp.int32)))
    got = flash_attention_int8(_t(q), _t(k), _t(v), causal=True,
                               q_offset=off)
    assert got.dtype == torch.float32 and got.shape == q.shape
    _, p127 = flash_attention_int8_ref(_t(q), _t(k), _t(v), causal=True,
                                       q_offset=off, with_probs=True)
    _check_rows(got.numpy(), want, p127.numpy())

    lens = np.array([sk, 17], np.int32)
    qd = q[:, :, :1]
    want = np.asarray(ref_modules.attention_scores(
        jnp.asarray(qd), jnp.asarray(k), jnp.asarray(v), causal=False,
        kv_valid=jnp.asarray(lens)))
    got = decode_attention_int8(_t(qd), _t(k), _t(v), _t(lens))
    _, p127 = decode_attention_int8_ref(_t(qd), _t(k), _t(v), _t(lens),
                                        with_probs=True)
    _check_rows(got.numpy(), want, p127.numpy())


def test_int8_attention_edges():
    """A row that sees one key is that key's value row, to the scales; a
    row that sees none is 0; a cache cut to its prefix reads the same as
    a copy of the prefix; q requiring grad is refused."""
    rng = np.random.default_rng(3)
    q = _t(rng.standard_normal((1, 2, 1, 16)).astype(np.float32))
    k, v = _t(_int8(rng, (1, 1, 8, 16))), _t(_int8(rng, (1, 1, 8, 16)))
    one = decode_attention_int8(q, k, v, torch.tensor([1], dtype=torch.int32))
    np.testing.assert_array_equal(
        one.numpy(), np.broadcast_to(
            v[:, :, :1].numpy().astype(np.float32) * 127 / np.float32(4064),
            one.shape))
    none = decode_attention_int8(q, k, v, torch.tensor([0],
                                                       dtype=torch.int32))
    assert not none.any()
    cut = flash_attention_int8(q.expand(1, 2, 3, 16).contiguous(),
                               k[:, :, :5], v[:, :, :5], q_offset=2)
    copy = flash_attention_int8(q.expand(1, 2, 3, 16).contiguous(),
                                k[:, :, :5].clone(), v[:, :, :5].clone(),
                                q_offset=2)
    assert torch.equal(cut, copy)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention_int8(q.clone().requires_grad_(), k, v)


def test_int8_plans_and_limits():
    """The plans' rows, clusters and shared memory; D outside the
    kernel's limits is refused."""
    p = plan_flash_int8(2, 40, 8, 512, 512, 128)
    assert (p.rows, p.cluster, p.tiles) == (64, 1, 40)
    assert p.smem_bytes == int8_smem_bytes(64, 128, 1)
    d = plan_decode_int8(2, 40, 8, 576, 128)
    assert (d.rows, d.tiles) == (16, 1) and 1 < d.cluster <= 9
    assert d.smem_bytes == int8_smem_bytes(16, 128, d.cluster)
    assert plan_decode_int8(2, 14, 2, 576, 64).rows == 16
    assert plan_decode_int8(1, 48, 1, 576, 128).rows == 64
    for bad in (72, 8, 144):
        with pytest.raises(ValueError, match="multiple of 16"):
            plan_flash_int8(1, 2, 1, 4, 4, bad)


def test_visible_pairs_counts_the_mask():
    for sq, sk, causal, off, skv in [(7, 7, True, 0, None),
                                     (3, 10, True, 7, None),
                                     (5, 9, True, 2, 6), (4, 6, False, 0, 3),
                                     (1, 30, True, 29, None),
                                     (8, 8, True, 0, 0)]:
        want = int(visible(sq, sk, causal, off, skv, "cpu").sum())
        assert visible_pairs(sq, sk, causal, off, skv) == want


# --------------------------------------------------------------------------
# the int8 cache in the model
# --------------------------------------------------------------------------
def _ref_params(cfg):
    return ref_model.init_params(cfg, KEY)


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_init_cache_int8_fields_match_reference(arch):
    rcfg, cfg = ref_get_smoke(arch), get_smoke(arch)
    memory = rparams = params = None
    if rcfg.encoder_decoder:
        rparams = _ref_params(rcfg)
        memory = np.zeros((2, rcfg.enc_positions, rcfg.d_model), np.float32)
        params = model.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                         "cpu")
    want = ref_model.init_cache(
        rcfg, 2, 12, memory=None if memory is None else jnp.asarray(memory),
        params=rparams, kv_dtype=jnp.int8)
    got = model.init_cache(cfg, 2, 12, "cpu",
                           memory=None if memory is None else _t(memory),
                           params=params, kv_dtype=torch.int8)
    for f in model.ROW_FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is None:
            continue
        assert tuple(g.shape) == w.shape, f
        assert g.dtype == (torch.int8 if w.dtype == jnp.int8
                           else torch.float32), f


def test_generate_int8_matches_reference():
    """Greedy decode over an int8 cache: the reference's tokens, and the
    reference's own test's criterion against the f32 cache."""
    rcfg, cfg = ref_get_smoke("qwen2_5_14b"), get_smoke("qwen2_5_14b")
    rparams = _ref_params(rcfg)
    params = model.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                     "cpu")
    prompt = np.asarray(jax.random.randint(KEY, (2, 8), 0, rcfg.vocab))
    want, rcache = ref_steps.make_generate(rcfg, 8)(
        rparams, jnp.asarray(prompt),
        ref_model.init_cache(rcfg, 2, 24, kv_dtype=jnp.int8))
    gen = steps.make_generate(cfg, 8)
    got, cache = gen(params, _t(prompt).long(),
                     model.init_cache(cfg, 2, 24, "cpu",
                                      kv_dtype=torch.int8))
    f32, _ = gen(params, _t(prompt).long(), model.init_cache(cfg, 2, 24,
                                                             "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cache.kv_k.dtype == torch.int8
    np.testing.assert_array_equal(cache.kv_v.numpy(), np.asarray(rcache.kv_v))
    assert float((got == f32).float().mean()) >= 0.5


# --------------------------------------------------------------------------
# grad_dtype
# --------------------------------------------------------------------------
def test_grad_dtype_bf16_matches_reference_step():
    """Two microbatches accumulated in bf16 (the optimizer gets bf16
    gradients): the loss to f32's 1e-5, the gradient norm to bf16's step
    (2^-8), each first moment within 2^-8 of its leaf's largest (a sum of
    two bf16 terms that nearly cancel keeps only their rounding), the
    parameters within lr / 100 (AdamW's first step is about lr sign(g))."""
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    rcfg, cfg = ref_get_smoke("qwen2_0_5b"), get_smoke("qwen2_0_5b")
    rstate = jax.jit(ref_steps.make_init_state(rcfg, ref_optim.AdamW(**kw)))(
        KEY)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, rcfg.vocab, (4, 12)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    rnew, rmet = jax.jit(ref_steps.make_train_step(
        rcfg, ref_optim.AdamW(**kw), microbatches=2,
        grad_dtype=jnp.bfloat16))(rstate, jax.tree.map(jnp.asarray, batch))
    state = steps.train_state_from_numpy(jax.tree.map(np.asarray, rstate),
                                         CPU)
    seen = []

    class Spy(AdamW):
        def apply(self, grads, opt_state, params):
            seen.extend({g.dtype for g in leaves(grads)})
            return super().apply(grads, opt_state, params)

    new, met = steps.make_train_step(cfg, Spy(**kw), microbatches=2,
                                     grad_dtype=torch.bfloat16)(state, batch)
    assert seen == [torch.bfloat16]
    np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=2 ** -8)
    for a, r in zip(leaves(new.opt.m), jax.tree.leaves(rnew.opt.m)):
        r = np.asarray(r)
        assert np.abs(a.numpy() - r).max() <= 2 ** -8 * np.abs(r).max()
    for a, r in zip(leaves(new.params), jax.tree.leaves(rnew.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=kw["lr"] / 100)


# --------------------------------------------------------------------------
# the meta branches
# --------------------------------------------------------------------------
def test_meta_branches_allocate_outputs_and_count():
    meta = resolve_device("meta")
    b, hq, hkv, sq, sk, d = 2, 6, 2, 5, 9, 16
    q = torch.empty((b, hq, sq, d), device=meta)
    k = torch.empty((b, hkv, sk, d), device=meta)
    k8 = torch.empty((b, hkv, sk, d), dtype=torch.int8, device=meta)
    x = torch.empty((7, d), device=meta)
    w = torch.empty((d,), device=meta)
    pairs = visible_pairs(sq, sk, True, 4, None)
    with meta_ops() as ops:
        out = flash_attention(q, k, k, q_offset=4)
        dq, dk, dv = flash_attention_bwd(q, k, k, q, q,
                                         torch.empty((b, hq, sq),
                                                     device=meta),
                                         q_offset=4)
        dec = decode_attention(q[:, :, :1], k, k)
        f8 = flash_attention_int8(q, k8, k8, q_offset=4)
        d8 = decode_attention_int8(q[:, :, :1], k8, k8)
        y = rmsnorm(x, w)
        dx, dw = rmsnorm_bwd(x, w, x)
    for t in (out, dq, dec, f8, d8, y, dx, dw, dk, dv):
        assert t.device.type == "meta" and t.dtype == torch.float32
    assert (out.shape, dk.shape, dec.shape, f8.shape, d8.shape) == (
        q.shape, k.shape, (b, hq, 1, d), q.shape, (b, hq, 1, d))
    assert ops.by_kernel == {
        "flash_attention": 4 * d * b * hq * pairs,
        "flash_attention_bwd": 10 * d * b * hq * pairs,
        "decode_attention": 4 * hq * d * b * sk,
        "flash_attention_int8": 4 * d * b * hq * pairs,
        "decode_attention_int8": 4 * hq * d * b * sk,
        "rmsnorm": 4 * 7 * d, "rmsnorm_bwd": 11 * 7 * d}
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xla")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")


# --------------------------------------------------------------------------
# Engine and run_pipelined
# --------------------------------------------------------------------------
def test_engines_satisfy_the_engine_protocol():
    graph = get_graph("squeezenet")
    params = cnn_params(cnn_init_params(graph, 0), "cpu")
    sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), "balanced")
    cnn = DualCoreEngine(DualCoreRunner("squeezenet", params, sched,
                                        device="cpu"))
    cfg = get_smoke("qwen2_0_5b")
    lm = DualMeshEngine(DualMeshRunner(
        cfg, model.params_from_numpy(model.init_params(cfg), "cpu"),
        split_streams("cpu"), max_len=16))
    fleet, _ = build_cnn_fleet(["squeezenet"], device="cpu")
    for eng in (cnn, lm, fleet):
        assert isinstance(eng, Engine)
    assert not isinstance(object(), Engine)


def test_run_pipelined_matches_reference():
    graph = get_graph("squeezenet")
    np_params = cnn_init_params(graph, 0)
    sched = build_schedule(graph, DUAL_BASELINE, BoardModel(), "balanced")
    ref_sched = ref_build_schedule(ref_get_graph("squeezenet"), REF_DUAL,
                                   RefBoard(), "balanced")
    rng = np.random.default_rng(5)
    images = [rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
              for _ in range(3)]
    record = []
    got = run_pipelined("squeezenet", cnn_params(np_params, "cpu"), sched,
                        [_t(x) for x in images], device="cpu",
                        record=record)
    ref_record = []
    want = ref_cnn.run_pipelined(
        "squeezenet", jax.tree.map(jnp.asarray, np_params), ref_sched,
        [jnp.asarray(x) for x in images], use_pallas=False,
        record=ref_record)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-3)
    assert [r[:3] for r in record] == [r[:3] for r in ref_record]
