"""The port's LM slice against the reference, on the CPU.

K6 (RMSNorm) and K7 (flash and decode attention): each plain version
against the reference's Pallas kernel in interpret mode, on the same numpy
inputs, at the reference's own f32 shapes and tolerances
(``tests/test_kernels.py``: 3e-4 for RMSNorm, 2e-4 for attention; both
sides are f32 and only the order of the sums differs).  Then the modules,
``decode_step`` and the ``DualMeshEngine`` against the reference's, on
``get_smoke("qwen2_0_5b")`` (2 layers, d 112, 14/2 heads, d_head 8) with
the reference's own ``init_params`` carried over as numpy: logits at
1e-4 (f32 through two layers, only the summation order differs), generated
tokens equal.  The port runs on ``device="cpu"``, where every kernel
wrapper takes its plain version and counts no launch.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.configs.registry import get_smoke as ref_get_smoke
from repro.configs import registry as ref_registry
from repro.dualmesh import DualMeshRunner as RefRunner
from repro.dualmesh import TpuModel
from repro.dualmesh import cost as ref_cost
from repro.dualmesh import plan_admission as ref_plan_admission
from repro.dualmesh import split_mesh
from repro.kernels.attention.kernel import \
    decode_attention as ref_decode_attention
from repro.kernels.attention.kernel import \
    flash_attention as ref_flash_attention
from repro.kernels.attention.ref import attention_ref as ref_attention_ref
from repro.kernels.rmsnorm.kernel import rmsnorm as ref_rmsnorm
from repro.lm import model as ref_model
from repro.lm import modules as ref_modules
from repro.serving import DualMeshEngine as RefEngine
from repro.serving import Request as RefRequest
from repro.serving import api as ref_api
from repro_torch.configs.registry import ARCH_IDS, get_arch, get_smoke
from repro_torch.dualmesh.cost import CardModel, decode_cost, prefill_cost
from repro_torch.dualmesh.partition import split_streams
from repro_torch.dualmesh.runtime import DualMeshRunner
from repro_torch.dualmesh.schedule import plan_admission, wave_makespan
from repro_torch.kernels.attention.kernel import (decode_attention,
                                                  flash_attention)
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.kernels.rmsnorm.kernel import rmsnorm
from repro_torch.kernels.util import resolve_device
from repro_torch.lm import model
from repro_torch.lm import modules
from repro_torch.serving import api
from repro_torch.serving.api import QueueFull, Request
from repro_torch.serving.lm import DualMeshEngine

ARCH = "qwen2_0_5b"
# the other registered dense configs
DENSE = ("qwen2_5_14b", "granite_20b", "command_r_plus_104b")
RMS_TOL = dict(rtol=3e-4, atol=3e-4)
ATTN_TOL = dict(rtol=2e-4, atol=2e-4)
LM_TOL = dict(rtol=1e-4, atol=1e-4)
# the reference's constants and its bf16 element, handed to the port's card
# model
REF_HW = CardModel(peak_flops=197e12, mem_bw=819e9, link_bw=50e9,
                   mfu_ceiling=0.6, bw_ceiling=0.8, step_floor_base=25e-6,
                   step_floor_tp=8e-6, step_floor_dp=2e-6, elem_bytes=2,
                   mem_bytes=16 * 1024 ** 3)
# the registered MoE configs
MOE = ("qwen2_moe_a2_7b", "granite_moe_3b_a800m")
# the SSM, hybrid, encoder-decoder and M-RoPE architectures (their parity
# with the reference is tests/test_torch_blocks.py's)
BLOCKS = ("xlstm_350m", "zamba2_2_7b", "whisper_small", "qwen2_vl_72b")


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def smoke():
    """The smoke config, the reference's parameters, and the same
    parameters carried over to the port."""
    cfg = ref_get_smoke(ARCH)
    ref_params = ref_model.init_params(cfg, jax.random.PRNGKey(0))
    params = model.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                     device="cpu")
    return cfg, ref_params, params


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
def test_configs_match_reference():
    for mine, ref in ((get_arch(ARCH), ref_get_arch(ARCH)),
                      (get_smoke(ARCH), ref_get_smoke(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.padded_vocab == ref.padded_vocab
        assert mine.param_count() == ref.param_count()
    assert get_arch(ARCH).padded_vocab == 153600


def test_registry_refuses_an_architecture_the_port_lacks():
    """The registry lists the reference's ten architectures and refuses
    any other name, naming the ones it has."""
    with pytest.raises(KeyError, match="qwen2_0_5b"):
        get_arch("no_such_arch")
    assert ARCH_IDS == ref_registry.ARCH_IDS
    assert sorted(ARCH_IDS) == sorted((ARCH, *DENSE, *MOE, *BLOCKS))


@pytest.mark.parametrize("name", DENSE)
def test_dense_configs_match_reference(name):
    """Qwen2.5-14B, Granite-20B and Command R+ at ``full()`` and
    ``smoke()``: the reference's fields, padded vocabulary and parameter
    count."""
    for mine, ref in ((get_arch(name), ref_get_arch(name)),
                      (get_smoke(name), ref_get_smoke(name))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.padded_vocab == ref.padded_vocab
        assert mine.param_count() == ref.param_count()
        model.check_supported(mine)


@pytest.mark.parametrize("name", DENSE)
def test_dense_smoke_forward_and_decode_match_reference(name):
    """Each other dense config at its smoke width, the reference's
    parameters carried over as numpy: the forward's logits, then an
    8-token prefill and 3 decode steps fed the reference's argmax, at
    1e-4."""
    cfg = ref_get_smoke(name)
    ref_params = ref_model.init_params(cfg, jax.random.PRNGKey(1))
    params = model.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                     device="cpu")
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (2, 8))
    want = ref_model.forward(ref_params, cfg, jnp.asarray(tokens))
    got = model.forward(params, get_smoke(name), _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)
    rc = ref_model.init_cache(cfg, 2, 16)
    pc = model.init_cache(get_smoke(name), 2, 16, device="cpu")
    feed = tokens
    for _ in range(4):
        want, rc = ref_model.decode_step(ref_params, cfg, jnp.asarray(feed),
                                         rc)
        got, pc = model.decode_step(params, get_smoke(name), _t(feed), pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)
        feed = np.asarray(jnp.argmax(want[:, -1, :cfg.vocab], -1))[:, None]


def test_init_params_has_the_reference_shapes(smoke):
    cfg, ref_params, _ = smoke
    mine = model.init_params(cfg, seed=0)
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref_params)
    assert jax.tree.map(lambda a: tuple(a.shape), mine) == shapes
    assert abs(float(mine["embed"].std()) - model.INIT_SCALE) < 1e-3
    again = model.init_params(cfg, seed=0)
    assert np.array_equal(again["lm_head"], mine["lm_head"])
    ssm = ref_get_smoke("xlstm_350m")
    ref_ssm = ref_model.init_params(ssm, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: tuple(a.shape), model.init_params(ssm)) \
        == jax.tree.map(lambda a: tuple(a.shape), ref_ssm)
    assert model.init_params(ssm)["blocks"]["wq"].shape == (
        ssm.n_layers, ssm.d_model, ssm.d_inner)


@pytest.mark.parametrize("name", BLOCKS)
def test_check_supported_refuses_the_blocks_the_port_lacks(name):
    """SSM, hybrid, encoder-decoder and M-RoPE: accepted, and the registry
    lists them; a block type the reference has not is refused."""
    model.check_supported(ref_get_smoke(name))
    assert name in ARCH_IDS
    with pytest.raises(NotImplementedError, match="not an architecture"):
        model.check_supported(dataclasses.replace(ref_get_smoke(name),
                                                  block_type="slstm"))


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", MOE)
def test_moe_configs_match_reference(name):
    """Qwen-MoE and Granite-MoE at ``full()`` and ``smoke()``: the
    reference's fields, padded vocabulary and parameter counts, total and
    active."""
    for mine, ref in ((get_arch(name), ref_get_arch(name)),
                      (get_smoke(name), ref_get_smoke(name))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.padded_vocab == ref.padded_vocab
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()
        model.check_supported(mine)
    assert get_arch("granite_moe_3b_a800m").padded_vocab == 51200


@pytest.fixture(scope="module", params=MOE)
def moe_smoke(request):
    """A MoE smoke config, the reference's parameters, and the same
    parameters carried over to the port."""
    cfg = ref_get_smoke(request.param)
    ref_params = ref_model.init_params(cfg, jax.random.PRNGKey(1))
    params = model.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                     device="cpu")
    return cfg, ref_params, params


@pytest.mark.parametrize("branch", ["dense", "scatter", "scatter_drop"])
def test_moe_block_matches_reference(moe_smoke, branch):
    """Layer 0's MoE block on 2 x 32 tokens: the dense branch (t <= the
    threshold), the scatter branch (threshold lowered), and the scatter
    branch with a capacity that drops tokens (capacity factor 0.2: 8
    slots an expert for 16 routed on average)."""
    cfg, ref_params, params = moe_smoke
    kw = {"dense": {}, "scatter": dict(moe_dense_threshold=4),
          "scatter_drop": dict(moe_dense_threshold=4,
                               moe_capacity_factor=0.2)}[branch]
    cfg = dataclasses.replace(cfg, **kw)
    x, = _arrays(21, (2, 32, cfg.d_model))
    lp = jax.tree.map(lambda a: a[0], ref_params["blocks"]["mlp"])
    if branch == "scatter_drop":
        # some token lost its place in an expert, so the drop is exercised
        logits = jnp.einsum("td,de->te", jnp.asarray(x).reshape(64, -1),
                            lp["router"])
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.moe_top_k)
        assert np.bincount(np.asarray(idx).ravel()).max() > 8
    want = ref_modules.moe_block(lp, jnp.asarray(x), cfg)
    got = modules.moe_block(params["layers"][0]["mlp"], _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)


def test_moe_forward_and_decode_match_reference(moe_smoke):
    """Each MoE config at its smoke width, the reference's parameters
    carried over as numpy: the forward's logits, then an 8-token prefill
    and 3 decode steps fed the reference's argmax, at 1e-4."""
    cfg, ref_params, params = moe_smoke
    mine = get_smoke(cfg.name.removesuffix("_smoke"))
    tokens = np.random.default_rng(13).integers(0, cfg.vocab, (2, 8))
    want = ref_model.forward(ref_params, cfg, jnp.asarray(tokens))
    got = model.forward(params, mine, _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)
    rc = ref_model.init_cache(cfg, 2, 16)
    pc = model.init_cache(mine, 2, 16, device="cpu")
    feed = tokens
    for _ in range(4):
        want, rc = ref_model.decode_step(ref_params, cfg, jnp.asarray(feed),
                                         rc)
        got, pc = model.decode_step(params, mine, _t(feed), pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)
        feed = np.asarray(jnp.argmax(want[:, -1, :cfg.vocab], -1))[:, None]


def test_moe_engine_matches_reference(moe_smoke):
    """The MoE model through ``DualMeshEngine`` (chunked prefills on the
    scatter branch, fused decode on the dense one) against the
    reference's engine: the same tokens, fused sizes and trace."""
    cfg, ref_params, params = moe_smoke
    cfg = dataclasses.replace(cfg, moe_dense_threshold=4)
    prompts = _prompts(cfg, n=3)
    ref = RefEngine(RefRunner(cfg, ref_params,
                              split_mesh(jax.devices()[:1], 0.5),
                              max_len=24), group_size=2, prefill_chunk=4)
    mine = DualMeshEngine(DualMeshRunner(cfg, params, split_streams("cpu"),
                                         max_len=24),
                          group_size=2, prefill_chunk=4)
    for p in prompts:
        ref.submit(RefRequest(jnp.asarray(p), gen_steps=5))
        mine.submit(Request(_t(p), gen_steps=5))
    want, got = ref.drain(), mine.drain()
    for a, b in zip(want.outputs, got.outputs):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert got.stats["fused_sizes"] == want.stats["fused_sizes"]
    assert [t[:2] for t in got.trace] == [t[:2] for t in want.trace]


@pytest.mark.parametrize("name", MOE)
def test_moe_init_params_has_the_reference_shapes(name):
    """The port's seeded MoE leaves in the reference's shapes: ``router``
    (L, d, e), ``wg``/``wu`` (L, e, d, f), ``wd`` (L, e, f, d) and the
    shared experts with a leading s axis."""
    cfg = ref_get_smoke(name)
    ref = jax.eval_shape(lambda: ref_model.init_params(
        cfg, jax.random.PRNGKey(0)))
    mine = model.init_params(get_smoke(name), seed=0)
    assert jax.tree.map(lambda a: tuple(a.shape), mine) == \
        jax.tree.map(lambda a: tuple(a.shape), ref)
    mlp = mine["blocks"]["mlp"]
    L, d, f, e = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.moe_experts
    assert mlp["router"].shape == (L, d, e)
    assert mlp["wd"].shape == (L, e, f, d)
    assert ("shared" in mlp) == bool(cfg.moe_shared)


@pytest.mark.parametrize("name", (ARCH, *MOE))
def test_load_params_is_bit_equal_to_init_params(name, monkeypatch):
    """The leaf-by-leaf loader gives ``params_from_numpy(init_params())``
    bit for bit, with chunks small enough that leaves span several, and
    the draws do not depend on the number of host threads."""
    monkeypatch.setattr(model, "DRAW_CHUNK", 1000)
    cfg = get_smoke(name)
    want = model.params_from_numpy(model.init_params(cfg, seed=5), "cpu")
    got = model.load_params(cfg, seed=5, device="cpu")
    keys = ("embed", "final_norm", "blocks", "lm_head")
    a = jax.tree.leaves({k: want[k] for k in keys})
    b = jax.tree.leaves({k: got[k] for k in keys})
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert len(got["layers"]) == cfg.n_layers
    assert got["layers"][1]["mlp"]["wg"].data_ptr() == \
        got["blocks"]["mlp"]["wg"][1].data_ptr()
    monkeypatch.setattr(model.os, "sched_getaffinity", lambda pid: {0})
    one = model.init_params(cfg, seed=5)
    assert np.array_equal(one["lm_head"], want["lm_head"].numpy())
    assert not np.array_equal(model.init_params(cfg, seed=6)["lm_head"],
                              one["lm_head"])


# --------------------------------------------------------------------------
# K6
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 256), (2, 16, 896), (1, 1, 12288),
                                   (3, 7, 1024), (16, 896)])
def test_k6_plain_matches_pallas(shape):
    x, w = _arrays(1, shape, shape[-1:])
    x *= 2.0
    want = ref_rmsnorm(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = rmsnorm(_t(x), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RMS_TOL)


# --------------------------------------------------------------------------
# K7
# --------------------------------------------------------------------------
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (2, 8, 2, 64, 64, 32, True),      # GQA
    (1, 4, 4, 128, 128, 64, True),    # MHA
    (2, 6, 1, 1, 256, 64, False),     # MQA decode shape
    (1, 14, 2, 37, 37, 64, True),     # qwen2-0.5b heads (non-pow2)
    (1, 2, 2, 8, 200, 128, False),    # cross-attn shape (sq != sk)
    (1, 4, 2, 8, 24, 32, True),       # causal, sq < sk: query 0 at key 0
    (2, 14, 2, 130, 130, 64, True),   # qwen2-0.5b heads across tile edges
    (1, 48, 1, 40, 40, 128, True),    # granite-20b's MQA group, D 128
])
def test_k7_plain_flash_matches_pallas(b, hq, hkv, sq, sk, d, causal):
    q, k, v = _arrays(2, (b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                      scale=0.5)
    want = ref_flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=32,
                               block_k=32, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, q_offset=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (1, 4, 2, 8, 24, 32), (2, 14, 2, 37, 100, 8), (1, 14, 2, 64, 64, 64)])
def test_k7_plain_flash_at_the_bottom_right_matches_attention_ref(
        b, hq, hkv, sq, sk, d):
    """At ``q_offset = Sk - Sq`` the flash kernel's plain version is the
    reference's oracle (and its LM modules' chunked prefill); at
    ``q_offset = 0`` it is the Pallas kernel, which differs when Sq < Sk."""
    q, k, v = _arrays(3, (b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                      scale=0.5)
    want = np.asarray(ref_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True))
    got = flash_attention(_t(q), _t(k), _t(v), causal=True,
                          q_offset=sk - sq)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    np.testing.assert_allclose(
        attention_ref(_t(q), _t(k), _t(v), causal=True).numpy(), want,
        **ATTN_TOL)
    if sq < sk:
        top_left = flash_attention(_t(q), _t(k), _t(v), causal=True)
        assert np.abs(top_left.numpy() - want).max() > 0.1


def test_k7_plain_flash_masks_keys_past_sk_valid():
    q, k, v = _arrays(4, (2, 6, 9, 16), (2, 3, 40, 16), (2, 3, 40, 16))
    got = flash_attention(_t(q), _t(k), _t(v), causal=False, sk_valid=23)
    want = ref_attention_ref(jnp.asarray(q), jnp.asarray(k[:, :, :23]),
                             jnp.asarray(v[:, :, :23]), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    # a cache cut along the sequence axis reads in place, as a copy would
    cut = flash_attention(_t(q), _t(k)[:, :, :30], _t(v)[:, :, :30],
                          causal=True, q_offset=21)
    copy = flash_attention(_t(q), _t(k)[:, :, :30].contiguous(),
                           _t(v)[:, :, :30].contiguous(), causal=True,
                           q_offset=21)
    assert torch.equal(cut, copy)


@pytest.mark.parametrize("ragged", [False, True])
def test_k7_plain_decode_matches_reference(ragged):
    q, k, v = _arrays(5, (3, 14, 1, 64), (3, 2, 80, 64), (3, 2, 80, 64),
                      scale=0.5)
    lens = np.array([80, 17, 61], np.int32) if ragged else None
    want = ref_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if lens is None else jnp.asarray(lens), interpret=True)
    got = decode_attention(_t(q), _t(k), _t(v),
                           None if lens is None else _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("g,hkv,ragged", [(48, 1, False), (48, 1, True),
                                          (12, 2, False), (12, 2, True)])
def test_k7_plain_decode_matches_reference_at_wide_groups(g, hkv, ragged):
    """Granite-20B's group (48 query heads on 1 kv head) and Command R+'s
    (12), D = 128, whole and ragged (down to kv_len 0 and 1): the plain
    decode against the reference's ``decode_attention`` (its flash kernel
    in interpret mode, or its jnp ragged path)."""
    q, k, v = _arrays(13, (4, g * hkv, 1, 128), (4, hkv, 70, 128),
                      (4, hkv, 70, 128), scale=0.5)
    lens = np.array([70, 0, 1, 33], np.int32) if ragged else None
    want = np.array(ref_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if lens is None else jnp.asarray(lens), interpret=True))
    if ragged:
        want[1] = 0.0      # no visible key: the port writes 0 (the
        #                    reference's ragged path averages every key)
    got = decode_attention(_t(q), _t(k), _t(v),
                           None if lens is None else _t(lens))
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


def test_wrappers_count_no_launch_on_cpu():
    before = (rmsnorm.launches, flash_attention.launches,
              decode_attention.launches)
    x, w = _arrays(6, (3, 8), (8,))
    rmsnorm(_t(x), _t(w))
    q, k = _arrays(6, (1, 2, 1, 8), (1, 1, 5, 8))
    flash_attention(_t(q), _t(k), _t(k))
    decode_attention(_t(q), _t(k), _t(k))
    assert (rmsnorm.launches, flash_attention.launches,
            decode_attention.launches) == before


# --------------------------------------------------------------------------
# modules and model
# --------------------------------------------------------------------------
def test_apply_rope_matches_reference():
    (x,) = _arrays(7, (2, 3, 11, 8))
    pos = np.arange(5, 16)
    cos, sin = ref_modules.rope_freqs(8, 1e6, jnp.asarray(pos))
    want = ref_modules.apply_rope(jnp.asarray(x), cos, sin)
    pcos, psin = modules.rope_freqs(8, 1e6, _t(pos))
    np.testing.assert_allclose(pcos.numpy(), np.asarray(cos), **LM_TOL)
    got = modules.apply_rope(_t(x), pcos, psin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)


@pytest.mark.parametrize("cached", [False, True])
def test_gqa_attention_matches_reference(smoke, cached):
    cfg, ref_params, params = smoke
    lp = jax.tree.map(lambda a: a[0], ref_params["blocks"]["attn"])
    lp = {k: v + 0.01 if k.startswith("b") else v for k, v in lp.items()}
    mine = {k: _t(v) for k, v in jax.tree.map(np.asarray, lp).items()}
    (x,) = _arrays(8, (2, 6, cfg.d_model))
    if not cached:
        pos = np.arange(6)
        want, _ = ref_modules.gqa_attention(lp, jnp.asarray(x), cfg,
                                            jnp.asarray(pos))
        got, _ = modules.gqa_attention(mine, _t(x), cfg, _t(pos))
    else:
        shape = (2, cfg.n_kv_heads, 16, cfg.d_head)
        ck, cv = _arrays(9, shape, shape)
        pos = np.arange(5, 11)
        want, rc = ref_modules.gqa_attention(
            lp, jnp.asarray(x), cfg, jnp.asarray(pos),
            cache=ref_modules.KVCache(jnp.asarray(ck), jnp.asarray(cv)),
            cache_pos=5)
        cache = modules.KVCache(_t(ck.copy()), _t(cv.copy()))
        got, cache = modules.gqa_attention(mine, _t(x), cfg, _t(pos),
                                           cache=cache, cache_pos=5)
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(rc.k),
                                   **LM_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)


def test_forward_matches_reference(smoke):
    cfg, ref_params, params = smoke
    tokens = np.random.default_rng(10).integers(0, cfg.vocab, (2, 12))
    want = ref_model.forward(ref_params, cfg, jnp.asarray(tokens))
    got = model.forward(params, cfg, _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)


@pytest.mark.parametrize("chunk", [None, 4])
def test_decode_step_matches_reference(smoke, chunk):
    """A whole or chunked prefill, then 4 decode steps fed the reference's
    argmax."""
    cfg, ref_params, params = smoke
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, (2, 12))
    rc = ref_model.init_cache(cfg, 2, 24)
    pc = model.init_cache(cfg, 2, 24, device="cpu")
    step = chunk or tokens.shape[1]
    for lo in range(0, tokens.shape[1], step):
        want, rc = ref_model.decode_step(ref_params, cfg,
                                         jnp.asarray(tokens[:, lo:lo + step]),
                                         rc)
        got, pc = model.decode_step(params, cfg,
                                    _t(tokens[:, lo:lo + step]), pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(want[:, -1, :cfg.vocab], -1))[:, None]
        want, rc = ref_model.decode_step(ref_params, cfg, jnp.asarray(tok),
                                         rc)
        got, pc = model.decode_step(params, cfg, _t(tok), pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)
    assert pc.pos == int(rc.pos) == 16
    np.testing.assert_allclose(pc.kv_k.numpy(), np.asarray(rc.kv_k),
                               **LM_TOL)
    last, _ = model.decode_step(params, cfg, _t(tok), pc, last_only=True)
    assert last.shape == (2, 1, cfg.padded_vocab)


STATIC_TOL = dict(rtol=1e-5, atol=1e-5)


def test_shape_static_decode_matches_reference(smoke):
    """The reference's decode design: after a chunked prefill, each decode
    step reads the position from the device scalar (RoPE, the k/v write,
    K7 decode over the whole cache masked to pos + 1).  Logits at 1e-5
    against the reference's ``decode_step`` (f32 through two layers, only
    the summation order differs); each step's k/v land at the device
    position as ``dynamic_update_slice`` writes them, and nothing past it;
    the host and device positions agree."""
    cfg, ref_params, params = smoke
    tokens = np.random.default_rng(13).integers(0, cfg.vocab, (2, 10))
    rc = ref_model.init_cache(cfg, 2, 20)
    pc = model.init_cache(cfg, 2, 20, device="cpu")
    for lo in range(0, 10, 4):
        want, rc = ref_model.decode_step(ref_params, cfg,
                                         jnp.asarray(tokens[:, lo:lo + 4]),
                                         rc)
        got, pc = model.decode_step(params, cfg, _t(tokens[:, lo:lo + 4]),
                                    pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **STATIC_TOL)
    for _ in range(5):
        tok = np.asarray(jnp.argmax(want[:, -1, :cfg.vocab], -1))[:, None]
        at = pc.pos
        want, rc = ref_model.decode_step(ref_params, cfg, jnp.asarray(tok),
                                         rc)
        got, nxt = model.decode_step(params, cfg, _t(tok), pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **STATIC_TOL)
        assert nxt.pos == int(nxt.pos_dev) == int(rc.pos) == at + 1
        assert nxt.pos_dev.dtype == torch.int32 and nxt.pos_dev.dim() == 0
        for mine, ref in ((nxt.kv_k, rc.kv_k), (nxt.kv_v, rc.kv_v)):
            np.testing.assert_allclose(mine[:, :, :, at].numpy(),
                                       np.asarray(ref)[:, :, :, at],
                                       **STATIC_TOL)
            assert not mine[:, :, :, at + 1:].any()
        pc = nxt


def test_decode_fills_the_cache_to_its_capacity(smoke):
    """A cache of 8: a 7-token prefill, then a decode step at the last
    position, at 1e-5 against the reference; one more step is refused on
    the host (the reference's ``dynamic_update_slice`` would clamp it)."""
    cfg, ref_params, params = smoke
    tokens = np.random.default_rng(14).integers(0, cfg.vocab, (2, 7))
    rc = ref_model.init_cache(cfg, 2, 8)
    pc = model.init_cache(cfg, 2, 8, device="cpu")
    want, rc = ref_model.decode_step(ref_params, cfg, jnp.asarray(tokens),
                                     rc)
    _, pc = model.decode_step(params, cfg, _t(tokens), pc)
    tok = np.asarray(jnp.argmax(want[:, -1, :cfg.vocab], -1))[:, None]
    want, rc = ref_model.decode_step(ref_params, cfg, jnp.asarray(tok), rc)
    got, pc = model.decode_step(params, cfg, _t(tok), pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STATIC_TOL)
    np.testing.assert_allclose(pc.kv_k.numpy(), np.asarray(rc.kv_k),
                               **STATIC_TOL)
    assert pc.pos == int(pc.pos_dev) == 8
    with pytest.raises(ValueError, match="exceed the cache's 8"):
        model.decode_step(params, cfg, _t(tok), pc)


# --------------------------------------------------------------------------
# planner, runtime and engine
# --------------------------------------------------------------------------
@pytest.mark.parametrize("batch,plen,gen,n", [(2, 512, 64, 8), (1, 16, 8, 5),
                                              (4, 2048, 256, 6)])
def test_plan_admission_matches_reference(batch, plen, gen, n):
    cfg = ref_get_arch(ARCH)
    want = ref_plan_admission(cfg, split_mesh(jax.devices()[:1], 0.5),
                              TpuModel(), batch, plen, gen, n)
    got = plan_admission(get_arch(ARCH), split_streams("cpu", 0.5), REF_HW,
                         batch, plen, gen, n)
    assert got.group_size == want.group_size
    assert got.est_makespan == pytest.approx(want.est_makespan, rel=1e-12)


@pytest.mark.parametrize("name", (ARCH, *DENSE))
def test_cost_model_counts_the_served_element(name):
    """At 2 bytes an element the card model's stage costs equal the
    reference's at the same constants, term by term; at its default of 4
    (the port serves f32) the memory terms, weights and KV cache alike,
    double and the compute terms stay."""
    cfg = get_arch(name)
    tpu = TpuModel()
    for args in ((2, 512, 1), (4, 2048, 8)):
        want = ref_cost.prefill_cost(ref_get_arch(name), *args, tpu, 8)
        got = prefill_cost(cfg, *args, REF_HW, 8)
        assert dataclasses.astuple(got) == pytest.approx(
            dataclasses.astuple(want), rel=1e-12)
    for args in ((16, 544, 1, 1), (8, 4096, 4, 3)):
        want = ref_cost.decode_cost(ref_get_arch(name), *args, tpu, 8)
        got = decode_cost(cfg, *args, REF_HW, 8)
        assert dataclasses.astuple(got) == pytest.approx(
            dataclasses.astuple(want), rel=1e-12)
    two = dataclasses.replace(REF_HW, step_floor_base=0.0, step_floor_tp=0.0,
                              step_floor_dp=0.0)
    four = dataclasses.replace(two, elem_bytes=4)
    assert CardModel().elem_bytes == 4
    for cost, args in ((prefill_cost, (2, 512, 1)),
                       (decode_cost, (16, 544, 1, 1))):
        a, b = cost(cfg, *args, two, 1), cost(cfg, *args, four, 1)
        assert b.t_memory == pytest.approx(2 * a.t_memory, rel=1e-12)
        assert b.t_compute == a.t_compute


def test_resolve_device_names_the_card_by_index(monkeypatch):
    """``"cuda"`` resolves to the indexed device, so it compares equal to
    the device of a tensor placed there (the runner checks its params)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device(torch.device("cuda", 0)) == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_split_streams_on_the_cpu_aliases_one_queue():
    dual = split_streams("cpu", 0.4)
    assert (dual.c_chips, dual.p_chips, dual.tp_c, dual.tp_p) == (1, 1, 1, 1)
    assert dual.theta == 0.4 and dual.stream("c") is None
    assert not dual.cores.distinct


def _shares(c: float, p: float):
    """A CPU split priced as if the c-core held ``c`` of the card's SMs and
    the p-core ``p`` (what ``split_streams`` records on a split card)."""
    return dataclasses.replace(split_streams("cpu", 0.5), c_share=c,
                               p_share=p)


def test_plan_sees_theta():
    """On a split card each core is priced at its share: with the c-core
    on a quarter of the SMs the prefill is slower and the decode faster
    than with the c-core on three quarters, and the plan changes."""
    cfg, hw = get_arch(ARCH), CardModel()
    args = (2, 512, 64, 8)
    small_c, big_c = _shares(0.25, 0.75), _shares(0.75, 0.25)
    pf = {d.c_share: prefill_cost(cfg, 2, 512, 1, hw.share(d.c_share), 1)
          for d in (small_c, big_c)}
    dec = {d.p_share: decode_cost(cfg, 16, 576, 1, 64,
                                  hw.share(d.p_share), 1)
           for d in (small_c, big_c)}
    assert pf[0.25].latency > pf[0.75].latency
    assert dec[0.75].latency < dec[0.25].latency
    a = plan_admission(cfg, small_c, hw, *args)
    b = plan_admission(cfg, big_c, hw, *args)
    assert (a.group_size, a.est_makespan) != (b.group_size, b.est_makespan)
    # the fitted laws at the measured points (theta 0.5, PERF.md): a decode
    # step 1.21x on 68 of 132 SMs, a prefill 1.75x on 64
    assert hw.share(68 / 132).step_floor_base / hw.step_floor_base == \
        pytest.approx(7.53 / 6.22, rel=1e-3)
    assert hw.peak_flops / hw.share(64 / 132).peak_flops == \
        pytest.approx(41.45 / 23.7, rel=1e-3)


@pytest.mark.parametrize("batch,plen,gen,n", [(2, 512, 64, 8), (1, 16, 8, 5)])
def test_plan_at_share_one_is_unchanged(batch, plen, gen, n):
    """At share 1 (no split, the CPU) every term is the whole card's."""
    cfg, hw = get_arch(ARCH), CardModel()
    assert hw.share(1.0) is hw
    whole = split_streams("cpu", 0.5)
    assert (whole.c_share, whole.p_share) == (1.0, 1.0)
    for g in range(1, n + 1):
        assert wave_makespan(cfg, whole, hw, batch, plen, gen, n, g) == \
            wave_makespan(cfg, _shares(1.0, 1.0), hw, batch, plen, gen, n, g)
    with pytest.raises(ValueError, match="share"):
        hw.share(0.0)


_SPLIT_MESH = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs.registry import get_arch
from repro.dualmesh import TpuModel, split_mesh
from repro.dualmesh.schedule import wave_makespan
assert len(jax.devices()) == 8
dual = split_mesh(jax.devices(), 0.25, tp_c=1, tp_p=1)
hw = TpuModel(step_floor_base=0.0, step_floor_tp=0.0, step_floor_dp=0.0)
cfg = get_arch("qwen2_0_5b")
print(json.dumps({"chips": [dual.c_chips, dual.p_chips],
                  "spans": [wave_makespan(cfg, dual, hw, 2, 512, 64, 8, g)
                            for g in range(1, 9)]}))
"""


def test_linear_share_law_matches_split_mesh():
    """Under a linear share law the port's one card priced at the
    reference's 8-chip pod equals the reference's ``split_mesh`` at theta
    0.25 on 8 host devices (2 c-chips, 6 p-chips, no TP, no step floor)."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(root / "src")}
    out = subprocess.run([sys.executable, "-c", _SPLIT_MESH], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    ref = json.loads(out.strip().splitlines()[-1])
    assert ref["chips"] == [2, 6]
    pod = dataclasses.replace(REF_HW, peak_flops=8 * REF_HW.peak_flops,
                              mem_bw=8 * REF_HW.mem_bw, step_floor_base=0.0,
                              step_floor_tp=0.0, step_floor_dp=0.0,
                              flops_share_exp=1.0, bw_share_exp=1.0)
    dual = _shares(2 / 8, 6 / 8)
    cfg = get_arch(ARCH)
    got = [wave_makespan(cfg, dual, pod, 2, 512, 64, 8, g)
           for g in range(1, 9)]
    assert got == pytest.approx(ref["spans"], rel=1e-12)


def _prompts(cfg, n=4, batch=2, plen=8):
    rng = np.random.default_rng(12)
    return [rng.integers(0, cfg.vocab, (batch, plen)) for _ in range(n)]


@pytest.mark.parametrize("chunk,group_size", [(None, 2), (4, 1), (4, 3)])
def test_engine_matches_reference(smoke, chunk, group_size):
    cfg, ref_params, params = smoke
    prompts = _prompts(cfg)
    ref = RefEngine(RefRunner(cfg, ref_params,
                              split_mesh(jax.devices()[:1], 0.5),
                              max_len=24),
                    group_size=group_size, prefill_chunk=chunk)
    mine = DualMeshEngine(DualMeshRunner(cfg, params, split_streams("cpu"),
                                         max_len=24),
                          group_size=group_size, prefill_chunk=chunk)
    for p in prompts:
        ref.submit(RefRequest(jnp.asarray(p), gen_steps=6))
        mine.submit(Request(_t(p), gen_steps=6))
    want, got = ref.drain(), mine.drain()
    assert len(got.outputs) == len(prompts)
    for a, b in zip(want.outputs, got.outputs):
        assert b.shape == (2, 8 + 6)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for key in ("fused_sizes", "prefill_tokens", "decode_tokens",
                "total_tokens"):
        assert got.stats[key] == want.stats[key], key
    assert [t[:2] for t in got.trace] == [t[:2] for t in want.trace]


#: engine scenarios run on both packages: the engine's options (``policy``
#: names a class of ``serving.api``), the requests as (arrival step,
#: generated tokens, slot deadline), the steps at which the test sweeps
#: the queue on its own slot clock (as the fleet executor does at a RUN)
#: and the retunes made before a step
LM_SCENARIOS = {
    "lifecycle": dict(kw=dict(group_size=2),
                      reqs=[(0, 3, None), (0, 3, None), (1, 2, None)]),
    "cap_below_group": dict(kw=dict(group_size=2, max_in_flight=1),
                            reqs=[(0, 2, None), (0, 2, None)]),
    "quantum_greedy": dict(kw=dict(group_size=2, quantum=2,
                                   policy="GreedyAdmission"),
                           reqs=[(0, 6, None), (0, 4, None), (0, 5, None),
                                 (2, 3, None)]),
    "slot_shed": dict(kw=dict(group_size=2, policy="ShedPolicy"),
                      reqs=[(0, 3, None), (0, 3, 0), (0, 2, 5), (0, 3, 1)],
                      sweep=True),
    "retune": dict(kw=dict(group_size=4, quantum=3),
                   reqs=[(0, 5, None), (0, 5, None), (0, 4, None),
                         (3, 4, None), (3, 4, None)],
                   retune={2: dict(group_size=1),
                           4: dict(quantum=1, prefill_chunk=2),
                           6: dict(group_size=2)}),
}


def _drive_lm(eng, scenario, make_req, prompt):
    """Step ``eng`` through ``scenario``; returns per step (queued,
    in flight, next core, next dispatch cycles, completions as (rid,
    status)) and the final result."""
    reqs = list(scenario["reqs"])
    log, step = [], 0
    while reqs or eng.has_work:
        while reqs and reqs[0][0] <= step:
            _, gen, deadline = reqs.pop(0)
            eng.submit(make_req(prompt, gen_steps=gen, deadline=deadline))
        for k, v in scenario.get("retune", {}).items():
            if k == step:
                eng.retune(**v)
        shed = (eng.shed_expired(step) if scenario.get("sweep") else [])
        row = (eng.queued, eng.in_flight, eng.next_core,
               eng.next_dispatch_cycles())
        done = shed + (eng.step() if eng.has_work else [])
        log.append(row + ([(c.ticket.rid, c.metrics.status)
                           for c in done],))
        step += 1
        assert step < 100, "the engine did not terminate"
    return log, eng.result()


@pytest.mark.parametrize("name", sorted(LM_SCENARIOS))
def test_engine_fleet_surface_matches_reference(smoke, name):
    """The LM engine's fleet surface on the reference's scenarios and
    more (an in-flight cap below the group size that still terminates, a
    finite quantum with greedy admission, slot-clock shedding swept as
    the fleet executor sweeps, retunes mid-run): step for step the same
    queue, in-flight count, ``next_core`` and ``next_dispatch_cycles``,
    the same completions and statuses, tokens equal, the same stats."""
    cfg, ref_params, params = smoke
    sc = LM_SCENARIOS[name]
    prompt = _prompts(cfg, n=1, batch=1, plen=4)[0]
    runs = {}
    for pkg, runner, mod, req, to in (
            ("ref", RefRunner(cfg, ref_params,
                              split_mesh(jax.devices()[:1], 0.5),
                              max_len=24), ref_api, RefRequest, jnp.asarray),
            ("port", DualMeshRunner(cfg, params, split_streams("cpu"),
                                    max_len=24), api, Request, _t)):
        kw = dict(sc["kw"])
        if "policy" in kw:
            kw["policy"] = (mod.ShedPolicy(clock="slot")
                            if kw["policy"] == "ShedPolicy"
                            else getattr(mod, kw["policy"])())
        eng = (RefEngine if pkg == "ref" else DualMeshEngine)(runner, **kw)
        runs[pkg] = _drive_lm(eng, sc, lambda p, **k: req(to(p), **k),
                              prompt)
    (ref_log, want), (port_log, got) = runs["ref"], runs["port"]
    assert port_log == ref_log
    assert [c.metrics.status for c in got.completions] == \
        [c.metrics.status for c in want.completions]
    for a, b in zip(want.outputs, got.outputs):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for key in ("fused_sizes", "prefill_tokens", "decode_tokens",
                "total_tokens", "group_size", "retunes", "n_streams"):
        assert got.stats[key] == want.stats[key], key
    if name == "cap_below_group":
        assert got.stats["fused_sizes"] == [1, 1]
    if name == "slot_shed":
        assert [c.metrics.status for c in got.completions].count(
            "shed") == 2
    if name == "retune":
        assert [r["group_size"] for r in got.stats["retunes"]
                if "group_size" in r] == [1, 2]


def test_engine_retune_validation_and_backpressure(smoke):
    """``retune`` refuses a knob below 1 and changes nothing then; a
    bounded queue raises ``QueueFull``; the ``serve`` shim equals the
    engine driven directly."""
    cfg, _, params = smoke
    runner = DualMeshRunner(cfg, params, split_streams("cpu"), max_len=24)
    eng = DualMeshEngine(runner, group_size=2, quantum=4, max_queue=1)
    for knob in ("group_size", "quantum", "prefill_chunk"):
        with pytest.raises(ValueError, match=f"{knob} must be >= 1"):
            eng.retune(**{knob: 0})
    assert eng.retune() == {"group_size": 2, "quantum": 4,
                            "prefill_chunk": None}
    assert eng.retunes == [] and eng.next_core is None
    p = _t(_prompts(cfg, n=1, batch=1, plen=4)[0])
    eng.submit(Request(p, gen_steps=1))
    with pytest.raises(QueueFull):
        eng.submit(Request(p, gen_steps=1))
    assert eng.drain().metrics.completed == 1
    prompts = [_t(x) for x in _prompts(cfg, n=3, batch=1, plen=6)]
    shim = runner.serve(prompts, gen_steps=4, group_size=2)
    eng = DualMeshEngine(runner, group_size=2)
    for x in prompts:
        eng.submit(Request(x, gen_steps=4))
    res = eng.drain()
    for a, b in zip(shim.outputs, res.outputs):
        assert torch.equal(a, b)
    for key in ("prefill_tokens", "decode_tokens", "total_tokens",
                "fused_sizes", "n_streams"):
        assert shim.stats[key] == res.stats[key], key


def test_runner_jit_groups_pools_decode_lanes_on_the_cpu(smoke):
    """``jit_groups`` (the card's decode graphs) changes nothing on the
    CPU: the same tokens with it on and off.  Either way a decode group
    runs on a lane keyed by (rows, capacity): a fuse of two requests takes
    a lane of 4 rows, the eviction of one copies the other into a lane of
    2 rows, and a later group of the same width reuses a lane."""
    cfg, _, params = smoke
    prompts = [_t(p) for p in _prompts(cfg)]
    outs = []
    for jit in (True, False):
        r = DualMeshRunner(cfg, params, split_streams("cpu"), max_len=24,
                           jit_groups=jit)
        assert r.jit_groups is jit
        res = r.serve(prompts, gen_steps=[6, 4, 6, 4], group_size=2)
        assert res.stats["fused_sizes"] == [2, 2]
        assert sorted(r.lanes.lanes) == [(2, 24), (4, 24)]
        assert all(lane.graph is None for v in r.lanes.lanes.values()
                   for lane in v)
        assert r.lanes.count == 2            # reused by the second group
        outs.append(res.outputs)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_run_two_streams_matches_reference(smoke):
    cfg, ref_params, params = smoke
    a, b = _prompts(cfg, n=2)
    ra, rb, rtrace = RefRunner(cfg, ref_params,
                               split_mesh(jax.devices()[:1], 0.5),
                               max_len=24).run_two_streams(
        jnp.asarray(a), jnp.asarray(b), gen_steps=3)
    pa, pb, ptrace = DualMeshRunner(cfg, params, split_streams("cpu"),
                                    max_len=24).run_two_streams(
        _t(a), _t(b), gen_steps=3)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(rb))
    assert [t[:2] for t in ptrace] == [t[:2] for t in rtrace]


def test_serve_lm_cli_on_cpu(monkeypatch, capsys):
    """The ``lm`` subcommand end to end on the CPU, at the smoke config (the
    published one is the card's)."""
    import repro_torch.launch.serve as serve

    monkeypatch.setattr(serve, "get_arch", get_smoke)
    assert serve.main(["lm", "--arch", ARCH, "--device", "cpu",
                       "--requests", "3", "--batch", "1", "--prompt-len",
                       "6", "--gen", "4", "--prefill-chunk", "4"]) == 0
    out = capsys.readouterr().out
    assert "admission plan: group_size=" in out
    assert "3 requests x batch 1" in out and "p95" in out
    assert "prefill  on c-core" in out and "decode   on p-core" in out
