"""The port's recurrent blocks (``repro_torch.lm.ssm``) against the
reference's ``repro.lm.ssm`` on the CPU.

The same numpy inputs, made from a seed, go through both modules; both
sides are f32 and only the order of the sums differs, so outputs and
states agree at ``LM_TOL`` (1e-4).  The chunk length is monkeypatched to 8
in both modules, so that the prefills below cross chunk boundaries and end
inside a chunk.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as ref_get_smoke
from repro.lm import ssm as ref_ssm
from repro_torch.lm import ssm

LM_TOL = dict(rtol=1e-4, atol=1e-4)
CHUNK = 8


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(ssm, "CHUNK", CHUNK)
    monkeypatch.setattr(ref_ssm, "CHUNK", CHUNK)


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **LM_TOL)


def _scan_inputs(seed, s, b=2, h=3, p=5, n=4):
    log_a, u, bk, ck, s0 = _arrays(seed, (b, s, h), (b, s, h, p),
                                   (b, s, h, n), (b, s, h, n), (b, h, p, n),
                                   scale=0.5)
    return -np.abs(log_a), u, bk, ck, s0


@pytest.mark.parametrize("s", [1, 3, 7, 8, 13, 24])
def test_chunked_gla_scan_matches_reference(s):
    """A nonzero initial state, S below, at and across the chunk of 8."""
    args = _scan_inputs(s, s)
    y, st = ssm.chunked_gla_scan(*map(_t, args))
    ry, rst = ref_ssm.chunked_gla_scan(*map(jnp.asarray, args))
    assert y.shape == ry.shape and st.shape == rst.shape
    _close(y, ry)
    _close(st, rst)


@pytest.mark.parametrize("s", [1, 13])
def test_gla_step_s_times_equals_the_scan(s):
    """``gla_step`` applied S times: the scan's outputs and final state,
    and the reference's step at every token."""
    log_a, u, bk, ck, s0 = map(_t, _scan_inputs(40 + s, s))
    y, st = ssm.chunked_gla_scan(log_a, u, bk, ck, s0)
    state, rstate = s0, jnp.asarray(s0.numpy())
    for t in range(s):
        step = (log_a[:, t], u[:, t], bk[:, t], ck[:, t])
        state, yt = ssm.gla_step(state, *step)
        rstate, ryt = ref_ssm.gla_step(rstate, *(jnp.asarray(a.numpy())
                                                 for a in step))
        _close(yt, y[:, t])
        _close(yt, ryt)
    _close(state, st)
    _close(state, rstate)


@pytest.mark.parametrize("tail", [False, True])
def test_causal_conv1d_matches_reference(tail):
    x, w, tl = _arrays(3, (2, 6, 10), (4, 10), (2, 3, 10))
    t = _t(tl) if tail else None
    out, new_tail = ssm.causal_conv1d(_t(x), _t(w), t)
    rout, rtail = ref_ssm.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(tl) if tail else None)
    _close(out, rout)
    assert tuple(new_tail.shape) == rtail.shape == (2, 3, 10)
    _close(new_tail, rtail)


def _block_params(name, seed):
    """The reference's first block of ``name``'s smoke config, as numpy."""
    from repro.lm import model as ref_model
    cfg = ref_get_smoke(name)
    params = ref_model.init_params(cfg, jax.random.PRNGKey(seed))
    first = jax.tree.map(lambda a: np.asarray(a[0]), params["blocks"])
    return cfg, first


BLOCKS = {"mamba2": ("zamba2_2_7b", ssm.mamba2_block, ref_ssm.mamba2_block),
          "mlstm": ("xlstm_350m", ssm.mlstm_block, ref_ssm.mlstm_block)}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_whole_matches_reference(kind):
    """A block over a 13-token sequence from no state: outputs and the
    final state."""
    name, mine, ref = BLOCKS[kind]
    cfg, lp = _block_params(name, 5)
    x, = _arrays(6, (2, 13, cfg.d_model))
    out, st = mine({k: _t(v) for k, v in lp.items()}, _t(x), cfg)
    rout, rst = ref(jax.tree.map(jnp.asarray, lp), jnp.asarray(x), cfg)
    _close(out, rout)
    _close(st.s, rst.s)
    assert (st.conv is None) == (rst.conv is None) == (kind == "mlstm")
    if st.conv is not None:
        _close(st.conv, rst.conv)


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_token_by_token_from_a_state(kind):
    """A 5-token chunk from the state the first 9 tokens left, then token
    by token: each against the reference from the same state, and the
    state written in place into the buffers it was given."""
    name, mine, ref = BLOCKS[kind]
    cfg, lp = _block_params(name, 7)
    params = {k: _t(v) for k, v in lp.items()}
    rparams = jax.tree.map(jnp.asarray, lp)
    x, = _arrays(8, (2, 17, cfg.d_model))
    _, st = mine(params, _t(x[:, :9]), cfg)
    _, rst = ref(rparams, jnp.asarray(x[:, :9]), cfg)
    bufs = ssm.SSMState(st.s.clone(),
                        None if st.conv is None else st.conv.clone())
    pieces = [(9, 14)] + [(t, t + 1) for t in range(14, 17)]
    for lo, hi in pieces:
        out, got = mine(params, _t(x[:, lo:hi]), cfg, bufs)
        rout, rst = ref(rparams, jnp.asarray(x[:, lo:hi]), cfg, rst)
        assert got.s is bufs.s and got.conv is bufs.conv
        _close(out, rout)
        _close(bufs.s, rst.s)
        if bufs.conv is not None:
            _close(bufs.conv, rst.conv)
