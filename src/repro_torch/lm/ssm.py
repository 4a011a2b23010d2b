"""Recurrent blocks: Mamba2 (SSD) and mLSTM (xLSTM), sharing one chunked
gated-linear scan.

Port of ``repro/lm/ssm.py``.  Both blocks are state-space recurrences of
the form

    S_t = a_t * S_{t-1} + b_t (x) u_t          (state:  H x P x N)
    y_t = <S_t, c_t> (+ D * u_t)

with a per-head scalar decay a_t.  A prefill (or a chunk of one) runs the
chunked scan: within a chunk of ``CHUNK`` tokens the contribution is a
masked quadratic einsum, across chunks a Python loop carries the state
(the reference's ``lax.scan``).  Decode is the one-step recurrence on a
carried state.  The reference has no Pallas kernel here: its scan is jnp
einsums, and the port's is PyTorch einsums.

mLSTM is the reference's GLA form: a sigmoid forget gate, an exp input gate
clipped to [-10, 10], and the normaliser as an extra row of the state (v
augmented with the input gate), so that it shares the scan.

Given a state, a block writes the new state into it in place (``copy_``)
and returns it, so that a decode step reads and writes the same buffers at
every position and can be captured as a CUDA graph.  The reference's
sharding hints have no counterpart on one card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

#: tokens of one chunk of the scan: the intra-chunk product costs
#: O(S * CHUNK), the loop across chunks S / CHUNK steps
CHUNK = 128


class SSMState(NamedTuple):
    """One layer's recurrent state: ``s`` (B, H, P, N) and, for Mamba2,
    ``conv`` (B, K - 1, C), the causal convolution's tail."""

    s: torch.Tensor
    conv: torch.Tensor | None


# --------------------------------------------------------------------------
# Shared chunked gated-linear scan
# --------------------------------------------------------------------------
def chunked_gla_scan(log_a: torch.Tensor, u: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor, s0: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """log_a: (B, S, H) per-head log decay (<= 0 for Mamba2); u: (B, S, H,
    P) inputs; b: (B, S, H, N) write keys; c: (B, S, H, N) read keys; s0:
    (B, H, P, N) initial state.  Returns y (B, S, H, P) and the final
    state."""
    bsz, s, h = log_a.shape
    p = u.shape[-1]
    lc = min(CHUNK, s)
    pad = -s % lc
    if pad:
        log_a = F.pad(log_a, (0, 0, 0, pad))
        u, b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (u, b, c))
    nc = (s + pad) // lc

    def chunks(t):
        return t.reshape((bsz, nc, lc) + t.shape[2:])

    la, uc, bc, cc = map(chunks, (log_a, u, b, c))
    mask = torch.tril(torch.ones(lc, lc, dtype=torch.bool,
                                 device=log_a.device))[None, :, :, None]
    state, ys = s0, []
    for i in range(nc):
        la_, u_, b_, c_ = la[:, i], uc[:, i], bc[:, i], cc[:, i]
        cum = torch.cumsum(la_, dim=1)                       # (B, Lc, H)
        total = cum[:, -1]                                   # (B, H)
        # intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) <c_i, b_j> u_j
        decay = cum[:, :, None, :] - cum[:, None, :, :]      # (B, i, j, H)
        # the reference's where(mask, exp(decay), 0), the mask applied
        # before the exp: the same values, and no 0 * inf = NaN in the
        # backward where a masked decay (j > i, positive) overflows
        w = torch.exp(decay.masked_fill(~mask, float("-inf")))
        scores = torch.einsum("bihn,bjhn->bijh", c_, b_) * w
        y = torch.einsum("bijh,bjhp->bihp", scores, u_)
        # inter-chunk: y_i += exp(cum_i) <c_i, s_prev>
        y = y + torch.einsum("bihn,bhpn->bihp", c_, state) \
            * torch.exp(cum)[..., None]
        # s = exp(total) s_prev + sum_j exp(total - cum_j) b_j u_j (the
        # weights go on u first: no (B, Lc, H, P, N) intermediate)
        wj = torch.exp(total[:, None] - cum)                 # (B, Lc, H)
        state = (torch.exp(total)[:, :, None, None] * state
                 + torch.einsum("bjhp,bjhn->bhpn", u_ * wj[..., None], b_))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s].reshape(bsz, s, h, p)
    return y, state


def gla_step(s: torch.Tensor, log_a: torch.Tensor, u: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One token of the recurrence (decode): log_a (B, H), u (B, H, P), b
    and c (B, H, N).  Returns the new state and y (B, H, P)."""
    a = torch.exp(log_a)[..., None, None]
    s_new = a * s + torch.einsum("bhp,bhn->bhpn", u, b)
    y = torch.einsum("bhn,bhpn->bhp", c, s_new)
    return s_new, y


def _write(state: SSMState, s_new: torch.Tensor,
           tail: torch.Tensor | None) -> SSMState:
    """The new state written into ``state``'s buffers."""
    state.s.copy_(s_new)
    if state.conv is not None:
        state.conv.copy_(tail)
    return state


# --------------------------------------------------------------------------
# Mamba2 block
# --------------------------------------------------------------------------
def mamba2_dims(cfg) -> tuple[int, int, int, int]:
    """(d_inner, heads, head width, state width) of a Mamba2 block."""
    din = cfg.d_inner
    nh = cfg.ssm_heads
    return din, nh, din // nh, cfg.ssm_state


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  tail: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, C); w: (K, C) depthwise causal convolution, then SiLU.
    ``tail`` is the carried (B, K - 1, C) suffix of the inputs before x
    (decode); returns the output and the new tail."""
    k = w.shape[0]
    if tail is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([tail, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    new_tail = xp[:, xp.shape[1] - (k - 1):, :]
    return F.silu(out), new_tail


def mamba2_block(params: dict, x: torch.Tensor, cfg,
                 state: SSMState | None = None
                 ) -> tuple[torch.Tensor, SSMState]:
    """x: (B, S, D) -> (B, S, D) and the state after x.  With ``state``
    given, runs on from it (decode, or a later chunk of a prefill) and
    writes the new state into it."""
    bsz, s, _ = x.shape
    din, nh, hp, ns = mamba2_dims(cfg)
    proj = torch.matmul(x, params["in_proj"])
    z, xin, bmat, cmat, dt = torch.split(proj, [din, din, ns, ns, nh],
                                         dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    tail = state.conv if state is not None else None
    conv_out, new_tail = causal_conv1d(conv_in, params["conv_w"], tail)
    xin, bmat, cmat = torch.split(conv_out, [din, ns, ns], dim=-1)
    dt = F.softplus(dt + params["dt_bias"])                  # (B, S, H)
    log_a = -torch.exp(params["a_log"])[None, None] * dt     # <= 0
    u = xin.reshape(bsz, s, nh, hp) * dt[..., None]          # dt-scaled
    b = bmat[:, :, None, :].expand(bsz, s, nh, ns)
    c = cmat[:, :, None, :].expand(bsz, s, nh, ns)
    s0 = (state.s if state is not None
          else torch.zeros((bsz, nh, hp, ns), device=x.device))
    if state is not None and s == 1:
        s_new, y = gla_step(s0, log_a[:, 0], u[:, 0], b[:, 0], c[:, 0])
        y = y[:, None]
    else:
        y, s_new = chunked_gla_scan(log_a, u, b, c, s0)
    y = y.reshape(bsz, s, din) + xin * params["d_skip"][None, None]
    y = y * F.silu(z)
    out = torch.matmul(y.to(x.dtype), params["out_proj"])
    if state is not None:
        return out, _write(state, s_new, new_tail)
    return out, SSMState(s_new, new_tail)


# --------------------------------------------------------------------------
# mLSTM block (xLSTM)
# --------------------------------------------------------------------------
def mlstm_block(params: dict, x: torch.Tensor, cfg,
                state: SSMState | None = None
                ) -> tuple[torch.Tensor, SSMState]:
    """mLSTM as gated linear attention with normaliser-augmented values;
    ``state`` as for :func:`mamba2_block`."""
    bsz, s, _ = x.shape
    din = cfg.d_inner
    nh = cfg.ssm_heads
    hp = din // nh
    q = torch.matmul(x, params["wq"]).reshape(bsz, s, nh, hp)
    k = torch.matmul(x, params["wk"]).reshape(bsz, s, nh, hp)
    v = torch.matmul(x, params["wv"]).reshape(bsz, s, nh, hp)
    k = k / (hp ** 0.5)
    gates = torch.matmul(x, params["w_gates"])               # (B, S, 2H)
    i_t = torch.exp(torch.clamp(gates[..., :nh], -10.0, 10.0))
    log_f = F.logsigmoid(gates[..., nh:])                    # <= 0
    # v with a column of ones: row P of the state is the normaliser n_t
    v_aug = torch.cat([v * i_t[..., None],
                       i_t[..., None] * torch.ones_like(v[..., :1])],
                      dim=-1)                                # (B,S,H,P+1)
    s0 = (state.s if state is not None
          else torch.zeros((bsz, nh, hp + 1, hp), device=x.device))
    if state is not None and s == 1:
        s_new, y = gla_step(s0, log_f[:, 0], v_aug[:, 0], k[:, 0], q[:, 0])
        y = y[:, None]
    else:
        y, s_new = chunked_gla_scan(log_f, v_aug, k, q, s0)
    num, den = y[..., :hp], y[..., hp:]
    y = num / torch.clamp(torch.abs(den), min=1.0)
    y = y.reshape(bsz, s, din).to(x.dtype)
    out = torch.matmul(y, params["wo"])
    if state is not None:
        return out, _write(state, s_new, None)
    return out, SSMState(s_new, None)
