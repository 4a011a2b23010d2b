"""Plain PyTorch versions of the attention kernels (K7).

Counterpart of ``repro/kernels/attention/ref.py`` and of the jnp
``masked_decode_ref`` in ``repro/kernels/attention/kernel.py``:

- ``attention_ref``: the reference's oracle, causal mask aligned to the
  bottom right (``tril(k=sk-sq)``);
- ``flash_attention_ref``: the plain version of the flash kernel, the same
  online softmax over 64-key tiles and the same ``q_offset`` / ``sk_valid``
  semantics (query row i sits at key position ``q_offset + i``); at
  ``q_offset = 0`` it computes what the TPU kernel computes, at
  ``q_offset = sk - sq`` what ``attention_ref`` computes;
- ``flash_attention_bwd_ref``: the plain version of the port's backward
  kernels of flash (dq, dk, dv from the forward's log-sum-exp);
- ``masked_decode_ref``: the reference's ragged-decode fallback;
- ``decode_attention_ref``: the plain version of the decode kernel, the
  mask built from the per-row ``kv_len``;
- ``flash_attention_int8_ref`` and ``decode_attention_int8_ref``: the
  plain versions of the int8 kernels, over an int8 cache with the
  reference's static scales (``int8_attention_ref``: the reference's
  ``_attn_block`` with int8 k/v, step by step);
- ``visible_pairs``: the (query, key) pairs the flash kernels compute,
  from the shape alone.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
BLOCK_K = 64          # the flash kernel's key tile

# The reference's static symmetric scales of the int8 KV cache
# (``repro/lm/modules.py``): k and v are stored as round(x * KV_SCALE), q
# and the probabilities are quantized on the fly, so both products are
# int8 x int8 -> s32.
KV_SCALE = 32.0
Q_SCALE = 32.0
P_SCALE = 127.0


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D)."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    kr = k.repeat_interleave(g, dim=1)
    vr = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr.float())
    return out.to(q.dtype)


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """f32, or f64 for f64 inputs (the tests' exact gradients)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        sk_valid: int | None = None, with_lse: bool = False):
    """Online-softmax GQA attention over 64-key tiles.

    q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D).  Key position kp is visible to
    query row i when kp < min(Sk, sk_valid) and, if causal,
    kp <= q_offset + i.  A row that sees no key is 0.  ``with_lse`` also
    returns each row's log-sum-exp of its visible scaled scores (B, Hq,
    Sq), -inf for a row that sees no key: what the backward reads."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    kv_end = sk if sk_valid is None else max(0, min(sk, sk_valid))
    n_keys = min(kv_end, max(q_offset + sq, 0)) if causal else kv_end
    ct = _compute_dtype(q)
    # the group's heads stacked as rows: (B, Hkv, G*Sq, D), no KV copies
    qg = q.to(ct).reshape(b, hkv, g * sq, d)
    qpos = q_offset + torch.arange(sq, device=q.device).repeat(g)
    m = torch.full((b, hkv, g * sq, 1), float("-inf"), dtype=ct,
                   device=q.device)
    l = torch.zeros((b, hkv, g * sq, 1), dtype=ct, device=q.device)
    acc = torch.zeros((b, hkv, g * sq, d), dtype=ct, device=q.device)
    for k0 in range(0, n_keys, BLOCK_K):
        k1 = min(k0 + BLOCK_K, kv_end)
        kt = k[:, :, k0:k1].to(ct)
        vt = v[:, :, k0:k1].to(ct)
        s = torch.matmul(qg, kt.transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(k0, k1, device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe)
        alpha = torch.exp(m - m_safe)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vt)
        m = m_new
    out = torch.where(l == 0, 0.0, acc / torch.where(l == 0, 1.0, l))
    out = out.reshape(b, hq, sq, d).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.where(l == 0, float("-inf"), m + torch.log(l))
    return out, lse.reshape(b, hq, sq).to(q.dtype)


def visible(sq: int, sk: int, causal: bool, q_offset: int,
            sk_valid: int | None, device) -> torch.Tensor:
    """(Sq, Sk) bool: key kp is visible to query row i (the flash
    kernel's mask)."""
    kv_end = sk if sk_valid is None else max(0, min(sk, sk_valid))
    kpos = torch.arange(sk, device=device)[None, :]
    vis = (kpos < kv_end).expand(sq, sk)
    if causal:
        qpos = q_offset + torch.arange(sq, device=device)[:, None]
        vis = vis & (kpos <= qpos)
    return vis


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            dout: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True, q_offset: int = 0,
                            sk_valid: int | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention_ref`` given its
    output ``out``, the output's gradient ``dout`` and the rows' ``lse``
    (``with_lse``): P = exp(s - lse) on the visible keys, D = rowsum(dout
    * out), dS = P (dout V^T - D); dq = scale dS K, dk = scale dS^T q and
    dv = P^T dout, each summed over the query heads of a KV head's group.
    The plain version of the port's backward kernels (the reference
    trains through XLA's attention and has no backward kernel)."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    kr = k.repeat_interleave(g, dim=1)
    vr = v.repeat_interleave(g, dim=1)
    s = torch.matmul(q, kr.transpose(-1, -2)) * scale
    vis = visible(sq, sk, causal, q_offset, sk_valid, q.device)
    p = torch.where(vis, torch.exp(s - torch.where(
        torch.isinf(lse), 0.0, lse)[..., None]), 0.0)
    dp = torch.matmul(dout, vr.transpose(-1, -2))
    ds = p * (dp - torch.sum(dout * out, dim=-1, keepdim=True))
    dq = torch.matmul(ds, kr) * scale
    dk = (torch.matmul(ds.transpose(-1, -2), q) * scale).reshape(
        b, hkv, g, sk, d).sum(dim=2)
    dv = torch.matmul(p.transpose(-1, -2), dout).reshape(
        b, hkv, g, sk, d).sum(dim=2)
    return dq, dk, dv


def masked_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias_mask: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, 1, D) against k/v (B, Hkv, S, D); ``bias_mask`` (B, 1, S)
    is True where a key is masked out."""
    g = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(g, dim=1)
    vr = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kr) / math.sqrt(q.shape[-1])
    s = torch.where(bias_mask[:, :, None, :], NEG_INF, s)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Single-token decode: q (B, Hq, 1, D) against the first ``kv_len[b]``
    rows of k/v (B, Hkv, S, D) (all S rows when ``kv_len`` is None).  A row
    with ``kv_len`` 0 is 0, as in the kernel."""
    b, s = k.shape[0], k.shape[2]
    if kv_len is None:
        mask = torch.zeros((b, 1, s), dtype=torch.bool, device=q.device)
        return masked_decode_ref(q, k, v, mask)
    lens = kv_len.to(q.device).long().clamp(0, s)
    mask = torch.arange(s, device=q.device)[None, None, :] \
        >= lens[:, None, None]
    out = masked_decode_ref(q, k, v, mask)
    return torch.where((lens > 0)[:, None, None, None], out, 0.0).to(q.dtype)


def visible_pairs(sq: int, sk: int, causal: bool, q_offset: int,
                  sk_valid: int | None) -> int:
    """The (query row, key) pairs :func:`visible` marks, for one (batch,
    head), in closed form (``q_offset`` >= 0): row i sees
    ``min(kv_end, q_offset + i + 1)`` keys when causal, ``kv_end``
    otherwise."""
    kv_end = sk if sk_valid is None else max(0, min(sk, sk_valid))
    if not causal:
        return sq * kv_end
    first = q_offset + 1                  # keys row 0 sees, before the cap
    under = max(0, min(sq, kv_end - first + 1))   # rows below the cap
    return under * first + under * (under - 1) // 2 + (sq - under) * kv_end


def _ieee_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c in x's dtype, rounded once (IEEE division).  A Python scalar
    divisor would let PyTorch's CUDA kernel multiply by its reciprocal."""
    return x / torch.full((1,), c, dtype=x.dtype, device=x.device)


def int8_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       vis: torch.Tensor, with_probs: bool = False):
    """The reference's int8 attention (``_attn_block`` with an int8 cache,
    reached from ``attention_scores``), step by step: qf = q / sqrt(D) (a
    division), qq = clip(round(qf * Q_SCALE), -127, 127), s = (qq . k) /
    (Q_SCALE KV_SCALE), masked to -1e30 where ``vis`` is False, p =
    exp(s - max) / sum, pq = round(p * P_SCALE), out = (pq . v) / (P_SCALE
    KV_SCALE).  Rounding is half to even, as ``jnp.round``'s.

    q: (B, Hq, Sq, D) float32; k, v: (B, Hkv, Sk, D) int8, Hq % Hkv == 0;
    vis: bool, broadcastable to (B, 1, 1, Sq, Sk) (the key is visible to
    the query row).  The integer products run in float64, where int8
    operands are exact in any order (int8 @ int8 would wrap on the CPU, and
    the card has no integer matmul).  A row that sees no key is 0 (the
    reference's -1e30 fill would average every key there; the model never
    sends such a row).  ``with_probs`` also returns p * P_SCALE before
    rounding (B, Hq, Sq, Sk), where a rounding tie shows."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = _ieee_div(q.float(), math.sqrt(d))
    qq = torch.clamp(torch.round(qf * Q_SCALE), -127, 127)
    qg = qq.reshape(b, hkv, g, sq, d).double()
    s = torch.matmul(qg, k.double()[:, :, None].transpose(-1, -2))
    s = (s / (Q_SCALE * KV_SCALE)).float()          # exact: s32 / 2^10
    s = torch.where(vis, s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    p127 = p * P_SCALE
    pq = torch.round(p127)
    acc = torch.matmul(pq.double(), v.double()[:, :, None]).float()
    out = _ieee_div(acc, P_SCALE * KV_SCALE)
    out = torch.where(vis.any(dim=-1, keepdim=True), out, 0.0)
    out = out.reshape(b, hq, sq, d)
    if with_probs:
        return out, p127.reshape(b, hq, sq, sk)
    return out


def flash_attention_int8_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             q_offset: int = 0, sk_valid: int | None = None,
                             with_probs: bool = False):
    """The plain version of ``flash_attention_int8``: q (B, Hq, Sq, D) f32
    against int8 k/v (B, Hkv, Sk, D), the mask of :func:`visible`."""
    vis = visible(q.shape[2], k.shape[2], causal, q_offset, sk_valid,
                  q.device)
    return int8_attention_ref(q, k, v, vis[None, None, None],
                              with_probs=with_probs)


def decode_attention_int8_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              kv_len: torch.Tensor | None = None, *,
                              with_probs: bool = False):
    """The plain version of ``decode_attention_int8``: q (B, Hq, 1, D) f32
    against the first ``kv_len[b]`` rows of int8 k/v (B, Hkv, S, D) (all S
    when ``kv_len`` is None); a row with ``kv_len`` 0 is 0."""
    b, s = k.shape[0], k.shape[2]
    lens = (torch.full((b,), s, device=q.device) if kv_len is None
            else kv_len.to(q.device).long().clamp(0, s))
    vis = torch.arange(s, device=q.device)[None, :] < lens[:, None]
    return int8_attention_ref(q, k, v, vis[:, None, None, None, :],
                              with_probs=with_probs)
