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
- ``masked_decode_ref``: the reference's ragged-decode fallback;
- ``decode_attention_ref``: the plain version of the decode kernel, the
  mask built from the per-row ``kv_len``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
BLOCK_K = 64          # the flash kernel's key tile


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        sk_valid: int | None = None) -> torch.Tensor:
    """Online-softmax GQA attention over 64-key tiles.

    q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D).  Key position kp is visible to
    query row i when kp < min(Sk, sk_valid) and, if causal,
    kp <= q_offset + i.  A row that sees no key is 0."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    kv_end = sk if sk_valid is None else max(0, min(sk, sk_valid))
    n_keys = min(kv_end, max(q_offset + sq, 0)) if causal else kv_end
    # the group's heads stacked as rows: (B, Hkv, G*Sq, D), no KV copies
    qg = q.float().reshape(b, hkv, g * sq, d)
    qpos = q_offset + torch.arange(sq, device=q.device).repeat(g)
    m = torch.full((b, hkv, g * sq, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, hkv, g * sq, 1), device=q.device)
    acc = torch.zeros((b, hkv, g * sq, d), device=q.device)
    for k0 in range(0, n_keys, BLOCK_K):
        k1 = min(k0 + BLOCK_K, kv_end)
        kt = k[:, :, k0:k1].float()
        vt = v[:, :, k0:k1].float()
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
    return out.reshape(b, hq, sq, d).to(q.dtype)


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
