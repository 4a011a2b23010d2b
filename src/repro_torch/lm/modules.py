"""Transformer building blocks of the LMs.

Port of ``repro/lm/modules.py``: RoPE and Qwen2-VL's M-RoPE, the KV cache,
GQA attention, Whisper's cross-attention, the SwiGLU MLP and the MoE block
(shared experts and routed top-k experts), over plain dictionaries of
tensors with weights in the reference's (d_in, d_out) layout.  The
reference's ``rms_norm`` has no counterpart here: ``lm/model.py`` calls
K6's wrapper ``rmsnorm`` itself.

Where the reference calls the kernels' oracles (``rmsnorm_ref``, and XLA
einsums for attention), the port calls its kernels: every RMSNorm goes to
K6 and every attention to K7, flash for a block of queries and decode for
one new token.  On a CPU tensor each runs its plain version.  The
reference's sharding hints have no counterpart on one card, and its
``Q_CHUNK`` query blocking is dropped: the flash kernel bounds the score
memory itself.  The projections stay ``torch.matmul`` in f32; the entry
points keep TF32 off (``torch.backends.cuda.matmul.allow_tf32``, PyTorch's
default), so the card computes them in full f32 as XLA does on the CPU.

The KV cache is written in place.  A block of S > 1 tokens (a prefill or
a chunk) goes into the cache rows at the host offset ``cache_pos`` with one
copy, and attention reads the cache cut to its filled prefix without
copying it.  One token (S == 1, the serve step) follows the reference's
shape-static decode: ``cache_pos`` is then a :class:`DecodePosition` made
once a step from the device position, the new k/v go in with an indexed
copy at that position (the counterpart of ``dynamic_update_slice``), and
K7 decode runs over the whole cache with ``kv_len = position + 1``, so a
decode step has the same shapes at every position and can be captured
once and replayed.

An int8 cache (``init_cache(kv_dtype=torch.int8)``, the reference's
static-scale KV quantization) stores ``quantize_kv(k)`` and
``quantize_kv(v)`` in both branches, and its attention goes to the int8
kernels (``flash_attention_int8`` at the host offset,
``decode_attention_int8`` at a :class:`DecodePosition`), whose dots are
int8 x int8 -> s32 as the reference's: no f32 copy of the cache is made.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.attention.kernel import (decode_attention,
                                                  decode_attention_int8,
                                                  flash_attention,
                                                  flash_attention_int8)
# the reference's names of the int8 cache's scales, kept here with it
from repro_torch.kernels.attention.ref import (  # noqa: F401
    KV_SCALE, P_SCALE, Q_SCALE)


# --------------------------------------------------------------------------
# Rotary embeddings
# --------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin (..., S, d_head//2) f32."""
    half = d_head // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, D); cos/sin: (B, S, D//2) or (S, D//2)."""
    if cos.dim() == 2:
        cos = cos[None]
        sin = sin[None]
    cos = cos[:, None]          # (B, 1, S, D/2)
    sin = sin[:, None]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_freqs(d_head: int, theta: float, positions3: torch.Tensor,
                sections: tuple[int, ...]
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL's M-RoPE: positions3 (B, 3, S) int (t/h/w); the d_head//2
    rotary frequencies are split into ``sections`` bands, each driven by
    one position stream -> cos/sin (B, S, d_head//2) f32.  With three
    equal streams it gives :func:`rope_freqs`'s values, bit for bit."""
    half = d_head // 2
    if sum(sections) != half:
        raise ValueError(f"mrope_freqs: sections {sections} do not sum to "
                         f"{half}")
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=positions3.device) / half))
    cos_parts, sin_parts = [], []
    start = 0
    for band, sec in enumerate(sections):
        pos = positions3[:, band].to(torch.float32)             # (B, S)
        ang = pos[..., None] * inv[start:start + sec]           # (B, S, sec)
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        start += sec
    return torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)


def rotary(cfg, positions: torch.Tensor,
           positions3: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (cos, sin) a block of ``cfg`` rotates q and k by: M-RoPE of
    ``positions3`` where ``cfg.mrope`` and they are given, else RoPE of
    ``positions`` (the reference's choice in ``gqa_attention``)."""
    if cfg.mrope and positions3 is not None:
        return mrope_freqs(cfg.d_head, cfg.rope_theta, positions3,
                           cfg.mrope_sections)
    return rope_freqs(cfg.d_head, cfg.rope_theta, positions)


# --------------------------------------------------------------------------
# Attention (GQA, optional bias, optional KV cache)
# --------------------------------------------------------------------------
class KVCache(NamedTuple):
    """One layer's cache: k and v (B, Hkv, S_max, Dh)."""

    k: torch.Tensor
    v: torch.Tensor


class DecodePosition(NamedTuple):
    """One decode step's position on the card, for every layer: ``at``
    (1,) int64, the cache row the new k/v go to, and ``kv_len`` (B,) int32,
    the keys each row attends to (``at + 1``)."""

    at: torch.Tensor
    kv_len: torch.Tensor


def quantize_kv(x: torch.Tensor) -> torch.Tensor:
    """x as the int8 cache stores it: clip(round(x * KV_SCALE), -127, 127),
    rounding half to even as ``jnp.round``."""
    return torch.clamp(torch.round(x.float() * KV_SCALE), -127,
                       127).to(torch.int8)


def decode_position(pos: torch.Tensor, batch: int) -> DecodePosition:
    """The :class:`DecodePosition` of the device int32 scalar ``pos``."""
    return DecodePosition(pos.reshape(1).long(),
                          (pos + 1).reshape(1).expand(batch).contiguous())


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, q_offset: int | None = None
                     ) -> torch.Tensor:
    """GQA attention of q (B, Hq, Sq, D) over k/v (B, Hkv, Sk, D): K7.

    ``q_offset`` positions the query block inside the key sequence (query
    row i at key ``q_offset + i``; default ``Sk - Sq``, the bottom-right
    alignment).  One query row goes to the decode kernel, which needs no
    mask when every key up to the row is visible: with a cache that is
    ``q_offset = Sk - 1``, the only case the model makes."""
    sq, sk = q.shape[2], k.shape[2]
    off = sk - sq if q_offset is None else q_offset
    q = q.contiguous()
    if sq == 1 and (not causal or off == sk - 1):
        return decode_attention(q, k, v)
    return flash_attention(q, k, v, causal=causal, q_offset=off)


def gqa_attention(params: dict, x: torch.Tensor, cfg,
                  positions: torch.Tensor,
                  cache: KVCache | None = None,
                  cache_pos: int | DecodePosition | None = None,
                  causal: bool = True,
                  rope: tuple[torch.Tensor, torch.Tensor] | None = None,
                  positions3: torch.Tensor | None = None):
    """Full attention block: qkv proj -> rope -> attention -> out proj.

    Returns (out, cache).  With a cache, the block's k/v are written in
    place at ``cache_pos``: a host int, and attention runs over the cache
    cut to ``cache_pos + S``; or, for one token, a
    :class:`DecodePosition`, and attention runs over the whole cache
    masked to its ``kv_len`` (module docstring).  q and k rotate by
    :func:`rotary` of ``positions`` and ``positions3``; ``rope`` passes
    that (cos, sin) when the caller has it already (one per forward, not
    per layer)."""
    b, s, _ = x.shape
    q = torch.matmul(x, params["wq"])
    k = torch.matmul(x, params["wk"])
    v = torch.matmul(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    cos, sin = rope if rope is not None else rotary(cfg, positions,
                                                    positions3)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    int8 = cache is not None and cache.k.dtype == torch.int8
    if int8:
        k, v = quantize_kv(k), quantize_kv(v)
    if cache is not None and isinstance(cache_pos, DecodePosition):
        if s != 1:
            raise ValueError(f"gqa_attention: a device position takes one "
                             f"token, got {s}")
        cache.k.index_copy_(2, cache_pos.at, k)
        cache.v.index_copy_(2, cache_pos.at, v)
        decode = decode_attention_int8 if int8 else decode_attention
        out = decode(q.contiguous(), cache.k, cache.v, cache_pos.kv_len)
    elif cache is not None:
        if cache_pos is None:
            raise ValueError("gqa_attention: a cache needs cache_pos")
        end = cache_pos + s
        cache.k[:, :, cache_pos:end] = k
        cache.v[:, :, cache_pos:end] = v
        ck, cv = cache.k[:, :, :end], cache.v[:, :, :end]
        if int8:
            out = flash_attention_int8(q.contiguous(), ck, cv, causal=causal,
                                       q_offset=cache_pos)
        else:
            out = attention_scores(q, ck, cv, causal=causal,
                                   q_offset=cache_pos)
    else:
        out = attention_scores(q, k.contiguous(), v.contiguous(),
                               causal=causal, q_offset=0)
    out = out.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return torch.matmul(out, params["wo"]), cache


def cross_kv(params: dict, memory: torch.Tensor, cfg
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Whisper's cross-attention keys and values of the encoder output
    ``memory`` (B, M, D): k and v (B, H, M, Dh)."""
    b, m, _ = memory.shape
    k = torch.matmul(memory, params["wk"]).reshape(
        b, m, cfg.n_heads, cfg.d_head).transpose(1, 2)
    v = torch.matmul(memory, params["wv"]).reshape(
        b, m, cfg.n_heads, cfg.d_head).transpose(1, 2)
    return k, v


def cross_attend(params: dict, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, cfg) -> torch.Tensor:
    """The queries of x (B, S, D) against cross keys and values k, v (B, H,
    M, Dh), no mask (K7: flash, or decode for one query row), then the
    output projection."""
    b, s, _ = x.shape
    q = torch.matmul(x, params["wq"]).reshape(
        b, s, cfg.n_heads, cfg.d_head).transpose(1, 2)
    out = attention_scores(q, k, v, causal=False, q_offset=0)
    out = out.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return torch.matmul(out, params["wo"])


def cross_attention(params: dict, x: torch.Tensor, memory: torch.Tensor,
                    cfg) -> torch.Tensor:
    """Whisper decoder cross-attention (memory = encoder output)."""
    k, v = cross_kv(params, memory, cfg)
    return cross_attend(params, x, k.contiguous(), v.contiguous(), cfg)


# --------------------------------------------------------------------------
# MLP (SwiGLU)
# --------------------------------------------------------------------------
def swiglu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """silu(x Wg) * (x Wu), then Wd."""
    gate = torch.nn.functional.silu(torch.matmul(x, params["wg"]))
    up = torch.matmul(x, params["wu"])
    return torch.matmul(gate * up, params["wd"])


# --------------------------------------------------------------------------
# MoE (shared experts, always on, and routed top-k experts)
# --------------------------------------------------------------------------
def _experts(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
             wd: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert: x (E, C, d) or (C, d) against (E, d, f),
    (E, d, f), (E, f, d) -> (E, C, d)."""
    gate = torch.nn.functional.silu(torch.matmul(x, wg))
    return torch.matmul(gate * torch.matmul(x, wu), wd)


def moe_block(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The reference's ``moe_block``: a softmax router picks ``moe_top_k``
    of ``moe_experts`` experts a token, the gates renormalised over the
    chosen (``clip(sum, 1e-9)``), plus ``moe_shared`` experts always on.

    The reference branches on the token count ``t`` of the call (batch x
    tokens), and so does the port:

    * dense (``t <= cfg.moe_dense_threshold``, decode): every expert runs
      on every token and the gates combine them; no token is dropped, and
      the shapes are static (no host sync), so a decode step captures.
    * scatter (prefill): each token's rank within its expert comes from a
      cumulative sum over the token-major (t*k, e) one-hot; up to ``cap =
      max(8, int(capacity_factor * t * k / e))`` tokens an expert go into
      an (e, cap, d) buffer, the experts run as one batched product, and
      each token gathers its k results weighted by its gates.  A token
      past its expert's capacity is dropped: it adds a zero row into slot
      ``cap - 1`` and gathers slot 0 with gate 0, as in the reference, so
      every kept slot sums exactly one token whatever the order of the
      adds.
    """
    b, s, d = x.shape
    t = b * s
    e, k = cfg.moe_experts, cfg.moe_top_k
    xt = x.reshape(t, d)
    probs = torch.softmax(torch.matmul(xt, params["router"]), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)                  # (t, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    if t <= cfg.moe_dense_threshold:
        y_all = _experts(xt, params["wg"], params["wu"], params["wd"])
        weights = torch.zeros((t, e), dtype=gate.dtype, device=x.device)
        weights.scatter_(1, idx, gate)                         # (t, e)
        out = torch.einsum("te,etd->td", weights, y_all)
    else:
        cap = max(8, int(cfg.moe_capacity_factor * t * k / e))
        flat = torch.zeros((t * k, e), dtype=torch.int64, device=x.device)
        flat.scatter_(1, idx.reshape(t * k, 1), 1)             # one-hot
        rank = torch.cumsum(flat, dim=0) - flat
        rank = (rank * flat).sum(-1).reshape(t, k)             # slot in expert
        keep = rank < cap
        gate = gate * keep
        slot = torch.where(keep, rank, cap - 1).reshape(-1)
        rows = (xt[:, None, :] * keep[..., None]).reshape(t * k, d)
        buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
        buf.index_put_((idx.reshape(-1), slot), rows, accumulate=True)
        y = _experts(buf, params["wg"], params["wu"], params["wd"])
        got = y[idx.reshape(-1), torch.where(keep, rank, 0).reshape(-1)]
        out = (got.reshape(t, k, d) * gate[..., None]).sum(dim=1)

    if cfg.moe_shared:
        sh = params["shared"]
        out = out + _experts(xt, sh["wg"], sh["wu"], sh["wd"]).sum(dim=0)
    return out.reshape(b, s, d).to(x.dtype)


def moe_aux_loss(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Load-balance auxiliary loss (Switch-style): the experts' count times
    the sum over experts of the share of tokens whose top-1 choice it is
    and its mean router probability.  No caller in the reference uses it;
    it is ported so that the module is whole."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs = torch.softmax(torch.matmul(xt, params["router"]).float(), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = torch.nn.functional.one_hot(top1, cfg.moe_experts).float().mean(0)
    imp = probs.mean(0)
    return cfg.moe_experts * torch.sum(frac * imp)
