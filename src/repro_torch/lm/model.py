"""Model assembly for the dense transformer.

Port of the transformer branch of ``repro/lm/model.py``: ``init_params``
(seeded, from numpy), ``params_from_numpy``, ``forward`` and the decode
path (``DecodeCache``, ``init_cache``, ``decode_step``).  Parameters keep
the reference's stacked pytree (a leading L axis on every block leaf), so
the reference's own parameters carry over as numpy.  The reference's
layer scan and rematerialisation become a Python loop over the layers.

Any other block type or family (MoE, SSM, hybrid, encoder-decoder,
M-RoPE) raises ``NotImplementedError``: it is ROADMAP queue 1 item 6.4.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm
from repro_torch.kernels.util import resolve_device
from repro_torch.lm.config import ArchConfig
from repro_torch.lm.modules import (KVCache, decode_position, gqa_attention,
                                    rope_freqs, swiglu_mlp)

INIT_SCALE = 0.02


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless the port can run ``cfg``."""
    if (cfg.block_type != "transformer" or cfg.family != "dense"
            or cfg.encoder_decoder or cfg.attn_every or cfg.mrope):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}, block {cfg.block_type!r} "
            f"is not in the port yet; only the dense transformer is "
            f"(MoE, SSM, hybrid, encoder-decoder and M-RoPE are ROADMAP "
            f"queue 1 item 6.4)")


# ==========================================================================
# Parameters
# ==========================================================================
def init_params(cfg: ArchConfig, seed: int = 0) -> dict:
    """Seeded parameters as numpy float32, in the reference's shapes:
    normal(0, INIT_SCALE) matrices, unit norm scales, zero QKV biases, and
    a separate ``lm_head`` (d_model, padded_vocab) as the reference keeps
    even for tied configs.  Block leaves carry a leading L axis."""
    check_supported(cfg)
    rng = np.random.default_rng(seed)
    L, d = cfg.n_layers, cfg.d_model

    def dense(*shape):
        return rng.standard_normal(shape, dtype=np.float32) \
            * np.float32(INIT_SCALE)

    attn = {"wq": dense(L, d, cfg.q_dim), "wk": dense(L, d, cfg.kv_dim),
            "wv": dense(L, d, cfg.kv_dim), "wo": dense(L, cfg.q_dim, d)}
    if cfg.qkv_bias:
        attn["bq"] = np.zeros((L, cfg.q_dim), np.float32)
        attn["bk"] = np.zeros((L, cfg.kv_dim), np.float32)
        attn["bv"] = np.zeros((L, cfg.kv_dim), np.float32)
    return {
        "embed": dense(cfg.vocab, d),
        "final_norm": np.ones((d,), np.float32),
        "blocks": {"ln1": np.ones((L, d), np.float32),
                   "ln2": np.ones((L, d), np.float32),
                   "attn": attn,
                   "mlp": {"wg": dense(L, d, cfg.d_ff),
                           "wu": dense(L, d, cfg.d_ff),
                           "wd": dense(L, cfg.d_ff, d)}},
        "lm_head": dense(d, cfg.padded_vocab),
    }


def _to_torch(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    a = np.require(np.asarray(tree, dtype=np.float32),
                   requirements=("C", "W"))      # a read-only input copies
    return torch.from_numpy(a).to(device)


def _layer_views(blocks: dict) -> list[dict]:
    """Per-layer views into the stacked block parameters."""
    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    return [pick(blocks, i) for i in range(blocks["ln1"].shape[0])]


def params_from_numpy(params: dict, device: str | torch.device = "cuda"
                      ) -> dict:
    """The stacked parameter tree (numpy, e.g. the reference's
    ``init_params`` through ``np.asarray``) as float32 tensors on
    ``device``, plus ``"layers"``: per-layer views into the stacked
    blocks, built once.  ``device`` defaults to the card and raises
    without one."""
    dev = resolve_device(device)
    out = {k: _to_torch(params[k], dev)
           for k in ("embed", "final_norm", "blocks", "lm_head")}
    out["layers"] = _layer_views(out["blocks"])
    return out


# ==========================================================================
# Forward (prefill without a cache)
# ==========================================================================
def _transformer_layer(lp, x, cfg, positions, rope, cache=None,
                       cache_pos=None):
    eps = cfg.norm_eps
    h, _ = gqa_attention(lp["attn"], rmsnorm(x, lp["ln1"], eps=eps), cfg,
                         positions, cache=cache, cache_pos=cache_pos,
                         rope=rope)
    x = x + h
    return x + swiglu_mlp(lp["mlp"], rmsnorm(x, lp["ln2"], eps=eps))


def forward(params: dict, cfg: ArchConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, padded_vocab).  ``params`` as
    ``params_from_numpy`` gives them."""
    check_supported(cfg)
    _, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, device=x.device)
    rope = rope_freqs(cfg.d_head, cfg.rope_theta, positions)
    for lp in params["layers"]:
        x = _transformer_layer(lp, x, cfg, positions, rope)
    x = rmsnorm(x, params["final_norm"], eps=cfg.norm_eps)
    return torch.matmul(x, params["lm_head"])


# ==========================================================================
# Decode (new tokens against a cache)
# ==========================================================================
class DecodeCache(NamedTuple):
    """The stacked KV cache and the number of positions already cached,
    twice: ``pos`` a host int (scheduling and bounds checks never wait on
    the card) and ``pos_dev`` the same count as a device int32 scalar
    (what a decode step reads, so its shapes do not change with the
    position, as the reference's traced ``pos``)."""

    kv_k: torch.Tensor          # (L, B, Hkv, S_max, Dh)
    kv_v: torch.Tensor
    pos: int
    pos_dev: torch.Tensor       # () int32, equal to pos


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> DecodeCache:
    """An empty cache for ``batch`` rows of up to ``max_len`` positions."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.d_head)
    return DecodeCache(torch.zeros(shape, device=dev),
                       torch.zeros(shape, device=dev), 0,
                       torch.zeros((), dtype=torch.int32, device=dev))


def decode_step(params: dict, cfg: ArchConfig, token: torch.Tensor,
                cache: DecodeCache, last_only: bool = False
                ) -> tuple[torch.Tensor, DecodeCache]:
    """token: (B, S), S >= 1 -> (logits (B, S, padded_vocab), cache).

    S == 1 is the serve step: it reads the position from ``cache.pos_dev``
    on the card (RoPE, the indexed k/v write, K7 decode over the whole
    cache with ``kv_len = pos + 1``), so its launches and shapes are the
    same at every position.  S > 1 is a (chunked) prefill at the host
    offset ``cache.pos`` (K7 flash at ``q_offset = cache.pos``).  The cache
    tensors are written in place; the returned cache shares them, with
    ``pos`` advanced by S and ``pos_dev`` a new scalar advanced by S.
    ``last_only`` computes the logits of the last position only (B, 1, V):
    what serving reads, without the LM head's product for every prompt
    token."""
    check_supported(cfg)
    _, s = token.shape
    pos = cache.pos
    if pos + s > cache.kv_k.shape[3]:
        raise ValueError(f"decode_step: {pos} cached + {s} new positions "
                         f"exceed the cache's {cache.kv_k.shape[3]}")
    x = params["embed"][token]
    if s == 1:
        positions = cache.pos_dev.reshape(1)
        at = decode_position(cache.pos_dev, token.shape[0])
    else:
        positions, at = torch.arange(pos, pos + s, device=x.device), pos
    rope = rope_freqs(cfg.d_head, cfg.rope_theta, positions)
    for i, lp in enumerate(params["layers"]):
        x = _transformer_layer(lp, x, cfg, positions, rope,
                               cache=KVCache(cache.kv_k[i], cache.kv_v[i]),
                               cache_pos=at)
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(x.contiguous(), params["final_norm"], eps=cfg.norm_eps)
    return torch.matmul(x, params["lm_head"]), cache._replace(
        pos=pos + s, pos_dev=cache.pos_dev + s)
