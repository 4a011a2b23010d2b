"""Model assembly for the dense and MoE transformers.

Port of the transformer branch of ``repro/lm/model.py``: ``init_params``
(seeded, from numpy), ``params_from_numpy``, ``forward`` and the decode
path (``DecodeCache``, ``init_cache``, ``decode_step``), for the dense
family and the MoE family (``lm/modules.py``'s ``moe_block`` in place of
the SwiGLU MLP).  Parameters keep the reference's stacked pytree (a
leading L axis on every block leaf), so the reference's own parameters
carry over as numpy.  The reference's layer scan and rematerialisation
become a Python loop over the layers.  ``load_params`` puts the same
parameters as ``params_from_numpy(init_params(...))`` on a device a chunk
at a time, for models whose weights the host should not hold at once.

SSM, hybrid, encoder-decoder and M-RoPE blocks raise
``NotImplementedError``: they are ROADMAP queue 1 item 6.4.
"""
from __future__ import annotations

import collections
import concurrent.futures
import itertools
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm
from repro_torch.kernels.util import resolve_device
from repro_torch.lm.config import ArchConfig
from repro_torch.lm.modules import (KVCache, decode_position, gqa_attention,
                                    moe_block, rope_freqs, swiglu_mlp)

INIT_SCALE = 0.02
#: elements of one seeded draw: chunk j of the i-th normal leaf (flat) is
#: drawn from its own stream, ``default_rng([seed, i, j])``, so chunks are
#: drawn on several host threads and the values do not depend on how many
DRAW_CHUNK = 1 << 22


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless the port can run ``cfg``."""
    if (cfg.block_type != "transformer"
            or cfg.family not in ("dense", "moe")
            or cfg.encoder_decoder or cfg.attn_every or cfg.mrope):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}, block {cfg.block_type!r} "
            f"is not in the port yet; the dense and MoE transformers are "
            f"(SSM, hybrid, encoder-decoder and M-RoPE are ROADMAP queue 1 "
            f"item 6.4)")


# ==========================================================================
# Parameters
# ==========================================================================
def _leaf_specs(cfg: ArchConfig) -> list[tuple[tuple[str, ...],
                                               tuple[int, ...], str]]:
    """(path, shape, init) of every parameter leaf, in tree order: the
    reference's leaves and shapes (its ``_moe_params`` for the MoE family,
    the shared experts with a leading s axis), block leaves with a leading
    L axis, and a separate ``lm_head`` (d_model, padded_vocab) as the
    reference keeps even for tied configs."""
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    specs = [(("embed",), (cfg.vocab, d), "normal"),
             (("final_norm",), (d,), "ones"),
             (("blocks", "ln1"), (L, d), "ones"),
             (("blocks", "ln2"), (L, d), "ones")]
    attn = [("wq", (L, d, cfg.q_dim)), ("wk", (L, d, cfg.kv_dim)),
            ("wv", (L, d, cfg.kv_dim)), ("wo", (L, cfg.q_dim, d))]
    specs += [(("blocks", "attn", k), shape, "normal") for k, shape in attn]
    if cfg.qkv_bias:
        specs += [(("blocks", "attn", k), (L, n), "zeros")
                  for k, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                               ("bv", cfg.kv_dim))]
    mlp = ("blocks", "mlp")
    if cfg.family == "moe":
        e, sh = cfg.moe_experts, cfg.moe_shared
        specs += [(mlp + ("router",), (L, d, e), "normal"),
                  (mlp + ("wg",), (L, e, d, f), "normal"),
                  (mlp + ("wu",), (L, e, d, f), "normal"),
                  (mlp + ("wd",), (L, e, f, d), "normal")]
        if sh:
            specs += [(mlp + ("shared", "wg"), (L, sh, d, f), "normal"),
                      (mlp + ("shared", "wu"), (L, sh, d, f), "normal"),
                      (mlp + ("shared", "wd"), (L, sh, f, d), "normal")]
    else:
        specs += [(mlp + ("wg",), (L, d, f), "normal"),
                  (mlp + ("wu",), (L, d, f), "normal"),
                  (mlp + ("wd",), (L, f, d), "normal")]
    specs.append((("lm_head",), (d, cfg.padded_vocab), "normal"))
    return specs


def _draw(seed: int, leaf: int, chunk: int, n: int) -> np.ndarray:
    """``n`` normal(0, INIT_SCALE) float32 draws of one chunk's stream."""
    a = np.random.default_rng([seed, leaf, chunk]).standard_normal(
        n, dtype=np.float32)
    a *= np.float32(INIT_SCALE)
    return a


def _chunks(specs, seed: int):
    """Yield ``(leaf, lo, hi), values`` for every chunk of every normal
    leaf, in order, drawn ahead on a pool of host threads (numpy draws
    without the GIL); at most two chunks a thread are held at once."""
    sizes = [math.prod(shape) if init == "normal" else 0
             for _, shape, init in specs]
    jobs = ((i, lo, min(n, lo + DRAW_CHUNK)) for i, n in enumerate(sizes)
            for lo in range(0, n, DRAW_CHUNK))
    workers = max(1, min(8, len(os.sched_getaffinity(0))))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        def submit(job):
            i, lo, hi = job
            return job, pool.submit(_draw, seed, i, lo // DRAW_CHUNK,
                                    hi - lo)

        pending = collections.deque(
            submit(j) for j in itertools.islice(jobs, 2 * workers))
        while pending:
            job, fut = pending.popleft()
            nxt = next(jobs, None)
            if nxt is not None:
                pending.append(submit(nxt))
            yield job, fut.result()


def _tree(specs, leaves) -> dict:
    out: dict = {}
    for (path, _, _), leaf in zip(specs, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def init_params(cfg: ArchConfig, seed: int = 0) -> dict:
    """Seeded parameters as numpy float32, in the reference's shapes
    (``_leaf_specs``): normal(0, INIT_SCALE) matrices drawn chunk by chunk
    (``DRAW_CHUNK``), unit norm scales and zero QKV biases."""
    check_supported(cfg)
    specs = _leaf_specs(cfg)
    make = {"normal": np.empty, "ones": np.ones, "zeros": np.zeros}
    leaves = [make[init](shape, np.float32) for _, shape, init in specs]
    for (i, lo, hi), values in _chunks(specs, seed):
        leaves[i].reshape(-1)[lo:hi] = values
    return _tree(specs, leaves)


def load_params(cfg: ArchConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """``params_from_numpy(init_params(cfg, seed), device)``, bit for bit,
    without the host holding the parameters: each chunk goes to ``device``
    as soon as it is drawn, so the host holds a few chunks at a time (a
    full-depth Qwen2.5-14B is 59 GB of float32).  ``device`` defaults to
    the card and raises without one."""
    check_supported(cfg)
    dev = resolve_device(device)
    specs = _leaf_specs(cfg)
    make = {"normal": torch.empty, "ones": torch.ones, "zeros": torch.zeros}
    leaves = [make[init](shape, dtype=torch.float32, device=dev)
              for _, shape, init in specs]
    for (i, lo, hi), values in _chunks(specs, seed):
        leaves[i].view(-1)[lo:hi].copy_(torch.from_numpy(values))
    out = _tree(specs, leaves)
    out["layers"] = _layer_views(out["blocks"])
    return out


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
    inner = rmsnorm(x, lp["ln2"], eps=eps)
    if cfg.family == "moe":
        return x + moe_block(lp["mlp"], inner, cfg)
    return x + swiglu_mlp(lp["mlp"], inner)


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
