"""Model assembly for the reference's LM architectures.

Port of ``repro/lm/model.py``: ``init_params`` (seeded, from numpy),
``params_from_numpy``, ``forward``, ``encode`` and the decode path
(``DecodeCache``, ``init_cache``, ``decode_step``), for every family the
reference builds: dense and MoE transformers (``lm/modules.py``'s
``moe_block`` in place of the SwiGLU MLP), Qwen2-VL's M-RoPE transformer,
mLSTM (xLSTM) and Mamba2 stacks (``lm/ssm.py``), Zamba2's hybrid (a
weight-shared attention block after every ``attn_every``-th Mamba2 layer,
with a KV cache of its own for each application) and Whisper's
encoder-decoder (its decoder cross-attends to K/V projected once from the
encoder's output).  Parameters keep the reference's stacked pytree (a
leading L axis on every block leaf), so the reference's own parameters
carry over as numpy.  The reference's layer scans, ``lax.cond`` and
rematerialisation become Python loops and branches over the layers.
``load_params`` puts the same parameters as
``params_from_numpy(init_params(...))`` on a device a chunk at a time,
for models whose weights the host should not hold at once.
"""
from __future__ import annotations

import collections
import concurrent.futures
import functools
import itertools
import math
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.kernels.rmsnorm.kernel import rmsnorm
from repro_torch.kernels.util import resolve_device
from repro_torch.lm.config import ArchConfig
from repro_torch.lm.modules import (KVCache, cross_attend, cross_attention,
                                    cross_kv, decode_position, gqa_attention,
                                    moe_block, rotary, swiglu_mlp)
from repro_torch.lm.ssm import (SSMState, mamba2_block, mamba2_dims,
                                mlstm_block)

INIT_SCALE = 0.02
#: elements of one seeded draw: chunk j of the i-th normal leaf (flat) is
#: drawn from its own stream, ``default_rng([seed, i, j])``, so chunks are
#: drawn on several host threads and the values do not depend on how many
DRAW_CHUNK = 1 << 22


#: the block types the port runs, and the families over them
BLOCK_TYPES = ("transformer", "mamba2", "mlstm")
FAMILIES = ("dense", "moe", "hybrid", "audio", "vlm", "ssm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless the port can run ``cfg``: a
    transformer (dense or MoE, encoder-decoder, M-RoPE) or a Mamba2 or
    mLSTM stack (with a shared attention block every ``attn_every``
    layers), as the reference builds them."""
    if (cfg.block_type not in BLOCK_TYPES or cfg.family not in FAMILIES
            or (cfg.block_type != "transformer"
                and (cfg.family == "moe" or cfg.encoder_decoder))):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}, block {cfg.block_type!r} "
            f"is not an architecture of the reference")


# ==========================================================================
# Parameters
# ==========================================================================
Spec = tuple[tuple[str, ...], tuple[int, ...], str]


def _attn_specs(path: tuple[str, ...], lead: tuple[int, ...],
                cfg: ArchConfig, qkv_bias: bool) -> list[Spec]:
    d = cfg.d_model
    out = [(path + (k,), lead + shape, "normal")
           for k, shape in (("wq", (d, cfg.q_dim)), ("wk", (d, cfg.kv_dim)),
                            ("wv", (d, cfg.kv_dim)), ("wo", (cfg.q_dim, d)))]
    if qkv_bias:
        out += [(path + (k,), lead + (n,), "zeros")
                for k, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                             ("bv", cfg.kv_dim))]
    return out


def _mlp_specs(path: tuple[str, ...], lead: tuple[int, ...],
               cfg: ArchConfig) -> list[Spec]:
    d, f = cfg.d_model, cfg.d_ff
    return [(path + ("wg",), lead + (d, f), "normal"),
            (path + ("wu",), lead + (d, f), "normal"),
            (path + ("wd",), lead + (f, d), "normal")]


def _transformer_specs(path: tuple[str, ...], lead: tuple[int, ...],
                       cfg: ArchConfig, qkv_bias: bool,
                       moe: bool) -> list[Spec]:
    """A transformer block's leaves: norms, attention, then the MLP (the
    reference's ``_moe_params`` for the MoE family, the shared experts
    with a leading s axis)."""
    d, f = cfg.d_model, cfg.d_ff
    specs = [(path + ("ln1",), lead + (d,), "ones"),
             (path + ("ln2",), lead + (d,), "ones")]
    specs += _attn_specs(path + ("attn",), lead, cfg, qkv_bias)
    mlp = path + ("mlp",)
    if not moe:
        return specs + _mlp_specs(mlp, lead, cfg)
    e, sh = cfg.moe_experts, cfg.moe_shared
    specs += [(mlp + ("router",), lead + (d, e), "normal"),
              (mlp + ("wg",), lead + (e, d, f), "normal"),
              (mlp + ("wu",), lead + (e, d, f), "normal"),
              (mlp + ("wd",), lead + (e, f, d), "normal")]
    if sh:
        specs += [(mlp + ("shared", "wg"), lead + (sh, d, f), "normal"),
                  (mlp + ("shared", "wu"), lead + (sh, d, f), "normal"),
                  (mlp + ("shared", "wd"), lead + (sh, f, d), "normal")]
    return specs


def _ssm_specs(cfg: ArchConfig) -> list[Spec]:
    """The stacked leaves of a Mamba2 or mLSTM block (the reference's
    ``_block_params``; the convolution's weights at scale 0.2)."""
    L, d = cfg.n_layers, cfg.d_model
    blk = ("blocks",)
    specs = [(blk + ("ln",), (L, d), "ones")]
    if cfg.block_type == "mamba2":
        din, nh, _, ns = mamba2_dims(cfg)
        zdim = 2 * din + 2 * ns + nh
        return specs + [
            (blk + ("in_proj",), (L, d, zdim), "normal"),
            (blk + ("conv_w",), (L, cfg.ssm_conv, din + 2 * ns), "conv"),
            (blk + ("dt_bias",), (L, nh), "zeros"),
            (blk + ("a_log",), (L, nh), "zeros"),
            (blk + ("d_skip",), (L, din), "ones"),
            (blk + ("out_proj",), (L, din, d), "normal")]
    din, nh = cfg.d_inner, cfg.ssm_heads
    return specs + [(blk + (k,), (L, d, din), "normal")
                    for k in ("wq", "wk", "wv")] + [
        (blk + ("w_gates",), (L, d, 2 * nh), "normal"),
        (blk + ("wo",), (L, din, d), "normal")]


def _leaf_specs(cfg: ArchConfig) -> list[Spec]:
    """(path, shape, init) of every parameter leaf, in tree order: the
    reference's leaves and shapes, block leaves with a leading L axis, a
    separate ``lm_head`` (d_model, padded_vocab) as the reference keeps
    even for tied configs, then Zamba2's shared block and Whisper's
    encoder and cross-attention blocks."""
    L, d = cfg.n_layers, cfg.d_model
    specs = [(("embed",), (cfg.vocab, d), "normal"),
             (("final_norm",), (d,), "ones")]
    if cfg.block_type == "transformer":
        specs += _transformer_specs(("blocks",), (L,), cfg, cfg.qkv_bias,
                                    cfg.family == "moe")
    else:
        specs += _ssm_specs(cfg)
    specs.append((("lm_head",), (d, cfg.padded_vocab), "normal"))
    if cfg.attn_every:
        specs += _transformer_specs(("shared_attn",), (), cfg, cfg.qkv_bias,
                                    False)
    if cfg.encoder_decoder:
        specs += _transformer_specs(("enc_blocks",), (cfg.enc_layers,), cfg,
                                    False, False)
        specs += [(("enc_pos",), (cfg.enc_positions, d), "normal"),
                  (("enc_norm",), (d,), "ones"),
                  (("cross_blocks", "ln"), (L, d), "ones")]
        specs += _attn_specs(("cross_blocks", "attn"), (L,), cfg,
                             cfg.qkv_bias)
    return specs


#: the scale of each drawn init: normal(0, scale)
SCALES = {"normal": INIT_SCALE, "conv": 0.2}


def _draw(seed: int, leaf: int, chunk: int, n: int,
          scale: float) -> np.ndarray:
    """``n`` normal(0, scale) float32 draws of one chunk's stream."""
    a = np.random.default_rng([seed, leaf, chunk]).standard_normal(
        n, dtype=np.float32)
    a *= np.float32(scale)
    return a


def _chunks(specs, seed: int):
    """Yield ``(leaf, lo, hi), values`` for every chunk of every drawn
    leaf, in order, drawn ahead on a pool of host threads (numpy draws
    without the GIL); at most two chunks a thread are held at once."""
    sizes = [math.prod(shape) if init in SCALES else 0
             for _, shape, init in specs]
    jobs = ((i, lo, min(n, lo + DRAW_CHUNK)) for i, n in enumerate(sizes)
            for lo in range(0, n, DRAW_CHUNK))
    workers = max(1, min(8, len(os.sched_getaffinity(0))))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        def submit(job):
            i, lo, hi = job
            return job, pool.submit(_draw, seed, i, lo // DRAW_CHUNK,
                                    hi - lo, SCALES[specs[i][2]])

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
    (``_leaf_specs``): normal(0, INIT_SCALE) matrices (0.2 for Mamba2's
    convolution) drawn chunk by chunk (``DRAW_CHUNK``), unit norm scales
    and D skips, zero QKV biases, dt biases and A logs."""
    check_supported(cfg)
    specs = _leaf_specs(cfg)
    make = {"normal": np.empty, "conv": np.empty, "ones": np.ones,
            "zeros": np.zeros}
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
    make = {"normal": torch.empty, "conv": torch.empty, "ones": torch.ones,
            "zeros": torch.zeros}
    leaves = [make[init](shape, dtype=torch.float32, device=dev)
              for _, shape, init in specs]
    for (i, lo, hi), values in _chunks(specs, seed):
        leaves[i].view(-1)[lo:hi].copy_(torch.from_numpy(values))
    return with_views(_tree(specs, leaves))


def _to_torch(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    a = np.require(np.asarray(tree, dtype=np.float32),
                   requirements=("C", "W"))      # a read-only input copies
    return torch.from_numpy(a).to(device)


def _layer_views(blocks: dict) -> list[dict]:
    """Per-layer views into the stacked block parameters: each leaf
    unbound along its layer axis at once, so that in training its
    gradient is one stack of the layers' (indexing a layer at a time
    would add a zero-filled stacked gradient for every layer)."""
    def split(tree):
        if isinstance(tree, dict):
            return {k: split(v) for k, v in tree.items()}
        return tree.unbind(0)

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    parts = split(blocks)
    first = parts
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [pick(parts, i) for i in range(len(first))]


#: the stacked trees of a parameter tree and the key of their views
VIEWS = {"blocks": "layers", "enc_blocks": "enc_layers",
         "cross_blocks": "cross_layers"}


def with_views(out: dict) -> dict:
    """``out`` with the per-layer views of each of its stacked trees
    (``VIEWS``), made now, from the tensors ``out`` holds."""
    for stacked, views in VIEWS.items():
        if stacked in out:
            out[views] = _layer_views(out[stacked])
    return out


def params_from_numpy(params: dict, device: str | torch.device = "cuda"
                      ) -> dict:
    """The stacked parameter tree (numpy, e.g. the reference's
    ``init_params`` through ``np.asarray``) as float32 tensors on
    ``device``, plus per-layer views into each stacked tree, built once:
    ``"layers"`` into ``"blocks"``, and for Whisper ``"enc_layers"`` and
    ``"cross_layers"``.  ``device`` defaults to the card and raises
    without one."""
    dev = resolve_device(device)
    out = {k: _to_torch(v, dev) for k, v in params.items()
           if k not in VIEWS.values()}
    return with_views(out)


# ==========================================================================
# Forward (prefill without a cache)
# ==========================================================================
def _transformer_layer(lp, x, cfg, positions, rope, cache=None,
                       cache_pos=None, causal=True):
    eps = cfg.norm_eps
    h, _ = gqa_attention(lp["attn"], rmsnorm(x, lp["ln1"], eps=eps), cfg,
                         positions, cache=cache, cache_pos=cache_pos,
                         causal=causal, rope=rope)
    x = x + h
    inner = rmsnorm(x, lp["ln2"], eps=eps)
    if cfg.family == "moe":
        return x + moe_block(lp["mlp"], inner, cfg)
    return x + swiglu_mlp(lp["mlp"], inner)


def _ssm_layer(lp, x, cfg, state: SSMState | None = None):
    block = mamba2_block if cfg.block_type == "mamba2" else mlstm_block
    h, new_state = block(lp, rmsnorm(x, lp["ln"], eps=cfg.norm_eps), cfg,
                         state)
    return x + h, new_state


def _shared_attn_apply(sp, x, cfg, positions, rope, cache=None,
                       cache_pos=None):
    """Zamba2's weight-shared attention and MLP block."""
    eps = cfg.norm_eps
    h, _ = gqa_attention(sp["attn"], rmsnorm(x, sp["ln1"], eps=eps), cfg,
                         positions, cache=cache, cache_pos=cache_pos,
                         rope=rope)
    x = x + h
    return x + swiglu_mlp(sp["mlp"], rmsnorm(x, sp["ln2"], eps=eps))


def _shared_after(cfg: ArchConfig, li: int) -> bool:
    """True where the shared block follows layer ``li``."""
    return bool(cfg.attn_every) and (li + 1) % cfg.attn_every == 0


def encode(params: dict, cfg: ArchConfig,
           enc_input: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over precomputed frame embeddings (B, M, D) (the
    reference's stub of the convolutional front end): learned positions,
    ``enc_layers`` non-causal transformer layers, the final norm."""
    x = enc_input + params["enc_pos"][None, :enc_input.shape[1]]
    positions = torch.arange(x.shape[1], device=x.device)
    rope = rotary(cfg, positions)
    for lp in _layer_views(params["enc_blocks"]):
        x = _transformer_layer(lp, x, cfg, positions, rope, causal=False)
    return rmsnorm(x, params["enc_norm"], eps=cfg.norm_eps)


def _remat(fn, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``fn(x)``; with ``remat`` and autograd recording, its activations
    are not kept but recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant: the counterpart of the
    reference's ``jax.checkpoint`` around each layer).  A layer draws no
    random numbers, so the RNG state is not saved."""
    if not (remat and torch.is_grad_enabled()):
        return fn(x)
    return torch.utils.checkpoint.checkpoint(
        fn, x, use_reentrant=False, preserve_rng_state=False)


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            positions3: torch.Tensor | None = None,
            enc_input: torch.Tensor | None = None,
            extra_embeds: torch.Tensor | None = None,
            remat: bool = True) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, padded_vocab).  ``params`` as
    ``params_from_numpy`` gives them.  ``positions3`` (B, 3, S) drives
    M-RoPE (Qwen2-VL); ``enc_input`` (B, M, D) is Whisper's frame
    embeddings, which it needs; ``extra_embeds`` (B, n, D) is added to the
    first n token embeddings (the reference's stub of the vision front
    end's patches).

    The per-layer views are made here, from the stacked leaves as they
    are now, so a gradient reaches the stacked leaves (the views in
    ``params`` may predate the leaves' ``requires_grad``).  ``remat``
    recomputes each layer (Zamba2: with the shared block after it) in the
    backward pass instead of keeping its activations; it changes nothing
    where autograd is not recording.  The reference's two-level scan keeps
    fewer carries but computes the same numbers."""
    check_supported(cfg)
    _, s = tokens.shape
    # F.embedding: the same gather, with a backward that sums each row's
    # gradient in a fixed order (indexing's accumulates in any order)
    x = torch.nn.functional.embedding(tokens, params["embed"])
    if extra_embeds is not None:
        x[:, :extra_embeds.shape[1]] += extra_embeds.to(x.dtype)
    positions = torch.arange(s, device=x.device)
    rope = rotary(cfg, positions, positions3)
    layers = _layer_views(params["blocks"])
    if cfg.encoder_decoder:
        if enc_input is None:
            raise ValueError(f"{cfg.name}: the encoder-decoder forward "
                             f"needs enc_input")
        memory = encode(params, cfg, enc_input)
        eps = cfg.norm_eps

        def dec_layer(lp, cp, h):
            att, _ = gqa_attention(lp["attn"], rmsnorm(h, lp["ln1"], eps=eps),
                                   cfg, positions, rope=rope)
            h = h + att
            h = h + cross_attention(cp["attn"], rmsnorm(h, cp["ln"], eps=eps),
                                    memory, cfg)
            return h + swiglu_mlp(lp["mlp"], rmsnorm(h, lp["ln2"], eps=eps))

        for lp, cp in zip(layers, _layer_views(params["cross_blocks"])):
            x = _remat(functools.partial(dec_layer, lp, cp), x, remat)
    elif cfg.block_type == "transformer":
        for lp in layers:
            x = _remat(lambda h, lp=lp: _transformer_layer(
                lp, h, cfg, positions, rope), x, remat)
    else:                                     # mamba2 / mlstm / hybrid
        def ssm_layer(li, lp, h):
            h, _ = _ssm_layer(lp, h, cfg)
            if _shared_after(cfg, li):
                h = _shared_attn_apply(params["shared_attn"], h, cfg,
                                       positions, rope)
            return h

        for li, lp in enumerate(layers):
            x = _remat(functools.partial(ssm_layer, li, lp), x, remat)
    x = rmsnorm(x, params["final_norm"], eps=cfg.norm_eps)
    return torch.matmul(x, params["lm_head"])


# ==========================================================================
# Decode (new tokens against a cache)
# ==========================================================================
class DecodeCache(NamedTuple):
    """The decode state of every family (the reference's fields, a field
    the family lacks is None; batch on axis 1 of each), and the number of
    positions already cached, twice: ``pos`` a host int (scheduling and
    bounds checks never wait on the card) and ``pos_dev`` the same count
    as a device int32 scalar (what a decode step reads, so its shapes do
    not change with the position, as the reference's traced ``pos``)."""

    kv_k: torch.Tensor | None       # (L, B, Hkv, S_max, Dh)  transformers
    kv_v: torch.Tensor | None
    ssm: torch.Tensor | None        # (L, B, H, P, N)  Mamba2 / mLSTM
    conv: torch.Tensor | None       # (L, B, K-1, C)  Mamba2
    shared_k: torch.Tensor | None   # (n_apps, B, Hkv, S_max, Dh)  Zamba2
    shared_v: torch.Tensor | None
    cross_k: torch.Tensor | None    # (L, B, H, M, Dh)  Whisper
    cross_v: torch.Tensor | None
    pos: int
    pos_dev: torch.Tensor           # () int32, equal to pos


#: the fields of a :class:`DecodeCache` that hold rows (batch on axis 1)
ROW_FIELDS = DecodeCache._fields[:-2]


def cache_rows(cache: DecodeCache) -> dict[str, torch.Tensor]:
    """The non-None row fields of ``cache``, by name."""
    return {f: getattr(cache, f) for f in ROW_FIELDS
            if getattr(cache, f) is not None}


def rows_cache(rows: dict[str, torch.Tensor], pos: int,
               pos_dev: torch.Tensor) -> DecodeCache:
    """The :class:`DecodeCache` of ``rows`` (``cache_rows``'s dict)."""
    return DecodeCache(**{f: rows.get(f) for f in ROW_FIELDS}, pos=pos,
                       pos_dev=pos_dev)


def cache_capacity(cache: DecodeCache) -> int | None:
    """Positions the cache holds: its KV caches' length, None for a pure
    SSM stack (a state has no length)."""
    for kv in (cache.kv_k, cache.shared_k):
        if kv is not None:
            return kv.shape[3]
    return None


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda",
               memory: torch.Tensor | None = None,
               params: dict | None = None,
               kv_dtype: torch.dtype | None = None) -> DecodeCache:
    """An empty cache for ``batch`` rows of up to ``max_len`` positions.
    Whisper needs the encoder's output ``memory`` (B, M, D) and the
    ``params``: its cross-attention K/V are projected here, once.
    ``kv_dtype=torch.int8`` stores the transformer blocks' self-attention
    KV (``kv_k``, ``kv_v``; Whisper's decoder's too) quantized with the
    reference's static scale (``lm/modules.py`` ``quantize_kv``); every
    other field (Zamba2's shared caches, Whisper's cross K/V, the SSM
    states) stays float32, as in the reference."""
    check_supported(cfg)
    dev = resolve_device(device)
    L = cfg.n_layers

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    rows: dict[str, torch.Tensor] = {}
    if cfg.block_type == "transformer":
        shape = (L, batch, cfg.n_kv_heads, max_len, cfg.d_head)
        kvd = kv_dtype or torch.float32
        rows.update(kv_k=zeros(*shape, dtype=kvd),
                    kv_v=zeros(*shape, dtype=kvd))
    elif cfg.block_type == "mlstm":
        hp = cfg.d_inner // cfg.ssm_heads
        rows["ssm"] = zeros(L, batch, cfg.ssm_heads, hp + 1, hp)
    else:
        din, nh, hp, ns = mamba2_dims(cfg)
        rows.update(ssm=zeros(L, batch, nh, hp, ns),
                    conv=zeros(L, batch, cfg.ssm_conv - 1, din + 2 * ns))
    if cfg.attn_every:
        shape = (cfg.n_layers // cfg.attn_every, batch, cfg.n_kv_heads,
                 max_len, cfg.d_head)
        rows.update(shared_k=zeros(*shape), shared_v=zeros(*shape))
    if cfg.encoder_decoder:
        if memory is None or params is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder cache needs "
                             f"the encoder's memory and the params")
        kv = [cross_kv(cp["attn"], memory.to(dev), cfg)
              for cp in params["cross_layers"]]
        rows.update(cross_k=torch.stack([k for k, _ in kv]),
                    cross_v=torch.stack([v for _, v in kv]))
    return rows_cache(rows, 0, torch.zeros((), dtype=torch.int32,
                                           device=dev))


def decode_step(params: dict, cfg: ArchConfig, token: torch.Tensor,
                cache: DecodeCache, last_only: bool = False,
                positions3: torch.Tensor | None = None,
                extra_embeds: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, DecodeCache]:
    """token: (B, S), S >= 1 -> (logits (B, S, padded_vocab), cache).

    S == 1 is the serve step: it reads the position from ``cache.pos_dev``
    on the card (RoPE, the indexed k/v write, K7 decode over the whole
    cache with ``kv_len = pos + 1``), so its launches and shapes are the
    same at every position; an SSM layer steps its state once.  S > 1 is
    a (chunked) prefill at the host offset ``cache.pos`` (K7 flash at
    ``q_offset = cache.pos``; an SSM layer's chunked scan from its state).
    Every cache tensor is written in place; the returned cache shares
    them, with ``pos`` advanced by S and ``pos_dev`` a new scalar advanced
    by S.  Whisper's cross-attention reads the K/V ``init_cache``
    projected, unmasked.  ``positions3`` (B, 3, S) drives M-RoPE
    (Qwen2-VL), and ``extra_embeds`` (B, n, D) is added to the first n
    token embeddings of the call as in :func:`forward` (the port's
    addition: the reference's ``decode_step`` has no patches, so a
    prompt's image can reach the cache only through ``forward`` there).
    ``last_only`` computes the logits of the last position
    only (B, 1, V): what serving reads, without the LM head's product for
    every prompt token."""
    check_supported(cfg)
    b, s = token.shape
    pos = cache.pos
    cap = cache_capacity(cache)
    if cap is not None and pos + s > cap:
        raise ValueError(f"decode_step: {pos} cached + {s} new positions "
                         f"exceed the cache's {cap}")
    x = params["embed"][token]
    if extra_embeds is not None:
        x[:, :extra_embeds.shape[1]] += extra_embeds.to(x.dtype)
    if s == 1:
        positions = cache.pos_dev.reshape(1)
        at = decode_position(cache.pos_dev, b)
    else:
        positions, at = torch.arange(pos, pos + s, device=x.device), pos
    rope = rotary(cfg, positions, positions3)
    eps = cfg.norm_eps
    if cfg.encoder_decoder:
        for i, (lp, cp) in enumerate(zip(params["layers"],
                                         params["cross_layers"])):
            att, _ = gqa_attention(
                lp["attn"], rmsnorm(x, lp["ln1"], eps=eps), cfg, positions,
                cache=KVCache(cache.kv_k[i], cache.kv_v[i]), cache_pos=at,
                rope=rope)
            x = x + att
            x = x + cross_attend(cp["attn"], rmsnorm(x, cp["ln"], eps=eps),
                                 cache.cross_k[i], cache.cross_v[i], cfg)
            x = x + swiglu_mlp(lp["mlp"], rmsnorm(x, lp["ln2"], eps=eps))
    elif cfg.block_type == "transformer":
        for i, lp in enumerate(params["layers"]):
            x = _transformer_layer(lp, x, cfg, positions, rope,
                                   cache=KVCache(cache.kv_k[i],
                                                 cache.kv_v[i]),
                                   cache_pos=at)
    else:
        for i, lp in enumerate(params["layers"]):
            x, _ = _ssm_layer(lp, x, cfg, SSMState(
                cache.ssm[i], None if cache.conv is None else cache.conv[i]))
            if _shared_after(cfg, i):
                app = i // cfg.attn_every
                x = _shared_attn_apply(
                    params["shared_attn"], x, cfg, positions, rope,
                    cache=KVCache(cache.shared_k[app], cache.shared_v[app]),
                    cache_pos=at)
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(x.contiguous(), params["final_norm"], eps=eps)
    return torch.matmul(x, params["lm_head"]), cache._replace(
        pos=pos + s, pos_dev=cache.pos_dev + s)
