"""train_step / serve_step factories for every architecture.

Port of ``repro/lm/steps.py``.  ``make_train_step``: cross-entropy LM loss
with microbatched gradient accumulation plus the AdamW update;
``make_prefill`` / ``make_serve_step`` / ``make_generate``: the inference
entry points over ``decode_step``.

Gradients come from autograd through the model: on the card every RMSNorm
and every attention of the forward is a kernel whose backward is a kernel
too (K6's and K7 flash's ``torch.autograd.Function``s), and the products
are ``torch.matmul`` in f32.  The reference's ``jax.jit`` has no
counterpart (PyTorch runs eagerly), its ``lax.scan`` over microbatches is
a loop, and ``constrain_mb`` (a GSPMD sharding hook) has none on one card.
Batches are dicts of numpy arrays or tensors and go to the parameters'
device here.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels.util import resolve_device
from repro_torch.lm.config import ArchConfig
from repro_torch.lm.model import (DecodeCache, _leaf_specs, _tree,
                                  decode_step, forward, load_params,
                                  params_from_numpy, with_views)
from repro_torch.train.optimizer import AdamW, AdamWState
from repro_torch.train.tree import leaves, tree_map, unflatten

#: batch fields that are integer indices (the rest are float32)
INT_FIELDS = ("tokens", "labels", "positions3")


def batch_to(batch: dict, device: torch.device) -> dict:
    """``batch``'s arrays as tensors on ``device``: token ids, labels and
    M-RoPE positions int64, the rest float32."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
        out[k] = t.to(device=device, dtype=torch.int64 if k in INT_FIELDS
                      else torch.float32)
    return out


def lm_loss(params, cfg: ArchConfig, batch: dict,
            remat: bool = True) -> torch.Tensor:
    """Next-token cross entropy in f32 of the forward's logits
    (:func:`logits_loss`)."""
    logits = forward(params, cfg, batch["tokens"],
                     positions3=batch.get("positions3"),
                     enc_input=batch.get("enc_input"),
                     extra_embeds=batch.get("extra_embeds"), remat=remat)
    return logits_loss(logits, cfg, batch)


def logits_loss(logits: torch.Tensor, cfg: ArchConfig,
                batch: dict) -> torch.Tensor:
    """The cross entropy of ``logits`` (B, S, padded_vocab) against
    ``batch["labels"]``, in f32: the padded vocabulary masked to -1e30,
    the gold logit, the mask (default all ones)."""
    logits = logits.float()
    labels = batch["labels"]
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    # the gold logit: a gather (the reference's one-hot sum is there for
    # GSPMD's sharded vocabulary; the value is the same)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(logz)
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor


def loss_and_grads(params, cfg: ArchConfig, batch: dict,
                   remat: bool = True) -> tuple[torch.Tensor, dict]:
    """(loss, gradients) of :func:`lm_loss` at ``params``: the leaves are
    taken as fresh grad-requiring tensors sharing the parameters' storage
    (the parameters themselves stay plain tensors), and the gradients come
    back as a tree of the same structure, without views."""
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves(params)]
        loss = lm_loss(unflatten(params, live), cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), unflatten(tree_map(lambda p: p, params), grads)


def make_train_step(cfg: ArchConfig, optimizer: AdamW,
                    microbatches: int = 1, remat: bool = True,
                    grad_dtype: torch.dtype | None = None):
    """Returns train_step(state, batch) -> (state, metrics).

    With microbatches > 1 the global batch is split along axis 0 and the
    gradients are accumulated in ``grad_dtype`` (default f32; bf16 is the
    reference's ``grads_bf16`` policy, which ``launch/dryrun.py``'s
    ``--grads-bf16`` asks for as the reference's dry run does: each
    microbatch's f32 gradient is cast to it and added, and the sum divided
    by the count in it), so the activations of only one microbatch are ever live; the
    optimizer takes the gradients in that dtype.  With one microbatch
    ``grad_dtype`` changes nothing, as in the reference.  ``remat``
    recomputes each layer in the backward pass.  The update is in place
    (``AdamW.apply``): the returned state holds the same parameter and
    moment tensors."""
    gdt = grad_dtype or torch.float32

    def train_step(state: TrainState, batch: dict):
        params = state.params
        first = leaves(params)[0]
        batch = batch_to(batch, first.device)
        if microbatches == 1:
            loss, grads = loss_and_grads(params, cfg, batch, remat)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            loss = torch.zeros((), device=first.device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=gdt,
                                                   device=p.device), params)
            size = b // microbatches
            for i in range(microbatches):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                l, g = loss_and_grads(params, cfg, mb, remat)
                loss = loss + l
                for acc, gi in zip(leaves(grads), leaves(g)):
                    acc.add_(gi.to(gdt))
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        lr = optimizer.schedule(state.opt.step)
        new_params, new_opt, gnorm = optimizer.apply(grads, state.opt, params)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def make_init_state(cfg: ArchConfig, optimizer: AdamW,
                    device: str | torch.device = "cuda"):
    """Returns init(seed) -> TrainState: ``load_params(cfg, seed)`` on
    ``device`` (the card by default), the optimizer's zero state, step 0.
    The reference takes a PRNG key and draws other numbers; its own state
    comes across with :func:`train_state_from_numpy`."""
    dev = resolve_device(device)

    def init(seed: int = 0) -> TrainState:
        params = load_params(cfg, seed, dev)
        return TrainState(params, optimizer.init(params),
                          torch.zeros((), dtype=torch.int32, device=dev))

    return init


def state_shapes(cfg: ArchConfig) -> TrainState:
    """A :class:`TrainState` of ``cfg`` whose leaves are ``meta`` tensors:
    the structure, shapes and dtypes a checkpoint restores into, with no
    memory behind it."""
    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs = _leaf_specs(cfg)
    params = with_views(_tree(specs, [meta(s) for _, s, _ in specs]))
    zeros = tree_map(lambda p: meta(p.shape), params)
    step = meta((), torch.int32)
    return TrainState(params, AdamWState(step, zeros,
                                         tree_map(lambda p: p, zeros)),
                      step)


def train_state_from_numpy(state, device: str | torch.device = "cuda"
                           ) -> TrainState:
    """The reference's ``TrainState`` (params, ``AdamWState(step, m, v)``,
    step), its leaves taken as numpy (e.g. ``jax.tree.map(np.asarray,
    state)``), as the port's on ``device``."""
    dev = resolve_device(device)

    def to(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    def step(a):
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32,
                            device=dev)

    opt = state.opt
    return TrainState(params_from_numpy(state.params, dev),
                      AdamWState(step(opt.step), tree_map(to, opt.m),
                                 tree_map(to, opt.v)),
                      step(state.step))


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------
def make_prefill(cfg: ArchConfig):
    """prefill(params, tokens, cache) -> (last-token logits, filled cache):
    the whole prompt as one ``decode_step`` of length S.  Whisper's cross
    K/V are in the cache already (``init_cache``), so ``enc_input`` is not
    read, as in the reference."""

    @torch.no_grad()
    def prefill(params, tokens, cache: DecodeCache, positions3=None,
                enc_input=None):
        logits, cache = decode_step(params, cfg, tokens, cache,
                                    positions3=positions3)
        return logits[:, -1:], cache

    return prefill


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, token, cache) -> (logits, next token, cache):
    one new token, greedy."""

    @torch.no_grad()
    def serve_step(params, token, cache: DecodeCache, positions3=None):
        logits, cache = decode_step(params, cfg, token, cache,
                                    positions3=positions3)
        next_token = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
        return logits, next_token, cache

    return serve_step


def make_generate(cfg: ArchConfig, steps: int):
    """generate(params, prompt, cache) -> (tokens (B, steps), cache):
    greedy decoding, the prefill's token first (the reference's scan as a
    loop)."""
    serve = make_serve_step(cfg)
    prefill = make_prefill(cfg)

    @torch.no_grad()
    def generate(params, prompt_tokens, cache: DecodeCache):
        logits, cache = prefill(params, prompt_tokens, cache)
        tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
        toks = []
        for _ in range(steps):
            toks.append(tok[:, 0])
            _, tok, cache = serve(params, tok, cache)
        return torch.stack(toks, dim=1), cache

    return generate
