"""Optimizers over trees of tensors: AdamW and SGD with momentum, with
global-norm clipping and a warmup-cosine schedule.

Port of ``repro/train/optimizer.py``, with the reference's formulas (not
``torch.optim``'s): the schedule is read at the step before the
increment and the bias corrections use the step after it; weight decay
goes inside the update on every leaf; clipping scales by ``clip_norm /
(gnorm + 1e-9)`` (at most 1); the norm returned is the one before
clipping.  The state's tensors live on the parameters' device, the step
a 0-dim int32 tensor there, so a step never waits on the host.

Where the reference returns new trees, ``apply`` updates the parameters
and the moments in place, under ``torch.no_grad()``: a full-size state
is three copies of the parameters (7.6 GB for Qwen2-0.5B), and in place
it needs a leaf's temporaries at most.  The per-layer views of a
parameter tree stay views of the updated leaves.  It returns the same
tensors, in the reference's tuple.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.train.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def _zeros(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _step0(params) -> torch.Tensor:
    first = leaves(params)
    dev = first[0].device if first else torch.device("cpu")
    return torch.zeros((), dtype=torch.int32, device=dev)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1

    def init(self, params) -> AdamWState:
        return AdamWState(step=_step0(params), m=_zeros(params),
                          v=_zeros(params))

    def schedule(self, step) -> torch.Tensor:
        """The learning rate at ``step`` (an int or an integer tensor), a
        float32 tensor on the step's device."""
        s = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp((s + 1) / max(1, self.warmup_steps), max=1.0)
        t = torch.clamp((s - self.warmup_steps)
                        / max(1, self.total_steps - self.warmup_steps),
                        0.0, 1.0)
        cos = self.min_lr_ratio + (1 - self.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return self.lr * warm * cos

    @torch.no_grad()
    def apply(self, grads, state: AdamWState, params):
        """One update of ``params`` (in place) by ``grads``; returns
        (params, the new state, the gradients' norm before clipping)."""
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        lr = self.schedule(state.step)
        bc1 = 1 - torch.pow(b1, step.to(torch.float32))
        bc2 = 1 - torch.pow(b2, step.to(torch.float32))
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                              leaves(state.v)):
            g = g.to(torch.float32) * scale
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).add_(torch.square(g), alpha=1 - b2)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u.add_(p.to(torch.float32), alpha=self.weight_decay)
            p.sub_((lr * u).to(p.dtype))
        return params, AdamWState(step, state.m, state.v), gnorm


class SGDMState(NamedTuple):
    step: torch.Tensor
    mom: Any


@dataclasses.dataclass(frozen=True)
class SGDM:
    lr: float = 0.1
    momentum: float = 0.9

    def init(self, params) -> SGDMState:
        return SGDMState(_step0(params), _zeros(params))

    @torch.no_grad()
    def apply(self, grads, state: SGDMState, params):
        """One update of ``params`` (in place); returns (params, the new
        state, the gradients' norm)."""
        for p, g, m in zip(leaves(params), leaves(grads), leaves(state.mom)):
            m.mul_(self.momentum).add_(g.to(torch.float32))
            p.sub_((self.lr * m).to(p.dtype))
        return params, SGDMState(state.step + 1, state.mom), global_norm(grads)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (leaf order)."""
    total = sum(torch.sum(torch.square(leaf.to(torch.float32)))
                for leaf in leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
