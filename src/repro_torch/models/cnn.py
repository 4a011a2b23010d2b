"""End-to-end PyTorch forwards of the served CNNs.

Port of ``repro/models/cnn.py`` for the paper's three workloads, and the
port's own EfficientNet-B4 forward.  Every model is driven by its
``LayerGraph`` from ``repro_torch.models.zoo`` and executed as a step
program (``repro_torch.dualcore.program``): run in order here (the
sequential forward), or partitioned into the pipelined c/p groups of
``repro_torch.dualcore.runtime``.

Parameters are a plain dict ``{layer: {"w": tensor, "b": tensor}}`` in the
reference's layouts: HWIO for conv and fc, ``(Kh, Kw, C)`` for depthwise.
``init_params`` draws He-init weights from a seeded numpy generator (torch
cannot replay ``jax.random``); ``params_from_numpy`` carries a numpy
parameter dict, the reference's included, onto a device.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.graph import LayerGraph
from repro_torch.dualcore.program import build_program
from repro_torch.kernels.util import resolve_device
from repro_torch.models.zoo import get_graph

__all__ = ["FORWARDS", "build_model", "init_params", "params_from_numpy",
           "run_pipelined"]

Params = dict[str, dict[str, torch.Tensor]]
NumpyParams = dict[str, dict[str, np.ndarray]]


def init_params(graph: LayerGraph, seed: int = 0) -> NumpyParams:
    """He-init weights (zero biases) for every conv/dwconv/fc layer, as
    float32 numpy arrays drawn from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    params: NumpyParams = {}
    for l in graph.layers:
        if l.op == "dwconv":
            shape = (l.K_h, l.K_w, l.C_i)
            fan_in = l.K_h * l.K_w
        else:
            shape = (l.K_h, l.K_w, l.C_i, l.C_o)
            fan_in = l.K_h * l.K_w * l.C_i
        w = rng.standard_normal(shape) * (2.0 / fan_in) ** 0.5
        params[l.name] = {"w": w.astype(np.float32),
                          "b": np.zeros((l.C_o,), np.float32)}
    return params


def params_from_numpy(params, device: str | torch.device = "cuda") -> Params:
    """Carry a parameter dict of arrays (``{layer: {"w", "b"}}``, numpy or
    anything ``np.asarray`` takes, such as the reference's) onto ``device``
    as contiguous float32 tensors (copies), layouts unchanged."""
    dev = resolve_device(device)
    return {name: {k: torch.tensor(np.asarray(v, dtype=np.float32),
                                   device=dev)
                   for k, v in p.items()}
            for name, p in params.items()}


def _make_forward(name: str) -> Callable:
    def forward(params: Params, x: torch.Tensor, collect: dict | None = None,
                fuse: bool = False) -> torch.Tensor:
        return build_program(name, fuse=fuse).run(params, x, collect)

    forward.__name__ = f"{name}_forward"
    forward.__qualname__ = forward.__name__
    forward.__doc__ = (f"Sequential forward pass of {name} "
                       f"(step program in repro_torch.dualcore.program).")
    return forward


mobilenet_v1_forward = _make_forward("mobilenet_v1")
mobilenet_v2_forward = _make_forward("mobilenet_v2")
squeezenet_forward = _make_forward("squeezenet")
efficientnet_b4_forward = _make_forward("efficientnet_b4")

FORWARDS: dict[str, Callable] = {
    "mobilenet_v1": mobilenet_v1_forward,
    "mobilenet_v2": mobilenet_v2_forward,
    "squeezenet": squeezenet_forward,
    "efficientnet_b4": efficientnet_b4_forward,
}


def build_model(name: str, seed: int = 0,
                device: str | torch.device = "cuda"):
    """Return (params, forward_fn, graph) for one of the paper workloads,
    with seeded He-init weights on ``device`` (a card unless the caller
    passes ``device="cpu"``)."""
    dev = resolve_device(device)
    g = get_graph(name)
    return params_from_numpy(init_params(g, seed), dev), FORWARDS[name], g


def run_pipelined(name: str, params: Params, schedule, images, *,
                  device: str | torch.device = "cuda",
                  fuse: bool | str = "group", jit_groups: bool = True,
                  record: list | None = None) -> list[torch.Tensor]:
    """Execute ``schedule`` for real: pipeline ``images`` through the
    alternating c/p-core group chain with the paper's one-slot offset
    (Fig.4b) and return the per-image logits in submission order.  The
    reference's compatibility wrapper over
    ``repro_torch.dualcore.runtime.DualCoreRunner.run_pipelined``
    (continuous serving goes through ``repro_torch.serving``'s
    ``DualCoreEngine``); ``device`` takes the place of the reference's
    ``devices`` and ``use_pallas`` (the kernels run on the card, the plain
    versions on the CPU).  ``record=[]`` captures the execution trace."""
    from repro_torch.dualcore.runtime import DualCoreRunner

    runner = DualCoreRunner(name, params, schedule, device=device,
                            fuse=fuse, jit_groups=jit_groups)
    return runner.run_pipelined(images, record=record)
