"""The squeeze-and-excitation (SE) gate in two launches.

Wrappers of the hand-written CUDA kernels in ``csrc/se_gate.cu``, which
replace no TPU kernel: the TPU system serves no network with SE gates.
The source says what bounds them on an H100 (bytes) and how a cluster of
blocks an image pools the map and meets over distributed shared memory
for the two FCs.  :func:`se_gate` gives the gate (N, C) of an NHWC map;
:func:`se_scale` multiplies the map by it in place.  A call's cluster
size comes from the map's size alone (:func:`se_cluster`).

A CUDA tensor launches the kernel on the current stream (or raises); a
CPU tensor runs the plain version from ``ref.py`` (the scale then returns
a new tensor).  ``se_gate.launches`` and ``se_scale.launches`` count the
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.se.ref import se_gate_ref, se_scale_ref
from repro_torch.kernels.util import (cdiv, check_cuda_operands, counted,
                                      launch)

#: threads a block of the gate kernel, and its largest cluster
NT = 256
MAX_CLUSTER = 8
#: map floats a block of the gate pools, at least (a cluster is the fewest
#: blocks that keep each at or under this, up to ``MAX_CLUSTER``)
FLOATS_PER_BLOCK = 1 << 16


def se_cluster(hw: int, c: int) -> int:
    """Blocks that pool one image of ``hw`` pixels of ``c`` channels."""
    return max(1, min(MAX_CLUSTER, cdiv(hw * c, FLOATS_PER_BLOCK)))


def se_smem_floats(c: int, s: int) -> int:
    """The gate kernel's shared memory in floats (``gate_smem_floats``)."""
    return max(4 * NT, c) + 2 * c + max(NT, s) + 2 * s


def se_gate(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor | None,
            w2: torch.Tensor, b2: torch.Tensor | None) -> torch.Tensor:
    """The SE gate (N, C) of the NHWC map ``x`` (N, H, W, C):
    ``sigmoid(silu(mean_hw(x) @ w1 + b1) @ w2 + b2)``, w1 (C, S), w2
    (S, C)."""
    if x.dim() != 4 or w1.dim() != 2 or w2.dim() != 2 or \
            w1.shape[0] != x.shape[3] or tuple(w2.shape) != \
            (w1.shape[1], x.shape[3]):
        raise ValueError(f"se_gate: x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    n, h, wd, c = x.shape
    s = w1.shape[1]
    for name, b, size in (("b1", b1, s), ("b2", b2, c)):
        if b is not None and tuple(b.shape) != (size,):
            raise ValueError(f"se_gate: {name} {tuple(b.shape)}, expected "
                             f"({size},)")
    if x.device.type == "cpu":
        return se_gate_ref(x, w1, b1, w2, b2)
    check_cuda_operands("se_gate", x.device, x=x, w1=w1, b1=b1, w2=w2,
                        b2=b2)
    gate = torch.empty((n, c), device=x.device, dtype=torch.float32)
    vec = int(c % 4 == 0 and x.data_ptr() % 16 == 0)
    launch("repro_se_gate", x.device, x, w1, b1, w2, b2, gate, n, h * wd, c,
           s, se_cluster(h * wd, c), 4 * se_smem_floats(c, s), vec)
    se_gate.launches += 1
    return gate


counted(se_gate)


def se_scale(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """``x`` (N, H, W, C) times ``gate`` (N, C) per image and channel: in
    place on the card (returns ``x``), a new tensor on the CPU."""
    if x.dim() != 4 or tuple(gate.shape) != (x.shape[0], x.shape[3]):
        raise ValueError(f"se_scale: x {tuple(x.shape)}, gate "
                         f"{tuple(gate.shape)}")
    if x.device.type == "cpu":
        return se_scale_ref(x, gate)
    check_cuda_operands("se_scale", x.device, x=x, gate=gate)
    n, h, wd, c = x.shape
    vec = int(c % 4 == 0 and x.data_ptr() % 16 == 0
              and gate.data_ptr() % 16 == 0)
    launch("repro_se_scale", x.device, x, gate, n, h * wd, c, vec)
    se_scale.launches += 1
    return x


counted(se_scale)
