"""SE gate entry point: the gate, then the scale (two launches on the
card, the plain versions on the CPU).  ``dualcore/program.py``'s SE step
calls :func:`squeeze_excite`."""
from __future__ import annotations

import torch

from repro_torch.kernels.se.kernel import se_gate, se_scale
from repro_torch.kernels.se.ref import se_gate_ref, se_scale_ref

__all__ = ["se_gate", "se_gate_ref", "se_scale", "se_scale_ref",
           "squeeze_excite", "squeeze_excite_ref"]


def squeeze_excite(x: torch.Tensor, w1: torch.Tensor,
                   b1: torch.Tensor | None, w2: torch.Tensor,
                   b2: torch.Tensor | None) -> torch.Tensor:
    """``x`` gated by its SE gate (in place on the card)."""
    return se_scale(x, se_gate(x, w1, b1, w2, b2))


def squeeze_excite_ref(x: torch.Tensor, w1: torch.Tensor,
                       b1: torch.Tensor | None, w2: torch.Tensor,
                       b2: torch.Tensor | None) -> torch.Tensor:
    """The plain version of :func:`squeeze_excite`, on any device."""
    return se_scale_ref(x, se_gate_ref(x, w1, b1, w2, b2))
