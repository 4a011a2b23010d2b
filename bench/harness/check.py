"""The output check: the logits the timed path served, against the plain
reference over the same weights and images.

The number compared, ``logit_err``, is the widest gap over the sampled
requests' images between a served logit and the reference's, measured
against the root mean square of that image's reference logits.  Its limit
is the configuration's (``limits.logit_err``), set from the program's
readings over many seeds and from the control's: the reference itself
computed in TF32 (``precision="tf32"``).

The reference's forward is the configuration's reference module's own
``forward`` where it defines one, else ``plain.forward``: resolved here
alone, by :func:`forward_of`, and handed to :func:`reference_logits` and
:func:`check` by their callers."""
from __future__ import annotations

import math
from collections.abc import Callable
from types import ModuleType

import torch

from bench.reference import plain
from bench.reference.plain import Entry

#: a reference's ``forward(table, params, x, precision)``: logits
#: ``(N, classes)`` of NHWC images, with ``plain.forward``'s contract
Forward = Callable[..., torch.Tensor]


def forward_of(reference: ModuleType) -> Forward:
    """The forward of the reference module ``reference``: its own
    ``forward`` where it defines one, else ``plain.forward``."""
    return getattr(reference, "forward", plain.forward)


def logit_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest |out - ref| of an image over the RMS of its ``ref`` row
    (inf if ``out`` has the wrong shape or a value that is not finite)."""
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        return math.inf
    rms = ref.pow(2).mean(dim=1).sqrt().clamp_min(1e-30)
    return float(((out.float() - ref).abs().amax(dim=1) / rms).max())


def reference_logits(forward: Forward, table: list[Entry], params: dict,
                     pool: torch.Tensor, indices, precision: str = "f32"
                     ) -> dict[int, torch.Tensor]:
    """``forward``'s logits of each pool batch in ``indices``, one batch
    at a time."""
    with torch.no_grad():
        return {i: forward(table, params, pool[i], precision)
                for i in sorted(set(indices))}


def check(kept: list[tuple[int, torch.Tensor]], forward: Forward,
          table: list[Entry], params: dict, pool: torch.Tensor) -> float:
    """``logit_err`` over the kept ``(pool index, served logits)``
    pairs against ``forward`` (inf if none was kept)."""
    if not kept:
        return math.inf
    refs = reference_logits(forward, table, params, pool,
                            [i for i, _ in kept])
    return max(logit_err(out, refs[i]) for i, out in kept)
