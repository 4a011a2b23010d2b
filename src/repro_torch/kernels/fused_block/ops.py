"""Dispatch wrappers for the fused MobileNet-block kernels.

Counterpart of ``repro/kernels/fused_block/ops.py``.  The CUDA kernel uses
fixed tiles, so the reference's block-shape choice has no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_block.kernel import fused_dw_pw_conv


def fused_dw_pw(x: torch.Tensor, dw_w: torch.Tensor, dw_b,
                pw_w: torch.Tensor, pw_b, residual=None, *, stride: int = 1,
                pad: int = 1, dw_act: str | None = "relu6",
                pw_act: str | None = None) -> torch.Tensor:
    """dw(KhxKw) -> pw(1x1) fused block.  pw_w: (C,Co)."""
    return fused_dw_pw_conv(x, dw_w, dw_b, pw_w, pw_b, residual,
                            stride=stride, pad=pad, dw_act=dw_act,
                            pw_act=pw_act)


def fused_inverted_residual(*args, **kwargs) -> torch.Tensor:
    """pw-expand -> dw -> pw-project in one launch: the TPU kernel
    ``repro/kernels/fused_block/kernel.py::fused_pw_dw_pw_conv`` (K5).

    Not ported yet, and never replaced by unfused steps: it raises."""
    raise NotImplementedError(
        "fused_inverted_residual needs K5 (fused_pw_dw_pw_conv), which is "
        "not ported yet (ROADMAP.md, queue 2, K5); run with fuse=False, "
        "or with fuse='group' on a plan whose groups hold no pw->dw->pw "
        "chain (MobileNet v2 under 'balanced')")
