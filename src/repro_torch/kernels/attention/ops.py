"""Attention entry points.

Counterpart of ``repro/kernels/attention/ops.py``.  The reference's
``attention`` dispatches on ``use_pallas`` and has no caller; the port has
one rule for every kernel instead (the CUDA kernel on a CUDA tensor, the
plain version on a CPU tensor), so this module only re-exports K7's
wrappers and the oracle; ``lm/modules.py`` imports the wrappers from
``kernel.py``.
"""
from repro_torch.kernels.attention.kernel import (decode_attention,
                                                  flash_attention)
from repro_torch.kernels.attention.ref import attention_ref

__all__ = ["flash_attention", "decode_attention", "attention_ref"]
