"""RMSNorm entry point.

Counterpart of ``repro/kernels/rmsnorm/ops.py``.  The reference dispatches
between its Pallas kernel and the jnp oracle with ``use_pallas``; the port
has one rule for every kernel instead (the CUDA kernel on a CUDA tensor,
the plain version on a CPU tensor), so this module only re-exports K6's
wrapper and the oracle; ``lm/model.py`` imports the wrapper from
``kernel.py``.
"""
from repro_torch.kernels.rmsnorm.kernel import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_ref"]
