"""Proximal operators and the fused CUDA kernel (PyTorch port)."""

from zfista_tpu_torch.ops.fused import (
    fista_step_dense_fused,
    fused_prox_momentum,
    fused_prox_momentum_plain,
)
from zfista_tpu_torch.ops.prox import prox_l1, soft_threshold

__all__ = [
    "soft_threshold",
    "prox_l1",
    "fused_prox_momentum",
    "fused_prox_momentum_plain",
    "fista_step_dense_fused",
]
