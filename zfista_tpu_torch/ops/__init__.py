"""Proximal operators, the TV prox and the CUDA kernels (PyTorch port)."""

from zfista_tpu_torch.ops.fused import (
    fista_step_dense_fused,
    fused_prox_momentum,
    fused_prox_momentum_plain,
)
from zfista_tpu_torch.ops.prox import (
    make_wsum_shifted_l1_box_prox,
    project_box,
    project_simplex,
    prox_group_lasso,
    prox_l1,
    prox_shifted_l1,
    soft_threshold,
)
from zfista_tpu_torch.ops.tv import prox_tv, tv2d, tv_dual_gap

__all__ = [
    "soft_threshold",
    "prox_l1",
    "prox_shifted_l1",
    "project_box",
    "project_simplex",
    "make_wsum_shifted_l1_box_prox",
    "prox_group_lasso",
    "fused_prox_momentum",
    "fused_prox_momentum_plain",
    "fista_step_dense_fused",
    "prox_tv",
    "tv2d",
    "tv_dual_gap",
]
