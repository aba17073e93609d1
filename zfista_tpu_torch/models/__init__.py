"""Problems (PyTorch port): the multiobjective zoo, LASSO and
TV-regularized deblurring."""

from zfista_tpu_torch.models.base import Problem
from zfista_tpu_torch.models.deblur import TVDeblur
from zfista_tpu_torch.models.lasso import Lasso
from zfista_tpu_torch.models.zoo import (
    FDS,
    JOS1,
    SD,
    TOI4,
    TRIDIA,
    ZDT1,
    LinearFunctionRank1,
)

__all__ = [
    "Problem",
    "JOS1",
    "SD",
    "FDS",
    "ZDT1",
    "TOI4",
    "TRIDIA",
    "LinearFunctionRank1",
    "Lasso",
    "TVDeblur",
]
