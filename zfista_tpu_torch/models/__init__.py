"""Problems (PyTorch port): LASSO and TV-regularized deblurring."""

from zfista_tpu_torch.models.base import Problem
from zfista_tpu_torch.models.deblur import TVDeblur
from zfista_tpu_torch.models.lasso import Lasso

__all__ = ["Problem", "Lasso", "TVDeblur"]
