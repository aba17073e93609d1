"""Problems (PyTorch port): the LASSO model so far."""

from zfista_tpu_torch.models.base import Problem
from zfista_tpu_torch.models.lasso import Lasso

__all__ = ["Problem", "Lasso"]
