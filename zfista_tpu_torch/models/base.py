r"""Problem base class for composite optimization.

PyTorch-port counterpart of :mod:`zfista_tpu.models.base`.  This slice
ports the constructor fields that :class:`~zfista_tpu_torch.models.Lasso`
uses; the generic shifted-L1/box nonsmooth term, its prox and the ``solve``
entry points come with the problem zoo (ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class Problem:
    """Base class for problems ``F_i(x) = f_i(x) + g_i(x)``."""

    def __init__(
        self,
        n_features: int,
        n_objectives: int,
        l1_ratios: Sequence[float] | None = None,
    ) -> None:
        self.n_features = n_features
        self.n_objectives = n_objectives
        # Host float64 constants, cast to the tensors' dtype at use.
        self.l1_ratios = (
            None
            if l1_ratios is None
            else np.atleast_1d(np.asarray(l1_ratios, np.float64))
        )
        if l1_ratios is not None and self.l1_ratios.shape != (n_objectives,):
            raise ValueError(
                f"l1_ratios must have shape ({n_objectives},); "
                f"got {self.l1_ratios.shape}"
            )
