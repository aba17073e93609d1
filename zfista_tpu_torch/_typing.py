"""Shared type aliases for zfista_tpu_torch.

PyTorch counterpart of :mod:`zfista_tpu._typing`: the same aliases, over
``torch.Tensor`` instead of ``jax.Array``.
"""

from __future__ import annotations

from typing import Any, Callable, Union

import numpy as np
import torch

Array = torch.Tensor
ArrayLike = Union[torch.Tensor, np.ndarray, float, int]
Scalar = Union[float, torch.Tensor]

# f(x) -> (m,) objective values (scalar objectives are normalized to shape (1,)).
ObjectiveFn = Callable[[Array], Array]
# jac_f(x) -> (m, n) Jacobian.
JacobianFn = Callable[[Array], Array]
# prox_wsum_g(weight, x) -> (n,); `weight` is lr (scalar, m==1) or lr*w ((m,), m>1).
ProxFn = Callable[[Any, Array], Array]
