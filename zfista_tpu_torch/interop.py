"""Carry problem data and solver state across from the JAX package.

The JAX package's LASSO params tuple and its solver ``State`` are numpy
arrays once fetched from the device (``jax.device_get``, or ``res.state``
of a solve).  These functions turn them into the port's tensors on an
explicit device and back, so a solve or a single step can be continued in
the port from where the JAX package left it.  Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from zfista_tpu_torch.core.solver import State, state_to_numpy

__all__ = ["lasso_params_from_numpy", "state_from_numpy", "state_to_numpy"]


def lasso_params_from_numpy(
    A: Any,
    b: Any,
    lam: Any,
    l2: Any = None,
    *,
    device: Any = "cpu",
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, ...]:
    """The port's ``Lasso`` params tuple ``(A, b, lam[, l2])`` on
    ``device``, for the params-style callables of
    :mod:`zfista_tpu_torch.models.lasso`.  ``dtype`` defaults to ``A``'s.
    The arrays are copied (arrays fetched from JAX are read-only)."""
    A_t = torch.tensor(np.asarray(A), dtype=dtype, device=device)
    rest = (b, lam) if l2 is None else (b, lam, l2)
    return (A_t,) + tuple(
        torch.tensor(np.asarray(v), dtype=A_t.dtype, device=device)
        for v in rest
    )


def state_from_numpy(state: Any, *, device: Any = "cpu") -> State:
    """The port's :class:`State` on ``device`` from any object with the
    JAX ``State``'s 12 fields as numpy arrays (dtypes kept, data copied)."""
    return State(
        *(
            torch.tensor(np.asarray(getattr(state, name)), device=device)
            for name in State._fields
        )
    )
