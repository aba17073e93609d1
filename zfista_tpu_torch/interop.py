"""Carry problem data and solver state across from the JAX package.

The JAX package's LASSO and TV-deblur params tuples, its TV dual fields
and its solver ``State`` are numpy arrays once fetched from the device
(``jax.device_get``, or ``res.state`` of a solve).  These functions turn
them into the port's tensors on a device (default ``"cuda"``, as the
port's other entry points: without a card that raises, and
``device="cpu"`` asks for the CPU) and back, so a solve,
a single step or a warm-started TV prox can be continued in the port from
where the JAX package left it; :func:`problem_from_spec` builds the port's
zoo problem matching a JAX one, and :func:`model_from_jax` the port's
``WaveletDeblur``, ``SparseLogistic`` or ``GroupLasso`` from a JAX
instance's data.  Nothing here imports JAX.
"""

from __future__ import annotations

import inspect
from typing import Any

import numpy as np
import torch

from zfista_tpu_torch.core.solver import State, data_device, state_to_numpy
from zfista_tpu_torch.models import zoo
from zfista_tpu_torch.models.base import Problem
from zfista_tpu_torch.models.deblur import WaveletDeblur
from zfista_tpu_torch.models.lasso import GroupLasso
from zfista_tpu_torch.models.logistic import SparseLogistic

__all__ = [
    "dual_from_numpy",
    "lasso_params_from_numpy",
    "model_from_jax",
    "problem_from_spec",
    "state_from_numpy",
    "state_to_numpy",
    "tv_deblur_params_from_numpy",
]


def lasso_params_from_numpy(
    A: Any,
    b: Any,
    lam: Any,
    l2: Any = None,
    *,
    device: Any = "cuda",
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, ...]:
    """The port's ``Lasso`` params tuple ``(A, b, lam[, l2])`` on
    ``device``, for the params-style callables of
    :mod:`zfista_tpu_torch.models.lasso`.  ``dtype`` defaults to ``A``'s.
    The arrays are copied (arrays fetched from JAX are read-only)."""
    device = data_device(device)
    A_t = torch.tensor(np.asarray(A), dtype=dtype, device=device)
    rest = (b, lam) if l2 is None else (b, lam, l2)
    return (A_t,) + tuple(
        torch.tensor(np.asarray(v), dtype=A_t.dtype, device=device)
        for v in rest
    )


def state_from_numpy(state: Any, *, device: Any = "cuda") -> State:
    """The port's :class:`State` on ``device`` from any object with the
    JAX ``State``'s 12 fields as numpy arrays (dtypes kept, data copied):
    a single solve's, or a batch's with a leading lane axis on every field
    (the JAX ``BatchResult.state``, for ``initial_states``)."""
    device = data_device(device)
    return State(
        *(
            torch.tensor(np.asarray(getattr(state, name)), device=device)
            for name in State._fields
        )
    )


def tv_deblur_params_from_numpy(
    b: Any, *operands: Any, device: Any = "cuda", dtype: torch.dtype | None = None
) -> tuple[torch.Tensor, ...]:
    """The port's ``TVDeblur`` params tuple on ``device``: ``(b, Gr, Gc,
    lam)`` for a separable blur or ``(b, K, lam)`` for a correlation
    kernel, the layout of the JAX ``TVDeblur._params`` and of the
    callables of :mod:`zfista_tpu_torch.models.deblur`.  ``dtype`` defaults
    to ``b``'s.  The arrays are copied."""
    if len(operands) not in (2, 3):
        raise ValueError(
            "expected (b, Gr, Gc, lam) or (b, K, lam); got b and "
            f"{len(operands)} more"
        )
    device = data_device(device)
    b_t = torch.tensor(np.asarray(b), dtype=dtype, device=device)
    return (b_t,) + tuple(
        torch.tensor(np.asarray(v), dtype=b_t.dtype, device=device)
        for v in operands
    )


def dual_from_numpy(
    p: Any, q: Any, *, device: Any = "cuda"
) -> tuple[torch.Tensor, torch.Tensor]:
    """A TV dual field ``(p, q)`` (e.g. the JAX ``prox_tv(...,
    return_dual=True)`` one) as tensors on ``device``, for
    ``prox_tv(..., dual0=...)``.  Dtypes kept, data copied."""
    device = data_device(device)
    return (
        torch.tensor(np.asarray(p), device=device),
        torch.tensor(np.asarray(q), device=device),
    )


def problem_from_spec(problem: Any) -> Problem:
    """The port's zoo problem of the same class as ``problem`` (a
    :mod:`zfista_tpu.models.zoo` instance), built from its constructor
    arguments: ``n_features``, ``n_objectives``, the raw ``l1_ratios`` and
    ``l1_shifts`` as passed, and ``bounds``.  Reads attributes only.  The
    two problems have the same ``name``.

    Raises ``ValueError`` for a class the zoo does not have, or for
    attributes the class's constructor cannot reproduce (e.g. an SD with
    other bounds).
    """
    name = type(problem).__name__
    cls = getattr(zoo, name, None)
    if not (isinstance(cls, type) and issubclass(cls, Problem)):
        raise ValueError(f"no zoo problem named {name!r} in zfista_tpu_torch")
    spec = {
        "n_features": problem.n_features,
        "n_objectives": problem.n_objectives,
        "l1_ratios": problem._l1_ratios_raw,
        "l1_shifts": problem._l1_shifts_raw,
        "bounds": problem.bounds,
    }
    accepted = inspect.signature(cls).parameters
    out = cls(**{k: v for k, v in spec.items() if k in accepted})
    if out.name != getattr(problem, "name", out.name) or (
        out.n_objectives,
        out.n_features,
    ) != (problem.n_objectives, problem.n_features):
        raise ValueError(
            f"{name}'s constructor cannot reproduce {problem!r} (got {out!r})"
        )
    return out


def model_from_jax(model: Any, *, device: Any = "cuda") -> Any:
    """The port's ``WaveletDeblur``, ``SparseLogistic`` or ``GroupLasso``
    built from a JAX instance of the class of the same name: its arrays
    (``b``; ``A`` and ``y``; ``A`` and ``b``) through ``np.asarray`` onto
    ``device``, its ``kernel``, ``levels``, ``l1_ratio`` and ``group_size``
    as they are.  Reads attributes only; raises ``ValueError`` for any
    other class."""
    name = type(model).__name__
    device = data_device(device)

    def arr(v: Any) -> torch.Tensor:
        return torch.tensor(np.asarray(v), device=device)

    if name == "WaveletDeblur":
        return WaveletDeblur(
            arr(model.b), l1_ratio=model.l1_ratio, kernel=model.kernel, levels=model.levels
        )
    if name == "SparseLogistic":
        return SparseLogistic(arr(model.A), arr(model.y), l1_ratio=model.l1_ratio)
    if name == "GroupLasso":
        return GroupLasso(
            arr(model.A), arr(model.b), l1_ratio=model.l1_ratio, group_size=model.group_size
        )
    raise ValueError(f"model_from_jax: no port of {name!r}")
