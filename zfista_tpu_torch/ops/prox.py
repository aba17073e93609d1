r"""Proximal operators as plain functions on tensors.

PyTorch-port counterpart of :mod:`zfista_tpu.ops.prox`: the soft-threshold
(the LASSO prox), the shifted-L1 prox, the box and simplex projections,
the reference's weighted-sum prox of shifted-L1 terms plus a box, and the
group-lasso prox.

Every max/min that can tie is ``torch.maximum``/``torch.minimum`` (not
``clamp``): at a tie their derivative splits 1/2-1/2 in forward and
reverse mode alike, as ``jnp.maximum``'s does, so ``torch.func`` through
a prox gives the m>=3 dual's Newton solver the same generalized Hessian
as ``jax.jacfwd`` (``clamp``'s derivative is 1 at its bound, another
valid Clarke element that sends Newton down another path).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from zfista_tpu_torch._typing import Array, ArrayLike
from zfista_tpu_torch.ops.precision import lane_sum


class DeviceConstants:
    """Host float64 arrays, copied once per ``(dtype, device)`` and kept.

    A per-call ``torch.as_tensor(array, device=x.device)`` would be one
    synchronous host-to-device copy inside every ``f``, ``g`` and prox
    call.  The host copies stay float64, so a tensor is always rounded
    once, from the exact value, to the dtype it is used in.
    """

    def __init__(self, **arrays: Any) -> None:
        self._host = {k: np.asarray(v, np.float64) for k, v in arrays.items()}
        self._cache: dict[tuple, dict[str, Array]] = {}

    def on(self, like: Array) -> dict[str, Array]:
        """The arrays as tensors of ``like``'s dtype, on its device."""
        key = (like.dtype, like.device)
        out = self._cache.get(key)
        if out is None:
            out = self._cache[key] = {
                k: torch.as_tensor(v, dtype=like.dtype, device=like.device)
                for k, v in self._host.items()
            }
        return out


_ZERO = DeviceConstants(zero=0.0)


def soft_threshold(x: Array, thresh: ArrayLike) -> Array:
    r"""Soft-thresholding: :math:`\mathrm{prox}_{t\|\cdot\|_1}(x)`.

    Elementwise ``sign(x) * max(|x| - thresh, 0)``.  ``thresh`` broadcasts.
    """
    return torch.sign(x) * torch.maximum(torch.abs(x) - thresh, _ZERO.on(x)["zero"])


# Alias with the jaxopt naming (``prox_lasso(x, l1reg)``), as in the JAX
# package, so problem definitions read like the literature.
def prox_l1(x: Array, scale: ArrayLike) -> Array:
    r"""Prox of ``scale * ||x||_1`` (a.k.a. ``prox_lasso``)."""
    return soft_threshold(x, scale)


def prox_shifted_l1(x: Array, scale: ArrayLike, shift: ArrayLike) -> Array:
    r"""Prox of ``scale * ||x - shift||_1``: shift, soft-threshold, unshift."""
    return soft_threshold(x - shift, scale) + shift


def project_box(x: Array, lower: ArrayLike, upper: ArrayLike) -> Array:
    r"""Euclidean projection onto the box ``[lower, upper]`` (broadcasts).

    ``jnp.clip``'s order: ``min(upper, max(lower, x))``."""
    def as_t(v):
        return torch.as_tensor(v, dtype=x.dtype, device=x.device)

    return torch.minimum(as_t(upper), torch.maximum(as_t(lower), x))


def project_simplex(v: Array) -> Array:
    r"""Euclidean projection of ``v`` (shape ``(..., m)``) onto the
    probability simplex, over the last dimension.

    Sort-based (Held/Wolfe/Crowder; Duchi et al. 2008): with
    ``u = sort(v, desc)`` find the largest ``rho`` with
    ``u_rho - (cumsum(u)_rho - 1)/rho > 0`` and threshold at
    ``theta = (cumsum(u)_rho - 1)/rho``.  Leading dimensions are a batch.
    """
    m = v.shape[-1]
    u = torch.flip(torch.sort(v, dim=-1).values, dims=(-1,))
    css = torch.cumsum(u, dim=-1) - 1.0
    idx = torch.arange(1, m + 1, dtype=v.dtype, device=v.device)
    cond = u - css / idx > 0
    # rho = number of True entries (cond is monotone non-increasing).
    count = torch.sum(cond, dim=-1)
    rho = count.to(v.dtype)
    rho_i = torch.clamp_min(count - 1, 0)
    theta = torch.gather(css, -1, rho_i[..., None])[..., 0] / torch.clamp_min(rho, 1.0)
    return torch.maximum(v - theta[..., None], _ZERO.on(v)["zero"])


def make_wsum_shifted_l1_box_prox(
    l1_ratios: ArrayLike | None,
    l1_shifts: ArrayLike | None,
    lower: float | None,
    upper: float | None,
):
    r"""Build ``prox_wsum_g(weight, x)`` for the reference's generic ``g``:
    ``g_i(x) = r_i * ||x - s_i||_1`` plus the indicator of a box.

    The prox of the weighted sum is the reference's sequential composition
    of per-objective shifted-L1 proxes finished by a box projection, as in
    :func:`zfista_tpu.ops.prox.make_wsum_shifted_l1_box_prox`, operation
    for operation.  That sequence is exact for a single unshifted L1 term.

    ⚠ Replicated reference quirk: the FIRST objective's shift is ignored
    (the reference computes ``prox_lasso(x + sum(coef[1:]) - s0 + s0,
    coef[0])``, a self-cancelling no-op).  Every reference benchmark
    problem has ``l1_shifts[0] == 0``; the quirk is kept for trajectory
    parity.

    ``weight`` is ``lr`` (scalar) for one objective or ``lr * w`` (shape
    ``(m,)``) otherwise.  ``l1_ratios``/``l1_shifts`` are host arrays
    (``None`` shifts mean all zero); they are kept as float64 on the host
    and copied once per ``(dtype, device)``.
    """
    consts = {}
    if l1_ratios is not None:
        ratios = np.atleast_1d(np.asarray(l1_ratios, np.float64))
        shifts = (
            np.zeros(ratios.shape)
            if l1_shifts is None
            else np.atleast_1d(np.asarray(l1_shifts, np.float64))
        )
        consts.update(ratios=ratios, shifts=shifts)
    box = lower is not None or upper is not None
    if box:
        consts.update(
            lo=-np.inf if lower is None else lower,
            hi=np.inf if upper is None else upper,
        )
    dc = DeviceConstants(**consts)

    def prox(weight: Any, x: Array) -> Array:
        c = dc.on(x)
        if l1_ratios is not None:
            coef = torch.atleast_1d(weight * c["ratios"])
            shifts = c["shifts"]
            # First term: the reference adds sum(coef[1:]) to x before the
            # first soft-threshold.
            x = soft_threshold(x + torch.sum(coef[1:]), coef[0])
            for i in range(1, coef.shape[0]):
                x = soft_threshold(x - coef[i] - shifts[i], coef[i]) + shifts[i]
        if box:
            x = torch.minimum(c["hi"], torch.maximum(c["lo"], x))
        return x

    return prox


def prox_group_lasso(x: Array, scale: ArrayLike, group_size: int) -> Array:
    r"""Prox of ``scale * sum_g ||x_g||_2`` for contiguous equal-size groups.

    Block soft-thresholding: each group ``v`` maps to
    ``v * max(1 - scale/||v||, 0)``.  ``group_size`` is static.  The
    norms sum in an order set by ``group_size`` alone
    (:func:`~zfista_tpu_torch.ops.precision.lane_sum`), so a group's
    result has the same bits whatever the groups or lanes beside it: in a
    whole vector, in a rank's block of it and in a lane of a batch.
    """
    n = x.shape[-1]
    if n % group_size:
        raise ValueError(f"n={n} not divisible by group_size={group_size}")
    v = x.reshape(*x.shape[:-1], n // group_size, group_size)
    return shrink_groups(v, lane_sum(v * v), scale).reshape(x.shape)


def shrink_groups(v: Array, sq: Array, scale: ArrayLike) -> Array:
    """Block soft-thresholding of the groups ``v (..., groups, size)``
    given their squared norms ``sq (..., groups)``: each group maps to
    ``v * max(1 - scale/||v||, 0)``."""
    norms = torch.sqrt(sq)[..., None]
    return v * torch.clamp_min(1.0 - scale / torch.clamp_min(norms, 1e-30), 0.0)
