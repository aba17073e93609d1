r"""The seven-problem benchmark zoo, on tensors.

PyTorch-port counterpart of :mod:`zfista_tpu.models.zoo`: the same
formulas, default sizes and box bounds, each with its analytic Jacobian
(tested against ``torch.func.jacfwd``).  The functions are vectorized and
free of Python branches on tensor values, so ``torch.func`` transforms run
through them.  Constants are host float64 arrays copied once per
``(dtype, device)``.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch

from zfista_tpu_torch._typing import Array
from zfista_tpu_torch.models.base import Problem
from zfista_tpu_torch.ops.precision import dot_hp
from zfista_tpu_torch.ops.prox import DeviceConstants

_dot = dot_hp

_SQRT2 = math.sqrt(2.0)


class JOS1(Problem):
    r"""Two convex quadratics: f1 = ||x||^2/n, f2 = ||x-2||^2/n.

    Jin, Olhofer & Sendhoff (GECCO'01).  Default n_features=5.
    """

    def __init__(
        self,
        n_features: int = 5,
        l1_ratios: Sequence[float] | None = None,
        l1_shifts: Sequence[float] | None = None,
        bounds: tuple[Any, Any] | None = None,
    ) -> None:
        super().__init__(n_features, 2, l1_ratios, l1_shifts, bounds)

    def f(self, x: Array) -> Array:
        n = self.n_features
        return torch.stack([_dot(x, x) / n, _dot(x - 2, x - 2) / n])

    def jac_f(self, x: Array) -> Array:
        n = self.n_features
        return torch.stack([2 * x / n, 2 * (x - 2) / n])


class SD(Problem):
    r"""Linear + reciprocal bi-objective (Stadler & Dauer 1992), n=4,
    bounds (1e-6, inf)."""

    _C1 = np.array([2.0, _SQRT2, _SQRT2, 1.0])
    _C2 = np.array([2.0, 2 * _SQRT2, 2 * _SQRT2, 2.0])

    def __init__(self) -> None:
        super().__init__(4, 2, bounds=(1e-6, math.inf))
        self._c = DeviceConstants(c1=self._C1, c2=self._C2)

    def f(self, x: Array) -> Array:
        c = self._c.on(x)
        return torch.stack([_dot(c["c1"], x), torch.sum(c["c2"] / x)])

    def jac_f(self, x: Array) -> Array:
        c = self._c.on(x)
        return torch.stack([c["c1"], -c["c2"] / x**2])


class FDS(Problem):
    r"""Three objectives: quartic / exp+quadratic / weighted negative-exp
    (Fliege, Grana Drummond & Svaiter, SIAM J. Optim. 2009), default n=10.
    """

    def __init__(
        self,
        n_features: int = 10,
        l1_ratios: Sequence[float] | None = None,
        l1_shifts: Sequence[float] | None = None,
        bounds: tuple[Any, Any] | None = None,
    ) -> None:
        super().__init__(n_features, 3, l1_ratios, l1_shifts, bounds)
        k = np.arange(1, n_features + 1)
        # k * (n - k + 1), the triangular convolution weights of f3
        self._c = DeviceConstants(k=k, conv=k * k[::-1])

    def f(self, x: Array) -> Array:
        n = self.n_features
        c = self._c.on(x)
        k = c["k"]
        f1 = _dot(k, (x - k) ** 4) / n**2
        f2 = torch.exp(torch.sum(x) / n) + _dot(x, x)
        f3 = _dot(c["conv"], torch.exp(-x)) / (n * (n + 1))
        return torch.stack([f1, f2, f3])

    def jac_f(self, x: Array) -> Array:
        n = self.n_features
        c = self._c.on(x)
        k = c["k"]
        j1 = 4 / n**2 * k * (x - k) ** 3
        j2 = torch.exp(torch.sum(x) / n) / n + 2 * x
        j3 = -c["conv"] * torch.exp(-x) / (n * (n + 1))
        return torch.stack([j1, j2, j3])


class ZDT1(Problem):
    r"""Classic ZDT1 with sqrt coupling (Zitzler, Deb & Thiele 2000),
    default n=30, bounds (1e-6, inf)."""

    def __init__(self, n_features: int = 30) -> None:
        super().__init__(n_features, 2, bounds=(1e-6, math.inf))

    def f(self, x: Array) -> Array:
        n = self.n_features
        f1 = x[0]
        h = 1 + 9 / (n - 1) * torch.sum(x[1:])
        f2 = h * (1 - torch.sqrt(f1 / h))
        return torch.stack([f1, f2])

    def jac_f(self, x: Array) -> Array:
        n = self.n_features
        h = 1 + 9 / (n - 1) * torch.sum(x[1:])
        # The JAX .at[0].set writes, as concatenations.
        e0 = torch.cat(
            [torch.ones_like(x[:1]), torch.zeros(n - 1, dtype=x.dtype, device=x.device)]
        )
        tail = 9 * (2 - torch.sqrt(x[0] / h)) / (2 * (n - 1))
        head = -torch.sqrt(h / x[0]) / 2
        j2 = torch.cat([head[None], tail.expand(n - 1)])
        return torch.stack([e0, j2])


class TOI4(Problem):
    r"""Partially separable quadratics (Toint 1983, problem 4), n=4."""

    def __init__(
        self,
        l1_ratios: Sequence[float] | None = None,
        l1_shifts: Sequence[float] | None = None,
        bounds: tuple[Any, Any] | None = None,
    ) -> None:
        super().__init__(4, 2, l1_ratios, l1_shifts, bounds)

    def f(self, x: Array) -> Array:
        f1 = x[0] ** 2 + x[1] ** 2 + 1
        f2 = 0.5 * ((x[0] - x[1]) ** 2 + (x[2] - x[3]) ** 2) + 1
        return torch.stack([f1, f2])

    def jac_f(self, x: Array) -> Array:
        z = torch.zeros((), dtype=x.dtype, device=x.device)
        j1 = torch.stack([2 * x[0], 2 * x[1], z, z])
        d01 = x[0] - x[1]
        d23 = x[2] - x[3]
        j2 = torch.stack([d01, -d01, d23, -d23])
        return torch.stack([j1, j2])


class TRIDIA(Problem):
    r"""Tridiagonal quadratics (Toint 1983), n=3, m=3."""

    def __init__(
        self,
        l1_ratios: Sequence[float] | None = None,
        l1_shifts: Sequence[float] | None = None,
        bounds: tuple[Any, Any] | None = None,
    ) -> None:
        super().__init__(3, 3, l1_ratios, l1_shifts, bounds)

    def f(self, x: Array) -> Array:
        return torch.stack(
            [
                (2 * x[0] - 1) ** 2,
                2 * (2 * x[0] - x[1]) ** 2,
                3 * (2 * x[1] - x[2]) ** 2,
            ]
        )

    def jac_f(self, x: Array) -> Array:
        z = torch.zeros((), dtype=x.dtype, device=x.device)
        return torch.stack(
            [
                torch.stack([8 * x[0] - 4, z, z]),
                torch.stack([16 * x[0] - 8 * x[1], 4 * x[1] - 8 * x[0], z]),
                torch.stack([z, 24 * x[1] - 12 * x[2], 6 * x[2] - 12 * x[1]]),
            ]
        )


class LinearFunctionRank1(Problem):
    r"""Rank-one squared-linear objectives f_i = (i * <j, x> - 1)^2
    (More, Garbow & Hillstrom 1981), defaults n=10, m=4."""

    def __init__(
        self,
        n_features: int = 10,
        n_objectives: int = 4,
        l1_ratios: Sequence[float] | None = None,
        l1_shifts: Sequence[float] | None = None,
        bounds: tuple[Any, Any] | None = None,
    ) -> None:
        super().__init__(n_features, n_objectives, l1_ratios, l1_shifts, bounds)
        self._c = DeviceConstants(
            i=np.arange(1, n_objectives + 1), j=np.arange(1, n_features + 1)
        )

    def f(self, x: Array) -> Array:
        c = self._c.on(x)
        return (c["i"] * _dot(c["j"], x) - 1) ** 2

    def jac_f(self, x: Array) -> Array:
        c = self._c.on(x)
        i, j = c["i"], c["j"]
        r = i * _dot(j, x) - 1  # (m,)
        return 2 * (i * r)[:, None] * j[None, :]
