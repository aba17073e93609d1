r"""The seven-problem benchmark zoo, on tensors.

PyTorch-port counterpart of :mod:`zfista_tpu.models.zoo`: the same
formulas, default sizes and box bounds, each with its analytic Jacobian
(tested against ``torch.func.jacfwd``).  The functions are vectorized and
free of Python branches on tensor values, so ``torch.func`` transforms run
through them.  Constants are host float64 arrays copied once per
``(dtype, device)``.

The four problems whose size is a parameter (``JOS1``, ``FDS``, ``ZDT1``,
``LinearFunctionRank1``) take ``sharding=feature_sharding(mesh)``
(:class:`~zfista_tpu_torch.models.base.Problem`): each then computes on
this rank's block of the features, its index-weighted constants taken at
the block's global offset, and reduces every sum over features in one
all-reduce per call.  ``SD``, ``TOI4`` and ``TRIDIA`` have 3-4 features
and refuse a sharding.
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
from zfista_tpu_torch.parallel.sharding import NamedSharding

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
        sharding: NamedSharding | None = None,
    ) -> None:
        super().__init__(n_features, 2, l1_ratios, l1_shifts, bounds, sharding)

    def f(self, x: Array) -> Array:
        return self._fsum(torch.stack([_dot(x, x), _dot(x - 2, x - 2)])) / self.n_features

    def jac_f(self, x: Array) -> Array:
        n = self.n_features
        return torch.stack([2 * x / n, 2 * (x - 2) / n])


class SD(Problem):
    r"""Linear + reciprocal bi-objective (Stadler & Dauer 1992), n=4,
    bounds (1e-6, inf)."""

    _C1 = np.array([2.0, _SQRT2, _SQRT2, 1.0])
    _C2 = np.array([2.0, 2 * _SQRT2, 2 * _SQRT2, 2.0])

    shardable = False

    def __init__(self, sharding: NamedSharding | None = None) -> None:
        super().__init__(4, 2, bounds=(1e-6, math.inf), sharding=sharding)
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
        sharding: NamedSharding | None = None,
    ) -> None:
        super().__init__(n_features, 3, l1_ratios, l1_shifts, bounds, sharding)
        k = np.arange(1, n_features + 1)
        # k * (n - k + 1), the triangular convolution weights of f3 (the
        # block's, at its global offset)
        self._c = DeviceConstants(k=self._features(k), conv=self._features(k * k[::-1]))

    def f(self, x: Array) -> Array:
        n = self.n_features
        c = self._c.on(x)
        k = c["k"]
        s = self._fsum(torch.stack(
            [_dot(k, (x - k) ** 4), self._sum(x), _dot(x, x), _dot(c["conv"], torch.exp(-x))]
        ))
        return torch.stack([s[0] / n**2, torch.exp(s[1] / n) + s[2], s[3] / (n * (n + 1))])

    def jac_f(self, x: Array) -> Array:
        n = self.n_features
        c = self._c.on(x)
        k = c["k"]
        j1 = 4 / n**2 * k * (x - k) ** 3
        j2 = torch.exp(self._fsum(self._sum(x)) / n) / n + 2 * x
        j3 = -c["conv"] * torch.exp(-x) / (n * (n + 1))
        return torch.stack([j1, j2, j3])


class ZDT1(Problem):
    r"""Classic ZDT1 with sqrt coupling (Zitzler, Deb & Thiele 2000),
    default n=30, bounds (1e-6, inf)."""

    def __init__(self, n_features: int = 30, sharding: NamedSharding | None = None) -> None:
        super().__init__(n_features, 2, bounds=(1e-6, math.inf), sharding=sharding)
        # 1 at the global feature 0 (on the first block), 0 elsewhere.
        self._c = DeviceConstants(first=self._features(np.arange(n_features) == 0))

    def _head(self, x: Array) -> tuple[Array, Array]:
        """``(x[0], h)`` of a block: ``x[0]`` lives on the first block, so it
        travels masked (``-0.0`` elsewhere, an exact zero for the sum) in the
        one all-reduce that also sums ``x[1:]``."""
        n = self.n_features
        first = self._c.on(x)["first"] > 0
        mine = torch.where(first, x, -0.0)
        s = self._fsum(torch.stack([self._sum(mine), self._sum(torch.where(first, -0.0, x))]))
        return s[0], 1 + 9 / (n - 1) * s[1]

    def f(self, x: Array) -> Array:
        n = self.n_features
        if self._sharded:
            f1, h = self._head(x)
        else:
            f1 = x[0]
            h = 1 + 9 / (n - 1) * torch.sum(x[1:])
        f2 = h * (1 - torch.sqrt(f1 / h))
        return torch.stack([f1, f2])

    def jac_f(self, x: Array) -> Array:
        n = self.n_features
        if self._sharded:
            x0, h = self._head(x)
            first = self._c.on(x)["first"]
            tail = 9 * (2 - torch.sqrt(x0 / h)) / (2 * (n - 1))
            head = -torch.sqrt(h / x0) / 2
            return torch.stack([first, torch.where(first > 0, head, tail)])
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

    shardable = False

    def __init__(
        self,
        l1_ratios: Sequence[float] | None = None,
        l1_shifts: Sequence[float] | None = None,
        bounds: tuple[Any, Any] | None = None,
        sharding: NamedSharding | None = None,
    ) -> None:
        super().__init__(4, 2, l1_ratios, l1_shifts, bounds, sharding)

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

    shardable = False

    def __init__(
        self,
        l1_ratios: Sequence[float] | None = None,
        l1_shifts: Sequence[float] | None = None,
        bounds: tuple[Any, Any] | None = None,
        sharding: NamedSharding | None = None,
    ) -> None:
        super().__init__(3, 3, l1_ratios, l1_shifts, bounds, sharding)

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
        sharding: NamedSharding | None = None,
    ) -> None:
        super().__init__(n_features, n_objectives, l1_ratios, l1_shifts, bounds, sharding)
        self._c = DeviceConstants(
            i=np.arange(1, n_objectives + 1), j=self._features(np.arange(1, n_features + 1))
        )

    def _jx(self, x: Array) -> Array:
        """``<j, x>`` over every feature."""
        return self._fsum(_dot(self._c.on(x)["j"], x))

    def f(self, x: Array) -> Array:
        c = self._c.on(x)
        return (c["i"] * self._jx(x) - 1) ** 2

    def jac_f(self, x: Array) -> Array:
        c = self._c.on(x)
        i, j = c["i"], c["j"]
        r = i * self._jx(x) - 1  # (m,)
        return 2 * (i * r)[:, None] * j[None, :]
