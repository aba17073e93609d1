r"""Problem base class for multiobjective composite optimization.

PyTorch-port counterpart of :mod:`zfista_tpu.models.base`.  Each problem
defines :math:`F_i(x) = f_i(x) + g_i(x)` with smooth convex :math:`f_i`
and closed proper convex :math:`g_i`:

* ``f``/``jac_f`` are plain functions on tensors (subclasses); ``jac_f``
  defaults to ``torch.func.jacfwd`` of ``f``.
* ``g_i(x) = r_i * ||x - s_i||_1`` plus a box indicator that is ``+inf``
  outside the bounds, and ``prox_wsum_g`` is the reference's sequential
  shifted-L1 composition plus box projection
  (:func:`zfista_tpu_torch.ops.prox.make_wsum_shifted_l1_box_prox`).
* ``solve`` runs :func:`zfista_tpu_torch.minimize_proximal_gradient` on
  ``x0``'s device, ``solve_batch`` the batch solver on ``x0s``'s.

A problem built with ``sharding=feature_sharding(mesh)``
(:mod:`zfista_tpu_torch.parallel.sharding`) takes this rank's block of the
features: its callables take the block and reduce their sums over the
``"model"`` ranks (``g``'s per-objective ℓ1 sums in one all-reduce, its
bounds test in one NaN-carrying max), and its solves start from the block
(``x0`` whole, or the block already tagged) and return the whole ``x`` on
every rank.  The JAX package needs no such keyword: there a sharding is
``jax.Array`` placement and XLA inserts the collectives.  Inside
``torch.func.vmap`` (the batch solver) a block's sums are
:func:`~zfista_tpu_torch.ops.precision.lane_sum` trees, so a lane's bits
do not depend on the lanes or ranks beside it.  On a mesh whose
``"model"`` axis is one rank the block is the whole vector and the
callables are the unsharded ones, op for op.  Subclasses whose size is
fixed (``SD``, ``TOI4``, ``TRIDIA``) refuse a sharding.

The constants stay float64 on the host and are copied once per
``(dtype, device)`` (:class:`~zfista_tpu_torch.ops.prox.DeviceConstants`):
a tensor built at construction would fix one dtype and device, and a
per-call copy would be a host-to-device transfer inside every ``g``.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from zfista_tpu_torch._typing import Array
from zfista_tpu_torch.core.solver import minimize_proximal_gradient
from zfista_tpu_torch.ops.precision import _over_lanes, lane_sum
from zfista_tpu_torch.ops.prox import DeviceConstants, make_wsum_shifted_l1_box_prox
from zfista_tpu_torch.parallel.batch import minimize_proximal_gradient_batch
from zfista_tpu_torch.parallel.sharding import (
    NamedSharding,
    all_reduce_max,
    all_reduce_sum,
    block,
    distribute,
    lanes_on_operator,
    sharding_of,
    tag,
)


class Problem:
    """Base class for test problems (subclasses implement ``f``; ``jac_f``
    optional)."""

    #: Whether the problem's size is a parameter, so that a sharding can cut
    #: its features into blocks.
    shardable = True

    def __init__(
        self,
        n_features: int,
        n_objectives: int,
        l1_ratios: Sequence[float] | None = None,
        l1_shifts: Sequence[float] | None = None,
        bounds: tuple[Any, Any] | None = None,
        sharding: NamedSharding | None = None,
    ) -> None:
        self.n_features = n_features
        self.n_objectives = n_objectives
        self._place(sharding)
        self._l1_ratios_raw = l1_ratios
        self._l1_shifts_raw = l1_shifts
        # Host float64 constants, cast to the tensors' dtype at use.
        self.l1_ratios = (
            None
            if l1_ratios is None
            else np.atleast_1d(np.asarray(l1_ratios, np.float64))
        )
        self.l1_shifts = (
            np.zeros(n_objectives)
            if l1_shifts is None
            else np.atleast_1d(np.asarray(l1_shifts, np.float64))
        )
        self.bounds = bounds
        # Full-shape validation: a (m, 1) array passes a len() check but
        # broadcasts g() to (m, m).
        if l1_ratios is not None and self.l1_ratios.shape != (n_objectives,):
            raise ValueError(
                f"l1_ratios must have shape ({n_objectives},); "
                f"got {self.l1_ratios.shape}"
            )
        if l1_shifts is not None and self.l1_shifts.shape != (n_objectives,):
            raise ValueError(
                f"l1_shifts must have shape ({n_objectives},); "
                f"got {self.l1_shifts.shape}"
            )
        consts = {}
        if self.l1_ratios is not None:
            consts.update(ratios=self.l1_ratios, shifts=self.l1_shifts)
        if bounds is not None:
            # Scalars or arrays (broadcast against x), as the prox takes them.
            consts.update(
                lo=-np.inf if bounds[0] is None else bounds[0],
                hi=np.inf if bounds[1] is None else bounds[1],
            )
        self._g_consts = DeviceConstants(**consts)
        self._prox = make_wsum_shifted_l1_box_prox(
            self.l1_ratios,
            self.l1_shifts,
            None if bounds is None else bounds[0],
            None if bounds is None else bounds[1],
        )
        self.name = self._generate_name()

    # -- naming (the same strings as the JAX package: the harness's cache
    #    keys and artifact paths) ------------------------------------------
    def _generate_name(self) -> str:
        parts = [type(self).__name__, f"n_{self.n_features}"]
        if self._l1_ratios_raw is not None:
            parts.append(
                "l1_ratios_" + "_".join(str(v) for v in self._l1_ratios_raw)
            )
            shifts = (
                self._l1_shifts_raw
                if self._l1_shifts_raw is not None
                else [0.0] * self.n_objectives
            )
            parts.append("l1_shifts_" + "_".join(str(v) for v in shifts))
        if self.bounds is not None:
            parts.append(f"bounds_{self.bounds[0]}_{self.bounds[1]}")
        return "_".join(parts)

    def __repr__(self) -> str:
        return self.name

    # -- feature blocks -------------------------------------------------------
    def _place(self, sharding: NamedSharding | None) -> None:
        """This rank's block of the features: ``feature_offset`` (the global
        index of its first feature) and ``block_size``; the whole vector
        without a sharding."""
        n = self.n_features
        self.sharding = sharding
        self.feature_offset, self.block_size, self._group = 0, n, None
        if sharding is None:
            return
        if not self.shardable:
            raise ValueError(
                f"{type(self).__name__} has a fixed size of {n} features: it takes no sharding"
            )
        if not isinstance(sharding, NamedSharding) or sharding.named != ((0, "model"),):
            raise ValueError(
                f"a problem's sharding lays its features out by feature_sharding (P('model')); "
                f"got {sharding!r}"
            )
        k = sharding.mesh.size("model")
        if n % k:
            raise ValueError(f"{n} features do not divide into {k} blocks along 'model'")
        self.block_size = n // k
        self.feature_offset = sharding.mesh.index("model") * self.block_size
        if self._sharded:
            self._group = sharding.group

    @property
    def _sharded(self) -> bool:
        """Whether the callables take a block of a vector cut over several
        ranks (a one-rank ``"model"`` axis leaves the whole vector)."""
        return self.block_size != self.n_features

    def _features(self, v: np.ndarray) -> np.ndarray:
        """This rank's block of a host array over the features."""
        return v[self.feature_offset : self.feature_offset + self.block_size]

    def _fsum(self, v: Array) -> Array:
        """``v`` summed over the ranks that hold the other blocks (``v``
        itself on the whole vector)."""
        return all_reduce_sum(v, self._group)

    def _sum(self, v: Array) -> Array:
        """A sum over the last axis: under ``torch.func.vmap``
        :func:`lane_sum` (a lane's bits whatever lanes are beside it, on
        every device), else ``torch.sum``."""
        return lane_sum(v) if _over_lanes(v) else torch.sum(v, dim=-1)

    # -- smooth part --------------------------------------------------------
    def f(self, x: Array) -> Array:
        raise NotImplementedError

    def jac_f(self, x: Array) -> Array:
        """Analytic Jacobian override point; the default is forward-mode
        autodiff of ``f``."""
        return torch.func.jacfwd(self.f)(x)

    # -- nonsmooth part ------------------------------------------------------
    def g(self, x: Array) -> Array:
        """On a feature block the per-objective ℓ1 sums take one all-reduce
        and the bounds test one NaN-carrying max over the ranks."""
        c = self._g_consts.on(x)
        if self.l1_ratios is not None:
            val = c["ratios"] * self._fsum(self._sum(torch.abs(x[None, :] - c["shifts"][:, None])))
        else:
            val = torch.zeros(self.n_objectives, dtype=x.dtype, device=x.device)
        if self.bounds is not None:
            infeasible = torch.any(x < c["lo"]) | torch.any(x > c["hi"])
            if self._sharded:
                infeasible = all_reduce_max(infeasible.to(x.dtype), self._group) > 0
            val = torch.where(infeasible, torch.inf, val)
        return val

    def prox_wsum_g(self, weight, x: Array) -> Array:
        return self._prox(weight, x)

    # -- solver entry points --------------------------------------------------
    def _x0_block(self, x0, device: Any):
        """``x0`` for a solve: with a sharding, this rank's block of it (``x0``
        whole, or the block already tagged), tagged with the placement the
        solver reads; a tensor keeps its device."""
        if self.sharding is None or sharding_of(x0) is not None:
            return x0
        if not isinstance(x0, torch.Tensor):
            return distribute(x0, self.sharding, device)
        return tag(block(x0, self.sharding).view(self.block_size), self.sharding)

    def minimize_proximal_gradient(self, x0, device: Any = "cuda", **kwargs):
        """Solve from ``x0``: on its device when it is a tensor (a CPU tensor
        asks for the CPU), else on ``device`` (default ``"cuda"``; a machine
        with no card raises).  With a sharding, from this rank's block of
        ``x0``; the result holds the whole ``x`` on every rank."""
        return minimize_proximal_gradient(
            self.f, self.g, self.jac_f, self.prox_wsum_g, self._x0_block(x0, device),
            device=device, **kwargs,
        )

    solve = minimize_proximal_gradient

    def solve_batch(self, x0s, device: Any = "cuda", **kwargs):
        """Solve from every row of ``x0s`` as one lane-batched solve
        (:func:`zfista_tpu_torch.parallel.minimize_proximal_gradient_batch`):
        on ``x0s``'s device when it is a tensor, else on ``device`` (default
        ``"cuda"``; a machine with no card raises).  With a sharding the
        lanes lie on its mesh as ``P("batch", "model")``: over the
        ``"batch"`` ranks and, within a lane, by features (``x0s`` whole,
        or this rank's block of it); the whole batch returns on every
        rank."""
        if self.sharding is not None:
            kwargs["in_sharding"] = lanes_on_operator(self.sharding, kwargs.get("in_sharding"))
        return minimize_proximal_gradient_batch(
            self.f, self.g, self.jac_f, self.prox_wsum_g, x0s, device=device, **kwargs
        )
