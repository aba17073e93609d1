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
from zfista_tpu_torch.parallel.batch import minimize_proximal_gradient_batch
from zfista_tpu_torch.ops.prox import DeviceConstants, make_wsum_shifted_l1_box_prox


class Problem:
    """Base class for test problems (subclasses implement ``f``; ``jac_f``
    optional)."""

    def __init__(
        self,
        n_features: int,
        n_objectives: int,
        l1_ratios: Sequence[float] | None = None,
        l1_shifts: Sequence[float] | None = None,
        bounds: tuple[Any, Any] | None = None,
    ) -> None:
        self.n_features = n_features
        self.n_objectives = n_objectives
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

    # -- smooth part --------------------------------------------------------
    def f(self, x: Array) -> Array:
        raise NotImplementedError

    def jac_f(self, x: Array) -> Array:
        """Analytic Jacobian override point; the default is forward-mode
        autodiff of ``f``."""
        return torch.func.jacfwd(self.f)(x)

    # -- nonsmooth part ------------------------------------------------------
    def g(self, x: Array) -> Array:
        c = self._g_consts.on(x)
        if self.l1_ratios is not None:
            val = c["ratios"] * torch.sum(
                torch.abs(x[None, :] - c["shifts"][:, None]), dim=1
            )
        else:
            val = torch.zeros(self.n_objectives, dtype=x.dtype, device=x.device)
        if self.bounds is not None:
            infeasible = torch.any(x < c["lo"]) | torch.any(x > c["hi"])
            val = torch.where(infeasible, torch.inf, val)
        return val

    def prox_wsum_g(self, weight, x: Array) -> Array:
        return self._prox(weight, x)

    # -- solver entry points --------------------------------------------------
    def minimize_proximal_gradient(self, x0, device: Any = "cuda", **kwargs):
        """Solve from ``x0``: on its device when it is a tensor (a CPU tensor
        asks for the CPU), else on ``device`` (default ``"cuda"``; a machine
        with no card raises)."""
        return minimize_proximal_gradient(
            self.f, self.g, self.jac_f, self.prox_wsum_g, x0, device=device, **kwargs
        )

    solve = minimize_proximal_gradient

    def solve_batch(self, x0s, device: Any = "cuda", **kwargs):
        """Solve from every row of ``x0s`` as one lane-batched solve
        (:func:`zfista_tpu_torch.parallel.minimize_proximal_gradient_batch`):
        on ``x0s``'s device when it is a tensor, else on ``device`` (default
        ``"cuda"``; a machine with no card raises)."""
        return minimize_proximal_gradient_batch(
            self.f, self.g, self.jac_f, self.prox_wsum_g, x0s, device=device, **kwargs
        )
