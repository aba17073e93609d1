"""SolverOptions: the solver's keyword arguments as one frozen dataclass.

PyTorch-port counterpart of :mod:`zfista_tpu.core.options`.  The JAX
version registers the class as a static pytree node so it can ride through
``jax.jit``; eager PyTorch has no tracing, so here it is a plain frozen
dataclass:

    opts = SolverOptions(nesterov=True, decay_rate=1, lr=0.5)
    res = minimize_proximal_gradient(f, g, jac_f, prox, x0, **opts.kwargs())
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, replace
from typing import Any


@dataclass(frozen=True)
class SolverOptions:
    """All options of :func:`zfista_tpu_torch.minimize_proximal_gradient`,
    with the reference's defaults."""

    lr: float = 1.0
    tol: float = 1e-5
    tol_rel: float = 0.0
    tol_internal: float = 1e-12
    tol_internal_rel: float = 0.0
    max_iter: int = 1_000_000
    max_iter_internal: int = 100_000
    max_backtrack_iter: int = 100
    warm_start: bool = False
    decay_rate: float = 0.5
    nesterov: bool = False
    nesterov_ratio: tuple[float, float] = (0.0, 0.25)
    return_all: bool = False
    verbose: bool = False
    deprecated: bool = False
    # None = device-aware auto (64 on CUDA in the bitwise-identical scalar
    # fixed-step regime, 1 otherwise) — the facade's default.
    check_every: int | None = None
    adaptive_restart: bool = False
    project_momentum: bool = False
    history_chunk: int = 512

    def kwargs(self) -> dict[str, Any]:
        """As a keyword dict for the solver facade."""
        return asdict(self)

    def replace(self, **changes: Any) -> "SolverOptions":
        return replace(self, **changes)
