r"""Total-variation seminorm and its prox (FGP), in PyTorch.

PyTorch-port counterpart of :mod:`zfista_tpu.ops.tv`.  The prox of
``λ·TV`` has no closed form; it is computed by FGP (fast gradient
projection: FISTA on the dual of the denoising problem, Beck & Teboulle,
IEEE TIP 2009) with a FIXED number of dual iterations, so it is inexact
like every practical TV prox and its cost is known in advance.

Discretization, as in the JAX package: forward differences with Neumann
(replicate) boundaries.  The dual field is two dense ``(H, W)`` tensors
whose last row/column are structurally zero.

Where the dual loop runs (``method``):

* ``"xla"``: the plain eager loop (:func:`zfista_tpu_torch.ops.tv_cuda.fgp_plain`)
  on any device — the counterpart of the JAX ``fori_loop``;
* ``"auto"`` / ``"pallas"``: on a CUDA tensor, one of the hand-written CUDA
  kernels of :mod:`zfista_tpu_torch.ops.tv_cuda` (whole-image resident, or
  temporally blocked 2-D tiles); on a CPU tensor, the plain loop, as the
  JAX package runs its XLA loop off the TPU.  2-D tiles cover any image
  shape, so on a card ``"auto"`` always reaches a kernel;
* ``"cuda_tiles_pipelined"`` (the port's own): the pipelined tile kernel
  on a CUDA tensor, which ``"auto"`` picks at no size; the plain loop on a
  CPU one;
* ``"pallas_interpret"``: raises.  The port has no kernel interpreter; its
  CPU path is the plain loop.

The kernels compute the plain loop's operations in its order and are built
with ``-fmad=false``, so on the card they equal it bitwise.
"""

from __future__ import annotations

import torch

from zfista_tpu_torch._typing import Array, Scalar
from zfista_tpu_torch.ops.precision import sum_hp

#: The method that pins the pipelined tile kernel, which ``"auto"`` picks
#: at no size (:func:`zfista_tpu_torch.ops.tv_cuda.choose`); on a CPU
#: tensor it runs the plain loop like ``"auto"``.
PIPELINED = "cuda_tiles_pipelined"
METHODS = ("auto", "xla", "pallas", "pallas_interpret", PIPELINED)


def _grad2d(u: Array) -> tuple[Array, Array]:
    """Forward differences, zero-padded to ``u.shape`` (Neumann boundary:
    the last row/column of each component is identically zero)."""
    px = torch.zeros_like(u)
    px[:-1, :] = u[1:, :] - u[:-1, :]
    py = torch.zeros_like(u)
    py[:, :-1] = u[:, 1:] - u[:, :-1]
    return px, py


def _div2d(p: Array, q: Array) -> Array:
    """Negative adjoint of :func:`_grad2d` on the padded representation:
    ``<grad u, (p,q)> = <u, -div(p,q)>`` exactly."""
    dx = torch.cat((p[:1, :], p[1:, :] - p[:-1, :]), dim=0)
    dy = torch.cat((q[:, :1], q[:, 1:] - q[:, :-1]), dim=1)
    return dx + dy


def tv2d(u: Array, isotropic: bool = True) -> Array:
    """Discrete total variation of a 2-D tensor (0-d tensor).

    Isotropic (default): ``sum_ij sqrt(dx_ij^2 + dy_ij^2)``; anisotropic:
    ``sum |dx| + |dy|``.  Matches the discretization of :func:`prox_tv`.
    """
    px, py = _grad2d(u)
    if isotropic:
        return sum_hp(torch.sqrt(px * px + py * py))
    return sum_hp(torch.abs(px)) + sum_hp(torch.abs(py))


def check_method(method: str) -> str:
    """``method`` if the port runs it, else ValueError."""
    if method not in METHODS:
        raise ValueError(
            "method must be 'auto', 'xla', 'pallas', 'pallas_interpret' or "
            f"{PIPELINED!r}; got {method!r}"
        )
    if method == "pallas_interpret":
        raise ValueError(
            "method='pallas_interpret' has no counterpart in zfista_tpu_torch: "
            "the port has no kernel interpreter, and its CPU path is the plain "
            "loop (method='xla', or 'auto' on a CPU tensor)"
        )
    return method


def prox_tv(
    lam: Scalar,
    v: Array,
    n_iter: int = 50,
    isotropic: bool = True,
    return_dual: bool = False,
    dual0: tuple[Array, Array] | None = None,
    method: str = "auto",
) -> Array | tuple[Array, tuple[Array, Array]]:
    r"""Prox of ``lam * TV``: ``argmin_u 0.5 ||u - v||^2 + lam TV(u)``.

    FGP on the dual ``max_{||(p,q)||<=1} -0.5 ||lam * div(p,q) - v||^2``
    with the fixed dual step ``1/(8 lam)``.  ``lam`` may be a 0-d tensor on
    ``v``'s device (it is ``lr * w * strength`` inside the solver, and the
    kernels read it there, with no host sync); ``lam <= 0`` returns ``v``.

    The constraint set is the pointwise unit ball: L2 across the two
    components when ``isotropic``, else the unit box.  ``dual0`` warm-starts
    the dual field; ``return_dual`` also returns the final feasible dual
    ``(p, q)``, the certificate for :func:`tv_dual_gap`.  ``method``: see
    the module docstring.
    """
    check_method(method)
    from zfista_tpu_torch.ops import tv_cuda

    lam = torch.as_tensor(lam, dtype=v.dtype, device=v.device).reshape(())
    if dual0 is None:
        p0 = q0 = torch.zeros_like(v)
    else:
        p0, q0 = dual0
    if method == "xla":
        u, p, q = tv_cuda.fgp_plain(lam, v, p0, q0, n_iter=n_iter, isotropic=isotropic)
    else:
        u, p, q = tv_cuda.fgp(
            lam, v, p0, q0, n_iter=n_iter, isotropic=isotropic, pipelined=method == PIPELINED
        )
    u = torch.where(lam > 0, u, v)
    if return_dual:
        return u, (p, q)
    return u


def tv_dual_gap(
    lam: Scalar,
    v: Array,
    u: Array,
    dual: tuple[Array, Array],
    isotropic: bool = True,
) -> Array:
    """Primal-dual gap certificate for ``u, dual = prox_tv(..,
    return_dual=True)``.

    ``dual`` must be a feasible point of the pointwise unit ball (FGP's
    iterates are, by projection).  gap = primal(u) - dual_value >= 0, and
    -> 0 as both converge.
    """
    p, q = dual
    primal = 0.5 * torch.sum((u - v) ** 2) + lam * tv2d(u, isotropic)
    w = lam * _div2d(p, q)
    # dual(z) = -||lam div z||^2/2 + <v, lam div z>.
    dual_val = -0.5 * torch.sum(w * w) + torch.sum(v * w)
    return primal - dual_val
