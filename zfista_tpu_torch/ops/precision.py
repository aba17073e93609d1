"""Full-precision product helpers — the precision policy, in one place.

PyTorch-port counterpart of :mod:`zfista_tpu.ops.precision`.  The JAX
package runs every product that feeds an iterate, a gradient or a
convergence decision at ``lax.Precision.HIGHEST``: reduced-precision
products floor the solver's ``||x - y||_inf`` criterion at ~1e-3, so
nothing converges and nothing reports an error.  On a CUDA card the same
trap is TF32: a float32 ``torch.matmul`` keeps ~3 decimal digits when
``torch.backends.cuda.matmul.allow_tf32`` is on or the float32 matmul
precision is not ``"highest"``.

These helpers run ``torch.matmul`` / ``torch.dot`` / ``conv2d`` in full
precision and RAISE when a global flag asks for less.  They never flip the flags
themselves: the flags are process-wide, and a library that changes them
changes every other caller's numbers too.
"""

from __future__ import annotations

import torch


def _require_full_fp32() -> None:
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "zfista_tpu_torch needs full-fp32 matrix products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest') (TF32 products "
            "floor the solver's convergence test at ~1e-3)"
        )


def _over_lanes(t: torch.Tensor) -> bool:
    """Whether ``t`` carries a lane dimension of ``torch.func.vmap`` (the
    batch solver's), under any other ``torch.func`` wrappers."""
    functorch = torch._C._functorch
    while functorch.is_functorch_wrapped_tensor(t):
        if functorch.is_batchedtensor(t):
            return True
        t = functorch.get_unwrapped(t)
    return False


def matmul_hp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` in full precision (matrix-vector / matrix-matrix).

    Under ``torch.func.vmap``, when each lane has its own matrix (or the
    operands are vectors), the product is a sum of elementwise products
    instead (:func:`lane_sum`): vmap would turn ``matmul`` into a batched
    cuBLAS call whose kernel, and so its rounding, changes with the number
    of lanes, and a lane's result must not depend on how many lanes run
    beside it.  A shared matrix (one operator, many lanes) stays one GEMM."""
    _require_full_fp32()
    la, lb = _over_lanes(a), _over_lanes(b)
    shared_matrix = (a.dim() == 2 and not la) or (b.dim() == 2 and not lb)
    if (la or lb) and not shared_matrix and a.dim() <= 2 and b.dim() <= 2:
        if a.dim() == 1:
            return lane_sum(a * b) if b.dim() == 1 else lane_sum(a[:, None] * b, dim=0)
        if b.dim() == 1:
            return lane_sum(a * b)
        return lane_sum(a[:, :, None] * b[None, :, :], dim=1)
    return torch.matmul(a, b)


def dot_hp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.dot`` in full precision (vector-vector); under
    ``torch.func.vmap`` the :func:`lane_sum` of elementwise products (see
    :func:`matmul_hp`)."""
    _require_full_fp32()
    if _over_lanes(a) or _over_lanes(b):
        return lane_sum(a * b)
    return torch.dot(a, b)


def sum_hp(v: torch.Tensor) -> torch.Tensor:
    """``torch.sum`` of every element; under ``torch.func.vmap`` the
    :func:`lane_sum` of the flattened lane, so that the sum does not
    depend on the number of lanes (see :func:`lane_sum`)."""
    if _over_lanes(v):
        return lane_sum(v.reshape(-1))
    return torch.sum(v)


def lane_sum(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``torch.sum(v, dim)`` in an order set by the length of ``dim``
    alone: a pairwise tree of elementwise adds over ``v`` zero-padded to a
    power of two.

    A reduction kernel over a ``(lanes, n)`` tensor splits each row among
    its threads and blocks by the number of rows (torch's CUDA reduction
    does), so a lane's sum, and every decision it feeds, would change with
    the number of lanes beside it: a lane-sharded batch would part from
    the unsharded one.  An elementwise add rounds each element alone, so
    every lane's tree is the same whatever the lane count or device.
    ``log2(n)`` adds of halving width read about twice the bytes of one
    reduction."""
    v = v.movedim(dim, -1)
    n = v.shape[-1]
    if n == 0:
        return torch.sum(v, dim=-1)
    width = 1 << (n - 1).bit_length()
    if width != n:
        v = torch.nn.functional.pad(v, (0, width - n))
    while width > 1:
        width //= 2
        v = v[..., :width] + v[..., width:]
    return v[..., 0]


def conv2d_hp(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.nn.functional.conv2d`` (a correlation, unpadded) in full
    precision.  A float32 convolution on a card goes through cuDNN, which
    uses TF32 while ``torch.backends.cudnn.allow_tf32`` is on (its
    default), so a float32 CUDA call raises unless it is off.  TF32 never
    touches float64."""
    if x.is_cuda and x.dtype == torch.float32 and torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "zfista_tpu_torch needs full-fp32 convolutions: set "
            "torch.backends.cudnn.allow_tf32 = False (TF32 convolutions "
            "floor the solver's convergence test at ~1e-3)"
        )
    return torch.nn.functional.conv2d(x, w)
