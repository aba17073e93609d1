r"""Fused prox-momentum kernel for the solver's bandwidth-bound hot path.

PyTorch/CUDA counterpart of :mod:`zfista_tpu.ops.fused`.  One FISTA
iteration on dense LASSO splits into

1. two dense matvecs (``A @ y``, ``Aᵀ r``) — cuBLAS through
   :func:`~zfista_tpu_torch.ops.precision.matmul_hp` in full fp32, as the
   JAX package leaves them to XLA outside any Pallas kernel, and
2. an elementwise chain over ``n``-vectors: gradient step, soft-threshold,
   momentum extrapolation — HBM-bandwidth-bound.

:func:`fused_prox_momentum` runs the whole chain as one hand-written CUDA
kernel (``zfista_tpu_torch/csrc/fused_prox_momentum.cu``): 3 reads
(``y, grad, x``) + 2 writes (``x⁺, y⁺``) per element, the roofline
minimum.  The JAX package retired its Pallas version from dispatch because
XLA's own fusion matched it on the TPU; eager PyTorch has no such fusion
and runs the same chain as about 7 separate elementwise launches, so the
port's solver dispatches the kernel on its LASSO step.

On a CPU tensor the wrapper takes :func:`fused_prox_momentum_plain`, the
plain PyTorch version; on a CUDA tensor it launches the kernel or raises.
The kernel is built with ``-fmad=false`` and the plain version computes in
the same operation order, so on the card the two are bitwise equal.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any

import torch

from zfista_tpu_torch._typing import Array, Scalar
from zfista_tpu_torch.ops import _build
from zfista_tpu_torch.ops.precision import matmul_hp
from zfista_tpu_torch.ops.prox import soft_threshold

#: Kernel launches made by each wrapper since import (or since a caller
#: reset the entry to 0).  Incremented only where the CUDA kernel is
#: launched, never on the plain CPU path, so a run can show that its main
#: path went through the kernel.
launch_counts: dict[str, int] = {"fused_prox_momentum": 0}

_SYMBOLS = {
    torch.float32: "zt_prox_momentum_f32",
    torch.float64: "zt_prox_momentum_f64",
}


@functools.cache
def _launcher(dtype: torch.dtype) -> tuple[Any, Any]:
    """The typed ctypes entry point for ``dtype`` and the error-string
    helper (builds the library on first use)."""
    lib = _build.load("fused_prox_momentum")
    fn = getattr(lib, _SYMBOLS[dtype])
    # c_void_p for every pointer and the stream: an undeclared argument
    # would be passed as a 32-bit int and cut the address.
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    errstr = lib.zt_cuda_error_string
    errstr.argtypes = [ctypes.c_int]
    errstr.restype = ctypes.c_char_p
    return fn, errstr


def fused_prox_momentum_plain(
    y: Array, grad: Array, x: Array, lr: Scalar, thresh: Scalar, gamma: Scalar
) -> tuple[Array, Array]:
    """Plain PyTorch version of the fused kernel (counterpart of
    ``fused_prox_momentum_xla``), in the kernel's operation order."""
    x_new = soft_threshold(y - lr * grad, thresh)
    return x_new, x_new + gamma * (x_new - x)


def _device_scalars(like: Array, *vals: Scalar) -> Array:
    """``vals`` as one contiguous device array of ``like``'s dtype.

    The kernel reads lr/thresh/gamma from device memory, as the TPU kernel
    read them from SMEM: on the solver path they are 0-d device tensors
    computed from the momentum scalar ``t``, and passing them by value
    would need a host read — a stream sync — every iteration.  (A Python
    float here costs one host-to-device copy; the solver never passes one.)
    """
    return torch.stack(
        [
            torch.as_tensor(v, dtype=like.dtype, device=like.device).reshape(())
            for v in vals
        ]
    )


def fused_prox_momentum(
    y: Array, grad: Array, x: Array, lr: Scalar, thresh: Scalar, gamma: Scalar
) -> tuple[Array, Array]:
    r"""Fused gradient-step + soft-threshold + momentum, one HBM pass.

    Returns ``(x_new, y_new)`` with
    ``x_new = soft(y - lr*grad, thresh)`` and
    ``y_new = x_new + gamma * (x_new - x)``.

    ``y``, ``grad`` and ``x`` are 1-D tensors of one dtype on one device.
    CPU tensors take :func:`fused_prox_momentum_plain`.  CUDA tensors
    (float32 or float64, contiguous) launch the CUDA kernel on the current
    stream; anything else raises.  The outputs are fresh tensors: the
    caller's ``y`` is never overwritten (the solver still needs it when
    the step converges and its ``y_new`` is discarded).
    """
    if y.device.type == "cpu":
        return fused_prox_momentum_plain(y, grad, x, lr, thresh, gamma)
    if y.device.type != "cuda":
        raise ValueError(f"fused_prox_momentum: unsupported device {y.device}")
    for name, v in (("grad", grad), ("x", x)):
        if v.device != y.device or v.dtype != y.dtype or v.shape != y.shape:
            raise ValueError(
                f"fused_prox_momentum: {name} is {v.dtype} {tuple(v.shape)} "
                f"on {v.device}; y is {y.dtype} {tuple(y.shape)} on {y.device}"
            )
        if not v.is_contiguous():
            raise ValueError(f"fused_prox_momentum: {name} is not contiguous")
    if y.dtype not in _SYMBOLS or y.dim() != 1 or not y.is_contiguous():
        raise ValueError(
            "fused_prox_momentum: y must be a contiguous 1-D float32/float64 "
            f"tensor, got {y.dtype} {tuple(y.shape)}"
        )
    scal = _device_scalars(y, lr, thresh, gamma)
    x_new = torch.empty_like(y)
    y_new = torch.empty_like(y)
    n = y.numel()
    if n == 0:
        return x_new, y_new
    fn, errstr = _launcher(y.dtype)
    code = fn(
        y.data_ptr(),
        grad.data_ptr(),
        x.data_ptr(),
        scal.data_ptr(),
        x_new.data_ptr(),
        y_new.data_ptr(),
        n,
        y.device.index,
        torch.cuda.current_stream(y.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(
            f"fused_prox_momentum kernel launch failed: cudaError {code} "
            f"({errstr(code).decode()})"
        )
    launch_counts["fused_prox_momentum"] += 1
    return x_new, y_new


def fista_step_dense_fused(A: Array, b: Array, lam: Scalar, lr: Scalar, carry):
    """One dense-LASSO FISTA step: two full-fp32 cuBLAS matvecs, then the
    fused kernel, then the t-update.  Counterpart of
    ``fista_step_dense_pallas``, and a drop-in for
    :func:`zfista_tpu_torch.models.lasso.fista_step_dense`.

    ``carry = (x, y, t)``; ``t``, ``lr`` and ``lam`` are 0-d tensors on
    ``A``'s device, so a loop of steps never reads the device.
    """
    x, y, t = carry
    grad = 2 * matmul_hp(A.T, matmul_hp(A, y) - b)
    t_new = torch.sqrt(t * t + 0.25) + 0.5
    gamma = (t - 1) / t_new
    x_new, y_new = fused_prox_momentum(y, grad, x, lr, lr * lam, gamma)
    return x_new, y_new, t_new
