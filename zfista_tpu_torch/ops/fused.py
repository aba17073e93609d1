r"""Fused kernels for the tail of a fixed-step FISTA iteration on LASSO.

PyTorch/CUDA counterpart of :mod:`zfista_tpu.ops.fused`.  One FISTA
iteration on dense LASSO splits into

1. two dense matvecs (``A @ y``, ``Aᵀ r``) — cuBLAS through
   :func:`~zfista_tpu_torch.ops.precision.matmul_hp` in full fp32, as the
   JAX package leaves them to XLA outside any Pallas kernel, and
2. a tail over ``n``-vectors and 0-d scalars: gradient step,
   soft-threshold, momentum extrapolation, the momentum recursion, and in
   the solver the convergence test, the counters and the chunk loop's mask.

The JAX package wrote the elementwise chain as a Pallas kernel and left
the scalars around it to XLA, which fused them into the step's program.
Eager PyTorch runs every one of them as a launch of its own, and on a
card the launches are what a LASSO step at ``n = 10⁴`` costs.  So the
CUDA kernel (``zfista_tpu_torch/csrc/fused_prox_momentum.cu``) has three
entries over one elementwise body, each one launch:

* :func:`fused_prox_momentum` — the TPU kernel's signature: ``(lr, thresh,
  gamma)`` given, ``x⁺, y⁺`` returned;
* :func:`fista_tail` — the raw dense step's tail: computes ``t⁺``,
  ``gamma`` and ``thresh`` from ``t, lr, lam`` itself
  (:func:`fista_step_dense_fused` is two GEMVs, ``− b``, ``× 2`` and this);
* :func:`lasso_step_tail` — the solver's step tail: also the grid-wide
  ``err = max|x⁺ − y|``, ``converged``, the freeze of ``y`` and ``t`` on
  the converging step, the counters, and the mask of a stopped state.

On a CPU tensor each wrapper takes its plain PyTorch version
(``*_plain``, beside it); on a CUDA tensor it launches the kernel or
raises.  The kernel is built with ``-fmad=false`` and the plain versions
compute in the same operation order, so on the card they are bitwise
equal.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from zfista_tpu_torch._typing import Array, Scalar
from zfista_tpu_torch.ops import _build
from zfista_tpu_torch.ops.precision import matmul_hp
from zfista_tpu_torch.ops.prox import soft_threshold
from zfista_tpu_torch.utils.profiling import register

#: Kernel launches made by each wrapper since import (or since a caller
#: reset the entry to 0).  Incremented only where the CUDA kernel is
#: launched, never on the plain CPU path, so a run can show that its main
#: path went through the kernel.  A replayed CUDA graph runs no wrapper:
#: the solver adds the launches its capture recorded at each replay
#: (``core.solver.run_graphed``), and takes back the capture's own.  The
#: tracing registry's group ``fused``.
launch_counts: dict[str, int] = register("fused", {
    "fused_prox_momentum": 0,
    "fista_tail": 0,
    "lasso_step_tail": 0,
})

_SOURCE = "fused_prox_momentum"
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: After an entry's pointers: the element count (then device and stream).
_COUNT = (ctypes.c_int64,)
#: ``max_iter`` of a step that has none: no ``nit`` reaches it.
_NO_MAX_ITER = 2**62


def _checked(name: str, y: Array, grad: Array, x: Array) -> None:
    """Raise unless ``y, grad, x`` are what the kernels take: contiguous
    1-D float32/float64 tensors of one shape on one CUDA device."""
    if y.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {y.device}")
    for nm, v in (("grad", grad), ("x", x)):
        if v.device != y.device or v.dtype != y.dtype or v.shape != y.shape:
            raise ValueError(
                f"{name}: {nm} is {v.dtype} {tuple(v.shape)} "
                f"on {v.device}; y is {y.dtype} {tuple(y.shape)} on {y.device}"
            )
        if not v.is_contiguous():
            raise ValueError(f"{name}: {nm} is not contiguous")
    if y.dtype not in _SUFFIX or y.dim() != 1 or not y.is_contiguous():
        raise ValueError(
            f"{name}: y must be a contiguous 1-D float32/float64 "
            f"tensor, got {y.dtype} {tuple(y.shape)}"
        )


def _scalar(name: str, v: Scalar, like: Array, dtype: torch.dtype | None = None) -> Array:
    """``v`` as a 0-d tensor of ``dtype`` (default ``like``'s) on ``like``'s
    device, which the kernels read by pointer: on the solver path the
    scalars are device values computed from the momentum scalar ``t``, and
    passing them by value would need a host read — a stream sync — every
    iteration.  A tensor that already is one passes through untouched; a
    Python number costs one host-to-device copy (the solver never passes
    one)."""
    dtype = like.dtype if dtype is None else dtype
    if isinstance(v, torch.Tensor):
        if v.dtype is dtype and v.device == like.device and v.numel() == 1:
            return v
        if v.numel() != 1:
            raise ValueError(f"{name} must hold one value, got {tuple(v.shape)}")
        if v.device == like.device:
            return v.to(dtype=dtype).reshape(())
    if torch.cuda.is_current_stream_capturing():
        # A host value inside a CUDA graph capture would be copied once,
        # at capture, and replayed as a constant: refuse it.
        raise RuntimeError(
            f"{name}: a host value ({type(v).__name__}) inside a CUDA graph "
            "capture; a captured step passes its scalars as 0-d tensors on "
            "the step's device"
        )
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=dtype).reshape(())
    return torch.tensor(v, dtype=dtype, device=like.device)


def _stream(y: Array) -> int:
    """The raw handle of the current stream on ``y``'s device.  Read the
    way Triton's launcher reads it: ``torch.cuda.current_stream`` builds a
    ``Stream`` object per call, which costs the host as much as an
    allocation, on a path whose every step is bound by the host."""
    return torch._C._cuda_getCurrentRawStream(y.device.index)


def fused_prox_momentum_plain(
    y: Array, grad: Array, x: Array, lr: Scalar, thresh: Scalar, gamma: Scalar
) -> tuple[Array, Array]:
    """Plain PyTorch version of the fused kernel (counterpart of
    ``fused_prox_momentum_xla``), in the kernel's operation order."""
    x_new = soft_threshold(y - lr * grad, thresh)
    return x_new, x_new + gamma * (x_new - x)


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
    _checked("fused_prox_momentum", y, grad, x)
    scal = [_scalar(nm, v, y) for nm, v in (("lr", lr), ("thresh", thresh), ("gamma", gamma))]
    x_new = torch.empty_like(y)
    y_new = torch.empty_like(y)
    fn = _build.entry(_SOURCE, f"zt_prox_momentum_{_SUFFIX[y.dtype]}", 8, _COUNT)
    code = fn(
        y.data_ptr(), grad.data_ptr(), x.data_ptr(),
        *(v.data_ptr() for v in scal),
        x_new.data_ptr(), y_new.data_ptr(),
        y.numel(), y.device.index, _stream(y),
    )
    _build.raise_on(code, _SOURCE, "fused_prox_momentum")
    launch_counts["fused_prox_momentum"] += 1
    return x_new, y_new


def fista_tail_plain(
    y: Array, grad: Array, x: Array, t: Array, lr: Scalar, lam: Scalar
) -> tuple[Array, Array, Array]:
    """Plain PyTorch version of :func:`fista_tail`: the chain of launches
    the kernel replaces, in its operation order."""
    t_new = torch.sqrt(t * t + 0.25) + 0.5
    gamma = (t - 1) / t_new
    x_new, y_new = fused_prox_momentum_plain(y, grad, x, lr, lr * lam, gamma)
    return x_new, y_new, t_new


def fista_tail(
    y: Array, grad: Array, x: Array, t: Array, lr: Scalar, lam: Scalar
) -> tuple[Array, Array, Array]:
    r"""The tail of one raw dense-LASSO FISTA step, one launch:
    ``t⁺ = √(t² + ¼) + ½``, ``gamma = (t − 1)/t⁺``, ``thresh = lr·lam``,
    then :func:`fused_prox_momentum`'s pass.  Returns ``(x⁺, y⁺, t⁺)``.

    ``t`` is a 0-d tensor; ``lr`` and ``lam`` are 0-d tensors on ``y``'s
    device on any path that must not read the device.  CPU tensors take
    :func:`fista_tail_plain`; CUDA tensors launch the kernel or raise.
    """
    if y.device.type == "cpu":
        return fista_tail_plain(y, grad, x, t, lr, lam)
    _checked("fista_tail", y, grad, x)
    scal = [_scalar(nm, v, y) for nm, v in (("t", t), ("lr", lr), ("lam", lam))]
    x_new = torch.empty_like(y)
    y_new = torch.empty_like(y)
    t_new = torch.empty_like(scal[0])
    fn = _build.entry(_SOURCE, f"zt_fista_tail_{_SUFFIX[y.dtype]}", 9, _COUNT)
    code = fn(
        y.data_ptr(), grad.data_ptr(), x.data_ptr(),
        *(v.data_ptr() for v in scal),
        x_new.data_ptr(), y_new.data_ptr(), t_new.data_ptr(),
        y.numel(), y.device.index, _stream(y),
    )
    _build.raise_on(code, _SOURCE, "fista_tail")
    launch_counts["fista_tail"] += 1
    return x_new, y_new, t_new


class StepTail(NamedTuple):
    """What the solver's LASSO step tail changes of the solver's state (the
    other fields pass through the step untouched)."""

    x: Array
    y: Array
    t: Array
    err: Array
    nit: Array
    nit_internal: Array
    converged: Array


def lasso_step_tail_plain(
    y: Array, grad: Array, x: Array, t: Array, lr: Array, lam: Scalar,
    err: Array, nit: Array, nit_internal: Array, converged: Array, failed: Array,
    *, a: float, b: float, tol: float, max_iter: int | None,
) -> StepTail:
    """Plain PyTorch version of :func:`lasso_step_tail`: the solver's
    fixed-step LASSO step after its gradient and the chunk loop's mask
    around it, launch for launch, in the kernel's operation order."""
    active = ~(converged | failed)
    if max_iter is not None:
        active = active & (nit < max_iter)
    t_new = torch.sqrt(t**2 - a * t + b) + 0.5
    gamma = (t - 1) / t_new
    x_new, y_new = fused_prox_momentum_plain(y, grad, x, lr, lr * lam, gamma)
    err_new = torch.amax(torch.abs(x_new - y))
    conv = err_new < tol
    new = StepTail(
        x_new,
        # Converged step: keep the old y/t (the JAX step's freeze).
        torch.where(conv, y, y_new),
        torch.where(conv, t, t_new),
        err_new,
        nit + 1,
        nit_internal + 1,
        conv,
    )
    old = (x, y, t, err, nit, nit_internal, converged)
    # The mask SELECTS, never multiplies: whatever a stopped state's step
    # computes, NaN included, never reaches the carry.
    return StepTail(*(torch.where(active, n, o) for n, o in zip(new, old)))


#: Per (device, stream): the two words the step-tail kernel folds its
#: grid-wide max through.  The kernel leaves them zero, so one buffer
#: serves every launch on its stream (launches there run in order).
_SCRATCH: dict[tuple[int, int], Array] = {}


def step_tail_scratch(device: torch.device) -> Array:
    """A fresh pair of the step tail's scratch words on ``device`` (zero,
    as every launch leaves them), for a caller that owns its own: a
    captured CUDA graph, which must neither allocate one nor share the
    stream's."""
    return torch.zeros(2, dtype=torch.int64, device=device)


def lasso_step_tail(
    y: Array, grad: Array, x: Array, t: Array, lr: Array, lam: Scalar,
    err: Array, nit: Array, nit_internal: Array, converged: Array, failed: Array,
    *, a: float, b: float, tol: float, max_iter: int | None,
    scratch: Array | None = None,
) -> StepTail:
    r"""The tail of the solver's fixed-step LASSO iteration, one launch.

    From the state's ``x, y, t, lr, err, nit, nit_internal, converged,
    failed`` and ``grad = ∇f(y)``: ``t⁺ = √(t² − a·t + b) + ½``,
    ``x⁺ = soft(y − lr·grad, lr·lam)``, ``y⁺ = x⁺ + ((t − 1)/t⁺)(x⁺ − x)``,
    ``err = max|x⁺ − y|``, ``converged = err < tol`` (then ``y`` and ``t``
    keep their old values), ``nit + 1``, ``nit_internal + 1``.  A state
    that is not active (converged, failed, or ``nit >= max_iter``) passes
    through: every output equals its input, so a chunk loop needs no
    mask around the step.  All outputs are fresh tensors.

    CPU tensors take :func:`lasso_step_tail_plain`; CUDA tensors launch
    the kernel or raise.  The scalars and flags are 0-d tensors on ``y``'s
    device (the solver's ``State`` fields); ``a, b, tol`` are Python
    numbers, rounded to ``y``'s dtype as PyTorch rounds them beside a
    tensor.  ``scratch`` (from :func:`step_tail_scratch`) is the kernel's
    two scratch words; by default the launch uses its stream's.
    """
    if y.device.type == "cpu":
        return lasso_step_tail_plain(
            y, grad, x, t, lr, lam, err, nit, nit_internal, converged, failed,
            a=a, b=b, tol=tol, max_iter=max_iter,
        )
    _checked("lasso_step_tail", y, grad, x)
    reals = [
        _scalar(nm, v, y)
        for nm, v in (("t", t), ("lr", lr), ("lam", lam), ("err", err))
    ]
    ints = [
        _scalar(nm, v, y, torch.int32)
        for nm, v in (("nit", nit), ("nit_internal", nit_internal))
    ]
    flags = [
        _scalar(nm, v, y, torch.bool)
        for nm, v in (("converged", converged), ("failed", failed))
    ]
    stream = _stream(y)
    if scratch is None:
        key = (y.device.index, stream)
        scratch = _SCRATCH.get(key)
        if scratch is None:
            scratch = _SCRATCH[key] = step_tail_scratch(y.device)
    out = StepTail(
        torch.empty_like(y),
        torch.empty_like(y),
        torch.empty_like(reals[0]),
        torch.empty_like(reals[0]),
        torch.empty_like(ints[0]),
        torch.empty_like(ints[0]),
        torch.empty_like(flags[0]),
    )
    fn = _build.entry(
        _SOURCE, f"zt_lasso_step_tail_{_SUFFIX[y.dtype]}", 19,
        (ctypes.c_double,) * 3 + (ctypes.c_int64,) + _COUNT,
    )
    code = fn(
        y.data_ptr(), grad.data_ptr(), x.data_ptr(),
        *(v.data_ptr() for v in (*reals, *ints, *flags, *out)),
        scratch.data_ptr(),
        float(a), float(b), float(tol),
        _NO_MAX_ITER if max_iter is None else int(max_iter),
        y.numel(), y.device.index, stream,
    )
    _build.raise_on(code, _SOURCE, "lasso_step_tail")
    launch_counts["lasso_step_tail"] += 1
    return out


def fista_step_dense_fused(A: Array, b: Array, lam: Scalar, lr: Scalar, carry):
    """One dense-LASSO FISTA step: two full-fp32 cuBLAS matvecs, then the
    fused tail (:func:`fista_tail`: the prox, the extrapolation and the
    t-update in one launch).  Counterpart of ``fista_step_dense_pallas``,
    and a drop-in for :func:`zfista_tpu_torch.models.lasso.fista_step_dense`.

    ``carry = (x, y, t)``; ``t``, ``lr`` and ``lam`` are 0-d tensors on
    ``A``'s device, so a loop of steps never reads the device.  A
    feature-sharded ``A`` (a column block, with ``x, y`` the feature
    blocks) all-reduces ``A @ y`` between the two matvecs; the tail runs on
    the local blocks, ``t`` replicated.
    """
    # Imported here: the parallel package imports the solver, which imports
    # this module.
    from zfista_tpu_torch.parallel.sharding import feature_sum

    x, y, t = carry
    grad = 2 * matmul_hp(A.T, feature_sum(A, matmul_hp(A, y)) - b)
    return fista_tail(y, grad, x, t, lr, lam)
