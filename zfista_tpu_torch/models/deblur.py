r"""TV-regularized image deblurring, in PyTorch.

PyTorch-port counterpart of the TV half of :mod:`zfista_tpu.models.deblur`:
``min_X ||blur(X) - b||² + λ·TV(X)`` on the image domain (BASELINE
configs[1]; reference settings: 9×9 Gaussian σ=4, fixed step lr = 1/L).

* The blur of a separable symmetric kernel (the Gaussian, ``K = a aᵀ``) is
  ``G X Gᵀ`` with banded SAME matrices, two full-fp32 matrix products
  (:func:`~zfista_tpu_torch.ops.precision.matmul_hp`; the JAX package
  leaves them to XLA outside any Pallas kernel).  Any other kernel is a
  zero-padded correlation (``conv2d`` after an explicit ``F.pad``).
  ``adjoint=True`` gives the TRUE adjoint, which ``jac_f`` needs.
* The TV prox is :func:`zfista_tpu_torch.ops.tv.prox_tv`: on a CUDA image
  one of the hand-written FGP kernels per prox call, on a CPU image the
  plain loop.

The wavelet-L1 formulation (``WaveletDeblur``, ``dwt2``, ``idwt2``) runs no
kernel and is not ported yet (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import time as _time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from zfista_tpu_torch._typing import Array
from zfista_tpu_torch.core.solver import data_device, minimize_proximal_gradient, run_masked
from zfista_tpu_torch.ops import tv_cuda
from zfista_tpu_torch.ops.precision import conv2d_hp, matmul_hp
from zfista_tpu_torch.ops.tv import PIPELINED, check_method, prox_tv, tv2d


def gaussian_kernel(size: int = 9, sigma: float = 4.0) -> np.ndarray:
    """Normalized 2-D Gaussian blur kernel (reference nb cell 4)."""
    ax = np.arange(size) - (size - 1) / 2
    g = np.exp(-(ax**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float64)


def _band_matrix(taps: np.ndarray, n: int) -> np.ndarray:
    """SAME-zero-padded 1-D convolution as a banded ``(n, n)`` matrix:
    ``(Bx)_i = sum_d taps[d+c] x_{i+d}`` with out-of-range terms dropped
    (== the conv's zero padding).  Only odd-length ``taps``."""
    c = (len(taps) - 1) // 2
    B = np.zeros((n, n))
    for d in range(-c, c + 1):
        if abs(d) < n:
            B += np.diag(np.full(n - abs(d), taps[d + c]), k=d)
    return B


def _separable_taps(k_np: np.ndarray) -> np.ndarray | None:
    """1-D taps such that ``K == taps tapsᵀ``, or None.

    The reconstruction check rejects even-length kernels, negative-definite
    rank-1 kernels and anything numerically non-separable; those use the
    correlation path instead.
    """
    if k_np.ndim != 2 or k_np.shape[0] != k_np.shape[1]:
        return None
    if k_np.shape[0] % 2 == 0:
        return None
    u_, s_, _ = np.linalg.svd(k_np)
    taps = u_[:, 0] * np.sqrt(s_[0])
    if not np.allclose(k_np, np.outer(taps, taps), atol=1e-12):
        return None
    return taps


def _same_pad(kh: int, kw: int, adjoint: bool) -> tuple[int, int, int, int]:
    """``F.pad`` widths (left, right, top, bottom) of the SAME correlation.

    XLA's SAME pads ``((k-1)//2, k//2)`` per dim.  The adjoint of a
    zero-padded correlation is correlation with the flipped kernel under
    the SWAPPED padding: for odd kernels the two agree, for even ones the
    operator would be off by a pixel (``padding="same"`` cannot express
    the swap)."""
    if adjoint:
        return kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2
    return (kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2


def _correlate(img: Array, K: Array, pad: tuple[int, int, int, int]) -> Array:
    x = F.pad(img[None, None, :, :], pad)
    return conv2d_hp(x, K[None, None, :, :].to(img.dtype))[0, 0]


def make_blur(kernel: np.ndarray, adjoint: bool = False) -> Callable[[Array], Array]:
    """SAME-padded 2-D convolution ``image -> blurred image``.

    Separable symmetric kernels go to ``G @ X @ Gᵀ`` with banded SAME
    matrices (boundary semantics identical to the conv's zero padding);
    anything else to a zero-padded correlation.  ``adjoint=True`` returns
    the TRUE adjoint ``blur*`` (``Gᵀ @ X @ G``; correlation with the doubly
    flipped kernel under swapped padding).
    """
    k_np = np.asarray(kernel, np.float64)
    taps = _separable_taps(k_np)
    # Device copies of the operands, built once per (size, dtype, device).
    cache: dict[Any, Array] = {}

    if taps is not None:

        def band(n: int, like: Array) -> Array:
            key = (n, like.dtype, like.device)
            B = cache.get(key)
            if B is None:
                B = cache[key] = torch.as_tensor(
                    _band_matrix(taps, n), dtype=like.dtype, device=like.device
                )
            return B

        def blur(img: Array) -> Array:
            Gr = band(img.shape[-2], img)
            Gc = band(img.shape[-1], img)
            if adjoint:  # <Gr X Gcᵀ, Y> = <X, Grᵀ Y Gc>
                return matmul_hp(matmul_hp(Gr.T, img), Gc)
            return matmul_hp(matmul_hp(Gr, img), Gc.T)

        return blur

    k_use = np.ascontiguousarray(k_np[::-1, ::-1] if adjoint else k_np)
    pad = _same_pad(*k_np.shape, adjoint)

    def blur_conv(img: Array) -> Array:
        key = (img.dtype, img.device)
        K = cache.get(key)
        if K is None:
            K = cache[key] = torch.as_tensor(k_use, dtype=img.dtype, device=img.device)
        return _correlate(img, K, pad)

    return blur_conv


def blur_lipschitz(kernel: np.ndarray, shape: tuple[int, int]) -> float:
    """``L = 2·max|F(kernel)|²`` — spectral bound on ``2‖A‖²`` for
    ``f = ‖Ax−b‖²`` (the circular-padding symbol upper-bounds the
    SAME-padded operator norm)."""
    sym = np.fft.fft2(kernel, s=shape)
    return float(2 * np.max(np.abs(sym)) ** 2)


def synthetic_cameraman(
    size: int = 256, dtype: torch.dtype | None = None, device: Any = "cuda"
) -> Array:
    """Deterministic synthetic test image, built with numpy in float64 (the
    JAX package's construction): piecewise-constant regions, gradients and
    a few edges.  ``dtype`` defaults to torch's default dtype.  The image
    goes to ``device`` (default ``"cuda"``; a machine with no card raises,
    ``device="cpu"`` asks for the CPU)."""
    i = np.arange(size)[:, None] / size
    j = np.arange(size)[None, :] / size
    img = 0.3 + 0.4 * (i > 0.5) + 0.2 * (j > 0.3)
    img = img + 0.15 * np.sin(6.28 * 3 * i) * (j < 0.6)
    disk = ((i - 0.35) ** 2 + (j - 0.65) ** 2) < 0.04
    img = np.where(disk, 0.9, img)
    tri = (i + j > 1.3) & (i + j < 1.5)
    img = np.where(tri, 0.1, img)
    dtype = torch.get_default_dtype() if dtype is None else dtype
    return torch.as_tensor(img, dtype=dtype, device=data_device(device))


def _as_image(observed: Any, device: Any) -> Array:
    if isinstance(observed, torch.Tensor):
        b = observed
    else:  # a copy: the caller's array may change later
        b = torch.tensor(np.asarray(observed), device=data_device(device))
    if not b.is_floating_point():
        b = b.to(torch.get_default_dtype())
    return b


class TVDeblur:
    """Composite problem ``F(X) = ‖blur(X) − b‖² + λ·TV(X)`` on the image
    domain.

    ``x`` is the flattened image; the TV prox is the fixed-budget FGP of
    :func:`zfista_tpu_torch.ops.tv.prox_tv` (``prox_iter`` dual iterations
    per outer prox call), so it is INEXACT; with the fixed step
    ``lr = 1/L`` the inexactness acts as a small perturbation.  The solve
    runs on ``observed``'s device: a tensor keeps its own (a CPU tensor
    asks for the CPU), and a numpy image goes to ``device`` (default
    ``"cuda"``; a machine with no card raises).

    ``prox_method``: ``"auto"`` (default) and ``"pallas"`` run a CUDA FGP
    kernel per prox call on a CUDA image and the plain loop on a CPU one;
    ``"cuda_tiles_pipelined"`` pins the pipelined tile kernel on a CUDA
    image; ``"xla"`` forces the plain loop everywhere.
    """

    def __init__(
        self,
        observed: Any,
        tv_ratio: float = 2e-4,
        kernel: np.ndarray | None = None,
        prox_iter: int = 30,
        isotropic: bool = True,
        prox_method: str = "auto",
        device: Any = "cuda",
    ) -> None:
        self.b = _as_image(observed, device)
        if self.b.ndim != 2:
            raise ValueError("observed must be a 2-D image")
        self.kernel = gaussian_kernel() if kernel is None else kernel
        self.tv_ratio = float(tv_ratio)
        self.prox_iter = int(prox_iter)
        self.isotropic = bool(isotropic)
        self.prox_method = check_method(str(prox_method))
        self._blur = make_blur(self.kernel)
        self._blur_T = make_blur(self.kernel, adjoint=True)
        self.n_objectives = 1
        self.n_features = int(self.b.shape[0] * self.b.shape[1])

    def _image(self, x: Array) -> Array:
        return torch.reshape(x, self.b.shape)

    def f(self, x: Array) -> Array:
        r = self._blur(self._image(x)) - self.b
        return torch.reshape(torch.sum(r * r), (1,))

    def jac_f(self, x: Array) -> Array:
        r = self._blur(self._image(x)) - self.b
        return 2 * torch.reshape(self._blur_T(r), (1, -1))

    def g(self, x: Array) -> Array:
        val = tv2d(self._image(x), self.isotropic)
        return torch.reshape(self.tv_ratio * val, (1,))

    def prox_wsum_g(self, weight: Any, x: Array) -> Array:
        u = prox_tv(
            torch.as_tensor(weight, dtype=x.dtype, device=x.device) * self.tv_ratio,
            self._image(x),
            n_iter=self.prox_iter,
            isotropic=self.isotropic,
            method=self.prox_method,
        )
        return torch.reshape(u, (-1,))

    def lipschitz(self) -> float:
        return blur_lipschitz(self.kernel, tuple(self.b.shape))

    def x0(self) -> Array:
        """Warm start at the observed image itself."""
        return torch.reshape(self.b, (-1,))

    def checkpoint_meta(self) -> dict[str, str]:
        """Configuration pins for a saved solver state.

        ``prox_kernel`` names the FGP implementation the prox resolves to
        here (:data:`zfista_tpu_torch.ops.tv_cuda.KERNEL_NAMES`), and
        ``backend`` is the image's device type.  The kernels equal the plain
        loop bitwise on the card, but a resume that wants bitwise
        continuation should still compare the recorded kernel.
        """
        if self.prox_method == "xla" or self.b.device.type != "cuda":
            resolved = "plain"
        elif self.prox_method == PIPELINED:
            resolved = PIPELINED
        else:
            resolved = tv_cuda.resolve(tuple(self.b.shape), self.b.dtype, self.b.device)
        return {
            "problem": "TVDeblur",
            "prox_method": self.prox_method,
            "prox_kernel": resolved,
            "backend": self.b.device.type,
            "prox_iter": str(self.prox_iter),
            "isotropic": str(self.isotropic),
            "tv_ratio": repr(self.tv_ratio),
        }

    def _bands(self) -> tuple[Array, Array] | None:
        """Banded blur matrices ``(Gr, Gc)`` on the image's device, built
        once per instance, or None for non-separable kernels."""
        bands = getattr(self, "_bands_cache", False)
        if bands is False:
            taps = _separable_taps(np.asarray(self.kernel, np.float64))
            if taps is None:
                bands = None
            else:
                dt, dev = self.b.dtype, self.b.device
                bands = (
                    torch.as_tensor(_band_matrix(taps, self.b.shape[0]), dtype=dt, device=dev),
                    torch.as_tensor(_band_matrix(taps, self.b.shape[1]), dtype=dt, device=dev),
                )
            self._bands_cache = bands
        return bands

    def solve(self, **kwargs: Any):
        """Fixed-step accelerated solve at ``lr = 1/L`` (decay_rate=1,
        nesterov=True), through the module-level params-style callables of
        :func:`_tv_deblur_callables` with ``(b, Gr, Gc, lam)`` (separable)
        or ``(b, K, lam)`` as params.

        .. warning:: The instance is FROZEN after the first call (the
           params tuple is cached); build a new instance per observation.
        """
        if "lr" not in kwargs:
            kwargs["lr"] = 1.0 / self.lipschitz()
        kwargs.setdefault("decay_rate", 1)
        kwargs.setdefault("nesterov", True)
        x0 = kwargs.pop("x0") if "x0" in kwargs else self.x0()
        p = getattr(self, "_params", None)
        if p is None:
            dt, dev = self.b.dtype, self.b.device
            lam = torch.tensor(self.tv_ratio, dtype=dt, device=dev)
            bands = self._bands()
            if bands is not None:
                p = (self.b, *bands, lam)
            else:
                p = (self.b, torch.as_tensor(self.kernel, dtype=dt, device=dev), lam)
            self._params = p
        fns = _tv_deblur_callables(
            self.prox_iter,
            self.isotropic,
            separable=len(p) == 4,
            prox_method=self.prox_method,
        )
        return minimize_proximal_gradient(*fns, x0, params=p, **kwargs)

    def solve_warm(
        self,
        max_iter: int = 500,
        tol: float = 1e-5,
        prox_iter: int = 8,
    ) -> dict:
        """Warm-dual fast path: fixed-step FISTA with the TV prox's FGP dual
        carried ACROSS outer iterations (:func:`_tv_warm_driver`), so a
        small inner budget (``prox_iter=8``) reaches cold-start quality.
        Separable symmetric kernels only.  Returns
        ``{x, fun, nit, error_criterion, time}`` with ``x`` a numpy array.
        """
        bands = self._bands()
        if bands is None:
            raise ValueError(
                "solve_warm requires a separable symmetric odd-size kernel"
            )
        start = _time.perf_counter()
        dt, dev = self.b.dtype, self.b.device
        Gr, Gc = bands
        X, F_, nit, err, _ = _tv_warm_driver(
            self.b,
            Gr,
            Gc,
            torch.tensor(self.tv_ratio, dtype=dt, device=dev),
            torch.tensor(1.0 / self.lipschitz(), dtype=dt, device=dev),
            torch.tensor(tol, dtype=dt, device=dev),
            int(max_iter),
            int(prox_iter),
            self.isotropic,
            self.prox_method,
        )
        return {
            "x": X.cpu().numpy().reshape(-1),
            "fun": float(F_),
            "nit": int(nit),
            "error_criterion": float(err),
            "time": _time.perf_counter() - start,
        }


class _WarmCarry(NamedTuple):
    """The carry of :func:`_tv_warm_driver` (the JAX loop's tuple)."""

    X: Array  # extrapolated point
    X_old: Array  # last prox output
    t: Array  # momentum t_k
    p: Array  # FGP dual field, carried across outer iterations
    q: Array
    k: Array  # outer iterations completed (int32)
    err: Array  # last ||x - y||_inf


def _tv_warm_driver(
    b: Array,
    Gr: Array,
    Gc: Array,
    lam: Array,
    lr: Array,
    tol: Array,
    max_iter: int,
    prox_iter: int,
    isotropic: bool,
    prox_method: str = "auto",
    check_every: int | None = None,
):
    """The warm-dual TV-deblur solve as an eager loop; the counterpart of
    the JAX package's ``_tv_warm_driver`` (one XLA ``while_loop``).

    Fixed-step FISTA ``(a,b)=(0,0.25)`` on ``||blur(X)-b||² + lam·TV(X)``,
    each prox call's FGP dual WARM-STARTED from the previous outer
    iteration's.  The carry is ``(X, X_old, t, p, q, k, err)`` (``X`` is the
    extrapolated point); it stops when ``err < tol`` or ``k == max_iter``.
    ``check_every`` (default 64 on a CUDA device, else 1) sets how often
    the host reads that; every value gives the same result.  Returns
    ``(X, F, nit, err, dual)``.
    """
    if check_every is None:
        check_every = 64 if b.device.type == "cuda" else 1

    def blur(X: Array) -> Array:
        return matmul_hp(matmul_hp(Gr, X), Gc.T)

    def blur_T(Y: Array) -> Array:
        # true adjoint (bitwise equal to blur for symmetric bands)
        return matmul_hp(matmul_hp(Gr.T, Y), Gc)

    def grad_f(X: Array) -> Array:
        return 2.0 * blur_T(blur(X) - b)

    z = torch.zeros_like(b)
    carry0 = _WarmCarry(
        X=b,
        X_old=b,
        t=torch.ones((), dtype=b.dtype, device=b.device),
        p=z,
        q=z,
        k=torch.zeros((), dtype=torch.int32, device=b.device),
        err=torch.full((), float("inf"), dtype=b.dtype, device=b.device),
    )

    def active(c: _WarmCarry) -> Array:
        return (c.err >= tol) & (c.k < max_iter)

    def body(c: _WarmCarry) -> _WarmCarry:
        X, X_old, t, pd, qd, k, _ = c
        y = X
        step_in = y - lr * grad_f(y)
        x_new, (pd_n, qd_n) = prox_tv(
            lr * lam,
            step_in,
            n_iter=prox_iter,
            isotropic=isotropic,
            return_dual=True,
            dual0=(pd, qd),
            method=prox_method,
        )
        err = torch.amax(torch.abs(x_new - y))
        t_new = torch.sqrt(t * t + 0.25) + 0.5
        y_new = x_new + ((t - 1.0) / t_new) * (x_new - X_old)
        return _WarmCarry(y_new, x_new, t_new, pd_n, qd_n, k + 1, err)

    _, x_f, _, pd_f, qd_f, nit, err = run_masked(body, carry0, active, int(check_every))
    r = blur(x_f) - b
    F_ = torch.sum(r * r) + lam * tv2d(x_f, isotropic)
    return x_f, F_, nit, err, (pd_f, qd_f)


#: Params-style callables for TVDeblur.solve, one set per static config.
#: Params layout: (b, Gr, Gc, lam) separable, else (b, K, lam).
_TV_CALLABLES: dict = {}


def _tv_deblur_callables(
    prox_iter: int, isotropic: bool, separable: bool, prox_method: str = "auto"
):
    key = (int(prox_iter), bool(isotropic), bool(separable), str(prox_method))
    fns = _TV_CALLABLES.get(key)
    if fns is not None:
        return fns

    if separable:

        def blur_p(X: Array, p) -> Array:
            _, Gr, Gc, _ = p
            return matmul_hp(matmul_hp(Gr.to(X.dtype), X), Gc.to(X.dtype).T)

        def blur_T_p(Y: Array, p) -> Array:
            # true adjoint: <Gr X Gcᵀ, Y> = <X, Grᵀ Y Gc>; equals blur_p
            # bitwise for centro-symmetric kernels (symmetric bands)
            _, Gr, Gc, _ = p
            return matmul_hp(matmul_hp(Gr.to(Y.dtype).T, Y), Gc.to(Y.dtype))

    else:

        def blur_p(X: Array, p) -> Array:
            K = p[1]
            return _correlate(X, K, _same_pad(*K.shape, adjoint=False))

        def blur_T_p(Y: Array, p) -> Array:
            # true adjoint of the SAME zero-padded correlation: the doubly
            # flipped kernel under SWAPPED padding (see _same_pad)
            K = p[1]
            return _correlate(
                Y, torch.flip(K, (0, 1)), _same_pad(*K.shape, adjoint=True)
            )

    def f_p(x, p):
        b = p[0]
        r = blur_p(torch.reshape(x, b.shape), p) - b
        return torch.reshape(torch.sum(r * r), (1,))

    def jac_p(x, p):
        b = p[0]
        r = blur_p(torch.reshape(x, b.shape), p) - b
        return 2 * torch.reshape(blur_T_p(r, p), (1, -1))

    def g_p(x, p):
        b, lam = p[0], p[-1]
        val = tv2d(torch.reshape(x, b.shape), isotropic)
        return torch.reshape(lam * val, (1,))

    def prox_p(w, x, p):
        b, lam = p[0], p[-1]
        w = w[0] if getattr(w, "ndim", 0) else w
        u = prox_tv(
            w * lam,
            torch.reshape(x, b.shape),
            n_iter=prox_iter,
            isotropic=isotropic,
            method=prox_method,
        )
        return torch.reshape(u, (-1,))

    fns = _TV_CALLABLES[key] = (f_p, g_p, jac_p, prox_p)
    return fns
