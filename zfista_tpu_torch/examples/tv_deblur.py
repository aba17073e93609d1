r"""TV-regularized image deblurring beside the wavelet-L1 formulation.

Counterpart of the JAX package's ``examples/tv_deblur.py``: solves
``min_X ||blur(X) - b||^2 + lam * TV(X)`` on the image domain by
fixed-step accelerated proximal gradient (lr = 1/L), whose TV prox is the
FGP dual solver (on a card, one CUDA FGP kernel per prox call), then the
warm-dual fast path ``solve_warm``, then the wavelet-L1 formulation on
the same blurred, noisy observation, and reports each one's PSNR against
the ground truth.  Float32, as the JAX package computes by default.

Usage:
    python -m zfista_tpu_torch.examples.tv_deblur [--size 256] [--image path.png]
        [--tv-ratio 2e-4] [--l1-ratio 2e-5] [--max-iter 500] [--device cuda]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return float(10 * np.log10(peak**2 / mse)) if mse > 0 else np.inf


def main(argv: Sequence[str] | None = None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--image", type=Path, default=None)
    parser.add_argument("--tv-ratio", type=float, default=2e-4)
    parser.add_argument("--l1-ratio", type=float, default=2e-5)
    parser.add_argument("--noise", type=float, default=1e-3)
    parser.add_argument("--max-iter", type=int, default=500)
    parser.add_argument("--tol", type=float, default=1e-5)
    parser.add_argument("--prox-iter", type=int, default=30)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from zfista_tpu_torch.core.solver import data_device
    from zfista_tpu_torch.models.deblur import (
        TVDeblur,
        WaveletDeblur,
        gaussian_kernel,
        idwt2,
        make_blur,
        synthetic_cameraman,
    )

    device = data_device(args.device)
    if args.image is not None:
        from PIL import Image

        truth = np.asarray(Image.open(args.image).convert("L"), dtype=np.float64) / 255.0
    else:
        truth = synthetic_cameraman(args.size, dtype=torch.float64, device="cpu").numpy()

    kernel = gaussian_kernel()
    rng = np.random.default_rng(0)
    observed = make_blur(kernel)(torch.tensor(truth, device=device)).cpu().numpy()
    observed += args.noise * rng.standard_normal(observed.shape)
    b = torch.tensor(observed, dtype=torch.float32, device=device)
    print(f"observed PSNR: {psnr(observed, truth):.2f} dB ({device})")

    def timed_solve(prob, **kw):
        """(result, first wall, second wall) in seconds: the first call
        also builds the kernels and warms the caches."""
        t0 = time.perf_counter()
        prob.solve(**kw)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = prob.solve(**kw)
        return res, first, time.perf_counter() - t0

    out = {}
    tv = TVDeblur(b, tv_ratio=args.tv_ratio, kernel=kernel, prox_iter=args.prox_iter)
    res_tv, first_tv, warm_tv = timed_solve(tv, max_iter=args.max_iter, tol=args.tol)
    out["tv"] = psnr(res_tv.x.reshape(observed.shape), truth)
    print(
        f"TV       : {res_tv.nit:4d} it, {warm_tv:6.2f} s second run "
        f"({first_tv:6.2f} s first), PSNR {out['tv']:.2f} dB, "
        f"F={float(np.ravel(res_tv.fun)[0]):.6g}"
    )

    # Warm-dual fast path: FGP duals carried across outer iterations,
    # prox_iter=8 instead of 30.
    tv.solve_warm(max_iter=args.max_iter, tol=args.tol)
    warm = tv.solve_warm(max_iter=args.max_iter, tol=args.tol)
    out["tv_warm"] = psnr(warm["x"].reshape(observed.shape), truth)
    print(
        f"TV (warm): {warm['nit']:4d} it, {warm['time']:6.2f} s second run, "
        f"PSNR {out['tv_warm']:.2f} dB, F={warm['fun']:.6g}"
    )

    wl = WaveletDeblur(b, l1_ratio=args.l1_ratio)
    res_wl, first_wl, warm_wl = timed_solve(wl, max_iter=args.max_iter, tol=args.tol)
    rec_wl = idwt2(torch.tensor(res_wl.x).reshape(observed.shape), wl.levels).numpy()
    out["wavelet"] = psnr(rec_wl, truth)
    print(
        f"waveletL1: {res_wl.nit:4d} it, {warm_wl:6.2f} s second run "
        f"({first_wl:6.2f} s first), PSNR {out['wavelet']:.2f} dB, "
        f"F={float(np.ravel(res_wl.fun)[0]):.6g}"
    )
    return out


if __name__ == "__main__":
    main()
