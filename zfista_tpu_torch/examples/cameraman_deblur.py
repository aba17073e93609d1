r"""Wavelet-L1 image deblurring with a momentum-pair sweep.

Counterpart of the JAX package's ``examples/cameraman_deblur.py`` (itself
the script form of the reference's examples/cameraman.ipynb): blur a
256x256 test image with a 9x9 Gaussian (sigma=4), then recover it by
solving

    min_x ||blur(IDWT(x)) - b||^2 + 2e-5 * ||x||_1

with fixed-step accelerated proximal gradient (lr = 1/L from the blur
kernel's Fourier symbol) for each of the papers' 15 momentum pairs (a, b),
all 15 as one lane-batched solve, then each pair re-run as its own timed
solve.  The image is the deterministic synthetic one (the cameraman
photograph is not redistributable); ``--image`` takes any square grayscale
image instead (needs pillow).  Writes ``cameraman_ab.csv`` (rows ``a ,b,
time,nit``) and, where matplotlib is installed, ``cameraman_deblur.png``
under ``--out``.

Usage:
    python -m zfista_tpu_torch.examples.cameraman_deblur [--size 256]
        [--out bench_results/torch] [--device cuda]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch


def load_image(path: Path, size: int, device) -> torch.Tensor:
    """A grayscale image in [0, 1], center-cropped to square and resized to
    ``size`` x ``size`` (pillow, imported here)."""
    from PIL import Image

    pil = Image.open(path).convert("L")
    w, h = pil.size
    if w != h:
        side = min(w, h)
        left, top = (w - side) // 2, (h - side) // 2
        pil = pil.crop((left, top, left + side, top + side))
    if pil.size != (size, size):
        pil = pil.resize((size, size), Image.LANCZOS)
    return torch.tensor(np.asarray(pil, dtype=np.float64) / 255.0, device=device).float()


def main(argv: Sequence[str] | None = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--out", type=Path, default=Path("bench_results/torch"))
    parser.add_argument("--image", type=Path, default=None)
    parser.add_argument("--max-iter", type=int, default=2000)
    parser.add_argument("--tol", type=float, default=1e-5)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from zfista_tpu_torch.bench.momentum_sweep import AB_GRID, momentum_sweep, write_ab_csv
    from zfista_tpu_torch.core.solver import data_device
    from zfista_tpu_torch.models.deblur import (
        WaveletDeblur,
        gaussian_kernel,
        idwt2,
        make_blur,
        synthetic_cameraman,
    )

    device = data_device(args.device)
    if args.image is not None:
        img = load_image(args.image, args.size, device)
    else:
        img = synthetic_cameraman(args.size, device=device)

    kernel = gaussian_kernel(9, 4.0)
    observed = make_blur(kernel)(img)
    prob = WaveletDeblur(observed, l1_ratio=2e-5, kernel=kernel)
    lr = 1.0 / prob.lipschitz()
    x0 = prob.x0().cpu().numpy()

    # One shared batched sweep for the iteration counts and the recovered
    # image, then each (a, b) pair re-run as its own timed solve: the
    # `time` column is measured seconds of that pair's solve.
    t0 = time.perf_counter()
    rows, res = momentum_sweep(
        prob,
        0.0,
        0.0,  # box unused: the explicit deterministic start below
        n_starts=1,
        x0s=x0[None, :],
        measure_times=True,
        nesterov=True,
        lr=lr,
        decay_rate=1,
        tol=args.tol,
        max_iter=args.max_iter,
        check_every=8,
        device=device,
    )
    total = time.perf_counter() - t0

    out_csv = args.out / "cameraman_ab.csv"
    write_ab_csv(rows, out_csv)
    print(f"wrote {out_csv} ({total:.1f}s wall for all {len(AB_GRID)} pairs on {device})")
    for r in rows:
        if r["nit"] is None:
            print(f"  (a={r['a']}, b={r['b']}): no converged start")
        else:
            print(
                f"  (a={r['a']}, b={r['b']}): {r['nit']:.0f} iterations, "
                f"{r['time']:.3f}s measured"
            )

    ok = np.asarray(res.success, bool)
    try:
        import matplotlib
    except ImportError:
        return rows, res
    if not ok.any():
        # Unconverged lanes sit at max_iter: no recovered image to show.
        print("no converged pair; skipping the recovered-image figure")
        return rows, res
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    best = int(np.argmin(np.where(ok, np.asarray(res.nit, float), np.inf)))
    rec = idwt2(torch.tensor(res.x[best]).reshape(img.shape), prob.levels).numpy()
    fig, axes = plt.subplots(1, 3, figsize=(10, 3.5))
    for ax, (data, title) in zip(
        axes,
        [
            (img.cpu().numpy(), "original"),
            (observed.cpu().numpy(), "blurred"),
            (rec, f"recovered {AB_GRID[best]}"),
        ],
    ):
        ax.imshow(data, cmap="gray")
        ax.set_title(title, fontsize=9)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(args.out / "cameraman_deblur.png", dpi=120)
    plt.close(fig)
    print(f"wrote {args.out / 'cameraman_deblur.png'}")
    return rows, res


if __name__ == "__main__":
    main()
