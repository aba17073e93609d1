r"""TV/FGP prox kernel bench: the plain loop against the CUDA FGP kernel
the dispatch picks, cold and nested inside the deblurring solve.

PyTorch-port counterpart of :mod:`zfista_tpu.bench.tv_bench` (which times
XLA's ``fori_loop`` against the Pallas kernels), with its flags:

    python -m zfista_tpu_torch.bench.tv_bench [--sizes 256,512,1024]
        [--n-iter 30] [--calls 20] [--repeats 5] [--deblur-size 256]
        [--deblur-iters 200]

* **cold prox** — for each size, ``calls`` chained ``prox_tv`` calls (each
  output is the next input) on a float32 image: ``method="auto"``, which
  runs the kernel :func:`zfista_tpu_torch.ops.tv_cuda.resolve` picks
  (each row is labelled with it), against ``method="xla"``, the plain
  loop.  Each chain is queued behind a stream hold and timed by CUDA
  events, the least of ``repeats`` windows after a warm-up
  (:func:`~zfista_tpu_torch.bench._card.held_ms`: the kernel's chain is
  queued whole before the hold runs out; the plain loop's, more launches
  than the launch queue holds, is paced by the host);
* **nested** — ``TVDeblur.solve_warm`` on the JAX bench's scene, kernel
  against plain, wall seconds of a second call.

The kernels equal the plain loop bitwise on the card, so both chains'
outputs and both solves' iterates are compared bitwise (any difference
raises).  The first line printed is the card's name and power limit.
Without a CUDA device the CLI exits with status 1.
"""

from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np
import torch

from zfista_tpu_torch.bench._card import held_ms, require_card, same_bits

#: ``tv_cuda.resolve``'s answer -> the kernel's name (its wrapper, and its
#: entry in ``tv_cuda.launch_counts``).
KERNEL_OF = {"cuda_resident": "fgp_resident", "cuda_tiles": "fgp_tiles"}


def scene(size: int, device) -> tuple[np.ndarray, np.ndarray]:
    """The JAX bench's nested-deblur scene: two flat blocks, Gaussian 9x9
    sigma=2, noise 0.01 (numpy seed 0).  Returns the kernel and the
    observation (blurred in float64 on ``device``)."""
    from zfista_tpu_torch.models import deblur as td

    img = np.zeros((size, size))
    img[size // 4 : 3 * size // 4, size // 4 : 3 * size // 4] = 1.0
    img[size // 2 :, : size // 2] = 0.5
    kernel = td.gaussian_kernel(9, 2.0)
    observed = td.make_blur(kernel)(torch.tensor(img, device=device)).cpu().numpy()
    observed += 0.01 * np.random.default_rng(0).standard_normal(observed.shape)
    return kernel, observed


def cold(size: int, n_iter: int, calls: int, repeats: int, rng: np.random.Generator) -> dict:
    """One cold-prox row: device ms per call of the plain loop and of the
    kernel ``method="auto"`` picks for a float32 ``size`` x ``size`` image."""
    from zfista_tpu_torch.ops import tv_cuda
    from zfista_tpu_torch.ops.tv import prox_tv

    dev = torch.device("cuda", torch.cuda.current_device())
    v0 = torch.tensor(rng.standard_normal((size, size)), dtype=torch.float32, device=dev)
    lam = torch.tensor(0.1, dtype=torch.float32, device=dev)

    def chained(method: str):
        def run():
            u = v0
            for _ in range(calls):
                u = prox_tv(lam, u, n_iter=n_iter, method=method)
            return u

        return run

    kernel = KERNEL_OF[tv_cuda.resolve((size, size), torch.float32, dev)]
    if not same_bits(chained("auto")(), chained("xla")()):
        raise AssertionError(f"cold prox at {size}: {kernel} differs from the plain loop")
    plain_ms = held_ms(chained("xla"), repeats, device_bound=False) / calls
    kernel_ms = held_ms(chained("auto"), repeats) / calls
    return dict(size=size, kernel=kernel, plain_ms=plain_ms, kernel_ms=kernel_ms,
                speedup=plain_ms / kernel_ms)


def nested(size: int, max_iter: int) -> dict:
    """``TVDeblur.solve_warm`` (``prox_iter=8``, ``tol=0``) on :func:`scene`,
    with the prox's kernel and with the plain loop: wall seconds of the
    first and of a second call, nit and F.  The two solves' iterates are
    held bitwise equal."""
    from zfista_tpu_torch.models import TVDeblur
    from zfista_tpu_torch.ops import tv_cuda

    dev = torch.device("cuda", torch.cuda.current_device())
    kernel, observed = scene(size, dev)
    b = torch.tensor(observed, dtype=torch.float32, device=dev)
    out = {"size": size, "kernel": KERNEL_OF[tv_cuda.resolve((size, size), torch.float32, dev)]}
    xs = {}
    for method in ("xla", "auto"):
        prob = TVDeblur(b, tv_ratio=1e-3, kernel=kernel, prox_method=method)
        r = prob.solve_warm(max_iter=max_iter, tol=0.0, prox_iter=8)
        r2 = prob.solve_warm(max_iter=max_iter, tol=0.0, prox_iter=8)
        xs[method] = r2["x"]
        out[method] = dict(first_s=r["time"], s=r2["time"], nit=r2["nit"], fun=r2["fun"])
    if not np.array_equal(xs["auto"], xs["xla"]):
        raise AssertionError(f"nested solve at {size}: kernel and plain iterates differ")
    return out


def main(argv: Sequence[str] | None = None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--sizes", default="256,512,1024")
    parser.add_argument("--n-iter", type=int, default=30)
    parser.add_argument("--calls", type=int, default=20,
                        help="chained prox calls per timed window (cold bench)")
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--deblur-size", type=int, default=256)
    parser.add_argument("--deblur-iters", type=int, default=200)
    args = parser.parse_args(argv)
    print(require_card("zfista_tpu_torch.bench.tv_bench"), flush=True)

    rng = np.random.default_rng(0)
    print(f"\n== cold prox: {args.calls} chained prox calls per window, "
          f"n_iter={args.n_iter}, least of {args.repeats}, device ms per call ==")
    print(f"{'size':>6} {'kernel':>13} {'plain ms/call':>14} {'kernel ms/call':>15} {'speedup':>8}")
    rows = []
    for size in (int(s) for s in args.sizes.split(",") if s):
        r = cold(size, args.n_iter, args.calls, args.repeats, rng)
        rows.append(r)
        print(f"{size:>6} {r['kernel']:>13} {r['plain_ms']:>14.4f} {r['kernel_ms']:>15.4f} "
              f"{r['speedup']:>7.2f}x", flush=True)

    size = int(args.deblur_size)
    print(f"\n== nested: TVDeblur.solve_warm {size}x{size}, "
          f"max_iter={args.deblur_iters}, prox_iter=8 ==")
    nest = nested(size, int(args.deblur_iters))
    for method, label in (("xla", "plain"), ("auto", nest["kernel"])):
        r = nest[method]
        print(f"  {label:>12}: {r['s']:.4f} s second call ({r['first_s']:.4f} s first call), "
              f"nit={r['nit']}, F={r['fun']!r}", flush=True)
    return {"cold": rows, "nested": nest}


if __name__ == "__main__":
    main()
