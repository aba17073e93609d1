r"""CUDA-kernel-against-plain sweep for the fused LASSO kernel.

PyTorch-port counterpart of :mod:`zfista_tpu.bench.kernels` (which times
the Pallas kernel against XLA's fusion): the hand-written CUDA kernel of
``zfista_tpu_torch/csrc/fused_prox_momentum.cu`` against its plain
PyTorch version, on the card.  Two measurements per size:

* **chain** — the isolated elementwise chain (gradient step →
  soft-threshold → momentum extrapolation),
  :func:`~zfista_tpu_torch.ops.fused.fused_prox_momentum` against
  ``fused_prox_momentum_plain``: 5 n-vectors of HBM traffic per
  application, no matvecs.
* **step** — one full dense-LASSO FISTA step (2 cuBLAS matvecs + the
  chain) with a small row count,
  :func:`~zfista_tpu_torch.ops.fused.fista_step_dense_fused` against
  :func:`~zfista_tpu_torch.models.lasso.fista_step_dense`.

Each variant runs ``n_iter`` applications, each feeding its outputs back
as the next one's inputs, as eager launches queued behind a stream hold
and timed by CUDA events (least of 3 windows after a warm-up;
:func:`~zfista_tpu_torch.bench._card.held_ms`).  The kernel's chain is
the device's time, not the host's launch rate: the hold is lengthened
until the host has queued the whole chain before it runs out.  The plain
chain and the steps may launch more than the launch queue holds, so the
host may pace them.  Both variants are compared bitwise over the whole
carry first.

The first line printed is the card's name and power limit; then one JSON
row per measurement.  Without a CUDA device the CLI exits with status 1.

CLI: ``python -m zfista_tpu_torch.bench.kernels [--sizes 1e4,1e5,1e6,1e7]``
"""

from __future__ import annotations

import argparse
import json
from typing import Sequence

import numpy as np
import torch

from zfista_tpu_torch.bench._card import held_ms, require_card, same_bits

#: Windows timed per variant (the least is reported).
REPEATS = 3


def _check_bitwise(what: str, got, ref) -> None:
    for i, (a, b) in enumerate(zip(got, ref)):
        if not same_bits(a, b):
            raise AssertionError(f"{what}: kernel and plain carries differ in element {i}")


def sweep_chain(n: int, n_iter: int = 300) -> dict:
    """Isolated elementwise chain on the card: the CUDA kernel's one pass
    against the plain PyTorch launches, float32."""
    from zfista_tpu_torch.ops.fused import fused_prox_momentum, fused_prox_momentum_plain

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    y, grad, x = (
        torch.tensor(rng.standard_normal(n), dtype=torch.float32, device=dev) for _ in range(3)
    )
    lr, thresh, gamma = (
        torch.tensor(v, dtype=torch.float32, device=dev) for v in (1e-3, 1e-4, 0.5)
    )

    def loop(chain):
        def run():
            x_c, y_c = x, y
            for _ in range(n_iter):
                x_c, y_c = chain(y_c, grad, x_c, lr, thresh, gamma)
            return x_c, y_c

        return run

    run_k = loop(fused_prox_momentum)
    run_p = loop(fused_prox_momentum_plain)
    # Bit parity before timing, over the WHOLE carry (a fault confined to
    # the momentum output y would otherwise pass unnoticed).
    _check_bitwise(f"chain n={n}", run_k(), run_p())
    t_k = held_ms(run_k, REPEATS) * 1e-3
    # The plain chain's launches may outnumber what the launch queue holds.
    t_p = held_ms(run_p, REPEATS, device_bound=False) * 1e-3
    traffic = 5 * 4 * n * n_iter  # 3 reads + 2 writes, f32
    return dict(
        kind="chain",
        n=n,
        cuda_us_per_app=1e6 * t_k / n_iter,
        plain_us_per_app=1e6 * t_p / n_iter,
        cuda_gbps=traffic / t_k / 1e9,
        plain_gbps=traffic / t_p / 1e9,
        cuda_over_plain=t_p / t_k,
    )


def sweep_step(n: int, m: int = 256, n_iter: int = 300) -> dict:
    """Full FISTA step on the card, small ``m``: cuBLAS matvecs + the fused
    tail against the plain step, float32."""
    from zfista_tpu_torch.models.lasso import fista_step_dense
    from zfista_tpu_torch.ops.fused import fista_step_dense_fused

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    A = torch.tensor(rng.standard_normal((m, n)), dtype=torch.float32, device=dev) / np.sqrt(m)
    b = torch.tensor(rng.standard_normal(m), dtype=torch.float32, device=dev)
    lam, lr = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (0.01, 1e-3))
    x0 = torch.zeros(n, dtype=torch.float32, device=dev)
    carry = (x0, x0, torch.tensor(1.0, dtype=torch.float32, device=dev))

    def loop(step):
        def run():
            c = carry
            for _ in range(n_iter):
                c = step(A, b, lam, lr, c)
            return c

        return run

    run_k = loop(fista_step_dense_fused)
    run_p = loop(fista_step_dense)
    _check_bitwise(f"step n={n} m={m}", run_k(), run_p())  # x, y AND t
    # Over n_iter steps both may launch more than the launch queue holds
    # (5 launches a fused step, more a plain one), so the host may pace
    # either window.
    t_k = held_ms(run_k, REPEATS, device_bound=False) * 1e-3
    t_p = held_ms(run_p, REPEATS, device_bound=False) * 1e-3
    return dict(
        kind="step",
        n=n,
        m=m,
        cuda_iters_per_s=n_iter / t_k,
        plain_iters_per_s=n_iter / t_p,
        cuda_over_plain=t_p / t_k,
    )


def main(argv: Sequence[str] | None = None) -> list[dict]:
    parser = argparse.ArgumentParser(description="CUDA-kernel-against-plain sweep")
    parser.add_argument("--sizes", default="1e4,1e5,1e6,1e7")
    parser.add_argument("--step-sizes", default="1e5,1e6")
    parser.add_argument("--n-iter", type=int, default=300)
    args = parser.parse_args(argv)
    print(require_card("zfista_tpu_torch.bench.kernels"), flush=True)
    rows = []
    for sweep, sizes in ((sweep_chain, args.sizes), (sweep_step, args.step_sizes)):
        for s in sizes.split(","):
            if not s:
                continue
            rows.append(sweep(int(float(s)), n_iter=args.n_iter))
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
