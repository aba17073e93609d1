"""Build and execute the PyTorch port's notebooks.

    python -m zfista_tpu_torch.examples.notebooks [--device cuda]  # build, execute, write
    python -m zfista_tpu_torch.examples.notebooks --no-exec         # build only

Counterpart of the JAX package's ``tools/gen_notebooks.py``: the cell
sources below are the single source of truth for
``examples/notebooks/getting_started_torch.ipynb`` and
``examples/notebooks/tv_deblur_torch.ipynb`` (the JAX notebooks' cells as
the port's calls), and ``tests/test_torch_notebooks.py`` holds the
committed files to them.  ``--device`` (default ``cuda``, which raises
without a card, as every entry point of the port does) is written into
each notebook's first code cell as ``DEVICE``, and every solve runs
there.  The committed files are built with ``--device cpu`` and carry a
CPU run's outputs.  ``nbformat`` and ``nbclient`` are imported only when
the notebooks are built.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "examples" / "notebooks"

_DEVICE_NOTE = """\
Every solve below runs on `DEVICE`, which the next cell pins to the
generator's `--device`.  The committed notebooks are a CPU run
(`--device cpu`); on a machine with an NVIDIA card set `DEVICE = "cuda"`
there (the port's default) and run the notebook again.  Nothing falls
back to the CPU on its own: without a card, `"cuda"` raises."""

GETTING_STARTED = [
    (
        "md",
        """\
# Getting started with `zfista_tpu_torch`

The PyTorch/CUDA port of `zfista_tpu`: single- and multi-objective
proximal gradient methods (FISTA with the momentum family of the
reference papers) in eager PyTorch, with hand-written CUDA kernels for
the hot loops on an NVIDIA H100.  This notebook walks the JAX package's
getting-started notebook with the port's calls: a scalar composite
problem, a multiobjective problem from the zoo, a lane-batched scenario
batch, and the quality metrics.

""" + _DEVICE_NOTE,
    ),
    (
        "setup",
        """\
import numpy as np
import torch

import zfista_tpu_torch

print(DEVICE, torch.__version__)""",
    ),
    (
        "md",
        """\
## 1. A scalar composite problem

Minimize $F(x) = f(x) + g(x)$ with smooth $f(x) = (x-1)^2$ and
nonsmooth $g(x) = 0.1\\,|x|$.  The solver needs $f$, $g$, an optional
Jacobian (``None`` → autodiff by `torch.func`), and the prox of the
weighted sum of $g$'s components — here plain soft-thresholding.  The
closed-form solution is $x^* = 1 - 0.1/2 = 0.95$.""",
    ),
    (
        "code",
        """\
f = lambda x: (x[0] - 1.0) ** 2
g = lambda x: 0.1 * torch.abs(x[0])
prox = lambda t, x: torch.sign(x) * torch.clamp_min(torch.abs(x) - 0.1 * t, 0.0)

res = zfista_tpu_torch.minimize_proximal_gradient(
    f, g, None, prox, np.array([3.0]), lr=0.4, nesterov=True, device=DEVICE
)
print(res.message)
print("x* =", float(res.x[0]), " nit =", res.nit)""",
    ),
    (
        "md",
        """\
## 2. A multiobjective problem from the zoo

`JOS1` is the classic convex bi-objective test problem
($f_1 = \\tfrac1n\\|x\\|^2$, $f_2 = \\tfrac1n\\|x-2\\|^2$).  Each solve
finds one Pareto-stationary point; the per-step subproblem (the dual of
the multiobjective descent step) is a bisection that runs on the device
with no host read.""",
    ),
    (
        "code",
        """\
from zfista_tpu_torch.models import JOS1

prob = JOS1(n_features=5)
r = prob.solve(np.full(5, 3.0), nesterov=True, tol=1e-6, device=DEVICE)
print("F(x*) =", np.asarray(r.fun))
print("nit =", r.nit, " success =", r.success)""",
    ),
    (
        "md",
        """\
## 3. Scenario batches: many solves as one lane-batched solve

The reference fans independent starts out to OS processes
(`joblib.Parallel`); the port runs every start as a lane of one solve:
the problem callables run over the lanes by `torch.func.vmap`, one
launch for all lanes, and the lanes can split over the ranks of a
`("batch", "model")` mesh (`zfista_tpu_torch.parallel.sharding`).""",
    ),
    (
        "code",
        """\
from zfista_tpu_torch.parallel import minimize_proximal_gradient_batch

rng = np.random.default_rng(0)
X0 = rng.uniform(-2.0, 4.0, size=(32, 5))
batch = minimize_proximal_gradient_batch(
    prob.f, prob.g, prob.jac_f, prob.prox_wsum_g, X0,
    nesterov=True, tol=1e-6, max_iter=2000, device=DEVICE,
)
print("converged:", int(np.asarray(batch.success).sum()), "/ 32")
print("mean nit:", float(np.asarray(batch.nit).mean()))""",
    ),
    (
        "md",
        """\
## 4. Front quality metrics

`calculate_metrics` reproduces the reference's metrics table (purity,
spread Γ/Δ, hypervolume, error rate, iteration/time averages) from
lists of per-solve results — `BatchResult.to_list()` explodes the
batch into exactly that.""",
    ),
    (
        "code",
        """\
from zfista_tpu_torch.metrics import calculate_metrics

# {metric name: {algorithm name: value}} — the reference's table layout
metrics, ratios = calculate_metrics(("accelerated", batch.to_list()))
for k, per_algo in sorted(metrics.items()):
    print(f"{k:28s} {per_algo['accelerated']:.6g}")""",
    ),
    (
        "md",
        """\
## 5. Momentum variants

The `(a, b)` momentum family of the reference papers is a solver
argument (`nesterov_ratio`), beside two opt-in options the reference
does not have: `adaptive_restart` (O'Donoghue–Candès) and
`project_momentum`.""",
    ),
    (
        "code",
        """\
for kw in (dict(nesterov_ratio=(0, 0.25)), dict(nesterov_ratio=(1, 1)),
           dict(adaptive_restart=True)):
    r = prob.solve(np.full(5, 3.0), nesterov=True, tol=1e-8, device=DEVICE, **kw)
    print(kw, "-> nit", r.nit)""",
    ),
]

TV_DEBLUR = [
    (
        "md",
        """\
# TV-regularized image deblurring

The imaging workload of the JAX package's `tv_deblur` notebook, with the
port's calls.  The TV prox is computed by FGP (FISTA on the dual) with a
fixed iteration budget inside the solver step; on a card it runs the
port's CUDA kernels (`zfista_tpu_torch/csrc/fgp_*.cu`), on the CPU their
plain PyTorch loop.

This notebook runs a small synthetic scene;
`python -m zfista_tpu_torch.examples.tv_deblur` runs the full-size
pipeline.

""" + _DEVICE_NOTE,
    ),
    (
        "setup",
        """\
import numpy as np
import torch

from zfista_tpu_torch.models.deblur import TVDeblur, gaussian_kernel, make_blur

print(DEVICE, torch.__version__)""",
    ),
    (
        "md",
        """\
## Build a blurred, noisy observation

A piecewise-constant scene (the regime TV shines in), blurred by a 9×9
Gaussian kernel — applied as two banded matmuls `G @ X @ Gᵀ` — plus
white noise.""",
    ),
    (
        "code",
        """\
size = 64
rng = np.random.default_rng(0)
truth = np.zeros((size, size), np.float32)
truth[size // 4 : 3 * size // 4, size // 4 : 3 * size // 4] = 1.0
truth[size // 2 :, : size // 2] = 0.5

kernel = gaussian_kernel(9, 2.0)
observed = make_blur(kernel)(torch.as_tensor(truth, device=DEVICE)).cpu().numpy()
observed += 0.01 * rng.standard_normal(observed.shape).astype(np.float32)
print("observed MSE vs truth:", float(np.mean((observed - truth) ** 2)))""",
    ),
    (
        "md",
        """\
## Solve $\\min_X \\|\\mathrm{blur}(X) - b\\|^2 + \\lambda\\,TV(X)$

`TVDeblur` wires the data term, its Jacobian (the true blur adjoint),
the TV value, and the FGP prox into the solver.  The prox is inexact
(fixed dual budget).""",
    ),
    (
        "code",
        """\
import warnings

prob = TVDeblur(observed, tv_ratio=1e-3, kernel=kernel, prox_iter=30, device=DEVICE)
with warnings.catch_warnings():
    # 300 iterations is this solve's budget: it stops there (status 0).
    warnings.simplefilter("ignore", UserWarning)
    res = prob.solve(max_iter=300, tol=1e-7)
restored = np.asarray(res.x).reshape(observed.shape)

mse_obs = float(np.mean((observed - truth) ** 2))
mse_rec = float(np.mean((restored - truth) ** 2))
print(f"MSE observed {mse_obs:.5f} -> restored {mse_rec:.5f} "
      f"({mse_obs / mse_rec:.1f}x better), nit={res.nit}")""",
    ),
    (
        "code",
        """\
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

fig, axes = plt.subplots(1, 3, figsize=(9, 3))
for ax, (img, title) in zip(
    axes,
    [(truth, "truth"), (observed, "observed"), (restored, "restored")],
):
    ax.imshow(img, cmap="gray", vmin=0, vmax=1)
    ax.set_title(title)
    ax.axis("off")
fig.tight_layout()""",
    ),
    (
        "md",
        """\
## Warm-dual fast path

Consecutive outer iterations see nearly identical prox inputs, so
`solve_warm` carries the dual field between prox calls and cuts the
per-call budget (`prox_iter=8`).""",
    ),
    (
        "code",
        """\
warm = prob.solve_warm(max_iter=300, tol=1e-7, prox_iter=8)
print(f"warm: F={warm['fun']:.6g} nit={warm['nit']} "
      f"(cold F={float(np.ravel(res.fun)[0]):.6g})")""",
    ),
    (
        "md",
        """\
## Checkpointing with a kernel pin

The FGP kernels equal the plain loop bitwise on the card, but a resume
that wants bitwise continuation must run the same implementation:
`checkpoint_meta()` records which one the prox resolves to here and the
image's device type (`utils.checkpoint.load_meta` reads them back).""",
    ),
    (
        "code",
        """\
print(prob.checkpoint_meta())""",
    ),
]

NOTEBOOKS = {
    "getting_started_torch.ipynb": GETTING_STARTED,
    "tv_deblur_torch.ipynb": TV_DEBLUR,
}


def cells(name: str, device: str) -> list[tuple[str, str]]:
    """The ``("md" | "code", source)`` cells of notebook ``name`` built
    for ``device``: its first code cell pins ``DEVICE``."""
    return [
        ("code", f'DEVICE = "{device}"  # "cpu", or "cuda" for the card\n\n{src}')
        if kind == "setup" else (kind, src)
        for kind, src in NOTEBOOKS[name]
    ]


def build(cells):
    """A notebook of ``cells`` (``("md" | "code", source)`` pairs)."""
    import nbformat

    nb = nbformat.v4.new_notebook()
    nb.metadata["kernelspec"] = {
        "name": "python3",
        "display_name": "Python 3",
        "language": "python",
    }
    for kind, src in cells:
        if kind == "md":
            nb.cells.append(nbformat.v4.new_markdown_cell(src))
        else:
            nb.cells.append(nbformat.v4.new_code_cell(src))
    return nb


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-exec", action="store_true", help="build only, no outputs")
    parser.add_argument("--device", default="cuda", help="the notebooks' DEVICE")
    args = parser.parse_args(argv)
    from zfista_tpu_torch.core.solver import data_device

    data_device(args.device)  # no card: raise before anything is written
    import nbformat

    OUT.mkdir(parents=True, exist_ok=True)
    for name in NOTEBOOKS:
        nb = build(cells(name, args.device))
        if not args.no_exec:
            from nbclient import NotebookClient

            client = NotebookClient(
                nb, timeout=900, kernel_name="python3",
                resources={"metadata": {"path": str(ROOT)}},
            )
            client.execute()
        nbformat.write(nb, OUT / name)
        n_out = sum(len(c.get("outputs", [])) for c in nb.cells)
        print(f"wrote {name}: {len(nb.cells)} cells, {n_out} outputs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
