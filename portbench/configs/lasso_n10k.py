"""``lasso_n10k``'s data recipe and the program objects it builds.

The headline instance of ``bench.py``'s recipe, drawn on the device with a
``torch.Generator`` there: ``A`` Gaussian over ``sqrt(m)``, a
``support``-sparse Gaussian truth, ``b = A x_true + noise * Gaussian``.
A run solves a fixed set of such instances, one drawn from each of the
configuration's ``instances`` seeds, so that every ``--seed`` gives the
same work: the iterations an instance takes, and the chunks of the
solver's graphs they fill, differ from instance to instance.  ``--seed``
draws the order in which the calls take them (:func:`instance`).  Every
call starts from ``x0 = 0``.
"""

from __future__ import annotations

import math

import numpy as np


def _instance(spec: dict, seed: int, device) -> dict:
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed))
    m, n, dt = spec["m"], spec["n"], getattr(torch, spec["dtype"])
    A = torch.randn(m, n, generator=gen, dtype=dt, device=device) / math.sqrt(m)
    idx = torch.randperm(n, generator=gen, device=device)[: spec["support"]]
    x_true = torch.zeros(n, dtype=dt, device=device)
    x_true[idx] = torch.randn(idx.numel(), generator=gen, dtype=dt, device=device)
    b = A @ x_true + spec["noise"] * torch.randn(m, generator=gen, dtype=dt, device=device)
    return {"A": A, "b": b, "lam": float(spec["lam"])}


def make_data(spec: dict, seed: int, device) -> dict:
    return {"instances": [_instance(spec, s, device) for s in spec["instances"]]}


def build(spec: dict, data: dict) -> list:
    from zfista_tpu_torch.models.lasso import Lasso

    return [Lasso(d["A"], d["b"], d["lam"]) for d in data["instances"]]


def instance(spec: dict, seed: int, call: int) -> int:
    """The instance that call ``call`` (>= 0) solves: each round of as many
    calls as there are instances takes every instance once, in an order
    drawn from the seed and the round's index."""
    count = len(spec["instances"])
    rng = np.random.default_rng([int(seed), int(call) // count + 2**32])
    return int(rng.permutation(count)[int(call) % count])


def starts(spec: dict, seed: int, call: int, count: int) -> np.ndarray:
    return np.zeros((count, spec["n"]), dtype=spec["dtype"])
