r"""Plain reference for ``lasso_n10k``: FISTA on ``||A x - b||^2 + lam ||x||_1``.

``f = ||A x - b||^2`` (no 1/2), so ``grad f = 2 A^T (A x - b)`` and
``L = 2 lambda_max(A^T A)``.  Two solvers, each from its equations:

* ``fixed``: FISTA at ``lr = 1/L``, where ``lambda_max`` comes from 50
  power iterations on ``v -> A^T (A v)`` from the start vector that the
  solver's documented recipe draws (``torch.randn(n)`` in ``A``'s dtype
  from a generator on ``A``'s device seeded with 0), here carried out in
  the reference's own dtype.
* ``backtrack``: FISTA from ``lr`` with the step halved until
  ``f(x+) <= f(y) + grad f(y).(x+ - y) + ||x+ - y||^2 / (2 lr) + tol_internal``;
  the step carries over to the next iteration.

Both take the momentum ``t <- sqrt(t^2 - a t + b) + 1/2`` and stop at the
first iteration whose ``||x+ - y||_inf < tol``, or after ``iterations``
iterations where the judge asks for the program's own count: the
iteration at which ``||x+ - y||_inf`` first dips under ``tol`` is not
reproducible across precisions, the iterates up to it are, and so is
how far ``||x+ - y||_inf`` lies from ``tol`` at the program's stop.  ``tf32=True`` rounds every matrix product's
operands to TF32 (10 explicit mantissa bits, round to nearest even), as
the tensor cores' TF32 mode does, and accumulates in the working dtype.

Plain PyTorch, any device; it imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """``v`` (float32) rounded to TF32's 10 mantissa bits, nearest even."""
    bits = v.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class Operator:
    """``A`` in the reference's dtype, its products (TF32 operands when
    asked) and the LASSO data."""

    def __init__(self, A: torch.Tensor, b: torch.Tensor, lam: float, dtype, tf32: bool = False):
        self.A = A.to(dtype)
        if tf32:
            self.A = round_tf32(self.A)
        self.b = b.to(dtype)
        self.lam = lam
        self.tf32 = tf32

    def _v(self, v: torch.Tensor) -> torch.Tensor:
        return round_tf32(v) if self.tf32 else v

    def matvec(self, v):
        return self.A @ self._v(v)

    def rmatvec(self, r):
        return self.A.T @ self._v(r)

    def grad(self, x):
        return 2 * self.rmatvec(self.matvec(x) - self.b)

    def f(self, x):
        r = self.matvec(x) - self.b
        return r @ r

    def lipschitz(self, n_iter: int = 50, seed: int = 0, like: torch.Tensor | None = None) -> float:
        """``2 lambda_max(A^T A)`` by the solver's power-iteration recipe;
        the start vector is drawn like ``like`` (the program's operator:
        its dtype and device)."""
        like = self.A if like is None else like
        gen = torch.Generator(device=like.device).manual_seed(seed)
        v = torch.randn(like.shape[1], generator=gen, dtype=like.dtype, device=like.device)
        v = v.to(self.A.dtype)
        v = v / torch.linalg.vector_norm(v)
        for _ in range(n_iter):
            w = self.rmatvec(self.matvec(v))
            v = w / torch.clamp_min(torch.linalg.vector_norm(w), 1e-30)
        return float(2 * (v @ self.rmatvec(self.matvec(v))))


def soft_threshold(x, thresh):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - thresh, 0)


def solve(
    op: Operator,
    x0: torch.Tensor,
    *,
    lr: float | None = None,
    tol: float = 1e-5,
    tol_internal: float = 1e-12,
    max_iter: int = 1_000_000,
    max_backtrack_iter: int = 100,
    decay_rate: float = 0.5,
    nesterov_ratio: tuple[float, float] = (0.0, 0.25),
    iterations: int | None = None,
    **_ignored,
) -> dict:
    """FISTA from ``x0``; ``decay_rate == 1`` is the fixed step at ``lr``.
    ``iterations`` runs exactly that many iterations, with no stop test.
    Returns ``x``, ``nit``, ``lr``, ``status`` (1 converged, 0 at
    ``max_iter`` or ``iterations``, 2 line search exhausted) and ``errs``,
    ``||x_k - y_{k-1}||_inf`` of each iteration ``k = 1 .. nit``."""
    if iterations is not None:
        max_iter, tol = iterations, -1.0
    a, b = nesterov_ratio
    lam = op.lam
    x = x0.to(op.A.dtype).clone()
    y = x.clone()
    t = 1.0
    status = 0
    nit = 0
    errs = []
    while nit < max_iter:
        g_y = op.grad(y)
        if decay_rate == 1:
            x_new = soft_threshold(y - lr * g_y, lr * lam)
        else:
            f_y = op.f(y)
            for _k in range(max_backtrack_iter):
                x_new = soft_threshold(y - lr * g_y, lr * lam)
                d = x_new - y
                model = f_y + g_y @ d + (d @ d) / (2 * lr)
                if bool(op.f(x_new) <= model + tol_internal):
                    break
                lr = lr * decay_rate
            else:
                status = 2
                break
        err = float(torch.amax(torch.abs(x_new - y)))
        errs.append(err)
        nit += 1
        if err < tol:
            x = x_new
            status = 1
            break
        t_new = (t * t - a * t + b) ** 0.5 + 0.5
        y = x_new + ((t - 1) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return {"x": x, "nit": nit, "lr": lr, "status": status, "errs": errs}


#: The control's iteration cap: a TF32 solve may never meet ``tol``.
CONTROL_MAX_ITER = 5000


def lane_instances(calls: list[dict]) -> list[int]:
    """The instance of every lane of ``calls``, in their order."""
    return [int(c.get("instance", 0)) for c in calls for _ in c["x0"]]


def answers(
    traffic: dict, data: dict, x0s, dtype, tf32: bool = False,
    max_iter: int | None = None, iterations=None, instances=None,
) -> list[dict]:
    """What the traffic's calls compute, solved by the reference from
    each row of ``x0s`` on the instance ``instances[i]`` of ``data``
    (``data`` itself where it holds one), in ``dtype`` (TF32 products
    where asked), to its own stop or over ``iterations[i]`` iterations
    for row ``i``: ``x``, ``lr``, ``nit``, ``status`` and ``errs`` of
    each.  Rows alike are solved once; the instances one at a time."""
    insts = data.get("instances", [data])
    rows = [0 if instances is None else int(instances[i]) for i in range(len(x0s))]
    out, seen = [None] * len(x0s), {}
    for at in sorted(set(rows)):
        inst = insts[at]
        opts = dict(traffic["options"])
        op = Operator(inst["A"], inst["b"], inst["lam"], dtype, tf32)
        if traffic["method"] == "solve_fixed_step":
            opts["lr"] = 1.0 / op.lipschitz(like=inst["A"])
            opts["decay_rate"] = 1
        if max_iter is not None:
            opts["max_iter"] = max_iter
        for i in (i for i, r in enumerate(rows) if r == at):
            its = None if iterations is None else int(iterations[i])
            key = (at, np.asarray(x0s[i]).tobytes(), its)
            if key not in seen:
                x0_t = torch.as_tensor(np.asarray(x0s[i]), device=op.A.device)
                seen[key] = solve(op, x0_t, iterations=its, **opts)
            out[i] = seen[key]
        del op
    return [
        {"x": r["x"].double().cpu().numpy(), "lr": float(r["lr"]), "nit": r["nit"],
         "status": r["status"], "errs": r["errs"]}
        for r in out
    ]


def judge(spec: dict, traffic: dict, data: dict, calls: list[dict], seed: int, device) -> dict:
    """The numbers that decide ``correct``: ``x_gap``, the widest relative
    gap ``||x - x_ref||_inf / ||x_ref||_inf`` of any call's answer against
    the float64 reference over as many iterations as the call took;
    ``stop_ratio``, the widest ``||x_nit - y_{nit-1}||_inf / tol`` of the
    reference at the iteration where a call says it converged (a solve
    that stops before its iterates meet the stopping rule reads well over
    1).  The fixed step's ``1/L`` is the reference's own: a step the
    program derives 1e-3 off moves ``x_gap`` past its limit."""
    x0s = [x0 for c in calls for x0 in c["x0"]]
    got = [x for c in calls for x in c["x"]]
    nits = [n for c in calls for n in c["nit"]]
    status = [s for c in calls for s in c["status"]]
    ref = answers(traffic, data, x0s, torch.float64, iterations=nits,
                  instances=lane_instances(calls))
    x_gap = max(
        float(np.max(np.abs(np.asarray(x, np.float64) - r["x"])) / max(np.max(np.abs(r["x"])), 1e-300))
        for x, r in zip(got, ref)
    )
    tol = float(traffic["options"]["tol"])
    stops = [r["errs"][-1] / tol for r, st in zip(ref, status) if st == 1 and r["errs"]]
    return {"x_gap": x_gap, "stop_ratio": max(stops, default=0.0)}
