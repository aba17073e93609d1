r"""Plain reference for ``fds_n10``: FDS and its accelerated proximal gradient.

FDS (Fliege, Grana Drummond & Svaiter, SIAM J. Optim. 2009) with ``n``
features and three objectives

.. math::

    f_1 = \tfrac{1}{n^2}\sum_k k (x_k - k)^4,\quad
    f_2 = e^{\bar x} + \|x\|^2,\quad
    f_3 = \tfrac{1}{n(n+1)}\sum_k k (n - k + 1) e^{-x_k},

and ``g = 0``.  The method is the accelerated multiobjective proximal
gradient of Tanabe, Fukuda & Yamashita with the momentum
``t <- sqrt(t^2 - a t + b) + 1/2`` and backtracking on the step ``lr``
(Armijo test ``F_i(x+) - F_i(x) <= sub + tol_internal`` for every ``i``),
written here from its equations, over a batch of starts at once.  Each
iteration's subproblem is the dual over the simplex,

.. math::

    \min_{w \in \Delta_3} \tfrac{lr}{2}\|J(y)^\top w\|^2 + w^\top (F(x) - f(y)),

a three-weight QP solved exactly by taking the best of its seven faces
(the interior, three edges, three vertices); ``x+ = y - lr J(y)^T w``.

Plain PyTorch, any device and dtype; it imports nothing of the program.
"""

from __future__ import annotations

import itertools
import sys

import numpy as np
import torch


def objectives(x: torch.Tensor) -> torch.Tensor:
    """``f(x)`` of every row of ``x (B, n)``: ``(B, 3)``."""
    n = x.shape[-1]
    k = torch.arange(1, n + 1, dtype=x.dtype, device=x.device)
    conv = k * k.flip(0)
    f1 = (k * (x - k) ** 4).sum(-1) / n**2
    f2 = torch.exp(x.sum(-1) / n) + (x * x).sum(-1)
    f3 = (conv * torch.exp(-x)).sum(-1) / (n * (n + 1))
    return torch.stack([f1, f2, f3], -1)


def jacobian(x: torch.Tensor) -> torch.Tensor:
    """``J(x)`` of every row of ``x (B, n)``: ``(B, 3, n)``."""
    n = x.shape[-1]
    k = torch.arange(1, n + 1, dtype=x.dtype, device=x.device)
    conv = k * k.flip(0)
    j1 = 4 / n**2 * k * (x - k) ** 3
    j2 = torch.exp(x.sum(-1, keepdim=True) / n) / n + 2 * x
    j3 = -conv * torch.exp(-x) / (n * (n + 1))
    return torch.stack([j1, j2, j3], -2)


def _faces(m: int) -> list[tuple[int, ...]]:
    return [c for r in range(1, m + 1) for c in itertools.combinations(range(m), r)]


def simplex_qp(G: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``argmin_{w in simplex} w^T G w / 2 + s^T w`` for every lane
    (``G (B, m, m)`` positive semidefinite, ``s (B, m)``), by the best
    feasible stationary point over all faces of the simplex."""
    B, m = s.shape
    best_w = torch.full_like(s, float("nan"))
    best_v = torch.full((B,), float("inf"), dtype=s.dtype, device=s.device)
    for face in _faces(m):
        idx = torch.tensor(face, device=s.device)
        k = len(face)
        Gf = G[:, idx][:, :, idx]
        # KKT of the face: [G_f 1; 1^T 0] [w; mu] = [-s_f; 1].
        K = torch.zeros((B, k + 1, k + 1), dtype=s.dtype, device=s.device)
        K[:, :k, :k] = Gf
        K[:, :k, k] = 1
        K[:, k, :k] = 1
        rhs = torch.cat([-s[:, idx], torch.ones((B, 1), dtype=s.dtype, device=s.device)], 1)
        if k > 1:
            sol, info = torch.linalg.solve_ex(K, rhs)
            wf = sol[:, :k]
            ok = (info == 0) & (wf >= 0).all(1) & torch.isfinite(wf).all(1)
        else:
            wf = torch.ones((B, 1), dtype=s.dtype, device=s.device)
            ok = torch.ones(B, dtype=torch.bool, device=s.device)
        w = torch.zeros_like(s)
        w[:, idx] = torch.where(ok[:, None], wf, 0)
        v = 0.5 * torch.einsum("bi,bij,bj->b", w, G, w) + (s * w).sum(1)
        take = ok & (v < best_v)
        best_v = torch.where(take, v, best_v)
        best_w = torch.where(take[:, None], w, best_w)
    return best_w


def solve(
    x0: torch.Tensor,
    *,
    lr: float = 1.0,
    tol: float = 1e-5,
    tol_internal: float = 1e-11,
    max_iter: int = 10_000,
    max_backtrack_iter: int = 100,
    decay_rate: float = 0.5,
    nesterov: bool = True,
    nesterov_ratio: tuple[float, float] = (0.0, 0.25),
    **_ignored,
) -> dict[str, torch.Tensor]:
    """Solve from every row of ``x0 (B, n)`` in ``x0``'s dtype and device.
    Returns ``x``, ``nit`` and ``status`` (1 converged, 0 at ``max_iter``,
    2 line search exhausted) per lane."""
    a, b = nesterov_ratio
    B = x0.shape[0]
    dev, dt = x0.device, x0.dtype
    x = x0.clone()
    y = x0.clone()
    F_x = objectives(x)
    t = torch.ones(B, dtype=dt, device=dev)
    step = torch.full((B,), float(lr), dtype=dt, device=dev)
    nit = torch.zeros(B, dtype=torch.int64, device=dev)
    status = torch.full((B,), -1, dtype=torch.int64, device=dev)
    for _ in range(max_iter):
        live = status < 0
        if not bool(live.any()):
            break
        f_y, J = objectives(y), jacobian(y)
        G = J @ J.transpose(1, 2)
        shift = F_x - f_y
        lr_try = step.clone()
        done = ~live
        x_new = x.clone()
        F_new = F_x.clone()
        for _k in range(max_backtrack_iter):
            w = simplex_qp(lr_try[:, None, None] * G, shift)
            d = -lr_try[:, None] * (w[:, None, :] @ J)[:, 0]
            x_t = y + d
            F_t = objectives(x_t)
            sub = -(0.5 * lr_try * (w[:, None, :] @ G @ w[:, :, None])[:, 0, 0] + (w * shift).sum(1))
            ok = ((F_t - F_x) <= (sub + tol_internal)[:, None]).all(1) & ~done
            x_new = torch.where(ok[:, None], x_t, x_new)
            F_new = torch.where(ok[:, None], F_t, F_new)
            step = torch.where(ok, lr_try, step)
            done = done | ok
            if bool(done.all()):
                break
            lr_try = torch.where(done, lr_try, lr_try * decay_rate)
        moved = live & done
        status = torch.where(live & ~done, 2, status)
        err = (x_new - y).abs().amax(1)
        conv = moved & (err < tol)
        if nesterov:
            t_new = torch.sqrt(t * t - a * t + b) + 0.5
            y_new = x_new + ((t - 1) / t_new)[:, None] * (x_new - x)
        else:
            t_new, y_new = t, x_new
        keep_y = moved & ~conv
        y = torch.where(keep_y[:, None], y_new, y)
        t = torch.where(keep_y, t_new, t)
        x = torch.where(moved[:, None], x_new, x)
        F_x = torch.where(moved[:, None], F_new, F_x)
        nit = nit + moved.to(nit.dtype)
        status = torch.where(conv, 1, status)
    status = torch.where(status < 0, 0, status)
    return {"x": x, "nit": nit, "status": status}


#: Lanes the reference solves at once.
BLOCK = 8192


def answers(traffic: dict, x0s: np.ndarray, dtype, device) -> dict[str, np.ndarray]:
    """The traffic's solve from every row of ``x0s``, by :func:`solve` in
    ``dtype`` on ``device``, in blocks of lanes."""
    opts = {k: v for k, v in traffic["options"].items() if k != "check_every"}
    parts = []
    for lo in range(0, len(x0s), BLOCK):
        x0 = torch.as_tensor(np.asarray(x0s[lo:lo + BLOCK]), dtype=dtype, device=device)
        parts.append({k: v.cpu().numpy() for k, v in solve(x0, **opts).items()})
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


#: A lane is off where its answer lies this far from the reference's
#: (relative, infinity norm): agreeing lanes read ~1e-11, the float32
#: control's 1e-2 and more.
LANE_OFF = 1e-6


def judge(spec: dict, traffic: dict, data: dict, calls: list[dict], seed: int, device) -> dict:
    """``lanes_off``: the share (%) of the lanes of every call of the window
    whose answer lies more than ``LANE_OFF`` from the float64 reference's
    from the same start (``||x - x_ref||_inf / ||x_ref||_inf``).  A share,
    not the widest gap: a backtracking test decided at the rounding floor
    sends a few lanes in ten thousand to another Pareto-critical point in
    any two implementations."""
    x0s = np.concatenate([c["x0"] for c in calls])
    x = np.concatenate([c["x"] for c in calls]).astype(np.float64)
    ref = answers(traffic, x0s, torch.float64, device)["x"]
    gap = np.max(np.abs(x - ref), axis=1) / np.maximum(np.max(np.abs(ref), axis=1), 1e-300)
    off = gap > LANE_OFF
    print(
        f"reference: {int(off.sum())} of {gap.size} lanes off; widest gap {gap.max():.3e}, "
        f"widest of the rest {gap[~off].max() if (~off).any() else float('nan'):.3e}",
        file=sys.stderr,
    )
    return {"lanes_off": 100.0 * float(off.mean())}
