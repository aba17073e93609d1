"""``correct`` at a size the CPU holds: a sound run of every cell passes
the cell's own limits; the control (the plain reference in the precision
below the configuration's, in the program's place) and each fault the
cell can have (a step that returns its state unchanged; half of a batch
left out; an answer altered where it is produced; a driver that ends a
solve one chunk before it converges) do not."""

import time

import numpy as np
import pytest
import torch

from portbench import calibrate, harness

CPU = torch.device("cpu")
SEED = 2**31 + 11
LASSO = {"spec": {"m": 500, "n": 2500, "support": 25}}
FDS_OPTS = {"lr": 1.0, "tol": 1e-5, "tol_internal": 1e-11, "max_iter": 10000, "decay_rate": 0.5,
            "nesterov": True, "nesterov_ratio": [0.0, 0.25], "check_every": 8}
SMALL = {
    "lasso_n10k.fixed": LASSO,
    "lasso_n10k.backtrack": LASSO,
    "fds_n10.front": {"traffic": {"starts": 16, "warmup_calls": 0}},
    "fds_n10.single": {"traffic": {"warmup_calls": 0}},
}
CELLS = sorted(SMALL)


def _small(cell, **traffic):
    over = {k: dict(v) for k, v in SMALL[cell].items()}
    over.setdefault("traffic", {}).update(traffic)
    return over


def _run(cell, **traffic):
    return harness.run(cell, SEED, 0.01, False, t_start=time.perf_counter(), device=CPU,
                       overrides=_small(cell, **traffic))


def _fails(out):
    return out["correct"] is False and any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    c = harness.Cell(cell, overrides=_small(cell))
    data = c.config.make_data(c.spec, SEED, CPU)
    starts = c.config.starts(c.spec, SEED, 0, int(c.traffic["starts"]))
    calls = [{"x0": starts, "x": starts, "nit": np.ones(len(starts), np.int64), "status": np.ones(len(starts), np.int64)}]
    ctrl = calibrate.control_calls(c, data, calls, CPU)
    numbers = c.reference.judge(c.spec, c.traffic, data, ctrl, SEED, CPU)
    assert any(v > c.limits[k] for k, v in numbers.items()), numbers


def _frozen(step):
    """``step`` made to return its carry unchanged but for its iteration
    count (so that the solve still ends at ``max_iter``), attributes
    kept."""

    def same(carry, *args, **kwargs):
        return carry._replace(nit=carry.nit + 1)

    same.__dict__.update(step.__dict__)
    if hasattr(step, "carried_search"):
        same.carried_search = _frozen(step.carried_search)
    return same


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged_is_not_correct(cell, monkeypatch):
    from zfista_tpu_torch.core import solver
    from zfista_tpu_torch.parallel import batch

    for mod, name in ((solver, "_make_step"), (solver, "_make_batch_step"), (batch, "_make_batch_step")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, **k: _frozen(real(*a, **k)))
    over = dict(harness.Cell(cell).traffic["options"], max_iter=200)
    assert _fails(_run(cell, options=over))


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from zfista_tpu_torch.models import base

    real = base.minimize_proximal_gradient_batch

    def half(f, g, jac_f, prox, x0s, **kwargs):
        res = real(f, g, jac_f, prox, x0s[: len(x0s) // 2], **kwargs)
        for key in ("x", "nit", "nit_internal", "status", "lr", "fun"):
            res[key] = np.concatenate([res[key], res[key]])
        return res

    monkeypatch.setattr(base, "minimize_proximal_gradient_batch", half)
    assert _fails(_run("fds_n10.front"))


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    from zfista_tpu_torch.core import solver
    from zfista_tpu_torch.parallel import batch

    real_host = solver.state_to_numpy

    def altered(state):
        host = real_host(state)
        x = host.x.copy()
        x.reshape(-1)[-1] += 1e-3 * max(float(np.max(np.abs(x))), 1.0)
        return host._replace(x=x)

    monkeypatch.setattr(solver, "state_to_numpy", altered)
    if hasattr(batch, "state_to_numpy"):
        monkeypatch.setattr(batch, "state_to_numpy", altered)
    assert _fails(_run(cell))


@pytest.mark.parametrize("cell", ["lasso_n10k.fixed", "lasso_n10k.backtrack"])
def test_a_driver_that_stops_one_chunk_early_is_not_correct(cell, monkeypatch):
    from zfista_tpu_torch.core import solver

    real = solver.run_chunks

    def early(step, carry, active, check_every, max_iter, owners=None):
        # The solve as it runs, from a copy of the carry, gives the step
        # at which it converges; the fault ends it one chunk before that
        # and reports it converged.
        probe = real(step, type(carry)(*(v.clone() for v in carry)), active, check_every,
                     max_iter, owners)
        stop = int(probe.nit) - check_every
        if not bool(probe.converged) or stop < 1:
            return probe
        out = solver.run_masked(step, carry, lambda c: active(c) & (c.nit < stop), check_every)
        return out._replace(converged=torch.ones_like(out.converged))

    monkeypatch.setattr(solver, "run_chunks", early)
    out = _run(cell)
    assert _fails(out) and out["checks"]["stop_ratio"]["value"] > out["checks"]["stop_ratio"]["limit"]
    assert out["checks"]["x_gap"]["value"] <= out["checks"]["x_gap"]["limit"]
