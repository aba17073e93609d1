"""The port's GroupLasso against the JAX package's, float64 on the CPU:
``f``/``jac_f``/``g``/prox, a backtracking and a fixed-step solve (equal
nit and trial counts, x to 1e-10), the ``group_size`` check,
``model_from_jax``, and the card by default."""

import torch_env  # noqa: F401  (one torch thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zfista_tpu.models.lasso import GroupLasso as JGroupLasso
from zfista_tpu_torch import interop
from zfista_tpu_torch.models import GroupLasso


def _data(m=30, n=40, seed=0):
    """Group-sparse truth (2 of 10 groups of 4) under a Gaussian operator."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x_true = np.zeros(n)
    x_true[:4] = rng.standard_normal(4)
    x_true[20:24] = rng.standard_normal(4)
    return A, A @ x_true + 0.01 * rng.standard_normal(m)


def _pair(lam=0.05, gs=4, **kw):
    A, b = _data(**kw)
    return JGroupLasso(A, b, lam, gs), GroupLasso(A, b, lam, gs, device="cpu")


def test_pieces_match_jax():
    j, t = _pair()
    rng = np.random.default_rng(1)
    for _ in range(3):
        x = rng.standard_normal(40)
        for piece in ("f", "jac_f", "g"):
            np.testing.assert_allclose(getattr(t, piece)(torch.tensor(x)).numpy(),
                                       np.asarray(getattr(j, piece)(jnp.asarray(x))),
                                       rtol=1e-13, atol=1e-14)
        for w in (0.0, 0.4, 3.0):
            np.testing.assert_allclose(t.prox_wsum_g(w, torch.tensor(x)).numpy(),
                                       np.asarray(j.prox_wsum_g(w, jnp.asarray(x))),
                                       rtol=1e-15, atol=1e-15)
    assert t.lipschitz(n_iter=200) == pytest.approx(j.lipschitz(n_iter=200), rel=1e-10)


@pytest.mark.parametrize("options", ["backtracking", "fixed_step"])
def test_solve_matches_jax(options):
    j, t = _pair()
    kw = dict(nesterov=True, tol=1e-9)
    if options == "fixed_step":
        kw.update(decay_rate=1, lr=1.0 / j.lipschitz(n_iter=200))
    rj = j.solve(np.zeros(40), **kw)
    rt = t.solve(np.zeros(40), **kw)
    assert rt.status == rj.status == 1
    assert (rt.nit, rt.nit_internal) == (rj.nit, rj.nit_internal)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    # whole groups vanish, as the truth's
    assert np.all(rt.x.reshape(-1, 4)[2:5] == 0)


def test_group_size_must_divide():
    A, b = _data()
    with pytest.raises(ValueError, match="divide by group_size"):
        GroupLasso(A, b, 0.1, 7, device="cpu")
    with pytest.raises(ValueError, match="divide by group_size"):
        JGroupLasso(A, b, 0.1, 7)


def test_model_from_jax_round_trip():
    j, _ = _pair(gs=8)
    t = interop.model_from_jax(j, device="cpu")
    assert isinstance(t, GroupLasso) and (t.group_size, t.l1_ratio) == (8, j.l1_ratio)
    np.testing.assert_array_equal(t.A.numpy(), np.asarray(j.A))
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))
    assert t.solve(np.zeros(40), nesterov=True).nit == j.solve(np.zeros(40), nesterov=True).nit


def test_goes_to_the_card_by_default(monkeypatch):
    A, b = _data()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GroupLasso(A, b, 0.1, 4)
    assert GroupLasso(A, b, 0.1, 4, device="cpu").A.device.type == "cpu"
