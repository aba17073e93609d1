"""The port's checkpoint and profiling utilities, against the JAX package.

* A State saved by the JAX package (x64) loads in the port with every
  field equal, dtype kept, and the port resumes from it to the JAX run's
  ``nit`` and x; a port-saved State loads in the JAX package with equal
  fields.  (The two packages' partial states differ in the last bit, as
  XLA and torch round differently, so the cross-package resume is held to
  the m=2 parity class and the in-package resume bitwise.)
* Stop, save, load and resume in the port is bitwise equal to the
  uninterrupted solve, single and batched; suffix normalisation, the
  atomic write, dtype kept, metadata round-trip and the collision
  ``ValueError``; ``load_state`` puts the state on the card by default.
* ``annotate`` as a context manager, a decorator and reentrant; ``trace``
  on the CPU writes a Chrome trace holding the annotation.
"""

import torch_env  # noqa: F401  (one torch thread a process)
import json

import numpy as np
import pytest
import torch

from zfista_tpu.models.zoo import JOS1 as JJOS1
from zfista_tpu.utils import checkpoint as jck
from zfista_tpu_torch import minimize_proximal_gradient
from zfista_tpu_torch.core.solver import State, init_state
from zfista_tpu_torch.models.deblur import TVDeblur, gaussian_kernel
from zfista_tpu_torch.models.zoo import JOS1
from zfista_tpu_torch.parallel import minimize_proximal_gradient_batch
from zfista_tpu_torch.utils import checkpoint as tck
from zfista_tpu_torch.utils.profiling import annotate, trace

X0 = np.random.default_rng(0).uniform(-2, 4, size=5)
OPTS = dict(nesterov=True, max_iter=200)


def _fns(p):
    return p.f, p.g, p.jac_f, p.prox_wsum_g


def _resume(state, **extra):
    return minimize_proximal_gradient(
        *_fns(JOS1(n_features=5)), torch.tensor(X0), initial_state=state, **OPTS, **extra
    )


def _assert_state_equal(a, b):
    for name, u, v in zip(State._fields, a, b):
        u, v = np.asarray(u), np.asarray(v)
        assert u.dtype == v.dtype, name
        np.testing.assert_array_equal(u, v, err_msg=name)


def _host(state):
    return State(*(v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in state))


@pytest.fixture(scope="module")
def jax_runs():
    prob = JJOS1(n_features=5)
    full = prob.minimize_proximal_gradient(X0, **OPTS)
    part = prob.minimize_proximal_gradient(X0, nesterov=True, max_iter=7, tol=0.0)
    return full, part


def test_jax_saved_state_resumes_in_the_port(tmp_path, jax_runs):
    full_j, part_j = jax_runs
    path = tmp_path / "jax_state.npz"
    jck.save_state(part_j.state, path)
    loaded = tck.load_state(path, device="cpu")
    assert all(v.device.type == "cpu" for v in loaded)
    _assert_state_equal(_host(loaded), State(*(np.asarray(v) for v in part_j.state)))
    resumed = _resume(loaded)
    assert resumed.success and resumed.nit == full_j.nit
    np.testing.assert_allclose(resumed.x, np.asarray(full_j.x), rtol=0, atol=1e-10)
    # Loading changed nothing: bitwise the resume from the same values in memory.
    again = _resume(State(*(np.asarray(v) for v in part_j.state)))
    _assert_state_equal(resumed.state, again.state)


def test_port_saved_state_loads_in_jax(tmp_path):
    part = JOS1(n_features=5).solve(torch.tensor(X0), nesterov=True, max_iter=7, tol=0.0)
    path = tmp_path / "port_state.npz"
    tck.save_state(part.state, path)
    loaded = jck.load_state(path)
    _assert_state_equal(State(*(np.asarray(v) for v in loaded)), part.state)


def test_resume_bitwise_identical(tmp_path):
    full = _resume(None)
    part = JOS1(n_features=5).solve(torch.tensor(X0), nesterov=True, max_iter=7, tol=0.0)
    tck.save_state(part.state, tmp_path / "solve.npz")
    resumed = _resume(tck.load_state(tmp_path / "solve.npz", device="cpu"))
    assert resumed.success and resumed.nit == full.nit
    _assert_state_equal(resumed.state, full.state)


def test_batched_state_roundtrip_and_resume(tmp_path):
    p = JOS1(n_features=5)
    x0s = torch.tensor(np.random.default_rng(1).uniform(-2, 4, size=(4, 5)))
    full = minimize_proximal_gradient_batch(*_fns(p), x0s, nesterov=True)
    part = minimize_proximal_gradient_batch(*_fns(p), x0s, nesterov=True, max_iter=5)
    tck.save_state(part.state, tmp_path / "batch")
    loaded = tck.load_state(tmp_path / "batch", device="cpu")
    assert loaded.x.shape == (4, 5) and loaded.nit.shape == (4,)
    _assert_state_equal(_host(loaded), part.state)
    resumed = minimize_proximal_gradient_batch(
        *_fns(p), x0s, nesterov=True, initial_states=loaded
    )
    _assert_state_equal(resumed.state, full.state)
    # and the JAX loader reads the batched file
    _assert_state_equal(
        State(*(np.asarray(v) for v in jck.load_state(tmp_path / "batch"))), part.state
    )


def test_suffix_normalisation_and_atomic_write(tmp_path):
    part = JOS1(n_features=5).solve(torch.ones(5, dtype=torch.float64), max_iter=3, tol=0.0)
    tck.save_state(part.state, tmp_path / "iter100")  # no .npz suffix
    assert (tmp_path / "iter100.npz").exists()
    assert [p for p in tmp_path.iterdir() if "tmp" in p.name] == []
    _assert_state_equal(_host(tck.load_state(tmp_path / "iter100", device="cpu")), part.state)
    _assert_state_equal(_host(tck.load_state(tmp_path / "iter100.npz", device="cpu")), part.state)


def test_dtypes_kept(tmp_path):
    """float32 stays float32 and float64 float64: torch has no x64 switch,
    so a load never changes a dtype."""
    for dt in (torch.float32, torch.float64):
        st = init_state(torch.arange(4, dtype=dt), torch.zeros(1, dtype=dt), 1, torch.tensor(0.5, dtype=dt))
        tck.save_state(st, tmp_path / f"{dt}.npz")
        back = tck.load_state(tmp_path / f"{dt}.npz", device="cpu")
        assert [v.dtype for v in back] == [v.dtype for v in st]
        assert back.nit.dtype == torch.int32 and back.converged.dtype == torch.bool


def test_meta_roundtrip_and_collision(tmp_path):
    st = init_state(torch.arange(4.0, dtype=torch.float64), torch.zeros(1, dtype=torch.float64), 1,
                    torch.tensor(0.5, dtype=torch.float64))
    path = tmp_path / "ckpt.npz"
    tck.save_state(st, path, meta={"prox_kernel": "fgp_resident", "prox_iter": "30"})
    assert tck.load_meta(path) == {"prox_kernel": "fgp_resident", "prox_iter": "30"}
    assert jck.load_meta(path) == tck.load_meta(path)
    _assert_state_equal(_host(tck.load_state(path, device="cpu")), _host(st))
    with pytest.raises(ValueError, match="collides"):
        tck.save_state(st, path, meta={"x": "oops"})
    tck.save_state(st, path)
    assert tck.load_meta(path) == {}


def test_tv_deblur_checkpoint_meta_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    prob = TVDeblur(rng.random((16, 16)), kernel=gaussian_kernel(5, 1.0), device="cpu")
    meta = prob.checkpoint_meta()
    assert meta["prox_kernel"] == "plain" and meta["backend"] == "cpu"
    res = prob.solve(max_iter=3, tol=0.0)
    tck.save_state(res.state, tmp_path / "tv.npz", meta=meta)
    assert tck.load_meta(tmp_path / "tv.npz") == meta


def test_load_state_goes_to_the_card_by_default(tmp_path, monkeypatch):
    st = init_state(torch.zeros(2, dtype=torch.float64), torch.zeros(1, dtype=torch.float64), 1,
                    torch.tensor(1.0, dtype=torch.float64))
    tck.save_state(st, tmp_path / "s.npz")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tck.load_state(tmp_path / "s.npz")


def test_annotate_decorator_and_ctx():
    @annotate("step")
    def f(x):
        return x + 1

    assert f(1) == 2
    with annotate("scope"):
        pass


def test_annotate_reentrant():
    ann = annotate("outer")
    with ann:
        with ann:
            pass
    assert ann._stack == []
    with ann:  # balanced: a fresh enter still works
        pass


def test_trace_writes_a_chrome_trace_with_the_scope(tmp_path):
    p = JOS1(n_features=5)
    with trace(tmp_path / "prof"):
        with annotate("zt.jos1"):
            p.solve(torch.tensor(X0), max_iter=3, tol=0.0)
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "zt.jos1" for e in events)
