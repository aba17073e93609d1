"""The port's batch solver with one objective: against the JAX package's
batch and against the port's own single solves, float64 on the CPU.

* the toy LASSO of ``tests/test_batch.py`` and a 20 x 40 dense LASSO:
  exact ``nit`` and ``nit_internal``, x at 1e-10, against JAX's
  ``minimize_proximal_gradient_batch`` and against the port's single
  solves;
* the λ sweep through ``batch_params``, per-lane momentum pairs,
  ``adaptive_restart``, ``tol_rel``, backtracking with lanes that take
  different trial counts and a lane that fails its line search alone;
* ``check_every``, ``iter_chunk`` and ``lane_chunk`` (a ragged tail)
  bitwise equal to the unchunked batch; histories and ``record_vecs``
  through ``to_list``; ``initial_states`` resume (from the port's state and
  from JAX's) bitwise;
* the validations, ``in_sharding``, the merge registry and the partial
  result after a device fault in a later lane chunk.

Each JAX batch is solved once per module (a vmapped JAX program takes
seconds to compile on the CPU).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zfista_tpu.models import lasso as jl
from zfista_tpu.parallel import batch as jb
from zfista_tpu_torch import interop
from zfista_tpu_torch import minimize_proximal_gradient as t_single
from zfista_tpu_torch.core.solver import State
from zfista_tpu_torch.models import lasso as tl
from zfista_tpu_torch.parallel import batch as tb
from zfista_tpu_torch.parallel.sharding import batch_sharding, feature_sharding, make_mesh

F64 = torch.float64
TOY_A = np.array([[1.0], [0.0], [0.0]])
TOY_B = np.array([1.0, 0.0, 0.0])
TOY_X0 = np.array([[0.0], [2.0], [-3.0], [0.5]])
J_TOY = jl.Lasso(TOY_A, TOY_B, l1_ratio=0.1)
T_TOY = tl.Lasso(torch.tensor(TOY_A), torch.tensor(TOY_B), 0.1)


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return fn(*args, **kwargs)


def _fns(p):
    return p.f, p.g, p.jac_f, p.prox_wsum_g


def _dense(seed=0, m=20, n=40):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x_true = np.zeros(n)
    x_true[rng.choice(n, 4, replace=False)] = rng.standard_normal(4)
    return A, A @ x_true + 0.01 * rng.standard_normal(m), rng.standard_normal((5, n))


DENSE_A, DENSE_B, DENSE_X0 = _dense()
J_DENSE = jl.Lasso(DENSE_A, DENSE_B, l1_ratio=0.05)
T_DENSE = tl.Lasso(torch.tensor(DENSE_A), torch.tensor(DENSE_B), 0.05)

#: (JAX problem, port problem, starts, options): solved by both packages.
CASES = {
    "toy_fista": (J_TOY, T_TOY, TOY_X0, dict(lr=0.4, nesterov=True)),
    "dense_backtracking": (J_DENSE, T_DENSE, DENSE_X0, dict(nesterov=True, max_iter=3000)),
    "dense_ista_backtracking": (J_DENSE, T_DENSE, DENSE_X0, dict(lr=3.0, decay_rate=0.7)),
    "dense_fixed_step": (J_DENSE, T_DENSE, DENSE_X0, dict(lr=0.05, decay_rate=1, nesterov=True)),
    "dense_adaptive_restart": (
        J_DENSE, T_DENSE, DENSE_X0, dict(lr=0.05, decay_rate=1, nesterov=True, adaptive_restart=True),
    ),
    "dense_tol_rel": (
        J_DENSE, T_DENSE, DENSE_X0, dict(nesterov=True, tol=0.0, tol_rel=1e-6, max_iter=400),
    ),
    "dense_ab": (
        J_DENSE, T_DENSE, DENSE_X0,
        dict(lr=0.05, decay_rate=1, batch_nesterov_ratio=np.array(
            [[0.0, 0.25], [0.5, 0.25], [0.75, 0.25], [0.2, 0.2], [0.6, 0.15]])),
    ),
}


@pytest.fixture(scope="module")
def jax_results():
    """Each case's JAX batch, solved once."""
    out = {}
    for name, (jp, _, x0s, kw) in CASES.items():
        out[name] = _quiet(jb.minimize_proximal_gradient_batch, *_fns(jp), jnp.asarray(x0s), **kw)
    return out


def _port(name, **extra):
    _, tp, x0s, kw = CASES[name]
    return _quiet(tb.minimize_proximal_gradient_batch, *_fns(tp), torch.tensor(x0s), **{**kw, **extra})


def _assert_same_batch(a, b):
    """Bitwise: every per-lane field and every State field."""
    for key in ("x", "fun", "nit", "nit_internal", "status", "lr", "error_criterion", "weight"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for name, u, v in zip(State._fields, a.state, b.state):
        assert np.array_equal(u, v) and u.dtype == v.dtype, f"State.{name}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_matches_jax_and_single_solves(name, jax_results):
    rj = jax_results[name]
    rt = _port(name)
    np.testing.assert_array_equal(rt.nit, np.asarray(rj.nit))
    np.testing.assert_array_equal(rt.nit_internal, np.asarray(rj.nit_internal))
    np.testing.assert_array_equal(rt.status, np.asarray(rj.status))
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.fun, np.asarray(rj.fun), rtol=1e-10, atol=1e-12)
    assert rt.x.dtype == np.float64 and rt.fun.shape == np.asarray(rj.fun).shape
    # Each lane is the port's own single solve from the same start.
    _, tp, x0s, kw = CASES[name]
    kw = dict(kw)
    ab = kw.pop("batch_nesterov_ratio", None)
    for i, lane in enumerate(rt.to_list()):
        if ab is not None:
            kw.update(nesterov=True, nesterov_ratio=tuple(ab[i]))
            assert lane.nesterov_ratio == tuple(ab[i])
        single = _quiet(t_single, *_fns(tp), torch.tensor(x0s[i]), **kw)
        assert (lane.nit, lane.nit_internal, lane.status) == (
            single.nit, single.nit_internal, single.status,
        )
        np.testing.assert_allclose(lane.x, single.x, rtol=0, atol=1e-10)
        np.testing.assert_allclose(lane.fun, single.fun, rtol=1e-10)


def test_lambda_sweep_with_batch_params():
    lams = np.array([1e-8, 0.1, 0.5, 1.0])
    kw = dict(lr=0.4, nesterov=True)
    rj = jb.minimize_proximal_gradient_batch(
        *jl.make_lasso_lambda_sweep(TOY_A, TOY_B), jnp.zeros((4, 1)),
        batch_params=jnp.asarray(lams), **kw,
    )
    fns = tl.make_lasso_lambda_sweep(TOY_A, TOY_B, device="cpu")
    rt = tb.minimize_proximal_gradient_batch(
        *fns, torch.zeros((4, 1), dtype=F64), batch_params=torch.tensor(lams), **kw
    )
    # Closed form: x* = max(1 - lam/2, 0).
    np.testing.assert_allclose(rt.x[:, 0], [1.0, 0.95, 0.75, 0.5], atol=1e-4)
    np.testing.assert_array_equal(rt.nit, np.asarray(rj.nit))
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    # batch_params as numpy, on the solve's device.
    rn = tb.minimize_proximal_gradient_batch(
        *fns, torch.zeros((4, 1), dtype=F64), batch_params=lams, **kw
    )
    np.testing.assert_array_equal(rn.x, rt.x)


@pytest.mark.parametrize("n", [1, 7, 64, 1000])
def test_lane_sum_is_a_fixed_tree(n):
    """``precision.lane_sum`` adds pairs of halves of the zero-padded
    vector, so a lane's sum is the same whether it runs alone or beside
    others, and agrees with ``torch.sum`` to rounding."""
    from zfista_tpu_torch.ops.precision import dot_hp, lane_sum, sum_hp

    V = torch.as_tensor(np.random.default_rng(n).standard_normal((16, n)))
    padded = torch.nn.functional.pad(V[5], (0, (1 << (n - 1).bit_length()) - n)).tolist()
    while len(padded) > 1:
        h = len(padded) // 2
        padded = [u + v for u, v in zip(padded[:h], padded[h:])]
    assert lane_sum(V[5]).item() == padded[0]
    for fn in (sum_hp, lambda v: dot_hp(v, v)):
        many, few = torch.func.vmap(fn)(V), torch.func.vmap(fn)(V[5:7])
        assert torch.equal(many[5:7], few)
    np.testing.assert_allclose(torch.func.vmap(sum_hp)(V), V.sum(1), rtol=1e-13, atol=1e-13)
    np.testing.assert_array_equal(lane_sum(V.T, dim=0), lane_sum(V))


def test_sweep_lanes_do_not_depend_on_the_lane_count():
    """Every per-lane field of a backtracking λ sweep, its objective and
    model value too, is bitwise the same for a lane solved among 16 or
    among 4: the lane-sharded batch's contract."""
    A, b, _ = _dense(seed=3, m=24, n=40)
    fns = tl.make_lasso_lambda_sweep(A, b, device="cpu")
    lams = np.linspace(0.01, 0.3, 16)
    kw = dict(lr=1.0, decay_rate=0.5, nesterov=True, max_iter=300)
    many = tb.minimize_proximal_gradient_batch(*fns, np.zeros((16, 40)), batch_params=lams,
                                               device="cpu", **kw)
    few = tb.minimize_proximal_gradient_batch(*fns, np.zeros((4, 40)), batch_params=lams[8:12],
                                              device="cpu", **kw)
    for name, u, v in zip(State._fields, many.state, few.state):
        np.testing.assert_array_equal(u[8:12], v, err_msg=name)


def test_elastic_net_and_group_lasso_sweeps_match_jax():
    A, b, x0s = _dense(5, m=12, n=8)
    lams = np.array([0.01, 0.1, 0.3])
    x0s = x0s[:3]
    kw = dict(lr=0.05, decay_rate=1, nesterov=True, max_iter=60, tol=0)
    for j_fns, t_fns in (
        (jl.make_lasso_lambda_sweep(A, b, l2_ratio=0.1),
         tl.make_lasso_lambda_sweep(A, b, l2_ratio=0.1, device="cpu")),
        (jl.make_group_lasso_lambda_sweep(A, b, 2),
         tl.make_group_lasso_lambda_sweep(A, b, 2, device="cpu")),
    ):
        rj = jb.minimize_proximal_gradient_batch(
            *j_fns, jnp.asarray(x0s), batch_params=jnp.asarray(lams), **kw
        )
        rt = tb.minimize_proximal_gradient_batch(
            *t_fns, torch.tensor(x0s), batch_params=torch.tensor(lams), **kw
        )
        np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)
        np.testing.assert_allclose(rt.fun, np.asarray(rj.fun), rtol=1e-10)
    with pytest.raises(ValueError, match="divide"):
        tl.make_group_lasso_lambda_sweep(A, b, 3, device="cpu")


def _scaled_lasso():
    """LASSO lanes whose operator is scaled per lane (``batch_params``): from
    lr 1 the lanes need different numbers of backtracking trials."""
    A, b, x0s = _dense(7, m=10, n=6)
    A_t, b_t = torch.tensor(A), torch.tensor(b)

    def f(x, s):
        r = s * (A_t @ x) - b_t
        return r @ r

    def jac(x, s):
        return 2 * s * (A_t.T @ (s * (A_t @ x) - b_t))

    def g(x, s):
        return 0.1 * torch.sum(torch.abs(x))

    def prox(t, x, s):
        return torch.sign(x) * torch.clamp_min(torch.abs(x) - 0.1 * t, 0.0)

    return (f, g, jac, prox), torch.tensor(x0s[:4]), torch.tensor([0.5, 1.0, 2.0, 30.0], dtype=F64)


def test_lanes_backtrack_on_their_own_and_fail_alone():
    fns, x0s, scale = _scaled_lasso()
    for kw in (dict(nesterov=True, max_iter=200),
               dict(nesterov=True, max_iter=200, max_backtrack_iter=5)):
        res = _quiet(tb.minimize_proximal_gradient_batch, *fns, x0s, batch_params=scale, **kw)
        for i, lane in enumerate(res.to_list()):
            bound = [lambda *a, fn=fn, s=scale[i]: fn(*a, s) for fn in fns]
            single = _quiet(t_single, *bound, x0s[i], **kw)
            assert (lane.nit, lane.nit_internal, lane.status, lane.lr) == (
                single.nit, single.nit_internal, single.status, single.lr,
            )
            np.testing.assert_allclose(lane.x, single.x, rtol=0, atol=1e-12)
        if "max_backtrack_iter" not in kw:
            # Every lane settled at its own step size, each with its own trials.
            assert res.success.all() and len(set(res.lr.tolist())) == 4
    # With 5 trials at most, the widest lane fails its first line search
    # (status 2, nit 0, x = x0, its 5 trials counted) while the others go on.
    assert list(res.status) == [1, 1, 1, 2] and res.nit[3] == 0 and res.nit_internal[3] == 5
    np.testing.assert_array_equal(res.x[3], x0s[3].numpy())
    assert not res.success[3] and res.success[:3].all()


@pytest.mark.parametrize(
    "name, extra",
    [
        ("dense_backtracking", dict(check_every=7)),
        ("dense_backtracking", dict(iter_chunk=5)),
        ("dense_backtracking", dict(lane_chunk=2)),
        ("dense_fixed_step", dict(check_every=16)),
        ("dense_fixed_step", dict(lane_chunk=3)),
        ("dense_ab", dict(lane_chunk=2, iter_chunk=9)),
    ],
)
def test_chunked_drivers_are_bitwise_the_unchunked_batch(name, extra):
    _assert_same_batch(_port(name, **extra), _port(name))


def test_history_matches_single_return_all_and_jax():
    kw = dict(lr=0.4, nesterov=True, record_vecs=True, history_chunk=5)
    x0s = TOY_X0[:2]
    rj = jb.minimize_proximal_gradient_batch(*_fns(J_TOY), jnp.asarray(x0s), **kw)
    rt = tb.minimize_proximal_gradient_batch(*_fns(T_TOY), torch.tensor(x0s), **kw)
    for lt, lj, x0 in zip(rt.to_list(), rj.to_list(), x0s):
        single = t_single(*_fns(T_TOY), torch.tensor(x0), lr=0.4, nesterov=True, return_all=True)
        assert len(lt.allvecs) == len(lt.allfuns) == len(lt.allerrs) + 1 == len(single.allvecs)
        assert len(lt.allfuns) == len(lj.allfuns)
        np.testing.assert_allclose(np.asarray(lt.allvecs), np.asarray(single.allvecs), atol=1e-12)
        np.testing.assert_allclose(lt.allfuns, single.allfuns, atol=1e-12)
        np.testing.assert_allclose(lt.allerrs, single.allerrs, atol=1e-12)
        np.testing.assert_allclose(lt.allfuns, lj.allfuns, atol=1e-10)
        np.testing.assert_allclose(np.asarray(lt.allvecs), np.asarray(lj.allvecs), atol=1e-10)
        assert lt.allfuns[0] == pytest.approx(float(T_TOY.f(torch.tensor(x0))[0] + T_TOY.g(torch.tensor(x0))[0]))
    # The history driver ends at the while driver's state.
    plain = tb.minimize_proximal_gradient_batch(*_fns(T_TOY), torch.tensor(x0s), lr=0.4, nesterov=True)
    np.testing.assert_array_equal(rt.x, plain.x)
    np.testing.assert_array_equal(rt.nit, plain.nit)
    # history_chunk is bounded by iter_chunk and changes nothing recorded.
    rc = tb.minimize_proximal_gradient_batch(*_fns(T_TOY), torch.tensor(x0s), iter_chunk=2, **kw)
    for a, c in zip(rt.to_list(), rc.to_list()):
        np.testing.assert_array_equal(a.allfuns, c.allfuns)
        np.testing.assert_array_equal(np.asarray(a.allvecs), np.asarray(c.allvecs))


def test_resume_from_initial_states_is_bitwise_and_heads_the_history():
    kw = dict(nesterov=True)
    full = _port("dense_backtracking")
    first = _port("dense_backtracking", max_iter=4)
    cont = _port("dense_backtracking", initial_states=first.state)
    _assert_same_batch(cont, full)
    # A JAX batch's state, carried across with a leading lane axis.
    sj = _quiet(jb.minimize_proximal_gradient_batch, *_fns(J_DENSE), jnp.asarray(DENSE_X0),
                max_iter=4, **kw).state
    st = interop.state_from_numpy(sj, device="cpu")
    assert st.x.shape == DENSE_X0.shape and st.nit.shape == (len(DENSE_X0),)
    from_jax = _port("dense_backtracking", initial_states=st)
    np.testing.assert_array_equal(from_jax.nit, full.nit)
    np.testing.assert_allclose(from_jax.x, full.x, rtol=0, atol=1e-10)
    # Resumed history: allvecs starts at the resume iterate, paired with F.
    rec = _port("dense_backtracking", initial_states=first.state, record_vecs=True)
    for i, lane in enumerate(rec.to_list()):
        np.testing.assert_array_equal(lane.allvecs[0], first.state.x[i])
        head = torch.tensor(lane.allvecs[0])
        F_head = float(T_DENSE.f(head)[0] + T_DENSE.g(head)[0])
        assert lane.allfuns[0] == pytest.approx(F_head, rel=1e-12)
        assert not np.array_equal(lane.allvecs[0], DENSE_X0[i])
    np.testing.assert_array_equal(rec.x, full.x)
    # keep_state=False returns no state.
    assert _port("dense_backtracking", keep_state=False).state is None


def test_validations_and_unported_sharding():
    args = (*_fns(T_TOY), torch.tensor(TOY_X0))
    for kw, match in (
        (dict(iter_chunk=0), "iter_chunk"),
        (dict(check_every=0), "check_every"),
        (dict(history=True, history_chunk=0), "history_chunk"),
        (dict(lane_chunk=0), "lane_chunk"),
        (dict(tol_rel=-1.0), "tol_rel"),
        (dict(tol_internal_rel=-1.0), "tol_internal_rel"),
        (dict(nesterov_ratio=(0.0, 0.25, 1.0)), "pair"),
        (dict(batch_nesterov_ratio=np.zeros((3, 2))), r"\(batch, 2\)"),
    ):
        with pytest.raises(ValueError, match=match):
            tb.minimize_proximal_gradient_batch(*args, lr=0.4, **kw)
    with pytest.raises(ValueError, match="x0s must be"):
        tb.minimize_proximal_gradient_batch(*_fns(T_TOY), torch.zeros(3, dtype=F64))
    # in_sharding takes a lane placement of a mesh, and no lane_chunk.
    mesh = make_mesh()
    with pytest.raises(TypeError, match="in_sharding"):
        tb.minimize_proximal_gradient_batch(*args, in_sharding=object())
    with pytest.raises(ValueError, match="'batch' axis"):
        tb.minimize_proximal_gradient_batch(*args, in_sharding=feature_sharding(mesh))
    with pytest.raises(ValueError, match="lane_chunk cannot be combined"):
        tb.minimize_proximal_gradient_batch(*args, in_sharding=batch_sharding(mesh), lane_chunk=8)
    with pytest.warns(UserWarning, match="iter_chunk"):
        tb.minimize_proximal_gradient_batch(*args, lr=0.4, iter_chunk=64, check_every=8, max_iter=64)
    with pytest.warns(UserWarning, match="history=True"):
        tb.minimize_proximal_gradient_batch(*args, lr=0.4, history=True, check_every=8)
    # An array pair is stored as a tuple; integer starts take the default
    # float dtype.
    res = tb.minimize_proximal_gradient_batch(
        lambda x: torch.sum((x - 1.0) ** 2), lambda x: 0.1 * torch.sum(torch.abs(x)), None,
        lambda t, x: torch.sign(x) * torch.clamp_min(torch.abs(x) - 0.1 * t, 0.0),
        torch.tensor([[0], [2]]), lr=0.4, nesterov=True, nesterov_ratio=np.array([0.0, 0.25]),
    )
    assert res.nesterov_ratio == (0.0, 0.25) and res.success.all()
    assert res.x.dtype == torch.empty(0).numpy().dtype
    np.testing.assert_allclose(res.x, 0.95, atol=1e-4)
    # lr is honoured call by call.
    kw = dict(nesterov=False, tol=0.0, max_iter=3)
    r1 = tb.minimize_proximal_gradient_batch(*args, lr=0.4, **kw)
    r2 = tb.minimize_proximal_gradient_batch(*args, lr=0.004, **kw)
    np.testing.assert_allclose(r2.lr, 0.004, rtol=1e-15)
    assert not np.allclose(r1.x, r2.x)


def test_lane_chunk_merge_registry(monkeypatch):
    orig = tb._pack_result

    def patched(*a, **k):
        res = orig(*a, **k)
        res["mystery"] = np.zeros(2)  # global-looking, chunk-width array
        return res

    monkeypatch.setattr(tb, "_pack_result", patched)
    with pytest.raises(RuntimeError, match="mystery"):
        tb.minimize_proximal_gradient_batch(
            *_fns(T_TOY), torch.tensor(TOY_X0), lr=0.4, nesterov=True, lane_chunk=2
        )


class _Fault(torch.AcceleratorError):
    pass


def test_lane_chunked_device_fault_returns_partial(monkeypatch):
    """A device fault in the second of three lane chunks: the first chunk's
    lanes keep their results, the rest are status 2 with x = x0, NaN fun and
    nit 0, no chunk is dispatched after the fault, and the warning and the
    message name the lane where it hit."""
    B, K = 5, 2
    x0s = torch.tensor(DENSE_X0)
    kw = dict(nesterov=True)
    ref = _port("dense_backtracking")
    orig = tb.minimize_proximal_gradient_batch
    calls = {"n": 0}

    def flaky(f, g, jac_f, prox, x0_arg, **kwargs):
        if x0_arg.shape[0] == K:  # a chunk's call
            calls["n"] += 1
            if calls["n"] == 2:
                raise _Fault("injected: an illegal memory access was encountered")
        return orig(f, g, jac_f, prox, x0_arg, **kwargs)

    monkeypatch.setattr(tb, "minimize_proximal_gradient_batch", flaky)
    with pytest.warns(UserWarning, match=r"device fault at lane chunk \[2:5\]"):
        res = orig(*_fns(T_DENSE), x0s, lane_chunk=K, **kw)
    assert calls["n"] == 2
    np.testing.assert_array_equal(res.x[:K], ref.x[:K])
    np.testing.assert_array_equal(res.nit[:K], ref.nit[:K])
    assert list(res.status) == [1, 1, 2, 2, 2] and not res.success[K:].any()
    np.testing.assert_array_equal(res.x[K:], DENSE_X0[K:])
    assert np.isnan(res.fun[K:]).all() and (res.nit[K:] == 0).all()
    assert "partial: device fault" in res.message and "lanes 2:5" in res.message
    assert res.state is None and len(res.to_list()) == B
    # A fault in the first chunk has nothing to keep: it propagates.
    calls["n"] = 1
    with pytest.raises(_Fault):
        orig(*_fns(T_DENSE), x0s, lane_chunk=K, **kw)


def test_batch_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.minimize_proximal_gradient_batch(*_fns(T_TOY), TOY_X0)
    res = tb.minimize_proximal_gradient_batch(*_fns(T_TOY), TOY_X0, device="cpu", lr=0.4)
    assert res.x.shape == TOY_X0.shape and res.success.all()


def _model_lanes(name):
    """A model's callables and 16 float64 starts (lanes x n a multiple of
    16), with the batch options its solve takes."""
    from zfista_tpu_torch.models import GroupLasso, SparseLogistic, TVDeblur, WaveletDeblur
    from zfista_tpu_torch.models.deblur import gaussian_kernel

    rng = np.random.default_rng(11)
    kw = dict(nesterov=True, max_iter=40, device="cpu")
    if name in ("TVDeblur", "WaveletDeblur"):
        img = rng.uniform(0.0, 1.0, (8, 8))
        cls = TVDeblur if name == "TVDeblur" else WaveletDeblur
        extra = dict(tv_ratio=1e-2, prox_iter=5) if name == "TVDeblur" else dict(l1_ratio=1e-2)
        p = cls(torch.tensor(img), kernel=gaussian_kernel(3, 1.0), **extra)
        # Backtracking from 1/L: the objective of every trial, g included.
        kw.update(lr=1.0 / p.lipschitz())
        n = 64
    elif name == "SparseLogistic":
        A = rng.standard_normal((24, 32))
        y = np.sign(A @ rng.standard_normal(32) + 0.1)
        p = SparseLogistic(torch.tensor(A), torch.tensor(y), 0.02)
        n = 32
    else:
        A, b, _ = _dense(seed=4, m=24, n=32)
        # Groups of 4, or one group of all 32 features: with the lanes
        # innermost, the CPU orders a sum over a lane's whole vector by the
        # lane count, so that case holds the group norms' own sums.
        gs = 32 if name == "GroupLassoOneGroup" else 4
        p = GroupLasso(torch.tensor(A), torch.tensor(b), 0.05, gs)
        n = 32
    return (p.f, p.g, p.jac_f, p.prox_wsum_g), rng.uniform(-1.0, 1.0, (16, n)), kw


@pytest.mark.parametrize("layout", ["lanes_outer", "lanes_inner"])
@pytest.mark.parametrize(
    "name", ["SparseLogistic", "TVDeblur", "WaveletDeblur", "GroupLasso", "GroupLassoOneGroup"]
)
def test_model_lanes_do_not_depend_on_the_lane_count(name, layout):
    """A model's lane solved among 16 or among 8 is bitwise the same in
    every field (its sums under vmap are lane sums, whose order the lane
    count does not set): the contract of a lane-sharded or lane-chunked
    batch of the model.  Starts with the lanes innermost in memory (the
    transpose of an ``(n, B)`` array) keep that layout through the step,
    where a reduction kernel's order follows the lane count."""
    fns, x0s, kw = _model_lanes(name)

    def starts(a):
        return torch.tensor(a) if layout == "lanes_outer" else torch.tensor(a.T.copy()).T

    many = tb.minimize_proximal_gradient_batch(*fns, starts(x0s), **kw)
    few = tb.minimize_proximal_gradient_batch(*fns, starts(x0s[:8]), **kw)
    for field, u, v in zip(State._fields, many.state, few.state):
        np.testing.assert_array_equal(u[:8], v, err_msg=field)
