"""The single-pass LASSO gradient ``2·Aᵀ(A y − b)``
(``zfista_tpu_torch/csrc/lasso_normal_gemv.cu``) and the dispatch that
chooses it (``models.lasso._one_pass``).

On the CPU: the decision as a function of the operands' properties (meta
tensors at the headline's 2000 × 10,000 stand in for a card's, with the
card predicate widened to them), the CPU path bitwise the two products it
had, and the launch counter.  The test marked ``card`` holds the kernel to
a float64 gradient and to itself (two launches, an eager launch and a
replayed graph) on a card; this file imports no JAX, so it runs there:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_normal_gemv.py -m card
"""

import torch_env  # noqa: F401  (one torch thread a process)
import math

import numpy as np
import pytest
import torch

from zfista_tpu_torch.models import Lasso
from zfista_tpu_torch.models import lasso as tl
from zfista_tpu_torch.ops import fused
from zfista_tpu_torch.ops.precision import matmul_hp
from zfista_tpu_torch.parallel.sharding import make_mesh, operator_sharding, tag
from zfista_tpu_torch.utils import profiling

M, N = 2000, 10_000
F32 = torch.float32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


@pytest.fixture
def meta_is_card(monkeypatch):
    """Meta tensors count as the card's: the decision's other conditions
    then read shapes, strides and dtypes that cost no memory."""
    monkeypatch.setattr(fused, "_on_card", lambda t: t.device.type in ("cuda", "meta"))


def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _operands(case):
    """``(A, b, y)`` for a case of the decision."""
    m, n = M, N
    if case == "at the row budget":
        n = fused.NORMAL_GEMV_MAX_N
    if case == "past the row budget":
        n = fused.NORMAL_GEMV_MAX_N + 1
    if case == "one row":
        m = 1
    A, b, y = _meta(m, n), _meta(m), _meta(n)
    if case == "transposed":
        A = _meta(n, m).T
    elif case == "column slice":
        A = _meta(m, 2 * n)[:, ::2]
    elif case == "float64":
        A, b, y = _meta(m, n, dtype=torch.float64), _meta(m, dtype=torch.float64), _meta(n, dtype=torch.float64)
    elif case == "A needs grad":
        A.requires_grad_()
    elif case == "y needs grad":
        y.requires_grad_()
    elif case == "y strided":
        y = _meta(2 * n)[::2]
    elif case == "b of another length":
        b = _meta(m + 1)
    elif case == "no rows":
        A, b = _meta(0, n), _meta(0)
    elif case == "sharded":
        tag(A, operator_sharding(make_mesh()))
    elif case == "cpu":
        A, b, y = torch.zeros(m, n), torch.zeros(m), torch.zeros(n)
    return A, b, y


@pytest.mark.parametrize(
    "case, takes",
    [
        ("whole", True),
        ("at the row budget", True),
        ("one row", True),
        ("past the row budget", False),
        ("transposed", False),
        ("column slice", False),
        ("float64", False),
        ("A needs grad", False),
        ("y needs grad", False),
        ("y strided", False),
        ("b of another length", False),
        ("no rows", False),
        ("sharded", False),
        ("cpu", False),
    ],
)
def test_dispatch_takes_the_kernel_only_where_it_may(meta_is_card, case, takes):
    """A whole, contiguous float32 operator on a card at the headline's
    shape takes the kernel; each excluded property keeps the two
    products."""
    assert tl._one_pass(*_operands(case)) is takes


@pytest.mark.parametrize("transform", ["vmap", "jacrev"])
def test_dispatch_keeps_the_products_under_torch_func(meta_is_card, transform):
    """The batch layer calls ``jac_f`` under ``vmap``; a ``jacrev`` tracks
    its input: neither reaches the kernel, which has no batching rule and
    no derivative."""
    A, b, _ = _operands("whole")
    seen = []

    def grad_of(v):
        seen.append(tl._one_pass(A, b, v))
        return v * 1

    if transform == "vmap":
        torch.func.vmap(grad_of)(_meta(3, N))
    else:
        torch.func.jacrev(grad_of)(_meta(N))
    assert seen == [False]


def _old_grad(A, b, x):
    """The gradient as the model computed it before the kernel."""
    return 2 * matmul_hp(A.T, matmul_hp(A, x) - b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mu", [0.0, 0.3])
def test_cpu_gradient_is_bitwise_the_two_products(monkeypatch, dtype, mu):
    """On the CPU ``_lasso_jac_p`` (the fixed-step solve's) and
    ``Lasso.jac_f`` (the backtracking solve's), with and without the
    elastic-net term, are bitwise what they were, and never reach the
    kernel's wrapper."""
    rng = np.random.default_rng(11)
    A = torch.as_tensor(rng.standard_normal((37, 53)), dtype=dtype)
    b = torch.as_tensor(rng.standard_normal(37), dtype=dtype)
    x = torch.as_tensor(rng.standard_normal(53), dtype=dtype)
    monkeypatch.setattr(fused, "lasso_normal_gemv", lambda *a: pytest.fail("kernel on the CPU"))
    want = _old_grad(A, b, x) + (mu * x if mu else 0)
    p = (A, b, torch.tensor(0.1, dtype=dtype)) + ((torch.tensor(mu, dtype=dtype),) if mu else ())
    assert torch.equal(tl._lasso_jac_p(x, p)[0], _old_grad(A, b, x) + (p[3] * x if mu else 0))
    got = Lasso(A, b, 0.1, l2_ratio=mu, device="cpu").jac_f(x)
    assert got.shape == (1, 53) and torch.equal(got[0], want)


def test_cpu_wrapper_is_its_plain_version_and_counts_nothing():
    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.standard_normal((9, 14)), dtype=F32)
    b, y = torch.as_tensor(rng.standard_normal(9), dtype=F32), torch.as_tensor(rng.standard_normal(14), dtype=F32)
    before = fused.launch_counts["lasso_normal_gemv"]
    got = fused.lasso_normal_gemv(A, b, y)
    assert torch.equal(got, fused.lasso_normal_gemv_plain(A, b, y))
    assert torch.equal(got, _old_grad(A, b, y))
    assert fused.launch_counts["lasso_normal_gemv"] == before


def test_launch_counter_is_registered():
    """The counter of the kernel's launches is one of the tracing
    registry's: ``profiling.snapshot()`` reports it as
    ``fused.lasso_normal_gemv``."""
    assert profiling.COUNTERS["fused"] is fused.launch_counts
    assert "lasso_normal_gemv" in fused.launch_counts
    snap = profiling.snapshot()
    assert snap["fused.lasso_normal_gemv"] == fused.launch_counts["lasso_normal_gemv"]


#: (m, n): the headline, ragged rows and columns, one column, one row, the
#: row budget, a row under four floats.
CARD_SHAPES = ((M, N), (1999, 10_001), (M, 1), (1, N), (7, fused.NORMAL_GEMV_MAX_N), (300, 3))


def _chain(m: int, n: int) -> int:
    """The kernel's longest chain of float32 roundings into one gradient
    entry: a row's dot product (at most 24 products a thread, 5 butterfly
    levels, 16 warps, − b) and a column's sum (its block's rows, ceil(m /
    132) of them; a slice of ceil(132 / 8) = 17 partials; 8 slices).  The
    doubling is exact."""
    rows = math.ceil(m / min(m, fused.NORMAL_GEMV_BLOCKS))
    return math.ceil(n / 512) + 5 + 16 + 1 + rows + 17 + 8


@pytest.mark.card
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_on_the_card(card, offset):
    """Against a float64 gradient, within the a-priori bound of its sums
    (Higham: |ĝ − g| ≤ 2·γ_K·|A|ᵀ(|A||y| + |b|), γ_K = K·u/(1 − K·u), u =
    2⁻²⁴, K the chain of :func:`_chain` plus one for the residual's
    rounding carried through the second sum); bitwise the same from launch
    to launch and between an eager launch and a replayed CUDA graph; one
    launch counted a call.  ``offset`` 1 starts ``A`` 4 bytes past an
    aligned address: rows off 16-byte boundaries take the kernel's
    one-float loads."""
    rng = np.random.default_rng(21)
    for m, n in CARD_SHAPES:
        host = (rng.standard_normal((m, n)) / math.sqrt(m)).astype(np.float32)
        buf = torch.empty(m * n + offset, dtype=F32, device=card)
        A = buf[offset:].view(m, n)
        A.copy_(torch.as_tensor(host))
        b = torch.as_tensor(rng.standard_normal(m).astype(np.float32), device=card)
        y = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=card)
        assert tl._one_pass(A, b, y)
        before = fused.launch_counts["lasso_normal_gemv"]
        got = fused.lasso_normal_gemv(A, b, y)
        again = fused.lasso_normal_gemv(A, b, y)
        assert fused.launch_counts["lasso_normal_gemv"] - before == 2
        A64, b64, y64 = A.double(), b.double(), y.double()
        want = 2 * (A64.T @ (A64 @ y64 - b64))
        u, k = 2.0**-24, _chain(m, n) + 1
        bound = 2 * (k * u / (1 - k * u)) * (A64.abs().T @ (A64.abs() @ y64.abs() + b64.abs()))
        err = (got.double() - want).abs()
        assert bool(torch.all(err <= bound)), (m, n, float(torch.max(err / bound)))
        assert torch.equal(got.view(torch.int32), again.view(torch.int32)), (m, n)

        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = fused.lasso_normal_gemv(A, b, y)
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed.view(torch.int32), got.view(torch.int32)), (m, n)
