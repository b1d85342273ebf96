"""The port's Krylov solvers against the JAX package on the CPU: ``cg`` with
its masked stopping test, the fixed-iteration executors of
``FIXED_KRYLOV``, the CG coarse solve that the lowering runs above
``DIRECT_SOLVE_MAX`` unknowns, and the V-cycles whose coarse solve is a
``KrylovSubspaceMethod`` node (tests/test_krylov.py:99-135).

Everything runs in float64 but the one float32 CG case.  A JAX ``cg``
returns ``x`` alone; its iteration count is read by running it with
``maxiter`` one short of the port's count, at it and one past it: the
first ``x`` differs from the second, which equals the third.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.compiler import cycles as jcycles
from evostencils_tpu.compiler import lower as jlower
from evostencils_tpu.compiler import solve as jsolve
from evostencils_tpu.ir import partitioning as jpart
from evostencils_tpu.ops import solvers as jsolvers
from evostencils_tpu.problems import poisson as jpoisson
from evostencils_tpu_torch.compiler import cycles as tcycles
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.compiler import solve as tsolve
from evostencils_tpu_torch.config import DIRECT_SOLVE_MAX
from evostencils_tpu_torch.ir import partitioning as tpart
from evostencils_tpu_torch.ops import solvers as tsolvers
from evostencils_tpu_torch.problems import poisson as tpoisson
from evostencils_tpu_torch.problems.poisson import build_rhs

#: x of a solver, port against JAX, relative to max|JAX| (float64)
X_RTOL = 1e-12
#: the small system: two fields of N x N, the 5-point Laplacian on each,
#: the second shifted by SHIFT (so that the fields converge apart)
N = 15
SHIFT = 0.75


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run's parallel workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _laplace(u, xp):
    pad = torch.nn.functional.pad(u, (1, 1, 1, 1)) if xp is torch \
        else xp.pad(u, 1)
    return (4 * u - pad[:-2, 1:-1] - pad[2:, 1:-1] - pad[1:-1, :-2]
            - pad[1:-1, 2:])


def _matvec(xp):
    """The two-field operator in ``xp`` (jnp, torch or numpy)."""
    return lambda v: (_laplace(v[0], xp), _laplace(v[1], xp) + SHIFT * v[1])


def _rhs(dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    b = [rng.standard_normal((N, N)) for _ in range(2)]
    if np.dtype(dtype).kind == "c":
        b = [x + 1j * rng.standard_normal((N, N)) for x in b]
    return [x.astype(dtype) for x in b]


def _both(b):
    return (tuple(jnp.asarray(x) for x in b),
            tuple(torch.from_numpy(x) for x in b))


def _assert_close(got, want, rtol=X_RTOL):
    scale = max(np.abs(np.asarray(w)).max() for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=rtol * scale)


def _jax_cg(bj, tol, maxiter):
    return jsolvers.cg(_matvec(jnp), bj, tol=tol, maxiter=maxiter)


def _port_cg(bt, tol, maxiter):
    """The port's x, iterations and host syncs."""
    tsolvers.reset_cg_counts()
    x = tsolvers.cg(_matvec(torch), bt, tol=tol, maxiter=maxiter)
    counts = dict(tsolvers.cg_counts)
    return x, int(counts["iterations"]), counts["syncs"]


def _jax_iterations_equal(bj, tol, k):
    """Whether the JAX cg stops after exactly ``k`` iterations."""
    before, at, after = (np.asarray(_jax_cg(bj, tol, m)[0])
                         for m in (k - 1, k, k + 1))
    return not np.array_equal(before, at) and np.array_equal(at, after)


# ---------------------------------------------------------------------------
# cg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tol", [1e-6, 1e-9, 1e-12])
def test_cg_matches_jax(tol):
    """To each tolerance the port stops at the JAX loop's iteration and
    returns its x within X_RTOL; it read the test back once every
    CG_CHECK_EVERY iterations, plus the read that found it done."""
    bj, bt = _both(_rhs())
    x, k, syncs = _port_cg(bt, tol, 1000)
    assert 5 < k < 1000
    assert _jax_iterations_equal(bj, tol, k)
    _assert_close(x, _jax_cg(bj, tol, 1000))
    assert syncs == math.ceil(k / tsolvers.CG_CHECK_EVERY) + 1


def test_cg_stops_between_checks(monkeypatch):
    """A stopping iteration between two reads: the state frozen on the
    device from the JAX loop's last iteration on, x is bitwise that of
    reading the test every iteration and of reading it every 7 or 50."""
    bj, bt = _both(_rhs(seed=3))
    tol = 1e-8
    monkeypatch.setattr(tsolvers, "CG_CHECK_EVERY", 1)
    x1, k, syncs = _port_cg(bt, tol, 1000)
    assert syncs == k + 1 and _jax_iterations_equal(bj, tol, k)
    for every in (7, 50):
        monkeypatch.setattr(tsolvers, "CG_CHECK_EVERY", every)
        xs, ks, syncs = _port_cg(bt, tol, 1000)
        assert k % every != 0
        assert ks == k and syncs == k // every + 2
        for a, c in zip(xs, x1):
            assert torch.equal(a, c)


def test_cg_maxiter_and_complex():
    """The maxiter bound (JAX's count is maxiter exactly) and a complex
    right-hand side of a Hermitian operator (the conjugating dot product):
    x within X_RTOL."""
    bj, bt = _both(_rhs())
    x, k, _ = _port_cg(bt, 1e-14, 13)
    assert k == 13
    _assert_close(x, _jax_cg(bj, 1e-14, 13))
    bj, bt = _both(_rhs(np.complex128, seed=1))
    x, k, _ = _port_cg(bt, 1e-8, 200)
    assert x[0].dtype == torch.complex128 and 5 < k < 200
    assert _jax_iterations_equal(bj, 1e-8, k)
    _assert_close(x, _jax_cg(bj, 1e-8, 200))


def test_cg_float32_residuals_above_the_floor():
    """In float32 the recurrence can pass its threshold at another
    iteration than JAX's, so the two are held by their true residuals
    instead: at 1e-5 both reach it within the float32 floor, and the two
    x agree to 1e-4 of max|JAX|."""
    b = _rhs(np.float32, seed=2)
    bj, bt = _both(b)
    xj = _jax_cg(bj, 1e-5, 1000)
    xt, _, _ = _port_cg(bt, 1e-5, 1000)
    bnorm = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in b))
    mv = _matvec(np)
    for x in (tuple(np.asarray(v, np.float64) for v in xj),
              tuple(v.numpy().astype(np.float64) for v in xt)):
        r = [bi - ai for bi, ai in zip(b, mv(x))]
        assert np.sqrt(sum((ri ** 2).sum() for ri in r)) < 2e-5 * bnorm
    _assert_close(xt, xj, rtol=1e-4)


# ---------------------------------------------------------------------------
# the fixed-iteration executors
# ---------------------------------------------------------------------------

#: (executor, iterations): BiCGStab to 12 only, since its recurrence
#: amplifies the dot products' summation-order rounding about tenfold
#: every two iterations on this operator (2e-11 of max|x| at 25)
FIXED_CASES = [(name, it) for name in sorted(jsolvers.FIXED_KRYLOV)
               for it in (1, 6, 12, 25)
               if not (name == "BiCGStab" and it > 12)]


@pytest.mark.parametrize("name, iterations", FIXED_CASES)
def test_fixed_executor_matches_jax(name, iterations):
    """Each executor, from zero and from a nonzero x0, within X_RTOL."""
    assert sorted(tsolvers.FIXED_KRYLOV) == sorted(jsolvers.FIXED_KRYLOV)
    b = _rhs(seed=iterations)
    x0 = _rhs(seed=100 + iterations)
    bj, bt = _both(b)
    x0j, x0t = _both(x0)
    fj, ft = jsolvers.FIXED_KRYLOV[name], tsolvers.FIXED_KRYLOV[name]
    _assert_close(ft(_matvec(torch), bt, iterations),
                  fj(_matvec(jnp), bj, iterations))
    _assert_close(ft(_matvec(torch), bt, iterations, x0t),
                  fj(_matvec(jnp), bj, iterations, x0j))


@pytest.mark.parametrize("name", sorted(jsolvers.FIXED_KRYLOV))
def test_fixed_executor_zero_rhs_and_complex(name):
    """A zero right-hand side stays zero through the zero-denominator
    guards (no NaN), and a complex right-hand side of the real operator
    matches JAX within X_RTOL."""
    zero = tuple(torch.zeros(N, N, dtype=torch.float64) for _ in range(2))
    x = tsolvers.FIXED_KRYLOV[name](_matvec(torch), zero, 5)
    assert all(torch.equal(xi, torch.zeros_like(xi)) for xi in x)
    bj, bt = _both(_rhs(np.complex128, seed=4))
    got = tsolvers.FIXED_KRYLOV[name](_matvec(torch), bt, 8)
    assert got[0].dtype == torch.complex128
    _assert_close(got, jsolvers.FIXED_KRYLOV[name](_matvec(jnp), bj, 8))


# ---------------------------------------------------------------------------
# the lowered coarse solves
# ---------------------------------------------------------------------------

def _lowered(pkg_cycles, pkg_lower, part, problem, krylov=None):
    cycle = pkg_cycles.v_cycle(
        problem.level_contexts, problem.rhs_entity, pre_smoothing=2,
        post_smoothing=1, omega=1.15, partitioning=part.RedBlack,
        coarse_operator=problem.coarsest_operator, coarse_krylov=krylov,
        coarse_krylov_iterations=300)
    return pkg_lower.lower_cycle(cycle, problem.approximation,
                                 problem.rhs_entity)


_SOLVES = {}


def _step_and_solve(levels, krylov, max_iterations, target):
    """One step from a random start and a solve from zero in each package,
    once: ((JAX u, port u), (JAX k, port k), the port's solve's CG counts,
    the port's lowered cycle)."""
    key = (levels, krylov, max_iterations, target)
    if key not in _SOLVES:
        _SOLVES[key] = _run_step_and_solve(*key)
    return _SOLVES[key]


def _run_step_and_solve(levels, krylov, max_iterations, target):
    pj = jpoisson.poisson_2d(*levels)
    pj.dtype = np.float64
    pt = tpoisson.poisson_2d(*levels)
    lj = _lowered(jcycles, jlower, jpart, pj, krylov)
    lt = _lowered(tcycles, tlower, tpart, pt, krylov)
    bj = pj.build_rhs()
    bt = build_rhs(pt, dtype=torch.float64, device="cpu")
    u0 = np.random.default_rng(7).standard_normal(bt[0].shape)
    omj, omt = jnp.asarray(lj.default_omegas), torch.tensor(lt.default_omegas)
    uj = lj.step((jnp.asarray(u0),), bj, omj)[0]
    ut = lt.step((torch.from_numpy(u0),), bt, omt)[0]
    _, kj, _ = jsolve.make_solver(lj, max_iterations, target)(
        (jnp.zeros_like(bj[0]),), bj, omj)
    tsolvers.reset_cg_counts()
    _, kt, _ = tsolve.make_solver(lt, max_iterations, target)(
        (torch.zeros_like(bt[0]),), bt, omt)
    return (np.asarray(uj), ut.numpy()), (int(kj), kt), \
        dict(tsolvers.cg_counts), lt


def test_cg_coarse_solve_in_lowered_cycle():
    """The RB V(2,1) of poisson_2d(8, 7): 255^2 over a coarse 127^2
    (16,129 unknowns, above DIRECT_SOLVE_MAX), which both lowerings solve
    by CG to 1e-12: one step within X_RTOL of max|JAX| and a solve to 1e-8
    in as many cycles, one CG solve a cycle; the cycle syncs the host, so
    its preconditioner would run eagerly."""
    (uj, ut), (kj, kt), counts, lt = _step_and_solve((8, 7), None, 20, 1e-8)
    assert 127 * 127 > DIRECT_SOLVE_MAX and lt.syncs_host
    np.testing.assert_allclose(ut, uj, rtol=0,
                               atol=X_RTOL * np.abs(uj).max())
    assert kt == kj and 3 <= kt < 20
    assert counts["solves"] == kt and int(counts["iterations"]) > 100 * kt


@pytest.mark.parametrize("krylov", [None, "CG", "BiCGStab", "MinRes",
                                    "ConjugateResidual"])
def test_krylov_coarse_solve_v_cycle(krylov):
    """tests/test_krylov.py:99-135 in both packages: poisson_2d(6, 4)'s RB
    V(2,1) over a coarse 15^2 solved by the dense inverse or by 300
    iterations of a fixed Krylov executor: one step within X_RTOL of
    max|JAX|, the same cycles to 1e-10; with CG as many as the dense
    solve's or one more, as the JAX test holds."""
    (uj, ut), (kj, kt), counts, lt = _step_and_solve((6, 4), krylov, 30,
                                                     1e-10)
    assert not lt.syncs_host and counts["solves"] == 0
    np.testing.assert_allclose(ut, uj, rtol=0,
                               atol=X_RTOL * np.abs(uj).max())
    assert kt == kj and kt < 30
    if krylov == "CG":
        (_, _), (_, k_dense), _, _ = _step_and_solve((6, 4), None, 30,
                                                     1e-10)
        assert kt <= k_dense + 1
