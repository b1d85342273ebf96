"""The port's split-complex deep solves
(evostencils_tpu_torch/compiler/refine_split.py) against the JAX package's
df64 module (evostencils_tpu/compiler/refine_split.py) on the CPU: the
float64 residual and matvec of the Robin-folded block system against the
df64 ones (hi + lo), the refusals of entries outside that class, and the
three solvers to a TRUE relative residual of 1e-7 with float32 recurrences
(tests/test_refine_split.py, tests/test_df64_basis.py): the true residual
recomputed in float64 from the returned solution, the iterations against
the float64 BiCGStab's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.compiler import refine_split as jrs
from evostencils_tpu.ir import base as jbase
from evostencils_tpu.problems import helmholtz as jhelmholtz
from evostencils_tpu.stencils import constant as jconstant
from evostencils_tpu_torch.compiler import cycles as tcycles
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.compiler import refine_split as trs
from evostencils_tpu_torch.ir import base as tbase
from evostencils_tpu_torch.ir import partitioning as tpart
from evostencils_tpu_torch.ir import smoother as tsmoother
from evostencils_tpu_torch.ops import apply as tapply
from evostencils_tpu_torch.ops.solvers import preconditioned_bicgstab_split
from evostencils_tpu_torch.problems import helmholtz as thelmholtz
from evostencils_tpu_torch.problems.poisson import build_rhs
from evostencils_tpu_torch.stencils import constant as tconstant

#: the JAX tests' problem (tests/test_refine_split.py:25-29)
LEVELS, K_TEST = (5, 3), 40.0
#: the JAX tests' bounds: the true residual recomputed in float64, and
#: the iterations against the float64 BiCGStab's
#: (tests/test_refine_split.py:96-107)
TRUE_TOL, ITER_FACTOR, ITER_SLACK = 2e-7, 1.15, 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run's parallel workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(pkg=thelmholtz):
    return pkg.helmholtz_2d_split(*LEVELS, k=K_TEST)


def test_split_residual_f64_matches_df64():
    """``split_system_residual_f64`` against the JAX
    ``split_system_residual_df`` (hi + lo) on the same float64 u and
    float32 b, with the Robin fold's center fixups on rows 0 and n - 1:
    within 1e-12 of max|b|, at the float64 solution of the system (where
    b - A u cancels to rounding) and at a random u."""
    pt, pj = _problem(), _problem(jhelmholtz)
    op_t, op_j = pt.outer_solver.operator, pj.outer_solver.operator
    b = tuple(np.asarray(f, np.float32) for f in pt.rhs_builder(np.float64))
    flat = np.concatenate([f.astype(np.float64).reshape(-1) for f in b])
    n = b[0].size
    solution = tlower.dense_inverse(op_t) @ flat
    rng = np.random.default_rng(3)
    for u in ([solution[:n], solution[n:]],
              [rng.standard_normal(n), rng.standard_normal(n)]):
        u = [x.reshape(b[0].shape) for x in u]
        got = trs.split_system_residual_f64(op_t)(
            tuple(torch.tensor(x) for x in u),
            tuple(torch.tensor(f) for f in b))
        hi = tuple(jnp.asarray(x.astype(np.float32)) for x in u)
        lo = tuple(jnp.asarray((x - x.astype(np.float32)).astype(np.float32))
                   for x in u)
        rh, rl = jrs.split_system_residual_df(op_j)(
            hi, lo, tuple(jnp.asarray(f) for f in b))
        scale = max(np.abs(f).max() for f in b)
        for g, h, l in zip(got, rh, rl):
            want = np.asarray(h, np.float64) + np.asarray(l, np.float64)
            assert g.dtype == torch.float64
            assert np.abs(g.numpy() - want).max() <= 1e-12 * scale


def test_split_matvec_f64_matches_df64_and_the_fields():
    """``split_system_matvec_f64`` against the JAX
    ``split_system_matvec_df`` (hi + lo) and against the operator's own
    ``StencilField`` blocks in float64 (the generic lowering), at a random
    float32 u: within 1e-12 of max|A u|."""
    pt, pj = _problem(), _problem(jhelmholtz)
    op_t, op_j = pt.outer_solver.operator, pj.outer_solver.operator
    rng = np.random.default_rng(4)
    u = tuple(rng.standard_normal((31, 31)).astype(np.float32)
              for _ in range(2))
    got = trs.split_system_matvec_f64(op_t)(tuple(torch.tensor(x)
                                                  for x in u))
    jh, jl = jrs.split_system_matvec_df(op_j)(jrs._vdf_from(
        tuple(jnp.asarray(x) for x in u)))
    generic = tlower.operator_applier(op_t)(tuple(torch.tensor(x).double()
                                                  for x in u))
    for g, h, l, gen in zip(got, jh, jl, generic):
        want = np.asarray(h, np.float64) + np.asarray(l, np.float64)
        scale = np.abs(want).max()
        assert np.abs(g.numpy() - want).max() <= 1e-12 * scale
        assert np.abs(g.numpy() - gen.numpy()).max() <= 1e-12 * scale


class _Fields:
    """A generator whose stencil field departs from its constant stencil
    by ``deltas`` {offset: (row, [values along the row])}."""

    def __init__(self, constant, apply, deltas):
        self.constant, self.apply, self.deltas = constant, apply, deltas

    def generate_stencil(self, grid):
        return self.constant.Stencil([((0, 0), 4.0), ((0, 1), -1.0),
                                      ((1, 0), -1.0)], 2)

    def generate_stencil_field(self, grid):
        st = self.generate_stencil(grid)
        shape = tuple(grid.size)
        fields = []
        for off, v in st.entries:
            f = np.full(shape, float(v))
            if off in self.deltas:
                row, values = self.deltas[off]
                f[row] += values
            fields.append(f)
        return self.apply.StencilField([o for o, _ in st.entries], fields)


@pytest.mark.parametrize("case", ["off-center", "varying-row"])
def test_entry_parts_refuse_as_jax(case):
    """An entry whose field departs from its stencil off the center, or by
    a delta that varies along a row, is refused with the JAX package's
    message; a constant center delta on one row is a fixup."""
    from evostencils_tpu.ops import apply as japply
    from evostencils_tpu_torch.grids import unit_interval_grid as tgrid
    from evostencils_tpu.grids import unit_interval_grid as jgrid
    deltas = {"off-center": {(0, 1): (0, np.ones(15))},
              "varying-row": {(0, 0): (3, np.arange(15.0))}}[case]
    tentry = tbase.Operator("A", tgrid(2, 4),
                            _Fields(tconstant, tapply, deltas))
    jentry = jbase.Operator("A", jgrid(2, 4),
                            _Fields(jconstant, japply, deltas))
    with pytest.raises(NotImplementedError) as jerr:
        jrs._entry_df_parts(jentry)
    with pytest.raises(NotImplementedError) as terr:
        trs._entry_parts(tentry)
    assert str(terr.value) == str(jerr.value)
    fixed = tbase.Operator("A", tgrid(2, 4), _Fields(
        tconstant, tapply, {(0, 0): (2, np.full(15, 0.5))}))
    stencil, fixups = trs._entry_parts(fixed)
    assert fixups == [(2, 0.5)] and len(stencil.entries) == 3


def jax_reliable_iterations(k, levels=(7, 3)):
    """The JAX package's ``reliable_bicgstab_split`` iterations to a true
    1e-7 on helmholtz_2d_split(*levels, k) in float32 on the CPU, one
    collective red-black V(2,1) (omega 0.6) a preconditioner application
    (tests/test_refine_split.py's setup).  ``chip_smoke.py`` holds the
    port's [deep-split] on the card to it:

        JAX_PLATFORMS=cpu python -c 'from tests.test_torch_refine_split
        import jax_reliable_iterations as f; print(f(80.0))'
    """
    from tests.test_refine_split import _setup_solver
    p = jhelmholtz.helmholtz_2d_split(*levels, k=k)
    p.dtype = np.float32
    mv, pc = _setup_solver(p, np.float32)
    _, _, it, hist = jrs.reliable_bicgstab_split(
        mv, pc, jrs.split_system_residual_df(p.outer_solver.operator),
        p.rhs_builder(np.float32), tol=1e-7,
        maxiter=p.outer_solver.max_iterations)
    return int(it)


def _solver(problem, dtype):
    """(matvec, preconditioner, b) of the split problem in ``dtype``: the
    collective red-black V(2,1) at omega 0.6 from zero a preconditioner
    application (tests/test_refine_split.py:59-74)."""
    cyc = tcycles.v_cycle(
        problem.level_contexts, problem.rhs_entity, pre_smoothing=2,
        post_smoothing=1, omega=0.6, partitioning=tpart.RedBlack,
        smoother_factory=tsmoother.generate_collective_jacobi,
        coarse_operator=problem.coarsest_operator)
    low = tlower.lower_cycle(cyc, problem.approximation, problem.rhs_entity)
    om = torch.tensor(low.default_omegas, dtype=dtype)

    def precond(fields):
        return low.step(tuple(torch.zeros_like(f) for f in fields), fields,
                        om)

    return (tlower.operator_applier(problem.outer_solver.operator), precond,
            build_rhs(problem, dtype=dtype, device="cpu"))


_F64 = {}


def _float64_reference():
    """The float64 split BiCGStab's iterations to 1e-7, and its matvec
    and b, once per run."""
    if not _F64:
        mv, pc, b = _solver(_problem(), torch.float64)
        _, k, _ = preconditioned_bicgstab_split(mv, pc, b, tol=1e-7,
                                                maxiter=3000)
        _F64.update(k=k, matvec=mv, b=b)
    return _F64


def _true_relative(x):
    ref = _float64_reference()
    ax = ref["matvec"](x)
    r = np.sqrt(sum(float(torch.sum((bb - aa) ** 2))
                    for bb, aa in zip(ref["b"], ax)))
    return r / np.sqrt(sum(float(torch.sum(bb ** 2)) for bb in ref["b"]))


@pytest.mark.parametrize("solver", ["reliable", "refined", "f64_basis"])
def test_reaches_true_1em7_in_f32(solver):
    """Each solver on float32 fields with the float32 preconditioner
    reaches a TRUE relative residual of 1e-7: its last history entry is
    at most 1e-7 (1.1e-7 for the float64 basis, as
    tests/test_df64_basis.py:76 allows), the residual recomputed in
    float64 from the returned float64 solution at most 2e-7, within the
    iterations of the JAX test's bound on the float64 BiCGStab's count
    (1.15 k64 + 10; the refined solver restarts the plateau phase and is
    held to 3 k64)."""
    p = _problem()
    mv, pc, b = _solver(p, torch.float32)
    assert all(f.dtype == torch.float32 for f in b)
    op = p.outer_solver.operator
    residual = trs.split_system_residual_f64(op)
    if solver == "reliable":
        x, k, hist = trs.reliable_bicgstab_split(mv, pc, residual, b,
                                                 tol=1e-7, maxiter=3000)
    elif solver == "refined":
        x, k, hist = trs.refined_bicgstab_split(mv, pc, residual, b,
                                                tol=1e-7, maxiter=3000)
    else:
        x, k, hist = trs.f64_basis_bicgstab_split(
            trs.split_system_matvec_f64(op), pc, residual, b, tol=1e-7,
            maxiter=600, segment=50)
    assert all(f.dtype == torch.float64 for f in x)
    assert hist[-1] <= (1.1e-7 if solver == "f64_basis" else 1e-7)
    assert _true_relative(x) <= TRUE_TOL
    k64 = _float64_reference()["k"]
    bound = 3 * k64 if solver == "refined" else \
        ITER_FACTOR * k64 + ITER_SLACK
    assert 0 < k <= bound, (k, k64)


def test_reliable_matches_jax_iterations():
    """The port's reliable solve and the JAX package's on the same float32
    b: both reach the true 1e-7, with iteration counts within 10% of each
    other (their float32 recurrences round apart, and the replacement
    points fall on the same segment boundaries)."""
    pj = _problem(jhelmholtz)
    from tests.test_refine_split import _setup_solver
    mvj, pcj = _setup_solver(pj, np.float32)
    bj = pj.rhs_builder(np.float32)
    _, _, kj, hj = jrs.reliable_bicgstab_split(
        mvj, pcj, jrs.split_system_residual_df(pj.outer_solver.operator),
        bj, tol=1e-7, maxiter=3000)
    p = _problem()
    mv, pc, b = _solver(p, torch.float32)
    np.testing.assert_array_equal(np.asarray(bj[0]), b[0].numpy())
    _, k, hist = trs.reliable_bicgstab_split(
        mv, pc, trs.split_system_residual_f64(p.outer_solver.operator), b,
        tol=1e-7, maxiter=3000)
    assert hj[-1] <= 1e-7 and hist[-1] <= 1e-7
    assert abs(k - kj) <= 0.1 * kj, (k, kj)


#: the [deep-split] solve: helmholtz_2d_split(7, 3) at k = 80, where the
#: port's float32 reliable solve may take RELIABLE_JAX_FACTOR times the
#: JAX package's iterations (296 on the CPU): its float32 recurrence
#: rounds apart from the JAX one, and it took 333 iterations with one
#: torch thread, 334 with two and 349 with four on the CPU, and 367 on an
#: H100 (chip_smoke.py holds it there to the same factor)
RELIABLE_K, RELIABLE_JAX_FACTOR = 80.0, 1.3


def test_reliable_at_k80_against_jax():
    """The reliable solve of [deep-split] against the JAX package's on
    the CPU, on the same float32 b: both reach a true 1e-7, the port's
    recomputed in float64 from its solution within TRUE_TOL, and its
    iterations within RELIABLE_JAX_FACTOR of the JAX package's."""
    k_jax = jax_reliable_iterations(RELIABLE_K)
    p = thelmholtz.helmholtz_2d_split(7, 3, k=RELIABLE_K)
    mv, pc, b = _solver(p, torch.float32)
    op = p.outer_solver.operator
    x, k, hist = trs.reliable_bicgstab_split(
        mv, pc, trs.split_system_residual_f64(op), b, tol=1e-7,
        maxiter=p.outer_solver.max_iterations)
    b64 = build_rhs(p, dtype=torch.float64, device="cpu")
    ax = tlower.operator_applier(op)(x)
    true = np.sqrt(sum(float(torch.sum((bi - ai) ** 2))
                       for bi, ai in zip(b64, ax))
                   / sum(float(torch.sum(bi ** 2)) for bi in b64))
    assert hist[-1] <= 1e-7 and true <= TRUE_TOL, (hist[-1], true)
    assert abs(k - k_jax) <= (RELIABLE_JAX_FACTOR - 1) * k_jax, (k, k_jax)
