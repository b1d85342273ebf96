"""The port's complex Helmholtz path against the JAX package on the CPU:
the complex sweep kernels' plain versions (``ops/kernels/rbgs_cx``), the
``helmholtz_2d`` problem, one lowered step of complex cycles, the outer
BiCGStab, the evaluator with the outer solver, the Dirichlet
shifted-Laplace hierarchy that reaches the sweep kernels, "JAX lowers =>
the port lowers" on seeded individuals, and the ``helmholtz2d`` CLI.

On the CPU the port's sweep wrappers run their plain versions; the JAX
package's Pallas entries run in interpret mode, as tests/test_pallas_cx.py
runs them.
"""

import collections
import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.compiler import cycles as jcycles
from evostencils_tpu.compiler import lower as jlower
from evostencils_tpu.evaluation import evaluator as jev
from evostencils_tpu.grammar import gp as jgp
from evostencils_tpu.grammar import multigrid as jmg
from evostencils_tpu.ir import base as jbase
from evostencils_tpu.ir import partitioning as jpart
from evostencils_tpu.ir import smoother as jsmoother
from evostencils_tpu.ir import system as jsystem
from evostencils_tpu.ir import transformations as jtrans
from evostencils_tpu.ops import solvers as jsolvers
from evostencils_tpu.ops.pallas import rbgs_cx as jcx
from evostencils_tpu.problems import helmholtz as jhelmholtz
from evostencils_tpu.stencils.constant import Stencil as JStencil
from evostencils_tpu_torch import optimize as toptimize
from evostencils_tpu_torch.compiler import cycles as tcycles
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.compiler import solve as tsolve
from evostencils_tpu_torch.evaluation import evaluator as tev
from evostencils_tpu_torch.grammar import gp as tgp
from evostencils_tpu_torch.grammar import multigrid as tmg
from evostencils_tpu_torch.ir import base as tbase
from evostencils_tpu_torch.ir import partitioning as tpart
from evostencils_tpu_torch.ir import smoother as tsmoother
from evostencils_tpu_torch.ir import system as tsystem
from evostencils_tpu_torch.ir import transformations as ttrans
from evostencils_tpu_torch.ops import apply as tapply
from evostencils_tpu_torch.ops import solvers as tsolvers
from evostencils_tpu_torch.ops.kernels import rbgs_cx as tcx
from evostencils_tpu_torch.ops.kernels import transfer as ttransfer
from evostencils_tpu_torch.optimization import program as tprogram
from evostencils_tpu_torch.problems import helmholtz as thelmholtz
from evostencils_tpu_torch.problems.helmholtz import dirichlet_helmholtz
from evostencils_tpu_torch.problems.poisson import build_rhs, poisson_2d
from evostencils_tpu_torch.stencils.constant import Stencil as TStencil

from tests.test_pallas_cx import VALS, _dirichlet_helmholtz, _random_cx
from tests.test_torch_slice3d import _describe

JAX = SimpleNamespace(problems=jhelmholtz, cycles=jcycles, part=jpart,
                      smoother=jsmoother, base=jbase, system=jsystem,
                      trans=jtrans, lower=jlower)
PORT = SimpleNamespace(problems=thelmholtz, cycles=tcycles, part=tpart,
                       smoother=tsmoother, base=tbase, system=tsystem,
                       trans=ttrans, lower=tlower)

#: an asymmetric complex stencil (center, up, down, left, right): a
#: swapped neighbour or a dropped imaginary part shows
ASYM = (5.0 - 0.7j, -1.5 + 0.1j, -0.5 - 0.3j, -1.25 + 0.05j, -0.75 + 0.2j)
#: the V(2,1) cycles of one step: (partitioning, smoother, omega); ``block``
#: is the 2 x 2 collective block Jacobi the grammar proposes
CYCLES = {"rb": ("RedBlack", "point", 0.6), "jacobi": ("Single", "point", 0.6),
          "block": ("Single", "block", 0.6)}
#: one lowered step, port against JAX in complex128 (relative to max|JAX|)
STEP_RTOL = 1e-10
#: the BiCGStab histories agree to HIST_RTOL while the residual stays above
#: HIST_FLOOR * ||b||.  Below it the recurrence amplifies rounding: on
#: helmholtz_2d(5, 3, k=20) reversing the summation order of the port's
#: own inner products moves the last entries by up to 45%, and the port
#: and the JAX package differ there by as much (while the iteration counts
#: agree)
HIST_RTOL, HIST_FLOOR = 1e-8, 1e-3
#: genGrow seeds of the "JAX lowers => the port lowers" probe
PROBE_SEEDS = range(40)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the eager ops on these grids run as fast on
    one, and the test run's parallel workers would otherwise oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# (a) the sweep kernels' plain versions against the Pallas entries
# ---------------------------------------------------------------------------

def _sweeps(mode):
    """(port wrapper, JAX Pallas entry) of a sweep mode."""
    if mode == "rb":
        return tcx.fused_rbgs_sweep_cx, jcx.fused_rbgs_sweep_cx
    return tcx.jacobi_sweep_cx, jcx.jacobi_sweep_cx


def _sweep_pair(mode, n, m, vals, omega, seeds):
    """The port's sweep on the CPU and the Pallas entry in interpret mode,
    on the same complex64 u and b."""
    u, b = (_random_cx(n, m, s) for s in seeds)
    port, pallas = _sweeps(mode)
    omegas = torch.tensor([0.9, omega], dtype=torch.float32)
    got = port(torch.from_numpy(np.array(u)), torch.from_numpy(np.array(b)),
               omegas, 1, vals)
    want = pallas(u, b, jnp.asarray(omega, jnp.float32), vals,
                  interpret=True)
    return got, np.asarray(want)


@pytest.mark.parametrize("n,m", [(257, 255), (129, 130), (96, 140),
                                 (300, 200)])
@pytest.mark.parametrize("mode,omega", [("rb", 0.6), ("jacobi", 0.8)])
def test_sweep_matches_pallas(mode, omega, n, m):
    """The wrapper's plain version on a CPU complex64 tensor against the
    Pallas entry with the JAX test's values (tests/test_pallas_cx.py:39-60,
    atol 5e-6); omega comes from the vector by index."""
    got, want = _sweep_pair(mode, n, m, VALS, omega, (1, 2))
    assert got.dtype == torch.complex64 and got.shape == (n, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-6)


@pytest.mark.parametrize("mode", ["rb", "jacobi"])
def test_sweep_asymmetric_stencil(mode):
    """An asymmetric complex stencil, so that a swapped neighbour or a
    conjugated coefficient shows (its effect is far above the slack)."""
    got, want = _sweep_pair(mode, 129, 130, ASYM, 0.8, (3, 4))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-6)
    swapped = (ASYM[0], ASYM[2], ASYM[1], ASYM[4], ASYM[3])
    wrong, _ = _sweep_pair(mode, 129, 130, swapped, 0.8, (3, 4))
    assert np.abs(wrong.numpy() - want).max() > 1e-2


def test_sweep_complex128_plain():
    """On the CPU the plain versions also take complex128, computed in
    complex128 (the JAX reference of tests/test_pallas_cx.py:20-30)."""
    n, m = 129, 130
    rng = np.random.default_rng(5)
    u = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    b = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    up = np.pad(u, 1)
    au = sum(v * up[1 + o0:1 + o0 + n, 1 + o1:1 + o1 + m] for v, (o0, o1)
             in zip(ASYM, [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]))
    want = u + 0.7 * (b - au) / ASYM[0]
    got = tcx.jacobi_sweep_cx(torch.from_numpy(u), torch.from_numpy(b),
                              torch.tensor([0.7], dtype=torch.float64), 0,
                              ASYM)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


def test_complex_five_point_values_match_jax():
    """tests/test_pallas_cx.py:63-74 in both packages."""
    cases = [
        [((0, 0), 4.0 - 2j), ((-1, 0), -1.0), ((1, 0), -1.0),
         ((0, -1), -1.0), ((0, 1), -1.0)],
        [((0, 0), 4.0), ((-1, 0), -1.0), ((1, 0), -1.0), ((0, -1), -1.0),
         ((0, 1), -1.0)],
        [((0, 0), 4.0 - 2j), ((1, 1), -1.0)],
        [((0, 0), 4.0 - 2j), ((-1, 0), -1.0 + 1j)],
    ]
    got = [tcx.complex_five_point_values(TStencil(c)) for c in cases]
    want = [jcx.complex_five_point_values(JStencil(c)) for c in cases]
    assert got == want
    assert got[0] == (4.0 - 2j, -1.0, -1.0, -1.0, -1.0)
    assert got[1] is None and got[2] is None
    assert got[3] == (4.0 - 2j, -1.0 + 1j, 0j, 0j, 0j)


@pytest.mark.parametrize("shape", [(65, 128), (64, 128), (257, 255),
                                   (65, 127), (2047, 2047), (8, 4096)])
def test_gate_matches_jax(shape):
    """The gate's level set is the JAX gate's (> 64 rows, >= 128 columns)
    on complex64; complex128 on the card and real fields are refused."""
    want = jcx.supports(jnp.zeros(shape, jnp.complex64), VALS)
    assert tcx.supports(torch.empty(shape, dtype=torch.complex64), VALS) \
        == want
    assert tcx.supports(torch.empty(shape, dtype=torch.complex64,
                                    device="meta"), VALS) == want
    assert not tcx.supports(torch.empty(shape, dtype=torch.complex64), None)
    assert not tcx.supports(torch.empty(shape, dtype=torch.complex128,
                                        device="meta"), VALS)
    assert not tcx.supports(torch.empty(shape, dtype=torch.float32), VALS)
    # the plain versions on the CPU take complex128 too
    assert tcx.supports(torch.empty(shape, dtype=torch.complex128), VALS) \
        == want


def test_wrappers_refuse_bad_arguments():
    u = torch.zeros((129, 130), dtype=torch.complex64)
    om = torch.tensor([0.6])
    with pytest.raises(ValueError):
        tcx.jacobi_sweep_cx(u, u[:-1], om, 0, VALS)
    with pytest.raises(ValueError):
        tcx.jacobi_sweep_cx(u, u, om.to(torch.complex64), 0, VALS)
    with pytest.raises(IndexError):
        tcx.fused_rbgs_sweep_cx(u, u, om, 1, VALS)
    with pytest.raises(ValueError):
        tcx.fused_rbgs_sweep_cx(u, u, om, 0, (0j,) + VALS[1:])
    with pytest.raises(ValueError):
        tcx.fused_rbgs_sweep_cx(u.to("meta"), u.to("meta"), om.to("meta"),
                                0, VALS)


def test_transfer_gate_refuses_complex():
    """A complex field takes the generic transfers on every device, as the
    JAX transfer gate (float32 / bfloat16) sends it."""
    assert ttransfer.supports(torch.empty((255, 255), dtype=torch.float64))
    for dtype in (torch.complex64, torch.complex128):
        assert not ttransfer.supports(torch.empty((255, 255), dtype=dtype))


# ---------------------------------------------------------------------------
# (b) the problem
# ---------------------------------------------------------------------------

def _v21(pkg, problem, key):
    partitioning, kind, omega = CYCLES[key]
    factory = pkg.smoother.generate_collective_jacobi if kind == "point" \
        else (lambda op: pkg.smoother.generate_collective_block_jacobi(
            op, [(2, 2)]))
    return pkg.cycles.v_cycle(
        problem.level_contexts, problem.rhs_entity, pre_smoothing=2,
        post_smoothing=1, omega=omega,
        partitioning=getattr(pkg.part, partitioning),
        smoother_factory=factory, coarse_operator=problem.coarsest_operator)


def test_problem_matches_jax():
    """helmholtz_2d(5, 3, k=20) in both packages: the same settings, the
    same V(2,1) IR node for node, the same right-hand side, and every
    level's Robin-folded StencilField and its dense matrix bit for bit."""
    pj = jhelmholtz.helmholtz_2d(5, 3, k=20.0)
    pt = thelmholtz.helmholtz_2d(5, 3, k=20.0)
    assert (pt.name, pt.fields, pt.max_level, pt.min_level, pt.dtype,
            pt.target_reduction, pt.max_iterations) == \
        (pj.name, pj.fields, pj.max_level, pj.min_level, pj.dtype,
         pj.target_reduction, pj.max_iterations)
    oj, ot = pj.outer_solver, pt.outer_solver
    assert (ot.name, ot.tolerance, ot.max_iterations, ot.split) == \
        (oj.name, oj.tolerance, oj.max_iterations, oj.split)
    for key in CYCLES:
        dj, dt = _describe(JAX, _v21(JAX, pj, key)), \
            _describe(PORT, _v21(PORT, pt, key))
        assert dt == dj and len(dt) > 20
    b = build_rhs(pt, dtype=torch.float64, device="cpu")
    assert b[0].dtype == torch.complex128
    np.testing.assert_array_equal(b[0].numpy(),
                                  np.asarray(pj.build_rhs()[0]))
    assert build_rhs(pt, dtype=torch.float32, device="cpu")[0].dtype == \
        torch.complex64
    ops = [(c.operator, c.grid[0]) for c in pt.level_contexts]
    ops_j = [c.operator for c in pj.level_contexts]
    ops.append((pt.coarsest_operator, pt.coarsest_operator.entries[0][0]
                .grid))
    ops_j.append(pj.coarsest_operator)
    ops.append((ot.operator, pt.finest_grid[0]))
    ops_j.append(oj.operator)
    for (op_t, grid), op_j in zip(ops, ops_j):
        sf_t = op_t.entries[0][0].stencil_generator.generate_stencil_field(
            grid)
        sf_j = op_j.entries[0][0].stencil_generator.generate_stencil_field(
            grid)
        assert sf_t.offsets == sf_j.offsets
        for ft, fj in zip(sf_t.fields, sf_j.fields):
            assert ft.dtype == np.complex128
            np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(sf_t.dense_matrix(),
                                      sf_j.dense_matrix())


def test_robin_folding_matches_ghost_elimination():
    """tests/test_helmholtz.py:19-37 on the port: the dense field-operator
    matrix equals the manual elimination of u_b = u_1 / (1 - i k h)."""
    from evostencils_tpu_torch.grids import unit_interval_grid
    g = unit_interval_grid(2, 3)
    gen = thelmholtz.HelmholtzOperatorGenerator(10.0, 0.0)
    M = gen.generate_stencil_field(g).dense_matrix()
    st = gen.generate_stencil(g)
    M0 = tapply.dense_matrix(st, g).astype(complex)
    alpha = 1.0 / (1.0 - 1j * 10.0 * g.spacing[0])
    n = g.size[0]
    west, east = st.value_at((-1, 0)), st.value_at((1, 0))
    for j in range(n):
        r0 = np.ravel_multi_index((0, j), g.size)
        M0[r0, r0] += west * alpha
        r1 = np.ravel_multi_index((n - 1, j), g.size)
        M0[r1, r1] += east * alpha
    np.testing.assert_allclose(M, M0, rtol=1e-13)


def test_stencil_field_apply_matches_dense_matrix():
    """The Robin-folded operator applied to a real float32 field gives a
    complex64 result equal to its dense matrix's product; a complex128
    field stays complex128."""
    from evostencils_tpu_torch.grids import unit_interval_grid
    g = unit_interval_grid(2, 4)
    sf = thelmholtz.HelmholtzOperatorGenerator(20.0, 0.5j) \
        .generate_stencil_field(g)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(g.size)
    want = (sf.dense_matrix() @ x.reshape(-1)).reshape(g.size)
    out = sf.apply(torch.tensor(x, dtype=torch.float32))
    assert out.dtype == torch.complex64
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    out = sf.apply(torch.tensor(x + 0j, dtype=torch.complex128))
    assert out.dtype == torch.complex128
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-13, atol=0)


# ---------------------------------------------------------------------------
# (c) one step, the outer solve and the evaluator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def helm():
    """Both packages' helmholtz_2d(5, 3, k=20), the port's b and each
    cycle lowered in both packages."""
    pj = jhelmholtz.helmholtz_2d(5, 3, k=20.0)
    pt = thelmholtz.helmholtz_2d(5, 3, k=20.0)
    lowered = {key: (jlower.lower_cycle(_v21(JAX, pj, key), pj.approximation,
                                        pj.rhs_entity),
                     tlower.lower_cycle(_v21(PORT, pt, key),
                                        pt.approximation, pt.rhs_entity))
               for key in CYCLES}
    return SimpleNamespace(pj=pj, pt=pt, bj=pj.build_rhs(),
                           bt=build_rhs(pt, dtype=torch.float64,
                                        device="cpu"), lowered=lowered)


@pytest.mark.parametrize("key", list(CYCLES))
def test_step_matches_jax(helm, key):
    """One lowered step of the V(2,1) from zero, complex128, within
    STEP_RTOL of max|JAX|; the block smoother runs complex block solves."""
    lj, lt = helm.lowered[key]
    uj = lj.step(tuple(jnp.zeros_like(x) for x in helm.bj), helm.bj,
                 jnp.asarray(lj.default_omegas))
    ut = lt.step(tuple(torch.zeros_like(x) for x in helm.bt), helm.bt,
                 torch.tensor(lt.default_omegas))
    want = np.asarray(uj[0])
    assert ut[0].dtype == torch.complex128
    assert np.abs(want.imag).max() > 0.1 * np.abs(want).max()
    np.testing.assert_allclose(ut[0].numpy(), want, rtol=0,
                               atol=STEP_RTOL * np.abs(want).max())


def _bicgstab(helm, key, maxiter=500):
    """Both packages' preconditioned BiCGStab on the true operator, one
    application of the cycle from zero as the preconditioner
    (tests/test_helmholtz.py:52-70)."""
    lj, lt = helm.lowered[key]
    omj, omt = jnp.asarray(lj.default_omegas), torch.tensor(
        lt.default_omegas)
    _, kj, hj = jsolvers.preconditioned_bicgstab(
        jlower.operator_applier(helm.pj.outer_solver.operator),
        lambda f: lj.step(tuple(jnp.zeros_like(x) for x in f), f, omj),
        helm.bj, tol=1e-7, maxiter=maxiter, history_size=maxiter)
    _, kt, ht = tsolvers.preconditioned_bicgstab(
        tlower.operator_applier(helm.pt.outer_solver.operator),
        lambda f: lt.step(tuple(torch.zeros_like(x) for x in f), f, omt),
        helm.bt, tol=1e-7, maxiter=maxiter, history_size=maxiter)
    return int(kj), np.asarray(hj), kt, ht.numpy()


@pytest.mark.parametrize("key", ["rb", "jacobi"])
def test_bicgstab_matches_jax(helm, key):
    """Equal iteration counts; histories within HIST_RTOL while the
    residual stays above HIST_FLOOR ||b||; both end below 1e-7 ||b||; the
    history keeps maxiter + 1 slots with the unused ones 0."""
    kj, hj, kt, ht = _bicgstab(helm, key)
    assert kt == kj and 5 < kt < 100
    assert ht.shape == hj.shape == (501,)
    assert np.all(ht[kt + 1:] == 0) and np.all(ht[:kt + 1] > 0)
    above = hj[:kt + 1] > HIST_FLOOR * hj[0]
    assert above.sum() >= 10
    np.testing.assert_allclose(ht[:kt + 1][above], hj[:kt + 1][above],
                               rtol=HIST_RTOL, atol=0)
    assert ht[kt] <= 1e-7 * ht[0] and hj[kj] <= 1e-7 * hj[0]


def test_bicgstab_identity_preconditioner_is_slower(helm):
    """tests/test_helmholtz.py:80-89: the cycle preconditions."""
    kt = _bicgstab(helm, "rb")[2]
    _, k_plain, _ = tsolvers.preconditioned_bicgstab(
        tlower.operator_applier(helm.pt.outer_solver.operator),
        lambda f: f, helm.bt, tol=1e-7, maxiter=2000)
    assert kt < k_plain / 2


@pytest.mark.parametrize("graph", [True, False])
def test_preconditioner_is_the_step_from_zero(helm, graph):
    """On the CPU ``make_preconditioner`` runs the step eagerly, whatever
    ``graph`` asks (the CUDA graph is captured only on the card): one
    application of the cycle from zero, bitwise, leaving its argument
    untouched."""
    _, lt = helm.lowered["rb"]
    om = torch.tensor(lt.default_omegas)
    precond = tsolve.make_preconditioner(lt, om, helm.bt, graph)
    fields = tuple(x.clone() for x in helm.bt)
    want = lt.step(tuple(torch.zeros_like(x) for x in fields), fields, om)
    got = precond(fields)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(f, b) for f, b in zip(fields, helm.bt))


def test_evaluator_outer_solver(helm):
    """The evaluator solves with the outer BiCGStab: its iterations and rho
    are the port's own BiCGStab's exactly, its iterations the JAX
    evaluator's; rho agrees with JAX's as far as the last history entry
    can (HIST_FLOOR)."""
    cycle_t, cycle_j = _v21(PORT, helm.pt, "rb"), _v21(JAX, helm.pj, "rb")
    et = tev.CycleEvaluator(helm.pt, device="cpu", max_iterations=500)
    ej = jev.CycleEvaluator(helm.pj, max_iterations=500)
    et.timing_enabled = ej.timing_enabled = False
    assert et._b[0].dtype == torch.complex128
    assert et._omegas([0.6]).dtype == torch.float64
    assert et.measurement_reduction == ej.measurement_reduction == 1e-7
    rt, rj = et.evaluate_expression(cycle_t), ej.evaluate_expression(cycle_j)
    kj, _, kt, ht = _bicgstab(helm, "rb")
    assert rt.iterations == rj.iterations == kt == kj
    assert rt.convergence_factor == (ht[kt] / ht[0]) ** (1.0 / kt)
    assert abs(np.log(rt.convergence_factor / rj.convergence_factor)) <= \
        np.log(10.0) / kt
    assert 0 < rt.convergence_factor < 1


def test_evaluator_float32_is_complex64():
    """float32 asked for the complex problem gives complex64 fields, real
    float32 relaxation factors and the JAX evaluator's measurement window
    for the same request (evaluator.py:70-77)."""
    pt = thelmholtz.helmholtz_2d(4, 3, k=20.0)
    pj = jhelmholtz.helmholtz_2d(4, 3, k=20.0)
    et = tev.CycleEvaluator(pt, dtype=np.float32, device="cpu")
    ej = jev.CycleEvaluator(pj, dtype=np.float32)
    assert et._b[0].dtype == torch.complex64
    assert ej._b[0].dtype == jnp.complex64
    assert et._omegas([0.6, 1.0]).dtype == torch.float32
    assert et.dtype is np.float32
    assert et.measurement_reduction == ej.measurement_reduction
    et.timing_enabled = False
    res = et.evaluate_expression(_v21(PORT, pt, "rb"))
    assert 0 < res.convergence_factor < 1


def test_split_outer_solver_refused():
    """The split-complex outer solver is no longer refused: the evaluator
    solves helmholtz_2d_split(4, 3) with the split BiCGStab on real (re,
    im) fields, in as many iterations as helmholtz_2d(4, 3) takes with
    the complex one (the same algebra)."""
    split = thelmholtz.helmholtz_2d_split(4, 3)
    et = tev.CycleEvaluator(split, dtype=np.float64, device="cpu")
    ec = tev.CycleEvaluator(thelmholtz.helmholtz_2d(4, 3), device="cpu")
    et.timing_enabled = ec.timing_enabled = False
    assert [x.dtype for x in et._b] == [torch.float64] * 2
    rs = et.evaluate_expression(_v21(PORT, split, "rb"))
    rc = ec.evaluate_expression(_v21(PORT, ec.problem, "rb"))
    assert rs.iterations == rc.iterations and 0 < rs.convergence_factor < 1


def test_real_fields_keep_real_omegas():
    """Real fields compute what they did: measure_solve's default
    relaxation factors and the evaluator's keep the fields' dtype."""
    problem = poisson_2d(max_level=5, min_level=3)
    ev = tev.CycleEvaluator(problem, dtype=np.float32, device="cpu")
    assert ev._b[0].dtype == ev._omegas([1.15]).dtype == torch.float32
    assert ev.dtype is np.float32 and ev.measurement_reduction == 1e-5
    cycle = tcycles.v_cycle(problem.level_contexts, problem.rhs_entity,
                            coarse_operator=problem.coarsest_operator)
    lowered = tlower.lower_cycle(cycle, problem.approximation,
                                 problem.rhs_entity)
    b = build_rhs(problem, dtype=torch.float64, device="cpu")
    res = tsolve.measure_solve(lowered, b, max_iterations=30, samples=1)
    assert res.solution[0].dtype == torch.float64 and res.converged


# ---------------------------------------------------------------------------
# (d) the kernels' path: the Dirichlet shifted-Laplace hierarchy
# ---------------------------------------------------------------------------

def _count_port(mp, counts):
    for name in ("fused_rbgs_sweep_cx", "jacobi_sweep_cx"):
        def counted(*a, _fn=getattr(tcx, name), _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)
        mp.setattr(tcx, name, counted)


def _count_jax(mp, counts):
    for name in ("fused_rbgs_sweep_cx", "jacobi_sweep_cx"):
        def counted(*a, _fn=getattr(jcx, name), _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)
        mp.setattr(jcx, name, counted)


def _steps_jax(problem, steps, pallas):
    from evostencils_tpu import config as jconfig
    cycle = _v21(JAX, problem, "rb")
    low = jlower.lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    b = problem.build_rhs()
    u = tuple(jnp.zeros_like(x) for x in b)
    om = jnp.asarray(low.default_omegas, jnp.float32)
    old = jconfig.config.use_pallas_kernels
    jconfig.config.use_pallas_kernels = pallas
    try:
        for _ in range(steps):
            u = low.step(u, b, om)
    finally:
        jconfig.config.use_pallas_kernels = old
    return np.asarray(u[0])


def test_dirichlet_hierarchy_matches_jax():
    """The Dirichlet hierarchy (8, 5) in complex64: the same IR as the JAX
    test's, and 3 steps of the RB V(2,1) with the plain versions against
    the JAX package with its Pallas entries in interpret mode within
    2e-4 max|ref| (tests/test_pallas_cx.py:77-107, :144-150); each step
    reaches the port's fused RB sweep exactly as often as the JAX
    lowering reaches its Pallas entry (3 sweeps on 255^2; 127^2 has too
    few columns for the gate)."""
    pj = _dirichlet_helmholtz(8, 5)
    pj.dtype = np.float32
    pt = dirichlet_helmholtz(8, 5)
    assert _describe(PORT, _v21(PORT, pt, "rb")) == \
        _describe(JAX, _v21(JAX, pj, "rb"))
    lt = tlower.lower_cycle(_v21(PORT, pt, "rb"), pt.approximation,
                            pt.rhs_entity)
    b = build_rhs(pt, dtype=torch.float32, device="cpu")
    assert b[0].dtype == torch.complex64
    u = tuple(torch.zeros_like(x) for x in b)
    om = torch.tensor(lt.default_omegas, dtype=torch.float32)
    counts_t, counts_j = collections.Counter(), collections.Counter()
    with pytest.MonkeyPatch.context() as mp:
        _count_port(mp, counts_t)
        _count_jax(mp, counts_j)
        for _ in range(3):
            u = lt.step(u, b, om)
        want = _steps_jax(pj, 3, True)
    assert dict(counts_t) == dict(counts_j) == {"fused_rbgs_sweep_cx": 9}
    assert u[0].dtype == torch.complex64
    np.testing.assert_allclose(u[0].numpy(), want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("key", ["rb", "jacobi"])
def test_dirichlet_kernels_against_generic(key):
    """On the Dirichlet hierarchy (8, 5) in complex64, one step through the
    sweep wrappers equals the generic lowering's masked half-sweeps (the
    gate shut) to float32 rounding; each V(2,1) reaches its sweep 3 times
    a step, on 255^2."""
    pt = dirichlet_helmholtz(8, 5)
    b = build_rhs(pt, dtype=torch.float32, device="cpu")
    u0 = tuple(torch.zeros_like(x) for x in b)
    lt = tlower.lower_cycle(_v21(PORT, pt, key), pt.approximation,
                            pt.rhs_entity)
    om = torch.tensor(lt.default_omegas, dtype=torch.float32)
    counts = collections.Counter()
    with pytest.MonkeyPatch.context() as mp:
        _count_port(mp, counts)
        got = lt.step(u0, b, om)[0]
    name = "fused_rbgs_sweep_cx" if key == "rb" else "jacobi_sweep_cx"
    assert dict(counts) == {name: 3}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcx, "supports", lambda u, vals: False)
        ref = lt.step(u0, b, om)[0]
    assert float((got - ref).abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=2e-5 * float(ref.abs().max()))


def test_robin_problem_reaches_no_cx_entry():
    """At helmholtz_2d(7, 3) in complex64 the Robin operator's field form
    keeps both packages off their complex sweep entries
    (tests/test_pallas_cx.py:153-164); the JAX step is traced with
    jax.eval_shape, which runs the lowering's Python."""
    from evostencils_tpu import config as jconfig
    pt = thelmholtz.helmholtz_2d(7, 3)
    pj = jhelmholtz.helmholtz_2d(7, 3)
    counts_t, counts_j = collections.Counter(), collections.Counter()
    with pytest.MonkeyPatch.context() as mp:
        _count_port(mp, counts_t)
        _count_jax(mp, counts_j)
        mp.setattr(jconfig.config, "use_pallas_kernels", True)
        lt = tlower.lower_cycle(_v21(PORT, pt, "rb"), pt.approximation,
                                pt.rhs_entity)
        b = build_rhs(pt, dtype=torch.float32, device="cpu")
        out = lt.step(tuple(torch.zeros_like(x) for x in b), b,
                      torch.tensor(lt.default_omegas, dtype=torch.float32))
        lj = jlower.lower_cycle(_v21(JAX, pj, "rb"), pj.approximation,
                                pj.rhs_entity)
        spec = (jax.ShapeDtypeStruct((127, 127), jnp.complex64),)
        jax.eval_shape(lj.step, spec, spec, jax.ShapeDtypeStruct(
            lj.default_omegas.shape, jnp.float32))
    assert out[0].dtype == torch.complex64
    assert not counts_t and not counts_j


# ---------------------------------------------------------------------------
# (e) JAX lowers => the port lowers
# ---------------------------------------------------------------------------

_PROBE = {}


def _probe_setup():
    if not _PROBE:
        pj = jhelmholtz.helmholtz_2d(5, 3)
        pt = thelmholtz.helmholtz_2d(5, 3)
        _PROBE.update(pj=pj, pt=pt, psj=_pset(jmg, pj), pst=_pset(tmg, pt),
                      b=build_rhs(pt, dtype=torch.float64, device="cpu"))
    return SimpleNamespace(**_PROBE)


def _pset(mg, problem):
    return mg.generate_primitive_set(problem.approximation,
                                     problem.rhs_entity,
                                     problem.level_contexts,
                                     problem.coarsest_operator)[0]


@pytest.mark.parametrize("seed", PROBE_SEEDS)
def test_jax_lowers_implies_port_lowers(seed):
    """genGrow(pset, 2, 40) seeds 0-39 on helmholtz_2d(5, 3): where the JAX
    package lowers an individual and traces a complex128 step
    (jax.eval_shape), the port lowers it and takes one complex128 step of
    the same shape."""
    s = _probe_setup()
    ij = jgp.genGrow(s.psj, 2, 40, rng=random.Random(seed))
    it = tgp.genGrow(s.pst, 2, 40, rng=random.Random(seed))
    assert str(it) == str(ij)
    try:
        lj = jlower.lower_cycle(jgp.compile_tree(ij, s.psj)[0],
                                s.pj.approximation, s.pj.rhs_entity)
        spec = (jax.ShapeDtypeStruct((31, 31), jnp.complex128),)
        jax.eval_shape(lj.step, spec, spec, jax.ShapeDtypeStruct(
            lj.default_omegas.shape, jnp.float64))
    except NotImplementedError:
        pytest.fail(f"the JAX package does not lower seed {seed}; the probe "
                    "expects every one of its individuals to lower")
    lt = tlower.lower_cycle(tgp.compile_tree(it, s.pst)[0],
                            s.pt.approximation, s.pt.rhs_entity)
    out = lt.step(tuple(torch.zeros_like(x) for x in s.b), s.b,
                  torch.tensor(lt.default_omegas))
    assert [tuple(o.shape) for o in out] == [(31, 31)]
    assert out[0].dtype == torch.complex128


# ---------------------------------------------------------------------------
# (f) the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("robust", [True, False])
def test_cli_helmholtz2d(tmp_path, capsys, monkeypatch, robust):
    """``python -m evostencils_tpu_torch.optimize helmholtz2d --cpu`` at
    levels 4 -> 3 ends with a best individual, with the 2k and 4k
    robustness variants (scripts/optimize.py:124-142) or, with
    ``--no-robustness``, without them."""
    monkeypatch.setattr(tev.CycleEvaluator, "timing_enabled", False)
    seen = {}
    init = tprogram.Optimizer.__init__

    def recording(self, problem, **kw):
        seen["variants"] = kw.get("robustness_problems")
        seen["factories"] = kw.get("robustness_factories")
        init(self, problem, **kw)

    monkeypatch.setattr(tprogram.Optimizer, "__init__", recording)
    argv = ["helmholtz2d", "--cpu", "--max-level", "4", "--min-level", "3",
            "--mu", "2", "--lambda", "2", "--generations", "1", "--seed",
            "0", "--output", str(tmp_path)]
    result = toptimize.main(argv + ([] if robust else ["--no-robustness"]))
    best = (tmp_path / "best_grammar.txt").read_text().strip()
    assert best == result["grammar_string"]
    assert "Best individual:" in capsys.readouterr().out
    if not robust:
        assert not seen["variants"] and seen["factories"] is None
        return
    ks = [v.outer_solver.operator.entries[0][0].stencil_generator.k
          for v in seen["variants"]]
    assert ks == [160.0, 320.0]
    assert all((v.max_level, v.min_level) == (4, 3)
               for v in seen["variants"])
    grown = [f(3, 5) for f in seen["factories"]]
    assert [(g.max_level, g.min_level) for g in grown] == [(5, 3)] * 2


def test_cli_helmholtz2d_defaults():
    """helmholtz2d's default levels are scripts/optimize.py's: 7 -> 3, and
    so are the split-complex problem's, which no longer waits for a
    later slice."""
    assert not hasattr(toptimize, "LATER_SLICES")
    problem = toptimize.get_problem("helmholtz2d")
    assert (problem.max_level, problem.min_level) == (7, 3)
    assert problem.finest_grid[0].size == (127, 127)
    split = toptimize.get_problem("helmholtz2d_split")
    assert (split.max_level, split.min_level) == (7, 3)
    assert split.outer_solver.split and len(split.finest_grid) == 2
