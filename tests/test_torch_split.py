"""The port's split-complex Helmholtz path against the JAX package on the
CPU: ``helmholtz_2d_split`` (the problem, its operators and right-hand
side), one lowered step with the varying collective point solve
(``_pointwise_varying_inverse``), the split BiCGStab, the system kernels'
tables and fixup rows (``_sys_entry_nine``) and the levels where each
package reaches them, the evaluator with the split outer solver, "JAX
lowers => the port lowers" on seeded individuals and on the stored
``helmholtz_split_k80_*`` champions, and the ``helmholtz2d_split`` CLI.

Every comparison runs in float64, where the port's system kernels run
their plain versions; the JAX package runs XLA there (its Pallas gates take
float32 only).  The levels each package's kernels would take are compared
in float32, the JAX step traced with ``jax.eval_shape``.
"""

import collections
import json
import pathlib
import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu import config as jconfig
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
from evostencils_tpu.ops.pallas import rbgs_sys as jrs
from evostencils_tpu.problems import helmholtz as jhelmholtz
from evostencils_tpu.stencils import gallery as jgallery
from evostencils_tpu_torch import optimize as toptimize
from evostencils_tpu_torch.compiler import cycles as tcycles
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.evaluation import evaluator as tev
from evostencils_tpu_torch.grammar import gp as tgp
from evostencils_tpu_torch.grammar import multigrid as tmg
from evostencils_tpu_torch.ir import base as tbase
from evostencils_tpu_torch.ir import partitioning as tpart
from evostencils_tpu_torch.ir import smoother as tsmoother
from evostencils_tpu_torch.ir import system as tsystem
from evostencils_tpu_torch.ir import transformations as ttrans
from evostencils_tpu_torch.ops import solvers as tsolvers
from evostencils_tpu_torch.ops.kernels import rbgs_sys as trs
from evostencils_tpu_torch.problems import helmholtz as thelmholtz
from evostencils_tpu_torch.problems.poisson import build_rhs
from evostencils_tpu_torch.stencils import gallery as tgallery

from tests.test_torch_slice3d import _describe

JAX = SimpleNamespace(problems=jhelmholtz, cycles=jcycles, part=jpart,
                      smoother=jsmoother, base=jbase, system=jsystem,
                      trans=jtrans, lower=jlower)
PORT = SimpleNamespace(problems=thelmholtz, cycles=tcycles, part=tpart,
                       smoother=tsmoother, base=tbase, system=tsystem,
                       trans=ttrans, lower=tlower)

#: the JAX test's fixture (tests/test_split_complex.py:28-29) and a
#: hierarchy whose finest level the system legs take (255^2, k = 80)
SMALL = ((5, 3), 20.0)
WIDE = ((8, 3), 80.0)
#: one lowered step, port against JAX, relative to max|JAX|
STEP_RTOL = 1e-12
#: the split BiCGStab's histories agree to HIST_RTOL while the residual
#: stays above HIST_FLOOR * ||b||; below it the recurrence amplifies
#: rounding (tests/test_torch_helmholtz.py:79-85)
HIST_RTOL, HIST_FLOOR = 1e-8, 1e-3
#: the V(2,1) cycles of one step: (partitioning, omega)
CYCLES = {"rb": ("RedBlack", 0.6), "jacobi": ("Single", 0.6)}
PROBE_SEEDS = range(40)
CHAMPIONS = pathlib.Path(__file__).resolve().parents[1] / "results" / \
    "evolved_champions.json"
CHAMPION_KEYS = ("helmholtz_split_k80_biobj_gen25",
                 "helmholtz_split_k80_robust_gen20")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run's parallel workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problems(levels, k):
    return (jhelmholtz.helmholtz_2d_split(*levels, k=k),
            thelmholtz.helmholtz_2d_split(*levels, k=k))


def _v21(pkg, problem, key):
    partitioning, omega = CYCLES[key]
    return pkg.cycles.v_cycle(
        problem.level_contexts, problem.rhs_entity, pre_smoothing=2,
        post_smoothing=1, omega=omega,
        partitioning=getattr(pkg.part, partitioning),
        smoother_factory=pkg.smoother.generate_collective_jacobi,
        coarse_operator=problem.coarsest_operator)


def _pset(mg, problem):
    """The primitive set the optimizer builds for the problem
    (program.py:518-524): coupled (re, im) fields."""
    return mg.generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator, coupled_fields=problem.coupled_fields)[0]


def bicgstab_iterations(package, form, k, levels=(7, 3)):
    """Iterations of the outer BiCGStab to 1e-7 of helmholtz_2d (``form``
    "complex") or helmholtz_2d_split ("split") at ``levels`` and
    wavenumber ``k``, one collective red-black V(2,1) (omega 0.6) from
    zero a preconditioner application, in float64 on the CPU, by the JAX
    package (``package`` "jax") or the port ("port")."""
    pkg = JAX if package == "jax" else PORT
    make = pkg.problems.helmholtz_2d_split if form == "split" \
        else pkg.problems.helmholtz_2d
    problem = make(*levels, k=k)
    cycle = pkg.cycles.v_cycle(
        problem.level_contexts, problem.rhs_entity, pre_smoothing=2,
        post_smoothing=1, omega=0.6, partitioning=pkg.part.RedBlack,
        smoother_factory=pkg.smoother.generate_collective_jacobi,
        coarse_operator=problem.coarsest_operator)
    low = pkg.lower.lower_cycle(cycle, problem.approximation,
                                problem.rhs_entity)
    matvec = pkg.lower.operator_applier(problem.outer_solver.operator)
    if package == "jax":
        with jax.enable_x64(True):
            b = problem.rhs_builder(np.float64) if form == "split" \
                else problem.build_rhs()
            om = jnp.asarray(low.default_omegas)
            solver = jsolvers.preconditioned_bicgstab_split \
                if form == "split" else jsolvers.preconditioned_bicgstab
            run = jax.jit(lambda b: solver(
                matvec, lambda f: low.step(
                    tuple(jnp.zeros_like(x) for x in f), f, om), b,
                tol=1e-7, maxiter=10000))
            return int(run(b)[1])
    b = build_rhs(problem, dtype=torch.float64, device="cpu")
    om = torch.tensor(low.default_omegas)
    solver = tsolvers.preconditioned_bicgstab_split if form == "split" \
        else tsolvers.preconditioned_bicgstab
    return solver(matvec, lambda f: low.step(
        tuple(torch.zeros_like(x) for x in f), f, om), b, tol=1e-7,
        maxiter=10000)[1]


def evolve_evaluations(package, seed, budget, levels=(7, 3)):
    """Every evaluation of ``optimize helmholtz2d_split NSGAII --mu 2
    --lambda 2 --generations 1 --seed <seed> --no-robustness --f32
    --cpu`` at ``levels`` (max, min), by the JAX package's
    scripts/optimize.py (``package`` "jax") or the port's CLI ("port"),
    with the evaluator's timing protocol off and the iteration budget
    cut to ``budget``: a list of (tree, iterations, convergence factor)
    in evaluation order.  chip_smoke.EVOLVE_SPLIT_SEED comes from these:
    ``JAX_PLATFORMS=cpu python -c 'from tests.test_torch_split import
    evolve_evaluations as f; print(f("jax", 4, 300))'``."""
    import importlib.util
    import sys
    import tempfile
    evaluator = jev.CycleEvaluator if package == "jax" \
        else tev.CycleEvaluator
    population = evaluator.evaluate_population
    out = []

    def logged(self, individuals, pset):
        results = population(self, individuals, pset)
        out.extend((str(i), float(r.iterations), float(r.convergence_factor))
                   for i, r in zip(individuals, results))
        return results

    if package == "jax":
        path = pathlib.Path(__file__).parents[1] / "scripts" / "optimize.py"
        spec = importlib.util.spec_from_file_location("_jax_optimize", path)
        cli = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cli)
    else:
        cli = toptimize
    get_problem = cli.get_problem

    def budgeted(*args, **kw):
        problem = get_problem(*args, **kw)
        problem.max_iterations = budget
        return problem

    with tempfile.TemporaryDirectory() as tmp, \
            pytest.MonkeyPatch.context() as mp:
        argv = ["helmholtz2d_split", "NSGAII", "--mu", "2", "--lambda", "2",
                "--generations", "1", "--seed", str(seed),
                "--no-robustness", "--f32", "--cpu", "--output", tmp,
                "--max-level", str(levels[0]),
                "--min-level", str(levels[1])]
        mp.setattr(evaluator, "evaluate_population", logged)
        mp.setattr(evaluator, "timing_enabled", False)
        mp.setattr(cli, "get_problem", budgeted)
        if package == "jax":
            mp.setattr(sys, "argv", ["optimize.py", *argv])
            cli.main()
        else:
            cli.main(argv)
    return out


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(2)]


# ---------------------------------------------------------------------------
# (a) the problem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels,k", [SMALL, WIDE])
def test_problem_matches_jax(levels, k):
    """The same settings and outer solver, the same V(2,1) IR node for node,
    the right-hand side bit for bit in float64 (float32 fields in float32),
    and every level's four StencilFields bit for bit."""
    pj, pt = _problems(levels, k)
    assert (pt.name, pt.fields, pt.max_level, pt.min_level, pt.dtype,
            pt.target_reduction, pt.max_iterations, pt.coupled_fields) == \
        (pj.name, pj.fields, pj.max_level, pj.min_level, pj.dtype,
         pj.target_reduction, pj.max_iterations, pj.coupled_fields)
    oj, ot = pj.outer_solver, pt.outer_solver
    assert (ot.name, ot.tolerance, ot.max_iterations, ot.split) == \
        (oj.name, oj.tolerance, oj.max_iterations, oj.split) and ot.split
    for key in CYCLES:
        dj, dt = _describe(JAX, _v21(JAX, pj, key)), \
            _describe(PORT, _v21(PORT, pt, key))
        assert dt == dj and len(dt) > 40
    b = build_rhs(pt, dtype=torch.float64, device="cpu")
    want = pj.rhs_builder(np.float64)
    assert len(b) == 2 and all(x.dtype == torch.float64 for x in b)
    for x, y in zip(b, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert [x.dtype for x in build_rhs(pt, dtype=torch.float32,
                                       device="cpu")] == [torch.float32] * 2
    ops_t = [c.operator for c in pt.level_contexts] + \
        [pt.coarsest_operator, ot.operator]
    ops_j = [c.operator for c in pj.level_contexts] + \
        [pj.coarsest_operator, oj.operator]
    for op_t, op_j in zip(ops_t, ops_j):
        for row_t, row_j in zip(op_t.entries, op_j.entries):
            for e_t, e_j in zip(row_t, row_j):
                assert e_t.name == e_j.name
                sf_t = e_t.stencil_generator.generate_stencil_field(e_t.grid)
                sf_j = e_j.stencil_generator.generate_stencil_field(e_j.grid)
                assert sf_t.offsets == sf_j.offsets
                for ft, fj in zip(sf_t.fields, sf_j.fields):
                    assert ft.dtype == np.float64
                    np.testing.assert_array_equal(ft, np.asarray(fj))
                assert e_t.generate_stencil().entries == \
                    e_j.generate_stencil().entries


@pytest.mark.parametrize("which", ["level", "outer"])
def test_operator_matches_jax_and_complex(which):
    """The split level operator M and the outer operator A on a random
    (re, im) pair: the JAX package's within 1e-12 relative, and the port's
    own complex operator on re + i im within 1e-12."""
    pj, pt = _problems(*SMALL)
    pc = thelmholtz.helmholtz_2d(*SMALL[0], k=SMALL[1])
    pick = {"level": lambda p: p.level_contexts[0].operator,
            "outer": lambda p: p.outer_solver.operator}[which]
    x = _fields(tuple(pt.finest_grid[0].size), 3)
    got = tlower.operator_applier(pick(pt))(
        tuple(torch.from_numpy(a) for a in x))
    want = jlower.operator_applier(pick(pj))(
        tuple(jnp.asarray(a) for a in x))
    (zc,) = tlower.operator_applier(pick(pc))(
        (torch.from_numpy(x[0] + 1j * x[1]),))
    scale = float(np.abs(zc.numpy()).max())
    for g, w, c in zip(got, want, (zc.real, zc.imag)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=STEP_RTOL * scale)
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=0,
                                   atol=STEP_RTOL * scale)


# ---------------------------------------------------------------------------
# (b) one step, the varying point solve and the system tables
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lowered():
    """Both packages' problems, b and each cycle lowered in both, at both
    hierarchies."""
    out = {}
    for levels, k in (SMALL, WIDE):
        pj, pt = _problems(levels, k)
        out[levels] = SimpleNamespace(
            pj=pj, pt=pt, bj=pj.rhs_builder(np.float64),
            bt=build_rhs(pt, dtype=torch.float64, device="cpu"),
            cycles={key: (jlower.lower_cycle(_v21(JAX, pj, key),
                                             pj.approximation, pj.rhs_entity),
                          tlower.lower_cycle(_v21(PORT, pt, key),
                                             pt.approximation, pt.rhs_entity))
                    for key in CYCLES})
    return out


@pytest.mark.parametrize("levels", [SMALL[0], WIDE[0]])
@pytest.mark.parametrize("key", list(CYCLES))
def test_step_matches_jax(lowered, levels, key):
    """One step of the collective V(2,1) from zero in float64 within
    STEP_RTOL of max|JAX| on both fields; every level below the legs'
    gate runs the varying point solve, which the step must reach."""
    s = lowered[levels]
    lj, lt = s.cycles[key]
    uj = lj.step(tuple(jnp.zeros_like(x) for x in s.bj), s.bj,
                 jnp.asarray(lj.default_omegas))
    sizes = collections.Counter()
    varying = tlower._Lowering._pointwise_varying_inverse
    with pytest.MonkeyPatch.context() as mp:
        def counted(self, op, fields):
            sizes[fields[0].shape[0]] += 1
            return varying(self, op, fields)
        mp.setattr(tlower._Lowering, "_pointwise_varying_inverse", counted)
        ut = lt.step(tuple(torch.zeros_like(x) for x in s.bt), s.bt,
                     torch.tensor(lt.default_omegas))
    assert set(sizes) == ({31, 15} if levels == SMALL[0]
                          else {127, 63, 31, 15})
    scale = max(float(np.abs(np.asarray(w)).max()) for w in uj)
    for g, w in zip(ut, uj):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=STEP_RTOL * scale)


def test_step_matches_complex_form(lowered):
    """The split step is the complex step (tests/test_split_complex.py:
    67-88) in the port: re + i im within 1e-9 of helmholtz_2d's."""
    s = lowered[SMALL[0]]
    _, lt = s.cycles["rb"]
    pc = thelmholtz.helmholtz_2d(*SMALL[0], k=SMALL[1])
    cycle = tcycles.v_cycle(pc.level_contexts, pc.rhs_entity,
                            pre_smoothing=2, post_smoothing=1, omega=0.6,
                            partitioning=tpart.RedBlack,
                            coarse_operator=pc.coarsest_operator)
    lc = tlower.lower_cycle(cycle, pc.approximation, pc.rhs_entity)
    bc = build_rhs(pc, dtype=torch.float64, device="cpu")
    zc = lc.step((torch.zeros_like(bc[0]),), bc,
                 torch.tensor(lc.default_omegas))[0].numpy()
    us = lt.step(tuple(torch.zeros_like(x) for x in s.bt), s.bt,
                 torch.tensor(lt.default_omegas))
    zs = us[0].numpy() + 1j * us[1].numpy()
    np.testing.assert_allclose(zs, zc, rtol=0, atol=1e-9 * np.abs(zc).max())


@pytest.mark.parametrize("m", [2, 3])
def test_varying_inverse_matches_jax(m):
    """The collective point solve of a system with a varying (0, 0)
    center: the closed-form 2 x 2 inverse with row fixups (m = 2) and the
    batched solve (m = 3), against the JAX package's and against numpy's
    solve at every point, float64."""
    from evostencils_tpu.stencils.constant import Stencil as JStencil
    from evostencils_tpu_torch.stencils.constant import Stencil as TStencil
    jpkg = SimpleNamespace(base=jbase, system=jsystem, stencil=JStencil)
    tpkg = SimpleNamespace(base=tbase, system=tsystem, stencil=TStencil)
    opj = _varying_system(jpkg, jgallery, m, jax_grid=True)
    opt = _varying_system(tpkg, tgallery, m, jax_grid=False)
    shape = tuple(opt.entries[0][0].grid.size)
    rng = np.random.default_rng(m)
    r = [rng.standard_normal(shape) for _ in range(m)]
    low = tlower._Lowering(None, None, None)
    low.set_like(torch.zeros(1, dtype=torch.float64))
    got = low.apply_inverse(tsystem.ElementwiseDiagonal(opt),
                            tuple(torch.from_numpy(a) for a in r))
    lj = jlower._Lowering(None, None, None)
    lj.dtype = jnp.float64
    want = lj.apply_inverse(jsystem.ElementwiseDiagonal(opj),
                            tuple(jnp.asarray(a) for a in r))
    # numpy: the m x m center matrix at every point
    d00 = tgallery.Poisson2DVariableCoefficients() \
        .generate_stencil_field(opt.entries[0][0].grid).diagonal_field()
    D = np.zeros(shape + (m, m))
    for i in range(m):
        for j in range(m):
            D[..., i, j] = d00 if i == j == 0 else \
                opt.entries[i][j].generate_stencil().value_at((0, 0))
    ref = np.linalg.solve(D, np.stack(r, axis=-1)[..., None])[..., 0]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13,
                                   atol=0)
        np.testing.assert_allclose(g.numpy(), ref[..., i], rtol=1e-12,
                                   atol=0)


def _varying_system(pkg, gallery, m, jax_grid):
    """An m x m system over a 31^2 grid whose (0, 0) entry has a
    variable-coefficient field form and whose other entries are constant
    and diagonally dominant."""
    if jax_grid:
        from evostencils_tpu.grids import unit_interval_grid
    else:
        from evostencils_tpu_torch.grids import unit_interval_grid
    g = unit_interval_grid(2, 5)
    entries = []
    for i in range(m):
        row = []
        for j in range(m):
            if i == j == 0:
                gen = gallery.Poisson2DVariableCoefficients()
            else:
                c = 3.0 + i if i == j else 0.3 * (i + 1) - 0.2 * j
                gen = pkg.base.ConstantStencilGenerator(
                    pkg.stencil([((0, 0), c), ((1, 0), -0.1)]))
            row.append(pkg.base.Operator(f"A{i}{j}", g, gen))
        entries.append(row)
    return pkg.system.Operator("A", entries)


@pytest.mark.parametrize("level", [0, -1])
def test_sys_entry_nine_matches_jax(level):
    """``_sys_entry_nine`` and ``_sys_nine_table`` of the split operator
    at the finest (255^2) and the coarsest context (15^2) of the wide
    hierarchy: the same coefficients, fixup rows and deltas as the JAX
    package's; the fixups sit on rows 0 and n - 1, on the (0, 0)
    coefficients of every block (the Robin fold)."""
    pj, pt = _problems(*WIDE)
    opj = pj.level_contexts[level].operator
    opt = pt.level_contexts[level].operator
    n = opt.entries[0][0].grid.size[0]
    for row_j, row_t in zip(opj.entries, opt.entries):
        for ej, et in zip(row_j, row_t):
            cj, xj = jlower._sys_entry_nine(ej)
            ct, xt = tlower._sys_entry_nine(et)
            assert ct == tuple(float(v) for v in cj)
            assert xt == {int(i): float(d) for i, d in xj.items()}
            assert set(xt) == {0, n - 1}
    tj, tt = jlower._sys_nine_table(opj), tlower._sys_nine_table(opt)
    assert tt == tj
    assert [r for r, _ in tt[1]] == [0, n - 1]


def test_kernels_reached_match_jax():
    """At helmholtz_2d_split(9, 3) in float32 each package reaches its
    system legs once per cycle on 511^2 and 255^2 and no system sweep,
    RB and Jacobi; the port's legs get the problem's own fixup rows
    (rows 0 and n - 1 of the level).  The JAX step is traced with
    jax.eval_shape."""
    names = ("fused_rbgs_sweep_sys", "jacobi_sweep_sys",
             "presmooth_residual_restrict_sys",
             "prolong_correct_postsmooth_sys")
    pj, pt = _problems((9, 3), 80.0)
    b = build_rhs(pt, dtype=torch.float32, device="cpu")
    for key in CYCLES:
        ct, cj = collections.Counter(), collections.Counter()
        with pytest.MonkeyPatch.context() as mp:
            for mod, cnt in ((trs, ct), (jrs, cj)):
                for name in names:
                    def counted(*a, _f=getattr(mod, name), _n=name, _c=cnt,
                                _port=mod is trs, **kw):
                        n = a[0][0].shape[0]
                        _c[(_n, n)] += 1
                        if _port:
                            assert [r for r, _ in kw["exc"]] == [0, n - 1]
                            assert [r for r, _ in kw["exc_minv"]] == \
                                [0, n - 1]
                        return _f(*a, **kw)
                    mp.setattr(mod, name, counted)
            mp.setattr(jconfig.config, "use_pallas_kernels", True)
            lt = tlower.lower_cycle(_v21(PORT, pt, key), pt.approximation,
                                    pt.rhs_entity)
            out = lt.step(tuple(torch.zeros_like(x) for x in b), b,
                          torch.tensor(lt.default_omegas,
                                       dtype=torch.float32))
            lj = jlower.lower_cycle(_v21(JAX, pj, key), pj.approximation,
                                    pj.rhs_entity)
            spec = (jax.ShapeDtypeStruct((511, 511), jnp.float32),) * 2
            jax.eval_shape(lj.step, spec, spec, jax.ShapeDtypeStruct(
                lj.default_omegas.shape, jnp.float32))
        assert all(o.dtype == torch.float32 for o in out)
        want = {(name, n): 1 for name in names[2:] for n in (511, 255)}
        assert dict(ct) == dict(cj) == want


# ---------------------------------------------------------------------------
# (c) the split BiCGStab and the evaluator
# ---------------------------------------------------------------------------

_BICGSTAB = {}


def _bicgstab(s, key, maxiter=400):
    """Both packages' split BiCGStab, one application of the cycle from
    zero as the preconditioner; once per hierarchy and cycle."""
    if (id(s), key) not in _BICGSTAB:
        _BICGSTAB[(id(s), key)] = (s, _bicgstab_run(s, key, maxiter))
    return _BICGSTAB[(id(s), key)][1]


def _bicgstab_run(s, key, maxiter):
    lj, lt = s.cycles[key]
    omj, omt = jnp.asarray(lj.default_omegas), torch.tensor(
        lt.default_omegas)
    _, kj, hj = jsolvers.preconditioned_bicgstab_split(
        jlower.operator_applier(s.pj.outer_solver.operator),
        lambda f: lj.step(tuple(jnp.zeros_like(x) for x in f), f, omj),
        s.bj, tol=1e-7, maxiter=maxiter, history_size=maxiter)
    xt, kt, ht = tsolvers.preconditioned_bicgstab_split(
        tlower.operator_applier(s.pt.outer_solver.operator),
        lambda f: lt.step(tuple(torch.zeros_like(x) for x in f), f, omt),
        s.bt, tol=1e-7, maxiter=maxiter, history_size=maxiter)
    return int(kj), np.asarray(hj), xt, kt, ht.numpy()


@pytest.mark.parametrize("key", list(CYCLES))
def test_split_bicgstab_matches_jax(lowered, key):
    """Equal iteration counts; histories within HIST_RTOL while the
    residual stays above HIST_FLOOR ||b||; both end below 1e-7 ||b||;
    the history keeps maxiter + 1 slots with the unused ones 0; the
    solution is real float64 (re, im)."""
    kj, hj, xt, kt, ht = _bicgstab(lowered[SMALL[0]], key)
    assert kt == kj and 5 < kt < 100
    assert ht.shape == hj.shape == (401,)
    assert np.all(ht[kt + 1:] == 0) and np.all(ht[:kt + 1] > 0)
    above = hj[:kt + 1] > HIST_FLOOR * hj[0]
    assert above.sum() >= 10
    np.testing.assert_allclose(ht[:kt + 1][above], hj[:kt + 1][above],
                               rtol=HIST_RTOL, atol=0)
    assert ht[kt] <= 1e-7 * ht[0] and hj[kj] <= 1e-7 * hj[0]
    assert len(xt) == 2 and all(x.dtype == torch.float64 for x in xt)


def test_split_bicgstab_matches_complex_bicgstab(lowered):
    """The split BiCGStab follows the port's complex BiCGStab on
    helmholtz_2d (tests/test_split_complex.py:91-130): iterations within
    2, solutions within 1e-4 max|z|."""
    s = lowered[SMALL[0]]
    _, _, xs, ks, _ = _bicgstab(s, "rb")
    pc = thelmholtz.helmholtz_2d(*SMALL[0], k=SMALL[1])
    cycle = tcycles.v_cycle(pc.level_contexts, pc.rhs_entity,
                            pre_smoothing=2, post_smoothing=1, omega=0.6,
                            partitioning=tpart.RedBlack,
                            coarse_operator=pc.coarsest_operator)
    lc = tlower.lower_cycle(cycle, pc.approximation, pc.rhs_entity)
    om = torch.tensor(lc.default_omegas)
    xc, kc, _ = tsolvers.preconditioned_bicgstab(
        tlower.operator_applier(pc.outer_solver.operator),
        lambda f: lc.step((torch.zeros_like(f[0]),), f, om),
        build_rhs(pc, dtype=torch.float64, device="cpu"), tol=1e-7,
        maxiter=400)
    assert abs(ks - kc) <= 2
    zc = xc[0].numpy()
    np.testing.assert_allclose(xs[0].numpy() + 1j * xs[1].numpy(), zc,
                               rtol=0, atol=1e-4 * np.abs(zc).max())


@pytest.mark.parametrize("degenerate", ["precond", "matvec"])
def test_split_bicgstab_breakdown_guard(lowered, degenerate):
    """A preconditioner or operator that returns 0 makes every quotient
    of the recurrence 0 / 0: the split BiCGStab, like the JAX package's
    (solvers.py:310-314), takes each as 0, carries no NaN and runs its
    budget with the residual at ||b||, while the complex solve stops on a
    NaN residual after one iteration."""
    s = lowered[SMALL[0]]
    lj, lt = s.cycles["rb"]
    omj, omt = jnp.asarray(lj.default_omegas), torch.tensor(
        lt.default_omegas)

    def zeros(f):
        return tuple(x * 0 for x in f)

    def pick(matvec, precond):
        return (zeros, precond) if degenerate == "matvec" \
            else (matvec, zeros)
    mj, pj = pick(jlower.operator_applier(s.pj.outer_solver.operator),
                  lambda f: lj.step(zeros(f), f, omj))
    mt, pt = pick(tlower.operator_applier(s.pt.outer_solver.operator),
                  lambda f: lt.step(zeros(f), f, omt))
    xj, kj, hj = jsolvers.preconditioned_bicgstab_split(
        mj, pj, s.bj, tol=1e-7, maxiter=5, history_size=5)
    xt, kt, ht = tsolvers.preconditioned_bicgstab_split(
        mt, pt, s.bt, tol=1e-7, maxiter=5, history_size=5)
    assert int(kj) == kt == 5
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-12)
    np.testing.assert_allclose(ht.numpy(), ht[0].item(), rtol=1e-12)
    for a, c in zip(xt, xj):
        assert torch.isfinite(a).all()
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    joined = (torch.complex(*s.bt),)
    _, kc, hc = tsolvers.preconditioned_bicgstab(
        lambda f: zeros(f) if degenerate == "matvec" else f,
        lambda f: zeros(f) if degenerate == "precond" else f, joined,
        tol=1e-7, maxiter=5, history_size=5)
    assert kc == 1 and torch.isnan(hc[1])


def test_evaluator_split_outer_solver(lowered):
    """The evaluator solves a split problem with the split BiCGStab: its
    iterations are the JAX evaluator's and the split solver's own, in
    float64 with real fields; float32 gives real float32 fields."""
    s = lowered[SMALL[0]]
    et = tev.CycleEvaluator(s.pt, dtype=np.float64, device="cpu",
                            max_iterations=400)
    ej = jev.CycleEvaluator(s.pj, dtype=np.float64, max_iterations=400)
    et.timing_enabled = ej.timing_enabled = False
    assert [x.dtype for x in et._b] == [torch.float64] * 2
    assert et.measurement_reduction == ej.measurement_reduction == 1e-7
    calls = []
    split = tsolvers.preconditioned_bicgstab_split
    with pytest.MonkeyPatch.context() as mp:
        def counted(*a, **kw):
            calls.append(1)
            return split(*a, **kw)
        mp.setattr(tev, "preconditioned_bicgstab_split", counted)
        rt = et.evaluate_expression(_v21(PORT, s.pt, "rb"))
    rj = ej.evaluate_expression(_v21(JAX, s.pj, "rb"))
    kj, _, _, kt, _ = _bicgstab(s, "rb")
    assert calls and rt.iterations == rj.iterations == kt == kj
    assert 0 < rt.convergence_factor < 1
    e32 = tev.CycleEvaluator(thelmholtz.helmholtz_2d_split(4, 3),
                             dtype=np.float32, device="cpu")
    assert [x.dtype for x in e32._b] == [torch.float32] * 2


# ---------------------------------------------------------------------------
# (d) JAX lowers => the port lowers
# ---------------------------------------------------------------------------

_PROBE = {}


def _probe_setup(levels):
    if levels not in _PROBE:
        pj, pt = _problems(levels, 80.0)
        _PROBE[levels] = SimpleNamespace(
            pj=pj, pt=pt, psj=_pset(jmg, pj), pst=_pset(tmg, pt),
            b=build_rhs(pt, dtype=torch.float64, device="cpu"))
    return _PROBE[levels]


def _champions():
    data = json.loads(CHAMPIONS.read_text())
    return [e["grammar"] for key in CHAMPION_KEYS for e in data[key]]


@pytest.mark.parametrize("case", [f"seed{s}" for s in PROBE_SEEDS]
                         + [f"champion{i}" for i in range(11)])
def test_jax_lowers_implies_port_lowers(case):
    """genGrow(pset, 2, 40) seeds 0-39 on helmholtz_2d_split(5, 3), and
    the 11 stored helmholtz_split_k80 champions at their 7 -> 3: where the
    JAX package lowers an individual and traces a float64 step
    (jax.eval_shape), the port lowers it and takes one float64 step of the
    same shapes."""
    if case.startswith("seed"):
        s = _probe_setup((5, 3))
        seed = int(case[4:])
        ij = jgp.genGrow(s.psj, 2, 40, rng=random.Random(seed))
        it = tgp.genGrow(s.pst, 2, 40, rng=random.Random(seed))
    else:
        s = _probe_setup((7, 3))
        grammar = _champions()[int(case[8:])]
        ij, it = jgp.parse_tree(grammar, s.psj), tgp.parse_tree(grammar,
                                                                 s.pst)
    assert str(it) == str(ij)
    n = s.pt.finest_grid[0].size[0]
    try:
        lj = jlower.lower_cycle(jgp.compile_tree(ij, s.psj)[0],
                                s.pj.approximation, s.pj.rhs_entity)
        spec = (jax.ShapeDtypeStruct((n, n), jnp.float64),) * 2
        jax.eval_shape(lj.step, spec, spec, jax.ShapeDtypeStruct(
            lj.default_omegas.shape, jnp.float64))
    except NotImplementedError:
        pytest.fail(f"the JAX package does not lower {case}; the probe "
                    "expects every one of its individuals to lower")
    lt = tlower.lower_cycle(tgp.compile_tree(it, s.pst)[0],
                            s.pt.approximation, s.pt.rhs_entity)
    out = lt.step(tuple(torch.zeros_like(x) for x in s.b), s.b,
                  torch.tensor(lt.default_omegas))
    assert [tuple(o.shape) for o in out] == [(n, n)] * 2
    assert all(o.dtype == torch.float64 for o in out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_step_matches_jax(seed):
    """One float64 step of a seeded individual (genGrow(pset, 2, 40) on
    helmholtz_2d_split(5, 3)) in each package: within STEP_RTOL of
    max|JAX|, so that an evolved cycle scores as in the JAX package."""
    s = _probe_setup((5, 3))
    ij = jgp.genGrow(s.psj, 2, 40, rng=random.Random(seed))
    it = tgp.genGrow(s.pst, 2, 40, rng=random.Random(seed))
    lj = jlower.lower_cycle(jgp.compile_tree(ij, s.psj)[0],
                            s.pj.approximation, s.pj.rhs_entity)
    lt = tlower.lower_cycle(tgp.compile_tree(it, s.pst)[0],
                            s.pt.approximation, s.pt.rhs_entity)
    bj = s.pj.rhs_builder(np.float64)
    uj = lj.step(tuple(jnp.zeros_like(x) for x in bj), bj,
                 jnp.asarray(lj.default_omegas))
    ut = lt.step(tuple(torch.zeros_like(x) for x in s.b), s.b,
                 torch.tensor(lt.default_omegas))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in uj)
    for g, w in zip(ut, uj):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=STEP_RTOL * scale)


# ---------------------------------------------------------------------------
# (e) the CLI
# ---------------------------------------------------------------------------

def test_cli_helmholtz2d_split(tmp_path, capsys, monkeypatch):
    """``python -m evostencils_tpu_torch.optimize helmholtz2d_split --cpu
    --no-robustness`` at levels 5 -> 3 (31^2) runs one generation and
    writes its best individual, which re-parses and evaluates to a finite
    convergence factor.  The problem is the JAX test's (k = 20,
    tests/test_split_complex.py:28-29; at k = 80 the red-black V(2,1)
    needs about 285 BiCGStab iterations at 31^2, the k = 20 one 26) and
    its iteration budget is cut from 10,000 to 40, so that a candidate
    that does not converge costs about a second (wall-time measurement
    off)."""
    monkeypatch.setattr(tev.CycleEvaluator, "timing_enabled", False)
    factory = thelmholtz.helmholtz_2d_split

    def cut(max_level, min_level, k=None):
        problem = factory(max_level, min_level, k=20.0)
        problem.max_iterations = 40
        return problem
    monkeypatch.setattr(thelmholtz, "helmholtz_2d_split", cut)
    result = toptimize.main(["helmholtz2d_split", "--cpu", "--max-level",
                             "5", "--min-level", "3", "--mu", "2",
                             "--lambda", "2", "--generations", "1", "--seed",
                             "0", "--no-robustness", "--output",
                             str(tmp_path)])
    best = (tmp_path / "best_grammar.txt").read_text().strip()
    assert best == result["grammar_string"]
    assert "Best individual:" in capsys.readouterr().out
    problem = cut(5, 3)
    evaluator = tev.CycleEvaluator(problem, device="cpu")
    pset = _pset(tmg, problem)
    res = evaluator.evaluate_expression(
        tgp.compile_tree(tgp.parse_tree(best, pset), pset)[0])
    assert np.isfinite(res.convergence_factor) and res.convergence_factor > 0


def test_cli_helmholtz2d_split_robustness():
    """helmholtz2d_split's default levels are scripts/optimize.py's (7 ->
    3), and its robustness variants are split problems at 2k and 4k
    (scripts/optimize.py:124-142), grown by their own factory."""
    problem = toptimize.get_problem("helmholtz2d_split")
    assert (problem.max_level, problem.min_level) == (7, 3)
    assert problem.outer_solver.split and problem.coupled_fields
    args = toptimize.parse_args(["helmholtz2d_split"])
    variants = [f(3, 5) for f in toptimize.robustness_factories(args)]
    assert [v.name for v in variants] == ["Helmholtz2DSplit"] * 2
    assert [v.outer_solver.operator.entries[0][0].stencil_generator.gen.k
            for v in variants] == [160.0, 320.0]
    assert all((v.max_level, v.min_level) == (5, 3) for v in variants)
    assert toptimize.robustness_factories(toptimize.parse_args(
        ["helmholtz2d_split", "--no-robustness"])) is None
