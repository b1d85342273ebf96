"""The port's deep solves (evostencils_tpu_torch/compiler/refine.py and
deep_solve.py) against the JAX package's df64 refinement
(evostencils_tpu/compiler/refine.py) on the CPU, and the bfloat16 storage
of the 2D legs that the bf16 inner cycles run.

The same right-hand sides, built in float64 and rounded to float32, go
through both packages.  The port measures its residual in float64, the
JAX package in df64 words whose floor lies near 1e-13 to 1e-14 of the
start, so histories are compared only above 1e-10 (FAS: 1e-9) of their
first entry.  A bf16 cycle rounds differently in the two packages (on the
CPU the JAX package runs it through XLA's generic ops, promoting to
float32 between stores; the port's generic levels stay bf16), so the bf16
mode is held to its convergence, not its values.
"""

import collections
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu import config as jconfig
from evostencils_tpu.compiler import cycles as jcycles
from evostencils_tpu.compiler import lower as jlower
from evostencils_tpu.compiler import refine as jrefine
from evostencils_tpu.ir import base as jbase
from evostencils_tpu.ir import partitioning as jpart
from evostencils_tpu.ir import system as jsystem
from evostencils_tpu.ops.pallas import leg3d as pleg3d
from evostencils_tpu.ops.pallas import rbgs as prbgs
from evostencils_tpu.ops.pallas import rbgs3d as prbgs3d
from evostencils_tpu.ops.pallas import rbgs_sys as prbgs_sys
from evostencils_tpu.ops.pallas import rbgs_var as prbgs_var
from evostencils_tpu.ops.pallas import transfer as ptransfer
from evostencils_tpu.ops.pallas import wavefront3d as pwavefront3d
from evostencils_tpu.problems import fas as jfas
from evostencils_tpu.problems import poisson as jpoisson
from evostencils_tpu.problems.api import scalar_hierarchy as jhierarchy
from evostencils_tpu.stencils import gallery as jgallery
from evostencils_tpu_torch import deep_solve
from evostencils_tpu_torch.compiler import cycles as tcycles
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.compiler import refine as trefine
from evostencils_tpu_torch.ir import partitioning as tpart
from evostencils_tpu_torch.ops import apply as tapply
from evostencils_tpu_torch.ops.kernels import leg3d as tleg3d
from evostencils_tpu_torch.ops.kernels import rbgs as trbgs
from evostencils_tpu_torch.ops.kernels import rbgs3d as trbgs3d
from evostencils_tpu_torch.ops.kernels import rbgs_cx as trbgs_cx
from evostencils_tpu_torch.ops.kernels import rbgs_sys as trbgs_sys
from evostencils_tpu_torch.ops.kernels import rbgs_var as trbgs_var
from evostencils_tpu_torch.ops.kernels import transfer as ttransfer
from evostencils_tpu_torch.ops.kernels import wavefront3d as twavefront3d
from evostencils_tpu_torch.problems import fas as tfas
from evostencils_tpu_torch.problems import poisson as tpoisson
from evostencils_tpu_torch.problems.poisson import build_rhs

VALS = (4.0, -1.0, -1.0, -1.0, -1.0)
VALS7 = (6.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0)
R_TAPS = ((0.25, 0.5, 0.25), (0.25, 0.5, 0.25))
P_TAPS = ((0.5, 1.0, 0.5), (0.5, 1.0, 0.5))
OMEGAS = (0.9, 1.15, 0.8, 1.3)
#: histories are compared above these shares of their first entry: the
#: JAX package's df64 floor lies near 1e-13 to 1e-14
HISTORY_FLOOR = 1e-10
FAS_HISTORY_FLOOR = 1e-9
HISTORY_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run's parallel workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(rng, *shape):
    return torch.tensor(rng.standard_normal(shape),
                        dtype=torch.float32).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# (a) the 2D legs' plain versions in bfloat16 storage
# ---------------------------------------------------------------------------

def _legs(shape, sweeps, seed=0):
    """(name, bf16 call, the same call on the operands widened to float32)
    of both legs at ``shape`` with ``sweeps`` sweeps."""
    rng = np.random.default_rng(seed)
    n, m = shape
    u, b, e = _bf16(rng, n, m), _bf16(rng, n, m), \
        _bf16(rng, (n - 1) // 2, (m - 1) // 2)
    om = torch.tensor(OMEGAS, dtype=torch.float32)
    down_ids, up_ids = [1, 2, 3][:sweeps], [0, 1, 2, 3][:sweeps + 1]

    def down(fn, *x):
        return fn(*x, om, down_ids, VALS, R_TAPS)

    def up(fn, uu, ee, bb):
        return fn(uu, ee, bb, om, up_ids, VALS, P_TAPS)

    return [("down", lambda fn: down(fn, u, b),
             lambda fn: down(fn, u.float(), b.float())),
            ("up", lambda fn: up(fn, u, e, b),
             lambda fn: up(fn, u.float(), e.float(), b.float()))]


PLAIN = {"down": ttransfer.presmooth_residual_restrict_plain,
         "up": ttransfer.prolong_correct_postsmooth_col_plain}
WRAPPER = {"down": ttransfer.presmooth_residual_restrict,
           "up": ttransfer.prolong_correct_postsmooth_col}


@pytest.mark.parametrize("sweeps", [1, 2, 3])
@pytest.mark.parametrize("shape", [(131, 197), (259, 131)])
def test_plain_bf16_legs_compute_in_float32(shape, sweeps):
    """A bf16 leg's plain version, and its wrapper on the CPU, equal the
    float32 computation on the widened operands rounded once to bf16, as
    the TPU kernels load bf16, compute in float32 and round on store
    (transfer.py:774-779, :876-879); bf16 arithmetic throughout would
    round every intermediate and differ."""
    for leg, bf16_call, f32_call in _legs(shape, sweeps):
        want = f32_call(PLAIN[leg])
        want = want if isinstance(want, tuple) else (want,)
        for fn in (PLAIN[leg], WRAPPER[leg]):
            got = bf16_call(fn)
            got = got if isinstance(got, tuple) else (got,)
            for g, w in zip(got, want):
                assert g.dtype == torch.bfloat16
                assert torch.equal(g, w.to(torch.bfloat16)), (leg, fn)


@pytest.mark.parametrize("leg", ["down", "up"])
def test_plain_bf16_legs_match_pallas_bf16(leg):
    """The bf16 plain legs against the Pallas kernels in interpret mode on
    bf16 grids, at 131 x 197 with two sweeps: within 2 bf16 ulps of
    max|Pallas| (both compute in float32, in other orders, and round
    once)."""
    sweeps, (n, m) = 2, (131, 197)
    (_, bf16_call, _), = [c for c in _legs((n, m), sweeps, seed=1)
                          if c[0] == leg]
    captured = {}

    def capture(*args):
        captured["args"] = args
        return PLAIN[leg](*args)

    got = bf16_call(capture)
    got = got if isinstance(got, tuple) else (got,)
    args = captured["args"]
    jx = [jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in
          (args[:2] if leg == "down" else args[:3])]
    om = args[2] if leg == "down" else args[3]
    ids = args[3] if leg == "down" else args[4]
    omegas = [float(om[i]) for i in ids]
    if leg == "down":
        want = ptransfer.presmooth_residual_restrict(
            *jx, omegas, VALS, R_TAPS, interpret=True)
    else:
        want = (ptransfer.prolong_correct_postsmooth_col(
            *jx, omegas, VALS, P_TAPS, interpret=True),)
    eps = float(torch.finfo(torch.bfloat16).eps)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert w.dtype == np.float32 and g.dtype == torch.bfloat16
        scale = np.abs(w).max()
        ulp = eps * 2.0 ** np.floor(np.log2(scale))
        assert np.abs(g.float().numpy() - w).max() <= 2 * ulp


# ---------------------------------------------------------------------------
# (b) every other kernel gate refuses bfloat16
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _spec(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


#: (the row the refusal names, the port's gate, the JAX gate or None where
#: it admits no bf16, a shape every gate admits in float32)
GATES = {
    "passes": ("rows 3 and 8",
               lambda u: ttransfer.supports(
                   u, "rows 3 and 8 (upleg_downleg_col, upleg_downleg_fused)"),
               ptransfer.supports, (255, 255)),
    "residual_restrict": ("row 4",
                          lambda u: ttransfer.supports(
                              u, "row 4 (residual_restrict)"),
                          ptransfer.supports, (255, 255)),
    "prolong_correct": ("row 5",
                        lambda u: ttransfer.supports(
                            u, "row 5 (prolong_correct)"),
                        ptransfer.supports, (255, 255)),
    "default": ("no bf16 form", ttransfer.supports, ptransfer.supports,
                (255, 255)),
    "rowlegs": ("rows 6-7", lambda u: tlower._LEG_GATES["const5"](u, True),
                ptransfer.supports, (255, 255)),
    "rbgs": ("rows 9-10", lambda u: trbgs.supports(u, VALS),
             lambda s: prbgs.supports(s, VALS), (255, 255)),
    "rbgs_var": ("row 11", lambda u: trbgs_var.supports(u, True),
                 lambda s: prbgs_var.supports(s, True), (255, 255)),
    "var_legs": ("rows 12-13",
                 lambda u: tlower._LEG_GATES["var5"](u, False),
                 ptransfer.supports, (255, 255)),
    "rbgs_sys": ("row 14", lambda u: trbgs_sys.supports((u, u), True),
                 lambda s: prbgs_sys.supports((s, s), True), (255, 255)),
    "sys_legs": ("rows 15-16", lambda u: trbgs_sys.leg_supports((u, u)),
                 ptransfer.supports, (255, 255)),
    "rbgs_cx": ("row 17", lambda u: trbgs_cx.supports(u, VALS), None,
                (255, 255)),
    "rbgs3d": ("row 18", lambda u: trbgs3d.supports(u, VALS7),
               lambda s: prbgs3d.supports(s, VALS7), (63, 63, 63)),
    "leg3d": ("rows 19-21", tleg3d.supports, pleg3d.supports,
              (255, 255, 255)),
    "wavefront3d": ("rows 22-23", twavefront3d.supports,
                    pwavefront3d.supports, (255, 255, 255)),
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_bf16_refused_at_every_other_gate(gate):
    """A bf16 field at any kernel gate but the 2D legs' raises
    NotImplementedError naming the kernel's row, where the JAX gate admits
    bf16 (rbgs.py:140, rbgs_var.py:58, rbgs_sys.py:68, rbgs3d.py:67,
    leg3d.py:397, wavefront3d.py:215, transfer.py:590; the complex sweeps'
    gate admits complex64 only).  The float32 field passes the gate."""
    row, port_gate, jax_gate, shape = GATES[gate]
    if jax_gate is not None:
        assert jax_gate(_spec(shape, jnp.bfloat16))
        assert port_gate(_meta(shape, torch.float32))
    for device in ("meta", "cpu"):
        u = torch.empty(shape, dtype=torch.bfloat16, device=device)
        with pytest.raises(NotImplementedError, match=row):
            port_gate(u)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_bf16_admitted_at_the_legs(device):
    """The 2D legs (rows 1-2) take bf16 on every device, at the float32
    level set, as the JAX gate does (transfer.py:590-595); the transfer
    gate admits it only when its caller names these rows."""
    for n in (255, 129, 127, 63):
        want = ptransfer.supports(_spec((n, n), jnp.bfloat16))
        u = torch.empty((n, n), dtype=torch.bfloat16, device=device)
        assert ttransfer.supports(u, ttransfer.LEG_ROWS) == want == (n >= 129)
        assert tlower._LEG_GATES["const5"](u, False) == want


def _counting(mp, entries, counts):
    for mod, names in entries.items():
        cnt = counts[mod.__name__.startswith("evostencils_tpu.")]
        for name in names:
            def counted(*a, _f=getattr(mod, name), _n=name, _c=cnt, **kw):
                _c[(_n, a[0].shape[0], str(a[0].dtype))] += 1
                return _f(*a, **kw)
            mp.setattr(mod, name, counted)


#: the 2D kernel entries of both packages
ENTRIES = {ttransfer: ("presmooth_residual_restrict",
                       "prolong_correct_postsmooth_col",
                       "residual_restrict", "prolong_correct"),
           trbgs: ("fused_rbgs_sweep", "jacobi_sweep"),
           ptransfer: ("presmooth_residual_restrict",
                       "prolong_correct_postsmooth_col",
                       "residual_rowrestrict", "prolong_row_correct"),
           prbgs: ("fused_rbgs_sweep", "jacobi_sweep")}


def _jax_poisson(max_level, min_level):
    p = jpoisson.poisson_2d(max_level=max_level, min_level=min_level)
    cycle = jcycles.v_cycle(p.level_contexts, p.rhs_entity,
                            pre_smoothing=2, post_smoothing=1, omega=1.15,
                            partitioning=jpart.RedBlack,
                            coarse_operator=p.coarsest_operator)
    return p, jlower.lower_cycle(cycle, p.approximation, p.rhs_entity)


def jax_deep_outer(max_level, inner_dtype="bfloat16"):
    """The JAX package's outer steps and ratios of the deep Poisson solve
    of scripts/deep_solve.py on the CPU: poisson_2d(max_level,
    max(max_level - 6, 2)), the red-black V(2,1) at omega 1.15, 3 cycles
    in ``inner_dtype`` an outer step (8 in "float32"), to 1e-12, at most
    16 outer steps.  ``chip_smoke.py`` holds the port's [deep-bf16] on
    the card to it:

        JAX_PLATFORMS=cpu python -c 'from tests.test_torch_refine import
        jax_deep_outer as f; print(f(10))'
    """
    pj, lj = _jax_poisson(max_level, max(max_level - 6, 2))
    bj = jnp.asarray(pj.build_rhs()[0], dtype=jnp.float32)
    options = dict(inner_cycles=8) if inner_dtype == "float32" else \
        dict(inner_cycles=3, inner_dtype=jnp.dtype(inner_dtype))
    res = jrefine.make_refined_solver(lj, max_outer=16,
                                      target_reduction=1e-12, **options)(bj)
    h = res.residuals
    return res.outer_iterations, [round(y / x, 3) for x, y in zip(h, h[1:])]


def _port_poisson(max_level, min_level):
    p = tpoisson.poisson_2d(max_level=max_level, min_level=min_level)
    cycle = tcycles.v_cycle(p.level_contexts, p.rhs_entity,
                            pre_smoothing=2, post_smoothing=1, omega=1.15,
                            partitioning=tpart.RedBlack,
                            coarse_operator=p.coarsest_operator)
    return p, tlower.lower_cycle(cycle, p.approximation, p.rhs_entity)


def _jax_shifted(max_level, min_level):
    gen = jgallery.ShiftedOperatorGenerator(jgallery.Poisson2D(), 20.0)
    ctxs, coarsest = jhierarchy("Ashift", 2, max_level, min_level, gen)
    rhs_e = jsystem.RightHandSide(
        "f", [jbase.RightHandSide("f", ctxs[0].grid[0])])
    cycle = jcycles.v_cycle(ctxs, rhs_e, pre_smoothing=2, post_smoothing=1,
                            omega=1.0, partitioning=jpart.RedBlack,
                            coarse_operator=coarsest)
    return jlower.lower_cycle(cycle, ctxs[0].approximation, rhs_e)


@pytest.mark.parametrize("case", ["poisson-bf16", "shifted-f32"])
def test_deep_cycles_reach_the_legs_as_jax(case):
    """The deep solves' cycles reach the 2D legs on the levels of at
    least 129 rows in both packages and no other kernel entry: the
    red-black V(2,1) of poisson_2d(9, 5) on bf16 fields, and the shifted
    linear cycle L + 20 I of the FAS Newton correction (scalar_hierarchy
    "Ashift" at 9 -> 6) in float32, whose shifted centre the leg planner
    takes as it takes the Laplacian's.  The JAX step is traced with
    jax.eval_shape."""
    if case == "poisson-bf16":
        tdtype, jdtype = torch.bfloat16, jnp.bfloat16
        _, lt = _port_poisson(9, 3)
        _, lj = _jax_poisson(9, 3)
    else:
        tdtype, jdtype = torch.float32, jnp.float32
        _, _, lt = deep_solve.fas_lowered(9, 6)
        lj = _jax_shifted(9, 6)
    counts = {True: collections.Counter(), False: collections.Counter()}
    with pytest.MonkeyPatch.context() as mp:
        _counting(mp, ENTRIES, counts)
        mp.setattr(jconfig.config, "use_pallas_kernels", True)
        b = (torch.ones((511, 511), dtype=tdtype),)
        out = lt.step((torch.zeros_like(b[0]),), b,
                      torch.tensor(lt.default_omegas, dtype=torch.float32))
        spec = (jax.ShapeDtypeStruct((511, 511), jdtype),)
        jax.eval_shape(lj.step, spec, spec, jax.ShapeDtypeStruct(
            lj.default_omegas.shape, jnp.float32))
    assert torch.isfinite(out[0].float()).all()
    want = {(name, n, dt): 1 for n in (511, 255)
            for name in ("presmooth_residual_restrict",
                         "prolong_correct_postsmooth_col")
            for dt in [str(tdtype)]}
    assert dict(counts[False]) == want
    assert {k[:2] for k in counts[True]} == {k[:2] for k in want}
    assert all(v == 1 for v in counts[True].values())


# ---------------------------------------------------------------------------
# (c) the refined solves against the JAX package
# ---------------------------------------------------------------------------

def _both_rhs(pj, pt):
    bj = jnp.asarray(pj.build_rhs()[0], dtype=jnp.float32)
    bt = build_rhs(pt, dtype=torch.float32, device="cpu")[0]
    np.testing.assert_array_equal(np.asarray(bj), bt.numpy())
    return bj, bt


def _relative(res):
    return np.asarray(res.residuals) / res.residuals[0]


def _histories_agree(hj, ht, floor):
    n = min(len(hj), len(ht))
    above = np.minimum(hj[:n], ht[:n]) > floor
    assert above.sum() >= 2
    np.testing.assert_allclose(ht[:n][above], hj[:n][above],
                               rtol=HISTORY_RTOL)


def test_residual_f64_matches_df64():
    """``scalar_residual_f64_fn`` against the JAX ``scalar_residual_df_fn``
    (hi + lo) on the same float64 u, float32 b, with and without the FAS
    nonlinearity: within 1e-12 of the residual's max abs."""
    for problem in (tpoisson.poisson_2d(6, 3), tfas.fas_2d_basic(6, 3)):
        jp = (jpoisson.poisson_2d(6, 3) if problem.name != "FAS_2D_Basic"
              else jfas.fas_2d_basic(6, 3))
        op_t = problem.level_contexts[0].operator
        op_j = jp.level_contexts[0].operator
        st = op_t.entries[0][0].generate_stencil()
        nl_t = tlower._nonlinear_of(op_t)
        nl_j = jlower._nonlinear_of(op_j)
        assert (nl_t is None) == (nl_j is None)
        rng = np.random.default_rng(5)
        u = rng.standard_normal((63, 63)) * 0.5
        b = rng.standard_normal((63, 63)).astype(np.float32)
        got = trefine.scalar_residual_f64_fn(
            st, nl_t and nl_t[0])(torch.tensor(u), torch.tensor(b))
        uh = u.astype(np.float32)
        ul = (u - uh).astype(np.float32)
        rh, rl = jrefine.scalar_residual_df_fn(
            op_j.entries[0][0].generate_stencil(), nl_j and nl_j[0])(
                jnp.asarray(uh), jnp.asarray(ul), jnp.asarray(b))
        want = np.asarray(rh, np.float64) + np.asarray(rl, np.float64)
        assert got.dtype == torch.float64
        assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_nonlinear_of_returns_the_generator():
    """``_nonlinear_of`` gives the generator that carries the nonlinear
    callables, as the JAX refinement expects (refine.py:178-190), and
    refinement refuses an operator without them, or without a correction
    cycle, as the JAX package does."""
    problem = tfas.fas_2d_basic(5, 3)
    gen, entry = tlower._nonlinear_of(problem.level_contexts[0].operator)
    assert isinstance(gen, tfas.FASOperatorGenerator)
    assert entry is problem.level_contexts[0].operator.entries[0][0]
    _, flow, corr = deep_solve.fas_lowered(5, 3)
    with pytest.raises(ValueError, match="correction_lowered"):
        trefine.make_refined_solver(flow, nonlinear=problem.level_contexts[
            0].operator)
    pp, low = _port_poisson(5, 3)
    with pytest.raises(ValueError, match="no nonlinear protocol"):
        trefine.make_refined_solver(low, nonlinear=pp.level_contexts[
            0].operator, correction_lowered=corr)


def test_poisson_to_1e12_with_f32_cycles():
    """poisson_2d(6, 3), ten float32 RB V(2,1) cycles an outer step, to
    1e-12 (tests/test_refine.py:97-124): the same outer count as the JAX
    package, and hi + lo within 1e-10 of a dense float64 solve in both
    packages."""
    pj, lj = _jax_poisson(6, 3)
    pt, lt = _port_poisson(6, 3)
    bj, bt = _both_rhs(pj, pt)
    rj = jrefine.make_refined_solver(lj, inner_cycles=10,
                                     target_reduction=1e-12)(bj)
    rt = trefine.make_refined_solver(lt, inner_cycles=10,
                                     target_reduction=1e-12)(bt)
    assert rj.converged and rt.converged
    assert rt.outer_iterations == rj.outer_iterations
    assert rt.residuals[-1] <= 1e-12 * rt.residuals[0]
    st = pt.level_contexts[0].operator.entries[0][0].generate_stencil()
    A = tapply.dense_matrix(st, pt.finest_grid[0])
    u_star = np.linalg.solve(A, bt.double().numpy().reshape(-1))
    assert rt.solution_hi.dtype == rt.solution_lo.dtype == torch.float32
    got = (rt.solution_hi.double() + rt.solution_lo.double()).reshape(-1)
    np.testing.assert_allclose(got.numpy(), rt.solution.reshape(-1),
                               rtol=0, atol=1e-14 * np.abs(u_star).max())
    rel = np.linalg.norm(got.numpy() - u_star) / np.linalg.norm(u_star)
    assert rel < 1e-10
    jgot = (np.asarray(rj.solution_hi, np.float64)
            + np.asarray(rj.solution_lo, np.float64)).reshape(-1)
    assert np.linalg.norm(jgot - u_star) / np.linalg.norm(u_star) < 1e-10


def test_poisson_histories_match_jax():
    """The outer histories of poisson_2d(6, 3) to 1e-12 with one float32
    cycle an outer step: equal outer counts (9), and the relative
    residuals within 1e-3 of the JAX package's above 1e-10 (they agree to
    about 2e-6 there).  An outer step's residual carries the float32
    rounding of its correction, about 4.5e-7 of the residual it corrects,
    which the two packages round apart: where a step's reduction comes
    near it, as with the ten cycles above (4.5e-7 after the first step),
    the histories part by up to 0.3% at three cycles and 30% at five.
    One cycle reduces by 1e-2 to 4e-2 a step, far above it."""
    pj, lj = _jax_poisson(6, 3)
    pt, lt = _port_poisson(6, 3)
    bj, bt = _both_rhs(pj, pt)
    options = dict(inner_cycles=1, max_outer=16, target_reduction=1e-12)
    rj = jrefine.make_refined_solver(lj, **options)(bj)
    rt = trefine.make_refined_solver(lt, **options)(bt)
    assert rj.converged and rt.converged
    assert rt.outer_iterations == rj.outer_iterations
    _histories_agree(_relative(rj), _relative(rt), HISTORY_FLOOR)


@pytest.mark.parametrize("levels", [(6, 3), (8, 2)])
def test_poisson_to_1e12_with_bf16_cycles(levels):
    """The same with bfloat16 inner cycles, three an outer step, at most
    16 outer steps (tests/test_refine.py:126-148), at 63^2 and 255^2: both
    packages converge, their outer counts lie within 2, and every outer
    step of each contracts the residual below 0.2.  (At 1023^2 neither
    package keeps that: the JAX package's CPU ratios there are 0.111,
    0.046, 1.013, 0.003, 2.305, ..., 11 outer steps, ``jax_deep_outer``,
    which [deep-bf16] holds the port's count to on the card.)"""
    pj, lj = _jax_poisson(*levels)
    pt, lt = _port_poisson(*levels)
    bj, bt = _both_rhs(pj, pt)
    rj = jrefine.make_refined_solver(lj, inner_cycles=3, max_outer=16,
                                     target_reduction=1e-12,
                                     inner_dtype=jnp.bfloat16)(bj)
    rt = trefine.make_refined_solver(lt, inner_cycles=3, max_outer=16,
                                     target_reduction=1e-12,
                                     inner_dtype=torch.bfloat16)(bt)
    assert rj.converged and rt.converged
    assert rt.residuals[-1] <= 1e-12 * rt.residuals[0]
    assert abs(rt.outer_iterations - rj.outer_iterations) <= 2
    for h in (rt.residuals, rj.residuals):
        assert max(b / a for a, b in zip(h, h[1:])) < 0.2


@pytest.mark.parametrize("levels", [(6, 3), (7, 3)])
def test_bf16_generic_levels_compute_as_jax(levels):
    """At 63^2 and 127^2 no kernel gate admits a level, so each package
    runs its bfloat16 cycles through its generic lowering, where the JAX
    package's float32 omegas promote the bf16 fields to float32 (a 0-d
    torch tensor would not; the port widens them, ``lower._damped``).
    Then the port's outer count equals the JAX package's, and its first
    two corrections leave residuals within 1e-2 relative of the JAX
    ones (computed in bf16 arithmetic, the port took 9 and 10 outer steps
    against 7, 0.18 and 0.28 apart after the first correction); later
    entries carry each package's own bf16 roundings."""
    pj, lj = _jax_poisson(*levels)
    pt, lt = _port_poisson(*levels)
    bj, bt = _both_rhs(pj, pt)
    options = dict(inner_cycles=3, max_outer=16, target_reduction=1e-12)
    rj = jrefine.make_refined_solver(lj, inner_dtype=jnp.bfloat16,
                                     **options)(bj)
    rt = trefine.make_refined_solver(lt, inner_dtype=torch.bfloat16,
                                     **options)(bt)
    assert rj.converged and rt.converged
    assert rt.outer_iterations == rj.outer_iterations
    hj, ht = _relative(rj), _relative(rt)
    assert np.all(np.abs(ht[1:3] - hj[1:3]) <= 1e-2 * hj[1:3]), (ht, hj)


def test_fas_to_1e10_with_f32_cycles():
    """fas_2d_basic(5, 3) to 1e-10 by Newton steps of 3 Richardson
    iterations, each preconditioned by 3 float32 cycles of the shifted
    linear operator L + 20 I (tests/test_refine.py:150-178): the same
    outer count as the JAX package, histories within 1e-3 above 1e-9."""
    pj = jfas.fas_2d_basic(max_level=5, min_level=3)
    fcycle = jcycles.fas_v_cycle(pj.level_contexts, pj.rhs_entity,
                                 coarse_operator=pj.coarsest_operator)
    lj = jlower.lower_cycle(fcycle, pj.approximation, pj.rhs_entity)
    pt, lt, ct = deep_solve.fas_lowered(5, 3)
    bj, bt = _both_rhs(pj, pt)
    options = dict(inner_cycles=3, max_outer=8, target_reduction=1e-10,
                   richardson_iterations=3)
    rj = jrefine.make_refined_solver(
        lj, nonlinear=pj.level_contexts[0].operator,
        correction_lowered=_jax_shifted(5, 3), **options)(bj)
    rt = trefine.make_refined_solver(
        lt, nonlinear=pt.level_contexts[0].operator, correction_lowered=ct,
        **options)(bt)
    assert rj.converged and rt.converged
    assert rt.outer_iterations == rj.outer_iterations
    assert rt.residuals[-1] <= 1e-10 * rt.residuals[0]
    _histories_agree(_relative(rj), _relative(rt), FAS_HISTORY_FLOOR)


def test_max_outer_remeasures_the_last_correction():
    """A solve that runs out of outer steps measures its last correction
    once more (refine.py:285-293): max_outer + 1 history entries, and
    converged only if that entry reaches the target."""
    pt, lt = _port_poisson(5, 3)
    b = build_rhs(pt, dtype=torch.float32, device="cpu")[0]
    res = trefine.make_refined_solver(lt, inner_cycles=1, max_outer=2,
                                      target_reduction=1e-12)(b)
    assert res.outer_iterations == 2 and len(res.residuals) == 3
    assert not res.converged
    assert res.residuals[2] < res.residuals[1] < res.residuals[0]


def test_deep_solve_cli(capsys):
    """``python -m evostencils_tpu_torch.deep_solve --cpu`` at 63^2 and
    31^2: all three solves converge and the last line is the JAX script's
    JSON (scripts/deep_solve.py:124-127)."""
    assert deep_solve.main(["--cpu", "--max-level", "6",
                            "--fas-max-level", "5"]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == {
        "poisson_1e12": True, "poisson_1e12_bf16_inner": True,
        "fas_1e10": True}
    assert "[deep] poisson2d 63^2: converged=True" in out.err
