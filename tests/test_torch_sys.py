"""The port's coupled-system kernels (evostencils_tpu_torch/ops/kernels/
rbgs_sys.py) and the sys9 branches of its lowering against the JAX
package: the plain versions of the four kernels against the Pallas
kernels they port (evostencils_tpu/ops/pallas/rbgs_sys.py, in interpret
mode on the CPU as tests/test_pallas_sys.py runs them), the gates against
the JAX gates, the fusion signature, coefficient tables and point-solve
matrices, the planned legs, which kernels one cycle step reaches in each
package, and one generic step in float64.

float32 results are held to 2e-6 times their largest magnitude: the plain
versions repeat each Pallas body's order of operations, and the two
differ only where the Pallas restriction and prolongation contract the
column axis as a matrix product.  The inputs are seeded numpy arrays, on
two coefficient tables: linear elasticity's own at 255^2, whose point
solve is diagonal, and a random diagonally dominant one with nonzero
corners in every block and a non-diagonal point solve, so that a swapped
(i, j) shows; the random one also runs with center and point-solve fixups
on two rows.  Shapes: 255^2, and 259 x 131 for the legs (odd on both
axes, asymmetric per-axis taps), 65 x 130 for the sweeps.
"""

import collections
import json
import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.compiler import cycles as jcycles
from evostencils_tpu.compiler import lower as jlower
from evostencils_tpu.config import config
from evostencils_tpu.grammar import gp as jgp
from evostencils_tpu.grammar import multigrid as jmg
from evostencils_tpu.ir import base as jbase
from evostencils_tpu.ir import partitioning as jpart
from evostencils_tpu.ir import smoother as jsmoother
from evostencils_tpu.ir import system as jsystem
from evostencils_tpu.ir import transformations as jtrans
from evostencils_tpu.ops.pallas import rbgs_sys as prs
from evostencils_tpu.ops.pallas import transfer as ptransfer
from evostencils_tpu.problems import elasticity as jelasticity
from evostencils_tpu_torch.compiler import cycles as tcycles
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.convert import state_from_numpy
from evostencils_tpu_torch.grammar import gp as tgp
from evostencils_tpu_torch.grammar import multigrid as tmg
from evostencils_tpu_torch.ir import base as tbase
from evostencils_tpu_torch.ir import partitioning as tpart
from evostencils_tpu_torch.ir import smoother as tsmoother
from evostencils_tpu_torch.ir import system as tsystem
from evostencils_tpu_torch.ir import transformations as ttrans
from evostencils_tpu_torch.ops.kernels import rbgs as trbgs
from evostencils_tpu_torch.ops.kernels import rbgs_sys as trs
from evostencils_tpu_torch.ops.kernels import rbgs_var as trv
from evostencils_tpu_torch.ops.kernels import transfer as ttransfer
from evostencils_tpu_torch.problems import elasticity as telasticity
from evostencils_tpu_torch.stencils import gallery as tgallery

#: the layers each package builds its own problem and cycle IR from
JAX = SimpleNamespace(problems=jelasticity, cycles=jcycles, part=jpart,
                      smoother=jsmoother, system=jsystem, trans=jtrans,
                      base=jbase, gp=jgp, mg=jmg, lower=jlower)
PORT = SimpleNamespace(problems=telasticity, cycles=tcycles, part=tpart,
                       smoother=tsmoother, system=tsystem, trans=ttrans,
                       base=tbase, gp=tgp, mg=tmg, lower=tlower)

#: relative tolerance: max |port - JAX| <= RTOL * max |JAX|
RTOL = 2e-6
#: the legs read omegas[1:1 + S] (down) and omegas[0:1 + S] (up)
OMEGAS = (0.9, 1.15, 0.8, 1.3)
#: the problem's transfer taps, and asymmetric ones for the ragged shape
R_TAPS = ((0.25, 0.5, 0.25), (0.25, 0.5, 0.25))
P_TAPS = ((0.5, 1.0, 0.5), (0.5, 1.0, 0.5))
R_TAPS_ASYM = ((0.2, 0.5, 0.3), (0.1, 0.6, 0.3))
P_TAPS_ASYM = ((0.4, 1.0, 0.6), (0.3, 0.9, 0.5))
#: (shape, table, red-black, fixups) of the sweep checks
SWEEP_CASES = [((255, 255), "elasticity", True, False),
               ((255, 255), "elasticity", False, False),
               ((65, 130), "random", True, True),
               ((65, 130), "random", False, True)]
#: (shape, table, sweeps, red-black, fixups) of the leg checks: every
#: sweep count and both partitionings
LEG_CASES = [((255, 255), "elasticity", 1, True, False),
             ((255, 255), "elasticity", 2, False, False),
             ((259, 131), "random", 3, False, True),
             ((259, 131), "random", 1, True, True),
             ((259, 131), "random", 2, True, False)]
CHAMPIONS = pathlib.Path(__file__).resolve().parents[1] / "results" / \
    "evolved_champions.json"
CHAMPION_KEY = "elasticity2d_255sq_collective_gen25"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the eager ops on these grids run as fast on
    one, and the test run's parallel workers would otherwise oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _random_table(seed=5):
    """A diagonally dominant 2 x 2 table of 9-point blocks: every block has
    nonzero corners, the off-diagonal blocks nonzero centers, so the point
    solve is not diagonal."""
    rng = np.random.default_rng(seed)
    coeffs = []
    for i in range(2):
        row = []
        for j in range(2):
            c = rng.uniform(-0.3, 0.3, 9)
            c[0] = 6.0 + rng.uniform(0, 1) if i == j else 0.7 + 0.2 * i
            c[1:5] += -1.0 if i == j else 0.0
            row.append(tuple(float(v) for v in c))
        coeffs.append(tuple(row))
    return tuple(coeffs)


def _level_operator(pkg, n):
    """The finest system operator of linear_elasticity_2d at n^2."""
    level = (n + 1).bit_length() - 1
    return pkg.problems.linear_elasticity_2d(
        max_level=level, min_level=level - 1).level_contexts[0].operator


def _fixups(n, coeffs, minv):
    """Center deltas on rows 3 and n - 2 and their point-solve deltas."""
    exc = ((3, ((0.5, 0.25), (-0.2, 0.75))), (n - 2, ((-0.4, 0.0),
                                                      (0.3, 0.6))))
    return exc, tlower._Lowering._sys_minv_exc(coeffs, "elem", exc, minv)


def _operator(kind, shape, fixups):
    """(coeffs, minv, exc, exc_minv) of a check."""
    if kind == "elasticity":
        coeffs = jlower._sys_nine_table(_level_operator(JAX, shape[0]))[0]
    else:
        coeffs = _random_table()
    minv = tlower._Lowering._sys_minv(coeffs, "elem")
    exc, exc_minv = _fixups(shape[0], coeffs, minv) if fixups else ((), ())
    return coeffs, minv, exc, exc_minv


def _fields(shape, seed):
    return [_normal(shape, seed + k) for k in range(2)]


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32
        err = np.abs(g - w).max()
        assert err <= RTOL * np.abs(w).max(), (err, np.abs(w).max())


def _omegas():
    return torch.tensor(OMEGAS, dtype=torch.float32)


def _t(arrays):
    return tuple(torch.tensor(a) for a in arrays)


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,table,red_black,fixups", SWEEP_CASES)
def test_sweep_plain_matches_pallas(shape, table, red_black, fixups):
    coeffs, minv, exc, exc_minv = _operator(table, shape, fixups)
    u, b = _fields(shape, 3), _fields(shape, 5)
    jax_fn = prs.fused_rbgs_sweep_sys if red_black else prs.jacobi_sweep_sys
    port_fn = trs.fused_rbgs_sweep_sys if red_black else trs.jacobi_sweep_sys
    want = jax_fn(_j(u), _j(b), jnp.float32(OMEGAS[1]), coeffs, minv,
                  exc=exc, exc_minv=exc_minv, interpret=True)
    trs.reset_launches()
    got = port_fn(_t(u), _t(b), _omegas(), 1, coeffs, minv, exc, exc_minv)
    assert set(trs.launches.values()) == {0}
    _close([g.numpy() for g in got], want)


def _taps(table):
    return (R_TAPS, P_TAPS) if table == "elasticity" \
        else (R_TAPS_ASYM, P_TAPS_ASYM)


@pytest.mark.parametrize("shape,table,sweeps,red_black,fixups", LEG_CASES)
def test_downleg_plain_matches_pallas(shape, table, sweeps, red_black,
                                      fixups):
    coeffs, minv, exc, exc_minv = _operator(table, shape, fixups)
    u, b = _fields(shape, 7), _fields(shape, 9)
    ids = list(range(1, 1 + sweeps))
    us_j, rc_j = prs.presmooth_residual_restrict_sys(
        _j(u), _j(b), [OMEGAS[i] for i in ids], coeffs, minv,
        _taps(table)[0], red_black=red_black, exc=exc, exc_minv=exc_minv,
        interpret=True)
    trs.reset_launches()
    us_t, rc_t = trs.presmooth_residual_restrict_sys(
        _t(u), _t(b), _omegas(), ids, coeffs, minv, _taps(table)[0],
        red_black=red_black, exc=exc, exc_minv=exc_minv)
    assert set(trs.launches.values()) == {0}
    _close([x.numpy() for x in us_t], us_j)
    _close([x.numpy() for x in rc_t], rc_j)


@pytest.mark.parametrize("shape,table,sweeps,red_black,fixups", LEG_CASES)
def test_upleg_plain_matches_pallas(shape, table, sweeps, red_black,
                                    fixups):
    n, m = shape
    coeffs, minv, exc, exc_minv = _operator(table, shape, fixups)
    u, b = _fields(shape, 11), _fields(shape, 13)
    e = _fields(((n - 1) // 2, (m - 1) // 2), 15)
    ids = list(range(0, 1 + sweeps))
    want = prs.prolong_correct_postsmooth_sys(
        _j(u), _j(e), _j(b), [OMEGAS[i] for i in ids], coeffs, minv,
        _taps(table)[1], red_black=red_black, exc=exc, exc_minv=exc_minv,
        interpret=True)
    trs.reset_launches()
    got = trs.prolong_correct_postsmooth_sys(
        _t(u), _t(e), _t(b), _omegas(), ids, coeffs, minv, _taps(table)[1],
        red_black=red_black, exc=exc, exc_minv=exc_minv)
    assert set(trs.launches.values()) == {0}
    _close([g.numpy() for g in got], want)


def test_checks_tell_the_variants_apart():
    """Partitionings, relaxation factors, the fixups, a transposed point
    solve and transposed taps all change the result, so the comparisons
    above tell them apart; a down-leg of one sweep smooths as the sweep
    does (the two share one order of operations)."""
    shape = (131, 131)
    coeffs, minv, exc, exc_minv = _operator("random", shape, True)
    u, b = _t(_fields(shape, 17)), _t(_fields(shape, 19))
    om = _omegas()
    minv_t = tuple(zip(*minv))
    outs = [trs.fused_rbgs_sweep_sys(u, b, om, 1, coeffs, minv),
            trs.jacobi_sweep_sys(u, b, om, 1, coeffs, minv),
            trs.fused_rbgs_sweep_sys(u, b, om, 2, coeffs, minv),
            trs.fused_rbgs_sweep_sys(u, b, om, 1, coeffs, minv, exc,
                                     exc_minv),
            trs.fused_rbgs_sweep_sys(u, b, om, 1, coeffs, minv_t)]
    for i in range(len(outs)):
        for j in range(i):
            assert max(float((x - y).abs().max())
                       for x, y in zip(outs[i], outs[j])) > 1e-3
    for red_black, sweep in ((True, outs[0]), (False, outs[1])):
        us = trs.presmooth_residual_restrict_sys(
            u, b, om, [1], coeffs, minv, R_TAPS_ASYM, red_black=red_black)[0]
        for x, y in zip(us, sweep):
            assert torch.equal(x, y)
    rc = trs.presmooth_residual_restrict_sys(u, b, om, [1], coeffs, minv,
                                             R_TAPS_ASYM)[1]
    rc_t = trs.presmooth_residual_restrict_sys(u, b, om, [1], coeffs, minv,
                                               R_TAPS_ASYM[::-1])[1]
    assert float((rc[0] - rc_t[0]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

HIERARCHY = [(2 ** k - 1,) * 2 for k in range(12, 2, -1)]   # 4095^2 .. 7^2
RAGGED = [(33, 128), (32, 128), (40, 127), (65, 130), (129, 129),
          (129, 128), (259, 131), (127, 255)]


def _meta(shape, dtype=torch.float32, n_fields=2):
    return tuple(torch.empty(shape, dtype=dtype, device="meta")
                 for _ in range(n_fields))


@pytest.mark.parametrize("shape", HIERARCHY + RAGGED)
def test_gates_match_jax(shape):
    """At F = 2 in float32 off the CPU (``meta`` tensors stand in for the
    card) the sweep gate admits what the JAX gate admits, and the leg gate
    what the JAX lowering's leg gate (the transfer gate on the first field)
    admits on odd grids; float64 off the CPU is refused.  F = 3, which the
    kernels are not built for, and more than MAX_EXC fixups are refused off
    the CPU, where the JAX gate admits them, and admitted on the CPU."""
    coeffs = _random_table()
    specs = [jax.ShapeDtypeStruct(shape, jnp.float32)] * 2
    fields = _meta(shape)
    assert trs.supports(fields, coeffs) == prs.supports(specs, coeffs)
    assert not trs.supports(fields, None)
    odd = all(n % 2 for n in shape)
    assert trs.leg_supports(fields) == (odd and ptransfer.supports(specs[0]))
    f64 = _meta(shape, torch.float64)
    assert not (trs.supports(f64, coeffs) or trs.leg_supports(f64))
    three = _meta(shape, n_fields=3)
    assert prs.supports(specs + specs[:1], coeffs) == \
        prs.supports(specs, coeffs)
    assert not (trs.supports(three, coeffs) or trs.leg_supports(three))
    many = tuple((r, ((0.0, 0.0), (0.0, 0.0)))
                 for r in range(trs.MAX_EXC + 1))
    assert not (trs.supports(fields, coeffs, many)
                or trs.leg_supports(fields, many))
    cpu = tuple(torch.empty(shape) for _ in range(3))
    assert trs.supports(cpu, coeffs, many) == prs.supports(specs, coeffs)
    assert trs.leg_supports(cpu, many) == (odd
                                           and ptransfer.supports(specs[0]))


def test_gate_levels():
    """The level sets on the elasticity path's 2047^2 hierarchy: the legs
    and the sweeps take 2047^2 .. 255^2 (127^2 has 127 columns and rows)."""
    def levels(gate):
        return [s[0] for s in HIERARCHY if gate(_meta(s))]
    assert levels(trs.leg_supports) == [4095, 2047, 1023, 511, 255]
    assert levels(lambda f: trs.supports(f, ())) == [4095, 2047, 1023, 511,
                                                     255]


# ---------------------------------------------------------------------------
# the fusion signature, the tables and the planned legs
# ---------------------------------------------------------------------------

def _operators(pkg):
    problem = pkg.problems.linear_elasticity_2d(max_level=8, min_level=4)
    return [ctx.operator for ctx in problem.level_contexts] + \
        [problem.coarsest_operator]


@pytest.mark.parametrize("kind", ["ElementwiseDiagonal", "Diagonal"])
def test_signature_and_tables_match_jax(kind):
    """On every level of linear_elasticity_2d(8, 4) the sys9 signature, the
    coefficient table, the point-solve matrix and the fixup deltas equal
    the JAX package's, in float64, for both smoother inverses."""
    for aj, at in zip(_operators(JAX), _operators(PORT)):
        sj = jlower._smoother_sig(aj, getattr(jsystem, kind)(aj))
        st = tlower._smoother_sig(at, getattr(tsystem, kind)(at))
        assert st[0] == "sys9" and st[1][1] == {"Diagonal": "diag"}.get(
            kind, "elem")
        assert st == sj
        assert tlower._sys_nine_table(at) == jlower._sys_nine_table(aj)
        coeffs = st[1][0]
        minv = tlower._Lowering._sys_minv(coeffs, st[1][1])
        assert minv == jlower._Lowering._sys_minv(coeffs, st[1][1])
        exc = _fixups(31, coeffs, minv)[0]
        assert tlower._Lowering._sys_minv_exc(coeffs, st[1][1], exc, minv) \
            == jlower._Lowering._sys_minv_exc(coeffs, st[1][1], exc, minv)
    # no smoother inverse, no system signature
    assert tlower._smoother_sig(at) is None


def test_signatures_compare_by_value_kind_included():
    """Elasticity's collective and decoupled point solves coincide (the
    cross-derivative blocks have no center), yet their signatures differ,
    as in the JAX package, so a chain that mixes them stops peeling."""
    at = _operators(PORT)[0]
    elem = tlower._smoother_sig(at, tsystem.ElementwiseDiagonal(at))
    diag = tlower._smoother_sig(at, tsystem.Diagonal(at))
    assert tlower._Lowering._sys_minv(elem[1][0], "elem") == \
        tlower._Lowering._sys_minv(diag[1][0], "diag")
    assert not tlower._same_sig(elem, diag)
    assert tlower._same_sig(elem, tlower._smoother_sig(
        _operators(PORT)[0], tsystem.ElementwiseDiagonal(at)))


#: hand-built cycles: (pre-sweeps, post-sweeps, partitioning, omega,
#: smoother factory)
HAND = {"rb_v21": (2, 1, "RedBlack", 1.25, "generate_collective_jacobi"),
        "jacobi_v21": (2, 1, "Single", 0.8, "generate_collective_jacobi"),
        "rb_v44": (4, 4, "RedBlack", 1.25, "generate_collective_jacobi"),
        "jacobi_v44": (4, 4, "Single", 0.8, "generate_collective_jacobi"),
        "decoupled_rb_v21": (2, 1, "RedBlack", 1.25,
                             "generate_decoupled_jacobi")}
STRUCTURES = sorted(HAND) + ["gen25_0"]


def _structure(pkg, key, max_level=8, min_level=4, dtype=np.float32):
    """A fresh problem and one of the structures, from one package's
    layers; ``gen25_0`` is the stored champion of lowest fitness_rho."""
    problem = pkg.problems.linear_elasticity_2d(max_level=max_level,
                                                min_level=min_level)
    problem.dtype = dtype
    if key in HAND:
        pre, post, partitioning, omega, factory = HAND[key]
        cycle = pkg.cycles.v_cycle(
            problem.level_contexts, problem.rhs_entity, pre_smoothing=pre,
            post_smoothing=post, omega=omega,
            partitioning=getattr(pkg.part, partitioning),
            smoother_factory=getattr(pkg.smoother, factory),
            coarse_operator=problem.coarsest_operator)
    else:
        entries = json.loads(CHAMPIONS.read_text())[CHAMPION_KEY]
        best = min(entries, key=lambda e: e["fitness_rho"])
        pset = pkg.mg.generate_primitive_set(
            problem.approximation, problem.rhs_entity,
            problem.level_contexts, problem.coarsest_operator)[0]
        cycle = pkg.gp.compile_tree(pkg.gp.parse_tree(best["grammar"], pset),
                                    pset)[0]
    pkg.trans.assign_cycle_ids(cycle)
    return problem, cycle


def _plan_rows(pkg, cycle):
    """The planned legs, by the cycle id of their outermost smoother:
    (leg, sweeps, red-black, signature kind, signature)."""
    by_smoother, _ = pkg.lower._plan_super_fusions(cycle)
    rows = {}
    for leg, plans in (("down", by_smoother),
                       ("up", pkg.lower._plan_post_fusions(cycle))):
        for plan in plans.values():
            if pkg is JAX:
                sig = plan["sig"]
                red_black = plan["partitioning"] is jpart.RedBlack
            else:
                sig = (plan["kind"], plan["vals"])
                red_black = plan["red_black"]
            rows[(leg, plan["sweeps"][0].global_id)] = (
                len(plan["sweeps"]), red_black, sig)
    return rows


@pytest.mark.parametrize("key", STRUCTURES)
def test_planned_legs_match_jax(key):
    """_plan_super_fusions and _plan_post_fusions find the same legs in
    both packages: the same outermost smoothers, numbers of sweeps,
    partitionings and sys9 signatures.  The port plans only the chains its
    legs take (the JAX planner also keeps constant Jacobi chains, which no
    leg runs; elasticity has none)."""
    rows_j = _plan_rows(JAX, _structure(JAX, key)[1])
    rows_t = _plan_rows(PORT, _structure(PORT, key)[1])
    assert rows_t == rows_j
    assert rows_j and {r[2][0] for r in rows_j.values()} == {"sys9"}


# ---------------------------------------------------------------------------
# dispatch: which kernels one cycle step reaches
# ---------------------------------------------------------------------------

NAMES = ("fused_rbgs_sweep_sys", "jacobi_sweep_sys",
         "presmooth_residual_restrict_sys", "prolong_correct_postsmooth_sys")
#: what one step at 255^2 (levels 8 -> 4) reaches: only 255^2 passes the
#: gates; a V(4,4) leaves one pre- and one post-sweep to the standalone
#: sweep beside legs of 3 sweeps
EXPECTED = {
    "rb_v21": {"presmooth_residual_restrict_sys": 1,
               "prolong_correct_postsmooth_sys": 1},
    "jacobi_v21": {"presmooth_residual_restrict_sys": 1,
                   "prolong_correct_postsmooth_sys": 1},
    "rb_v44": {"presmooth_residual_restrict_sys": 1,
               "prolong_correct_postsmooth_sys": 1,
               "fused_rbgs_sweep_sys": 2},
    "jacobi_v44": {"presmooth_residual_restrict_sys": 1,
                   "prolong_correct_postsmooth_sys": 1,
                   "jacobi_sweep_sys": 2},
    "decoupled_rb_v21": {"presmooth_residual_restrict_sys": 1,
                         "prolong_correct_postsmooth_sys": 1},
    "gen25_0": {"presmooth_residual_restrict_sys": 1,
                "prolong_correct_postsmooth_sys": 1,
                "fused_rbgs_sweep_sys": 1},
}


def _count(monkeypatch, calls, module, name):
    fn = getattr(module, name)

    def counted(*a, **k):
        calls[name.replace("_plain", "")] += 1
        return fn(*a, **k)
    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("key", STRUCTURES)
def test_step_dispatch_matches_jax(monkeypatch, key):
    """One step of each structure at 255^2 in float32 reaches the same
    system kernels, as often, in both packages: the Pallas entry points in
    the JAX lowering (traced with ``jax.eval_shape``, which counts the calls
    without compiling them), the plain versions in the port, which runs the
    step; no other kernel of the port runs."""
    jax_calls, port_calls = collections.Counter(), collections.Counter()
    for name in NAMES:
        _count(monkeypatch, jax_calls, prs, name)
        _count(monkeypatch, port_calls, trs, name + "_plain")
    monkeypatch.setattr(config, "use_pallas_kernels", True)
    other = collections.Counter()
    for mod, names in ((trbgs, ("fused_rbgs_sweep_plain", "sweep_plain")),
                       (trv, ("fused_rbgs_sweep_var_plain",
                              "jacobi_sweep_var_plain",
                              "presmooth_residual_restrict_var_plain",
                              "prolong_correct_postsmooth_var_plain")),
                       (ttransfer, ("presmooth_residual_restrict_plain",
                                    "prolong_correct_postsmooth_col_plain",
                                    "residual_restrict_plain",
                                    "prolong_correct_plain"))):
        for name in names:
            _count(monkeypatch, other, mod, name)

    pj, cj = _structure(JAX, key)
    pt, ct = _structure(PORT, key)
    lj = jlower.lower_cycle(cj, pj.approximation, pj.rhs_entity)
    lt = tlower.lower_cycle(ct, pt.approximation, pt.rhs_entity)
    np.testing.assert_array_equal(lt.default_omegas, lj.default_omegas)
    shape = tuple(pt.level_contexts[0].grid[0].size)
    spec = jax.ShapeDtypeStruct(shape, jnp.float32)
    out_j = jax.eval_shape(lj.step, (spec, spec), (spec, spec),
                           jax.ShapeDtypeStruct(lj.default_omegas.shape,
                                                jnp.float32))
    u, b, om = state_from_numpy(_fields(shape, 21), _fields(shape, 23),
                                lt.default_omegas, device="cpu",
                                dtype=torch.float32)
    out = lt.step(u, b, om)

    assert dict(jax_calls) == EXPECTED[key]
    assert port_calls == jax_calls
    assert not other
    assert [tuple(o.shape) for o in out] == [tuple(o.shape) for o in out_j]
    assert all(bool(torch.isfinite(o).all()) for o in out)


@pytest.mark.parametrize("key", STRUCTURES)
def test_generic_step_matches_jax_float64(monkeypatch, key):
    """One step of each structure in float64 with the kernels off on both
    sides: XLA in the JAX package, the plain versions (on 255^2) and the
    generic lowering (127^2 .. 31^2, with the constant F x F collective
    point inverse, and the dense 15^2 coarse solve) in the port.  The
    steps agree to 1e-12 of their largest value; they sum the stencil
    terms and the coarse matvec in different orders."""
    monkeypatch.setattr(config, "use_pallas_kernels", False)
    pj, cj = _structure(JAX, key, dtype=np.float64)
    pt, ct = _structure(PORT, key, dtype=np.float64)
    lj = jlower.lower_cycle(cj, pj.approximation, pj.rhs_entity)
    lt = tlower.lower_cycle(ct, pt.approximation, pt.rhs_entity,
                            use_kernels=False)
    shape = tuple(pt.level_contexts[0].grid[0].size)
    u0 = [np.random.default_rng(25 + k).standard_normal(shape)
          for k in range(2)]
    b0 = [np.asarray(x, np.float64) for x in pj.rhs_builder(jnp.float64)]
    ref = [np.asarray(r) for r in lj.step(
        tuple(jnp.asarray(x) for x in u0), tuple(jnp.asarray(x) for x in b0),
        jnp.asarray(lj.default_omegas))]
    u, b, om = state_from_numpy(u0, b0, lt.default_omegas, device="cpu",
                                dtype=torch.float64)
    out = lt.step(u, b, om)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float64 and r.dtype == np.float64
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=1e-12 * np.abs(r).max())


def test_varying_collective_inverse_names_its_slice():
    """The collective point inverse of a system whose central coefficients
    vary, which waited for the split-complex Helmholtz slice, now solves
    the 2 x 2 system of central coefficients at every point: numpy's
    solve of the same matrices, float64."""
    at = _operators(PORT)[-1]
    low = tlower._Lowering(None, None, None)
    low.set_like(torch.zeros(1, dtype=torch.float64))
    field_op = tbase.Operator("A00", at.entries[0][0].grid,
                              tgallery.Poisson2DVariableCoefficients())
    varying = tsystem.Operator("A", [[field_op, at.entries[0][1]],
                                     [at.entries[1][0], at.entries[1][1]]])
    shape = tuple(at.entries[0][0].grid.size)
    rng = np.random.default_rng(4)
    r = [rng.standard_normal(shape) for _ in range(2)]
    got = low.apply_inverse(tsystem.ElementwiseDiagonal(varying),
                            tuple(torch.from_numpy(x) for x in r))
    D = np.empty(shape + (2, 2))
    D[..., 0, 0] = tgallery.Poisson2DVariableCoefficients() \
        .generate_stencil_field(field_op.grid).diagonal_field()
    for i, j in ((0, 1), (1, 0), (1, 1)):
        D[..., i, j] = varying.entries[i][j].generate_stencil() \
            .value_at((0, 0))
    want = np.linalg.solve(D, np.stack(r, axis=-1)[..., None])[..., 0]
    for k, g in enumerate(got):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), want[..., k], rtol=1e-12,
                                   atol=0)
