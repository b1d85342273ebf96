"""The port's hand-built reference cycles (evostencils_tpu_torch/ir/
reference_cycles.py) and program listing (compiler/pretty.py) against the
JAX package's on the CPU.

Each of the four V(2,2) fixtures (linear and FAS, two and three grids, at
the sizes of tests/test_reference_cycles.py) is built by both packages:
the IR must be the same node for node, one float64 step from a seeded
start must agree to 1e-12, and the port's own solves must meet the JAX
tests' textbook bounds.  ``pretty_cycle`` must print the same listing as
the JAX package's for the fixtures, the red-black V(2,1), 40 seeded
``genGrow`` individuals at 511^2 and the stored
``poisson2d_1023sq_seeded_gen75`` champions.
"""

import json
import pathlib
import random
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.compiler import cycles as jcycles
from evostencils_tpu.compiler import lower as jlower
from evostencils_tpu.compiler import pretty as jpretty
from evostencils_tpu.grammar import gp as jgp
from evostencils_tpu.grammar import multigrid as jmg
from evostencils_tpu.ir import base as jbase
from evostencils_tpu.ir import partitioning as jpart
from evostencils_tpu.ir import reference_cycles as jref
from evostencils_tpu.ir import transformations as jtrans
from evostencils_tpu.problems import fas as jfas
from evostencils_tpu.problems import poisson as jpoisson
from evostencils_tpu_torch.compiler import cycles as tcycles
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.compiler import pretty as tpretty
from evostencils_tpu_torch.compiler import solve as tsolve
from evostencils_tpu_torch.grammar import gp as tgp
from evostencils_tpu_torch.grammar import multigrid as tmg
from evostencils_tpu_torch.ir import base as tbase
from evostencils_tpu_torch.ir import partitioning as tpart
from evostencils_tpu_torch.ir import reference_cycles as tref
from evostencils_tpu_torch.ir import transformations as ttrans
from evostencils_tpu_torch.problems import fas as tfas
from evostencils_tpu_torch.problems import poisson as tpoisson
from evostencils_tpu_torch.problems.poisson import build_rhs

from tests.test_torch_slice3d import _describe

JAX = SimpleNamespace(poisson=jpoisson, fas=jfas, ref=jref, base=jbase,
                      trans=jtrans, lower=jlower, pretty=jpretty,
                      cycles=jcycles, part=jpart, gp=jgp, mg=jmg)
PORT = SimpleNamespace(poisson=tpoisson, fas=tfas, ref=tref, base=tbase,
                       trans=ttrans, lower=tlower, pretty=tpretty,
                       cycles=tcycles, part=tpart, gp=tgp, mg=tmg)

#: fixture -> (problem family, max level, min level), the sizes of
#: tests/test_reference_cycles.py
FIXTURES = {"v22_two_grid": ("poisson", 6, 5),
            "v22_three_grid": ("poisson", 6, 4),
            "fas_v22_two_grid": ("fas", 5, 4),
            "fas_v22_three_grid": ("fas", 5, 3)}
#: one lowered float64 step, port against JAX, relative to max|JAX|
STEP_RTOL = 1e-12
ROOT = pathlib.Path(__file__).resolve().parents[1]
CHAMPIONS = json.loads((ROOT / "results" / "evolved_champions.json")
                       .read_text())["poisson2d_1023sq_seeded_gen75"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run's parallel workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def build_fixture(pkg, name, max_level=None, min_level=None):
    """``(problem, cycle)`` of fixture ``name`` from one package's layers,
    at FIXTURES' levels unless others are given."""
    family, hi, lo = FIXTURES[name]
    hi, lo = max_level or hi, min_level or lo
    if family == "poisson":
        problem = pkg.poisson.poisson_2d(max_level=hi, min_level=lo)
    else:
        problem = pkg.fas.fas_2d_basic(max_level=hi, min_level=lo)
    problem.dtype = np.float64
    levels = problem.level_contexts
    build = getattr(pkg.ref, f"generate_{name.replace('v22', 'v_22_cycle')}")
    if name.endswith("two_grid"):
        cycle = build(levels[0], problem.coarsest_operator,
                      problem.rhs_entity)
    else:
        cycle = build(levels[0], levels[1], problem.coarsest_operator,
                      problem.rhs_entity)
    return problem, cycle


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixture_ir_matches_jax(name):
    """Both packages build the same tree, node for node."""
    _, cj = build_fixture(JAX, name)
    _, ct = build_fixture(PORT, name)
    dj, dt = _describe(JAX, cj), _describe(PORT, ct)
    assert len(dt) == len(dj) > 10
    assert dt == dj


@pytest.mark.parametrize("name", list(FIXTURES))
def test_one_step_matches_jax(name):
    """One float64 step of each lowered fixture from a seeded start."""
    pj, cj = build_fixture(JAX, name)
    pt, ct = build_fixture(PORT, name)
    lj = jlower.lower_cycle(cj, pj.approximation, pj.rhs_entity)
    lt = tlower.lower_cycle(ct, pt.approximation, pt.rhs_entity)
    np.testing.assert_array_equal(lt.default_omegas, lj.default_omegas)
    bj = pj.build_rhs()
    bt = build_rhs(pt, dtype=torch.float64, device="cpu")
    u0 = np.random.default_rng(7).uniform(-1, 1, bj[0].shape)
    uj = lj.step((jnp.asarray(u0),), bj, jnp.asarray(lj.default_omegas))
    ut = lt.step((torch.from_numpy(u0),), bt,
                 torch.as_tensor(lt.default_omegas))
    want = np.asarray(uj[0])
    np.testing.assert_allclose(ut[0].numpy(), want, rtol=0,
                               atol=STEP_RTOL * np.abs(want).max())


def port_solve(name, max_iterations, target):
    """The port's float64 solve of fixture ``name`` from zero:
    (reduction, rho, iterations)."""
    problem, cycle = build_fixture(PORT, name)
    lowered = tlower.lower_cycle(cycle, problem.approximation,
                                 problem.rhs_entity)
    b = build_rhs(problem, dtype=torch.float64, device="cpu")
    run = tsolve.make_solver(lowered, max_iterations, target)
    _, k, hist = run(tuple(torch.zeros_like(x) for x in b), b,
                     torch.as_tensor(lowered.default_omegas))
    hist = hist.numpy()
    reduction = hist[k] / hist[0]
    return reduction, reduction ** (1.0 / max(k, 1)), k


@pytest.mark.parametrize("name,rho_max", [("v22_two_grid", 0.1),
                                          ("v22_three_grid", 0.12)])
def test_linear_fixture_textbook_rho(name, rho_max):
    """The bounds of tests/test_reference_cycles.py:30-51: RB-GS V(2,2)
    to 1e-12 within 60 cycles, rho under 0.1 (two grids) and 0.12
    (three)."""
    reduction, rho, _ = port_solve(name, 60, 1e-12)
    assert reduction <= 1e-12
    assert rho < rho_max


@pytest.mark.parametrize("name", ["fas_v22_two_grid", "fas_v22_three_grid"])
def test_fas_fixture_converges(name):
    """The FAS fixtures reach 1e-10 within 80 cycles
    (tests/test_reference_cycles.py:54-75)."""
    reduction, _, k = port_solve(name, 80, 1e-10)
    assert reduction <= 1e-10 and k < 80


# -- the program listing -----------------------------------------------------

@pytest.mark.parametrize("name", list(FIXTURES))
def test_pretty_fixture_matches_jax(name):
    text = tpretty.pretty_cycle(build_fixture(PORT, name)[1])
    assert text == jpretty.pretty_cycle(build_fixture(JAX, name)[1])
    lines = text.splitlines()
    assert lines[0].startswith("gen_mgCycle@")
    assert lines[-1].strip().startswith("return u")


def test_pretty_red_black_v21_matches_jax():
    """The red-black V(2,1) of tests/test_pretty.py's second case, with
    its levels and colouring."""
    texts = []
    for pkg in (JAX, PORT):
        p = pkg.poisson.poisson_2d(max_level=6, min_level=4)
        cycle = pkg.cycles.v_cycle(
            p.level_contexts, p.rhs_entity, pre_smoothing=2,
            post_smoothing=1, omega=1.15, partitioning=pkg.part.RedBlack,
            coarse_operator=p.coarsest_operator)
        texts.append(pkg.pretty.pretty_cycle(cycle))
    assert texts[1] == texts[0]
    assert "red_black" in texts[1] and "CGS(" in texts[1]
    assert texts[1].count("update @ level 6") >= 3


def _psets(max_level, min_level):
    out = []
    for pkg in (JAX, PORT):
        problem = pkg.poisson.poisson_2d(max_level=max_level,
                                         min_level=min_level)
        out.append(pkg.mg.generate_primitive_set(
            problem.approximation, problem.rhs_entity,
            problem.level_contexts, problem.coarsest_operator)[0])
    return out


@pytest.fixture(scope="module")
def psets_511():
    return _psets(9, 5)


@pytest.fixture(scope="module")
def psets_1023():
    return _psets(10, 5)


def _listings(psets, make):
    """``pretty_cycle`` of the tree ``make(pkg, pset)`` grows, compiled by
    each package: (JAX's listing, the port's)."""
    out = []
    for pkg, pset in zip((JAX, PORT), psets):
        ind = make(pkg, pset)
        expr = pkg.gp.compile_tree(ind, pset)[0]
        pkg.trans.assign_cycle_ids(expr)
        out.append((str(ind), pkg.pretty.pretty_cycle(expr)))
    (sj, tj), (st, tt) = out
    assert st == sj
    return tj, tt


@pytest.mark.parametrize("seed", range(40))
def test_pretty_gen_grow_matches_jax(psets_511, seed):
    """genGrow individuals of the 511^2 grammar (levels 9 -> 5)."""
    tj, tt = _listings(psets_511, lambda pkg, pset: pkg.gp.genGrow(
        pset, 2, 40, rng=random.Random(seed)))
    assert tt == tj


@pytest.mark.parametrize("index", range(len(CHAMPIONS)))
def test_pretty_champion_matches_jax(psets_1023, index):
    """The stored poisson2d_1023sq_seeded_gen75 champions (levels
    10 -> 5)."""
    string = CHAMPIONS[index]["grammar"]
    tj, tt = _listings(psets_1023,
                       lambda pkg, pset: pkg.gp.parse_tree(string, pset))
    assert tt == tj
    assert "level 10" in tt
