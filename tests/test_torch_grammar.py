"""The port's copies of the grammar (evostencils_tpu_torch/grammar) against
the JAX package's: the same seeded random streams grow, vary and parse the
same trees, and a tree compiles to the same cycle IR node for node.

Each package builds its own problem and primitive set.
"""

import json
import pathlib
import random

import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.grammar import gp as jgp
from evostencils_tpu.grammar import multigrid as jmg
from evostencils_tpu.grammar import seeds as jseeds
from evostencils_tpu.problems import poisson as jpoisson
from evostencils_tpu_torch.grammar import gp as tgp
from evostencils_tpu_torch.grammar import multigrid as tmg
from evostencils_tpu_torch.grammar import seeds as tseeds
from evostencils_tpu_torch.problems import poisson as tpoisson

from tests.test_torch_slice3d import JAX, PORT, _describe

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHAMPIONS = json.loads((ROOT / "results" / "evolved_champions.json")
                       .read_text())
POISSON2D = sorted(k for k in CHAMPIONS if k.startswith("poisson2d_"))


def _psets(max_level, min_level):
    out = []
    for poisson, mg in ((jpoisson, jmg), (tpoisson, tmg)):
        problem = poisson.poisson_2d(max_level=max_level, min_level=min_level)
        out.append(mg.generate_primitive_set(
            problem.approximation, problem.rhs_entity,
            problem.level_contexts, problem.coarsest_operator)[0])
    return out


@pytest.fixture(scope="module")
def psets_255():
    return _psets(8, 5)


@pytest.fixture(scope="module")
def psets_1023():
    return _psets(10, 5)


def test_psets_have_the_same_productions(psets_255):
    psj, pst = psets_255
    for kind in ("primitives", "terminals"):
        pj, pt = getattr(psj, kind), getattr(pst, kind)
        assert sorted(map(repr, pj)) == sorted(map(repr, pt))
        for tj, tt in zip(sorted(pj, key=repr), sorted(pt, key=repr)):
            assert [n.name for n in pj[tj]] == [n.name for n in pt[tt]]


@pytest.mark.parametrize("seed", range(12))
def test_gen_grow_same_string(psets_255, seed):
    psj, pst = psets_255
    a = jgp.genGrow(psj, 2, 40, rng=random.Random(seed))
    b = tgp.genGrow(pst, 2, 40, rng=random.Random(seed))
    assert str(b) == str(a)


@pytest.mark.parametrize("seed", range(4))
def test_variation_same_string(psets_255, seed):
    """Crossover, node replacement and subtree mutation draw the same
    random stream in both packages."""
    psj, pst = psets_255
    rj, rt = random.Random(seed), random.Random(seed)
    j1, j2 = (jgp.genGrow(psj, 2, 10, rng=rj) for _ in range(2))
    t1, t2 = (tgp.genGrow(pst, 2, 10, rng=rt) for _ in range(2))
    j1, j2 = jgp.cxOnePoint(j1, j2, rng=rj)
    t1, t2 = tgp.cxOnePoint(t1, t2, rng=rt)
    assert (str(t1), str(t2)) == (str(j1), str(j2))
    (j1,) = jgp.mutNodeReplacement(j1, psj, rng=rj)
    (t1,) = tgp.mutNodeReplacement(t1, pst, rng=rt)
    assert str(t1) == str(j1)
    (j2,) = jgp.mutate_subtree(j2, 1, 4, psj, rng=rj)
    (t2,) = tgp.mutate_subtree(t2, 1, 4, pst, rng=rt)
    assert str(t2) == str(j2)


def _compiled_rows(pkg, gp, pset, string):
    ind = gp.parse_tree(string, pset)
    assert str(ind) == string
    return _describe(pkg, gp.compile_tree(ind, pset)[0])


def _champions():
    return [(key, i) for key in POISSON2D
            for i in range(len(CHAMPIONS[key]))]


@pytest.mark.parametrize("key,index", _champions())
def test_champion_compiles_to_the_same_tree(psets_1023, key, index):
    """Every stored 2D Poisson champion (1023^2, levels 10 -> 5) parses
    with the port's primitive set, and its compiled cycle equals the JAX
    package's node for node."""
    psj, pst = psets_1023
    string = CHAMPIONS[key][index]["grammar"]
    dj = _compiled_rows(JAX, jgp, psj, string)
    dt = _compiled_rows(PORT, tgp, pst, string)
    assert len(dt) == len(dj) > 20
    for a, b in zip(dt, dj):
        assert a == b


def test_seeded_v_cycle_string(psets_255):
    """The seeded V(2,1) individual of grammar/seeds.py is the same string
    and compiles to the same tree in both packages."""
    psj, pst = psets_255
    sj = jseeds.v_cycle_string(3, 8)
    assert tseeds.v_cycle_string(3, 8) == sj
    dj = _compiled_rows(JAX, jgp, psj, sj)
    dt = _compiled_rows(PORT, tgp, pst, sj)
    assert dt == dj
