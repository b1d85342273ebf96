"""The port's 3D path, the Poisson V(2,1) cycle (evostencils_tpu_torch
lowering with the ops/kernels/wavefront3d legs), against the JAX package
on the CPU; and the port's copies of the IR layers against the originals.

Each package builds its own problem and cycle IR and lowers it.  Levels
the wavefront gate admits (at least 63 points on axis 2) run the fused
legs: the Pallas kernels in interpret mode on the JAX side, their plain
PyTorch versions in the port.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from evostencils_tpu.compiler import cycles as jcycles
from evostencils_tpu.compiler import lower as jlower
from evostencils_tpu.compiler import solve as jsolve
from evostencils_tpu.config import config
from evostencils_tpu.ir import base as jbase
from evostencils_tpu.ir import partitioning as jpart
from evostencils_tpu.ir import transformations as jtrans
from evostencils_tpu.problems import poisson as jpoisson
from evostencils_tpu_torch.compiler import cycles as tcycles
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.compiler import solve as tsolve
from evostencils_tpu_torch.convert import state_from_numpy
from evostencils_tpu_torch.ir import base as tbase
from evostencils_tpu_torch.ir import partitioning as tpart
from evostencils_tpu_torch.ir import transformations as ttrans
from evostencils_tpu_torch.ops.kernels import wavefront3d as tw
from evostencils_tpu_torch.problems import poisson as tpoisson
from evostencils_tpu_torch.problems.poisson import build_rhs

#: the layers each package builds its own problem and cycle IR from
JAX = SimpleNamespace(problems=jpoisson, cycles=jcycles, part=jpart,
                      base=jbase, trans=jtrans)
PORT = SimpleNamespace(problems=tpoisson, cycles=tcycles, part=tpart,
                       base=tbase, trans=ttrans)


def _v21(pkg, dim, max_level, min_level, dtype=np.float64):
    """A fresh problem and its V(2,1) cycle, as scripts/bench_suite.py
    builds the poisson3d row, from the layers of one package."""
    build = pkg.problems.poisson_2d if dim == 2 else pkg.problems.poisson_3d
    problem = build(max_level=max_level, min_level=min_level)
    problem.dtype = dtype
    cycle = pkg.cycles.v_cycle(
        problem.level_contexts, problem.rhs_entity, pre_smoothing=2,
        post_smoothing=1, omega=1.15, partitioning=pkg.part.RedBlack,
        coarse_operator=problem.coarsest_operator)
    return problem, cycle


def _lower_both(max_level, min_level, dtype):
    pj, cj = _v21(JAX, 3, max_level, min_level, dtype)
    pt, ct = _v21(PORT, 3, max_level, min_level, dtype)
    lj = jlower.lower_cycle(cj, pj.approximation, pj.rhs_entity)
    lt = tlower.lower_cycle(ct, pt.approximation, pt.rhs_entity)
    np.testing.assert_array_equal(lt.default_omegas, lj.default_omegas)
    return pj, lj, pt, lt


def test_step_matches_pallas_interpret_f32(monkeypatch):
    """One V(2,1) step at 63^3 in float32 against the JAX step with the
    wavefront kernels (interpret mode); atol 2e-5 as
    tests/test_wavefront3d.py grants that path.  The 63^3 level runs each
    plain leg exactly once; 31^3 and below run the generic lowering."""
    pj, lj, pt, lt = _lower_both(6, 3, np.float32)
    b = pj.build_rhs()
    u0 = tuple(jnp.zeros_like(x) for x in b)
    old = config.use_pallas_kernels
    config.use_pallas_kernels = True
    try:
        ref = lj.step(u0, b, jnp.asarray(lj.default_omegas, jnp.float32))
    finally:
        config.use_pallas_kernels = old

    calls = {"down": 0, "up": 0}
    down, up = tw.downleg_wavefront_3d_plain, tw.upleg_wavefront_3d_plain

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tw, "downleg_wavefront_3d_plain", count("down", down))
    monkeypatch.setattr(tw, "upleg_wavefront_3d_plain", count("up", up))
    u, bt, om = state_from_numpy([np.asarray(x) for x in u0],
                                 [np.asarray(x) for x in b],
                                 lj.default_omegas, device="cpu",
                                 dtype=torch.float32)
    out = lt.step(u, bt, om)
    assert calls == {"down": 1, "up": 1}
    assert out[0].dtype == torch.float32
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=2e-5)
    assert float(out[0].abs().max()) > 0


@pytest.mark.parametrize("max_level", [5, 6])
def test_solve_matches_xla_f64(max_level):
    """Solve to 1e-10 in float64 at 31^3 and 63^3 (min level 2) against
    the JAX XLA path: equal iteration counts, histories and rho to rtol
    1e-6 above an absolute floor of 1e-15 * ||b||, as in 2D
    (tests/test_torch_slice.py).  At 63^3 the port runs its plain legs,
    whose premultiplied update differs from the XLA half-sweep at
    rounding level."""
    pj, lj, pt, lt = _lower_both(max_level, 2, np.float64)
    b = pj.build_rhs()
    u0 = tuple(jnp.zeros_like(x) for x in b)
    old = config.use_pallas_kernels
    config.use_pallas_kernels = False
    try:
        _, kj, hj = jsolve.make_solver(lj, 30, 1e-10)(
            u0, b, jnp.asarray(lj.default_omegas))
        kj, hj = int(kj), np.asarray(hj)
    finally:
        config.use_pallas_kernels = old

    bt = build_rhs(pt, dtype=torch.float64, device="cpu")
    ut = tuple(torch.zeros_like(x) for x in bt)
    om = torch.tensor(lt.default_omegas, dtype=torch.float64)
    _, kt, ht = tsolve.make_solver(lt, 30, 1e-10)(ut, bt, om)
    ht = ht.numpy()
    assert kt == kj and 0 < kt < 30
    np.testing.assert_allclose(ht, hj, rtol=1e-6, atol=1e-15 * hj[0])
    # rho = (h_k / h_0)^(1/k) carries the history's tolerance at its last
    # entry, divided by k: at 63^3 h_k is 1.6e-11 * ||b||, where the floor
    # of 1e-15 * ||b|| is 6e-5 of h_k and 7e-6 of rho over k = 9 cycles
    rho_t = (ht[kt] / ht[0]) ** (1 / kt)
    rho_j = (hj[kj] / hj[0]) ** (1 / kj)
    rho_tol = 1e-6 + 1e-15 * hj[0] / hj[kj] / kj
    assert abs(rho_t - rho_j) <= rho_tol * rho_j


def test_build_rhs_3d_bitwise_f64():
    """The port's 3D right-hand side (Dirichlet data folded in, RHS_u = 0)
    equals the JAX problem.build_rhs() bitwise."""
    ref = np.asarray(jpoisson.poisson_3d(max_level=5, min_level=2)
                     .build_rhs()[0])
    problem = tpoisson.poisson_3d(max_level=5, min_level=2)
    out = build_rhs(problem, dtype=torch.float64, device="cpu")[0].numpy()
    assert out.dtype == ref.dtype and np.abs(ref).max() > 0
    np.testing.assert_array_equal(out, ref)


def _describe(pkg, root):
    """The cycle DAG in visit order, one tuple per unique node: type name,
    grid sizes, stencil entries, relaxation factor and cycle id,
    partitioning, and the positions of its children."""
    pkg.trans.assign_cycle_ids(root)
    order, rows = {}, []

    def visit(e):
        if id(e) in order:
            return order[id(e)]
        order[id(e)] = len(order)
        row = [type(e).__name__]
        g = getattr(e, "grid", None)
        grids = g if isinstance(g, list) else [g]
        row.append(tuple(tuple(x.size) if x is not None else None
                         for x in grids))
        st = None
        if isinstance(e, pkg.base.Operator):
            st = e.generate_stencil()
        row.append(tuple(st.entries) if st is not None and
                   hasattr(st, "entries") else None)
        if isinstance(e, pkg.base.Cycle):
            row += [float(e.relaxation_factor), e.global_id,
                    getattr(e.partitioning, "__name__", None)]
        slot = len(rows)
        rows.append(None)
        row.append(tuple(visit(c) for c in e.children))
        rows[slot] = tuple(row)
        return order[id(e)]

    visit(root)
    return rows


@pytest.mark.parametrize("dim", [2, 3])
def test_ir_matches_jax_package(dim):
    """The port's copies of grids, stencils, ir and compiler.cycles build
    the same V(2,1) tree as the JAX package, node for node."""
    levels = (8, 5) if dim == 2 else (6, 2)
    _, cj = _v21(JAX, dim, *levels)
    _, ct = _v21(PORT, dim, *levels)
    dj, dt = _describe(JAX, cj), _describe(PORT, ct)
    assert len(dt) == len(dj) > 20
    for a, b in zip(dt, dj):
        assert a == b
