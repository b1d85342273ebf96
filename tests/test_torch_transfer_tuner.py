"""The port's transfer-weight tuner (evostencils_tpu_torch/ops/
transfer_weights.py, optimization/{cma,intergrid_transfer}.py) against the
JAX package's on the CPU, in float64.

The CMA-ES ask/tell stream is bitwise the JAX package's; the weighted
transfers agree to 1e-12 and a batch equals its members one by one; the
batched two-grid objective agrees with the JAX package's
``jax.vmap(cgc_rho)`` on the same initial error to 1e-10; the JAX test's
whole run (tests/test_intergrid_transfer.py) gives the same history and
best weights, and its tuned IR nodes lower in the port.  The JAX
package's tuner builds its default 3D weight boxes with a two-argument
``np.multiply.outer`` and stops there, so in 3D its objective is taken
before that point (``_jax_objective``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from evostencils_tpu.compiler import lower as jlower
from evostencils_tpu.ir import reference_cycles as jref
from evostencils_tpu.ops import transfer_weights as jtw
from evostencils_tpu.optimization import cma as jcma
from evostencils_tpu.optimization import intergrid_transfer as jit_
from evostencils_tpu.problems import poisson as jpoisson
from evostencils_tpu_torch.compiler import lower as tlower
from evostencils_tpu_torch.compiler import solve as tsolve
from evostencils_tpu_torch.ir import reference_cycles as tref
from evostencils_tpu_torch.ops import transfer_weights as ttw
from evostencils_tpu_torch.optimization import cma as tcma
from evostencils_tpu_torch.optimization import intergrid_transfer as tit
from evostencils_tpu_torch.problems import poisson as tpoisson
from evostencils_tpu_torch.problems.poisson import build_rhs

#: the transfers and one lowered step, port against JAX
TRANSFER_RTOL = 1e-12
#: the batched objective on the same weights and initial error
OBJECTIVE_RTOL = 1e-10
#: a whole run's history (min and avg per generation) and best weights
RUN_TOL = 1e-9
#: the JAX test's run (tests/test_intergrid_transfer.py:52-56)
JAX_RUN = dict(generations=15, operator_range=1, smoothing_steps=1,
               measure_iterations=8, seed=2)
#: a short run of each other operator form
SHORT_RUN = dict(generations=4, smoothing_steps=1, measure_iterations=6,
                 seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run's parallel workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problems(name, max_level, min_level):
    return (getattr(jpoisson, name)(max_level=max_level, min_level=min_level),
            getattr(tpoisson, name)(max_level=max_level, min_level=min_level))


def _jax_e0(problem, seed):
    """The JAX tuner's initial error (intergrid_transfer.py:134-136)."""
    shape = tuple(problem.level_contexts[0].grid[0].size)
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        dtype=jnp.float64))


def _jax_objective(problem, monkeypatch, **kw):
    """The JAX tuner's ``jax.jit(jax.vmap(cgc_rho))``, recorded as the
    tuner builds it (intergrid_transfer.py:147); in 3D the tuner stops
    at its default weights, after the objective exists."""
    recorded = []
    real_jit = jax.jit

    def recording_jit(fn, *args, **kwargs):
        recorded.append(fn)
        return real_jit(fn, *args, **kwargs)
    monkeypatch.setattr(jax, "jit", recording_jit)
    try:
        jit_.optimize(problem, generations=0, **kw)
    except TypeError:
        assert problem.dimension == 3
    monkeypatch.setattr(jax, "jit", real_jit)
    return real_jit(recorded[-1])


# -- CMA-ES ------------------------------------------------------------------

@pytest.mark.parametrize("n,lambda_,seed", [(6, None, 1), (18, None, 2),
                                            (54, 12, 0)])
def test_cma_stream_is_bitwise_jax(n, lambda_, seed):
    """The same centroid, sigma and seed give bitwise the same samples,
    mean, step size and covariance over 25 generations of a shifted
    sphere."""
    centroid = np.linspace(-1.0, 2.0, n)
    ej = jcma.CMAES(centroid, sigma=0.3, lambda_=lambda_, seed=seed)
    et = tcma.CMAES(centroid, sigma=0.3, lambda_=lambda_, seed=seed)
    for _ in range(25):
        pj, pt = ej.ask(), et.ask()
        np.testing.assert_array_equal(pt, pj)
        fit = ((pj - 0.5) ** 2).sum(axis=1)
        ej.tell(pj, fit)
        et.tell(pt, fit)
        np.testing.assert_array_equal(et.mean, ej.mean)
        np.testing.assert_array_equal(et.C, ej.C)
        assert et.sigma == ej.sigma


def test_cma_minimizes_sphere():
    """tests/test_intergrid_transfer.py:21-26 on the port's copy."""
    es = tcma.CMAES([3.0] * 6, sigma=1.0, seed=1)
    for _ in range(100):
        pop = es.ask()
        es.tell(pop, (pop ** 2).sum(axis=1))
    assert float((es.mean ** 2).sum()) < 1e-6


# -- the weighted transfers --------------------------------------------------

@pytest.mark.parametrize("n,dim,radius", [(31, 2, 1), (31, 2, 2),
                                          (15, 3, 1), (15, 3, 2)])
def test_weighted_transfers_match_jax(n, dim, radius):
    """A batch of 4 random kernels on 4 random fields at 31^2 and 15^3:
    each member against the JAX functions, and the batch against its
    members one at a time."""
    rng = np.random.default_rng(n + dim + radius)
    batch, width = 4, 2 * radius + 1
    fine = (n,) * dim
    coarse = ((n - 1) // 2,) * dim
    u = rng.standard_normal((batch,) + fine)
    uc = rng.standard_normal((batch,) + coarse)
    wr = rng.uniform(-0.5, 1.0, (batch,) + (width,) * dim)
    wp = rng.uniform(-0.5, 1.0, (batch,) + (width,) * dim)
    got_r = ttw.restrict_weighted(torch.from_numpy(u), torch.from_numpy(wr))
    got_p = ttw.prolong_weighted(torch.from_numpy(uc), torch.from_numpy(wp),
                                 fine)
    assert got_r.shape == (batch,) + coarse
    assert got_p.shape == (batch,) + fine
    for k in range(batch):
        want_r = np.asarray(jtw.restrict_weighted(jnp.asarray(u[k]),
                                                  jnp.asarray(wr[k])))
        want_p = np.asarray(jtw.prolong_weighted(jnp.asarray(uc[k]),
                                                 jnp.asarray(wp[k]), fine))
        np.testing.assert_allclose(got_r[k].numpy(), want_r, rtol=0,
                                   atol=TRANSFER_RTOL * np.abs(want_r).max())
        np.testing.assert_allclose(got_p[k].numpy(), want_p, rtol=0,
                                   atol=TRANSFER_RTOL * np.abs(want_p).max())
        one_r = ttw.restrict_weighted(torch.from_numpy(u[k:k + 1]),
                                      torch.from_numpy(wr[k:k + 1]))
        one_p = ttw.prolong_weighted(torch.from_numpy(uc[k:k + 1]),
                                     torch.from_numpy(wp[k:k + 1]), fine)
        np.testing.assert_allclose(one_r[0].numpy(), got_r[k].numpy(),
                                   rtol=0, atol=1e-15 * np.abs(want_r).max())
        np.testing.assert_allclose(one_p[0].numpy(), got_p[k].numpy(),
                                   rtol=0, atol=1e-15 * np.abs(want_p).max())


def test_radius_zero_kernel_raises():
    with pytest.raises(ValueError, match="radius"):
        ttw.restrict_weighted(torch.zeros(1, 7, 7), torch.ones(1, 1, 1))


# -- the batched objective ---------------------------------------------------

@pytest.mark.parametrize("name,levels", [("poisson_2d", (5, 4)),
                                         ("poisson_2d_variable", (5, 4)),
                                         ("poisson_3d", (4, 3))])
def test_batched_objective_matches_jax(name, levels, monkeypatch):
    """8 weight vectors (the default pair and 7 perturbations of it) in
    one batch against the JAX package's vmapped objective, both from
    JAX's initial error; each member alone gives the same value."""
    pj, pt = _problems(name, *levels)
    kw = dict(smoothing_steps=1, measure_iterations=8, seed=3)
    batched = _jax_objective(pj, monkeypatch, **kw)
    objective = tit.TransferObjective(pt, initial_error=_jax_e0(pj, 3),
                                      **kw)
    default = objective.default_weights()
    rng = np.random.default_rng(11)
    weights = default + np.concatenate(
        [np.zeros((1, default.size)),
         0.05 * rng.standard_normal((7, default.size))])
    want = np.asarray(batched(jnp.asarray(weights)))
    got = objective(weights)
    np.testing.assert_allclose(got, want, rtol=OBJECTIVE_RTOL)
    assert np.all(np.isfinite(got)) and got[0] < 1
    one = np.concatenate([objective(weights[k:k + 1]) for k in range(8)])
    np.testing.assert_allclose(one, got, rtol=1e-13)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_non_finite_member_scores_1e100(dtype):
    """A member whose error blows up scores 1e100, as in JAX
    (intergrid_transfer.py:145), and leaves the others alone; in float32
    too."""
    _, pt = _problems("poisson_2d", 5, 4)
    objective = tit.TransferObjective(pt, measure_iterations=8, dtype=dtype)
    default = objective.default_weights()
    weights = np.stack([default, default * 1e160])
    got = objective(weights)
    assert got[1] == 1e100 and 0 < got[0] < 1


# -- whole runs --------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run_results():
    """The JAX test's run in both packages, from JAX's initial error."""
    pj, pt = _problems("poisson_2d", 5, 4)
    rj = jit_.optimize(pj, **JAX_RUN)
    rt = tit.optimize(pt, device="cpu", initial_error=_jax_e0(pj, 2),
                      **JAX_RUN)
    return rj, rt


def test_run_matches_jax(jax_run_results):
    rj, rt = jax_run_results
    assert len(rt.history) == len(rj.history) == 15
    for a, b in zip(rt.history, rj.history):
        assert a["gen"] == b["gen"]
        assert a["min"] == pytest.approx(b["min"], rel=RUN_TOL)
        assert a["avg"] == pytest.approx(b["avg"], rel=RUN_TOL)
    np.testing.assert_allclose(rt.weights, rj.weights, rtol=0, atol=RUN_TOL)
    assert rt.convergence_factor == pytest.approx(rj.convergence_factor,
                                                  rel=RUN_TOL)
    assert rt.default_convergence_factor == pytest.approx(
        rj.default_convergence_factor, rel=RUN_TOL)
    # the JAX test's own checks
    assert rt.convergence_factor <= rt.default_convergence_factor
    assert rt.convergence_factor < 0.7


def test_tuned_nodes_match_jax(jax_run_results):
    """The tuned Restriction/Prolongation nodes: names, grids and stencil
    entries equal the JAX package's entry for entry."""
    rj, rt = jax_run_results
    for nj, nt in ((rj.restriction, rt.restriction),
                   (rj.prolongation, rt.prolongation)):
        ej, et = nj.entries[0][0], nt.entries[0][0]
        assert (nt.name, type(et).__name__) == (nj.name, type(ej).__name__)
        assert tuple(et.fine_grid.size) == tuple(ej.fine_grid.size)
        assert tuple(et.coarse_grid.size) == tuple(ej.coarse_grid.size)
        sj, st = ej.generate_stencil(), et.generate_stencil()
        assert st.dimension == 2 and st.number_of_entries == 9
        assert st.entries == sj.entries


def _tuned_two_grid(pkg_poisson, ref, result):
    """The V(2,2) two-grid fixture of poisson_2d(5, 4) with the tuned
    transfers in its fine level context."""
    problem = pkg_poisson.poisson_2d(max_level=5, min_level=4)
    problem.dtype = np.float64
    fine = dataclasses.replace(problem.level_contexts[0],
                               restriction=result.restriction,
                               prolongation=result.prolongation)
    return problem, ref.generate_v_22_cycle_two_grid(
        fine, problem.coarsest_operator, problem.rhs_entity)


def test_tuned_nodes_lower_in_the_port(jax_run_results):
    """A two-grid V(2,2) with the tuned transfers lowers in the port: one
    float64 step equals the JAX package's with JAX's tuned nodes, and the
    port's solve reaches 1e-10."""
    rj, rt = jax_run_results
    pj, cj = _tuned_two_grid(jpoisson, jref, rj)
    pt, ct = _tuned_two_grid(tpoisson, tref, rt)
    lj = jlower.lower_cycle(cj, pj.approximation, pj.rhs_entity)
    lt = tlower.lower_cycle(ct, pt.approximation, pt.rhs_entity)
    bj = pj.build_rhs()
    bt = build_rhs(pt, dtype=torch.float64, device="cpu")
    u0 = np.random.default_rng(5).uniform(-1, 1, bj[0].shape)
    want = np.asarray(lj.step((jnp.asarray(u0),), bj,
                              jnp.asarray(lj.default_omegas))[0])
    got = lt.step((torch.from_numpy(u0),), bt,
                  torch.as_tensor(lt.default_omegas))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TRANSFER_RTOL * np.abs(want).max())
    run = tsolve.make_solver(lt, 60, 1e-10)
    _, k, hist = run(tuple(torch.zeros_like(x) for x in bt), bt,
                     torch.as_tensor(lt.default_omegas))
    assert k < 60 and hist[k] <= 1e-10 * hist[0]


def test_variable_coefficient_run_matches_jax():
    """A short run on poisson_2d_variable (the StencilField operator and
    its dense coarse matrix) against the JAX package's."""
    pj, pt = _problems("poisson_2d_variable", 5, 4)
    rj = jit_.optimize(pj, **SHORT_RUN)
    rt = tit.optimize(pt, device="cpu", initial_error=_jax_e0(pj, 0),
                      **SHORT_RUN)
    for a, b in zip(rt.history, rj.history):
        assert a["min"] == pytest.approx(b["min"], rel=RUN_TOL)
        assert a["avg"] == pytest.approx(b["avg"], rel=RUN_TOL)
    np.testing.assert_allclose(rt.weights, rj.weights, rtol=0, atol=RUN_TOL)
    assert rt.convergence_factor <= rt.default_convergence_factor < 1


def test_3d_run_on_its_own_draw():
    """A short 3D run (poisson_3d(4, 3): 15^3 over 7^3) from the port's
    own seeded draw: 27-entry boxes, tuned no worse than the default."""
    _, pt = _problems("poisson_3d", 4, 3)
    rt = tit.optimize(pt, device="cpu", **SHORT_RUN)
    assert len(rt.history) == SHORT_RUN["generations"]
    assert np.isfinite(rt.convergence_factor)
    assert rt.convergence_factor <= rt.default_convergence_factor < 1
    st = rt.restriction.entries[0][0].generate_stencil()
    assert st.dimension == 3 and st.number_of_entries == 27
    again = tit.optimize(pt, device="cpu", **SHORT_RUN)
    assert again.history == rt.history


def test_default_device_is_the_card():
    """With no device the tuner asks for the card, and says so where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, pt = _problems("poisson_2d", 5, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tit.optimize(pt, generations=1)
