"""CMA-ES tuning of restriction/prolongation stencil weights (counterpart
of evostencils_tpu/optimization/intergrid_transfer.py:37-203).

The reference's transfer-operator weight optimization (reference
optimization/intergrid_transfer.py:10-144) generates one parametrized C++
solver, then *recompiles the C++ for every CMA candidate* and measures the
convergence factor.  Here the transfer weights are tensors with a leading
batch axis (ops/transfer_weights.py) and each CMA generation runs as one
batched program on the device, with one read back to the host per
generation.

Objective (matching the reference protocol): asymptotic convergence factor
of the two-grid CGC cycle ``u <- u + P A_c^{-1} R (b - A u)`` measured over
``measure_iterations`` sweeps (reference generate_coarse_grid_correction:
intergrid_transfer.py:68-84 — pure CGC, smoothing commented out there;
``smoothing_steps`` adds damped-Jacobi pre/post smoothing for a
smoother-aware objective).  ``A_c^{-1}`` is formed once, by
``torch.linalg.inv`` of the dense coarse operator (``ops/apply``'s
``dense_matrix``) in float64 on the device, and kept in the objective's
dtype, as the JAX package keeps numpy's inverse (:106).
"""

from __future__ import annotations

import functools
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..config import setup_device
from ..evaluation.evaluator import _torch_dtype
from ..grids import Grid
from ..ir import base, system
from ..ops import apply as ops_apply
from ..ops.transfer_weights import prolong_weighted, restrict_weighted
from ..stencils.constant import Stencil
from .cma import CMAES


@dataclass
class TransferOptimizationResult:
    restriction: system.Restriction
    prolongation: system.Prolongation
    weights: np.ndarray
    convergence_factor: float
    #: same objective with full-weighting / multilinear transfers
    default_convergence_factor: float = np.inf
    history: List[dict] = field(default_factory=list)


def _weights_to_stencil(w: np.ndarray, operator_range: int,
                        dimension: int) -> Stencil:
    shape = (2 * operator_range + 1,) * dimension
    box = np.asarray(w, dtype=np.float64).reshape(shape)
    entries = []
    for index in np.ndindex(shape):
        offset = tuple(i - operator_range for i in index)
        entries.append((offset, float(box[index])))
    return Stencil(entries)


class TransferObjective:
    """The two-grid objective of the finest level pair of ``problem`` for
    a ``(B, 2 * (2r+1)^d)`` batch of weight vectors (restriction's box,
    then prolongation's): :meth:`rho` returns the ``B`` convergence
    factors as a float64 tensor on the device, 1e100 where one is not
    finite (the body of cgc_rho, intergrid_transfer.py:112-145, for every
    member at once; in float32 the JAX package's 1e100 rounds to
    infinity).

    ``initial_error`` (the fine grid's shape) replaces the seeded draw;
    the default is a standard normal field from a ``torch.Generator``
    seeded with ``seed``, fixed across candidates."""

    def __init__(self, problem, *, operator_range: int = 1,
                 smoothing_steps: int = 0, smoothing_omega: float = 0.8,
                 measure_iterations: int = 10, seed: int = 0,
                 dtype=np.float64, device="cpu", initial_error=None):
        fine = problem.level_contexts[0]
        if len(fine.grid) != 1:
            raise NotImplementedError(
                "transfer tuning supports scalar problems")
        grid = fine.grid[0]
        self.grid = grid
        self.dimension = dimension = grid.dimension
        self.operator_range = operator_range
        self.width = 2 * operator_range + 1
        self.kernel_size = self.width ** dimension
        self.n_weights = 2 * self.kernel_size  # restriction + prolongation
        self.smoothing_steps = smoothing_steps
        self.smoothing_omega = smoothing_omega
        self.measure_iterations = measure_iterations
        self.device = device = torch.device(device)
        self.dtype = dtype = _torch_dtype(dtype)

        A_entry = fine.operator.entries[0][0]
        A_st = A_entry.generate_stencil()
        gen = getattr(A_entry, "stencil_generator", None)
        A_sf = (gen.generate_stencil_field(A_entry.grid)
                if gen is not None
                and hasattr(gen, "generate_stencil_field") else None)
        self.fine_shape = fine_shape = tuple(grid.size)
        self.coarse_shape = tuple((n - 1) // 2 for n in fine_shape)
        if len(problem.level_contexts) > 1:
            coarse_op_entry = problem.level_contexts[1].operator.entries[0][0]
        else:
            coarse_op_entry = problem.coarsest_operator.entries[0][0]
        self.coarse_grid = coarse_grid = (
            coarse_op_entry.grid if hasattr(coarse_op_entry, "grid")
            else Grid(self.coarse_shape, tuple(2 * s for s in grid.spacing),
                      grid.level - 1))
        cgen = getattr(coarse_op_entry, "stencil_generator", None)
        if cgen is not None and hasattr(cgen, "generate_stencil_field"):
            Ac = cgen.generate_stencil_field(coarse_grid).dense_matrix()
        else:
            Ac = ops_apply.dense_matrix(coarse_op_entry.generate_stencil(),
                                        coarse_grid)
        Ac = torch.as_tensor(Ac, dtype=torch.float64, device=device)
        self.Ac_inv = torch.linalg.inv(Ac).to(dtype)
        del Ac
        if A_sf is not None:
            apply_one = A_sf.apply
            self.diag = A_sf.diagonal_tensor(device, dtype)
        else:
            apply_one = functools.partial(ops_apply.apply_constant, A_st)
            self.diag = ops_apply.scalar(
                dict(A_st.entries).get((0,) * dimension))
        #: A on a batch of fields, the operator's own application vmapped
        self._apply = torch.vmap(apply_one)

        if initial_error is None:
            generator = torch.Generator().manual_seed(seed)
            initial_error = torch.randn(fine_shape, generator=generator,
                                        dtype=torch.float64)
        else:
            initial_error = torch.as_tensor(np.array(initial_error))
        self.e0 = initial_error.to(device=device, dtype=dtype)
        self.r0 = torch.linalg.vector_norm(apply_one(self.e0))

    def _smooth(self, u):
        """Damped Jacobi towards b = 0."""
        for _ in range(self.smoothing_steps):
            u = u - (self.smoothing_omega / self.diag) * self._apply(u)
        return u

    def rho(self, weights: torch.Tensor) -> torch.Tensor:
        batch = weights.shape[0]
        box = (batch,) + (self.width,) * self.dimension
        wr = weights[:, :self.kernel_size].reshape(box)
        wp = weights[:, self.kernel_size:].reshape(box)
        u = self.e0.expand((batch,) + self.fine_shape)
        for _ in range(self.measure_iterations):
            u = self._smooth(u)
            rc = restrict_weighted(-self._apply(u), wr)
            ec = (rc.reshape(batch, -1) @ self.Ac_inv.T).reshape(
                (batch,) + self.coarse_shape)
            u = u + prolong_weighted(ec, wp, self.fine_shape)
            u = self._smooth(u)
        rk = torch.linalg.vector_norm(self._apply(u).reshape(batch, -1),
                                      dim=1)
        rho = ((rk / self.r0) ** (1.0 / self.measure_iterations)).double()
        return torch.where(torch.isfinite(rho), rho,
                           torch.full_like(rho, 1e100))

    def __call__(self, weights) -> np.ndarray:
        """:meth:`rho` of a numpy batch, read back to the host once."""
        w = torch.as_tensor(np.asarray(weights), dtype=self.dtype,
                            device=self.device)
        return self.rho(w).cpu().numpy()

    def default_weights(self) -> np.ndarray:
        """Full weighting and multilinear interpolation embedded in the
        weight boxes (the tuner's starting incumbent).  The boxes are the
        outer products of the 1D kernels over every axis; the JAX package
        forms them with a two-argument ``np.multiply.outer``, which
        refuses three axes (intergrid_transfer.py:158-162)."""
        def embed(kernel):
            box = np.zeros((self.width,) * self.dimension)
            c = self.operator_range
            box[tuple(slice(c - 1, c + 2)
                      for _ in range(self.dimension))] = kernel
            return box.ravel()

        fw = np.array([0.25, 0.5, 0.25])
        bl = np.array([0.5, 1.0, 0.5])
        return np.concatenate([
            embed(functools.reduce(np.multiply.outer, [k] * self.dimension))
            for k in (fw, bl)])


def optimize(problem, generations: int = 20, *,
             operator_range: int = 1,
             smoothing_steps: int = 0,
             smoothing_omega: float = 0.8,
             measure_iterations: int = 10,
             lambda_: Optional[int] = None,
             seed: int = 0,
             dtype=np.float64,
             centroid: str = "default",
             verbose: bool = False,
             device=None,
             initial_error=None) -> TransferOptimizationResult:
    """Tune transfer weights of the finest two-grid hierarchy of ``problem``
    (intergrid_transfer.py:58-203), on the card unless ``device`` says
    otherwise.

    Scalar problems only (the reference tuner also builds per-field scalar
    transfer stencils; block systems reuse the tuned scalar stencil on the
    diagonal), with a constant stencil or a ``StencilField`` operator.
    Each generation's candidates are scored in one batched call
    (:class:`TransferObjective`).  Returns tuned system-level
    Restriction/Prolongation IR nodes ready to be used in level
    contexts."""
    device = setup_device("cuda" if device is None else device)
    objective = TransferObjective(
        problem, operator_range=operator_range,
        smoothing_steps=smoothing_steps, smoothing_omega=smoothing_omega,
        measure_iterations=measure_iterations, seed=seed, dtype=dtype,
        device=device, initial_error=initial_error)
    n_weights = objective.n_weights
    default_w = objective.default_weights()
    default_f = float(objective(default_w[None])[0])

    # centroid at the textbook transfers, sigma sized to explore around
    # them: CMA then strictly refines the default (the reference instead
    # spreads uniform mass — intergrid_transfer.py:127 — and must first
    # rediscover the textbook weights)
    if centroid == "default":
        es = CMAES(default_w, sigma=0.1, lambda_=lambda_, seed=seed)
    else:
        center = 2.0 / n_weights * 2
        es = CMAES([center] * n_weights, sigma=center / 2, lambda_=lambda_,
                   seed=seed)
    history = []
    best_w, best_f = default_w, default_f
    for gen in range(generations):
        pop = es.ask()
        fits = objective(pop)
        es.tell(pop, fits)
        i = int(np.argmin(fits))
        if fits[i] < best_f:
            best_f, best_w = float(fits[i]), pop[i].copy()
        record = {"gen": gen, "min": float(fits.min()),
                  "avg": float(fits.mean()), "sigma": es.sigma}
        history.append(record)
        if verbose:
            print(f"[cma] gen {gen}: min={record['min']:.4f} "
                  f"avg={record['avg']:.4f} sigma={es.sigma:.3g}",
                  file=sys.stderr)

    kernel_size = objective.kernel_size
    dimension = objective.dimension
    grid, coarse_grid = objective.grid, objective.coarse_grid
    r_st = _weights_to_stencil(best_w[:kernel_size], operator_range,
                               dimension)
    p_st = _weights_to_stencil(best_w[kernel_size:], operator_range,
                               dimension)
    restriction = system.Restriction("tuned_R", [
        base.Restriction("tuned_R", grid, coarse_grid,
                         base.ConstantStencilGenerator(r_st))])
    prolongation = system.Prolongation("tuned_P", [
        base.Prolongation("tuned_P", grid, coarse_grid,
                          base.ConstantStencilGenerator(p_st))])
    return TransferOptimizationResult(restriction, prolongation, best_w,
                                      best_f, default_f, history)
