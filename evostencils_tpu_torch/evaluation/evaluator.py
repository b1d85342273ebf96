"""Measured fitness evaluation (counterpart of
evostencils_tpu/evaluation/evaluator.py).

The surface and the arithmetic are the JAX package's: ``structure_key``,
``EvaluationResult``, ``CycleEvaluator.evaluate_expression``,
``evaluate_population`` and ``measure_interleaved``; the float32
measurement window at 1e-5 with the log-eps/log-rho extrapolation to the
problem's target (evaluator.py:79-85, :385-394); the slope-fit timing of
chained solves (evaluator.py:155-287) with ``torch.cuda.synchronize`` as
the sync point.

* Each distinct cycle *structure* (tree with relaxation-factor terminals
  normalized out) is lowered once and cached; its solver serves every
  relaxation-factor vector.
* The members of a structure group run one after another, each with its
  own relaxation-factor vector: there is no ``vmap`` of the solver here.
* Per-individual time to convergence = measured per-cycle time of the
  structure x iteration count of the individual.

A problem with an outer Krylov solver (Helmholtz) is solved by
``ops.solvers.preconditioned_bicgstab`` on its true operator, one
application of the cycle from a zero initial guess as the preconditioner
(evaluator.py:122-152).  The fields carry the problem's complex dtype in
the asked precision: float32 gives complex64 fields, float64 complex128;
relaxation factors stay real in that precision.  A split-complex outer
solver (``outer_solver.split``, ``helmholtz_2d_split``) runs
``ops.solvers.preconditioned_bicgstab_split`` on real (re, im) fields.

With ``chain=`` (a level-chunked run's finished finer chunks, finest
first) and ``cand_entities=`` (the entities the candidate chunk's trees
bind), each candidate is the innermost coarse solver of the whole composed
program (``compiler.lower.lower_composed``), solved on the finest grid;
the chain's relaxation factors prefix each member's own
(evaluator.py:55-73, :97-104, :526-530).

What exists only for XLA compilation is left out: ``_precompile_groups``
and ``compile_workers``, the power-of-two bucket padding of the batches
and the persistent compilation cache.  ``canonicalize = True`` raises
``NotImplementedError``: ``compiler/canonical.py`` is not ported yet.

An individual whose cycle the port cannot lower (``NotImplementedError``)
or whose solve fails arithmetically scores infinity, as in the JAX
package.  A kernel that fails to build or launch raises: that is a fault,
never a fitness.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..compiler.lower import (ChainLink, lower_composed, lower_cycle,
                              operator_applier)
from ..compiler.solve import make_preconditioner, make_solver
from ..grammar import gp
from ..ir import base, transformations
from ..ops.solvers import (preconditioned_bicgstab,
                           preconditioned_bicgstab_split)
from ..problems.poisson import build_rhs

_RF_PATTERN = re.compile(r"rf_\d+")

#: what a run of a lowered structure may raise for an individual the port
#: cannot evaluate (the lowering's own set, evaluator.py:513-548);
#: anything else, such as a kernel that fails to build or launch
#: (RuntimeError), propagates
_UNEVALUABLE = (NotImplementedError, ValueError, ArithmeticError, KeyError,
                MemoryError, np.linalg.LinAlgError,
                torch.cuda.OutOfMemoryError)


def structure_key(individual) -> str:
    """Tree string with relaxation-factor terminals normalized away."""
    return _RF_PATTERN.sub("rf", str(individual))


@dataclass
class EvaluationResult:
    time_to_convergence_ms: float
    convergence_factor: float
    iterations: float   # float so that infinity is representable


#: the numpy dtypes a problem or an evaluator may ask for
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64,
                 np.dtype(np.complex64): torch.complex64,
                 np.dtype(np.complex128): torch.complex128}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype)]


class CycleEvaluator:
    """Measured evaluation backend over a Problem, on ``device``."""

    def __init__(self, problem, *, dtype=None,
                 max_iterations: Optional[int] = None,
                 target_reduction: Optional[float] = None,
                 throughput_cycles: int = 5, infinity: float = 1e100,
                 device="cuda", chain: Optional[List[ChainLink]] = None,
                 cand_entities: Optional[Tuple] = None):
        self.problem = problem
        #: level-chunked runs: the finer chunks' best cycles (finest
        #: first); candidates are then coarse cycles spliced in underneath
        #: and the measured solve is the whole composed program on the
        #: finest grid (reference optimization/program.py:810-899)
        self.chain = chain or []
        #: (approximation, rhs) entities the candidate chunk's trees bind
        self.cand_entities = cand_entities
        if self.chain and cand_entities is None:
            raise ValueError("chain evaluation requires cand_entities")
        #: the composed program's fixed relaxation-factor prefix: the
        #: chain's cycles, in the ids lower_composed assigns them
        self._omega_prefix = np.concatenate(
            [[float(c.relaxation_factor)
              for c in transformations.find_nodes(link.root, base.Cycle)]
             for link in self.chain]) if self.chain else np.zeros(0)
        self.device = torch.device(device)
        self.torch_dtype = _torch_dtype(dtype or problem.dtype)
        #: the numpy form, which the optimizer hands to evaluators it builds
        self.dtype = next(d.type for d, t in _TORCH_DTYPES.items()
                          if t == self.torch_dtype)
        self.max_iterations = max_iterations or problem.max_iterations
        self.target_reduction = target_reduction or problem.target_reduction
        # f32 residuals stagnate around 1e-7 relative; measure rho at a
        # reachable reduction and extrapolate the iteration count to the
        # problem target with log(eps)/log(rho) — the reference's own
        # time-to-convergence model (reference program.py:347-349).  The
        # rule reads the asked dtype, as the JAX evaluator's does
        # (evaluator.py:70-77): float32 asked for a complex problem
        # (complex64 fields) measures at 1e-5 there too
        self.measurement_reduction = self.target_reduction
        if np.dtype(self.dtype).itemsize <= 4:
            self.measurement_reduction = max(self.target_reduction, 1e-5)
        self.throughput_cycles = throughput_cycles
        self.infinity = infinity
        problem.dtype = self.dtype
        # complex64 fields for a complex problem in float32
        self._b = build_rhs(problem, dtype=self.torch_dtype,
                            device=self.device)
        self._u0 = tuple(torch.zeros_like(x) for x in self._b)
        self._solver_cache: Dict[str, dict] = {}
        self.compilations = 0

    # -- structure lowering --------------------------------------------------

    def _get_compiled(self, key: str, expression: base.Cycle):
        entry = self._solver_cache.get(key)
        if entry is not None:
            return entry
        if self.chain:
            lowered = lower_composed(self.chain, expression,
                                     *self.cand_entities)
        else:
            lowered = lower_cycle(expression, self.problem.approximation,
                                  self.problem.rhs_entity)
        outer = getattr(self.problem, "outer_solver", None)
        if outer is not None:
            solver = self._make_outer_solver(lowered, outer)
        else:
            solver = make_solver(lowered, self.max_iterations,
                                 self.measurement_reduction)
        entry = {"lowered": lowered, "solver": solver, "cycle_time_ms": None}
        self._solver_cache[key] = entry
        self.compilations += 1
        return entry

    def _make_outer_solver(self, lowered, outer):
        """``run(u0, b, omegas) -> (x, iterations, history)``: the outer
        Krylov solve of ``outer.operator`` with one application of the
        cycle from a zero initial guess as the preconditioner
        (evaluator.py:122-152), replayed from a CUDA graph on the card
        (``compiler.solve.make_preconditioner``); split-complex problems
        take the (re, im)-pair BiCGStab, so every tensor stays real.
        ``u0`` is not read: BiCGStab starts from zero.  The coarse solve's
        matrix product runs in full float32 (no TF32), PyTorch's default,
        as the JAX package asks with ``default_matmul_precision
        ("highest")``."""
        matvec = operator_applier(outer.operator)
        max_iter = min(outer.max_iterations, self.max_iterations)
        bicgstab = preconditioned_bicgstab_split \
            if getattr(outer, "split", False) else preconditioned_bicgstab

        def solver(u0, b, omegas):
            return bicgstab(
                matvec, make_preconditioner(lowered, omegas, b), b,
                tol=outer.tolerance, maxiter=max_iter,
                history_size=max_iter)
        return solver

    def _omegas(self, values) -> torch.Tensor:
        """Relaxation factors: real, in the fields' precision."""
        return torch.as_tensor(np.asarray(values, dtype=np.float64),
                               dtype=self._b[0].real.dtype,
                               device=self.device)

    #: slope-fit timing protocol: repetitions per window size and the
    #: chained-solve counts per timed window.  The per-solve time is the
    #: least-squares SLOPE of window time against solves per window, so
    #: the fixed cost of opening and closing a window lands in the
    #: intercept and cancels (evaluator.py:155-161).
    timing_reps = 3
    timing_window_sizes = (1, 2, 4, 8)
    #: False skips wall-time measurement entirely (cycle time fixed at
    #: 1.0 ms, so time_to_convergence degenerates to the iteration count)
    timing_enabled = True
    #: soft budget: the largest window is shrunk so one window stays under
    #: this many seconds
    timing_window_budget_s = 1.5

    @staticmethod
    def _chain(x, e: float):
        """Device-side state chaining (evaluator.py:175-187): scale the
        previous solution to numerical irrelevance (``e`` ~ 1e-35, below
        the float32 ulp of b in the residual, so the iteration trace is
        unchanged) so that consecutive solves of a window depend on each
        other and stay on the device."""
        return tuple(torch.nan_to_num(xi * e, nan=0.0, posinf=0.0,
                                      neginf=0.0) for xi in x)

    def _sync(self) -> None:
        """The sync point that opens and closes a timed window."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _salt(k: int) -> float:
        # the float32 value, as the JAX package's jnp.float32 scale
        return float(np.float32((k % 7 + 1) * 1e-35))

    def _solve_window(self, run, om, x, n_solves: int, salt: int):
        """Time one window of ``n_solves`` chained solves.  Returns
        (wall seconds, final solution)."""
        u0 = self._chain(x, self._salt(salt))
        self._sync()                        # drain all prior work
        t0 = time.perf_counter()
        out = run(u0, self._b, om)
        for j in range(1, n_solves):
            u0 = self._chain(out[0], self._salt(salt + j))
            out = run(u0, self._b, om)
        self._sync()                        # close the window
        return time.perf_counter() - t0, out[0]

    @staticmethod
    def _fit_slope(pairs) -> float:
        """Least-squares slope of (solves-per-window, window seconds)."""
        S = np.array([p[0] for p in pairs], dtype=float)
        W = np.array([p[1] for p in pairs], dtype=float)
        A = np.stack([S, np.ones_like(S)], axis=1)
        slope, _ = np.linalg.lstsq(A, W, rcond=None)[0]
        return float(slope)

    def _window_plan(self, probe_s: float):
        """Window sizes fitting the per-window budget given one solve
        takes ``probe_s`` (upper bound: includes the fixed cost)."""
        sizes = [s for s in self.timing_window_sizes
                 if s == 1 or s * probe_s <= self.timing_window_budget_s]
        return tuple(sizes)

    def _timing_series(self, run, om, x, reps=None, sizes=None, salt0=0):
        """Per-window-size wall times for one solver.  Returns
        ({size: [seconds, ...]}, final solution, next salt)."""
        per_s: Dict[int, List[float]] = {}
        salt = salt0
        for _ in range(reps or self.timing_reps):
            for S in sizes or self.timing_window_sizes:
                w, x = self._solve_window(run, om, x, S, salt)
                salt += S
                per_s.setdefault(S, []).append(w)
        return per_s, x, salt

    @classmethod
    def _slope_from_series(cls, per_s) -> float:
        """Per-solve seconds from a window series: slope over per-size
        minima; the single-size minimum when the plan had one size."""
        pairs = [(S, min(ws)) for S, ws in sorted(per_s.items())]
        if len(pairs) == 1:
            return pairs[0][1] / pairs[0][0]
        slope = cls._fit_slope(pairs)
        if slope <= 0:          # pathological noise: fall back to the
            lo, hi = pairs[0], pairs[-1]        # two-point estimate
            slope = (hi[1] - lo[1]) / max(hi[0] - lo[0], 1)
        return max(slope, 1e-12)

    def _measure_cycle_time(self, entry) -> float:
        """Per-iteration wall time of this structure: windows of 1/2/4/8
        chained full solves, per-size minima, least-squares slope = seconds
        per solve, divided by the (deterministic) iteration count
        (evaluator.py:253-287)."""
        if entry["cycle_time_ms"] is not None:
            return entry["cycle_time_ms"]
        if not self.timing_enabled:
            entry["cycle_time_ms"] = 1.0
            return 1.0
        om = self._omegas(entry["lowered"].default_omegas)
        run = entry["solver"]
        out = run(self._u0, self._b, om)           # warm-up
        x = out[0]
        iters = max(out[1], 1)
        w_probe, x = self._solve_window(run, om, x, 1, 0)
        if w_probe > self.timing_window_budget_s:
            # seconds-long solves (e.g. iteration-capped failures): one
            # sample is enough
            entry["cycle_time_ms"] = w_probe * 1e3 / iters
            return entry["cycle_time_ms"]
        sizes = self._window_plan(w_probe)
        per_s, x, _ = self._timing_series(run, om, x, sizes=sizes, salt0=1)
        per_s.setdefault(1, []).append(w_probe)
        slope = self._slope_from_series(per_s)
        entry["cycle_time_ms"] = slope * 1e3 / iters
        return entry["cycle_time_ms"]

    def measure_interleaved(self, keyed_expressions, reps: int = 5):
        """Head-to-head measurement of several structures interleaved in
        one process (evaluator.py:289-349): the timed windows round-robin
        across the structures within every repetition, so drift hits all
        of them equally; each structure gets a per-rep slope fit, reported
        as median and spread.

        ``keyed_expressions``: list of (key, expression).  Returns a list
        of dicts with ms_per_iter (median over reps), ms_per_iter_spread
        (min/max of the per-rep slopes), iterations, convergence_factor,
        time_to_convergence_ms."""
        entries = []
        for key, expression in keyed_expressions:
            entry = self._get_compiled(key, expression)
            om = self._omegas(entry["lowered"].default_omegas)
            run = entry["solver"]
            out = run(self._u0, self._b, om)
            iters = max(out[1], 1)
            hist = out[2].cpu().numpy()
            w_probe, x = self._solve_window(run, om, out[0], 1, 0)
            entries.append({"entry": entry, "om": om, "run": run, "x": x,
                            "iters": iters, "hist": hist,
                            "sizes": self._window_plan(w_probe),
                            "rep_slopes": []})
        salt = 1
        for _ in range(reps):
            per_rep = [dict() for _ in entries]
            longest = max(len(e["sizes"]) for e in entries)
            for si in range(longest):
                for ei, e in enumerate(entries):
                    if si >= len(e["sizes"]):
                        continue
                    S = e["sizes"][si]
                    w, e["x"] = self._solve_window(e["run"], e["om"],
                                                   e["x"], S, salt)
                    salt += S
                    per_rep[ei].setdefault(S, []).append(w)
            for ei, e in enumerate(entries):
                e["rep_slopes"].append(self._slope_from_series(per_rep[ei]))
        results = []
        for (key, _), e in zip(keyed_expressions, entries):
            slopes = np.array(e["rep_slopes"])
            ms_it = float(np.median(slopes)) * 1e3 / e["iters"]
            res = self._result_from_history_with_time(
                e["entry"], e["hist"], e["iters"], ms_it)
            results.append({
                "key": key, "ms_per_iter": ms_it,
                "ms_per_iter_spread": (float(slopes.min()) * 1e3 / e["iters"],
                                       float(slopes.max()) * 1e3 / e["iters"]),
                "iterations": res.iterations,
                "convergence_factor": res.convergence_factor,
                "time_to_convergence_ms": res.time_to_convergence_ms,
            })
        return results

    # -- single evaluation ---------------------------------------------------

    def evaluate_expression(self, expression: base.Cycle,
                            key: Optional[str] = None) -> EvaluationResult:
        key = key or str(id(expression))
        entry = self._get_compiled(key, expression)
        omegas = self._omegas(entry["lowered"].default_omegas)
        _, iters, hist = entry["solver"](self._u0, self._b, omegas)
        return self._result_from_history(entry, hist.cpu().numpy(), iters)

    def _result_from_history(self, entry, hist, iters) -> EvaluationResult:
        return self._result_from_history_with_time(
            entry, hist, iters, None)

    def _result_from_history_with_time(self, entry, hist, iters,
                                       cycle_time) -> EvaluationResult:
        """evaluator.py:369-394."""
        if cycle_time is None:
            cycle_time = self._measure_cycle_time(entry)
        r0 = hist[0]
        converged = (r0 > 0 and np.isfinite(hist[iters])
                     and hist[iters] <= self.measurement_reduction * r0
                     * (1 + 1e-6))
        if iters > 0 and np.isfinite(hist[iters]) and hist[iters] > 0 and r0 > 0:
            rho = float((hist[iters] / r0) ** (1.0 / iters))
        else:
            rho = self.infinity if not np.isfinite(hist[iters]) else 0.0
        if not converged or not np.isfinite(rho):
            return EvaluationResult(self.infinity,
                                    rho if np.isfinite(rho) else self.infinity,
                                    self.infinity)
        if self.measurement_reduction > self.target_reduction and rho > 0:
            # extrapolate to the problem target (f32 measurement window)
            iters_full = (np.log(self.target_reduction) / np.log(rho)
                          if rho < 1 else self.infinity)
        else:
            iters_full = float(iters)
        if not np.isfinite(iters_full) or iters_full > 10 * self.max_iterations:
            return EvaluationResult(self.infinity, rho, self.infinity)
        return EvaluationResult(cycle_time * iters_full, rho,
                                float(np.ceil(iters_full)))

    # -- population evaluation -----------------------------------------------

    #: structure canonicalization (compiler/canonical.py) is not ported
    canonicalize = False

    def evaluate_population(self, individuals: List, pset) -> List[EvaluationResult]:
        """Group by structure, lower each structure once, run its members
        one after another (evaluator.py:497-581 without the batching)."""
        if self.canonicalize:
            raise NotImplementedError(
                "canonicalize: compiler/canonical.py is not ported yet")
        infinite = EvaluationResult(self.infinity, self.infinity,
                                    self.infinity)
        groups: Dict[str, List[int]] = {}
        expressions: List[Optional[base.Cycle]] = [None] * len(individuals)
        results: List[Optional[EvaluationResult]] = [None] * len(individuals)
        for i, ind in enumerate(individuals):
            if len(ind) > 150:
                results[i] = infinite
                continue
            try:
                state = gp.compile_tree(ind, pset)
                expr = state[0]
                transformations.assign_cycle_ids(expr)
                expressions[i] = expr
                groups.setdefault(structure_key(ind), []).append(i)
            except (MemoryError, ValueError, NotImplementedError,
                    RuntimeError, KeyError):
                results[i] = infinite
        for key, members in groups.items():
            try:
                entry = self._get_compiled(key, expressions[members[0]])
            except (NotImplementedError, ValueError, RuntimeError, KeyError,
                    np.linalg.LinAlgError):
                for i in members:
                    results[i] = infinite
                continue
            for i in members:
                # a composed program's chain factors prefix the member's
                # own (lower_composed's id assignment)
                om = self._omegas(np.concatenate([
                    self._omega_prefix,
                    [float(c.relaxation_factor) for c in
                     transformations.find_nodes(expressions[i],
                                                base.Cycle)]]))
                try:
                    _, iters, hist = entry["solver"](self._u0, self._b, om)
                    hist = hist.cpu().numpy()
                except _UNEVALUABLE:
                    results[i] = infinite
                    continue
                results[i] = self._result_from_history(entry, hist, iters)
        return results
