"""Copy of evostencils_tpu/optimization/prescreen.py, kept in the port so
that it imports nothing of the JAX package.  What differs from the copied
file: the small instance is measured on ``device``, the card by default.
The copied file pins the host CPU only so that the screen pays no device
compile; the port compiles nothing, so the screen runs where the real
evaluator does.

The copied file's docstring, whose compile latencies are the JAX
package's:

Cheap pre-screen of offspring on a small instance of the problem.

The reference pairs its expensive codegen-based fitness with a cheap
model-based estimate precisely so hopeless candidates never pay for the
full ExaSlang -> JVM -> g++ -> run pipeline (reference
optimization/program.py:319-384, the estimate_* dual path).

This prescreen measures the SAME grammar individual on a small instance
of the same problem:

* trees transfer positionally between the full-size and the small
  grammar — the i-th registered symbol of one maps to the i-th of the
  other — exactly as mid-run generalization transfers populations
  (reference program.py:512-539; ``Optimizer._generalize``);
* the small instance (e.g. 127 x 127 for a 1023 x 1023 campaign, same
  hierarchy depth) solves in milliseconds;
* candidates that diverge on the small grid, or whose measured small-grid
  rho exceeds ``rho_cap``, are rejected with an estimated fitness
  (rho, infinity) and never reach the full-size evaluation.

``rho_cap`` defaults to 0.9: the evaluator itself fails any structure with
rho > 1e-5^(1/100) ~ 0.891 (its measurement window), so rejects are
structures that were going to score infinity anyway.  Smoother-only
cycles have grid-DEPENDENT rho (rho_small < rho_big), so the small-grid
measurement errs on the conservative side: borderline candidates pass and
the full-size evaluation decides.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..grammar import gp
from ..grammar.multigrid import generate_primitive_set


class SmallGridPrescreen:
    """Measured small-grid rejection filter over a full-size grammar."""

    def __init__(self, small_problem, *, rho_cap: float = 0.9,
                 maximum_local_system_size: int = 8,
                 enable_partitioning: bool = True,
                 max_iterations: Optional[int] = None, device="cuda"):
        from ..evaluation.evaluator import CycleEvaluator

        self.rho_cap = rho_cap
        self.pset_small, _ = generate_primitive_set(
            small_problem.approximation, small_problem.rhs_entity,
            small_problem.level_contexts,
            small_problem.coarsest_operator,
            maximum_local_system_size=maximum_local_system_size,
            enable_partitioning=enable_partitioning,
            FAS=small_problem.nonlinear_term is not None,
            coupled_fields=getattr(small_problem, 'coupled_fields',
                                   False))
        self.evaluator = CycleEvaluator(
            small_problem, max_iterations=max_iterations, device=device)
        self.evaluator.timing_enabled = False   # convergence only
        self._small_names = list(self.pset_small.mapping)
        self._rename_for: Optional[int] = None      # id of attached pset
        self._rename: Optional[dict] = None
        #: running statistics for campaign reporting
        self.screened = 0
        self.rejected = 0

    def attach(self, pset) -> bool:
        """Build the positional full-grammar -> small-grammar node map.
        Returns False (prescreen disabled) when the grammars have
        different shapes — e.g. a level-chunked pset."""
        if self._rename_for == id(pset):
            return self._rename is not None
        self._rename_for = id(pset)
        big_names = list(pset.mapping)
        if len(big_names) != len(self._small_names):
            self._rename = None
            return False
        self._rename = dict(zip(big_names, self._small_names))
        return True

    def screen(self, individuals: List, pset) -> List[Optional[float]]:
        """Returns, per individual, ``None`` (survives: measure it for
        real) or the small-grid rho estimate (reject: assign estimated
        fitness with infinite time, skip the full-size evaluation)."""
        if not individuals or not self.attach(pset):
            return [None] * len(individuals)
        small_inds: List[Optional[gp.Individual]] = []
        verdicts: List[Optional[float]] = [None] * len(individuals)
        infinity = self.evaluator.infinity
        for i, ind in enumerate(individuals):
            try:
                small_inds.append(gp.Individual(
                    [self.pset_small.mapping[self._rename[n.name]]
                     for n in ind]))
            except KeyError:
                # node not in the attached grammar (stale pset): pass
                # through to the real evaluator, which owns the error
                small_inds.append(None)
        to_eval = [si for si in small_inds if si is not None]
        if not to_eval:
            return verdicts
        results = self.evaluator.evaluate_population(to_eval,
                                                     self.pset_small)
        it = iter(results)
        for i, si in enumerate(small_inds):
            if si is None:
                continue
            res = next(it)
            self.screened += 1
            hopeless = (res.iterations >= infinity
                        or not np.isfinite(res.convergence_factor)
                        or res.convergence_factor > self.rho_cap)
            if hopeless:
                self.rejected += 1
                rho = res.convergence_factor
                verdicts[i] = float(min(rho, infinity)) \
                    if np.isfinite(rho) else infinity
        return verdicts
