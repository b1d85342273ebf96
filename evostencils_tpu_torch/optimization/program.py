"""Copy of evostencils_tpu/optimization/program.py, kept in the port so that
it imports nothing of the JAX package.  It drives the port's grammar,
evaluator (evaluation/evaluator.py) and communicators (parallel/comm.py).
What differs from the copied file:

* model-based estimation defaults to the port's
  ``ConvergenceEvaluator`` on the evaluator's device (LFA as batched
  complex128 tensor programs there) and ``PerformanceEvaluator(H100)``;
* every evaluator it builds (generalization, robustness variants, level
  chunks, the re-evaluation of a chunked program) inherits the base
  evaluator's device as well as its dtype and budgets.

Level-chunked runs (``levels_per_run`` below the level count) and
``evaluate_chunked_program`` run as in the copied file, on the port's
composed lowering (``compiler.lower.lower_composed``).

The copied file's docstring:

Evolutionary optimizer: (mu+lambda) G3P over the multigrid grammar.

Native counterpart of the reference Optimizer
(optimization/program.py:67-954): same evolutionary loop — initial
population, crossover/mutation with cache-aware retry, elitism + NSGA-II/III
or unique-best selection, fitness caching by tree string, checkpointing
every ``checkpoint_frequency`` generations, mid-run generalization (problem
growth), and level-chunked runs whose best cycle becomes the coarse-grid
solver of the next finer run.

Differences by design:
* evaluation is the batched native backend (evaluation/evaluator.py), not
  subprocess codegen — whole structure groups evaluate in one TPU program;
* distribution rides host-level collectives over the JAX runtime
  (parallel/comm.py) instead of mpi4py: populations stay replicated
  (every rank runs the identical rng/selection stream — pass the same
  seed on all ranks), evaluation is partitioned ``pending[rank::size]``
  and (tree-string, fitness) pairs are allgathered, dividing evaluation
  cost by the rank count (reference program.py:478,495-502,580-588);
  with deterministic (model-based) fitness a multi-rank run is
  bit-identical to the single-process run.
"""

from __future__ import annotations

import hashlib
import math
import os
import pickle
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from ..grammar import gp
from ..grammar.multigrid import generate_primitive_set
from ..ir import base, system, transformations
from ..compiler.lower import ChainLink
from ..evaluation.evaluator import CycleEvaluator, EvaluationResult
from ..parallel.comm import Communicator, NullCommunicator
from . import nsga


@dataclass
class CheckPoint:
    """Pickled evolution state (reference optimization/program.py:47-64).

    Saved at end-of-generation, so ``population`` is the post-selection
    population of size mu and ``generation`` the last completed generation;
    resuming restores the exact evolution stream (``rng_state``, fitness
    ``cache``, ``hof_items``).  ``finished_chunks`` holds the grammar
    strings of the best individual of every *completed* level chunk, so a
    resumed run rebuilds the coarse-solver chain without re-evolving them
    (reference program.py:794-801, :813-820)."""
    min_level: int
    max_level: int
    generation: int
    finished_chunks: list
    population: list
    logbooks: list
    rng_state: object = None
    cache: dict = None
    hof_items: list = None
    gen_count: int = 0
    level_offset: int = 0

    def dump_to_file(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self, f)


def load_checkpoint_from_file(path: str) -> CheckPoint:
    with open(path, "rb") as f:
        return pickle.load(f)


def _chunk_entities(prob, chunk_ctxs, first):
    """Approximation/rhs entities of one level chunk: the finest chunk
    carries the problem's own entities, coarser chunks start from zero on
    a synthetic coarse rhs (the restricted residual the finer chain
    passes down).  Shared by evolution and stored-solver re-evaluation —
    both must build identical programs."""
    if first:
        return prob.approximation, prob.rhs_entity
    approx = system.ZeroApproximation(chunk_ctxs[0].grid)
    rhs_e = system.RightHandSide(
        "b_c", [base.RightHandSide("b_c", g) for g in chunk_ctxs[0].grid])
    return approx, rhs_e


def _chunk_coarsest(prob, contexts, i, levels_per_run):
    """Operator below a chunk's coarsest level (the chunk grammar's
    coarse-grid-solver operator)."""
    if i + levels_per_run < len(contexts):
        return contexts[i + levels_per_run].operator
    return prob.coarsest_operator


class Optimizer:
    """G3P optimizer over a Problem."""

    infinity = 1e100
    epsilon = 1e-20

    def __init__(self, problem, *, evaluator: Optional[CycleEvaluator] = None,
                 checkpoint_directory_path: str = "./checkpoints",
                 problem_factory: Optional[Callable] = None,
                 convergence_evaluator=None, performance_evaluator=None,
                 model_based_estimation: bool = False,
                 robustness_problems: Optional[List] = None,
                 robustness_factories: Optional[List[Callable]] = None,
                 rng: Optional[random.Random] = None,
                 comm: Optional[Communicator] = None,
                 prescreen=None):
        self.problem = problem
        #: optional SmallGridPrescreen (optimization/prescreen.py):
        #: offspring whose measured small-grid convergence is hopeless get
        #: an estimated (rho, infinity) fitness and never reach the
        #: expensive measured evaluation (the reference's cheap-estimate
        #: dual path, reference program.py:319-384)
        self.prescreen = prescreen
        #: host-level collectives for population-parallel evaluation;
        #: all ranks must construct the Optimizer with the same rng seed
        self.comm = comm or NullCommunicator()
        self.evaluator = evaluator or CycleEvaluator(problem)
        #: harder problem variants every candidate must also solve; fitness
        #: becomes the worst case over all of them (reference Helmholtz
        #: k-doubling robustness loop, exastencils.py:518-532)
        self.robustness_problems = robustness_problems or []
        #: (min_level, max_level) -> variant problem, one per robustness
        #: variant — required for mid-run generalization so the variant
        #: grammars regrow with the base problem (see _rebuild_problem)
        self.robustness_factories = robustness_factories
        self._robustness: List[tuple] = []
        self.checkpoint_directory_path = checkpoint_directory_path
        self.problem_factory = problem_factory
        self.model_based_estimation = model_based_estimation
        if model_based_estimation:
            if convergence_evaluator is None:
                from ..prediction.convergence import ConvergenceEvaluator
                convergence_evaluator = ConvergenceEvaluator(
                    problem.dimension, samples_per_axis=8,
                    device=self.evaluator.device)
            if performance_evaluator is None:
                from ..prediction.performance import (H100,
                                                      PerformanceEvaluator)
                performance_evaluator = PerformanceEvaluator(H100)
        self.convergence_evaluator = convergence_evaluator
        self.performance_evaluator = performance_evaluator
        self.rng = rng or random.Random()
        self.individual_cache: Dict[str, tuple] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self.total_evaluations = 0
        self._pset = None
        self._pset_builder = None   # problem -> pset, used by _generalize
        self._maximum_local_system_size = 8
        self._enable_partitioning = True
        self._n_objectives = 2

    # -- caching -------------------------------------------------------------

    def individual_in_cache(self, individual) -> bool:
        hit = str(individual) in self.individual_cache
        if hit:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        return hit

    def add_individual_to_cache(self, individual, values):
        self.individual_cache[str(individual)] = tuple(values)

    # -- evaluation ----------------------------------------------------------

    def _fitness_from_result(self, result: EvaluationResult):
        if self._n_objectives == 2:
            # (convergence factor, time per iteration)
            if result.iterations >= self.infinity:
                return (min(result.convergence_factor, self.infinity),
                        self.infinity)
            return (result.convergence_factor,
                    result.time_to_convergence_ms / max(result.iterations, 1.0))
        # single objective: measured time to convergence
        if result.iterations >= self.infinity:
            return (min(result.convergence_factor, self.infinity) ** 0.5
                    * self.infinity ** 0.5,)
        return (result.time_to_convergence_ms,)

    def evaluate_invalid(self, individuals: List[gp.Individual]):
        """Assign fitness to all invalid individuals, cache-aware and
        batched by structure."""
        pending = []
        for ind in individuals:
            if ind.fitness.valid:
                continue
            if self.individual_in_cache(ind):
                ind.fitness.values = self.individual_cache[str(ind)]
            else:
                pending.append(ind)
        if not pending:
            return 0    # replicated state: all ranks agree, no collective
        # partition evaluation across ranks, allgather the fitness values
        # (reference program.py:495-502 MPI-partitioned evaluation)
        local = self.comm.shard(pending)
        if self.model_based_estimation:
            local_values = [self._estimate_objectives(ind) for ind in local]
        else:
            verdicts = [None] * len(local)
            if self.prescreen is not None and \
                    not getattr(self.evaluator, "chain", None):
                try:
                    verdicts = self.prescreen.screen(local, self._pset)
                except Exception as e:     # never let the estimate path
                    print(f"prescreen failed ({e}); measuring everything",
                          flush=True)      # kill the real one
                    verdicts = [None] * len(local)
            survivors = [ind for ind, v in zip(local, verdicts) if v is None]
            results = iter(
                self.evaluator.evaluate_population(survivors, self._pset))
            local_values = [
                self._fitness_from_result(next(results)) if v is None
                else self._fitness_from_result(
                    EvaluationResult(self.infinity, v, self.infinity))
                for v in verdicts]
            local_values = self._apply_robustness(local, local_values)
        values_list = self.comm.allgather_shards(local_values)
        for ind, values in zip(pending, values_list):
            ind.fitness.values = values
            self.add_individual_to_cache(ind, values)
        self.total_evaluations += len(pending)
        return len(pending)

    def _apply_robustness(self, individuals, values_list):
        """Worst-case fitness over the robustness problem variants: each
        individual that solves the base problem is re-parsed against every
        variant grammar and must solve that problem too."""
        if not self._robustness:
            return values_list
        finite = [i for i, v in enumerate(values_list)
                  if all(x < self.infinity for x in v)]
        if not finite:
            return values_list
        values_list = list(values_list)
        for evaluator_v, pset_v in self._robustness:
            parsed = []
            kept = []
            for i in finite:
                try:
                    parsed.append(gp.parse_tree(str(individuals[i]), pset_v))
                    kept.append(i)
                except (KeyError, ValueError, SyntaxError):
                    values_list[i] = (self.infinity,) * len(values_list[i])
            if not parsed:
                continue
            results = evaluator_v.evaluate_population(parsed, pset_v)
            for i, res in zip(kept, results):
                vv = self._fitness_from_result(res)
                values_list[i] = tuple(max(a, b)
                                       for a, b in zip(values_list[i], vv))
            finite = [i for i in kept
                      if all(x < self.infinity for x in values_list[i])]
        return values_list

    def _estimate_objectives(self, individual):
        """Model-based fitness: LFA spectral radius + roofline runtime
        (reference optimization/program.py:319-384)."""
        import math as _math
        try:
            state = gp.compile_tree(individual, self._pset)
            expression = state[0]
            transformations.assign_cycle_ids(expression)
        except (MemoryError, ValueError, NotImplementedError, RuntimeError,
                KeyError):
            return (self.infinity,) * self._n_objectives
        rho = self.convergence_evaluator.compute_spectral_radius(expression)
        bad = (rho == 0.0 or _math.isnan(rho) or _math.isinf(rho))
        if self._n_objectives == 2:
            if bad:
                return (self.infinity, self.infinity)
            runtime = self.performance_evaluator.estimate_runtime(
                expression) * 1e3
            return (rho, runtime)
        if bad:
            return (self.infinity,)
        if self.performance_evaluator is None:
            return (rho,)
        runtime = self.performance_evaluator.estimate_runtime(expression) * 1e3
        if rho < 1:
            return (_math.log(self.epsilon) / _math.log(rho) * runtime,)
        return (rho * self.infinity ** 0.25,)

    # -- evolutionary loop ---------------------------------------------------

    def ea_mu_plus_lambda(self, initial_population_size, generations,
                          generalization_interval, mu_, lambda_,
                          crossover_probability, mutation_probability,
                          min_level, max_level, logbooks,
                          select, select_for_mating, hof,
                          objectives, checkpoint_frequency=2,
                          checkpoint: Optional[CheckPoint] = None,
                          use_random_search=False,
                          finished_chunks=None,
                          node_replacement_probability=1.0 / 3.0,
                          initial_individuals=None,
                          verbose=True):
        toolbox_generate = lambda: gp.genGrow(self._pset, 0, 50, rng=self.rng)

        def mutate(ind):
            if self.rng.random() < node_replacement_probability:
                return gp.mutNodeReplacement(ind, self._pset, rng=self.rng)
            return gp.mutate_subtree(ind, 0, 10, self._pset, rng=self.rng)

        use_checkpoint = checkpoint is not None
        if use_checkpoint and mu_ != len(checkpoint.population):
            if self.comm.rank == 0:
                print(f"Warning: checkpoint population size "
                      f"{len(checkpoint.population)} does not match mu "
                      f"{mu_} — ignoring checkpoint", flush=True)
            use_checkpoint = False
        count = 0
        level_offset = 0
        if use_checkpoint:
            population = checkpoint.population
            min_generation = checkpoint.generation
            if not logbooks and getattr(checkpoint, "logbooks", None):
                # restore pre-interruption generation statistics — the
                # caller passes a fresh [] on resume
                logbooks.extend(checkpoint.logbooks)
            if logbooks:
                logbook = logbooks[-1]
            else:
                logbook = []
                logbooks.append(logbook)
            if getattr(checkpoint, "rng_state", None) is not None:
                self.rng.setstate(checkpoint.rng_state)
            if getattr(checkpoint, "cache", None):
                self.individual_cache.update(checkpoint.cache)
            if getattr(checkpoint, "hof_items", None):
                hof.update(checkpoint.hof_items)
            count = getattr(checkpoint, "gen_count", 0)
            level_offset = getattr(checkpoint, "level_offset", 0)
            if level_offset and self.problem_factory is not None:
                # re-grow the problem to the checkpointed generalization
                # state so evaluation matches the interrupted run.  The
                # checkpointed individuals already carry the grown grammar's
                # node names, so rebind them by name (no positional rename),
                # and re-restore the cache _rebuild_problem wipes — the
                # checkpointed fitness/cache reflect the grown problem.
                self._rebuild_problem(min_level + level_offset,
                                      max_level + level_offset)
                if getattr(checkpoint, "cache", None):
                    self.individual_cache.update(checkpoint.cache)
                for ind in population:
                    for pos, node in enumerate(ind):
                        ind[pos] = self._pset.mapping[node.name]
        else:
            # optional seeds: known-good grammar strings (grammar/seeds.py)
            # prepended to the random initial population — the reference's
            # campaigns start near working configurations too
            seeds = []
            for s in (initial_individuals or []):
                try:
                    seeds.append(gp.parse_tree(s, self._pset))
                except (KeyError, ValueError, SyntaxError) as e:
                    if self.comm.rank == 0:
                        print(f"seed individual does not parse ({e}); "
                              "skipped", flush=True)
            population = seeds + [
                toolbox_generate()
                for _ in range(initial_population_size - len(seeds))]
            min_generation = 0
            logbook = []
            logbooks.append(logbook)

        if self.comm.size > 1:
            # the sharded-evaluation contract requires replicated
            # populations (same rng seed on every rank) — fail loudly
            # instead of silently assigning fitness to wrong individuals
            # stable across interpreters (str hashes are salted per process)
            digest = hashlib.sha256(
                "\n".join(sorted(str(i) for i in population))
                .encode()).hexdigest()
            digests = self.comm.allgather_object(digest)
            if len(set(digests)) != 1:
                raise RuntimeError(
                    "island ranks generated different populations; all "
                    "ranks must construct the Optimizer with the same "
                    "rng seed (parallel/comm.py replication contract)")

        if not use_checkpoint:
            # (a resumed population is the already-selected, already-scored
            # state at end of checkpoint.generation — re-selecting here
            # would perturb the restored evolution stream)
            self.evaluate_invalid(population)
            population = select(population, mu_)
            hof.update(population)
            record = nsga.compile_statistics(population, objectives)
            logbook.append({"gen": min_generation, "nevals": len(population),
                            **record})
            if verbose and self.comm.rank == 0:
                self._print_record(logbook[-1], objectives)

        for gen in range(min_generation + 1, generations + 1):
            if count >= generalization_interval:
                # generalization: grow the problem, re-evaluate everything
                # (reference optimization/program.py:512-539)
                level_offset += 1
                count = 0
                if self.problem_factory is not None:
                    population = self._generalize(min_level + level_offset,
                                                  max_level + level_offset,
                                                  population)
                    hof.clear()
                    self.evaluate_invalid(population)
                    population = select(population, mu_)
                    hof.update(population)

            if use_random_search:
                offspring = [toolbox_generate() for _ in range(lambda_)]
            else:
                n_parents = lambda_ + (lambda_ % 2)
                parents = [ind.clone()
                           for ind in select_for_mating(population, n_parents)]
                offspring = []
                for ind1, ind2 in zip(parents[::2], parents[1::2]):
                    child1 = child2 = None
                    tries = 0
                    while tries < 10 and (
                            child1 is None or len(child1) > 150
                            or self.individual_in_cache(child1)
                            or child2 is None or len(child2) > 150
                            or self.individual_in_cache(child2)):
                        choice = self.rng.random()
                        c1, c2 = ind1.clone(), ind2.clone()
                        if choice < crossover_probability:
                            child1, child2 = gp.cxOnePoint(c1, c2, rng=self.rng)
                        elif choice < crossover_probability + \
                                mutation_probability + 1e-9:
                            (child1,) = mutate(c1)
                            (child2,) = mutate(c2)
                        else:
                            child1, child2 = c1, c2
                        tries += 1
                    child1.fitness.invalidate()
                    child2.fitness.invalidate()
                    offspring.append(child1)
                    if len(offspring) < lambda_:
                        offspring.append(child2)
                    if len(offspring) >= lambda_:
                        break

            nevals = self.evaluate_invalid(offspring)
            hof.update(offspring)

            population = select(population + offspring, mu_)
            count += 1
            record = nsga.compile_statistics(population, objectives)
            logbook.append({"gen": gen, "nevals": nevals, **record})
            if verbose and self.comm.rank == 0:
                self._print_record(logbook[-1], objectives)

            if gen % checkpoint_frequency == 0:
                # end-of-generation state: post-selection population + rng +
                # cache + hof, so a resume continues the exact stream
                self._save_checkpoint(min_level, max_level, gen,
                                      finished_chunks, population, logbooks,
                                      hof, count, level_offset)

        hof.update(population)
        return population, logbook, hof, min_level + level_offset, \
            max_level + level_offset

    @staticmethod
    def _print_record(record, objectives):
        parts = [f"gen={record['gen']}", f"nevals={record['nevals']}"]
        for name in list(objectives) + ["size"]:
            s = record[name]
            parts.append(f"{name}[avg={s['avg']:.3g} min={s['min']:.3g}]")
        print("  ".join(parts), flush=True)

    def _save_checkpoint(self, min_level, max_level, gen, finished_chunks,
                         population, logbooks, hof=None, gen_count=0,
                         level_offset=0):
        if self.comm.rank != 0:     # rank-0-only I/O (reference :278-279)
            return
        try:
            os.makedirs(self.checkpoint_directory_path, exist_ok=True)
            cp = CheckPoint(min_level, max_level, gen,
                            list(finished_chunks or []), population, logbooks,
                            rng_state=self.rng.getstate(),
                            cache=dict(self.individual_cache),
                            hof_items=[ind.clone() for ind in hof]
                            if hof is not None else None,
                            gen_count=gen_count, level_offset=level_offset)
            cp.dump_to_file(
                os.path.join(self.checkpoint_directory_path, "checkpoint.p"))
        except (pickle.PickleError, TypeError, OSError) as e:
            print(f"checkpoint failed: {e}", flush=True)

    def _generalize(self, new_min_level, new_max_level, population):
        """Grow the problem, rebuild the grammar over the regrown hierarchy,
        and transfer the population onto it — the native counterpart of the
        reference re-initializing code generation at shifted levels
        (program.py:512-539).

        Grammar symbol names embed absolute levels (``P_3`` is the level-3
        prolongation entity), so trees cannot re-parse by name after the
        shift.  ``generate_primitive_set`` registers symbols in a
        deterministic order for a fixed hierarchy depth, so the transfer is
        positional: the i-th registered symbol of the old grammar maps to
        the i-th of the new one, and every tree carries over node-by-node."""
        old_pset = self._pset
        self._rebuild_problem(new_min_level, new_max_level)
        old_names = list(old_pset.mapping)
        new_names = list(self._pset.mapping)
        if len(old_names) != len(new_names):
            raise ValueError(
                "regrown grammar has a different symbol count "
                f"({len(new_names)} vs {len(old_names)}) — the problem "
                "factory changed the grammar shape, not just the levels")
        rename = dict(zip(old_names, new_names))
        reparsed = []
        for ind in population:
            new_ind = gp.Individual(
                [self._pset.mapping[rename[n.name]] for n in ind])
            reparsed.append(new_ind)
        return reparsed

    def _rebuild_problem(self, new_min_level, new_max_level):
        """Regrow the problem via ``problem_factory`` and rebuild the
        evaluator + primitive set over the new hierarchy."""
        if getattr(self.evaluator, "chain", None):
            # the finer-chunk chain was evolved on the OLD hierarchy; quietly
            # rebuilding without it would measure candidates against a
            # different program than the one being composed
            raise NotImplementedError(
                "mid-run generalization under a level-chunked run is not "
                "supported: set levels_per_run to span the full hierarchy "
                "or disable generalization_interval")
        problem = self.problem_factory(new_min_level, new_max_level)
        if problem.levels_total != self.problem.levels_total:
            raise ValueError(
                "problem_factory must preserve the hierarchy depth during "
                f"generalization (got {problem.levels_total} levels, "
                f"expected {self.problem.levels_total})")
        self.problem = problem
        self.evaluator = CycleEvaluator(
            problem, dtype=self.evaluator.dtype,
            max_iterations=self.evaluator.max_iterations,
            target_reduction=self.evaluator.target_reduction,
            device=self.evaluator.device)
        if self._pset_builder is not None:
            self._pset = self._pset_builder(problem)
        else:
            pset, _ = generate_primitive_set(
                problem.approximation, problem.rhs_entity,
                problem.level_contexts, problem.coarsest_operator,
                maximum_local_system_size=self._maximum_local_system_size,
                enable_partitioning=self._enable_partitioning,
                FAS=problem.nonlinear_term is not None,
                coupled_fields=getattr(problem, 'coupled_fields', False))
            self._pset = pset
        # regrow the robustness variants with the base problem: their old
        # psets name OLD-level entities, so every re-parse after the shift
        # would KeyError into infinity fitness — the round-1 stale-pset
        # failure mode, but for the variant grammars
        if self._robustness:
            if not self.robustness_factories or \
                    len(self.robustness_factories) != len(self._robustness):
                raise ValueError(
                    "mid-run generalization with robustness variants needs "
                    "robustness_factories (one (min_level, max_level) -> "
                    "problem callable per variant) so the variant grammars "
                    "regrow with the base problem")
            self.robustness_problems = [
                f(new_min_level, new_max_level)
                for f in self.robustness_factories]
            rebuilt = []
            for variant in self.robustness_problems:
                pset_v, _ = generate_primitive_set(
                    variant.approximation, variant.rhs_entity,
                    variant.level_contexts, variant.coarsest_operator,
                    maximum_local_system_size=self._maximum_local_system_size,
                    enable_partitioning=self._enable_partitioning,
                    FAS=variant.nonlinear_term is not None,
                    coupled_fields=getattr(variant, 'coupled_fields', False))
                ev_v = CycleEvaluator(
                    variant, dtype=self.evaluator.dtype,
                    max_iterations=self.evaluator.max_iterations,
                    target_reduction=self.evaluator.target_reduction,
                    device=self.evaluator.device)
                rebuilt.append((ev_v, pset_v))
            self._robustness = rebuilt
        self.individual_cache.clear()

    # -- algorithm frontends -------------------------------------------------

    def SOGP(self, **kwargs):
        self._n_objectives = 1
        return self._run(select=gp.select_unique_best,
                         select_for_mating=lambda pop, k: nsga.selTournament(
                             pop, k, tournsize=2, rng=self.rng),
                         objectives=["time_to_convergence"], **kwargs)

    def NSGAII(self, **kwargs):
        self._n_objectives = 2

        def select_for_mating(pop, k):
            if k % 4:
                k += 4 - k % 4
            return nsga.selTournamentDCD(pop, k, rng=self.rng)

        return self._run(select=nsga.selNSGA2,
                         select_for_mating=select_for_mating,
                         objectives=["convergence_factor", "execution_time"],
                         pareto=True, **kwargs)

    def NSGAIII(self, **kwargs):
        self._n_objectives = 2
        mu_ = kwargs.get("mu_", 32)
        ref_points = nsga.uniform_reference_points(2, mu_)

        def select(pop, k):
            return nsga.selNSGA3(pop, k, ref_points, rng=self.rng)

        return self._run(select=select,
                         select_for_mating=lambda pop, k: nsga.selRandom(
                             pop, k, rng=self.rng),
                         objectives=["convergence_factor", "execution_time"],
                         pareto=True, **kwargs)

    def _run(self, *, select, select_for_mating, objectives, pareto=False,
             pset, initial_population_size, generations, mu_, lambda_,
             min_level, max_level, generalization_interval=10 ** 9,
             crossover_probability=0.7, mutation_probability=0.3,
             logbooks=None, checkpoint=None, checkpoint_frequency=2,
             use_random_search=False, finished_chunks=None,
             pset_builder=None, initial_individuals=None, verbose=True):
        self._pset = pset
        if pset_builder is not None:
            self._pset_builder = pset_builder
        logbooks = logbooks if logbooks is not None else []
        hof = nsga.ParetoFront() if pareto else nsga.HallOfFame(2 * mu_)
        return self.ea_mu_plus_lambda(
            initial_population_size, generations, generalization_interval,
            mu_, lambda_, crossover_probability, mutation_probability,
            min_level, max_level, logbooks, select, select_for_mating, hof,
            objectives, checkpoint_frequency, checkpoint, use_random_search,
            finished_chunks, initial_individuals=initial_individuals,
            verbose=verbose)

    # -- top-level entry -----------------------------------------------------

    def estimate_execution_time(self, convergence_factor, execution_time):
        if convergence_factor < 1:
            return math.log(self.epsilon) / math.log(convergence_factor) \
                * execution_time
        return convergence_factor * math.sqrt(self.infinity) * execution_time

    def evolutionary_optimization(self, *, mu_=32, lambda_=32,
                                  population_initialization_factor=4,
                                  generations=20,
                                  generalization_interval=10 ** 9,
                                  crossover_probability=0.7,
                                  mutation_probability=0.3,
                                  optimization_method=None,
                                  levels_per_run=None,
                                  maximum_local_system_size=8,
                                  enable_partitioning=True,
                                  continue_from_checkpoint=False,
                                  use_random_search=False,
                                  initial_individuals=None,
                                  verbose=True):
        """Level-chunked evolution (reference optimization/program.py:770-902):
        the finest chunk evolves first (its coarse-grid solve is a default
        direct/CG solve of the operator below it); every subsequent, coarser
        chunk's candidates are measured as the coarse-grid solver spliced in
        underneath the already-evolved finer chain — the whole composed
        program is solved on the finest grid, the native counterpart of the
        reference's solver-program splicing (exastencils.py:485-537)."""
        problem = self.problem
        levels = problem.max_level - problem.min_level
        if levels_per_run is None:
            levels_per_run = levels
        contexts = problem.level_contexts
        FAS = problem.nonlinear_term is not None
        # FAS + chunked runs: the chunk boundary's coarse solve carries the
        # restricted-solution initial guess through the spliced chain
        # (lower.make_chain_applier initial_guess, apply_coarse_solver) —
        # matching the reference's generator-agnostic chunking with the FAS
        # backend (reference program.py:810-899, exastencils_FAS.py:440-446)
        if levels_per_run < levels and generalization_interval < generations:
            # reference program.py:780-783: stepwise generalization is only
            # supported for single-stage optimizations
            if self.comm.rank == 0:
                print("Warning: stepwise generalization only supported for "
                      "single-stage optimizations — disabling it", flush=True)
            generalization_interval = generations
        self._maximum_local_system_size = maximum_local_system_size
        self._enable_partitioning = enable_partitioning

        checkpoint = None
        cp_path = os.path.join(self.checkpoint_directory_path, "checkpoint.p")
        if continue_from_checkpoint and os.path.isfile(cp_path):
            try:
                checkpoint = load_checkpoint_from_file(cp_path)
            except (pickle.PickleError, EOFError):
                checkpoint = None
        finished: List[str] = list(getattr(checkpoint, "finished_chunks", [])
                                   or []) if checkpoint is not None else []

        if optimization_method is None:
            optimization_method = self.NSGAII

        base_evaluator = self.evaluator
        pops, logbooks, hofs = [], [], []
        best_expression = None
        best_individual = None
        #: finished chunks' best cycles, finest first (ChainLink per chunk)
        chain: List[ChainLink] = []
        variant_chains = [[] for _ in self.robustness_problems]

        def sort_key(ind):
            v = ind.fitness.values
            if len(v) == 2:
                return self.estimate_execution_time(v[0], v[1])
            return v[0]

        for ci, i in enumerate(range(0, levels, levels_per_run)):
            # chunk ci covers grammar over contexts[i : i+levels_per_run]
            chunk_contexts = contexts[i:i + levels_per_run]
            max_level = problem.max_level - i
            min_level = max_level - len(chunk_contexts)
            approximation, rhs = _chunk_entities(problem, chunk_contexts,
                                                 ci == 0)
            coarsest_op = _chunk_coarsest(problem, contexts, i,
                                          levels_per_run)
            pset, _ = generate_primitive_set(
                approximation, rhs, chunk_contexts, coarsest_op,
                maximum_local_system_size=maximum_local_system_size,
                enable_partitioning=enable_partitioning, FAS=FAS,
                coupled_fields=getattr(problem, 'coupled_fields', False))
            self.individual_cache.clear()
            self._pset = pset
            if ci == 0:
                self.evaluator = base_evaluator
            else:
                self.evaluator = CycleEvaluator(
                    problem, dtype=base_evaluator.dtype,
                    max_iterations=base_evaluator.max_iterations,
                    target_reduction=base_evaluator.target_reduction,
                    device=base_evaluator.device,
                    chain=list(chain), cand_entities=(approximation, rhs))

            # robustness variants: each candidate must also solve every
            # harder problem variant (reference Helmholtz k-doubling,
            # exastencils.py:518-532); under chunked runs each variant keeps
            # its own finished-chunk chain
            self._robustness = []
            variant_parts = []
            for vi, variant in enumerate(self.robustness_problems):
                v_ctxs = variant.level_contexts[i:i + levels_per_run]
                v_approx, v_rhs = _chunk_entities(variant, v_ctxs, ci == 0)
                v_coarsest = _chunk_coarsest(variant,
                                             variant.level_contexts, i,
                                             levels_per_run)
                pset_v, _ = generate_primitive_set(
                    v_approx, v_rhs, v_ctxs, v_coarsest,
                    maximum_local_system_size=maximum_local_system_size,
                    enable_partitioning=enable_partitioning, FAS=FAS,
                    coupled_fields=getattr(variant, 'coupled_fields',
                                           False))
                # variant evaluators inherit the base evaluator's settings
                # in BOTH branches (and in _rebuild_problem): a non-default
                # base dtype/iteration budget must not silently change the
                # variants' fitness thresholds
                if ci == 0:
                    ev_v = CycleEvaluator(
                        variant, dtype=base_evaluator.dtype,
                        max_iterations=base_evaluator.max_iterations,
                        target_reduction=base_evaluator.target_reduction,
                        device=base_evaluator.device)
                else:
                    ev_v = CycleEvaluator(
                        variant, dtype=base_evaluator.dtype,
                        max_iterations=base_evaluator.max_iterations,
                        target_reduction=base_evaluator.target_reduction,
                        device=base_evaluator.device,
                        chain=list(variant_chains[vi]),
                        cand_entities=(v_approx, v_rhs))
                self._robustness.append((ev_v, pset_v))
                variant_parts.append((v_approx, v_rhs, pset_v))

            def extend_chains(best_ind, best_expr, last_chunk):
                if last_chunk:
                    return
                chain.append(ChainLink(best_expr, approximation, rhs))
                for vi, (v_approx, v_rhs, pset_v) in enumerate(variant_parts):
                    ind_v = gp.parse_tree(str(best_ind), pset_v)
                    state_v = gp.compile_tree(ind_v, pset_v)
                    expr_v = state_v[0]
                    transformations.assign_cycle_ids(expr_v)
                    variant_chains[vi].append(
                        ChainLink(expr_v, v_approx, v_rhs))

            last_chunk = i + levels_per_run >= levels
            if ci < len(finished):
                # chunk completed before the checkpoint: restore its best
                # from the grammar string instead of re-evolving
                best_individual = gp.parse_tree(finished[ci], pset)
                best_expression = gp.compile_tree(best_individual, pset)[0]
                transformations.assign_cycle_ids(best_expression)
                extend_chains(best_individual, best_expression, last_chunk)
                pops.append([best_individual])
                hofs.append([best_individual])
                continue
            tmp = None
            if checkpoint is not None and ci == len(finished) and \
                    checkpoint.min_level == min_level and \
                    checkpoint.max_level == max_level:
                tmp = checkpoint

            pop, log, hof, _, _ = optimization_method(
                pset=pset,
                initial_population_size=population_initialization_factor * mu_,
                generations=generations, mu_=mu_, lambda_=lambda_,
                min_level=min_level, max_level=max_level,
                generalization_interval=generalization_interval,
                crossover_probability=crossover_probability,
                mutation_probability=mutation_probability,
                logbooks=logbooks, checkpoint=tmp,
                use_random_search=use_random_search,
                finished_chunks=finished,
                initial_individuals=initial_individuals if ci == 0 else None,
                verbose=verbose)

            ranked = sorted(hof, key=sort_key)
            pops.append(pop)
            hofs.append(hof)
            best_individual = ranked[0]
            state = gp.compile_tree(best_individual, self._pset)
            best_expression = state[0]
            transformations.assign_cycle_ids(best_expression)
            extend_chains(best_individual, best_expression, last_chunk)
            finished.append(str(best_individual))

        self.evaluator = base_evaluator
        return {"best_individual": best_individual,
                "best_expression": best_expression,
                "grammar_string": str(best_individual),
                "chunk_grammar_strings": list(finished),
                "chain": list(chain),
                "populations": pops, "logbooks": logbooks, "hofs": hofs}

    # -- re-evaluation of stored individuals ---------------------------------

    def evaluate_chunked_program(self, chunk_strings: List[str],
                                 levels_per_run: Optional[int] = None,
                                 maximum_local_system_size=8,
                                 enable_partitioning=True):
        """Rebuild a level-chunked run's solver from its per-chunk grammar
        strings (finest chunk first, ``result['chunk_grammar_strings']``)
        and re-measure the FULL composed program on the finest grid —
        the stored-solver analogue of the reference re-running a complete
        multi-run solver program (reference optimization/program.py:904-929
        over the spliced program of :810-899)."""
        problem = self.problem
        levels = problem.max_level - problem.min_level
        if levels_per_run is None:
            # ceil(levels / n_chunks) is only a GUESS at the original run's
            # chunking (9 levels in 3 chunks could have been 3+3+3 or
            # 4+4+1); a wrong guess is caught below, pass the original
            # levels_per_run to be exact
            levels_per_run = -(-levels // len(chunk_strings))
        n_chunks = len(range(0, levels, levels_per_run))
        if n_chunks != len(chunk_strings):
            raise ValueError(
                f"levels_per_run={levels_per_run} splits {levels} levels "
                f"into {n_chunks} chunks but {len(chunk_strings)} grammar "
                "strings were given — pass the original run's "
                "levels_per_run")
        contexts = problem.level_contexts
        FAS = problem.nonlinear_term is not None
        chain: List[ChainLink] = []
        last = None
        for ci, i in enumerate(range(0, levels, levels_per_run)):
            chunk_contexts = contexts[i:i + levels_per_run]
            # same chunk-entity construction as evolutionary_optimization —
            # both sites MUST stay in sync or re-evaluation rebuilds a
            # different program than the one evolved
            approximation, rhs = _chunk_entities(problem, chunk_contexts,
                                                 ci == 0)
            coarsest_op = _chunk_coarsest(problem, contexts, i,
                                          levels_per_run)
            pset, _ = generate_primitive_set(
                approximation, rhs, chunk_contexts, coarsest_op,
                maximum_local_system_size=maximum_local_system_size,
                enable_partitioning=enable_partitioning, FAS=FAS,
                coupled_fields=getattr(problem, 'coupled_fields', False))
            try:
                ind = gp.parse_tree(chunk_strings[ci], pset)
            except (KeyError, ValueError, SyntaxError) as e:
                raise ValueError(
                    f"chunk {ci} grammar string does not parse against the "
                    f"reconstructed {len(chunk_contexts)}-level chunk "
                    f"grammar (levels_per_run={levels_per_run} probably "
                    "differs from the original run's)") from e
            expr = gp.compile_tree(ind, pset)[0]
            transformations.assign_cycle_ids(expr)
            last = (expr, approximation, rhs)
            if i + levels_per_run < levels:
                chain.append(ChainLink(expr, approximation, rhs))
        expr, approximation, rhs = last
        evaluator = CycleEvaluator(
            problem, dtype=self.evaluator.dtype,
            max_iterations=self.evaluator.max_iterations,
            target_reduction=self.evaluator.target_reduction,
            device=self.evaluator.device, chain=chain,
            cand_entities=(approximation, rhs)) if chain else self.evaluator
        result = evaluator.evaluate_expression(
            expr, key="|".join(chunk_strings))
        return expr, result

    def generate_and_evaluate_program_from_grammar_representation(
            self, grammar_string: str, maximum_local_system_size=8,
            enable_partitioning=True):
        """Rebuild an individual from its tree string and re-measure it
        (reference optimization/program.py:904-929)."""
        problem = self.problem
        pset, _ = generate_primitive_set(
            problem.approximation, problem.rhs_entity,
            problem.level_contexts, problem.coarsest_operator,
            maximum_local_system_size=maximum_local_system_size,
            enable_partitioning=enable_partitioning,
            FAS=problem.nonlinear_term is not None,
            coupled_fields=getattr(problem, 'coupled_fields', False))
        individual = gp.parse_tree(grammar_string, pset)
        state = gp.compile_tree(individual, pset)
        expression = state[0]
        transformations.assign_cycle_ids(expression)
        result = self.evaluator.evaluate_expression(
            expression, key=grammar_string)
        return expression, result
