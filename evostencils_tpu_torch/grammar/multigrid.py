"""Copy of evostencils_tpu/grammar/multigrid.py, kept in the port so that it imports
nothing of the JAX package.

Typed multigrid grammar (G3P productions).

The heart of solver synthesis: a typed grammar whose derivation trees are
legal multigrid cycles.  Productions are state-transition closures that
incrementally assemble the cycle IR — residual computation, smoother
application, coarsening, coarse-grid correction, coarse-grid solve — with
guard types ensuring the root state (u, f) is consumed exactly once and
every intermediate state is well-formed.

Reference parity: evostencils/grammar/multigrid.py:176-478.  The reference
builds its per-level operators from ExaStencils L2 output; here they come
directly from the problem definition (problems/api.LevelContext), which is
the native replacement for the ExaSlang round-trip.

Deviation: block-shape terminals are uniform across fields (the batched
block-solve plans require a single block lattice; the reference permits
per-field shapes — grammar/multigrid.py:388-407).
"""

from __future__ import annotations

import itertools
from functools import reduce
from typing import List, Optional

import numpy as np

from ..ir import base, system, smoother
from ..ir import partitioning as part
from .typing import Type
from .gp import PrimitiveSet


class Terminals:
    """Per-level operator bundle exposed to the grammar
    (reference grammar/multigrid.py:176-194)."""

    def __init__(self, approximation, operator, coarse_operator,
                 restriction_operators, prolongation_operators,
                 coarse_grid_solver, relaxation_factor_interval,
                 partitionings=None):
        self.approximation = approximation
        self.operator = operator
        self.coarse_operator = coarse_operator
        self.restriction_operators = restriction_operators
        self.prolongation_operators = prolongation_operators
        self.coarse_grid_solver = coarse_grid_solver
        self.relaxation_factor_interval = relaxation_factor_interval
        self.no_partitioning = part.Single
        self.partitionings = partitionings or []

    @property
    def grid(self):
        return self.operator.grid

    @property
    def coarse_grid(self):
        return self.coarse_operator.grid


class Types:
    """Per-level nonterminals: S (approximation state), C (correction
    state), guarded variants, operators, transfers
    (reference grammar/multigrid.py:196-236)."""

    @staticmethod
    def _take(identifier, previous, attr, guard=False):
        if previous is None:
            return Type(identifier, guard)
        return getattr(previous, attr)

    def __init__(self, depth: int, previous_types: Optional["Types"] = None,
                 FAS: bool = False):
        p = previous_types
        self.S_h = self._take(f"S_{depth}", p, "S_2h")
        self.S_guard_h = self._take(f"S_guard_{depth}", p, "S_guard_2h", True)
        self.C_h = self._take(f"C_{depth}", p, "C_2h")
        self.C_guard_h = self._take(f"C_guard_{depth}", p, "C_guard_2h", True)
        self.x_h = self._take(f"x_{depth}", p, "x_2h")
        self.A_h = self._take(f"A_{depth}", p, "A_2h")
        self.R_h = Type(f"R_{depth}")

        self.S_2h = Type(f"S_{depth + 1}")
        self.S_guard_2h = Type(f"S_guard_{depth + 1}", guard=True)
        self.C_2h = Type(f"C_{depth + 1}")
        self.C_guard_2h = Type(f"C_guard_{depth + 1}", guard=True)
        self.x_2h = Type(f"x_{depth + 1}")
        self.A_2h = Type(f"A_{depth + 1}")
        self.P_2h = Type(f"P_{depth + 1}")
        self.CGS_2h = Type(f"CGS_{depth + 1}")

        self.Partitioning = self._take("Partitioning", p, "Partitioning")
        self.RelaxationFactorIndex = self._take("RelaxationFactorIndex", p,
                                                "RelaxationFactorIndex")
        self.BlockShape = self._take("BlockShape", p, "BlockShape")
        if FAS:
            self.NewtonSteps = self._take("NewtonSteps", p, "NewtonSteps")


def add_level(pset: PrimitiveSet, terminals: Terminals, types: Types,
              depth: int, coarsest: bool = False, FAS: bool = False,
              coupled_fields: bool = False):
    """Register one level's productions (reference
    grammar/multigrid.py:238-385).

    ``coupled_fields``: the system's fields are components of one logical
    complex field (split-complex Helmholtz) — "decoupled" smoothing then
    means complex point division, i.e. collective over the block, keeping
    the search space identical to the complex formulation's."""
    if not coarsest:
        pset.addTerminal(system.ZeroApproximation(terminals.coarse_grid),
                         types.x_2h, f"zero_{depth + 1}")
        pset.addTerminal(terminals.coarse_operator, types.A_2h,
                         f"A_{depth + 1}")
    for prolongation in terminals.prolongation_operators:
        pset.addTerminal(prolongation, types.P_2h, f"{prolongation.name}")
    for restriction in terminals.restriction_operators:
        pset.addTerminal(restriction, types.R_h, f"{restriction.name}")

    scalar_equation = len(terminals.grid) == 1

    # -- state transitions ---------------------------------------------------

    def residual(state):
        approximation, rhs = state
        return base.Cycle(approximation, rhs,
                          base.Residual(terminals.operator, approximation, rhs),
                          predecessor=approximation.predecessor
                          if hasattr(approximation, "predecessor") else None)

    def apply(operator, cycle):
        cycle.correction = base.Multiplication(operator, cycle.correction)
        return cycle

    def update(relaxation_factor_index, partitioning_, cycle):
        cycle.relaxation_factor = \
            terminals.relaxation_factor_interval[relaxation_factor_index]
        cycle.partitioning = partitioning_
        return cycle, cycle.rhs

    def initiate_cycle(coarse_operator, coarse_approximation, cycle):
        coarse_residual = base.Residual(coarse_operator, coarse_approximation,
                                        cycle.correction)
        new_cycle = base.Cycle(coarse_approximation, cycle.correction,
                               coarse_residual)
        new_cycle.predecessor = cycle
        return new_cycle

    def coarse_grid_correction(prolongation_operator, state, restriction=None):
        cycle = state[0]
        if FAS:
            correction_FAS = base.mul(restriction, cycle.predecessor.approximation)
            correction_c = base.sub(cycle, correction_FAS)
            correction = base.mul(prolongation_operator, correction_c)
        else:
            correction = base.Multiplication(prolongation_operator, cycle)
        cycle.predecessor.correction = correction
        return cycle.predecessor

    def restrict(restriction_operator, cycle):
        if FAS:
            residual_c = base.mul(restriction_operator, cycle.correction)
            residual_FAS = base.mul(
                terminals.coarse_operator,
                base.Multiplication(restriction_operator, cycle.approximation))
            cycle.correction = base.add(residual_c, residual_FAS)
            return cycle
        return apply(restriction_operator, cycle)

    def coarsening(coarse_operator, coarse_approximation, restriction_operator,
                   cycle):
        cycle = restrict(restriction_operator, cycle)
        if FAS:
            # The reference's FAS backend initializes the coarse solution
            # field with the restricted fine solution before smoothing
            # (exastencils_FAS.py:118-133 assigns solution <- R u alongside
            # the FASApproximation store), overriding the grammar's zero
            # terminal.  Without this seed the Newton smoother linearizes
            # around zero and grammar FAS cycles lose their tau-corrected
            # coarse information (measured rho 0.95 vs 0.13 for the same
            # V(2,2) at 127^2).
            restricted_solution = base.mul(restriction_operator,
                                           cycle.approximation)
            coarse_approximation = base.Cycle(
                coarse_approximation, cycle.correction, restricted_solution,
                relaxation_factor=1.0)
        return initiate_cycle(coarse_operator, coarse_approximation, cycle)

    def update_with_coarse_grid_correction(relaxation_factor_index,
                                           prolongation_operator, state,
                                           restriction_operator=None):
        cycle = coarse_grid_correction(prolongation_operator, state,
                                       restriction_operator)
        return update(relaxation_factor_index, terminals.no_partitioning, cycle)

    def smoothing(relaxation_factor_index, partitioning_, generate_smoother,
                  cycle):
        if not isinstance(cycle.correction, base.Residual):
            raise ValueError("invalid production: expected residual")
        smoothing_operator = generate_smoother(cycle.correction.operator)
        cycle = apply(base.Inverse(smoothing_operator), cycle)
        return update(relaxation_factor_index, partitioning_, cycle)

    def decoupled_jacobi(relaxation_factor_index, partitioning_, cycle):
        gen = (smoother.generate_collective_jacobi if coupled_fields
               else smoother.generate_decoupled_jacobi)
        return smoothing(relaxation_factor_index, partitioning_, gen, cycle)

    def collective_jacobi(relaxation_factor_index, partitioning_, cycle):
        return smoothing(relaxation_factor_index, partitioning_,
                         smoother.generate_collective_jacobi, cycle)

    def collective_block_jacobi(relaxation_factor_index, block_shape, cycle):
        def factory(operator):
            return smoother.generate_collective_block_jacobi(operator,
                                                             block_shape)
        return smoothing(relaxation_factor_index, part.Single, factory, cycle)

    def jacobi_picard(relaxation_factor_index, partitioning_, cycle):
        return smoothing(relaxation_factor_index, partitioning_,
                         smoother.generate_jacobi_picard, cycle)

    def jacobi_newton(relaxation_factor_index, partitioning_, n_newton_steps,
                      cycle):
        def factory(operator):
            return smoother.generate_jacobi_newton(operator, n_newton_steps)
        return smoothing(relaxation_factor_index, partitioning_, factory, cycle)

    def correct_with_coarse_grid_solver(relaxation_factor_index,
                                        prolongation_operator,
                                        coarse_grid_solver,
                                        restriction_operator, cycle):
        cycle = restrict(restriction_operator, cycle)
        if FAS:
            restricted_solution_FAS = base.mul(restriction_operator,
                                               cycle.approximation)
            # per-use solver node carrying the FAS initial guess
            cgs_local = base.CoarseGridSolver(
                coarse_grid_solver.operator, coarse_grid_solver.expression,
                initial_guess=restricted_solution_FAS)
            approximation_c = base.mul(cgs_local, cycle.correction)
            correction = base.mul(prolongation_operator,
                                  base.sub(approximation_c,
                                           restricted_solution_FAS))
            cycle.correction = correction
        else:
            cycle = apply(prolongation_operator,
                          apply(coarse_grid_solver, cycle))
        return update(relaxation_factor_index, terminals.no_partitioning, cycle)

    def add_primitive(f, fixed_types, in_types, out_types, name):
        for t_in, t_out in zip(in_types, out_types):
            pset.addPrimitive(f, fixed_types + [t_in], t_out,
                              f"{name}__{t_in.identifier}"
                              if t_in is not in_types[0] else name)

    # -- productions ---------------------------------------------------------
    add_primitive(residual, [], [types.S_h, types.S_guard_h],
                  [types.C_h, types.C_guard_h], f"residual_{depth}")

    if not scalar_equation:
        # under coupled_fields the production smooths collectively (the
        # (re, im) pair is one logical field); register it under a
        # DISTINCT name so saved grammar strings/checkpoints can never be
        # silently reinterpreted when the flag changes (round-3 advisor)
        add_primitive(decoupled_jacobi,
                      [types.RelaxationFactorIndex, types.Partitioning],
                      [types.C_h, types.C_guard_h],
                      [types.S_h, types.S_guard_h],
                      (f"coupled_point_jacobi_{depth}" if coupled_fields
                       else f"decoupled_jacobi_{depth}"))
    if not FAS:
        add_primitive(collective_jacobi,
                      [types.RelaxationFactorIndex, types.Partitioning],
                      [types.C_h, types.C_guard_h],
                      [types.S_h, types.S_guard_h],
                      f"collective_jacobi_{depth}")
        add_primitive(collective_block_jacobi,
                      [types.RelaxationFactorIndex, types.BlockShape],
                      [types.C_h, types.C_guard_h],
                      [types.S_h, types.S_guard_h],
                      f"collective_block_jacobi_{depth}")
    else:
        add_primitive(jacobi_picard,
                      [types.RelaxationFactorIndex, types.Partitioning],
                      [types.C_h, types.C_guard_h],
                      [types.S_h, types.S_guard_h],
                      f"jacobi_picard_{depth}")
        add_primitive(jacobi_newton,
                      [types.RelaxationFactorIndex, types.Partitioning,
                       types.NewtonSteps],
                      [types.C_h, types.C_guard_h],
                      [types.S_h, types.S_guard_h],
                      f"jacobi_newton_{depth}")

    if not coarsest:
        if FAS:
            # FAS coarse-grid correction needs the restriction operator for
            # the solution transfer (reference grammar/multigrid.py:366-375)
            pset.addPrimitive(
                update_with_coarse_grid_correction,
                [types.RelaxationFactorIndex, types.P_2h, types.S_2h, types.R_h],
                types.S_h, f"cgc_{depth}")
            pset.addPrimitive(
                update_with_coarse_grid_correction,
                [types.RelaxationFactorIndex, types.P_2h, types.S_guard_2h,
                 types.R_h],
                types.S_guard_h, f"cgc_{depth}__guard")
        else:
            add_primitive(update_with_coarse_grid_correction,
                          [types.RelaxationFactorIndex, types.P_2h],
                          [types.S_2h, types.S_guard_2h],
                          [types.S_h, types.S_guard_h],
                          f"cgc_{depth}")
        add_primitive(coarsening, [types.A_2h, types.x_2h, types.R_h],
                      [types.C_h, types.C_guard_h],
                      [types.C_2h, types.C_guard_2h],
                      f"coarsening_{depth}")
    else:
        # NOTE: both the guarded and unguarded correction chains produce an
        # *unguarded* S here — the coarse-grid solve is the only production
        # that discharges the guard, which is what forces every derivation to
        # reach the coarsest level (and makes typed generation terminate).
        # Mirrors reference grammar/multigrid.py:384.
        add_primitive(correct_with_coarse_grid_solver,
                      [types.RelaxationFactorIndex, types.P_2h, types.CGS_2h,
                       types.R_h],
                      [types.C_h, types.C_guard_h],
                      [types.S_h, types.S_h],
                      f"cgs_{depth}")
        pset.addTerminal(terminals.coarse_grid_solver, types.CGS_2h,
                         f"CGS_{depth + 1}")


def add_block_shapes(pset, n_fields, grid, types, dimension,
                     maximum_local_system_size):
    """Per-field block-shape terminals: every combination of per-field
    block lattices with n_fields < total unknowns <=
    maximum_local_system_size (reference grammar/multigrid.py:388-407 —
    fields of a system may carry different block shapes, e.g. elasticity
    (1,2)/(2,1)).  Uniform combinations keep the compact ``bs_AxB`` name;
    mixed ones join the per-field shapes with ``_``."""
    shapes = []

    def gen(shape, remaining_dims):
        if remaining_dims == 0:
            shapes.append(tuple(shape))
            return
        for k in range(1, maximum_local_system_size + 1):
            gen(shape + [k], remaining_dims - 1)

    gen([], dimension)
    for combo in itertools.product(shapes, repeat=n_fields):
        total = sum(reduce(lambda a, b: a * b, shape, 1) for shape in combo)
        if not n_fields < total <= maximum_local_system_size:
            continue
        if all(shape == combo[0] for shape in combo):
            name = "bs_" + "x".join(str(s) for s in combo[0])
        else:
            name = "bs_" + "_".join(
                "x".join(str(s) for s in shape) for shape in combo)
        pset.addTerminal(tuple(combo), types.BlockShape, name)


def generate_primitive_set(approximation, rhs, level_contexts,
                           coarsest_operator, *,
                           relaxation_factor_samples: int = 37,
                           maximum_local_system_size: int = 8,
                           coarse_grid_solver_expression=None,
                           depth: Optional[int] = None,
                           enable_partitioning: bool = True,
                           FAS: bool = False,
                           coupled_fields: bool = False):
    """Assemble the full multi-level grammar (reference
    grammar/multigrid.py:409-478).

    ``level_contexts[k]`` supplies operator/transfers for grammar level k;
    the operator below the last used context is the coarse-grid-solver
    target.
    """
    if depth is None:
        depth = len(level_contexts)
    if depth < 1 or depth > len(level_contexts):
        raise ValueError(f"depth {depth} out of range")
    relaxation_factor_interval = np.linspace(0.1, 1.9,
                                             relaxation_factor_samples)

    def coarse_op(k):
        if k + 1 < len(level_contexts):
            return level_contexts[k + 1].operator
        return coarsest_operator

    ctx = level_contexts[0]
    terminals = Terminals(
        approximation, ctx.operator, coarse_op(0),
        [ctx.restriction], [ctx.prolongation],
        base.CoarseGridSolver(coarse_op(0), coarse_grid_solver_expression),
        relaxation_factor_interval,
        [part.RedBlack] if enable_partitioning else [])
    types = Types(0, FAS=FAS)
    pset = PrimitiveSet("main", types.S_h)
    pset.addTerminal((approximation, rhs), types.S_guard_h, "u_and_f")
    pset.addTerminal(part.Single, types.Partitioning, "single")
    if enable_partitioning and not FAS:
        pset.addTerminal(part.RedBlack, types.Partitioning, "red_black")
    for i in range(relaxation_factor_samples):
        pset.addTerminal(i, types.RelaxationFactorIndex, f"rf_{i}")
    dimension = terminals.grid[0].dimension
    if not FAS:
        add_block_shapes(pset, len(terminals.grid), terminals.grid, types,
                         dimension, maximum_local_system_size)
    else:
        for i in (1, 2, 3, 4):
            pset.addTerminal(i, types.NewtonSteps, f"newton_{i}")

    coarsest = depth == 1
    add_level(pset, terminals, types, 0, coarsest=coarsest, FAS=FAS,
              coupled_fields=coupled_fields)
    terminal_list = [terminals]
    for k in range(1, depth):
        ctx = level_contexts[k]
        coarse_approximation = system.ZeroApproximation(terminals.coarse_grid)
        coarsest = k == depth - 1
        terminals = Terminals(
            coarse_approximation, ctx.operator, coarse_op(k),
            [ctx.restriction], [ctx.prolongation],
            base.CoarseGridSolver(coarse_op(k), coarse_grid_solver_expression),
            relaxation_factor_interval,
            [part.RedBlack] if enable_partitioning else [])
        types = Types(k, previous_types=types, FAS=FAS)
        add_level(pset, terminals, types, k, coarsest=coarsest, FAS=FAS,
                  coupled_fields=coupled_fields)
        terminal_list.append(terminals)
    return pset, terminal_list
