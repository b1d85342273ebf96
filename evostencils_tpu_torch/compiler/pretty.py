"""Copy of evostencils_tpu/compiler/pretty.py, kept in the port so that it
imports nothing of the JAX package.

Human-readable program listing of a cycle expression.

The reference round-trips every evolved cycle through a textual DSL —
`code_generation/exastencils.py:684-925` emits ExaSlang L3 and
`code_generation/layer4.py:1-201` pretty-prints an L4 AST.  The port
lowers IR straight to PyTorch programs, so there is no DSL artifact; this
module provides the equivalent *inspectable* form: a statement-oriented
listing of the multigrid program a cycle expression denotes, in evaluation
order, one smoothing / residual / transfer / coarse-solve step per line.

Use it to eyeball evolved individuals, diff two cycles structurally, or
embed the listing in logs next to the grammar string::

    print(pretty_cycle(cycle))
"""

from __future__ import annotations

from typing import Dict, List

from ..ir import base, system
from ..ir import partitioning as part
from ..ir.krylov import KrylovSubspaceMethod


def _level_of(grid) -> int:
    if isinstance(grid, list):
        return grid[0].level
    return grid.level


def _fmt_weight(w) -> str:
    try:
        return f"{float(w):g}"
    except (TypeError, ValueError):
        return str(w)


class _Printer:
    def __init__(self):
        self.lines: List[str] = []
        self.names: Dict[int, str] = {}
        self.counters: Dict[str, int] = {}

    def fresh(self, prefix: str, level: int) -> str:
        key = f"{prefix}{level}"
        n = self.counters.get(key, 0)
        self.counters[key] = n + 1
        return f"{key}" if n == 0 else f"{key}_{n}"

    def stmt(self, lhs: str, rhs: str, note: str = "") -> None:
        pad = " " * max(1, 28 - len(lhs) - len(rhs) - 5)
        self.lines.append(f"  {lhs} = {rhs}" + (f"{pad}// {note}" if note
                                                else ""))

    # -- operand rendering -------------------------------------------------

    def operand(self, expr) -> str:
        if expr is None:
            return "0"
        if id(expr) in self.names:
            return self.names[id(expr)]
        if isinstance(expr, base.Cycle):
            return self.cycle(expr)
        if isinstance(expr, base.Residual):
            return self.residual(expr)
        if isinstance(expr, base.CoarseGridSolver):
            return f"CGS(A@{_level_of(expr.grid)})"
        if isinstance(expr, KrylovSubspaceMethod):
            return (f"{expr.name}(A@{_level_of(expr.grid)}, "
                    f"iters={expr.iterations})")
        if isinstance(expr, system.ElementwiseDiagonal):
            return f"point_diag({self.operand(expr.operand)})"
        if isinstance(expr, system.Diagonal):
            return f"decoupled_diag({self.operand(expr.operand)})"
        if isinstance(expr, system.Jacobian):
            return (f"newton[{expr.n_newton_steps}]"
                    f"({self.operand(expr.operand)})")
        if isinstance(expr, base.Diagonal):
            return f"diag({self.operand(expr.operand)})"
        if isinstance(expr, base.LowerTriangle):
            return f"lower({self.operand(expr.operand)})"
        if isinstance(expr, base.UpperTriangle):
            return f"upper({self.operand(expr.operand)})"
        if isinstance(expr, base.BlockDiagonal):
            return (f"block_diag{tuple(expr.block_size)}"
                    f"({self.operand(expr.operand)})")
        if isinstance(expr, base.Inverse):
            return f"inv({self.operand(expr.operand)})"
        if isinstance(expr, base.Transpose):
            return f"transpose({self.operand(expr.operand)})"
        if isinstance(expr, base.Multiplication):
            return (f"{self.operand(expr.operand1)} * "
                    f"{self.operand(expr.operand2)}")
        if isinstance(expr, base.Addition):
            return (f"({self.operand(expr.operand1)} + "
                    f"{self.operand(expr.operand2)})")
        if isinstance(expr, base.Subtraction):
            return (f"({self.operand(expr.operand1)} - "
                    f"{self.operand(expr.operand2)})")
        if isinstance(expr, base.Scaling):
            return (f"{_fmt_weight(expr.factor)} * "
                    f"{self.operand(expr.operand)}")
        if isinstance(expr, (base.Restriction, system.Restriction)):
            return f"R@{_level_of(expr.grid)}"
        if isinstance(expr, (base.Prolongation, system.Prolongation)):
            return f"P@{_level_of(expr.grid)}"
        if isinstance(expr, (base.ZeroOperator, system.ZeroOperator)):
            return "0"
        if isinstance(expr, (base.Identity, system.Identity)):
            return "I"
        if isinstance(expr, (base.Operator, system.Operator)):
            return f"{expr.name}@{_level_of(expr.grid)}"
        if isinstance(expr, (base.ZeroApproximation,
                             system.ZeroApproximation)):
            return "0"
        if isinstance(expr, (base.RightHandSide, system.RightHandSide)):
            return f"{expr.name}@{_level_of(expr.grid)}"
        if isinstance(expr, (base.Approximation, system.Approximation)):
            return f"{expr.name}@{_level_of(expr.grid)}"
        return str(expr)

    # -- statements --------------------------------------------------------

    def residual(self, expr: base.Residual) -> str:
        lvl = _level_of(expr.grid)
        name = self.fresh("r", lvl)
        self.stmt(name, f"{self.operand(expr.rhs)} - "
                        f"{self.operand(expr.operator)} * "
                        f"{self.operand(expr.approximation)}",
                  note=f"residual @ level {lvl}")
        self.names[id(expr)] = name
        return name

    def cycle(self, expr: base.Cycle) -> str:
        lvl = _level_of(expr.grid)
        prev = self.operand(expr.approximation)
        corr = self.operand(expr.correction)
        name = self.fresh("u", lvl)
        get_name = getattr(expr.partitioning, "get_name", None)
        color = ("" if expr.partitioning is part.Single or get_name is None
                 else f" [{get_name()}]")
        self.stmt(name,
                  f"{prev} + {_fmt_weight(expr.relaxation_factor)} * {corr}",
                  note=f"update @ level {lvl}{color}")
        self.names[id(expr)] = name
        return name


def pretty_cycle(expression: base.Cycle, title: str = "gen_mgCycle") -> str:
    """Render a cycle expression as a statement listing (one line per
    multigrid operation, in evaluation order)."""
    p = _Printer()
    lvl = _level_of(expression.grid)
    result = p.operand(expression)
    header = f"{title}@{lvl}:"
    return "\n".join([header] + p.lines + [f"  return {result}"])
