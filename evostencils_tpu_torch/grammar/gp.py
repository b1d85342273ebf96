"""Copy of evostencils_tpu/grammar/gp.py, kept in the port so that it imports
nothing of the JAX package.

Native typed genetic-programming engine.

Replaces DEAP (not available in this image; SURVEY.md §2.3 calls for a
native reimplementation).  Trees are flat prefix-order lists of lightweight,
picklable nodes; primitive/terminal payloads (closures, IR objects) live in
the :class:`PrimitiveSet` context, looked up by name at compile time — so
populations and checkpoints pickle cleanly, and ``str(tree)`` is an exact,
re-parseable representation (the reference relies on the same property via
``eval(str(tree), pset.context)``, optimization/program.py:904-929).

Generation/mutation semantics mirror reference grammar/gp.py:6-135:
stack-based typed growth with optional subtree reinsertion, 150-node cap,
same-signature node replacement, and regrow-with-50%-reuse subtree mutation.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .typing import Type


@dataclass(frozen=True)
class Node:
    """One tree node: a named reference into the pset mapping."""
    name: str
    arity: int
    ret: Type
    args: Tuple[Type, ...] = ()

    def format(self, *arg_strings: str) -> str:
        if self.arity == 0:
            return self.name
        return f"{self.name}({','.join(arg_strings)})"


class PrimitiveSet:
    """Typed primitive/terminal registry with a by-name payload context."""

    def __init__(self, name: str, ret_type: Type):
        self.name = name
        self.ret = ret_type
        self.primitives: Dict[Type, List[Node]] = {}
        self.terminals: Dict[Type, List[Node]] = {}
        self.mapping: Dict[str, Node] = {}
        self.context: Dict[str, object] = {}
        self._terminal_counter = 0

    def _register(self, node: Node, payload, is_primitive: bool):
        if node.name in self.mapping:
            raise ValueError(f"duplicate grammar symbol {node.name!r}")
        self.mapping[node.name] = node
        self.context[node.name] = payload
        target = self.primitives if is_primitive else self.terminals
        for t in (node.ret,) + node.args:
            self.primitives.setdefault(t, [])
            self.terminals.setdefault(t, [])
        target[node.ret].append(node)

    def addPrimitive(self, fn: Callable, arg_types: Sequence[Type],
                     ret_type: Type, name: str):
        node = Node(name, len(arg_types), ret_type, tuple(arg_types))
        self._register(node, fn, True)

    def addTerminal(self, value, type_: Type, name: Optional[str] = None):
        if name is None:
            name = f"t{self._terminal_counter}"
            self._terminal_counter += 1
        node = Node(name, 0, type_)
        self._register(node, value, False)


class Fitness:
    """Minimizing fitness tuple (the reference uses DEAP weights (-1, -1))."""

    __slots__ = ("_values",)

    def __init__(self):
        self._values: Optional[Tuple[float, ...]] = None

    @property
    def valid(self) -> bool:
        return self._values is not None

    @property
    def values(self) -> Tuple[float, ...]:
        return self._values

    @values.setter
    def values(self, v):
        self._values = tuple(float(x) for x in v)

    def invalidate(self):
        self._values = None

    def dominates(self, other: "Fitness") -> bool:
        """Pareto dominance for minimization."""
        not_worse = all(a <= b for a, b in zip(self._values, other._values))
        strictly_better = any(a < b for a, b in zip(self._values, other._values))
        return not_worse and strictly_better

    def __repr__(self):
        return f"Fitness({self._values})"


class Individual(list):
    """A prefix-order tree of Nodes with fitness (DEAP PrimitiveTree-alike)."""

    def __init__(self, nodes=()):
        super().__init__(nodes)
        self.fitness = Fitness()
        # NSGA-II bookkeeping
        self.crowding_distance = 0.0

    def __str__(self):
        if not self:
            return ""
        out, _ = _format(self, 0)
        return out

    def clone(self) -> "Individual":
        child = Individual(self)
        if self.fitness.valid:
            child.fitness.values = self.fitness.values
        return child

    def searchSubtree(self, begin: int) -> slice:
        """Slice spanning the subtree rooted at index ``begin``."""
        end = begin + 1
        total = self[begin].arity
        while total > 0:
            total += self[end].arity - 1
            end += 1
        return slice(begin, end)


def _format(tree: Sequence[Node], pos: int) -> Tuple[str, int]:
    node = tree[pos]
    pos += 1
    args = []
    for _ in range(node.arity):
        s, pos = _format(tree, pos)
        args.append(s)
    return node.format(*args), pos


def compile_tree(tree: Sequence[Node], pset: PrimitiveSet):
    """Evaluate the tree bottom-up through the pset context."""

    def rec(pos: int):
        node = tree[pos]
        pos += 1
        payload = pset.context[node.name]
        if node.arity == 0:
            return payload, pos
        args = []
        for _ in range(node.arity):
            value, pos = rec(pos)
            args.append(value)
        return payload(*args), pos

    value, end = rec(0)
    if end != len(tree):
        raise ValueError("malformed tree: trailing nodes")
    return value


def parse_tree(expression: str, pset: PrimitiveSet) -> Individual:
    """Inverse of ``str(tree)``: rebuild an Individual from its string
    (the safe analogue of the reference's eval(grammar_string),
    optimization/program.py:918)."""
    tokens = []
    token = ""
    for ch in expression:
        if ch in "(),":
            if token.strip():
                tokens.append(token.strip())
            token = ""
            if ch != ",":
                tokens.append(ch)
        else:
            token += ch
    if token.strip():
        tokens.append(token.strip())

    nodes: List[Node] = []

    def rec(pos: int) -> int:
        name = tokens[pos]
        node = pset.mapping[name]
        nodes.append(node)
        pos += 1
        if pos < len(tokens) and tokens[pos] == "(":
            pos += 1
            for _ in range(node.arity):
                pos = rec(pos)
            if tokens[pos] != ")":
                raise ValueError(f"expected ')' at token {pos}")
            pos += 1
        elif node.arity != 0:
            raise ValueError(f"primitive {name} used without arguments")
        return pos

    end = rec(0)
    if end != len(tokens):
        raise ValueError("trailing tokens in grammar string")
    return Individual(nodes)


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------

def generate(pset: PrimitiveSet, min_height: int, max_height: int,
             condition: Callable[[int, int], bool], return_type: Type = None,
             subtree: Optional[Sequence[Node]] = None,
             rng: random.Random = random) -> List[Node]:
    """Stack-based typed tree growth with optional subtree reinsertion
    (reference gp.py:6-43)."""
    type_ = pset.ret if return_type is None else return_type
    expression: List[Node] = []
    height = rng.randint(min_height, max_height)
    stack = [(0, type_)]
    subtree_inserted = subtree is None
    while stack:
        depth, type_ = stack.pop()
        if not subtree_inserted and type_ == return_type and expression:
            expression.extend(subtree)
            subtree_inserted = True
            continue
        terminals = pset.terminals.get(type_, [])
        primitives = pset.primitives.get(type_, [])
        if condition(height, depth):
            nodes = terminals + primitives
        else:
            nodes = terminals if terminals else primitives
        if not nodes:
            raise RuntimeError(f"no terminal or primitive produces {type_}")
        choice = rng.choice(nodes)
        if choice.arity > 0:
            for arg in reversed(choice.args):
                stack.append((depth + 1, arg))
        expression.append(choice)
    return expression


def genGrow(pset: PrimitiveSet, min_height: int, max_height: int,
            type_: Type = None, size_limit: int = 150,
            rng: random.Random = random) -> Individual:
    def condition(height, depth):
        return depth < height

    result = generate(pset, min_height, max_height, condition, type_, rng=rng)
    while len(result) > size_limit:
        result = generate(pset, min_height, max_height, condition, type_,
                          rng=rng)
    return Individual(result)


# ---------------------------------------------------------------------------
# Variation operators
# ---------------------------------------------------------------------------

def cxOnePoint(ind1: Individual, ind2: Individual,
               rng: random.Random = random) -> Tuple[Individual, Individual]:
    """Typed one-point crossover: swap subtrees with a common return type."""
    if len(ind1) < 2 or len(ind2) < 2:
        return ind1, ind2
    types1: Dict[Type, List[int]] = {}
    types2: Dict[Type, List[int]] = {}
    for i, node in enumerate(ind1[1:], 1):
        types1.setdefault(node.ret, []).append(i)
    for i, node in enumerate(ind2[1:], 1):
        types2.setdefault(node.ret, []).append(i)
    common = set(types1) & set(types2)
    if not common:
        return ind1, ind2
    type_ = rng.choice(sorted(common, key=lambda t: (t.identifier, t.guard)))
    i1 = rng.choice(types1[type_])
    i2 = rng.choice(types2[type_])
    s1, s2 = ind1.searchSubtree(i1), ind2.searchSubtree(i2)
    ind1[s1], ind2[s2] = ind2[s2], ind1[s1]
    return ind1, ind2


def mutNodeReplacement(individual: Individual, pset: PrimitiveSet,
                       rng: random.Random = random) -> Tuple[Individual]:
    """Replace one node by another with the same signature
    (reference gp.py:84-108)."""
    if len(individual) < 2:
        return (individual,)
    for _ in range(1000):
        index = rng.randrange(1, len(individual))
        node = individual[index]
        if node.arity == 0:
            terminals = pset.terminals[node.ret]
            individual[index] = rng.choice(terminals)
            return (individual,)
        prims = [p for p in pset.primitives[node.ret] if p.args == node.args]
        if len(prims) > 1:
            individual[index] = rng.choice(prims)
            return (individual,)
    return (individual,)


def mutate_subtree(individual: Individual, min_height: int, max_height: int,
                   pset: PrimitiveSet,
                   rng: random.Random = random) -> Tuple[Individual]:
    """Regrow a random subtree; with probability 0.5 the old subtree is
    re-inserted somewhere inside the regrown one (reference gp.py:111-124)."""
    index = rng.randrange(len(individual))
    node = individual[index]
    slice_ = individual.searchSubtree(index)

    def condition(height, depth):
        return depth < height

    subtree = list(individual[slice_]) if rng.random() < 0.5 else None
    new_subtree = generate(pset, min_height, max_height, condition, node.ret,
                           subtree, rng=rng)
    individual[slice_] = new_subtree
    return (individual,)


def select_unique_best(individuals: List[Individual], k: int,
                       **_kwargs) -> List[Individual]:
    """Dedup by string, then take the k best (minimization;
    reference gp.py:127-135 sorts DEAP's weighted fitness descending,
    which for weight -1 is ascending raw fitness)."""
    seen = {}
    for ind in individuals:
        key = str(ind)
        if key not in seen:
            seen[key] = ind
    unique = list(seen.values())
    return sorted(unique, key=lambda ind: ind.fitness.values)[:k]
