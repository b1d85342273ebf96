"""Copy of evostencils_tpu/ir/transformations.py, kept in the port so that it imports
nothing of the JAX package.

Tree analyses over the IR (reference ir/transformations.py)."""

from . import base, system


def obtain_coarsest_level(cycle: base.Cycle) -> int:
    """Minimum grid level reachable from the cycle (reference
    ir/transformations.py:13-41)."""

    def recurse(expr, min_level):
        if isinstance(expr, base.Cycle):
            g = expr.grid
            level = min(e.level for e in g) if isinstance(g, list) else g.level
            min_level = min(min_level, level)
            return min(recurse(expr.correction, min_level), min_level)
        for child in expr.children:
            min_level = min(min_level, recurse(child, min_level))
        return min_level

    g = cycle.grid
    start = min(e.level for e in g) if isinstance(g, list) else g.level
    return recurse(cycle, start)


def count_nodes(expr: base.Expression) -> int:
    seen = set()

    def recurse(e):
        if id(e) in seen:
            return 0
        seen.add(id(e))
        return 1 + sum(recurse(c) for c in e.children)

    return recurse(expr)


def find_nodes(expr: base.Expression, node_type) -> list:
    """All (unique) nodes of a given type in the expression DAG."""
    seen = set()
    out = []

    def recurse(e):
        if id(e) in seen:
            return
        seen.add(id(e))
        if isinstance(e, node_type):
            out.append(e)
        for c in e.children:
            recurse(c)

    recurse(expr)
    return out


def find_independent_field_sets(operator) -> list:
    """Groups of mutually coupled fields of a system operator (union-find
    over nonzero off-diagonal blocks).

    Native counterpart of the reference's decoupling analysis
    (ir/transformations.py:124-145 ``find_independent_equation_sets``),
    which separates independent from dependent local equations before
    emitting coupled ``solve locally`` blocks: fields in different groups
    can be smoothed decoupled; fields within a group need a collective
    smoother."""
    from . import system
    entries = operator.entries if isinstance(operator, system.Operator) \
        else [[operator]]
    n = len(entries)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, row in enumerate(entries):
        for j, entry in enumerate(row):
            if i == j or isinstance(entry, base.ZeroOperator):
                continue
            st = entry.generate_stencil() if hasattr(entry, "generate_stencil") \
                else None
            if st is not None and hasattr(st, "entries") and not st.entries:
                continue
            ra, rb = find(i), find(j)
            if ra != rb:
                parent[ra] = rb
    groups: dict = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return sorted(groups.values())


def expression_to_dot(expr: base.Expression, path: str = None) -> str:
    """GraphViz DOT text of an expression tree (reference
    optimization/program.py:931-942 ``visualize_tree`` via pygraphviz;
    here dependency-free — render with ``dot -Tpng``)."""
    lines = ["digraph cycle {", "  node [shape=box, fontsize=10];"]
    counter = [0]

    def visit(e):
        nid = counter[0]
        counter[0] += 1
        label = type(e).__name__
        extra = []
        if isinstance(e, base.Cycle):
            extra.append(f"w={float(e.relaxation_factor):.3g}")
            if e.partitioning is not None:
                extra.append(getattr(e.partitioning, "__name__",
                                     str(e.partitioning)))
        name = getattr(e, "name", None)
        if isinstance(name, str):
            extra.append(name)
        if extra:
            label += "\\n" + " ".join(extra)
        lines.append(f'  n{nid} [label="{label}"];')
        for child in getattr(e, "children", ()):
            cid = visit(child)
            lines.append(f"  n{nid} -> n{cid};")
        return nid

    visit(expr)
    lines.append("}")
    text = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


def assign_cycle_ids(expr: base.Expression, start: int = 0) -> int:
    """Number every Cycle node in evaluation order, starting at ``start``;
    returns ``start + count`` (the next free id).  Used by the
    relaxation-weight tuning path (reference optimization/program.py
    weight_obtained/weight_set bookkeeping) and by composed chunk programs,
    where the finer chunks' cycles occupy the id prefix and each candidate
    coarse cycle is numbered after them (compiler/lower.lower_composed)."""
    cycles = find_nodes(expr, base.Cycle)
    for i, c in enumerate(cycles):
        c.global_id = start + i
    return start + len(cycles)
