"""Copy of evostencils_tpu/grammar/typing.py, kept in the port so that it imports
nothing of the JAX package.

Grammar nonterminal symbols (reference grammar/typing.py)."""


class Type:
    """Value-equal type tag; ``guard`` marks the guarded state chain that
    forces the root terminal to be consumed exactly once."""

    __slots__ = ("identifier", "guard")

    def __init__(self, identifier: str, guard: bool = False):
        self.identifier = identifier
        self.guard = guard

    def __eq__(self, other):
        return (isinstance(other, Type) and self.identifier == other.identifier
                and self.guard == other.guard)

    def __hash__(self):
        return hash((self.identifier, self.guard))

    def __repr__(self):
        return f"Type({self.identifier}{', guard' if self.guard else ''})"
