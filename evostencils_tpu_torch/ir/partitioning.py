"""Copy of evostencils_tpu/ir/partitioning.py, kept in the port so that it imports
nothing of the JAX package.

Grid-coloring strategies for smoothers (reference ir/partitioning.py)."""

from ..stencils import constant, periodic


class Single:
    """No partitioning: one full sweep."""

    @staticmethod
    def generate(stencil, grid):
        if stencil is None:
            return [None]
        return [periodic.from_constant(constant.unit(grid.dimension))]

    @staticmethod
    def get_name():
        return "single"


class RedBlack:
    """Two-color partitioning: red points updated first, then black with the
    refreshed red values (Gauss-Seidel-like coupling between half-sweeps)."""

    @staticmethod
    def generate(stencil, grid):
        if stencil is None:
            return [None]
        return list(periodic.red_black_partitioning(
            periodic.as_periodic(stencil), grid))

    @staticmethod
    def get_name():
        return "red_black"
