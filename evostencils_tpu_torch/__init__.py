"""PyTorch and CUDA port of ``evostencils_tpu``.

The port keeps its own copies of the JAX package's array-free layers
(``grids``, ``stencils``, ``ir``, ``compiler.cycles``, ``problems.api``
and the Poisson, elasticity and complex Helmholtz problems, ``grammar``,
``optimization.program`` and ``optimization.nsga``, ``parallel.comm``),
each naming the file it copies, and replaces the layers that run arrays:
``ops.apply`` (stencil application and transfers in plain torch),
``ops.local_solve`` (block solves), ``ops.solvers`` (the outer BiCGStab
of Helmholtz), ``ops.kernels`` (hand-written CUDA kernels for Hopper with
their plain PyTorch versions), ``compiler.lower``, ``compiler.solve`` and
``evaluation.evaluator``.  ``optimize`` is the command-line twin of
``scripts/optimize.py``.

It imports neither ``jax`` nor anything of ``evostencils_tpu``; only the
tests import both packages, to hold the port to the reference.
"""
