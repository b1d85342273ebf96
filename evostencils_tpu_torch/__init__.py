"""PyTorch and CUDA port of ``evostencils_tpu``.

The port shares the JAX package's array-free layers (``grids``, ``ir``,
``stencils``, ``compiler.cycles``, ``problems``) and replaces the layers
that run arrays: ``ops.apply`` (stencil application and transfers in plain
torch), ``ops.kernels`` (hand-written CUDA kernels for Hopper with their
plain PyTorch versions), ``compiler.lower`` and ``compiler.solve``.

It never imports ``jax``, directly or through the JAX package.
"""
