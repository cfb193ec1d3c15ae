"""PyTorch/CUDA port of the ``repro`` package (parallel actors, K-ary
sum-tree prioritized replay, DQN learners).

The JAX package ``repro`` is the reference; every module here has a
counterpart of the same name there.  This package imports ``torch`` and
numpy only, never ``jax`` or ``repro``.
"""
