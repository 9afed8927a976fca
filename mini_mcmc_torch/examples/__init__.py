"""Posteriors of the JAX package's examples and benchmark stages, in
PyTorch (counterpart of ``examples/``, whose files import JAX)."""
