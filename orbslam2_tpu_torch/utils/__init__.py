"""Utilities: synthetic world, evaluation, interop with the JAX package."""
