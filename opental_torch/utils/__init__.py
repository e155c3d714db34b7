"""Utilities: weight conversion from the JAX package's variables, the
synthetic dataset."""
