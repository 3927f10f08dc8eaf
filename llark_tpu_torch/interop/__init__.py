"""Interop with the JAX package's parameter layout."""
