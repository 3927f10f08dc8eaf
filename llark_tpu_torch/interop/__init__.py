"""Interop: the JAX package's parameter layout (`from_jax`), HF checkpoints
(`hf`) and weight deltas (`delta`)."""
