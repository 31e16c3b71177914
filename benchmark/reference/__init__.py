"""Plain float32 references: PyTorch and NumPy only, nothing of the
program, JAX or the JAX package."""
