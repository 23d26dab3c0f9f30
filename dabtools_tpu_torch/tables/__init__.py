"""Static DAB tables (copies of the JAX package's NumPy modules)."""
