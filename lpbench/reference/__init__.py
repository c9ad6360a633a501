"""The plain reference: NumPy and SciPy in f64, from the LPs the
benchmark made. It imports nothing of the program and nothing of JAX."""
