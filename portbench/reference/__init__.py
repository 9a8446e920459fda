"""The plain reference: NumPy and SciPy only.  It imports neither JAX, nor
the JAX package, nor anything of the port, and works from the operator and
the right-hand sides that the benchmark made.  The program's solution is
what it judges; it takes nothing else the program made."""
