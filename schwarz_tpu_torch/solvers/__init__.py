"""Local solvers and preconditioners."""
