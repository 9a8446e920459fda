"""The benchmark of ``schwarz_tpu_torch`` on one NVIDIA H100: time to a
1e-8 solution on a stream of right-hand sides.  ``run.py`` runs one cell
once; ``BENCHMARK.json`` at the checkout's root names the cells, and each
configuration, traffic mix and metric is a file of its own here.  Nothing
here imports JAX or the JAX package, and ``reference/`` imports nothing of
the port."""

import os

# host thread pools held to one thread
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def steady_process() -> None:
    """One process with few threads: no BLAS or OpenMP pool beside the
    thread that drives the card.  Call it before NumPy or PyTorch is first
    imported (``run.py`` and ``control.py`` run as commands do)."""
    for var in THREAD_VARS:
        os.environ[var] = "1"
