"""Runnable tours of the port, one module each (the counterparts of the
repository's ``examples/``):

    python -m schwarz_tpu_torch.examples.poisson_basic
    python -m schwarz_tpu_torch.examples.optimized_schwarz
    python -m schwarz_tpu_torch.examples.advanced_async
    python -m schwarz_tpu_torch.examples.free_running_async

Each runs on the CUDA device and raises without one unless given
``--device cpu``; each module's ``main(device)`` returns what it printed.
"""

import argparse


def device_from_args(doc: str):
    """The ``--device`` of an example's command line (None: CUDA)."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda; 'cpu' "
                        "runs the kernels' plain PyTorch versions)")
    return p.parse_args().device
