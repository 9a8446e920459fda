"""The one generator of traffic: a mix's file (``traffic/<name>.json``)
holds its parameters, and this module turns them into requests.

One client drives the program in a closed loop: it sends the next request
when the previous one has returned, and every solve starts from x = 0.  A
request is a right-hand side for the configuration's operator.  The pool
of them is drawn in set-up, in one call on the run's device from a
generator seeded with ``--seed``, so that the window holds only the
program's work and one seed gives the same requests.  Row 0 is the warm-up
solves'; the measured solves take rows 1, 2, ... in turn, starting again
at row 1 once the pool is used up.

Parameters of a mix:
    rhs             {"distribution": "uniform", "low", "high"}, float64
    pool            rows drawn in set-up (warm-up row included)
    warmup_solves   solves made in set-up before the window
"""

from __future__ import annotations

import numpy as np


def validate(mix: dict) -> None:
    if mix["rhs"]["distribution"] != "uniform":
        raise ValueError(f"unknown distribution {mix['rhs']['distribution']!r}")
    if int(mix["pool"]) < 2 or int(mix["warmup_solves"]) < 1:
        raise ValueError("pool >= 2 rows and warmup_solves >= 1")


def make_requests(mix: dict, n_rows: int, seed: int, device) -> np.ndarray:
    """(pool, n_rows) float64 right-hand sides drawn from ``seed``."""
    import torch

    validate(mix)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    rhs = mix["rhs"]
    t = torch.rand((int(mix["pool"]), int(n_rows)), generator=gen,
                   device=device, dtype=torch.float64)
    t = t * (float(rhs["high"]) - float(rhs["low"])) + float(rhs["low"])
    return t.cpu().numpy()


def row(mix: dict, k: int) -> int:
    """The pool row of the k-th measured solve (k = 0, 1, ...)."""
    return 1 + k % (int(mix["pool"]) - 1)
