"""Executor selection: the role of ``schwarz_tpu/utils/backend.py``.

The reference selects its executor per rank and fails fast on an unusable
one (source/schwarz_base.cpp:86-123: omp/cuda/reference dispatch plus a
CUDA device sanity check, utils.cpp:164-167).  The port runs on a CUDA
device, or on the CPU when the caller asks for it by name
(:func:`resolve_device`, which every solver and :func:`ensure_backend`
take).  ``auto`` means CUDA here: it never falls back to the CPU, so a run
that asked for the card cannot quietly compute somewhere else.
"""

from __future__ import annotations

import torch

from schwarz_tpu_torch.exceptions import SchwarzError

EXECUTORS = ("auto", "cuda", "cpu")


class ExecutorError(SchwarzError):
    """Requested executor unusable (reference role: the unknown-executor /
    no-CUDA-device failures of schwarz_base.cpp:86-123, utils.cpp:164-167).
    """


def resolve_device(device=None) -> torch.device:
    """The device a solver runs on: CUDA unless the caller names another.
    There is no silent fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "schwarz_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of its kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def ensure_backend(executor: str = "auto") -> str:
    """The device type for ``executor`` in {auto, cuda, cpu}: ``"cpu"`` for
    ``cpu``, ``"cuda"`` for ``auto`` and ``cuda``.  Raises
    :class:`ExecutorError` for an unknown name, and for ``auto`` or
    ``cuda`` when no CUDA device is available."""
    if executor == "cpu":
        return "cpu"
    if executor not in EXECUTORS:
        raise ExecutorError(
            f"unknown executor '{executor}' (want {'|'.join(EXECUTORS)}; the "
            "reference accepts omp|cuda|reference, schwarz_base.cpp:116-122)")
    try:
        return resolve_device().type
    except RuntimeError:
        raise ExecutorError(
            f"--executor {executor} needs a CUDA device and none is "
            "available; run with --executor cpu to compute on the CPU"
        ) from None
