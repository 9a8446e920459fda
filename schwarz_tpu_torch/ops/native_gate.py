"""Compile-and-run probe with a per-key cache: the port of
``schwarz_tpu/ops/native_gate.py``'s ``native_probe`` and ``reset_cache``.

``native_probe(key, fn, *args, compare=None)`` runs ``fn(*args)`` once per
``key`` in the process, synchronizes the device, and answers ``(ok,
reason)``: an exception is a negative answer (its class and message are the
reason), and a result that differs from ``compare(*args)`` is one too.

The JAX solver uses its gate to choose: a Pallas kernel that fails its
probe falls back to the XLA path (``schwarz_tpu/ras.py:1403-1451``).  The
port keeps no such fallback.  Its kernels run on CUDA tensors whenever they
are on the path, and a kernel that fails raises; nothing on the solver path
calls this probe to pick a plain version.  It is a diagnostic: a caller can
ask whether a kernel builds, runs and agrees with its plain version.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

_CACHE: dict = {}


def _synchronize(x) -> None:
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def native_probe(
    key,
    fn: Callable,
    *args,
    compare: Optional[Callable] = None,
) -> Tuple[bool, Optional[str]]:
    """Run ``fn(*args)`` once per ``key`` and report ``(ok, reason)``.

    ``reason`` is the failure's class and message, or a mismatch note when
    ``compare`` (a reference implementation on the same args) disagrees.
    Never raises: any exception is the probe's negative answer.
    """
    if key in _CACHE:
        return _CACHE[key]
    try:
        out = fn(*args)
        _synchronize(out)
        ok, reason = True, None
        if compare is not None:
            ref = compare(*args)
            _synchronize(ref)
            ok = bool(np.array_equal(_host(out), _host(ref)))
            if not ok:
                reason = "native result mismatch vs reference path"
    except Exception as e:  # the probe's answer, not the caller's error
        ok, reason = False, f"{type(e).__name__}: {str(e)[:300]}"
    _CACHE[key] = (ok, reason)
    return ok, reason


def reset_cache() -> None:
    """Test hook: forget previous probe outcomes."""
    _CACHE.clear()
