"""Readings behind the float32-local tolerances of test_torch_two_level.py.

For each case of ``F32_CASES`` the largest relative gap between the port's
and the JAX package's global residual histories, and the gap after the
first outer iteration; then, on the DIA flagship analog, the same gaps
with a fault planted in the port's plan (coarse step in float64, FSAI
factors rounded to bfloat16, G without its first diagonal).  Run on the
CPU:

    JAX_PLATFORMS=cpu python tests/torch_f32_readings.py
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ.pop("SCHWARZ_TPU_COARSE_CACHE", None)

import test_torch_two_level as t  # noqa: E402


def _gaps(hj, ts):
    ht = ts.run().global_resnorm_history
    n = min(len(hj), len(ht))
    rel = np.abs(ht[:n] / hj[:n] - 1)
    return len(hj) - 1, len(ht) - 1, float(rel[1]), float(rel.max())


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _drop_first(x):
    x = x.clone()
    x[:, 0] = 0
    return x


FAULTS = {
    "coarse step in float64": {"coarse_basis": torch.Tensor.double,
                               "coarse_inv": torch.Tensor.double},
    "FSAI factors in bfloat16": {"fsai_gl_dia": _bf16,
                                 "fsai_gu_dia": _bf16},
    "G without its first diagonal": {"fsai_gl_dia": _drop_first},
}


def main():
    print("case: iterations JAX / port, gap after the first iteration, "
          "largest gap")
    for name, (n, S, kw, rtol, _) in t.F32_CASES.items():
        js, ts = t._solvers(n, S, **kw)
        hj = js.run().global_resnorm_history
        ij, it, first, top = _gaps(hj, ts)
        print(f"{name}: {ij} / {it}, {first:.3e}, {top:.3e} "
              f"(held at {rtol:g})", flush=True)
    n, S, kw, _, _ = t.F32_CASES["flagship-analog-dia"]
    hj = t._solvers(n, S, **kw)[0].run().global_resnorm_history
    for fault, change in FAULTS.items():
        ts = t._solvers(n, S, **kw)[1]
        for key, fn in change.items():
            new = fn(ts._plan[key])
            if new.dtype == ts._plan[key].dtype:
                # in place: the local solve holds the plan's tensors
                ts._plan[key].copy_(new)
            else:
                ts._plan[key] = new
        ij, it, first, top = _gaps(hj, ts)
        print(f"flagship-analog-dia, {fault}: {ij} / {it}, {first:.3e}, "
              f"{top:.3e}", flush=True)


if __name__ == "__main__":
    main()
