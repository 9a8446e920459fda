"""The port's diagnostics: counterparts of the two Pallas kernels of
``scripts/tpu_diagnostics.py`` (source: ``csrc/diagnostics.cu``).

    python -m schwarz_tpu_torch.diagnostics smoke flagorder   # on the card
    python -m schwarz_tpu_torch.diagnostics --device cpu      # plain versions

- ``smoke`` (K8, replaces ``run_smoke``): ``x * 2`` on a (256, 256) float32
  tensor, the check that a kernel launches at all.
- ``flagorder`` (K9, replaces ``run_semread``): the flag-order probe behind
  K5's ``fresh_read``.  A producer and a consumer block on two SMs pass
  ``n`` floats, the round number in every element, through K5's
  release/acquire protocol for many rounds; the consumer counts elements
  that are not the round number.  A pass (0 mismatches, two SMs) on a
  device is what lets ``fresh_read`` run there in this process.

The other runs of the TPU script (spmv, direct, ras, fgmres) launch no
Pallas kernel; their port waits for the drivers (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import torch

from schwarz_tpu_torch.exceptions import NotImplementedFeature
from schwarz_tpu_torch.ops import cuda_build
from schwarz_tpu_torch.ras import resolve_device

_FLAG_ORDER_PASSED: set = set()   # CUDA device indices where K9 passed


def smoke_x2_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def smoke_x2(x: torch.Tensor) -> torch.Tensor:
    """y = x * 2; K8 on the card."""
    if x.device.type == "cpu":
        return smoke_x2_plain(x)
    cuda_build.check_operands("smoke_x2", (torch.float32,), x=x)
    y = torch.empty_like(x)
    lib = cuda_build.library("diagnostics")
    cuda_build.check(lib.smoke_x2_f32(x.data_ptr(), y.data_ptr(), x.numel(),
                                      cuda_build.stream_ptr(x.device)),
                     "smoke_x2")
    smoke_x2.launches += 1
    return y


smoke_x2.launches = 0


def flag_order_probe_plain(n: int, rounds: int, device="cpu",
                           slots: int = 4) -> Dict[str, int]:
    """The probe in lockstep: the consumer reads round r's slot after the
    producer wrote it, so it counts the expected 0 mismatches."""
    buf = torch.zeros((slots, n), dtype=torch.float32, device=device)
    bad = torch.zeros((), dtype=torch.int64, device=device)
    for r in range(rounds):
        buf[r % slots].fill_(float(r))
        bad += (buf[r % slots] != float(r)).sum()
    return {"mismatches": int(bad), "error": 0, "producer_sm": -1,
            "consumer_sm": -1}


def flag_order_probe(n: int = 32768, rounds: int = 10000, device=None,
                     slots: int = 4) -> Dict[str, int]:
    """K9 on the card: mismatching elements seen by the consumer over
    ``rounds`` messages of ``n`` floats, the watchdog error (0 or 1), and
    the SM ids of producer and consumer.  A pass marks the device as
    verified for ``fresh_read``."""
    device = resolve_device(device)
    if device.type == "cpu":
        return flag_order_probe_plain(n, rounds, device, slots)
    buf = torch.empty((slots, n), dtype=torch.float32, device=device)
    sync = torch.zeros(slots + 1, dtype=torch.int64, device=device)
    out = torch.zeros(4, dtype=torch.int32, device=device)
    lib = cuda_build.library("diagnostics")
    with torch.cuda.device(device):
        cuda_build.check(
            lib.flag_order_probe(buf.data_ptr(), sync.data_ptr(),
                                 out.data_ptr(), n, rounds, slots,
                                 cuda_build.stream_ptr(device)),
            "flag_order_probe")
    flag_order_probe.launches += 1
    bad, err, sm_p, sm_c = out.tolist()
    if bad == 0 and err == 0 and sm_p != sm_c:
        _FLAG_ORDER_PASSED.add(_index(device))
    return {"mismatches": bad, "error": err, "producer_sm": sm_p,
            "consumer_sm": sm_c}


flag_order_probe.launches = 0


def _index(device) -> int:
    idx = torch.device(device).index
    return torch.cuda.current_device() if idx is None else idx


def require_flag_order(device) -> None:
    """Raise unless the flag-order probe passed on ``device`` in this
    process (the counterpart of the JAX package's ``_require_sem_unit``)."""
    idx = _index(device)
    if idx not in _FLAG_ORDER_PASSED:
        raise NotImplementedFeature(
            "fresh_read peeks the sequence words of newer slots; it runs on "
            f"cuda:{idx} only after the flag-order probe passed there in "
            "this process — call schwarz_tpu_torch.diagnostics."
            "flag_order_probe() first, or drop fresh_read (bounded-staleness "
            "reads stay correct without it)")


def run_smoke(device) -> bool:
    x = torch.arange(256 * 256, dtype=torch.float32,
                     device=device).reshape(256, 256)
    y = smoke_x2(x)
    ok = torch.equal(y, smoke_x2_plain(x))
    print(f"smoke (K8, x * 2 on (256, 256) float32, {device}): "
          f"{'ok' if ok else 'MISMATCH'}, sum {float(y.sum()):.1f}",
          flush=True)
    return ok


def run_flagorder(device, n: int = 32768, rounds: int = 10000) -> bool:
    res = flag_order_probe(n, rounds, device)
    ok = (res["mismatches"] == 0 and res["error"] == 0
          and (device.type == "cpu"
               or res["producer_sm"] != res["consumer_sm"]))
    print(f"flagorder (K9, {rounds} rounds of {n} floats, {device}): "
          f"{'ok' if ok else 'FAILED'}: {res}", flush=True)
    return ok


ALL = {"smoke": run_smoke, "flagorder": run_flagorder}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="*", help=f"any of {list(ALL)}")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    unknown = set(args.which) - set(ALL)
    if unknown:
        ap.error(f"unknown diagnostics {sorted(unknown)}; choose from "
                 f"{list(ALL)}")
    device = resolve_device(args.device)
    ok = True
    for name in args.which or list(ALL):
        ok = ALL[name](device) and ok
    print("DONE" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
