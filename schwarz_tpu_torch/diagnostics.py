"""The port's diagnostics: counterparts of the two Pallas kernels of
``scripts/tpu_diagnostics.py`` (source: ``csrc/diagnostics.cu``).

    python -m schwarz_tpu_torch.diagnostics smoke flagorder   # on the card
    python -m schwarz_tpu_torch.diagnostics --device cpu      # plain versions

- ``smoke`` (K8, replaces ``run_smoke``): ``x * 2`` on a (256, 256) float32
  tensor, the check that a kernel launches at all.
- ``flagorder`` (K9, replaces ``run_semread``): the flag-order probe behind
  the free-running kernels' ``fresh_read``.  A producer and a consumer
  cluster of C thread blocks, each block on its own SM, pass ``n`` floats,
  the round number in every element, through K5's publish and consume steps
  for many rounds: every producer block writes its share of the slot, a
  cluster barrier, the leader's release of the sequence word; the
  consumer leader's acquire, a cluster barrier, every consumer block reads
  its share and counts elements that are not the round number.  A pass (0
  mismatches, no watchdog, 2C distinct SMs) at C on a device is what lets
  ``fresh_read`` run there, in this process, at any cluster size up to C.

Why a pass at C covers every smaller C: K5 and K6 publish a slot exactly as
the probe does, whatever their C.  The ordering ``fresh_read`` relies on is
that the leader's release covers the stores that the cluster's other blocks
made before the cluster barrier.  A cluster of fewer blocks runs the same
code with fewer of those remote writers, and at C = 1 the leader writes
alone; a larger cluster than the probe's has writers on SMs the probe never
exercised, so it needs its own pass.

The other runs of the TPU script (spmv, direct, ras, fgmres) launch no
Pallas kernel; their port waits for the command line (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import torch

from schwarz_tpu_torch.exceptions import NotImplementedFeature
from schwarz_tpu_torch.ops import cuda_build
from schwarz_tpu_torch.ops.cluster_geometry import (ANY_CLUSTER_SIZES,
                                                    choose_cluster,
                                                    require_cluster)
from schwarz_tpu_torch.utils.backend import resolve_device

# CUDA device index -> the largest cluster size at which K9 passed there
_FLAG_ORDER_PASSED: Dict[int, int] = {}


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
                           slots: int = 4, cluster=None) -> Dict:
    """The probe in lockstep: the consumer reads round r's slot after the
    producer wrote it, so it counts the expected 0 mismatches.  No SM runs
    it: the 2C SM ids are -1 (C = ``cluster``, 1 when not given)."""
    C = 1 if cluster is None else int(cluster)
    buf = torch.zeros((slots, n), dtype=torch.float32, device=device)
    bad = torch.zeros((), dtype=torch.int64, device=device)
    for r in range(rounds):
        buf[r % slots].fill_(float(r))
        bad += (buf[r % slots] != float(r)).sum()
    return {"mismatches": int(bad), "error": 0, "cluster": C,
            "producer_sms": [-1] * C, "consumer_sms": [-1] * C}


def flag_order_probe(n: int = 32768, rounds: int = 10000, device=None,
                     slots: int = 4, cluster=None) -> Dict:
    """K9 on the card: mismatching elements seen by the consumer cluster over
    ``rounds`` messages of ``n`` floats, the watchdog error (0 or 1), the
    cluster size C and the SM ids of the producer's and the consumer's C
    blocks.  C is the largest of ``ANY_CLUSTER_SIZES`` for which the card
    holds two clusters (8 on an H100) unless ``cluster`` forces one.  A pass
    (0 mismatches, no watchdog, 2C distinct SMs) records C for the device;
    :func:`require_flag_order` reads it."""
    device = resolve_device(device)
    if device.type == "cpu":
        return flag_order_probe_plain(n, rounds, device, slots, cluster)
    lib = cuda_build.library("diagnostics")

    def fits(c: int) -> int:
        with torch.cuda.device(device):
            return lib.flag_order_max_clusters(c)

    C = (choose_cluster(2, fits, ANY_CLUSTER_SIZES) if cluster is None
         else int(cluster))
    require_cluster("flag_order_probe", 2, C, fits, ANY_CLUSTER_SIZES,
                    need=2, unit="side")
    ld = -(-n // 4) * 4
    buf = torch.empty((slots, ld), dtype=torch.float32, device=device)
    sync = torch.zeros(slots + 1, dtype=torch.int64, device=device)
    out = torch.zeros(2 + 2 * C, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        cuda_build.check(
            lib.flag_order_probe(buf.data_ptr(), sync.data_ptr(),
                                 out.data_ptr(), n, rounds, slots, C,
                                 cuda_build.stream_ptr(device)),
            "flag_order_probe")
    flag_order_probe.launches += 1
    bad, err, *sms = out.tolist()
    if bad == 0 and err == 0 and len(set(sms)) == 2 * C:
        idx = _index(device)
        _FLAG_ORDER_PASSED[idx] = max(_FLAG_ORDER_PASSED.get(idx, 0), C)
    return {"mismatches": bad, "error": err, "cluster": C,
            "producer_sms": sms[:C], "consumer_sms": sms[C:]}


flag_order_probe.launches = 0


def _index(device) -> int:
    idx = torch.device(device).index
    return torch.cuda.current_device() if idx is None else idx


def flag_order_passed(device) -> int:
    """The largest cluster size at which the flag-order probe passed on
    ``device`` in this process; 0 when it has not passed there."""
    return _FLAG_ORDER_PASSED.get(_index(device), 0)


def require_flag_order(device, cluster: int = 1) -> None:
    """Raise unless the flag-order probe passed on ``device`` in this
    process at a cluster of at least ``cluster`` blocks (the counterpart of
    the JAX package's ``_require_sem_unit``; why a larger pass covers a
    smaller C is in the module's docstring)."""
    idx = _index(device)
    have = flag_order_passed(device)
    if have < cluster:
        raise NotImplementedFeature(
            "fresh_read peeks the sequence words of newer slots; on "
            f"cuda:{idx} with ranks of {cluster} thread blocks it runs only "
            f"after the flag-order probe passed there at a cluster of C >= "
            f"{cluster} blocks in this process (largest passed: "
            f"{have or 'none'}) — call schwarz_tpu_torch.diagnostics."
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
    sms = res["producer_sms"] + res["consumer_sms"]
    ok = (res["mismatches"] == 0 and res["error"] == 0
          and (device.type == "cpu" or len(set(sms)) == len(sms)))
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
