"""CSV writers matching the reference's post-run outputs (a copy of
``schwarz_tpu/utils/io_csv.py``; the files are byte-identical).

  - per-stage timing CSV      (BenchBase::write_timings, bench_base.hpp:219-273)
  - comm-volume CSV           (BenchBase::write_comm_data, bench_base.hpp:178-216)
  - iteration/residual CSV    (write_iters_and_residuals, schwarz_base.cpp:50-70)
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def write_timings(summary: Dict[str, Dict[str, float]], path: str) -> None:
    """func,total,avg,min,med,max — one row per solver stage."""
    with open(path, "w") as f:
        f.write("func,total,avg,min,med,max\n")
        for stage, s in summary.items():
            f.write(
                f"{stage},{s['total']:.9g},{s['avg']:.9g},{s['min']:.9g},"
                f"{s['med']:.9g},{s['max']:.9g}\n"
            )


def write_comm_data(
    comm_matrix: np.ndarray, iters: int, path: str,
    locality: np.ndarray | None = None,
) -> None:
    """subdomain,neighbor,recv_elements,send_elements,iters,is_local — per
    neighbor pair (the reference gathers send/recv element counts per neighbor,
    schwarz_base.cpp:274-319; is_local mirrors check_subd_locality,
    utils.cpp:52-66: same host = ICI, different host = DCN)."""
    S = comm_matrix.shape[0]
    with open(path, "w") as f:
        f.write("subdomain,neighbor,recv_elements,send_elements,iters,is_local\n")
        for p in range(S):
            for q in range(S):
                if comm_matrix[p, q] > 0 or comm_matrix[q, p] > 0:
                    loc = 1 if locality is None else int(locality[p, q])
                    f.write(
                        f"{p},{q},{int(comm_matrix[p, q])},"
                        f"{int(comm_matrix[q, p])},{iters},{loc}\n"
                    )


def write_iters_and_residuals(
    local_hist: np.ndarray,        # (iters, S)
    global_hist: np.ndarray,       # (iters,)
    inner_hist: np.ndarray,        # (iters, S)
    path_prefix: str,
) -> None:
    """One ``iter_res_XX.csv`` per subdomain: iter,local_resnorm,global_resnorm,
    inner_iters (cf. the per-rank files of schwarz_base.cpp:456-472)."""
    iters, S = local_hist.shape
    for p in range(S):
        name = f"{path_prefix}iter_res_{p:02d}.csv"
        with open(name, "w") as f:
            f.write("iter,local_resnorm,global_resnorm,inner_iters\n")
            for k in range(iters):
                f.write(
                    f"{k},{local_hist[k, p]:.12g},{global_hist[k]:.12g},"
                    f"{int(inner_hist[k, p])}\n"
                )
