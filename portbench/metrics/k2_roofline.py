"""K2's share of its roofline over the profiled stretch: the launches'
bounds over K2's device time (kernels named ``assemble_kernel``,
``csrc/halo_runs.cu``).  Every launch of a plan writes the same ``x_ext``
from the same segment table (``RASolver``'s ``ext_segs`` and
``ext_first``), so each has the bound of :func:`launch_bytes`."""

import numpy as np

from portbench.metrics.peaks import bound_s

# the segment kinds of csrc/halo_runs.cu
ZERO, WINDOW, HALO = 0, 1, 2
ITEMSIZE = {"float32": 4, "float64": 8}


def launch_bytes(segs, first, S: int, r_ext: int, one_source: bool,
                 itemsize: int) -> int:
    """A frozen copy of ``chip_smoke.py`` ``_k2_bound`` (:278-302): x_ext
    (S, r_ext) written once, the tables read once, and each source element
    that a window or halo segment reads counted once, however many segments
    read it.  With ``one_source`` (the ``all_gather`` form) window and halo
    segments read the same array, ``x_own`` flat; otherwise the halo
    segments read the compact halo values, a second array."""
    seg = np.asarray(segs).astype(np.int64)
    n_read = 0
    for kinds in ([(WINDOW, HALO)] if one_source else [(WINDOW,), (HALO,)]):
        sel = seg[np.isin(seg[:, 2], kinds)]
        if len(sel):
            ends = sel[:, 3] + sel[:, 1]
            depth = np.zeros(int(ends.max()) + 1, np.int64)
            np.add.at(depth, sel[:, 3], 1)
            np.add.at(depth, ends, -1)
            n_read += int((np.cumsum(depth) > 0).sum())
    table_bytes = (np.asarray(segs).size + np.asarray(first).size) * 4
    return (S * r_ext + n_read) * itemsize + table_bytes


def read(ctx):
    p, tab = ctx.profile, ctx.tables
    if p is None or "ext_segs" not in tab or "ext_first" not in tab:
        return None
    n = p["counters"].get("assemble_x_ext", {}).get("launches", 0)
    t = sum(s for name, (_, s) in p["kernels"].items()
            if "assemble_kernel" in name)
    if not n or t <= 0:
        return None
    sh = ctx.shapes
    nbytes = launch_bytes(tab["ext_segs"], tab["ext_first"], sh["S"],
                          sh["R_ext"], sh["halo_strategy"] == "all_gather",
                          ITEMSIZE[sh["dtype"]])
    return 100 * n * bound_s(nbytes, 0, "float32") / t
