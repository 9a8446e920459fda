"""K6: the free-running asynchronous RAS rounds of the 2-D block-grid tier,
a hand-written CUDA kernel.

Replaces ``schwarz_tpu/ops/async_ras_2d.py`` ``async_ras_2d_rounds`` (:232):
one launch runs ``rounds`` outer RAS iterations on every rank of a cyclic
``pdx x pdy`` rank grid with no barrier between ranks.  Each rank pushes
four edge strips and its known-converged bits into slot rings of M = 2B+2
messages, consumes its four neighbours' messages of round t-B, acknowledges
them, gossips convergence in band, runs its correction solve (Jacobi-PCG or
BiCGStab on the 9-point operator, with the optional O-RAS Robin diagonal)
and freezes once it knows every rank converged (source:
``csrc/async_ras_2d.cu``).  The operations of the inner iterations bound
it on the card; the first version ran a rank on one SM.  Now a rank is a
cluster of C thread blocks of 512 threads on C SMs, block c owning a
contiguous band of the rank's tile rows; C is the largest of 8 down to 1
for which the card holds D such clusters at once
(:func:`.cluster_geometry.choose_cluster`).

Layout, for D = pdx*pdy ranks that each fold a (ply, plx) sub-grid of
(By, Bx) windows into one (FY, FX) = (ply*By, plx*Bx) tile: ``coef``
(D, 9, FY, FX), planes C, E, W, S, N, SE, SW, NE, NW; ``b``, ``dinv``,
``mask_dom``, ``mask_int``, ``boost`` and the iterate ``x`` (D, FY, FX);
``known`` and ``aux`` (D, 128).  The iterate carries its halos (HX columns,
HY rows on each side of a window): they are the state between launches.
Every operand is float32.  Dot products sum float32 products in float64 and
round once, in the kernel and in the plain version alike, and the kernel is
built without FMA contraction, as K5 is (:mod:`.async_ras_kernel`).

:func:`async_ras_2d_rounds_plain` is the same function in plain PyTorch: a
lockstep emulation in which every rank runs round t at once.  Without
``fresh_read`` the kernel's result does not depend on timing, so the
emulation is exact up to ties in the float64 sums.  With ``fresh_read`` the
emulation reads message t-1 in every direction, one legal schedule.
"""

from __future__ import annotations

from typing import Optional

import torch

from schwarz_tpu_torch.ops import cuda_build
from schwarz_tpu_torch.ops.cluster_geometry import (ANY_CLUSTER_SIZES,
                                                    choose_cluster,
                                                    require_cluster,
                                                    split_rows)
from schwarz_tpu_torch.ops.async_ras_kernel import (
    LANES,
    bicgstab_plain,
    dot_f64,
    jacobi_pcg_plain,
)

HX = 64   # left/right halo width: 63 cells of overlap + the stencil ring
HY = 8    # top/bottom halo height: 7 cells of overlap + the stencil ring
_max_clusters: dict = {}   # (device, points, C) -> clusters the card holds

# (dy, dx) of the stencil planes C, E, W, S, N, SE, SW, NE, NW
_SHIFTS = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0),
           (1, 1), (1, -1), (-1, 1), (-1, -1))


def _refresh_intra(xs, ply: int, plx: int, By: int, Bx: int):
    """Halos between a rank's own windows, all read from the tile ``xs`` as
    it is before the round: left/right strips over the full height first,
    then top/bottom strips over the full width, which own the corners."""
    out = xs.clone()
    for iy in range(ply):
        r0 = iy * By
        for ix in range(plx):
            c0 = ix * Bx
            if ix > 0:
                out[:, r0:r0 + By, c0:c0 + HX] = \
                    xs[:, r0:r0 + By, c0 - 2 * HX:c0 - HX]
            if ix < plx - 1:
                out[:, r0:r0 + By, c0 + Bx - HX:c0 + Bx] = \
                    xs[:, r0:r0 + By, c0 + Bx + HX:c0 + Bx + 2 * HX]
    for iy in range(ply):
        r0 = iy * By
        if iy > 0:
            out[:, r0:r0 + HY] = xs[:, r0 - 2 * HY:r0 - HY]
        if iy < ply - 1:
            out[:, r0 + By - HY:r0 + By] = \
                xs[:, r0 + By + HY:r0 + By + 2 * HY]
    return out


def async_ras_2d_rounds_plain(
    coef, b, dinv, mask_dom, mask_int, x, known, aux, boost=None, *,
    pdx: int, pdy: int, ply: int, plx: int, rounds: int, staleness: int,
    ninner: int, tol: float, fresh_read: bool = False, nonsym: bool = False,
):
    """Lockstep emulation of ``rounds`` free-running rounds of all D ranks.

    Returns (x, known, aux) in the input layout.  aux lanes: 0 the first
    local ||r||^2 (-1 before the first round), 1 ``done_at`` (-1 until the
    rank knows of global convergence), 2 the global round counter, 3 the
    last local ||r||^2, 4 fresh-read hits."""
    f32 = torch.float32
    dev = x.device
    D, FY, FX = x.shape
    By, Bx = FY // ply, FX // plx
    B = max(staleness, 1)
    T = rounds
    fresh = fresh_read and B > 1
    tol2 = torch.tensor(float(tol) * float(tol), dtype=f32, device=dev)
    lane = torch.arange(LANES, device=dev)
    me = torch.arange(D, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    def apply_dom(v):
        # w[i, j] = sum_k c_k[i, j] * v[i + dy_k, j + dx_k], cyclic over the
        # folded tile; wrapped and cross-window reads meet zero coefficients
        acc = coef[:, 0] * v
        for k in range(1, 9):
            dy, dx = _SHIFTS[k]
            acc = acc + coef[:, k] * torch.roll(v, (-dy, -dx), (1, 2))
        return acc

    def dot(u, v):
        return dot_f64(u, v, (1, 2))

    def apply_solve(v):
        av = mask_dom * apply_dom(v)
        if boost is not None:
            av = av + boost * v
        return av

    def from_rank(a, dy: int, dx: int):
        """a[rank (dyy + dy, dxx + dx)] at rank (dyy, dxx), cyclic."""
        g = a.reshape((pdy, pdx) + a.shape[1:])
        return torch.roll(g, (-dy, -dx), (0, 1)).reshape(a.shape)

    def unpack(xx, known_k, msg):
        """The halos and known bits of message ``msg`` (strips sL, sR, sU,
        sD and flags, as sent): what the left rank sent to its right lands
        in my left halo, and so on; up/down strips go last, full width."""
        sL, sR, sU, sD, flags = msg
        xx = xx.clone()
        xx[:, :, :HX] = from_rank(sR, 0, -1)
        xx[:, :, FX - HX:] = from_rank(sL, 0, 1)
        xx[:, :HY] = from_rank(sD, -1, 0)
        xx[:, FY - HY:] = from_rank(sU, 1, 0)
        for dy, dx in ((0, -1), (0, 1), (-1, 0), (1, 0)):
            known_k = torch.maximum(known_k, from_rank(flags, dy, dx))
        return xx, known_k

    known_k = torch.maximum(known, (lane >= D).to(f32)[None, :])
    rn0, done_at, base_t = aux[:, 0], aux[:, 1], aux[:, 2]
    hits = torch.clamp(aux[:, 4], min=0.0)
    rn = torch.zeros(D, dtype=f32, device=dev)
    xx = x
    sent = []      # per round: (sL, sR, sU, sD, known bits)
    for t in range(T):
        if ply > 1 or plx > 1:
            xx = _refresh_intra(xx, ply, plx, By, Bx)
        sent.append((xx[:, :, HX:2 * HX], xx[:, :, FX - 2 * HX:FX - HX],
                     xx[:, HY:2 * HY], xx[:, FY - 2 * HY:FY - HY], known_k))
        if t >= B:
            # known bits only grow, so the newest message's flags are the
            # union over the slots a fresh read looks at
            xx, known_k = unpack(xx, known_k, sent[t - 1 if fresh else t - B])
            if fresh:
                hits = hits + 4.0 * (B - 1)
        r = mask_dom * (b - apply_dom(xx))
        rn = dot(mask_int * r, mask_int * r)[:, 0, 0]
        rn0 = torch.where(rn0 < 0, rn, rn0)
        myconv = (rn <= tol2 * rn0).to(f32)
        mybit = torch.where(lane[None, :] == me[:, None], myconv[:, None],
                            zero)
        known_k = torch.maximum(known_k, mybit)
        all_known = torch.sum(known_k, dim=1) >= LANES
        frozen = (done_at >= 0) | all_known
        if nonsym:
            z = bicgstab_plain(apply_solve, dot, dinv, r, ninner)
        else:
            z = jacobi_pcg_plain(apply_solve, dot, dinv, r, ninner)
        xx = torch.where(frozen[:, None, None] | (mask_int == 0.0), xx,
                         xx + mask_int * z)
        done_at = torch.where(done_at >= 0, done_at,
                              torch.where(all_known, base_t + float(t),
                                          -torch.ones_like(done_at)))
    # the freshest message refreshes the halos for the next launch
    xx, known_k = unpack(xx, known_k, sent[T - 1])
    aux_out = torch.zeros_like(aux)
    for k, v in enumerate((rn0, done_at, base_t + float(T), rn, hits)):
        aux_out[:, k] = v
    return xx.contiguous(), known_k, aux_out


def async_ras_2d_rounds(
    coef, b, dinv, mask_dom, mask_int, x, known, aux, boost=None, *,
    pdx: int, pdy: int, ply: int, plx: int, rounds: int, staleness: int,
    ninner: int, tol: float, fresh_read: bool = False, nonsym: bool = False,
    cluster: Optional[int] = None,
):
    """``rounds`` free-running rounds of all D ranks; K6 on the card.

    One cooperative launch; a rank is a cluster of C 512-thread blocks,
    each owning a band of the rank's tile rows, and all D clusters are
    resident at once (the ranks spin on each other).  C is the largest size
    of :data:`.cluster_geometry.ANY_CLUSTER_SIZES` for which the card holds
    D clusters, unless ``cluster`` forces one (the solvers never do; the
    tests and the smoke run compare sizes); the C of the last launch is kept
    in ``async_ras_2d_rounds.cluster``.  The operator walks each band's
    cells without integer division, and a rank's reductions are float64
    partials per block summed over the cluster in block order.  Raises when
    the card cannot hold D clusters of C blocks, when a wait times out, and
    for ``fresh_read`` unless the flag-order probe (K9) has passed in this
    process at a cluster of at least the C about to launch."""
    kw = dict(pdx=pdx, pdy=pdy, ply=ply, plx=plx, rounds=rounds,
              staleness=staleness, ninner=ninner, tol=tol,
              fresh_read=fresh_read, nonsym=nonsym)
    if x.device.type == "cpu":
        return async_ras_2d_rounds_plain(coef, b, dinv, mask_dom, mask_int,
                                         x, known, aux, boost, **kw)
    ops = dict(coef=coef, b=b, dinv=dinv, mask_dom=mask_dom,
               mask_int=mask_int, x=x, known=known, aux=aux)
    if boost is not None:
        ops["boost"] = boost
    cuda_build.check_operands("async_ras_2d_rounds", (torch.float32,), **ops)
    D = pdx * pdy
    if x.dim() != 3 or x.shape[0] != D:
        raise ValueError(f"async_ras_2d_rounds: x must be ({D}, FY, FX), got "
                         f"{tuple(x.shape)}")
    _, FY, FX = x.shape
    for name in ("b", "dinv", "mask_dom", "mask_int", "boost"):
        if name in ops and ops[name].shape != x.shape:
            raise ValueError(f"async_ras_2d_rounds: {name} must be "
                             f"{tuple(x.shape)}")
    if (coef.shape != (D, 9, FY, FX) or known.shape != (D, LANES)
            or aux.shape != (D, LANES) or FY % ply or FX % plx
            or FY // ply <= 2 * HY or FX // plx <= 2 * HX):
        raise ValueError("async_ras_2d_rounds: operand shapes do not match "
                         f"D={D}, tile ({FY}, {FX}), windows ({ply}, {plx})")
    if FY * FX >= 1 << 24:
        raise ValueError(f"async_ras_2d_rounds: a tile of {FY * FX} cells; "
                         "the kernel takes fewer than 2^24")
    if D > LANES:
        raise ValueError(f"async_ras_2d_rounds: {D} ranks; the gossip keeps "
                         f"one lane per rank, at most {LANES}")
    B = max(staleness, 1)
    # a 5-point operator skips the four diagonal planes: a zero plane adds
    # +-0 to every sum, so the result is the same
    points = 9 if bool(coef[:, 5:].any()) else 5
    lib = cuda_build.library("async_ras_2d")

    def fits(c: int) -> int:
        key = (x.device, points, c)
        if key not in _max_clusters:
            with torch.cuda.device(x.device):
                _max_clusters[key] = lib.async_ras_2d_max_clusters(points, c)
        return _max_clusters[key]

    C = (choose_cluster(D, fits, ANY_CLUSTER_SIZES) if cluster is None
         else int(cluster))
    require_cluster("async_ras_2d_rounds", D, C, fits, ANY_CLUSTER_SIZES,
                    need=D, unit="rank")
    if fresh_read and B > 1:
        from schwarz_tpu_torch.diagnostics import require_flag_order

        require_flag_order(x.device, C)
    band, _ = split_rows(FY, C)
    M = 2 * B + 2
    slot = max(FY * HX, HY * FX) + LANES
    nwork = (7 if nonsym else 4) + (1 if ply * plx > 1 else 0)
    dev = x.device
    out = [torch.empty_like(x), torch.empty_like(known),
           torch.empty_like(aux)]
    work = torch.empty((D, nwork, FY * FX), dtype=torch.float32, device=dev)
    ring = torch.empty((D, 4, M, slot), dtype=torch.float32, device=dev)
    # sequence words (D, 4, M), ack counters (D, 4) as uint32 pairs, and
    # the error word: zeroed by a stream-ordered memset before each launch
    sync = torch.zeros(D * 4 * M + D * 2 + 1, dtype=torch.int64, device=dev)
    cuda_build.check(
        lib.async_ras_2d_f32(
            coef.data_ptr(), b.data_ptr(), dinv.data_ptr(),
            mask_dom.data_ptr(), mask_int.data_ptr(),
            boost.data_ptr() if boost is not None else None,
            x.data_ptr(), known.data_ptr(), aux.data_ptr(),
            *(o.data_ptr() for o in out), work.data_ptr(), ring.data_ptr(),
            sync.data_ptr(), pdx, pdy, ply, plx, FY // ply, FX // plx, HY,
            HX, rounds, B, ninner, int(bool(nonsym)), int(bool(fresh_read)),
            points, float(tol) * float(tol), C, band,
            cuda_build.stream_ptr(dev)),
        "async_ras_2d_rounds")
    async_ras_2d_rounds.launches += 1
    async_ras_2d_rounds.cluster = C
    err = int(sync[-1].item())
    if err:
        what = {1: "an acknowledgement", 2: "a neighbour's message",
                3: "a message to drain"}.get(err, f"code {err}")
        raise RuntimeError(
            f"async_ras_2d_rounds: a rank waited for {what} past the "
            "watchdog; the ranks' protocol is broken")
    return tuple(out)


async_ras_2d_rounds.launches = 0
async_ras_2d_rounds.cluster = None    # blocks per rank of the last launch
