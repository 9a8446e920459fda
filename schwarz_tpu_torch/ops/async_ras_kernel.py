"""K5: the free-running asynchronous RAS rounds, a hand-written CUDA kernel.

Replaces ``schwarz_tpu/ops/async_ras.py`` ``async_ras_rounds`` (:394): one
launch runs ``rounds`` outer RAS iterations on every rank with no barrier
between ranks.  Each rank pushes its two edge strips and its known-converged
bits into slot rings of M = 2B+2 messages, consumes its neighbours' messages
of round t-B, acknowledges them for flow control, gossips convergence in
band, runs its correction solve (Jacobi-PCG, BiCGStab or GMRES(m), with the
optional O-RAS Robin diagonal) and freezes once it knows every rank
converged (source: ``csrc/async_ras.cu``).  A rank is a cluster of C
thread blocks on C SMs, the rank's rows split in contiguous chunks over
them; C is the largest of 8, 4, 2, 1 for which the card holds D such
clusters at once (:func:`choose_cluster`).

Layout, for D ranks of Sl windows each (the JAX package's per-device
operands, stacked over ranks): ``dia`` (D, K, Sl*total); ``b``, ``dinv``,
``mask_dom``, ``mask_int``, ``boost`` (D, Sl*total); ``x`` (D, Sl*R);
``known`` and ``aux`` (D, 128); the halo carries ``hl``, ``hr`` (D, hw).
Every operand is float32.  Dot products take float32 products and sum them
in float64 before rounding to float32, in the kernel and in the plain
version alike, and the kernel is built without FMA contraction: card and
plain version then agree bit for bit, up to rare ties, so a rank detects
convergence at the same round on both.  The JAX package sums in float32;
the CPU parity tests hold the two within float32 tolerance.

:func:`async_ras_rounds_plain` is the same function in plain PyTorch: a
lockstep emulation in which every rank runs round t at once.  Without
``fresh_read`` the kernel's result does not depend on timing (a rank blocks
on message t-B exactly, and a slot is not overwritten before it is
acknowledged), so the emulation is exact up to ties in the float64 sums.
With ``fresh_read`` the emulation reads message t-1, the newest message
available in lockstep: one legal schedule among many.

Across the processes of a mesh (``mesh=``), the operands hold the process's
D / P ranks.  The kernel then reaches the neighbours' rings in peer
processes through the mesh's window (:mod:`.rank_rings`); the plain version
takes its two rank rolls through ``Mesh.shift`` and is otherwise the
single-process emulation, bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from schwarz_tpu_torch.ops import cuda_build
from schwarz_tpu_torch.ops.cluster_geometry import (  # noqa: F401  re-exported
    CLUSTER_SIZES, choose_cluster)
from schwarz_tpu_torch.ops.rank_rings import launch_rounds, ring_layout
from schwarz_tpu_torch.parallel.mesh import group_of

LANES = 128                # known-converged bit lanes: at most 128 ranks
MAX_GMRES_M = 64           # Hessenberg held in shared memory
_SOLVERS = {"cg": 0, "bicgstab": 1, "gmres": 2}
_max_clusters: dict = {}   # (device, K, C) -> clusters the card holds


def _sdiv(a, b):
    """a / b where |b| > tiny, else 0 (the breakdown guard of the JAX
    package's BiCGStab and GMRES corrections)."""
    tiny = torch.finfo(torch.float32).tiny
    return torch.where(b.abs() > tiny,
                       a / torch.where(b == 0, torch.ones_like(b), b),
                       torch.zeros_like(b))


def solver_kind(nonsym: bool, nonsym_solver: str) -> str:
    """'cg', 'bicgstab' or 'gmres'; raises on an unknown ``nonsym_solver``."""
    if nonsym_solver not in ("bicgstab", "gmres"):
        raise ValueError(f"nonsym_solver must be 'bicgstab' or 'gmres', got "
                         f"{nonsym_solver!r}")
    return nonsym_solver if nonsym else "cg"


def dot_f64(u, v, dims):
    """float32 products summed in float64 over ``dims`` (kept) and rounded
    to float32: the kernels sum the same products in float64 in another
    order, so card and plain version give the same float32 dot."""
    return torch.sum((u * v).double(), dim=dims, keepdim=True).float()


def jacobi_pcg_plain(apply_solve, dot, dinv, r, ninner: int):
    """``ninner`` iterations of Jacobi-preconditioned CG on A_solve z = r
    from z = 0, batched over ranks (``dot`` reduces each rank to one step
    size)."""
    tiny = torch.finfo(torch.float32).tiny
    zero = torch.zeros((), dtype=torch.float32, device=r.device)
    z = torch.zeros_like(r)
    p = dinv * r
    rho = dot(r, p)
    for _ in range(ninner):
        ap = apply_solve(p)
        pap = dot(p, ap)
        alpha = torch.where(pap > 0, rho / torch.clamp(pap, min=tiny), zero)
        z = z + alpha * p
        r = r - alpha * ap
        sn = dinv * r
        rho_n = dot(r, sn)
        beta = torch.where(rho > 0, rho_n / torch.clamp(rho, min=tiny), zero)
        p = sn + beta * p
        rho = rho_n
    return z


def bicgstab_plain(apply_solve, dot, dinv, r, ninner: int):
    """``ninner`` iterations of right-Jacobi-preconditioned BiCGStab on
    A_solve z = r from z = 0, batched over ranks, with the JAX package's
    breakdown guards."""
    one = torch.ones((r.shape[0],) + (1,) * (r.dim() - 1),
                     dtype=torch.float32, device=r.device)
    zz, rr = torch.zeros_like(r), r
    p, v = torch.zeros_like(r), torch.zeros_like(r)
    rho, alpha, omega = one, one, one
    for _ in range(ninner):
        rho_n = dot(r, rr)
        beta = _sdiv(rho_n * alpha, rho * omega)
        p = rr + beta * (p - omega * v)
        ph = dinv * p
        v = apply_solve(ph)
        alpha = _sdiv(rho_n, dot(r, v))
        s = rr - alpha * v
        sh = dinv * s
        t = apply_solve(sh)
        omega = _sdiv(dot(t, s), dot(t, t))
        zz = zz + alpha * ph + omega * sh
        rr = s - omega * t
        rho = rho_n
    return zz


def async_ras_rounds_plain(
    dia, b, dinv, mask_dom, mask_int, x, known, aux, hl, hr, boost=None, *,
    offsets: Tuple[int, ...], total: int, hw: int, rounds: int,
    staleness: int, ninner: int, tol: float, fresh_read: bool = False,
    nonsym: bool = False, nonsym_solver: str = "bicgstab", mesh=None,
):
    """Lockstep emulation of ``rounds`` free-running rounds of all D ranks
    (of this process's D / P ranks under a ``mesh``).

    Returns (x, known, aux, hl, hr) in the input layout.  aux lanes: 0 the
    first local ||r||^2 (-1 before the first round), 1 ``done_at`` (-1 until
    the rank knows of global convergence), 2 the global round counter, 3 the
    last local ||r||^2, 4 fresh-read hits."""
    solver = solver_kind(nonsym, nonsym_solver)
    f32 = torch.float32
    dev = x.device
    group = group_of(mesh)
    D, K, L = dia.shape
    Dg = D if group is None else group.num_ranks   # ranks of the group
    Sl = L // total
    R = total - 2 * hw
    B = max(staleness, 1)
    T = rounds
    tol2 = torch.tensor(float(tol) * float(tol), dtype=f32, device=dev)
    lane = torch.arange(LANES, device=dev)
    first = 0 if group is None else group.block(Dg).start
    me = torch.arange(D, device=dev) + first
    zero = torch.zeros((), dtype=f32, device=dev)

    def apply_dom(v):
        # w[i] = sum_k dia_k[i] * v[(i + o_k) mod L], cyclic over the
        # rank's folded windows; cross-window reads meet zero coefficients
        acc = dia[:, 0] * torch.roll(v, -offsets[0], 1)
        for k in range(1, K):
            acc = acc + dia[:, k] * torch.roll(v, -offsets[k], 1)
        return acc

    def dot(u, v):
        return dot_f64(u, v, 1)

    def apply_solve(v):
        av = mask_dom * apply_dom(v)
        if boost is not None:
            av = av + boost * v
        return av

    def gmres(r):
        m = ninner
        zs = torch.zeros((D, 1), dtype=f32, device=dev)
        beta = torch.sqrt(dot(r, r))
        V = [r * _sdiv(torch.ones_like(beta), beta)]
        H = [[zs] * m for _ in range(m + 1)]
        cs, sn = [], []
        g = [beta] + [zs] * m
        for j in range(m):
            w = apply_solve(dinv * V[j])
            for i in range(j + 1):
                hij = dot(w, V[i])
                w = w - hij * V[i]
                H[i][j] = hij
            hn = torch.sqrt(dot(w, w))
            H[j + 1][j] = hn
            V.append(w * _sdiv(torch.ones_like(hn), hn))
            for i in range(j):
                t = cs[i] * H[i][j] + sn[i] * H[i + 1][j]
                H[i + 1][j] = -sn[i] * H[i][j] + cs[i] * H[i + 1][j]
                H[i][j] = t
            dn = torch.sqrt(H[j][j] * H[j][j] + H[j + 1][j] * H[j + 1][j])
            c, s_ = _sdiv(H[j][j], dn), _sdiv(H[j + 1][j], dn)
            cs.append(c)
            sn.append(s_)
            H[j][j] = c * H[j][j] + s_ * H[j + 1][j]
            g[j + 1] = -s_ * g[j]
            g[j] = c * g[j]
        y = [zs] * m
        for i in reversed(range(m)):
            acc = g[i]
            for k2 in range(i + 1, m):
                acc = acc - H[i][k2] * y[k2]
            y[i] = _sdiv(acc, H[i][i])
        u = y[0] * V[0]
        for i in range(1, m):
            u = u + y[i] * V[i]
        return dinv * u

    correct = {
        "cg": lambda r: jacobi_pcg_plain(apply_solve, dot, dinv, r, ninner),
        "bicgstab": lambda r: bicgstab_plain(apply_solve, dot, dinv, r,
                                             ninner),
        "gmres": gmres,
    }[solver]
    roll = ((lambda a, r: torch.roll(a, r, 0)) if group is None
            else group.shift)

    def neighbours(strip_l, strip_r, flags):
        """(left rank's right strip, right rank's left strip, left rank's
        flags, right rank's flags) of a message as sent: one roll a
        direction."""
        ml = roll(torch.cat((strip_r, flags), 1), 1)    # rank me-1's
        mr = roll(torch.cat((strip_l, flags), 1), -1)   # rank me+1's
        return ml[:, :hw], mr[:, :hw], ml[:, hw:], mr[:, hw:]

    known_k = torch.maximum(known, (lane >= Dg).to(f32)[None, :])
    rn0, done_at, base_t = aux[:, 0], aux[:, 1], aux[:, 2]
    hits = torch.clamp(aux[:, 4], min=0.0)
    rn = torch.zeros(D, dtype=f32, device=dev)
    xx = x
    no_flags = torch.zeros_like(known_k)
    sent = []      # per round: (left strip, right strip, known bits)
    for t in range(T):
        sent.append((xx[:, :hw], xx[:, Sl * R - hw:], known_k))
        if t >= B:
            u = t - 1 if (fresh_read and B > 1) else t - B
            # known bits only grow, so the newest message's flags are the
            # union over the slots a fresh read looks at
            halo_l, halo_r, flags_l, flags_r = neighbours(*sent[u])
            if fresh_read and B > 1:
                hits = hits + 2.0 * (B - 1)
        else:
            halo_l, halo_r = hl, hr
            flags_l = flags_r = no_flags
        xw = xx.reshape(D, Sl, R)
        lp = torch.cat([halo_l[:, None], xw[:, :-1, R - hw:]], dim=1)
        rp = torch.cat([xw[:, 1:, :hw], halo_r[:, None]], dim=1)
        xp = torch.cat([lp, xw, rp], dim=2).reshape(D, L)
        r = mask_dom * (b - apply_dom(xp))
        rn = dot(mask_int * r, mask_int * r)[:, 0]
        rn0 = torch.where(rn0 < 0, rn, rn0)
        myconv = (rn <= tol2 * rn0).to(f32)
        mybit = torch.where(lane[None, :] == me[:, None], myconv[:, None],
                            zero)
        known_new = torch.maximum(torch.maximum(known_k, mybit),
                                  torch.maximum(flags_l, flags_r))
        all_known = torch.sum(known_new, dim=1) >= LANES
        frozen = (done_at >= 0) | all_known
        z = correct(r)
        z_int = z.reshape(D, Sl, total)[:, :, hw:hw + R].reshape(D, Sl * R)
        xx = torch.where(frozen[:, None], xx, xx + z_int)
        known_k = known_new
        done_at = torch.where(done_at >= 0, done_at,
                              torch.where(all_known, base_t + float(t),
                                          -torch.ones_like(done_at)))
    # drain: the messages of rounds T-B .. T-1 were sent but not consumed;
    # their flags are still gossip, and the last one is the halo carry
    for n in range(max(T - B, 0), T):
        hl_out, hr_out, flags_l, flags_r = neighbours(*sent[n])
        known_k = torch.maximum(torch.maximum(known_k, flags_l), flags_r)
    aux_out = torch.zeros_like(aux)
    for k, v in enumerate((rn0, done_at, base_t + float(T), rn, hits)):
        aux_out[:, k] = v
    return (xx.contiguous(), known_k, aux_out, hl_out.contiguous(),
            hr_out.contiguous())


def async_ras_rounds(
    dia, b, dinv, mask_dom, mask_int, x, known, aux, hl, hr, boost=None, *,
    offsets: Tuple[int, ...], total: int, hw: int, rounds: int,
    staleness: int, ninner: int, tol: float, fresh_read: bool = False,
    nonsym: bool = False, nonsym_solver: str = "bicgstab",
    cluster: Optional[int] = None, mesh=None,
):
    """``rounds`` free-running rounds of all D ranks; K5 on the card.

    One cooperative launch, one cluster of C 1024-thread blocks per rank
    (all ranks resident at once, or the waits would deadlock).  C is
    :func:`choose_cluster`'s unless ``cluster`` forces one (the solvers
    never do; the tests and the smoke run compare sizes).  Raises when the
    card cannot hold D clusters, when a wait times out, and for
    ``fresh_read`` unless the flag-order probe (K9) has passed in this
    process at a cluster of at least the C about to launch.  Under a
    ``mesh`` of several processes the operands hold the process's ranks
    and each process launches them (see :mod:`.rank_rings`); the card must
    hold them alone, and ``.longest_wait_ns`` keeps the launch's longest
    wait."""
    kw = dict(offsets=offsets, total=total, hw=hw, rounds=rounds,
              staleness=staleness, ninner=ninner, tol=tol,
              fresh_read=fresh_read, nonsym=nonsym,
              nonsym_solver=nonsym_solver, mesh=mesh)
    if x.device.type == "cpu":
        return async_ras_rounds_plain(dia, b, dinv, mask_dom, mask_int, x,
                                      known, aux, hl, hr, boost, **kw)
    group = group_of(mesh)
    solver = solver_kind(nonsym, nonsym_solver)
    ops = dict(dia=dia, b=b, dinv=dinv, mask_dom=mask_dom,
               mask_int=mask_int, x=x, known=known, aux=aux, hl=hl, hr=hr)
    if boost is not None:
        ops["boost"] = boost
    cuda_build.check_operands("async_ras_rounds", (torch.float32,), **ops)
    D, K, L = dia.shape
    Sl, R = L // total, total - 2 * hw
    for name in ("b", "dinv", "mask_dom", "mask_int", "boost"):
        if name in ops and ops[name].shape != (D, L):
            raise ValueError(f"async_ras_rounds: {name} must be ({D}, {L})")
    if (L % total or x.shape != (D, Sl * R) or known.shape != (D, LANES)
            or aux.shape != (D, LANES) or hl.shape != (D, hw)
            or hr.shape != (D, hw)):
        raise ValueError("async_ras_rounds: operand shapes do not match "
                         f"D={D}, Sl*total={L}, total={total}, hw={hw}")
    if len(offsets) != K or not 0 < K <= 32:
        raise ValueError(f"async_ras_rounds: {len(offsets)} offsets for {K} "
                         "diagonals (1..32)")
    Dg = D if group is None else group.num_ranks   # D: this launch's
    if Dg > LANES:
        raise ValueError(f"async_ras_rounds: {Dg} ranks; the gossip keeps "
                         f"one lane per rank, at most {LANES}")
    if group is not None and group.ranks_per_process != D:
        raise ValueError(f"async_ras_rounds: {D} ranks in this process; "
                         f"the mesh deals it {group.ranks_per_process}")
    if solver == "gmres" and ninner > MAX_GMRES_M:
        raise ValueError(f"async_ras_rounds: GMRES({ninner}) exceeds the "
                         f"kernel's m <= {MAX_GMRES_M}")
    B = max(staleness, 1)
    lib = cuda_build.library("async_ras")

    def fits(c: int) -> int:
        key = (x.device, K, c)
        if key not in _max_clusters:
            with torch.cuda.device(x.device):
                _max_clusters[key] = lib.async_ras_max_clusters(K, c)
        return _max_clusters[key]

    C = choose_cluster(D, fits) if cluster is None else int(cluster)
    if C not in CLUSTER_SIZES or fits(C) < D:
        raise RuntimeError(
            f"async_ras_rounds: {D} ranks need {D} co-resident clusters of "
            f"{C} 1024-thread blocks; this card holds "
            f"{fits(C) if C in CLUSTER_SIZES else 0} — use fewer ranks "
            "(num_ranks)")
    if fresh_read and B > 1:
        from schwarz_tpu_torch.diagnostics import require_flag_order

        require_flag_order(x.device, C)
    M = 2 * B + 2
    slot = -(-(hw + Dg) // 4) * 4
    nwork = {"cg": 5, "bicgstab": 8, "gmres": ninner + 4}[solver]
    dev = x.device
    out = [torch.empty_like(x), torch.empty_like(known),
           torch.empty_like(aux), torch.empty_like(hl), torch.empty_like(hr)]
    work = torch.empty((D, nwork, L), dtype=torch.float32, device=dev)
    # the rings (D, 2, M, slot), sequence words (D, 2, M), ack counters
    # (D, 2) and the error word, in this process's window
    lay = ring_layout(D, 2, M, slot)
    first = 0 if group is None else group.block(Dg).start
    err, longest = launch_rounds(
        "async_ras", dev, group, lay, lambda *win: lib.async_ras_f32(
            dia.data_ptr(), b.data_ptr(), dinv.data_ptr(),
            mask_dom.data_ptr(), mask_int.data_ptr(),
            boost.data_ptr() if boost is not None else None,
            x.data_ptr(), known.data_ptr(), aux.data_ptr(), hl.data_ptr(),
            hr.data_ptr(), *(o.data_ptr() for o in out), work.data_ptr(),
            *win, Dg, D, first, Sl, K, total, hw, rounds, B, ninner,
            _SOLVERS[solver],
            int(bool(fresh_read)), cuda_build.int_array(offsets),
            float(tol) * float(tol), C, cuda_build.stream_ptr(dev)))
    async_ras_rounds.launches += 1
    async_ras_rounds.cluster = C
    async_ras_rounds.longest_wait_ns = longest
    if err:
        what = {1: "an acknowledgement", 2: "a neighbour's message",
                3: "a message to drain"}.get(err, f"code {err}")
        raise RuntimeError(
            f"async_ras_rounds: a rank waited for {what} past the watchdog; "
            "the ranks' protocol is broken")
    return tuple(out)


async_ras_rounds.launches = 0
async_ras_rounds.cluster = None    # blocks per rank of the last launch
async_ras_rounds.longest_wait_ns = None   # last launch's, across processes
