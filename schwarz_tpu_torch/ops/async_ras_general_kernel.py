"""K7: the free-running asynchronous RAS rounds of the general-graph tier, a
hand-written CUDA kernel.

Replaces ``schwarz_tpu/ops/async_ras_general.py`` ``async_general_rounds``
(:360): one launch runs ``rounds`` outer RAS iterations on every rank (one
per subdomain of any partition of any matrix) with no barrier between ranks.
Each rank sends, on every colour of the edge-coloured subdomain graph, the
owned values its partner needs with its known-converged bits into a slot ring
of M = 2B+2 messages, consumes its partners' messages of round t-B (in the
warm-up rounds t < B the ``carry`` of the previous launch), acknowledges
them, gossips convergence in band, runs its correction solve on its extended
rows (Jacobi-PCG or BiCGStab, with the optional O-RAS Robin diagonal) and
freezes once it knows every rank converged (source:
``csrc/async_ras_general.cu``).

Layout, for S ranks with Rext = Rint + H extended slots each (owned rows,
then halo): the operators in padded ELL form, planes first, ``cols`` int32
and ``vals`` float32 (S, K, Rext), the entries of a row in slot order;
``b``, ``dinv``, ``mask_int``, ``boost`` (S, Rext); ``send_idx`` and
``recv_slot`` int32 (S, C, SEG): the owned position packed into place k of
the message on colour c, and the halo slot place k of the received message
lands in, -1 for none; ``tgt_subd`` int32 (S, C): the partner, or the rank
itself where it has no link of that colour; the iterate ``x`` (S, Rint),
``known`` and ``aux`` (S, 128), ``carry`` (S, C, SEG).  Dot products sum
float32 products in float64 and round once, a row's product is summed over
its K entries in order in float32, and the kernel is built without FMA
contraction, as K5 and K6 are (:mod:`.async_ras_kernel`).

A rank is one block.  When the rank's work vectors, ELL planes and dinv
fit the block's shared memory (:func:`.cluster_geometry.general_variant`)
the ``shared`` variant copies them there at the launch's start and runs
512 threads a block; otherwise the ``global`` variant, the same kernel,
keeps them in device memory and runs 1024.  The choice is by size alone.

:func:`async_general_rounds_plain` is the same function in plain PyTorch: a
lockstep emulation in which every rank runs round t at once.  A rank blocks
on message t-B exactly and no slot is reused before it is acknowledged, so
the kernel's result does not depend on timing and the emulation is exact up
to ties in the float64 sums.
"""

from __future__ import annotations

import torch

from schwarz_tpu_torch.ops import cuda_build
from schwarz_tpu_torch.ops.async_ras_kernel import (
    LANES,
    bicgstab_plain,
    dot_f64,
    jacobi_pcg_plain,
)
from schwarz_tpu_torch.ops.cluster_geometry import (SMEM_PER_BLOCK,
                                                    general_smem_bytes,
                                                    general_variant)

VARIANTS = ("shared", "global")


def ell_planes(cols, vals):
    """(S, Rext, K) ELL arrays of a plan -> the kernel's (S, K, Rext)."""
    return (cols.permute(0, 2, 1).contiguous(),
            vals.permute(0, 2, 1).contiguous())


def async_general_rounds_plain(
    cols, vals, b, dinv, mask_int, send_idx, recv_slot, tgt_subd, x, known,
    aux, carry, boost=None, *, rounds: int, staleness: int, ninner: int,
    tol: float, nonsym: bool = False,
):
    """Lockstep emulation of ``rounds`` free-running rounds of all S ranks.

    Returns (x, known, aux, carry) in the input layout.  aux lanes: 0 the
    first local ||r||^2 (-1 before the first round), 1 ``done_at`` (-1 until
    the rank knows of global convergence), 2 the global round counter, 3 the
    last local ||r||^2; the other lanes pass through."""
    f32 = torch.float32
    dev = x.device
    S, K, Rext = vals.shape
    Rint = x.shape[1]
    H = Rext - Rint
    C, SEG = send_idx.shape[1:]
    B = max(staleness, 1)
    T = rounds
    tol2 = torch.tensor(float(tol) * float(tol), dtype=f32, device=dev)
    lane = torch.arange(LANES, device=dev)
    me = torch.arange(S, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    col_idx = cols.long()
    tgt = tgt_subd.long()
    color = torch.arange(C, device=dev)[None, :]
    # unused places pack position 0 and are zeroed; unused received places
    # land in a scratch slot past the halo
    send_pos = send_idx.clamp(min=0).long().reshape(S, C * SEG)
    send_on = (send_idx >= 0).reshape(S, C * SEG)
    land = torch.where(recv_slot >= 0, recv_slot,
                       torch.full_like(recv_slot, H)).long().reshape(S, -1)

    def apply_dom(v):
        # w[q] = sum_k vals[k, q] * v[cols[k, q]], the K entries in order
        acc = vals[:, 0] * torch.gather(v, 1, col_idx[:, 0])
        for k in range(1, K):
            acc = acc + vals[:, k] * torch.gather(v, 1, col_idx[:, k])
        return acc

    def dot(u, v):
        return dot_f64(u, v, 1)

    def apply_solve(v):
        av = apply_dom(v)
        if boost is not None:
            av = av + boost * v
        return av

    def received(a):
        """a[partner on colour c, c] at every (rank, c): what the rank's
        partner sent it (its own message where it has no link)."""
        return a[tgt, color]

    known_k = torch.maximum(known, (lane >= S).to(f32)[None, :])
    rn0, done_at = aux[:, 0], aux[:, 1]
    base_t = aux[0, 2]
    rn = torch.zeros(S, dtype=f32, device=dev)
    xx = x
    sent = []      # per round: (values (S, C, SEG), known bits (S, 128))
    for t in range(T):
        vals_out = torch.where(send_on, torch.gather(xx, 1, send_pos), zero)
        sent.append((vals_out.reshape(S, C, SEG), known_k))
        if t >= B:
            msg = received(sent[t - B][0])
            # a rank without a link on a colour gets its own bits back
            flags = received(sent[t - B][1][:, None, :].expand(S, C, LANES))
            known_k = torch.maximum(known_k, flags.amax(dim=1))
        else:
            msg = carry
        halo = torch.zeros((S, H + 1), dtype=f32, device=dev)
        halo.scatter_(1, land, msg.reshape(S, C * SEG))
        x_ext = torch.cat([xx, halo[:, :H]], dim=1)
        r = b - apply_dom(x_ext)
        rn = dot(mask_int * r, mask_int * r)[:, 0]
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
        xx = torch.where(frozen[:, None], xx, xx + z[:, :Rint])
        done_at = torch.where(done_at >= 0, done_at,
                              torch.where(all_known, base_t + float(t),
                                          -torch.ones_like(done_at)))
    # the last B messages were sent but not consumed: their flags are still
    # gossip, and the values of the last one are the carry
    for n in range(max(T - B, 0), T):
        flags = received(sent[n][1][:, None, :].expand(S, C, LANES))
        known_k = torch.maximum(known_k, flags.amax(dim=1))
    carry_out = received(sent[T - 1][0])
    aux_out = aux.clone()
    for k, v in enumerate((rn0, done_at, base_t + float(T), rn)):
        aux_out[:, k] = v
    return xx.contiguous(), known_k, aux_out, carry_out.contiguous()


def async_general_rounds(
    cols, vals, b, dinv, mask_int, send_idx, recv_slot, tgt_subd, x, known,
    aux, carry, boost=None, *, rounds: int, staleness: int, ninner: int,
    tol: float, nonsym: bool = False, variant=None,
):
    """``rounds`` free-running rounds of all S ranks; K7 on the card.

    One cooperative launch, one block per rank (all ranks resident at once,
    or the waits would deadlock).  ``variant`` ('shared' or 'global') forces
    what :func:`.cluster_geometry.general_variant` otherwise chooses by size
    (the solvers never force it; the tests and the smoke run compare both).
    The last launch's variant and threads a block are kept in
    ``async_general_rounds.variant`` and ``.threads``.  Raises when a forced
    'shared' variant does not fit, when the card cannot hold S blocks and
    when a wait times out."""
    kw = dict(rounds=rounds, staleness=staleness, ninner=ninner, tol=tol,
              nonsym=nonsym)
    if x.device.type == "cpu":
        return async_general_rounds_plain(
            cols, vals, b, dinv, mask_int, send_idx, recv_slot, tgt_subd, x,
            known, aux, carry, boost, **kw)
    f32s = dict(vals=vals, b=b, dinv=dinv, mask_int=mask_int, x=x,
                known=known, aux=aux, carry=carry)
    if boost is not None:
        f32s["boost"] = boost
    ints = dict(cols=cols, send_idx=send_idx, recv_slot=recv_slot,
                tgt_subd=tgt_subd)
    what = "async_general_rounds"
    cuda_build.check_operands(what, (torch.float32,), **f32s)
    cuda_build.check_operands(what, (torch.int32,), **ints)
    if cols.device != x.device:
        raise ValueError(f"{what}: operands must share one CUDA device")
    if vals.dim() != 3 or x.dim() != 2 or send_idx.dim() != 3:
        raise ValueError(f"{what}: vals must be (S, K, Rext), x (S, Rint) "
                         "and send_idx (S, C, SEG)")
    S, K, Rext = vals.shape
    Rint = x.shape[1]
    C, SEG = send_idx.shape[1:]
    for name in ("b", "dinv", "mask_int", "boost"):
        if name in f32s and f32s[name].shape != (S, Rext):
            raise ValueError(f"{what}: {name} must be ({S}, {Rext})")
    if (cols.shape != vals.shape or x.shape[0] != S or not 0 < Rint <= Rext
            or recv_slot.shape != (S, C, SEG) or tgt_subd.shape != (S, C)
            or carry.shape != (S, C, SEG) or known.shape != (S, LANES)
            or aux.shape != (S, LANES)):
        raise ValueError(f"{what}: operand shapes do not match S={S}, "
                         f"K={K}, Rext={Rext}, Rint={Rint}, C={C}, SEG={SEG}")
    if S > LANES:
        raise ValueError(f"{what}: {S} ranks; the gossip keeps one lane per "
                         f"rank, at most {LANES}")
    fitting = general_variant(Rext, K, nonsym)
    v = fitting if variant is None else variant
    if v not in VARIANTS:
        raise ValueError(f"{what}: variant {v!r}, expected one of {VARIANTS}")
    smem = general_smem_bytes(Rext, K, nonsym) if v == "shared" else 0
    if v == "shared" and fitting != "shared":
        raise ValueError(
            f"{what}: a rank of {Rext} extended rows and {K} entries a row "
            f"needs {smem} bytes of shared memory; a block may take "
            f"{SMEM_PER_BLOCK} — use variant='global' or more parts")
    lib = cuda_build.library("async_ras_general")
    nt = lib.async_general_threads(smem)
    with torch.cuda.device(x.device):
        cap = lib.async_general_max_ranks(K, smem)
    if S > cap:
        raise RuntimeError(
            f"{what}: {S} ranks need {S} co-resident blocks of {nt} threads "
            f"and {smem} bytes of shared memory ({v} variant); this card "
            f"holds {cap} — use a partition with fewer parts")
    B = max(staleness, 1)
    M = 2 * B + 2
    dev = x.device
    out = [torch.empty_like(x), torch.empty_like(known),
           torch.empty_like(aux), torch.empty_like(carry)]
    work = (torch.empty((S, 8 if nonsym else 5, Rext), dtype=torch.float32,
                        device=dev) if v == "global" else None)
    ring = torch.empty((S, C, M, SEG + LANES), dtype=torch.float32,
                       device=dev)
    # sequence words (S, C, M), ack counters (S, C) as uint32 pairs, and the
    # error word: zeroed by a stream-ordered memset before each launch
    sync = torch.zeros(S * C * M + (S * C + 1) // 2 + 1, dtype=torch.int64,
                       device=dev)
    cuda_build.check(
        lib.async_general_f32(
            cols.data_ptr(), vals.data_ptr(), b.data_ptr(), dinv.data_ptr(),
            mask_int.data_ptr(),
            boost.data_ptr() if boost is not None else None,
            send_idx.data_ptr(), recv_slot.data_ptr(), tgt_subd.data_ptr(),
            x.data_ptr(), known.data_ptr(), aux.data_ptr(), carry.data_ptr(),
            *(o.data_ptr() for o in out),
            work.data_ptr() if work is not None else None, ring.data_ptr(),
            sync.data_ptr(), S, Rint, Rext - Rint, K, SEG, C, rounds, B,
            ninner, int(bool(nonsym)), float(tol) * float(tol), smem,
            cuda_build.stream_ptr(dev)),
        what)
    async_general_rounds.launches += 1
    async_general_rounds.variant = v
    async_general_rounds.threads = nt
    err = int(sync[-1].item())
    if err:
        waited = {1: "an acknowledgement", 2: "a partner's message",
                  3: "a message to drain"}.get(err, f"code {err}")
        raise RuntimeError(
            f"{what}: a rank waited for {waited} past the watchdog; the "
            "ranks' protocol is broken")
    return tuple(out)


async_general_rounds.launches = 0
async_general_rounds.variant = None   # 'shared' or 'global', last launch
async_general_rounds.threads = None   # threads a block, last launch
