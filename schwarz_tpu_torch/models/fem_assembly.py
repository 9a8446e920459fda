"""Real P1 finite-element assembly with adaptive local refinement (a numpy
copy of ``schwarz_tpu/models/fem_assembly.py``, bit-identical).

The role of the reference's deal.II programs (benchmarking/dealii_ex_6.cpp:
adaptively-refined FEM Poisson feeding SolverRAS at :312-316, and the
anisotropic FEM family behind the bundled ani3/ani4 test matrices): produce
genuinely *unstructured*, locally-refined operators — the regime where the
graph (metis-equivalent) partitioner and per-row ``cell_weights`` earn their
keep, which structured FD generators never stress.

Pipeline (host, numpy, setup-time):
  1. structured triangulation of the unit square (two triangles per cell),
  2. ``refine_levels`` rounds of longest-edge (Rivara) bisection of the
     triangles nearest ``refine_at``, with conformity propagation (no
     hanging nodes — asserted),
  3. vectorized P1 stiffness assembly for ``-div(K grad u)`` with
     ``K = R(theta) diag(1, eps) R(theta)^T`` (eps >> 1 reproduces the
     ani3/ani4 anisotropy), one-point-quadrature load ``f = 1``,
  4. Dirichlet elimination of boundary nodes.

Returns the interior operator, rhs, node coordinates, and per-node
``cell_weights`` (incident-triangle counts — refined regions are heavier),
ready for ``solve(..., cell_weights=...)`` weight-balanced partitioning.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from schwarz_tpu_torch.models.csr import CSRMatrix


def _structured_triangulation(n: int):
    """(n+1)^2 vertices on the unit square, 2*n^2 triangles (lower-left /
    upper-right split of each cell), all counter-clockwise."""
    xs = np.linspace(0.0, 1.0, n + 1)
    vx, vy = np.meshgrid(xs, xs, indexing="xy")
    verts = np.stack([vx.ravel(), vy.ravel()], axis=1)

    def vid(ix, iy):
        return iy * (n + 1) + ix

    tris = []
    for iy in range(n):
        for ix in range(n):
            a = vid(ix, iy)
            b = vid(ix + 1, iy)
            c = vid(ix + 1, iy + 1)
            d = vid(ix, iy + 1)
            tris.append((a, b, c))
            tris.append((a, c, d))
    return verts, tris


def _refine(verts: np.ndarray, tris, marked) -> Tuple[np.ndarray, list]:
    """Longest-edge (Rivara) bisection of ``marked`` triangle indices with
    conformity propagation; returns (new verts, new triangle list)."""
    verts_list = [tuple(v) for v in verts]
    mid: Dict[frozenset, int] = {}

    def midpoint(a: int, b: int) -> int:
        key = frozenset((a, b))
        if key not in mid:
            va = np.asarray(verts_list[a])
            vb = np.asarray(verts_list[b])
            verts_list.append(tuple((va + vb) / 2.0))
            mid[key] = len(verts_list) - 1
        return mid[key]

    def longest_edge(t):
        pts = [np.asarray(verts_list[v]) for v in t]
        lens = [np.sum((pts[(k + 1) % 3] - pts[k]) ** 2) for k in range(3)]
        k = int(np.argmax(lens))
        return t[k], t[(k + 1) % 3], t[(k + 2) % 3]

    tris = [tuple(t) for t in tris]
    queue = set(int(m) for m in marked)
    # bisect marked triangles, then propagate until conforming: any triangle
    # one of whose edges carries a midpoint must itself be bisected
    for _ in range(64 * (len(tris) + len(queue)) + 64):
        if queue:
            idx = queue.pop()
            t = tris[idx]
            if t is None:
                continue
            a, b, c = longest_edge(t)
            m = midpoint(a, b)
            tris[idx] = None
            tris.append((a, m, c))
            tris.append((m, b, c))
            continue
        # conformity sweep
        dirty = False
        for idx, t in enumerate(tris):
            if t is None:
                continue
            for k in range(3):
                e = frozenset((t[k], t[(k + 1) % 3]))
                if e in mid:
                    queue.add(idx)
                    dirty = True
                    break
        if not dirty:
            break
    else:  # pragma: no cover - safety bound
        raise RuntimeError("refinement did not reach conformity")

    new_tris = [t for t in tris if t is not None]
    # conformity assertion: no surviving triangle edge carries a midpoint
    # (a midpoint on an edge would be a hanging node)
    for t in new_tris:
        for k in range(3):
            assert frozenset((t[k], t[(k + 1) % 3])) not in mid, (
                "hanging node after refinement"
            )
    return np.asarray(verts_list, dtype=np.float64), new_tris


def fem_p1_poisson(
    n: int,
    refine_levels: int = 0,
    refine_at: Tuple[float, float] = (0.0, 0.0),
    refine_fraction: float = 0.25,
    eps: float = 1.0,
    theta: float = 0.0,
    dtype=np.float64,
) -> Tuple[CSRMatrix, np.ndarray, np.ndarray, np.ndarray]:
    """Assemble the P1 operator for ``-div(K grad u) = 1`` on the unit square.

    ``refine_levels`` rounds of local refinement bisect the
    ``refine_fraction`` of triangles nearest ``refine_at`` (dealii_ex_6's
    adaptive-refinement role); ``eps``/``theta`` set the anisotropy
    ``K = R(theta) diag(1, eps) R(theta)^T`` (ani3/ani4 role; eps = 1 is the
    plain Laplacian).

    Returns ``(A_interior, rhs_interior, coords_interior, cell_weights)``.
    """
    verts, tris = _structured_triangulation(n)
    for _ in range(refine_levels):
        cent = np.array([
            np.mean([verts[v] for v in t], axis=0) for t in tris
        ])
        dist = np.linalg.norm(cent - np.asarray(refine_at), axis=1)
        k = max(1, int(refine_fraction * len(tris)))
        marked = np.argsort(dist)[:k]
        verts, tris = _refine(verts, tris, marked)

    T = np.asarray(tris, dtype=np.int64)            # (M, 3)
    P = verts[T]                                    # (M, 3, 2)
    # edge vectors opposite each vertex: e_k = p_{k+2} - p_{k+1}
    e = P[:, [2, 0, 1], :] - P[:, [1, 2, 0], :]     # (M, 3, 2)
    # signed double area
    twoA = e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0]
    area = np.abs(twoA) / 2.0
    # grad of barycentric basis k: rotate opposite edge by 90 deg / (2A)
    grads = np.stack([-e[..., 1], e[..., 0]], axis=-1) / twoA[:, None, None]
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]])
    K = R @ np.diag([1.0, eps]) @ R.T
    # element stiffness: A_ij = area * grad_i . K grad_j   (M, 3, 3)
    Kg = np.einsum("ab,mjb->mja", K, grads)
    elem = area[:, None, None] * np.einsum("mia,mja->mij", grads, Kg)

    rows = np.repeat(T, 3, axis=1).ravel()          # (M*9,)
    cols = np.tile(T, (1, 3)).ravel()
    vals = elem.reshape(-1)   # row-major (i outer, j inner) matches rows/cols

    V = len(verts)
    on_bnd = (
        (np.abs(verts[:, 0]) < 1e-12) | (np.abs(verts[:, 0] - 1) < 1e-12)
        | (np.abs(verts[:, 1]) < 1e-12) | (np.abs(verts[:, 1] - 1) < 1e-12)
    )
    interior = np.where(~on_bnd)[0]
    new_id = -np.ones(V, dtype=np.int64)
    new_id[interior] = np.arange(len(interior))

    keep = (~on_bnd[rows]) & (~on_bnd[cols])
    # scipy COO->CSR sums the per-triangle duplicates of each (i, j) pair
    # (CSRMatrix.from_coo does not coalesce)
    import scipy.sparse as sp

    A = CSRMatrix.from_scipy(sp.coo_matrix(
        (vals[keep].astype(dtype),
         (new_id[rows[keep]], new_id[cols[keep]])),
        shape=(len(interior), len(interior)),
    ).tocsr())
    # load f = 1, one-point quadrature: area/3 to each vertex
    rhs_full = np.zeros(V, dtype=dtype)
    np.add.at(rhs_full, T.ravel(), np.repeat(area / 3.0, 3))
    # cell weights: incident-triangle counts (refined regions heavier)
    wt_full = np.zeros(V, dtype=np.float64)
    np.add.at(wt_full, T.ravel(), 1.0)
    return (
        A,
        rhs_full[interior],
        verts[interior],
        wt_full[interior],
    )


# --- dealii_ex_9 role: SUPG-stabilized pure advection ----------------------

def _ex9_beta(p: np.ndarray) -> np.ndarray:
    """Advection field of the reference program
    (benchmarking/dealii_ex_9.cpp:77-84): (2, 1 + 0.8 sin(8 pi x))."""
    out = np.empty_like(p)
    out[:, 0] = 2.0
    out[:, 1] = 1.0 + 0.8 * np.sin(8.0 * np.pi * p[:, 0])
    return out


def _ex9_source(p: np.ndarray) -> np.ndarray:
    """Right-hand side (dealii_ex_9.cpp:105-115): 0.1/d^2 inside the ball
    of diameter 0.1 around (-0.75, -0.75), else 0.1."""
    d = 0.1
    r2 = ((p - np.array([-0.75, -0.75])) ** 2).sum(axis=1)
    return np.where(r2 < d * d, 0.1 / d ** 2, 0.1)


def _ex9_boundary(p: np.ndarray) -> np.ndarray:
    """Weak inflow boundary values (dealii_ex_9.cpp:127-135):
    exp(5 (1 - |p|^2)) sin(16 pi |p|^2)."""
    r2 = (p ** 2).sum(axis=1)
    return np.exp(5.0 * (1.0 - r2)) * np.sin(16.0 * np.pi * r2)


def _boundary_edges(T: np.ndarray):
    """(a, b, opp) arrays of edges owned by exactly one triangle."""
    seen: Dict[frozenset, Tuple[int, int, int]] = {}
    dup = set()
    for t in T:
        for k in range(3):
            a, b, o = int(t[(k + 1) % 3]), int(t[(k + 2) % 3]), int(t[k])
            e = frozenset((a, b))
            if e in seen:
                dup.add(e)
            else:
                seen[e] = (a, b, o)
    edges = [v for e, v in seen.items() if e not in dup]
    arr = np.asarray(edges, dtype=np.int64).reshape(-1, 3)
    return arr[:, 0], arr[:, 1], arr[:, 2]


def _assemble_advection(verts, T, beta, source, inflow_values,
                        delta_factor, dtype):
    """Vectorized P1 SUPG assembly of ``beta . grad u = f`` with weak
    inflow boundary conditions (dealii_ex_9.cpp:289-367 semantics).

    Test functions ``phi_i + delta beta . grad phi_i`` with
    ``delta = delta_factor * diameter``; edge-midpoint quadrature (exact
    through degree 2); boundary faces with ``beta . n < 0`` contribute
    ``-(beta.n) phi_i phi_j`` / ``-(beta.n) g phi_i`` via 2-point Gauss.
    No Dirichlet elimination: every vertex is a DOF (the inflow condition
    is weak), so the operator is genuinely non-symmetric.
    """
    import scipy.sparse as sp

    P = verts[T]                                    # (M, 3, 2)
    e = P[:, [2, 0, 1], :] - P[:, [1, 2, 0], :]     # edge opposite vertex k
    twoA = e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0]
    area = np.abs(twoA) / 2.0
    grads = np.stack([-e[..., 1], e[..., 0]], axis=-1) / twoA[:, None, None]
    diam = np.linalg.norm(e, axis=2).max(axis=1)
    delta = delta_factor * diam                     # (M,)

    # quadrature: midpoint of the edge opposite vertex q
    mids = (P[:, [1, 2, 0], :] + P[:, [2, 0, 1], :]) / 2.0   # (M, 3, 2)
    M = len(T)
    bq = beta(mids.reshape(-1, 2)).reshape(M, 3, 2)
    fq = np.asarray(source(mids.reshape(-1, 2))).reshape(M, 3)
    bg = np.einsum("mqa,mja->mqj", bq, grads)       # beta(q) . grad phi_j
    phi = 0.5 * (1.0 - np.eye(3))                   # phi[i, q] at mid_q
    w = area / 3.0
    elem = w[:, None, None] * (
        np.einsum("iq,mqj->mij", phi, bg)
        + delta[:, None, None] * np.einsum("mqi,mqj->mij", bg, bg)
    )
    rhs_elem = w[:, None] * (
        np.einsum("iq,mq->mi", phi, fq)
        + delta[:, None] * np.einsum("mqi,mq->mi", bg, fq)
    )

    V = len(verts)
    rows = [np.repeat(T, 3, axis=1).ravel()]
    cols = [np.tile(T, (1, 3)).ravel()]
    vals = [elem.reshape(-1)]
    rhs = np.zeros(V, dtype=np.float64)
    np.add.at(rhs, T.ravel(), rhs_elem.ravel())

    # weak inflow terms on boundary edges
    ea, eb, eo = _boundary_edges(T)
    pa, pb = verts[ea], verts[eb]
    tang = pb - pa
    L = np.linalg.norm(tang, axis=1)
    nrm = np.stack([tang[:, 1], -tang[:, 0]], axis=1) / L[:, None]
    # outward: away from the opposite vertex
    flip = ((verts[eo] - (pa + pb) / 2.0) * nrm).sum(axis=1) > 0
    nrm[flip] *= -1.0
    for s in ((1.0 - 1.0 / np.sqrt(3.0)) / 2.0,
              (1.0 + 1.0 / np.sqrt(3.0)) / 2.0):
        xq = pa + tang * s
        bn = (beta(xq) * nrm).sum(axis=1)
        gq = np.asarray(inflow_values(xq))
        wq = L / 2.0
        coef = np.where(bn < 0.0, -bn * wq, 0.0)    # per-q-point inflow test
        pha, phb = 1.0 - s, s
        for (i, pi) in ((ea, pha), (eb, phb)):
            for (j, pj) in ((ea, pha), (eb, phb)):
                rows.append(i)
                cols.append(j)
                vals.append(coef * pi * pj)
            np.add.at(rhs, i, coef * gq * pi)

    A = CSRMatrix.from_scipy(sp.coo_matrix(
        (np.concatenate(vals).astype(dtype),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(V, V),
    ).tocsr())
    return A, rhs.astype(dtype), grads, diam


def fem_p1_advection(
    n: int,
    refine_cycles: int = 0,
    refine_fraction: float = 0.3,
    delta_factor: float = 0.1,
    beta=None,
    source=None,
    inflow_values=None,
    domain: Tuple[float, float] = (-1.0, 1.0),
    dtype=np.float64,
) -> Tuple[CSRMatrix, np.ndarray, np.ndarray, np.ndarray]:
    """Assemble the P1 SUPG advection operator of dealii_ex_9.

    ``beta . grad u = f`` on ``domain^2`` with weak inflow boundary
    conditions; defaults reproduce the reference program's data
    (dealii_ex_9.cpp:77-135).  ``refine_cycles`` rounds of
    gradient-estimator adaptive refinement (the GradientEstimation loop,
    dealii_ex_9.cpp:576-580): solve on the current mesh, mark the
    ``refine_fraction`` of triangles with the largest
    ``|grad u_h| diam^1.5`` indicator, Rivara-bisect.

    Returns ``(A, rhs, coords, cell_weights)`` over ALL vertices (the
    inflow condition is weak — no Dirichlet elimination); ``A`` is
    non-symmetric, so pair with GMRES local solves
    (``local_solver=iterative-ginkgo --non_symmetric_matrix`` in CLI
    terms).
    """
    import scipy.sparse.linalg as spla

    beta = beta or _ex9_beta
    source = source or _ex9_source
    inflow_values = inflow_values or _ex9_boundary

    verts, tris = _structured_triangulation(n)
    lo, hi = domain
    verts = lo + (hi - lo) * verts
    for _ in range(refine_cycles):
        T = np.asarray(tris, dtype=np.int64)
        A, rhs, grads, diam = _assemble_advection(
            verts, T, beta, source, inflow_values, delta_factor, dtype
        )
        u = spla.spsolve(A.to_scipy().tocsc(), rhs)
        gu = np.einsum("mi,mia->ma", u[T], grads)   # per-cell grad u_h
        indicator = np.linalg.norm(gu, axis=1) * diam ** 1.5
        k = max(1, int(refine_fraction * len(T)))
        marked = np.argsort(indicator)[-k:]
        verts, tris = _refine(verts, tris, marked)

    T = np.asarray(tris, dtype=np.int64)
    A, rhs, _grads, _diam = _assemble_advection(
        verts, T, beta, source, inflow_values, delta_factor, dtype
    )
    wt = np.zeros(len(verts), dtype=np.float64)
    np.add.at(wt, T.ravel(), 1.0)
    return A, rhs, verts, wt


# --- dealii_ex_17 role: step-8/17 linear elasticity ------------------------

def _ex17_body_force(p: np.ndarray) -> np.ndarray:
    """step-8 body force (dealii_ex_17.cpp:182-204): x-component 1 inside
    the r=0.2 balls around (+-0.5, 0), y-component 1 inside the r=0.2
    ball around the origin."""
    f = np.zeros_like(p)
    r1 = ((p - np.array([0.5, 0.0])) ** 2).sum(axis=1)
    r2 = ((p - np.array([-0.5, 0.0])) ** 2).sum(axis=1)
    f[:, 0] = np.where((r1 < 0.04) | (r2 < 0.04), 1.0, 0.0)
    f[:, 1] = np.where((p ** 2).sum(axis=1) < 0.04, 1.0, 0.0)
    return f


def fem_p1_elasticity(
    n: int,
    lam: float = 1.0,
    mu: float = 1.0,
    body_force=None,
    domain: Tuple[float, float] = (-1.0, 1.0),
    dtype=np.float64,
) -> Tuple[CSRMatrix, np.ndarray, np.ndarray, np.ndarray]:
    """Assemble vector-P1 linear elasticity (the dealii_ex_17 problem).

    The step-8/17 bilinear form (dealii_ex_17.cpp:475-495):
    ``lambda div u div v + mu grad u : grad v^T + mu grad u : grad v``
    (strong form ``-mu lap u - (lambda + mu) grad(div u) = f``) on
    ``domain^2`` with zero Dirichlet boundary, constant ``lambda``/``mu``
    and the step-8 ball body forces.  The reference drives this with pure
    deal.II + PETSc CG as an external baseline; here the SPD vector
    operator feeds the RAS solver directly.

    DOFs interleave components (``dof = 2 vertex + comp``).  Returns
    ``(A_interior, rhs_interior, coords_interior_dofs, cell_weights)``.
    """
    body_force = body_force or _ex17_body_force

    verts, tris = _structured_triangulation(n)
    lo, hi = domain
    verts = lo + (hi - lo) * verts
    T = np.asarray(tris, dtype=np.int64)            # (M, 3)
    P = verts[T]
    e = P[:, [2, 0, 1], :] - P[:, [1, 2, 0], :]
    twoA = e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0]
    area = np.abs(twoA) / 2.0
    g = np.stack([-e[..., 1], e[..., 0]], axis=-1) / twoA[:, None, None]

    # block element matrix over (a, ci, b, cj):
    #   area * (lam g_a[ci] g_b[cj] + mu g_a[cj] g_b[ci]
    #           + (ci == cj) mu g_a . g_b)
    gagb = np.einsum("mak,mbk->mab", g, g)          # g_a . g_b
    elem = (
        lam * np.einsum("mai,mbj->maibj", g, g)
        + mu * np.einsum("maj,mbi->maibj", g, g)
        + mu * gagb[:, :, None, :, None] * np.eye(2)[None, None, :, None, :]
    ) * area[:, None, None, None, None]

    dof = 2 * T[:, :, None] + np.arange(2)[None, None, :]   # (M, 3, 2)
    drow = np.broadcast_to(dof[:, :, :, None, None], elem.shape)
    dcol = np.broadcast_to(dof[:, None, None, :, :], elem.shape)

    # rhs: edge-midpoint quadrature of phi_a f_c
    mids = (P[:, [1, 2, 0], :] + P[:, [2, 0, 1], :]) / 2.0
    M = len(T)
    fq = body_force(mids.reshape(-1, 2)).reshape(M, 3, 2)
    phi = 0.5 * (1.0 - np.eye(3))                   # phi[a, q]
    rhs_elem = (area / 3.0)[:, None, None] * np.einsum(
        "aq,mqc->mac", phi, fq
    )                                               # (M, 3, 2)

    V = len(verts)
    rhs_full = np.zeros(2 * V, dtype=np.float64)
    np.add.at(rhs_full, dof.ravel(), rhs_elem.ravel())

    on_bnd = (
        (np.abs(verts[:, 0] - lo) < 1e-12) | (np.abs(verts[:, 0] - hi) < 1e-12)
        | (np.abs(verts[:, 1] - lo) < 1e-12) | (np.abs(verts[:, 1] - hi) < 1e-12)
    )
    dof_bnd = np.repeat(on_bnd, 2)
    interior = np.where(~dof_bnd)[0]
    new_id = -np.ones(2 * V, dtype=np.int64)
    new_id[interior] = np.arange(len(interior))

    rows, cols, vals = drow.ravel(), dcol.ravel(), elem.ravel()
    keep = (~dof_bnd[rows]) & (~dof_bnd[cols])
    import scipy.sparse as sp

    A = CSRMatrix.from_scipy(sp.coo_matrix(
        (vals[keep].astype(dtype),
         (new_id[rows[keep]], new_id[cols[keep]])),
        shape=(len(interior), len(interior)),
    ).tocsr())

    wt_full = np.zeros(V, dtype=np.float64)
    np.add.at(wt_full, T.ravel(), 1.0)
    coords_dof = np.repeat(verts, 2, axis=0)
    return (
        A,
        rhs_full[interior].astype(dtype),
        coords_dof[interior],
        np.repeat(wt_full, 2)[interior],
    )
