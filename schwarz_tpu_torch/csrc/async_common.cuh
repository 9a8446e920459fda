// Device code shared by the free-running kernels (async_ras.cu, the 1-D
// banded tier, async_ras_2d.cu, the 2-D block-grid tier, and
// async_ras_general.cu, the general tier): the release/acquire handoff
// between ranks, the watchdog spin, the float64 reductions and the
// correction solves that take any operator.  A rank is one thread block of
// NT threads (block_sum, jacobi_pcg, jacobi_bicgstab: the general tier) or a
// thread-block cluster (ClusterTeam and the cluster_* solves: the 1-D and
// 2-D tiers).  The flag-order probe (diagnostics.cu) runs the same handoff.
#pragma once

#include <cooperative_groups.h>

#include <cfloat>
#include <cstdint>
#include <type_traits>

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;  // known-converged lanes: one per rank
constexpr long long kWatchdogCycles = 8000000000LL;  // ~4 s at 1.98 GHz

enum Wait { kWaitAck = 1, kWaitMessage = 2, kWaitDrain = 3 };

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ void red_release_add(unsigned int* p,
                                                unsigned int v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Spins until *p >= want.  False when the watchdog fired here or elsewhere.
template <typename T>
__device__ bool spin_until(const T* p, T want, int* err, int code) {
  const long long t0 = clock64();
  while (ld_acquire(p) < want) {
    if (*(volatile int*)err != 0) return false;
    if (clock64() - t0 > kWatchdogCycles) {
      atomicCAS(err, 0, code);
      return false;
    }
    __nanosleep(64);
  }
  return true;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sums each v[n] over the block; every thread gets the totals.  The terms
// are float32 products; the sums are float64 and are rounded to float32 by
// the caller, so the result does not depend on the summation order (up to
// a tie at a float32 rounding boundary) and the plain version, which sums
// the same float32 products in float64, gets the same float32 dot.
// A block of NT threads; ``sh`` holds N * NT / 32 + N doubles.
template <int NT, int N>
__device__ __forceinline__ void block_sum(double (&v)[N], double* sh) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = warp_sum(v[n]);
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) sh[n * NW + warp] = v[n];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float s = warp_sum(lane < NW ? sh[n * NW + lane] : 0.0);
      if (lane == 0) sh[N * NW + n] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = sh[N * NW + n];
  __syncthreads();  // sh is written again by the next call
}

__device__ __forceinline__ float sdiv(float a, float b) {
  return fabsf(b) > FLT_MIN ? a / b : 0.f;
}

// The correction solves below take the solve operator as
// ``A(std::bool_constant<scaled>, v, q)``: row q of A_solve v, or of
// A_solve (dv * v) when scaled.  They run over the rank's n folded cells
// with step sizes shared by the whole rank (one polynomial per rank).

// ninner iterations of Jacobi-preconditioned CG on A_solve z = r from z = 0,
// by a block of NT threads.  On entry p = dv * r, zz = 0 and rho = <r, p>;
// r is overwritten; the correction is left in zz.  The vectors may lie in
// shared or in device memory.
template <int NT, class Op>
__device__ void jacobi_pcg(Op&& A, int n, int ninner, float rho, float* r,
                           float* p, float* zz, float* ap,
                           const float* __restrict__ dv, double* red) {
  const int tid = threadIdx.x;
  for (int it = 0; it < ninner; ++it) {
    double pap[1] = {0.0};
    for (int q = tid; q < n; q += NT) {
      const float v = A(std::false_type{}, p, q);
      ap[q] = v;
      pap[0] += (double)(p[q] * v);
    }
    block_sum<NT>(pap, red);
    const float pa = (float)pap[0];
    const float alpha = pa > 0.f ? rho / fmaxf(pa, FLT_MIN) : 0.f;
    double rho_n[1] = {0.0};
    for (int q = tid; q < n; q += NT) {
      zz[q] = zz[q] + alpha * p[q];
      const float rq = r[q] - alpha * ap[q];
      r[q] = rq;
      rho_n[0] += (double)(rq * (dv[q] * rq));
    }
    block_sum<NT>(rho_n, red);
    const float rn_ = (float)rho_n[0];
    const float beta = rho > 0.f ? rn_ / fmaxf(rho, FLT_MIN) : 0.f;
    for (int q = tid; q < n; q += NT) p[q] = dv[q] * r[q] + beta * p[q];
    __syncthreads();  // the next product reads neighbours' p
    rho = rn_;
  }
}

// ninner iterations of right-Jacobi-preconditioned BiCGStab on
// A_solve z = r from z = 0, by a block of NT threads.  On entry
// zz = p = v = 0, rr = r and rho_n = <r, r>; the correction is left in zz.
template <int NT, class Op>
__device__ void jacobi_bicgstab(Op&& A, int n, int ninner, float rho_n,
                                const float* r, float* zz, float* rr,
                                float* p, float* v, float* s, float* tv,
                                const float* __restrict__ dv, double* red) {
  const int tid = threadIdx.x;
  float rho = 1.f, alpha = 1.f, omega = 1.f;
  for (int it = 0; it < ninner; ++it) {
    const float beta = sdiv(rho_n * alpha, rho * omega);
    for (int q = tid; q < n; q += NT)
      p[q] = rr[q] + beta * (p[q] - omega * v[q]);
    __syncthreads();
    double rv[1] = {0.0};
    for (int q = tid; q < n; q += NT) {
      const float vq = A(std::true_type{}, p, q);
      v[q] = vq;
      rv[0] += (double)(r[q] * vq);
    }
    block_sum<NT>(rv, red);
    alpha = sdiv(rho_n, (float)rv[0]);
    for (int q = tid; q < n; q += NT) s[q] = rr[q] - alpha * v[q];
    __syncthreads();
    double ts[2] = {0.0, 0.0};
    for (int q = tid; q < n; q += NT) {
      const float tq = A(std::true_type{}, s, q);
      tv[q] = tq;
      ts[0] += (double)(tq * s[q]);
      ts[1] += (double)(tq * tq);
    }
    block_sum<NT>(ts, red);
    omega = sdiv((float)ts[0], (float)ts[1]);
    double rn_next[1] = {0.0};
    for (int q = tid; q < n; q += NT) {
      zz[q] = zz[q] + alpha * (dv[q] * p[q]) + omega * (dv[q] * s[q]);
      const float rq = s[q] - omega * tv[q];
      rr[q] = rq;
      rn_next[0] += (double)(r[q] * rq);
    }
    block_sum<NT>(rn_next, red);
    rho = rho_n;
    rho_n = (float)rn_next[0];
  }
}

// ---- a rank on a thread-block cluster -------------------------------------

// One block of a cluster (of at most 8 blocks of NT threads) owns rows
// [q0, q1) of the rank's vectors; the cluster's blocks together own all of
// them.  A reduction sums the block's float32 products in float64 into a
// partial in its shared memory; after one cluster barrier warp 0 of every block reads the C partials through
// distributed shared memory (lane c block c's) and adds them in the order
// 0..C-1, so every block of the rank holds the same bits, rounded to
// float32 as block_sum rounds them; the block then reads the totals from
// its own shared memory (``sh`` holds kSumScratch doubles).
// The partial slots alternate between two buffers, so that a block may
// write the next reduction's partial while another still reads this one's:
// one cluster barrier per reduction.  ``sync`` is the cluster's barrier: a
// block reads other blocks' rows of a vector in global memory only after
// it, and with __ldcg (L1 is not coherent across SMs).
constexpr int kMaxSum = 2;  // terms of one reduction
constexpr int kSumScratch = kMaxSum * kWarps + kMaxSum;  // doubles of ``sh``

template <int NT>
struct ClusterTeamT {
  int q0, q1;
  double* part;  // this block's (2, kMaxSum) partial slots, in shared memory
  int buf;
  template <int N>
  __device__ __forceinline__ void sum(double (&v)[N], double* sh) {
    static_assert(N <= kMaxSum, "kMaxSum terms at most");
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] = warp_sum(v[n]);
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) sh[n * kWarps + warp] = v[n];
    }
    __syncthreads();
    double* mine = part + buf * kMaxSum;
    if (warp == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const double s = warp_sum(lane < NT / 32 ? sh[n * kWarps + lane]
                                                 : 0.0);
        if (lane == 0) mine[n] = s;
      }
    }
    cl.sync();
    const int C = (int)cl.num_blocks();
    // warp 0 reads the C partials, lane c block c's, and adds them in block
    // order; the block reads the totals from its own shared memory
    double* tot = sh + kMaxSum * kWarps;
    if (warp == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const double pc = lane < C ? cl.map_shared_rank(mine, lane)[n] : 0.0;
        double t = 0.0;
        for (int c = 0; c < C; ++c) t += __shfl_sync(0xffffffffu, pc, c);
        if (lane == 0) tot[n] = (float)t;
      }
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] = tot[n];
    buf ^= 1;
  }
  __device__ __forceinline__ void sync() {
    cooperative_groups::this_cluster().sync();
  }
};
using ClusterTeam = ClusterTeamT<kThreads>;

// Rows a thread keeps in flight: a rank's loops are bound by the latency of
// their loads (one block streams a chunk of rows through one SM), so in a
// pointwise loop each thread issues the loads of kRowsInFlight rows before
// it uses any.  A row of a product already has 2K + 2 loads in flight; more
// rows there only add spills (a thread of a 1024-thread block has 64
// registers), and measured slower on the card.
constexpr int kRowsInFlight = 4;
constexpr int kProductRowsInFlight = 1;

template <int N>
struct Vals {
  float v[N];
};

// For each of this thread's rows of [q0, q1): store(q, load(q)),
// kRowsInFlight rows at a time, every load before the first store.  ``load``
// only reads; the rows' order, and so each thread's order of summation, is
// the plain loop's.
template <int U = kRowsInFlight, int NT, class Load, class Store>
__device__ __forceinline__ void for_rows(const ClusterTeamT<NT>& team,
                                         Load&& load, Store&& store) {
  for (int q = team.q0 + (int)threadIdx.x; q < team.q1; q += U * NT) {
    decltype(load(q)) v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (q + u * NT < team.q1) v[u] = load(q + u * NT);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (q + u * NT < team.q1) store(q + u * NT, v[u]);
  }
}

// jacobi_pcg over the team's rows.
template <class Team, class Op>
__device__ void cluster_pcg(Team& team, Op&& A, int ninner, float rho,
                            float* r, float* p, float* zz, float* ap,
                            const float* __restrict__ dv, double* red) {
  for (int it = 0; it < ninner; ++it) {
    double pap[1] = {0.0};
    for_rows<kProductRowsInFlight>(
        team,
        [&](int q) { return Vals<2>{{A(std::false_type{}, p, q), p[q]}}; },
        [&](int q, Vals<2> l) {
          ap[q] = l.v[0];
          pap[0] += (double)(l.v[1] * l.v[0]);
        });
    team.sum(pap, red);
    const float pa = (float)pap[0];
    const float alpha = pa > 0.f ? rho / fmaxf(pa, FLT_MIN) : 0.f;
    double rho_n[1] = {0.0};
    for_rows(
        team,
        [&](int q) { return Vals<5>{{zz[q], p[q], r[q], ap[q], dv[q]}}; },
        [&](int q, Vals<5> l) {
          zz[q] = l.v[0] + alpha * l.v[1];
          const float rq = l.v[2] - alpha * l.v[3];
          r[q] = rq;
          rho_n[0] += (double)(rq * (l.v[4] * rq));
        });
    team.sum(rho_n, red);
    const float rn_ = (float)rho_n[0];
    const float beta = rho > 0.f ? rn_ / fmaxf(rho, FLT_MIN) : 0.f;
    for_rows(
        team, [&](int q) { return Vals<3>{{dv[q], r[q], p[q]}}; },
        [&](int q, Vals<3> l) { p[q] = l.v[0] * l.v[1] + beta * l.v[2]; });
    team.sync();  // the next product reads neighbours' p
    rho = rn_;
  }
}

// jacobi_bicgstab over the team's rows.
template <class Team, class Op>
__device__ void cluster_bicgstab(Team& team, Op&& A, int ninner,
                                 float rho_n, const float* r, float* zz,
                                 float* rr, float* p, float* v, float* s,
                                 float* tv, const float* __restrict__ dv,
                                 double* red) {
  float rho = 1.f, alpha = 1.f, omega = 1.f;
  for (int it = 0; it < ninner; ++it) {
    const float beta = sdiv(rho_n * alpha, rho * omega);
    for_rows(
        team, [&](int q) { return Vals<3>{{rr[q], p[q], v[q]}}; },
        [&](int q, Vals<3> l) {
          p[q] = l.v[0] + beta * (l.v[1] - omega * l.v[2]);
        });
    team.sync();
    double rv[1] = {0.0};
    for_rows<kProductRowsInFlight>(
        team,
        [&](int q) { return Vals<2>{{A(std::true_type{}, p, q), r[q]}}; },
        [&](int q, Vals<2> l) {
          v[q] = l.v[0];
          rv[0] += (double)(l.v[1] * l.v[0]);
        });
    team.sum(rv, red);
    alpha = sdiv(rho_n, (float)rv[0]);
    for_rows(
        team, [&](int q) { return Vals<2>{{rr[q], v[q]}}; },
        [&](int q, Vals<2> l) { s[q] = l.v[0] - alpha * l.v[1]; });
    team.sync();
    double ts[2] = {0.0, 0.0};
    for_rows<kProductRowsInFlight>(
        team,
        [&](int q) { return Vals<2>{{A(std::true_type{}, s, q), s[q]}}; },
        [&](int q, Vals<2> l) {
          tv[q] = l.v[0];
          ts[0] += (double)(l.v[0] * l.v[1]);
          ts[1] += (double)(l.v[0] * l.v[0]);
        });
    team.sum(ts, red);
    omega = sdiv((float)ts[0], (float)ts[1]);
    double rn_next[1] = {0.0};
    for_rows(
        team,
        [&](int q) {
          return Vals<6>{{zz[q], dv[q], p[q], s[q], tv[q], r[q]}};
        },
        [&](int q, Vals<6> l) {
          zz[q] = l.v[0] + alpha * (l.v[1] * l.v[2]) +
                  omega * (l.v[1] * l.v[3]);
          const float rq = l.v[3] - omega * l.v[4];
          rr[q] = rq;
          rn_next[0] += (double)(l.v[5] * rq);
        });
    team.sum(rn_next, red);
    rho = rho_n;
    rho_n = (float)rn_next[0];
  }
}

constexpr int kMaxGmres = 64;

// Shared-memory scratch of one GMRES(m) cycle: the Hessenberg matrix, the
// Givens rotations, the rotated right-hand side and the small solution.
struct GmresScratch {
  float H[(kMaxGmres + 1) * kMaxGmres];
  float g[kMaxGmres + 1], cs[kMaxGmres], sn[kMaxGmres], yv[kMaxGmres];
};

// One GMRES(m) cycle (one Arnoldi pass, modified Gram-Schmidt, Givens
// rotations) with right Jacobi preconditioning on A_solve z = r from z = 0,
// over the team's rows.  ``V(i)`` is the i-th of the m + 1 basis vectors,
// ``rr2`` = <r, r>; the correction dv * (V y) is left in zz.  Every block of
// the cluster solves the same small problem from the same sums.
template <class Op, class Basis>
__device__ void cluster_gmres(ClusterTeam& team, Op&& A, Basis&& V, int m,
                              float rr2, const float* r, float* zz,
                              const float* __restrict__ dv, GmresScratch& G,
                              double* red) {
  const int tid = threadIdx.x;
  const float beta = sqrtf(rr2);
  const float inv = sdiv(1.f, beta);
  float* v0 = V(0);
  for_rows(
      team, [&](int q) { return r[q]; },
      [&](int q, float rq) { v0[q] = rq * inv; });
  if (tid == 0) {
    G.g[0] = beta;
    for (int i = 1; i <= m; ++i) G.g[i] = 0.f;
  }
  team.sync();  // the first product reads neighbours' V_0
  for (int jj = 0; jj < m; ++jj) {
    float* w = V(jj + 1);
    const float* vj = V(jj);
    double h[1] = {0.0};
    for_rows<kProductRowsInFlight>(
        team,
        [&](int q) { return Vals<2>{{A(std::true_type{}, vj, q), v0[q]}}; },
        [&](int q, Vals<2> l) {
          w[q] = l.v[0];
          h[0] += (double)(l.v[0] * l.v[1]);
        });
    team.sum(h, red);
    // modified Gram-Schmidt: w -= h_i V_i, each h from the updated w
    for (int i = 0; i <= jj; ++i) {
      const float hi = (float)h[0];
      if (tid == 0) G.H[i * kMaxGmres + jj] = hi;
      const float* vi = V(i);
      const float* vn = i < jj ? V(i + 1) : nullptr;
      double nx[1] = {0.0};
      for_rows(
          team,
          [&](int q) {
            return Vals<3>{{w[q], vi[q], vn != nullptr ? vn[q] : 0.f}};
          },
          [&](int q, Vals<3> l) {
            const float wq = l.v[0] - hi * l.v[1];
            w[q] = wq;
            nx[0] += (double)(wq * (vn != nullptr ? l.v[2] : wq));
          });
      team.sum(nx, red);
      h[0] = nx[0];
    }
    const float hn = sqrtf((float)h[0]);
    const float winv = sdiv(1.f, hn);
    for_rows(
        team, [&](int q) { return w[q]; },
        [&](int q, float wq) { w[q] = wq * winv; });
    if (tid == 0) {
      float* H = G.H;
      H[(jj + 1) * kMaxGmres + jj] = hn;
      for (int i = 0; i < jj; ++i) {
        const float hij = H[i * kMaxGmres + jj];
        const float hi1 = H[(i + 1) * kMaxGmres + jj];
        H[(i + 1) * kMaxGmres + jj] = -G.sn[i] * hij + G.cs[i] * hi1;
        H[i * kMaxGmres + jj] = G.cs[i] * hij + G.sn[i] * hi1;
      }
      const float hjj = H[jj * kMaxGmres + jj];
      const float hj1 = H[(jj + 1) * kMaxGmres + jj];
      const float dn = sqrtf(hjj * hjj + hj1 * hj1);
      const float c = sdiv(hjj, dn), s_ = sdiv(hj1, dn);
      G.cs[jj] = c;
      G.sn[jj] = s_;
      H[jj * kMaxGmres + jj] = c * hjj + s_ * hj1;
      G.g[jj + 1] = -s_ * G.g[jj];
      G.g[jj] = c * G.g[jj];
    }
    team.sync();  // the next product reads neighbours' V_{jj+1}
  }
  if (tid == 0) {
    for (int i = m - 1; i >= 0; --i) {
      float acc_i = G.g[i];
      for (int k2 = i + 1; k2 < m; ++k2)
        acc_i = acc_i - G.H[i * kMaxGmres + k2] * G.yv[k2];
      G.yv[i] = sdiv(acc_i, G.H[i * kMaxGmres + i]);
    }
  }
  __syncthreads();  // yv is the block's; the rows below are its own
  for_rows(
      team,
      [&](int q) {
        float u = G.yv[0] * v0[q];
        for (int i = 1; i < m; ++i) u = u + G.yv[i] * V(i)[q];
        return Vals<2>{{u, dv[q]}};
      },
      [&](int q, Vals<2> l) { zz[q] = l.v[1] * l.v[0]; });
}
