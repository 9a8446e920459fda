// Device code shared by the free-running kernels (async_ras.cu, the 1-D
// banded tier, and async_ras_2d.cu, the 2-D block-grid tier): the
// release/acquire handoff between ranks, the watchdog spin, the float64
// block reduction and the two correction solves that take any operator.
#pragma once

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
// ``sh`` holds N * kWarps + N doubles.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N], double* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = warp_sum(v[n]);
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) sh[n * kWarps + warp] = v[n];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float s = warp_sum(sh[n * kWarps + lane]);
      if (lane == 0) sh[N * kWarps + n] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = sh[N * kWarps + n];
  __syncthreads();  // sh is written again by the next call
}

__device__ __forceinline__ float sdiv(float a, float b) {
  return fabsf(b) > FLT_MIN ? a / b : 0.f;
}

// The correction solves below take the solve operator as
// ``A(std::bool_constant<scaled>, v, q)``: row q of A_solve v, or of
// A_solve (dv * v) when scaled.  They run over the rank's n folded cells
// with step sizes shared by the whole rank (one polynomial per rank).

// ninner iterations of Jacobi-preconditioned CG on A_solve z = r from z = 0.
// On entry p = dv * r, zz = 0 and rho = <r, p>; r is overwritten; the
// correction is left in zz.
template <class Op>
__device__ void jacobi_pcg(Op&& A, int n, int ninner, float rho, float* r,
                           float* p, float* zz, float* ap,
                           const float* __restrict__ dv, double* red) {
  const int tid = threadIdx.x;
  for (int it = 0; it < ninner; ++it) {
    double pap[1] = {0.0};
    for (int q = tid; q < n; q += kThreads) {
      const float v = A(std::false_type{}, p, q);
      ap[q] = v;
      pap[0] += (double)(p[q] * v);
    }
    block_sum(pap, red);
    const float pa = (float)pap[0];
    const float alpha = pa > 0.f ? rho / fmaxf(pa, FLT_MIN) : 0.f;
    double rho_n[1] = {0.0};
    for (int q = tid; q < n; q += kThreads) {
      zz[q] = zz[q] + alpha * p[q];
      const float rq = r[q] - alpha * ap[q];
      r[q] = rq;
      rho_n[0] += (double)(rq * (dv[q] * rq));
    }
    block_sum(rho_n, red);
    const float rn_ = (float)rho_n[0];
    const float beta = rho > 0.f ? rn_ / fmaxf(rho, FLT_MIN) : 0.f;
    for (int q = tid; q < n; q += kThreads) p[q] = dv[q] * r[q] + beta * p[q];
    __syncthreads();  // the next product reads neighbours' p
    rho = rn_;
  }
}

// ninner iterations of right-Jacobi-preconditioned BiCGStab on
// A_solve z = r from z = 0.  On entry zz = p = v = 0, rr = r and
// rho_n = <r, r>; the correction is left in zz.
template <class Op>
__device__ void jacobi_bicgstab(Op&& A, int n, int ninner, float rho_n,
                                const float* r, float* zz, float* rr,
                                float* p, float* v, float* s, float* tv,
                                const float* __restrict__ dv, double* red) {
  const int tid = threadIdx.x;
  float rho = 1.f, alpha = 1.f, omega = 1.f;
  for (int it = 0; it < ninner; ++it) {
    const float beta = sdiv(rho_n * alpha, rho * omega);
    for (int q = tid; q < n; q += kThreads)
      p[q] = rr[q] + beta * (p[q] - omega * v[q]);
    __syncthreads();
    double rv[1] = {0.0};
    for (int q = tid; q < n; q += kThreads) {
      const float vq = A(std::true_type{}, p, q);
      v[q] = vq;
      rv[0] += (double)(r[q] * vq);
    }
    block_sum(rv, red);
    alpha = sdiv(rho_n, (float)rv[0]);
    for (int q = tid; q < n; q += kThreads) s[q] = rr[q] - alpha * v[q];
    __syncthreads();
    double ts[2] = {0.0, 0.0};
    for (int q = tid; q < n; q += kThreads) {
      const float tq = A(std::true_type{}, s, q);
      tv[q] = tq;
      ts[0] += (double)(tq * s[q]);
      ts[1] += (double)(tq * tq);
    }
    block_sum(ts, red);
    omega = sdiv((float)ts[0], (float)ts[1]);
    double rn_next[1] = {0.0};
    for (int q = tid; q < n; q += kThreads) {
      zz[q] = zz[q] + alpha * (dv[q] * p[q]) + omega * (dv[q] * s[q]);
      const float rq = s[q] - omega * tv[q];
      rr[q] = rq;
      rn_next[0] += (double)(r[q] * rq);
    }
    block_sum(rn_next, red);
    rho = rho_n;
    rho_n = (float)rn_next[0];
  }
}
