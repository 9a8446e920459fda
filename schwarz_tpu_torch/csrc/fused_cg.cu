// K3: the whole batched (Jacobi-)preconditioned CG of the local solves in
// one launch, on a pure-DIA operator.
//
// Replaces schwarz_tpu/ops/fused_cg.py fused_cg_solve, with the same update,
// masking and stopping rules: Combined(Iteration, ResidualNormReduction),
// warm start from x0, the pap > 0 / rho > 0 guards with eps = FLT_MIN, and a
// subdomain whose initial residual is zero never iterates.
//
// One block per subdomain runs that subdomain's whole loop.  This is exact:
// in the TPU kernel a subdomain that has stopped keeps its x, r, p and
// scalars (its step is act * alpha = 0), so a block that stops when its own
// subdomain stops gives the same x, iteration count and residual ratio, and
// no synchronisation across blocks is needed.  Shifted reads are
// bounds-checked (zero outside [0, R)) where the TPU kernel wraps modulo R and
// relies on zero band entries; both give the same products.
//
// Vectors live in device memory (x, and the r, p, ap work arrays the wrapper
// allocates); at the 1M-row slice one subdomain's state is a few MB and
// stays mostly in L2.  Dot products are block reductions in float32.
//
// Bound on the card: the bytes read once (dia, b, x0, dinv) and written once
// (x) and the flops of the iterations run are of the same order at the
// slice's shapes.  With one block per subdomain only S of the 132 SMs work,
// each streaming its vectors from L2 every iteration, so this first version
// is far from that bound by design; a cooperative or cluster version that
// spreads a subdomain over many SMs is later work.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sums a and b over the block; every thread gets both totals.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sh[warp] = a;
    sh[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? sh[lane] : 0.f;
    b = lane < kThreads / 32 ? sh[32 + lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      sh[64] = a;
      sh[65] = b;
    }
  }
  __syncthreads();
  a = sh[64];
  b = sh[65];
  __syncthreads();  // sh is written again by the next call
}

template <int KC>
__global__ void __launch_bounds__(kThreads)
fused_cg_kernel(const float* __restrict__ dia, const float* __restrict__ b,
                const float* __restrict__ x0, const float* __restrict__ dinv,
                float* x, float* r, float* p, float* ap,
                int* __restrict__ iters_out, float* __restrict__ rel_out,
                int K, int R, Offsets offs, float tol2, int maxit) {
  __shared__ float sh[66];
  const long long base = (long long)blockIdx.x * R;
  const float* d = dia + base * K;
  b += base;
  x0 += base;
  x += base;
  r += base;
  p += base;
  ap += base;
  if (dinv != nullptr) dinv += base;

  // r0 = b - A x0, z0 = M r0, p0 = z0
  float rho = 0.f, rn0 = 0.f;
  for (long long i = threadIdx.x; i < R; i += kThreads) {
    const float ri = b[i] - dia_row<KC>(d, x0, i, K, R, offs);
    const float zi = dinv != nullptr ? dinv[i] * ri : ri;
    x[i] = x0[i];
    r[i] = ri;
    p[i] = zi;
    rho += ri * zi;
    rn0 += ri * ri;
  }
  block_sum2(rho, rn0, sh);
  const float tol2rn0 = tol2 * rn0;
  bool active = rn0 > fmaxf(tol2rn0, 0.f) && rn0 > 0.f;
  float rn = rn0;
  int it = 0;
  while (active && it < maxit) {
    float pap = 0.f, unused = 0.f;
    for (long long i = threadIdx.x; i < R; i += kThreads) {
      const float a = dia_row<KC>(d, p, i, K, R, offs);
      ap[i] = a;
      pap += p[i] * a;
    }
    block_sum2(pap, unused, sh);
    const float alpha = pap > 0.f ? rho / fmaxf(pap, FLT_MIN) : 0.f;
    float rho_new = 0.f, rn_new = 0.f;
    for (long long i = threadIdx.x; i < R; i += kThreads) {
      x[i] += alpha * p[i];
      const float ri = r[i] - alpha * ap[i];
      const float zi = dinv != nullptr ? dinv[i] * ri : ri;
      r[i] = ri;
      rho_new += ri * zi;
      rn_new += ri * ri;
    }
    block_sum2(rho_new, rn_new, sh);
    const float beta = rho > 0.f ? rho_new / fmaxf(rho, FLT_MIN) : 0.f;
    for (long long i = threadIdx.x; i < R; i += kThreads) {
      const float zi = dinv != nullptr ? dinv[i] * r[i] : r[i];
      p[i] = zi + beta * p[i];
    }
    __syncthreads();  // the next product reads neighbours' p
    rn = rn_new;
    rho = rho_new;
    ++it;
    active = rn > tol2rn0;
  }
  if (threadIdx.x == 0) {
    iters_out[blockIdx.x] = it;
    rel_out[blockIdx.x] = sqrtf(rn / (rn0 > 0.f ? rn0 : 1.f));
  }
}

}  // namespace

extern "C" {

// dia (S, K, R); b, x0, dinv (may be null), x, r, p, ap (S, R); iters and
// rel (S,).  All contiguous float32/int32 on the device.
int fused_cg_f32(const float* dia, const float* b, const float* x0,
                 const float* dinv, float* x, float* r, float* p, float* ap,
                 int* iters, float* rel, int S, int K, int R,
                 const int* offs, float tol2, int maxit, void* stream) {
  if (K < 1 || K > kMaxDiags) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  const Offsets o = make_offsets(offs, K);
  return dispatch_diags(K, [&](auto kc) {
    fused_cg_kernel<decltype(kc)::value>
        <<<S, kThreads, 0, (cudaStream_t)stream>>>(
            dia, b, x0, dinv, x, r, p, ap, iters, rel, K, R, o, tol2, maxit);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
