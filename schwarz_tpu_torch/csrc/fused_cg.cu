// K3: the whole batched (Jacobi-)preconditioned CG of the local solves in
// one launch, on a pure-DIA operator.
//
// Replaces schwarz_tpu/ops/fused_cg.py fused_cg_solve (:84), with the same
// update, masking and stopping rules: Combined(Iteration,
// ResidualNormReduction), warm start from x0, the pap > 0 / rho > 0 guards
// with eps = FLT_MIN, and a subdomain whose initial residual is zero never
// iterates.
//
// Layout.  A subdomain is a thread-block cluster of C blocks of 1024
// threads on C SMs; the wrapper takes the largest C (8 down to 1) for which
// the card holds all S clusters at once, so the subdomains run in one wave.
// Subdomains never wait on each other, so the launch is not cooperative.
// This is exact: in the TPU kernel a subdomain that has stopped keeps its
// x, r, p and scalars (its step is act * alpha = 0), so a cluster that
// stops when its own subdomain stops gives the same x, iteration count and
// residual ratio.  Block c owns rows [c*chunk, (c+1)*chunk) of the
// subdomain.  In the shared-memory variant (kShared) it keeps its chunk of
// x, r, p, A p and, when there is room, dinv in its shared memory for the
// whole solve: x0, b and dinv are read once, x written once.  The product
// reads the rows of p that other blocks own (any DIA offset) through
// distributed shared memory, after the cluster barrier that ends the p
// update.  (Copying those rows into a halo buffer first, all loads in
// flight, measured slower on the card.)  When a chunk does not fit, the
// global-memory variant keeps the vectors in device memory and reads other
// blocks' rows of p with __ldcg after the same barrier.  The K
// diagonals stream from L2 (23 MB over the 1M-row slice) with several loads
// in flight (for_rows in async_common.cuh).  Shifted reads are
// bounds-checked (zero outside [0, R)) where the TPU kernel wraps modulo R
// and relies on zero band entries; both give the same products.
//
// Sums.  A reduction is a float64 partial of float32 products per block,
// added over the cluster in block order through distributed shared memory
// and rounded to float32 once (ClusterTeam::sum): one cluster barrier per
// reduction, and every block holds the same alpha, beta, rho and ||r||^2,
// so the cluster stops together.  Three cluster barriers per iteration.
//
// Bound on the card: the bytes read once (dia, b, x0, dinv) and written once
// (x), against the flops of the iterations run; at the slice's shapes the
// operations bound it.  The first version ran a subdomain on one block (16
// of 132 SMs at the slice), streaming x, r, p, A p and dinv from L2 three
// times per iteration; a cluster spreads the subdomain over C SMs and keeps
// those vectors in shared memory.
#include "async_common.cuh"
#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

struct Args {
  const float* dia;   // (S, K, R)
  const float* b;     // (S, R), as x0, dinv (may be null) and x
  const float* x0;
  const float* dinv;
  float* x;
  float* r;   // (S, R) work vectors of the global-memory variant
  float* p;
  float* ap;
  int* iters;  // (S,)
  float* rel;
  int K, R, C, chunk, maxit, dv_shared;
  Offsets offs;
  float tol2;
};

template <int KC, bool kShared>
__global__ void __launch_bounds__(kThreads, 1) fused_cg_kernel(const Args a) {
  extern __shared__ float sv[];  // kShared: x, r, p, ap[, dinv] chunks
  __shared__ double red[kSumScratch];
  __shared__ double part[2 * kMaxSum];

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int crank = (int)cluster.block_rank();
  const int s = blockIdx.x / a.C;
  const int R = a.R, K = a.K, chunk = a.chunk;
  ClusterTeam team{min(R, crank * chunk), min(R, (crank + 1) * chunk), part,
                   0};
  const int q0 = team.q0, q1 = team.q1;
  const long long base = (long long)s * R;
  const float* d = a.dia + base * K;
  const float* b = a.b + base;
  const float* x0 = a.x0 + base;
  const float* dg = a.dinv != nullptr ? a.dinv + base : nullptr;
  const bool jac = dg != nullptr;
  // the block's rows of each vector, indexed by the subdomain's row
  float *x, *r, *p, *ap, *dv;
  if (kShared) {
    x = sv - q0;
    r = sv + chunk - q0;
    p = sv + 2 * chunk - q0;
    ap = sv + 3 * chunk - q0;
    // dinv too when the launch gave room for it, else from device memory
    dv = a.dv_shared ? sv + 4 * chunk - q0 : const_cast<float*>(dg);
  } else {
    x = a.x + base;
    r = a.r + base;
    p = a.p + base;
    ap = a.ap + base;
    dv = const_cast<float*>(dg);
  }
  // p at a row another block owns (0 <= c < R)
  auto remote_p = [&](int c) -> float {
    if constexpr (kShared) {
      const int o = c / chunk;
      return *cluster.map_shared_rank(sv + 2 * chunk + (c - o * chunk), o);
    }
    return __ldcg(p + c);
  };
  // row i of A p
  auto prod = [&](int i) {
    const int nk = KC > 0 ? KC : K;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < nk; ++k) {
      const int c = i + a.offs.v[k];
      float xv;
      if (c >= q0 && c < q1) xv = p[c];
      else if (c < 0 || c >= R) xv = 0.f;
      else xv = remote_p(c);
      acc += __ldg(d + (long long)k * R + i) * xv;
    }
    return acc;
  };

  // r0 = b - A x0, z0 = M r0, p0 = z0
  double s0[2] = {0.0, 0.0};
  for_rows<kProductRowsInFlight>(
      team,
      [&](int i) {
        return Vals<3>{{b[i] - dia_row<KC>(d, x0, i, K, R, a.offs), x0[i],
                        jac ? dg[i] : 1.f}};
      },
      [&](int i, Vals<3> l) {
        const float ri = l.v[0];
        const float zi = jac ? l.v[2] * ri : ri;
        x[i] = l.v[1];
        r[i] = ri;
        p[i] = zi;
        if (kShared && jac && a.dv_shared) dv[i] = l.v[2];
        s0[0] += (double)(ri * zi);
        s0[1] += (double)(ri * ri);
      });
  team.sum(s0, red);  // its barrier also publishes p0 to the cluster
  float rho = (float)s0[0];
  const float rn0 = (float)s0[1];
  const float tol2rn0 = a.tol2 * rn0;
  bool active = rn0 > fmaxf(tol2rn0, 0.f) && rn0 > 0.f;
  float rn = rn0;
  int it = 0;
  while (active && it < a.maxit) {
    double pap[1] = {0.0};
    for_rows<kProductRowsInFlight>(
        team, [&](int i) { return Vals<2>{{prod(i), p[i]}}; },
        [&](int i, Vals<2> l) {
          ap[i] = l.v[0];
          pap[0] += (double)(l.v[1] * l.v[0]);
        });
    team.sum(pap, red);
    const float pa = (float)pap[0];
    const float alpha = pa > 0.f ? rho / fmaxf(pa, FLT_MIN) : 0.f;
    double nx[2] = {0.0, 0.0};
    for_rows(
        team,
        [&](int i) {
          return Vals<5>{{x[i], p[i], r[i], ap[i], jac ? dv[i] : 1.f}};
        },
        [&](int i, Vals<5> l) {
          x[i] = l.v[0] + alpha * l.v[1];
          const float ri = l.v[2] - alpha * l.v[3];
          const float zi = jac ? l.v[4] * ri : ri;
          r[i] = ri;
          nx[0] += (double)(ri * zi);
          nx[1] += (double)(ri * ri);
        });
    team.sum(nx, red);
    const float rho_new = (float)nx[0];
    const float beta = rho > 0.f ? rho_new / fmaxf(rho, FLT_MIN) : 0.f;
    for_rows(
        team,
        [&](int i) { return Vals<3>{{r[i], jac ? dv[i] : 1.f, p[i]}}; },
        [&](int i, Vals<3> l) {
          const float zi = jac ? l.v[1] * l.v[0] : l.v[0];
          p[i] = zi + beta * l.v[2];
        });
    team.sync();  // the next product reads other blocks' p
    rn = (float)nx[1];
    rho = rho_new;
    ++it;
    active = rn > tol2rn0;
  }
  if (kShared)
    for (int i = q0 + tid; i < q1; i += kThreads) a.x[base + i] = x[i];
  if (crank == 0 && tid == 0) {
    a.iters[s] = it;
    a.rel[s] = sqrtf(rn / (rn0 > 0.f ? rn0 : 1.f));
  }
  cluster.sync();  // no block leaves while another may read its shared data
}

// S subdomains of C blocks: a launch of S clusters of C blocks.
cudaLaunchConfig_t launch_config(int S, int C, int smem,
                                 cudaLaunchAttribute* at,
                                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// Calls f(kernel) for the instance of K diagonals and the variant (shared
// memory when smem > 0), after allowing it smem bytes of shared memory.
template <class F>
int with_kernel(int K, int smem, F&& f) {
  return dispatch_diags(K, [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    if (smem > 0) {
      auto* fn = &fused_cg_kernel<KC, true>;
      const cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      return e != cudaSuccess ? (int)e : f(fn);
    }
    return f(&fused_cg_kernel<KC, false>);
  });
}

}  // namespace

extern "C" {

// Clusters of C blocks with smem bytes of dynamic shared memory each (0:
// the global-memory variant) that the card holds at once; 0 when it cannot
// hold one, or without cluster launch support.
int fused_cg_max_clusters(int K, int C, int smem) {
  int dev = 0, clus = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&clus, cudaDevAttrClusterLaunch, dev);
  if (!clus || C < 1 || C > 8 || smem < 0) return 0;
  int n = 0;
  const int e = with_kernel(K, smem, [&](auto fn) {
    cudaLaunchAttribute at[1];
    cudaLaunchConfig_t cfg = launch_config(1, C, smem, at, 0);
    return (int)cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  });
  if (e != 0) cudaGetLastError();  // a refused size is not a launch error
  return e == 0 ? n : 0;
}

// dia (S, K, R); b, x0, dinv (may be null), x (S, R); r, p, ap (S, R) work
// vectors of the global-memory variant (may be null with smem > 0); iters
// and rel (S,).  All contiguous float32/int32 on the device.  C: blocks per
// subdomain; chunk: rows per block; smem: dynamic shared memory of a block,
// 0 for the global-memory variant.
int fused_cg_f32(const float* dia, const float* b, const float* x0,
                 const float* dinv, float* x, float* r, float* p, float* ap,
                 int* iters, float* rel, int S, int K, int R,
                 const int* offs, float tol2, int maxit, int C, int chunk,
                 int smem, void* stream) {
  if (K < 1 || K > kMaxDiags || C < 1 || C > 8 || chunk < 1 ||
      (long long)chunk * C < R || smem < 0 ||
      (smem > 0 && smem < chunk * 4 * 4) ||
      (smem == 0 && (r == nullptr || p == nullptr || ap == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  Args a{};
  a.dia = dia;
  a.b = b;
  a.x0 = x0;
  a.dinv = dinv;
  a.x = x;
  a.r = r;
  a.p = p;
  a.ap = ap;
  a.iters = iters;
  a.rel = rel;
  a.K = K;
  a.R = R;
  a.C = C;
  a.chunk = chunk;
  a.maxit = maxit;
  a.dv_shared = dinv != nullptr && smem >= chunk * 5 * 4;
  a.offs = make_offsets(offs, K);
  a.tol2 = tol2;
  return with_kernel(K, smem, [&](auto fn) {
    cudaLaunchAttribute at[1];
    cudaLaunchConfig_t cfg =
        launch_config(S, C, smem, at, (cudaStream_t)stream);
    return (int)cudaLaunchKernelEx(&cfg, fn, a);
  });
}

}  // extern "C"
