// K3: the whole batched preconditioned CG of the local solves in one
// launch, on a pure-DIA operator: no preconditioner, Jacobi, or FSAI(0)
// (M^-1 = G^T G with both factors banded).
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
// FSAI.  The JAX kernel refuses FSAI; this mode goes beyond it, with the
// rules above.  z = G^T (G r) takes two banded products over the
// subdomain: after the r update, a cluster barrier, w = G r (reading other
// blocks' rows of r), a barrier, z = G^T w (other blocks' rows of w) into
// A p's rows, then one reduction of <r, z> and ||r||^2.  Five cluster
// barriers per iteration.  w is a fifth work vector; when the planes of A,
// G and G^T fit beside the vectors, each block copies its rows of them to
// shared memory once and reads them there at every iteration instead of
// from L2 (at the flagship's 16 x 21504 rows, C = 6: 0.284 against 0.356
// ms a solve of 20 iterations on an H100).
//
// Bound on the card: the bytes read once (dia, b, x0, dinv or FSAI's
// factors) and written once (x), against the flops of the iterations run;
// at the slice's shapes the operations bound it, at the flagship's FSAI
// locals the bytes.  The first version ran a subdomain on one block (16
// of 132 SMs at the slice), streaming x, r, p, A p and dinv from L2 three
// times per iteration; a cluster spreads the subdomain over C SMs and keeps
// those vectors in shared memory.
#include "async_common.cuh"
#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

struct Args {
  const float* dia;   // (S, K, R)
  const float* gl;    // FSAI: G (S, Kg, R) on the lower pattern, else null
  const float* gu;    // FSAI: G^T (S, Ku, R) on the upper pattern
  const float* b;     // (S, R), as x0, dinv (may be null) and x
  const float* x0;
  const float* dinv;
  float* x;
  float* r;   // (S, R) work vectors of the global-memory variant
  float* p;
  float* ap;
  float* w;   // FSAI's G r
  int* iters;  // (S,)
  float* rel;
  int K, Kg, Ku, R, C, chunk, maxit, dv_shared, planes_shared;
  Offsets offs, goffs, uoffs;
  float tol2;
};

// Shared memory of a block of the shared-memory variant, in chunks of its
// rows: x, r, p, A p, then dinv (Jacobi, when there is room) or w (FSAI),
// then (FSAI, when there is room) the K planes of A, the Kg of G and the Ku
// of G^T.
enum Slot { kX = 0, kR = 1, kP = 2, kAp = 3, kW = 4, kPlanes = 5 };

template <int KC, bool kShared, bool kFsai>
__global__ void __launch_bounds__(kThreads, 1) fused_cg_kernel(const Args a) {
  extern __shared__ float sv[];
  __shared__ double red[kSumScratch];
  __shared__ double part[2 * kMaxSum];
  __shared__ int foffs[2 * kMaxDiags];  // FSAI: G's offsets, then G^T's

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
  float *x, *r, *p, *ap, *dv, *w;
  if (kShared) {
    x = sv + kX * chunk - q0;
    r = sv + kR * chunk - q0;
    p = sv + kP * chunk - q0;
    ap = sv + kAp * chunk - q0;
    w = sv + kW * chunk - q0;
    // dinv too when the launch gave room for it, else from device memory
    dv = a.dv_shared ? sv + kW * chunk - q0 : const_cast<float*>(dg);
  } else {
    x = a.x + base;
    r = a.r + base;
    p = a.p + base;
    ap = a.ap + base;
    w = kFsai ? a.w + base : nullptr;
    dv = const_cast<float*>(dg);
  }
  // v at row c of the subdomain, zero outside [0, R): the block's own rows
  // from v, other blocks' through distributed shared memory (slot: v's
  // place in shared memory) or past L1 from device memory
  auto at = [&](const float* v, int slot, int c) -> float {
    if (c >= q0 && c < q1) return v[c];
    if (c < 0 || c >= R) return 0.f;
    if constexpr (kShared) {
      const int o = c / chunk;
      return *cluster.map_shared_rank(sv + slot * chunk + (c - o * chunk), o);
    }
    return __ldcg(v + c);
  };
  // FSAI: plane k of A, G and G^T at row i is band[k * st + i], in shared
  // memory when the launch gave room for them, else in device memory
  const float *bA = d, *bG = nullptr, *bU = nullptr;
  long long st = R;
  if constexpr (kFsai) {
    // the factors' offsets are indexed at run time: from shared memory,
    // not the parameters (read first after the cluster barrier below)
#pragma unroll
    for (int k = 0; k < kMaxDiags; ++k)
      if (tid == k) {
        foffs[k] = a.goffs.v[k];
        foffs[kMaxDiags + k] = a.uoffs.v[k];
      }
    bG = a.gl + base * a.Kg;
    bU = a.gu + base * a.Ku;
    if (kShared && a.planes_shared) {
      float* pl = sv + kPlanes * chunk;
      const int n = q1 - q0;
      for (int k = 0; k < K; ++k)
        for (int i = tid; i < n; i += kThreads)
          pl[k * chunk + i] = __ldg(d + (long long)k * R + q0 + i);
      for (int k = 0; k < a.Kg; ++k)
        for (int i = tid; i < n; i += kThreads)
          pl[(K + k) * chunk + i] = __ldg(bG + (long long)k * R + q0 + i);
      for (int k = 0; k < a.Ku; ++k)
        for (int i = tid; i < n; i += kThreads)
          pl[(K + a.Kg + k) * chunk + i] =
              __ldg(bU + (long long)k * R + q0 + i);
      bA = pl - q0;
      bG = bA + K * chunk;
      bU = bG + a.Kg * chunk;
      st = chunk;
    }
  }
  // row i of A p
  auto prod = [&](int i) {
    const int nk = KC > 0 ? KC : K;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < nk; ++k) {
      const float xv = at(p, kP, i + a.offs.v[k]);
      acc += (kFsai ? bA[k * st + i] : __ldg(d + (long long)k * R + i)) * xv;
    }
    return acc;
  };
  // row i of the product of FSAI's factor (nk planes at band, offsets o)
  // with v
  auto factor_row = [&](const float* band, int nk, const int* o,
                        const float* v, int slot, int i) {
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < nk; ++k)
      acc += band[k * st + i] * at(v, slot, i + o[k]);
    return acc;
  };
  // FSAI: z = G^T (G r) into z's rows, <r, z> added to rz.  Other blocks'
  // r must be published (a cluster barrier) before the call.
  auto fsai_apply = [&](float* z, double& rz) {
    for_rows<kProductRowsInFlight>(
        team,
        [&](int i) {
          return Vals<1>{{factor_row(bG, a.Kg, foffs, r, kR, i)}};
        },
        [&](int i, Vals<1> l) { w[i] = l.v[0]; });
    team.sync();  // G^T w reads other blocks' w
    for_rows<kProductRowsInFlight>(
        team,
        [&](int i) {
          return Vals<2>{{factor_row(bU, a.Ku, foffs + kMaxDiags, w, kW, i),
                          r[i]}};
        },
        [&](int i, Vals<2> l) {
          z[i] = l.v[0];
          rz += (double)(l.v[1] * l.v[0]);
        });
  };

  // r0 = b - A x0, z0 = M r0, p0 = z0
  double s0[2] = {0.0, 0.0};
  if constexpr (kFsai) {
    for_rows<kProductRowsInFlight>(
        team,
        [&](int i) {
          return Vals<2>{{b[i] - dia_row<KC>(d, x0, i, K, R, a.offs), x0[i]}};
        },
        [&](int i, Vals<2> l) {
          x[i] = l.v[1];
          r[i] = l.v[0];
          s0[1] += (double)(l.v[0] * l.v[0]);
        });
    team.sync();  // G r0 reads other blocks' r0 (and the planes are in)
    fsai_apply(p, s0[0]);
  } else {
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
  }
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
    if constexpr (kFsai) {
      for_rows(
          team,
          [&](int i) { return Vals<4>{{x[i], p[i], r[i], ap[i]}}; },
          [&](int i, Vals<4> l) {
            x[i] = l.v[0] + alpha * l.v[1];
            const float ri = l.v[2] - alpha * l.v[3];
            r[i] = ri;
            nx[1] += (double)(ri * ri);
          });
      team.sync();  // G r reads other blocks' r
      fsai_apply(ap, nx[0]);  // z over A p's rows
    } else {
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
    }
    team.sum(nx, red);
    const float rho_new = (float)nx[0];
    const float beta = rho > 0.f ? rho_new / fmaxf(rho, FLT_MIN) : 0.f;
    if constexpr (kFsai) {
      for_rows(
          team, [&](int i) { return Vals<2>{{ap[i], p[i]}}; },
          [&](int i, Vals<2> l) { p[i] = l.v[0] + beta * l.v[1]; });
    } else {
      for_rows(
          team,
          [&](int i) { return Vals<3>{{r[i], jac ? dv[i] : 1.f, p[i]}}; },
          [&](int i, Vals<3> l) {
            const float zi = jac ? l.v[1] * l.v[0] : l.v[0];
            p[i] = zi + beta * l.v[2];
          });
    }
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

// Calls f(kernel) for the instance of K diagonals, the mode (FSAI or not)
// and the variant (shared memory when smem > 0), after allowing it smem
// bytes of shared memory.
template <bool kFsai, class F>
int with_kernel_mode(int K, int smem, F&& f) {
  return dispatch_diags(K, [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    if (smem > 0) {
      auto* fn = &fused_cg_kernel<KC, true, kFsai>;
      const cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      return e != cudaSuccess ? (int)e : f(fn);
    }
    return f(&fused_cg_kernel<KC, false, kFsai>);
  });
}

template <class F>
int with_kernel(int K, int smem, bool fsai, F&& f) {
  return fsai ? with_kernel_mode<true>(K, smem, f)
              : with_kernel_mode<false>(K, smem, f);
}

}  // namespace

extern "C" {

// Clusters of C blocks with smem bytes of dynamic shared memory each (0:
// the global-memory variant) of the mode (fsai != 0: FSAI) that the card
// holds at once; 0 when it cannot hold one, or without cluster launch
// support.
int fused_cg_max_clusters(int K, int C, int smem, int fsai) {
  int dev = 0, clus = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&clus, cudaDevAttrClusterLaunch, dev);
  if (!clus || C < 1 || C > 8 || smem < 0) return 0;
  int n = 0;
  const int e = with_kernel(K, smem, fsai != 0, [&](auto fn) {
    cudaLaunchAttribute at[1];
    cudaLaunchConfig_t cfg = launch_config(1, C, smem, at, 0);
    return (int)cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  });
  if (e != 0) cudaGetLastError();  // a refused size is not a launch error
  return e == 0 ? n : 0;
}

// dia (S, K, R); gl (S, Kg, R) and gu (S, Ku, R) FSAI's G and G^T, or null
// (then dinv may be given); b, x0, dinv, x (S, R); r, p, ap, w (S, R) work
// vectors of the global-memory variant (may be null with smem > 0; w only
// under FSAI); iters and rel (S,).  All contiguous float32/int32 on the
// device.  offs, goffs, uoffs: the K, Kg, Ku diagonal offsets.  C: blocks
// per subdomain; chunk: rows per block; smem: dynamic shared memory of a
// block, 0 for the global-memory variant.
int fused_cg_f32(const float* dia, const float* gl, const float* gu,
                 const float* b, const float* x0, const float* dinv, float* x,
                 float* r, float* p, float* ap, float* w, int* iters,
                 float* rel, int S, int K, int Kg, int Ku, int R,
                 const int* offs, const int* goffs, const int* uoffs,
                 float tol2, int maxit, int C, int chunk, int smem,
                 void* stream) {
  const bool fsai = gl != nullptr;
  const int vectors = fsai ? 5 : 4;
  if (K < 1 || K > kMaxDiags || C < 1 || C > 8 || chunk < 1 ||
      (long long)chunk * C < R || smem < 0 ||
      (smem > 0 && smem < chunk * vectors * 4) ||
      (smem == 0 && (r == nullptr || p == nullptr || ap == nullptr ||
                     (fsai && w == nullptr))) ||
      (fsai && (gu == nullptr || dinv != nullptr || Kg < 1 ||
                Kg > kMaxDiags || Ku < 1 || Ku > kMaxDiags)))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  Args a{};
  a.dia = dia;
  a.gl = gl;
  a.gu = gu;
  a.b = b;
  a.x0 = x0;
  a.dinv = dinv;
  a.x = x;
  a.r = r;
  a.p = p;
  a.ap = ap;
  a.w = w;
  a.iters = iters;
  a.rel = rel;
  a.K = K;
  a.Kg = fsai ? Kg : 0;
  a.Ku = fsai ? Ku : 0;
  a.R = R;
  a.C = C;
  a.chunk = chunk;
  a.maxit = maxit;
  a.dv_shared = dinv != nullptr && smem >= chunk * 5 * 4;
  a.planes_shared = fsai && smem >= chunk * (5 + K + Kg + Ku) * 4;
  a.offs = make_offsets(offs, K);
  if (fsai) {
    a.goffs = make_offsets(goffs, Kg);
    a.uoffs = make_offsets(uoffs, Ku);
  }
  a.tol2 = tol2;
  return with_kernel(K, smem, fsai, [&](auto fn) {
    cudaLaunchAttribute at[1];
    cudaLaunchConfig_t cfg =
        launch_config(S, C, smem, at, (cudaStream_t)stream);
    return (int)cudaLaunchKernelEx(&cfg, fn, a);
  });
}

}  // extern "C"
