// K5: free-running asynchronous RAS rounds, one launch for T rounds of all
// ranks, with no barrier between ranks.
//
// Replaces schwarz_tpu/ops/async_ras.py async_ras_rounds (:394).  Per round
// a rank packs its two edge strips and its known-converged bits into slot
// rings, consumes its neighbours' messages of round t-B (or, in warm-up
// rounds t < B, the halos carried from the previous launch with zero flags),
// builds its folded extended windows, computes the masked residual, its
// ||r||^2 over owned rows and the convergence bit, merges the gossip, runs
// its correction solve (Jacobi-PCG, BiCGStab or GMRES(m), with the O-RAS
// Robin diagonal when given) and freezes once it knows every rank converged.
// After T rounds it drains the outstanding messages into its known bits and
// its halo carries.
//
// Layout.  A rank is a cluster of C thread blocks of 1024 threads on C SMs
// (C in {1, 2, 4, 8}, chosen by the wrapper), launched cooperatively with a
// cluster dimension, so that all D ranks are resident at once: a rank spins
// on its neighbours, so a rank that is not scheduled would deadlock the
// others.  The card takes the cooperative attribute together with the
// cluster dimension (checked on an H100 with CUDA 12.9), and the wrapper
// checks cudaOccupancyMaxActiveClusters >= D before the launch.  A rank's Sl
// windows are one contiguous vector of L = Sl*total floats; block c of the
// cluster owns the contiguous rows [c L/C, (c+1) L/C) of every vector
// (rounded to 32 rows, so that its reads stay coalesced).  The shifted
// reads of the DIA product wrap cyclically over L, as the TPU kernel's flat
// shifts do, and every cross-window read meets a zero coefficient
// (hw >= ovp + bw); they reach into other blocks' rows, so the vectors a
// product reads are read after a cluster barrier, with __ldcg (L1 is not
// coherent across SMs).  Vectors read only pointwise (r, z, the products)
// are touched by their owner block alone.  A block's loops are bound by the
// latency of their loads, so each thread keeps the loads of four rows in
// flight (for_rows in async_common.cuh).  Work vectors live in device
// memory (the wrapper allocates them): the chunk of a rank of the slice
// (122752 / C rows, five vectors) does not fit one SM's shared memory.
// Dot products are float32 products summed in float64, per block and then
// over the cluster in block order (ClusterTeam in async_common.cuh), and
// rounded to float32; this file is built with -fmad=false.  The plain
// PyTorch version does the same, so card and CPU agree bit for bit up to
// rare ties, and every block of a rank holds the same step sizes, known
// bits and done_at.  The correction solve shares its step sizes across the
// rank's windows (one polynomial per rank), as on the TPU.  A rank that is
// frozen skips its correction solve: the TPU kernel computes it and
// discards it.
//
// Messages.  Each (rank, direction) owns a ring of M = 2B+2 slots in device
// memory: hw strip floats, the D known lanes, and a 64-bit sequence word
// per slot.  Direction 0 carries the rank's first hw rows to its left
// neighbour, direction 1 its last hw rows to its right neighbour; the ring
// is cyclic (rank 0's left neighbour is rank D-1, and with D = 1 a rank is
// its own neighbour).  The protocol runs on the cluster's block 0 (the
// leader): every block writes its share of the slot, a cluster barrier
// orders them, then the leader's thread 0 fences and release-stores the
// sequence number t+1.  Consumer: the leader's thread 0 spins with acquire
// loads until the sequence number arrives, a cluster barrier follows, and
// every block reads the slot with __ldcg.  Once every block has read the
// slot (another cluster barrier), the leader adds one to the producer's ack
// counter with a release; a producer waits for ack >= t-M+1 before it
// reuses a slot at round t >= M.
//
// Launch boundaries: the sequence words, ack counters and the error word
// are reset by a stream-ordered memset before every launch (the wrapper
// allocates them zeroed), so messages are numbered from 1 in each launch,
// as the TPU kernel's rings start empty at each launch.
//
// Watchdog: every spin is bounded by clock64(); on timeout the rank sets
// the error word and leaves the loop, every other spin sees the error word
// and leaves too, and the wrapper raises.
//
// fresh_read: the leader's thread 0 also peeks the sequence words of the
// B-1 newer slots and takes the newest message that has fully arrived; the
// other blocks read its choice through distributed shared memory.  A slot
// cannot be overwritten before its message is acknowledged at round u+B > t,
// so the peek is safe.
//
// Bound on the card: per launch, the bytes of dia, b, dinv, both masks and
// x read once, against T * ninner * (2K+13) float32 operations per row;
// at the 1M-row slice the operations bound it.  The first version ran a
// rank on one SM (16 of 132 at the slice) and streamed each rank's vectors
// through it several times per inner iteration; the cluster spreads a rank
// over C SMs.  Each inner iteration still streams the rank's DIA
// coefficients (55 MB over all ranks at the slice, more than the 50 MB L2).
#include "async_common.cuh"
#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

enum Solver { kCG = 0, kBiCGStab = 1, kGMRES = 2 };

struct Args {
  const float* dia;    // (D, K, L)
  const float* b;      // (D, L)
  const float* dinv;
  const float* md;
  const float* mi;
  const float* boost;  // may be null
  const float* x_in;   // (D, Sl*R)
  const float* known_in;
  const float* aux_in;  // (D, 128)
  const float* hl_in;   // (D, hw)
  const float* hr_in;
  float* x;
  float* known_out;
  float* aux_out;
  float* hl_out;
  float* hr_out;
  float* work;  // (D, nwork, L)
  float* ring;  // (D, 2, M, slot)
  unsigned long long* seq;  // (D, 2, M)
  unsigned int* ack;        // (D, 2)
  int* err;
  int D, Sl, K, total, hw, R, T, B, M, ninner, solver, fresh, slot, nwork;
  int L, C, chunk;
  Offsets offs;
  float tol2;
};

// Row q of the DIA product over the rank's folded vector, reads wrapping
// cyclically: sum_k dia[k, q] * (scale ? dv * v : v)[(q + o_k) mod L].  The
// reads of v reach other blocks' rows: __ldcg.
template <int KC, bool kScale>
__device__ __forceinline__ float dia_row_cyc(const float* __restrict__ dia,
                                             const float* v,
                                             const float* __restrict__ dv,
                                             int q, int K, int L,
                                             const Offsets& offs) {
  const int nk = KC > 0 ? KC : K;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < nk; ++k) {
    int c = q + offs.v[k];
    if (c < 0) c += L;
    else if (c >= L) c -= L;
    const float vc = __ldcg(v + c);
    const float xv = kScale ? dv[c] * vc : vc;
    const float d = dia[(long long)k * L + q];
    acc = k == 0 ? d * xv : acc + d * xv;
  }
  return acc;
}

// A_solve (dv * v if kScale) at row q: the masked product, plus the O-RAS
// Robin diagonal when ``bo`` is given.
template <int KC, bool kScale>
__device__ __forceinline__ float apply_solve(
    const float* __restrict__ dia, const float* __restrict__ dv,
    const float* __restrict__ md, const float* __restrict__ bo,
    const float* v, int q, int K, int L, const Offsets& offs) {
  float s = md[q] * dia_row_cyc<KC, kScale>(dia, v, dv, q, K, L, offs);
  if (bo != nullptr) {
    const float vq = v[q];  // an own row
    s += bo[q] * (kScale ? dv[q] * vq : vq);
  }
  return s;
}

template <int KC>
__global__ void __launch_bounds__(kThreads, 1) async_ras_kernel(const Args a) {
  __shared__ float known[kLanes], fl_l[kLanes], fl_r[kLanes];
  __shared__ double red[4 * kWarps + 4];
  __shared__ double part[2 * kMaxSum];
  __shared__ GmresScratch gm;
  __shared__ int src_l, src_r;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int crank = (int)cluster.block_rank();
  const bool lead = crank == 0;   // the cluster's block 0 runs the protocol
  const int me = blockIdx.x / a.C;
  const int D = a.D, L = a.L, hw = a.hw, R = a.R, total = a.total;
  const int Sl = a.Sl, T = a.T, B = a.B, M = a.M;
  const int SlR = Sl * R;
  // this block's share of strided work over the whole rank
  const int g0 = crank * kThreads + tid, gstep = a.C * kThreads;
  ClusterTeam team{min(L, crank * a.chunk), min(L, (crank + 1) * a.chunk),
                   part, 0};
  const int q0 = team.q0 + tid, q1 = team.q1;
  const int left = (me + D - 1) % D, right = (me + 1) % D;
  const long long vb = (long long)me * L;
  const float* dia = a.dia + vb * a.K;
  const float* bo = a.boost != nullptr ? a.boost + vb : nullptr;
  const float* b = a.b + vb;
  const float* dv = a.dinv + vb;
  const float* md = a.md + vb;
  const float* mi = a.mi + vb;
  float* x = a.x + (long long)me * SlR;
  const float* x_in = a.x_in + (long long)me * SlR;
  float* W = a.work + (long long)me * a.nwork * L;
  auto vec = [&](int i) { return W + (long long)i * L; };
  auto slot = [&](int rank, int dir, int j) {
    return a.ring + (((long long)rank * 2 + dir) * M + j) * a.slot;
  };
  auto seq = [&](int rank, int dir, int j) {
    return a.seq + ((long long)rank * 2 + dir) * M + j;
  };
  auto ack = [&](int rank, int dir) { return a.ack + rank * 2 + dir; };

  for (int l = tid; l < kLanes; l += kThreads)
    known[l] = fmaxf(a.known_in[me * kLanes + l], l >= D ? 1.f : 0.f);
  for (int i = g0; i < SlR; i += gstep) x[i] = x_in[i];
  float rn0 = a.aux_in[me * kLanes + 0];
  float done_at = a.aux_in[me * kLanes + 1];
  const float base_t = a.aux_in[me * kLanes + 2];
  float hits = fmaxf(a.aux_in[me * kLanes + 4], 0.f);  // the leader's count
  float rn = 0.f;
  cluster.sync();  // x is read across blocks from here on

  auto A_solve = [&](auto scaled, const float* v, int q) {
    return apply_solve<KC, decltype(scaled)::value>(dia, dv, md, bo, v, q, a.K,
                                                    L, a.offs);
  };

  for (int t = 0; t < T; ++t) {
    const int j = t % M;
    // ---- flow control: slot j is free once its last message was acked
    if (t >= M) {
      if (lead && tid == 0) {
        const unsigned int want = t - M + 1;
        spin_until(ack(me, 0), want, a.err, kWaitAck) &&
            spin_until(ack(me, 1), want, a.err, kWaitAck);
      }
      cluster.sync();
    }
    // ---- pack and publish the two edge strips with the known bits
    {
      float* s0 = slot(me, 0, j);
      float* s1 = slot(me, 1, j);
      for (int i = g0; i < hw; i += gstep) {
        s0[i] = __ldcg(x + i);
        s1[i] = __ldcg(x + SlR - hw + i);
      }
      if (lead) {
        for (int l = tid; l < D; l += kThreads) {
          s0[hw + l] = known[l];
          s1[hw + l] = known[l];
        }
      }
      cluster.sync();
      if (lead && tid == 0) {
        __threadfence();
        st_release(seq(me, 0, j), (unsigned long long)t + 1);
        st_release(seq(me, 1, j), (unsigned long long)t + 1);
      }
    }
    // ---- consume the neighbours' message of round t - B
    const bool msg = t >= B;
    const float* h_l;
    const float* h_r;
    if (msg) {
      if (lead && tid == 0) {
        const int u = t - B, jc = u % M;
        spin_until(seq(left, 1, jc), (unsigned long long)u + 1, a.err,
                   kWaitMessage) &&
            spin_until(seq(right, 0, jc), (unsigned long long)u + 1, a.err,
                       kWaitMessage);
        int cl = jc, cr = jc;
        if (a.fresh && B > 1) {
          for (int d = 1; d < B; ++d) {
            const int un = u + d, jn = un % M;
            if (ld_acquire(seq(left, 1, jn)) >= (unsigned long long)un + 1) {
              cl = jn;
              hits += 1.f;
            }
            if (ld_acquire(seq(right, 0, jn)) >= (unsigned long long)un + 1) {
              cr = jn;
              hits += 1.f;
            }
          }
        }
        src_l = cl;
        src_r = cr;
      }
      cluster.sync();
      h_l = slot(left, 1, *cluster.map_shared_rank(&src_l, 0));
      h_r = slot(right, 0, *cluster.map_shared_rank(&src_r, 0));
      // known bits only grow, so the newest message's flags cover the
      // union over every slot the fresh read looked at
      for (int l = tid; l < kLanes; l += kThreads) {
        fl_l[l] = l < D ? __ldcg(h_l + hw + l) : 0.f;
        fl_r[l] = l < D ? __ldcg(h_r + hw + l) : 0.f;
      }
    } else {
      h_l = a.hl_in + (long long)me * hw;
      h_r = a.hr_in + (long long)me * hw;
      for (int l = tid; l < kLanes; l += kThreads) fl_l[l] = fl_r[l] = 0.f;
    }
    // ---- the folded extended windows: ring halos at the rank's edges,
    // the current iterate between its own windows
    float* xp = vec(0);
    for_rows(
        team,
        [&](int q) {
          const int s = q / total, i = q - s * total;
          const float* xs = x + (long long)s * R;
          if (i < hw) return s == 0 ? __ldcg(h_l + i) : __ldcg(xs + i - hw);
          if (i < hw + R) return __ldcg(xs + i - hw);
          return s == Sl - 1 ? __ldcg(h_r + i - hw - R) : __ldcg(xs + i - hw);
        },
        [&](int q, float v) { xp[q] = v; });
    cluster.sync();  // every block has read the slot; xp is read across
    if (msg && lead && tid == 0) {
      red_release_add(ack(left, 1), 1u);
      red_release_add(ack(right, 0), 1u);
    }
    // ---- masked residual, its norm over owned rows, solver start vectors
    float* r = vec(1);
    double acc[2] = {0.0, 0.0};
    for_rows<kProductRowsInFlight>(
        team,
        [&](int q) {
          return Vals<5>{{dia_row_cyc<KC, false>(dia, xp, dv, q, a.K, L,
                                                 a.offs),
                          md[q], b[q], mi[q], dv[q]}};
        },
        [&](int q, Vals<5> l) {
          const float rq = l.v[1] * (l.v[2] - l.v[0]);
          r[q] = rq;
          const float m = l.v[3] * rq;
          acc[0] += (double)(m * m);
          if (a.solver == kCG) {
            const float s0 = l.v[4] * rq;
            vec(2)[q] = s0;   // p
            vec(3)[q] = 0.f;  // z
            acc[1] += (double)(rq * s0);
          } else {
            acc[1] += (double)(rq * rq);
            if (a.solver == kBiCGStab) {
              vec(2)[q] = 0.f;  // zz
              vec(3)[q] = rq;   // rr
              vec(4)[q] = 0.f;  // p
              vec(5)[q] = 0.f;  // v
            }
          }
        });
    team.sum(acc, red);
    rn = (float)acc[0];
    rn0 = rn0 < 0.f ? rn : rn0;
    const float myconv = rn <= a.tol2 * rn0 ? 1.f : 0.f;
    float kn = 0.f;
    if (tid < kLanes) {
      kn = fmaxf(fmaxf(known[tid], tid == me ? myconv : 0.f),
                 fmaxf(fl_l[tid], fl_r[tid]));
      known[tid] = kn;
    }
    const bool all_known =
        __syncthreads_count(tid < kLanes && kn >= 1.f) == kLanes;
    const bool frozen = done_at >= 0.f || all_known;

    // ---- correction solve z ~= A_solve^-1 r (skipped when frozen)
    const float* z = nullptr;
    if (!frozen && a.solver == kCG) {
      float* zz = vec(3);
      cluster_pcg(team, A_solve, a.ninner, (float)acc[1], r, vec(2), zz,
                  vec(4), dv, red);
      z = zz;
    } else if (!frozen && a.solver == kBiCGStab) {
      float* zz = vec(2);
      // acc[1] is dot(r, rr) with rr = r
      cluster_bicgstab(team, A_solve, a.ninner, (float)acc[1], r, zz,
                       vec(3), vec(4), vec(5), vec(6), vec(7), dv, red);
      z = zz;
    } else if (!frozen) {  // GMRES(m), one Arnoldi cycle
      float* zz = vec(a.ninner + 3);
      cluster_gmres(team, A_solve, [&](int i) { return vec(2 + i); },
                    a.ninner, (float)acc[1], r, zz, dv, gm, red);
      z = zz;
    }
    if (z != nullptr) {
      for (int q = q0; q < q1; q += kThreads) {
        const int s = q / total, i = q - s * total - hw;
        if (i >= 0 && i < R) {
          float* xq = x + (long long)s * R + i;
          *xq = __ldcg(xq) + z[q];
        }
      }
    }
    if (done_at < 0.f && all_known) done_at = base_t + (float)t;
    cluster.sync();  // x and known are read by the next round's pack
  }

  // ---- drain: messages T-B .. T-1 were sent but not consumed; their flags
  // are still gossip and the last one is the halo carried to the next launch
  const int n0 = T - B > 0 ? T - B : 0;
  if (lead && tid == 0) {
    for (int n = n0; n < T; ++n) {
      spin_until(seq(left, 1, n % M), (unsigned long long)n + 1, a.err,
                 kWaitDrain) &&
          spin_until(seq(right, 0, n % M), (unsigned long long)n + 1, a.err,
                     kWaitDrain);
    }
  }
  cluster.sync();
  {
    const float* cl = slot(left, 1, (T - 1) % M);
    const float* cr = slot(right, 0, (T - 1) % M);
    for (int i = g0; i < hw; i += gstep) {
      a.hl_out[(long long)me * hw + i] = __ldcg(cl + i);
      a.hr_out[(long long)me * hw + i] = __ldcg(cr + i);
    }
  }
  if (lead) {
    for (int l = tid; l < D; l += kThreads) {
      float k = known[l];
      for (int n = n0; n < T; ++n) {
        k = fmaxf(fmaxf(k, __ldcg(slot(left, 1, n % M) + hw + l)),
                  __ldcg(slot(right, 0, n % M) + hw + l));
      }
      known[l] = k;
    }
    __syncthreads();
    for (int l = tid; l < kLanes; l += kThreads) {
      a.known_out[me * kLanes + l] = known[l];
      float v = 0.f;
      if (l == 0) v = rn0;
      if (l == 1) v = done_at;
      if (l == 2) v = base_t + (float)T;
      if (l == 3) v = rn;
      a.aux_out[me * kLanes + l] = v;
    }
    if (tid == 0) a.aux_out[me * kLanes + 4] = hits;
  }
  cluster.sync();  // no block leaves while another may read its partials
}

// D ranks of C blocks: a cooperative launch of D clusters of C blocks.
cudaLaunchConfig_t launch_config(int D, int C, cudaLaunchAttribute* at,
                                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(D * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  return cfg;
}

}  // namespace

extern "C" {

// Clusters of C blocks of the kernel that the card holds at once: the
// largest rank count a launch with cluster size C can hold (0 without
// cooperative or cluster launch support).
int async_ras_max_clusters(int K, int C) {
  int dev = 0, coop = 0, clus = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&clus, cudaDevAttrClusterLaunch, dev);
  if (!coop || !clus || C < 1 || C > 8) return 0;
  int n = 0;
  const int e = dispatch_diags(K, [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    cudaLaunchAttribute at[2];
    cudaLaunchConfig_t cfg = launch_config(1, C, at, 0);
    return (int)cudaOccupancyMaxActiveClusters(&n, async_ras_kernel<KC>, &cfg);
  });
  return e == 0 ? n : 0;
}

// See ops/async_ras_kernel.py for the operand layout.  ``sync`` holds the
// (D, 2, M) sequence words, the (D, 2) ack counters and the error word,
// zeroed by the caller before the launch.  C: blocks per rank.
int async_ras_f32(const float* dia, const float* b, const float* dinv,
                  const float* md, const float* mi, const float* boost,
                  const float* x_in, const float* known_in,
                  const float* aux_in, const float* hl_in, const float* hr_in,
                  float* x, float* known, float* aux, float* hl, float* hr,
                  float* work, float* ring, void* sync, int D, int Sl, int K,
                  int total, int hw, int T, int B, int ninner, int solver,
                  int fresh, const int* offs, float tol2, int C,
                  void* stream) {
  if (K < 1 || K > kMaxDiags || D < 1 || D > kLanes || T < 1 || B < 1 ||
      C < 1 || C > 8)
    return (int)cudaErrorInvalidValue;
  if (solver == kGMRES && (ninner < 1 || ninner > kMaxGmres))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.dia = dia;
  a.b = b;
  a.dinv = dinv;
  a.md = md;
  a.mi = mi;
  a.boost = boost;
  a.x_in = x_in;
  a.known_in = known_in;
  a.aux_in = aux_in;
  a.hl_in = hl_in;
  a.hr_in = hr_in;
  a.x = x;
  a.known_out = known;
  a.aux_out = aux;
  a.hl_out = hl;
  a.hr_out = hr;
  a.work = work;
  a.ring = ring;
  a.D = D;
  a.Sl = Sl;
  a.K = K;
  a.total = total;
  a.hw = hw;
  a.R = total - 2 * hw;
  a.T = T;
  a.B = B;
  a.M = 2 * B + 2;
  a.ninner = ninner;
  a.solver = solver;
  a.fresh = fresh;
  a.slot = (hw + D + 3) / 4 * 4;
  a.nwork = solver == kCG ? 5 : solver == kBiCGStab ? 8 : ninner + 4;
  a.L = Sl * total;
  a.C = C;
  a.chunk = ((a.L + C - 1) / C + 31) / 32 * 32;
  a.offs = make_offsets(offs, K);
  a.tol2 = tol2;
  auto* s = static_cast<unsigned long long*>(sync);
  a.seq = s;
  a.ack = reinterpret_cast<unsigned int*>(s + (long long)D * 2 * a.M);
  a.err = reinterpret_cast<int*>(s + (long long)D * 2 * a.M + D);
  return dispatch_diags(K, [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    cudaLaunchAttribute at[2];
    cudaLaunchConfig_t cfg = launch_config(D, C, at, (cudaStream_t)stream);
    return (int)cudaLaunchKernelEx(&cfg, async_ras_kernel<KC>, a);
  });
}

}  // extern "C"
