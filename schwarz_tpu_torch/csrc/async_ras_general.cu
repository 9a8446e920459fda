// K7: free-running asynchronous RAS rounds on any graph and partition, one
// launch for T rounds of all ranks, with no barrier between ranks.
//
// Replaces schwarz_tpu/ops/async_ras_general.py async_general_rounds (:360).
// The rank is the subdomain.  Its extended vector has Rext = Rint + H slots:
// its owned rows, then its halo (overlap closure and Dirichlet frontier ring,
// ordered by owner).  The subdomain graph is edge-coloured, so a rank has at
// most one link per colour; tgt[c] is its partner on colour c, or itself
// when it has no link of that colour.  Per round a rank
//   - packs, for every colour, the owned values its partner needs (through
//     send_idx) with its known-converged bits into a slot ring, from its
//     iterate as it is BEFORE this round's update,
//   - at t >= B consumes its partners' messages of round t-B: the values land
//     in its halo slots (through recv_slot) and the known bits are merged; in
//     the warm-up rounds t < B the halo comes from ``carry``, the last
//     message of the previous launch, and no bits are merged,
//   - computes the residual r = b - A x_ext of its extended operator (rows
//     off the solve domain are zero), ||r||^2 over its OWNED rows and the
//     convergence bit, merges the gossip, runs its correction solve on all
//     Rext rows (Jacobi-PCG or BiCGStab, with the O-RAS Robin diagonal when
//     given) and adds the correction to its owned rows unless it knows every
//     rank converged.
// After T rounds it merges the known bits of the last B messages and keeps
// the values of message T-1 as the next launch's carry.
//
// Layout.  One block per rank (block_threads below), launched
// cooperatively so that all S ranks are resident at once: a rank spins on
// its partners.  The operator is padded ELL, planes first: cols and vals
// (S, K, Rext), the entries of a row in slot order, a row's product summed
// in that order in float32.  The TPU kernel's dense operators, one-hot pack
// and unpack matrices and lane-replicated tiles turn gathers into matrix
// products there; here packing and unpacking are indexed loads and stores.
// With everything in device memory a rank's loops are bound by the latency
// of its loads: every entry of a product is a chain of two L2 loads, cols
// then the vector at cols.  So the shared-memory variant (kShared) copies
// the rank's whole working set into its block's shared memory at the
// launch's start: the work vectors (xe, r, p, z, A p; BiCGStab's three
// more), then the ELL planes (vals float32, cols as 16-bit indices), then
// dinv; at the general slice (Rext = 2432, K = 9) that is 190 KB of the 227
// KB a block may take, and every gather of every sweep hits shared memory.
// Its sweeps are then bound by shared-memory bandwidth: a product entry is
// three shared loads (index, value, gather).  b, mask_int and boost are read once a round and the
// rings are read by other ranks: they stay in device memory.  A rank too
// large for shared memory takes the global-memory variant, the same code
// with every array in device memory (ops/cluster_geometry.py sizes both).
// One SM per rank, so clusters cannot help here: 128 ranks of two blocks
// would need 256 SMs.
//
// Sums.  Dot products are block reductions of float32 products summed in
// float64 and rounded once, and this file is built with -fmad=false, as the
// 1-D and 2-D kernels are: the plain PyTorch version does the same, so card
// and CPU detect convergence at the same round.  A frozen rank skips its
// correction solve.
//
// Messages.  Each (rank, colour) owns a ring of M = 2B+2 slots: SEG values,
// the 128 known lanes and a 64-bit sequence word; the partner reads it.  The
// producer writes its slots with all threads, __syncthreads, then thread c
// fences and release-stores t+1 on colour c; ALL colours are published
// before any message is awaited, or a cycle of ranks could deadlock.  On
// the consumer thread c spins with acquire loads on colour c (the C waits,
// each an L2 round trip, overlap), __syncthreads, the block reads with
// __ldcg and thread c credits colour c's producer's ack counter; a producer
// waits for ack >= t-M+1 before it reuses a slot at t >= M.  Pack and
// unpack walk every (colour, place) pair at once, each thread with the
// loads of kRowsInFlight pairs in flight.  A colour on which a rank has no
// link carries nothing: its message would come back to the rank itself
// with the rank's own bits.  Sequence words, acks and the error word
// are zeroed by the caller before each launch.  Every spin is bounded by
// clock64() in one process and by the global timer across processes: on
// timeout the group's error word is set, all spins leave and the wrapper
// raises.  Across processes each process launches its
// Sl = S / P ranks (me = first + blockIdx.x) and reaches its partners'
// rings through the table of windows (RankRings in async_common.cuh,
// ops/rank_rings.py).
//
// Bound on the card: cols, vals, b, dinv, mask_int and x read once and x
// written once, against T * (ninner + 1) * (2K + 13) float32 operations per
// extended row; at S = 128, Rext = 2432, K = 9 the operations bound it.  One
// SM per rank runs far from that bound: its shared-memory bandwidth, not
// the card's arithmetic, limits a sweep.
#include <cstdint>

#include "async_common.cuh"

namespace {

struct Args {
  const int* cols;     // (S, K, Rext)
  const float* vals;   // (S, K, Rext)
  const float* b;      // (S, Rext), as dinv, mi, boost
  const float* dinv;
  const float* mi;
  const float* boost;  // may be null
  const int* send_idx;   // (S, C, SEG), -1 where nothing is packed
  const int* recv_slot;  // (S, C, SEG), -1 where nothing lands
  const int* tgt;        // (S, C)
  const float* x_in;     // (S, Rint)
  const float* known_in;  // (S, 128)
  const float* aux_in;
  const float* carry_in;  // (S, C, SEG)
  float* x_out;
  float* known_out;
  float* aux_out;
  float* carry_out;
  float* work;  // (Sl, nwork, Rext); null in the shared-memory variant
  float* ring;  // (S, C, M, slot): in one process
  unsigned long long* seq;  // (S, C, M)
  unsigned int* ack;        // (S, C)
  int* err;
  int S, Rint, H, Rext, K, SEG, C, T, B, M, ninner, nonsym, nwork, slot;
  float tol2;
};

// Byte offsets of the shared-memory variant's arrays (the layout of
// general_smem_bytes in ops/cluster_geometry.py): the nwork work vectors,
// vals, cols as 16-bit indices (padded to 16 bytes), dinv.
struct SmemLayout {
  long long vals, cols, dinv, total;
  __host__ __device__ SmemLayout(int nwork, int K, int Rext) {
    vals = 4LL * nwork * Rext;
    cols = vals + 4LL * K * Rext;
    dinv = cols + (2LL * K * Rext + 15) / 16 * 16;
    total = dinv + 4LL * Rext;
  }
};

// Threads a block.  With a rank's data in shared memory every sweep is
// bound by shared-memory bandwidth and each block reduction costs more with
// more warps: 512 threads measured fastest at the general slice, for CG and
// BiCGStab (against 256, 384 and 1024).  With the data in device memory
// more loads from L2 in flight win: 1024.
__host__ __device__ constexpr int block_threads(bool shared) {
  return shared ? 512 : 1024;
}

// KC: the ELL width K when the launcher knows it at compile time (5 or 9:
// a row's K loads then issue together), else 0.
// kCross: the ranks span processes (RankRings in async_common.cuh)
template <bool kShared, int KC, bool kCross>
__global__ void __launch_bounds__(block_threads(kShared), 1)
    async_general_kernel(const ArgsFor<Args, kCross> a) {
  constexpr int NT = block_threads(kShared);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float known[kLanes];
  __shared__ double red[3 * (NT / 32) + 4];
  using Idx = std::conditional_t<kShared, uint16_t, int>;

  const int tid = threadIdx.x;
  const int ml = blockIdx.x;          // the rank in this process's launch
  const int me = group_rank<kCross>(a, ml);  // in the group
  const int S = a.S, T = a.T, B = a.B, M = a.M, C = a.C, K = a.K;
  const int Rint = a.Rint, Rext = a.Rext, SEG = a.SEG;
  const long long eb = (long long)ml * K * Rext;
  const long long vb = (long long)ml * Rext;
  const float* b = a.b + vb;
  const float* mi = a.mi + vb;
  const float* bo = a.boost != nullptr ? a.boost + vb : nullptr;
  const int* sidx = a.send_idx + (long long)ml * C * SEG;
  const int* rslot = a.recv_slot + (long long)ml * C * SEG;
  const int* tgt = a.tgt + ml * C;
  const Idx* cols;
  const float* vals;
  const float* dv;
  float* W;
  if constexpr (kShared) {
    // the rank's operator and dinv, copied in once; the work vectors are
    // written before they are read
    const SmemLayout lay(a.nwork, K, Rext);
    auto* sv = reinterpret_cast<float*>(smem + lay.vals);
    auto* sc = reinterpret_cast<uint16_t*>(smem + lay.cols);
    auto* sd = reinterpret_cast<float*>(smem + lay.dinv);
    for (int i = tid; i < K * Rext; i += NT) {
      sv[i] = a.vals[eb + i];
      sc[i] = (uint16_t)a.cols[eb + i];
    }
    for (int i = tid; i < Rext; i += NT) sd[i] = a.dinv[vb + i];
    cols = sc;
    vals = sv;
    dv = sd;
    W = reinterpret_cast<float*>(smem);
  } else {
    cols = a.cols + eb;
    vals = a.vals + eb;
    dv = a.dinv + vb;
    W = a.work + (long long)ml * a.nwork * Rext;
  }
  auto vec = [&](int i) { return W + (long long)i * Rext; };
  float* xe = vec(0);  // [owned rows, halo]
  auto slot = [&](int rank, int c, int j) {
    if constexpr (kCross)
      return a.rings.at(rank, c, j);
    else
      return a.ring + (((long long)rank * C + c) * M + j) * a.slot;
  };
  auto seq = [&](int rank, int c, int j) {
    if constexpr (kCross)
      return a.rings.seq(rank, c, j);
    else
      return a.seq + ((long long)rank * C + c) * M + j;
  };
  auto ack = [&](int rank, int c) {
    if constexpr (kCross)
      return a.rings.ack(rank, c);
    else
      return a.ack + rank * C + c;
  };
  auto err = [&] {
    if constexpr (kCross)
      return a.rings.err();
    else
      return a.err;
  };
  auto longest = [&]() -> unsigned long long* {
    if constexpr (kCross)
      return a.rings.longest();
    else
      return nullptr;
  };
  // row q of A v, or of A (dv * v) when scaled: the entries in slot order
  auto A_row = [&](auto scaled, const float* v, int q) {
    auto at = [&](int i) {
      return decltype(scaled)::value ? dv[i] * v[i] : v[i];
    };
    const int nk = KC > 0 ? KC : K;
    float acc = vals[q] * at(cols[q]);
#pragma unroll
    for (int k = 1; k < nk; ++k)
      acc = acc + vals[k * Rext + q] * at(cols[k * Rext + q]);
    return acc;
  };
  // the same with the O-RAS diagonal
  auto A_solve = [&](auto scaled, const float* v, int q) {
    float acc = A_row(scaled, v, q);
    if (bo != nullptr)
      acc = acc + bo[q] * (decltype(scaled)::value ? dv[q] * v[q] : v[q]);
    return acc;
  };
  // the values of my partners' messages in ring slot j into my halo: every
  // (colour, place) pair at once, kRowsInFlight of a thread's in flight
  auto unpack_values = [&](int j) {
    for (int i0 = tid; i0 < C * SEG; i0 += kRowsInFlight * NT) {
      int h[kRowsInFlight];
      float v[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int i = i0 + u * NT, c = i / SEG;
        h[u] = i < C * SEG && tgt[c] != me ? rslot[i] : -1;
        if (h[u] >= 0) v[u] = __ldcg(slot(tgt[c], c, j) + i - c * SEG);
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u)
        if (h[u] >= 0) xe[Rint + h[u]] = v[u];
    }
  };
  // my partners' known bits in ring slot j into mine: thread (g, l) reads
  // lane l of colours g, g + G, ..., all its loads in flight.  Known bits
  // are 0 or 1, and the max of non-negative floats is the max of their bits
  // as integers, so the groups merge with shared-memory atomicMax.
  auto merge_flags = [&](int j) {
    constexpr int G = NT / kLanes;
    const int l = tid % kLanes;
    float k = 0.f;
    for (int c0 = tid / kLanes; c0 < C; c0 += G * kRowsInFlight) {
      float f[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int c = c0 + u * G;
        f[u] = c < C && tgt[c] != me ? __ldcg(slot(tgt[c], c, j) + SEG + l)
                                     : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) k = fmaxf(k, f[u]);
    }
    atomicMax(reinterpret_cast<int*>(known) + l, __float_as_int(k));
  };
  // wait until every partner's message n has arrived: thread c waits on
  // colour c, so the waits overlap
  auto await_messages = [&](int n, int code) {
    for (int c = tid; c < C; c += NT)
      if (tgt[c] != me)
        spin<kCross>(seq(tgt[c], c, n % M), (unsigned long long)n + 1,
                     err(), code, longest());
    __syncthreads();
  };

  for (int l = tid; l < kLanes; l += NT)
    known[l] = fmaxf(a.known_in[ml * kLanes + l], l >= S ? 1.f : 0.f);
  for (int i = tid; i < Rext; i += NT)
    xe[i] = i < Rint ? a.x_in[(long long)ml * Rint + i] : 0.f;
  float rn0 = a.aux_in[ml * kLanes + 0];
  float done_at = a.aux_in[ml * kLanes + 1];
  const float base_t = a.aux_in[2];  // rank 0's round counter
  float rn = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int j = t % M;
    // ---- flow control: slot j is free once its last message was acked
    if (t >= M) {
      for (int c = tid; c < C; c += NT)
        if (tgt[c] != me)
          spin<kCross>(ack(me, c), (unsigned int)(t - M + 1), err(),
                       kWaitAck, longest());
      __syncthreads();
    }
    // ---- pack and publish one message per colour with the known bits;
    // thread c releases colour c
    for (int i0 = tid; i0 < C * SEG; i0 += kRowsInFlight * NT) {
      int src[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int i = i0 + u * NT;
        src[u] = i < C * SEG ? sidx[i] : -1;
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int i = i0 + u * NT, c = i / SEG;
        if (i < C * SEG && tgt[c] != me)
          slot(me, c, j)[i - c * SEG] = src[u] >= 0 ? xe[src[u]] : 0.f;
      }
    }
    for (int i = tid; i < C * kLanes; i += NT) {
      const int c = i / kLanes;
      const int l = i - c * kLanes;
      if (tgt[c] != me) slot(me, c, j)[SEG + l] = known[l];
    }
    __syncthreads();
    for (int c = tid; c < C; c += NT) {
      if (tgt[c] != me) {
        __threadfence();
        st_release(seq(me, c, j), (unsigned long long)t + 1);
      }
    }
    // ---- consume the partners' messages of round t - B, or the carry
    if (t >= B) {
      const int u = t - B;
      await_messages(u, kWaitMessage);
      unpack_values(u % M);
      merge_flags(u % M);
      __syncthreads();
      for (int c = tid; c < C; c += NT)
        if (tgt[c] != me) red_release_add(ack(tgt[c], c), 1u);
    } else {
      const float* cy = a.carry_in + (long long)ml * C * SEG;
      for (int i = tid; i < C * SEG; i += NT) {
        const int h = rslot[i];
        if (h >= 0) xe[Rint + h] = cy[i];
      }
      __syncthreads();
    }
    // ---- residual, its norm over owned rows, solver start vectors
    // (b and mi stream from device memory: kRowsInFlight rows' loads in
    // flight, the rows in the plain loop's order)
    float* r = vec(1);
    double acc[2] = {0.0, 0.0};
    for_rows(
        ClusterTeamT<NT>{0, Rext, nullptr, 0},
        [&](int q) {
          return Vals<4>{{A_row(std::false_type{}, xe, q), b[q], mi[q],
                          dv[q]}};
        },
        [&](int q, Vals<4> l) {
          const float rq = l.v[1] - l.v[0];
          r[q] = rq;
          const float m = l.v[2] * rq;
          acc[0] += (double)(m * m);
          if (!a.nonsym) {
            const float s0 = l.v[3] * rq;
            vec(2)[q] = s0;   // p
            vec(3)[q] = 0.f;  // z
            acc[1] += (double)(rq * s0);
          } else {
            acc[1] += (double)(rq * rq);
            vec(2)[q] = 0.f;  // zz
            vec(3)[q] = rq;   // rr
            vec(4)[q] = 0.f;  // p
            vec(5)[q] = 0.f;  // v
          }
        });
    block_sum<NT>(acc, red);
    rn = (float)acc[0];
    rn0 = rn0 < 0.f ? rn : rn0;
    const float myconv = rn <= a.tol2 * rn0 ? 1.f : 0.f;
    float kn = 0.f;
    if (tid < kLanes) {
      kn = fmaxf(known[tid], tid == me ? myconv : 0.f);
      known[tid] = kn;
    }
    const bool all_known =
        __syncthreads_count(tid < kLanes && kn >= 1.f) == kLanes;
    const bool frozen = done_at >= 0.f || all_known;

    // ---- correction solve z ~= A_solve^-1 r on all rows, added to the
    // owned rows
    if (!frozen) {
      const float* z;
      if (!a.nonsym) {
        jacobi_pcg<NT>(A_solve, Rext, a.ninner, (float)acc[1], r, vec(2),
                       vec(3), vec(4), dv, red);
        z = vec(3);
      } else {
        // acc[1] is dot(r, rr) with rr = r
        jacobi_bicgstab<NT>(A_solve, Rext, a.ninner, (float)acc[1], r,
                            vec(2), vec(3), vec(4), vec(5), vec(6), vec(7),
                            dv, red);
        z = vec(2);
      }
      for (int q = tid; q < Rint; q += NT) xe[q] = xe[q] + z[q];
    }
    if (done_at < 0.f && all_known) done_at = base_t + (float)t;
    __syncthreads();  // xe and known are read by the next round's pack
  }

  // ---- the last B messages were sent but not consumed: their flags are
  // still gossip, and the values of message T-1 are the next launch's carry
  for (int n = T - B > 0 ? T - B : 0; n < T; ++n) {
    await_messages(n, kWaitDrain);
    merge_flags(n % M);
  }
  {
    const int jl = (T - 1) % M;
    float* cy = a.carry_out + (long long)ml * C * SEG;
    for (int c = 0; c < C; ++c) {
      const float* m = tgt[c] != me ? slot(tgt[c], c, jl) : nullptr;
      for (int k = tid; k < SEG; k += NT)
        cy[c * SEG + k] = m != nullptr ? __ldcg(m + k) : 0.f;
    }
  }
  __syncthreads();
  for (int q = tid; q < Rint; q += NT)
    a.x_out[(long long)ml * Rint + q] = xe[q];
  for (int l = tid; l < kLanes; l += NT) {
    a.known_out[ml * kLanes + l] = known[l];
    float v = a.aux_in[ml * kLanes + l];
    if (l == 0) v = rn0;
    if (l == 1) v = done_at;
    if (l == 2) v = base_t + (float)T;
    if (l == 3) v = rn;
    a.aux_out[ml * kLanes + l] = v;
  }
}

// Calls f(kernel) for the variant (shared memory when smem > 0), the ELL
// width and whether the ranks span processes, after allowing it smem bytes
// of dynamic shared memory.
template <class F>
int with_kernel(int K, int smem, bool cross, F&& f) {
  auto go = [&](auto* fn) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return e != cudaSuccess ? (int)e : f(fn);
  };
  // across processes the time slices bound a round: one kernel with K at
  // run time keeps the build short
  if (cross)
    return smem > 0 ? go(&async_general_kernel<true, 0, true>)
                    : go(&async_general_kernel<false, 0, true>);
  auto pick = [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    return smem > 0 ? go(&async_general_kernel<true, KC, false>)
                    : go(&async_general_kernel<false, KC, false>);
  };
  return K == 5   ? pick(std::integral_constant<int, 5>{})
         : K == 9 ? pick(std::integral_constant<int, 9>{})
                  : pick(std::integral_constant<int, 0>{});
}

}  // namespace

extern "C" {

// Threads a block of the variant with smem bytes of dynamic shared memory
// (0: the global-memory variant).
int async_general_threads(int smem) { return block_threads(smem > 0); }

// Co-resident blocks of the kernel for ELL width K with smem bytes of
// dynamic shared memory (0: the global-memory variant) on this card: the
// largest rank count a cooperative launch can hold (0 without cooperative
// launch support or when the card refuses the size).
int async_general_max_ranks(int K, int smem) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop || smem < 0) return 0;
  const int e = with_kernel(K, smem, false, [&](auto fn) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, block_threads(smem > 0), smem);
  });
  if (e != 0) {
    cudaGetLastError();  // a refused size is not a launch error
    return 0;
  }
  return per_sm * sms;
}

// See ops/async_ras_general_kernel.py for the operand layout: the per-rank
// operands hold this process's Sl ranks, which start at ``first``.
// ``table`` (P,) holds every process's window (the rings, then the sequence
// words, acks and error word at the byte offsets, zeroed by the caller
// before the launch; in one process ``table`` is not read and ``own`` is
// the process's window).  smem > 0 runs the shared-memory variant with smem
// bytes (then ``work`` may be null), 0 the global-memory variant.
int async_general_f32(const int* cols, const float* vals, const float* b,
                      const float* dinv, const float* mi, const float* boost,
                      const int* send_idx, const int* recv_slot,
                      const int* tgt, const float* x_in,
                      const float* known_in, const float* aux_in,
                      const float* carry_in, float* x, float* known,
                      float* aux, float* carry, float* work,
                      const void* table, void* own, long long seq_off,
                      long long ack_off, long long err_off, int S, int Sl,
                      int first, int Rint,
                      int H, int K, int SEG, int C, int T, int B, int ninner,
                      int nonsym, float tol2, int smem, void* stream) {
  if (S < 1 || S > kLanes || Sl < 1 || S % Sl || first % Sl || first >= S ||
      T < 1 || B < 1 || Rint < 1 || H < 0 || K < 1 || SEG < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  const int Rext = Rint + H;
  const int nwork = nonsym ? 8 : 5;
  if (smem > 0 &&
      (Rext > 65535 || smem < SmemLayout(nwork, K, Rext).total))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.cols = cols;
  a.vals = vals;
  a.b = b;
  a.dinv = dinv;
  a.mi = mi;
  a.boost = boost;
  a.send_idx = send_idx;
  a.recv_slot = recv_slot;
  a.tgt = tgt;
  a.x_in = x_in;
  a.known_in = known_in;
  a.aux_in = aux_in;
  a.carry_in = carry_in;
  a.x_out = x;
  a.known_out = known;
  a.aux_out = aux;
  a.carry_out = carry;
  a.work = work;
  a.S = S;
  a.Rint = Rint;
  a.H = H;
  a.Rext = Rext;
  a.K = K;
  a.SEG = SEG;
  a.C = C;
  a.T = T;
  a.B = B;
  a.M = 2 * B + 2;
  a.ninner = ninner;
  a.nonsym = nonsym;
  a.nwork = nwork;
  a.slot = SEG + kLanes;
  a.tol2 = tol2;
  char* w = static_cast<char*>(own);
  a.ring = reinterpret_cast<float*>(w);
  a.seq = reinterpret_cast<unsigned long long*>(w + seq_off);
  a.ack = reinterpret_cast<unsigned int*>(w + ack_off);
  a.err = reinterpret_cast<int*>(w + err_off);
  const WithRings<Args> c{a, make_rings(table, own, seq_off, ack_off,
                                        err_off, Sl, C, a.M, a.slot, first)};
  void* params[] = {Sl != S ? (void*)&c : (void*)&a};
  return with_kernel(K, smem, Sl != S, [&](auto fn) {
    return (int)cudaLaunchCooperativeKernel(
        (const void*)fn, dim3(Sl), dim3(block_threads(smem > 0)), params, smem,
        (cudaStream_t)stream);
  });
}

}  // extern "C"
