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
// Layout.  One 1024-thread block per rank, launched cooperatively so that
// all S ranks are resident at once: a rank spins on its partners.  The
// operator is padded ELL, planes first: cols and vals (S, K, Rext), the
// entries of a row in slot order, a row's product summed in that order in
// float32.  The TPU kernel's dense operators, one-hot pack and unpack
// matrices and lane-replicated tiles turn gathers into matrix products
// there; here packing and unpacking are indexed loads and stores.
//
// Sums.  Dot products are block reductions of float32 products summed in
// float64 and rounded once, and this file is built with -fmad=false, as the
// 1-D and 2-D kernels are: the plain PyTorch version does the same, so card
// and CPU detect convergence at the same round.  A frozen rank skips its
// correction solve.
//
// Messages.  Each (rank, colour) owns a ring of M = 2B+2 slots: SEG values,
// the 128 known lanes and a 64-bit sequence word; the partner reads it.  The
// producer writes a slot with all threads, __syncthreads, then thread 0
// fences and release-stores t+1; ALL colours are published before any
// message is awaited, or a cycle of ranks could deadlock.  The consumer's
// thread 0 spins with acquire loads, __syncthreads, the block reads with
// __ldcg and thread 0 credits the producer's ack counter; a producer waits
// for ack >= t-M+1 before it reuses a slot at t >= M.  A colour on which a
// rank has no link carries nothing: its message would come back to the rank
// itself with the rank's own bits.  Sequence words, acks and the error word
// are zeroed by the caller before each launch.  Every spin is bounded by
// clock64(): on timeout the error word is set, all spins leave and the
// wrapper raises.
//
// Bound on the card: cols, vals, b, dinv, mask_int and x read once and x
// written once, against T * (ninner + 1) * (2K + 13) float32 operations per
// extended row; at S = 128, Rext = 2048, K = 9 the operations bound it.  With
// one SM per rank, work vectors in device memory and a gather per entry this
// first version is far from that bound by design.
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
  float* work;  // (S, nwork, Rext)
  float* ring;  // (S, C, M, slot)
  unsigned long long* seq;  // (S, C, M)
  unsigned int* ack;        // (S, C)
  int* err;
  int S, Rint, H, Rext, K, SEG, C, T, B, M, ninner, nonsym, nwork, slot;
  float tol2;
};

__global__ void __launch_bounds__(kThreads, 1)
    async_general_kernel(const Args a) {
  __shared__ float known[kLanes];
  __shared__ double red[3 * kWarps + 4];

  const int tid = threadIdx.x;
  const int me = blockIdx.x;
  const int S = a.S, T = a.T, B = a.B, M = a.M, C = a.C, K = a.K;
  const int Rint = a.Rint, Rext = a.Rext, SEG = a.SEG;
  const long long eb = (long long)me * K * Rext;
  const int* cols = a.cols + eb;
  const float* vals = a.vals + eb;
  const long long vb = (long long)me * Rext;
  const float* b = a.b + vb;
  const float* dv = a.dinv + vb;
  const float* mi = a.mi + vb;
  const float* bo = a.boost != nullptr ? a.boost + vb : nullptr;
  const int* sidx = a.send_idx + (long long)me * C * SEG;
  const int* rslot = a.recv_slot + (long long)me * C * SEG;
  const int* tgt = a.tgt + me * C;
  float* W = a.work + (long long)me * a.nwork * Rext;
  auto vec = [&](int i) { return W + (long long)i * Rext; };
  float* xe = vec(0);  // [owned rows, halo]
  auto slot = [&](int rank, int c, int j) {
    return a.ring + (((long long)rank * C + c) * M + j) * a.slot;
  };
  auto seq = [&](int rank, int c, int j) {
    return a.seq + ((long long)rank * C + c) * M + j;
  };
  auto ack = [&](int rank, int c) { return a.ack + rank * C + c; };
  // row q of A v, or of A (dv * v) when scaled; with the O-RAS diagonal
  auto A_solve = [&](auto scaled, const float* v, int q) {
    auto at = [&](int i) {
      return decltype(scaled)::value ? dv[i] * v[i] : v[i];
    };
    float acc = vals[q] * at(cols[q]);
    for (int k = 1; k < K; ++k)
      acc = acc + vals[k * Rext + q] * at(cols[k * Rext + q]);
    if (bo != nullptr) acc = acc + bo[q] * at(q);
    return acc;
  };
  // the values of my partners' messages in ring slot j into my halo
  auto unpack_values = [&](int j) {
    for (int c = 0; c < C; ++c) {
      if (tgt[c] == me) continue;
      const float* m = slot(tgt[c], c, j);
      for (int k = tid; k < SEG; k += kThreads) {
        const int h = rslot[c * SEG + k];
        if (h >= 0) xe[Rint + h] = __ldcg(m + k);
      }
    }
  };
  auto merge_flags = [&](int j) {
    if (tid < kLanes) {
      float k = known[tid];
      for (int c = 0; c < C; ++c)
        if (tgt[c] != me) k = fmaxf(k, __ldcg(slot(tgt[c], c, j) + SEG + tid));
      known[tid] = k;
    }
  };
  // thread 0: wait until every partner's message n has arrived
  auto await_messages = [&](int n, int code) {
    if (tid == 0) {
      for (int c = 0; c < C; ++c) {
        if (tgt[c] == me) continue;
        if (!spin_until(seq(tgt[c], c, n % M), (unsigned long long)n + 1,
                        a.err, code))
          break;
      }
    }
    __syncthreads();
  };

  for (int l = tid; l < kLanes; l += kThreads)
    known[l] = fmaxf(a.known_in[me * kLanes + l], l >= S ? 1.f : 0.f);
  for (int i = tid; i < Rext; i += kThreads)
    xe[i] = i < Rint ? a.x_in[(long long)me * Rint + i] : 0.f;
  float rn0 = a.aux_in[me * kLanes + 0];
  float done_at = a.aux_in[me * kLanes + 1];
  const float base_t = a.aux_in[2];  // rank 0's round counter
  float rn = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int j = t % M;
    // ---- flow control: slot j is free once its last message was acked
    if (t >= M) {
      if (tid == 0) {
        const unsigned int want = t - M + 1;
        for (int c = 0; c < C; ++c) {
          if (tgt[c] == me) continue;
          if (!spin_until(ack(me, c), want, a.err, kWaitAck)) break;
        }
      }
      __syncthreads();
    }
    // ---- pack and publish one message per colour with the known bits
    for (int c = 0; c < C; ++c) {
      if (tgt[c] == me) continue;
      float* m = slot(me, c, j);
      for (int k = tid; k < SEG; k += kThreads) {
        const int i = sidx[c * SEG + k];
        m[k] = i >= 0 ? xe[i] : 0.f;
      }
      if (tid < kLanes) m[SEG + tid] = known[tid];
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      for (int c = 0; c < C; ++c)
        if (tgt[c] != me) st_release(seq(me, c, j), (unsigned long long)t + 1);
    }
    // ---- consume the partners' messages of round t - B, or the carry
    if (t >= B) {
      const int u = t - B;
      await_messages(u, kWaitMessage);
      unpack_values(u % M);
      merge_flags(u % M);
      __syncthreads();
      if (tid == 0)
        for (int c = 0; c < C; ++c)
          if (tgt[c] != me) red_release_add(ack(tgt[c], c), 1u);
    } else {
      const float* cy = a.carry_in + (long long)me * C * SEG;
      for (int i = tid; i < C * SEG; i += kThreads) {
        const int h = rslot[i];
        if (h >= 0) xe[Rint + h] = cy[i];
      }
      __syncthreads();
    }
    // ---- residual, its norm over owned rows, solver start vectors
    float* r = vec(1);
    double acc[2] = {0.0, 0.0};
    for (int q = tid; q < Rext; q += kThreads) {
      float ax = vals[q] * xe[cols[q]];
      for (int k = 1; k < K; ++k)
        ax = ax + vals[k * Rext + q] * xe[cols[k * Rext + q]];
      const float rq = b[q] - ax;
      r[q] = rq;
      const float m = mi[q] * rq;
      acc[0] += (double)(m * m);
      if (!a.nonsym) {
        const float s0 = dv[q] * rq;
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
    }
    block_sum(acc, red);
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
        jacobi_pcg(A_solve, Rext, a.ninner, (float)acc[1], r, vec(2), vec(3),
                   vec(4), dv, red);
        z = vec(3);
      } else {
        // acc[1] is dot(r, rr) with rr = r
        jacobi_bicgstab(A_solve, Rext, a.ninner, (float)acc[1], r, vec(2),
                        vec(3), vec(4), vec(5), vec(6), vec(7), dv, red);
        z = vec(2);
      }
      for (int q = tid; q < Rint; q += kThreads) xe[q] = xe[q] + z[q];
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
    float* cy = a.carry_out + (long long)me * C * SEG;
    for (int c = 0; c < C; ++c) {
      const float* m = tgt[c] != me ? slot(tgt[c], c, jl) : nullptr;
      for (int k = tid; k < SEG; k += kThreads)
        cy[c * SEG + k] = m != nullptr ? __ldcg(m + k) : 0.f;
    }
  }
  __syncthreads();
  for (int q = tid; q < Rint; q += kThreads)
    a.x_out[(long long)me * Rint + q] = xe[q];
  for (int l = tid; l < kLanes; l += kThreads) {
    a.known_out[me * kLanes + l] = known[l];
    float v = a.aux_in[me * kLanes + l];
    if (l == 0) v = rn0;
    if (l == 1) v = done_at;
    if (l == 2) v = base_t + (float)T;
    if (l == 3) v = rn;
    a.aux_out[me * kLanes + l] = v;
  }
}

}  // namespace

extern "C" {

// Co-resident blocks of the kernel on this card: the largest rank count a
// cooperative launch can hold (0 without cooperative launch support).
int async_general_max_ranks() {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, async_general_kernel, kThreads, 0) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

// See ops/async_ras_general_kernel.py for the operand layout.  ``sync``
// holds the (S, C, M) sequence words, the (S, C) ack counters (padded to a
// whole 64-bit word) and the error word, zeroed by the caller before the
// launch.
int async_general_f32(const int* cols, const float* vals, const float* b,
                      const float* dinv, const float* mi, const float* boost,
                      const int* send_idx, const int* recv_slot,
                      const int* tgt, const float* x_in,
                      const float* known_in, const float* aux_in,
                      const float* carry_in, float* x, float* known,
                      float* aux, float* carry, float* work, float* ring,
                      void* sync, int S, int Rint, int H, int K, int SEG,
                      int C, int T, int B, int ninner, int nonsym,
                      float tol2, void* stream) {
  if (S < 1 || S > kLanes || T < 1 || B < 1 || Rint < 1 || H < 0 || K < 1 ||
      SEG < 1 || C < 1)
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
  a.ring = ring;
  a.S = S;
  a.Rint = Rint;
  a.H = H;
  a.Rext = Rint + H;
  a.K = K;
  a.SEG = SEG;
  a.C = C;
  a.T = T;
  a.B = B;
  a.M = 2 * B + 2;
  a.ninner = ninner;
  a.nonsym = nonsym;
  a.nwork = nonsym ? 8 : 5;
  a.slot = SEG + kLanes;
  a.tol2 = tol2;
  auto* s = static_cast<unsigned long long*>(sync);
  const long long nseq = (long long)S * C * a.M;
  const long long nack = ((long long)S * C + 1) / 2;
  a.seq = s;
  a.ack = reinterpret_cast<unsigned int*>(s + nseq);
  a.err = reinterpret_cast<int*>(s + nseq + nack);
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)async_general_kernel,
                                          dim3(S), dim3(kThreads), params, 0,
                                          (cudaStream_t)stream);
}

}  // extern "C"
