// K6: free-running asynchronous RAS rounds on a 2-D block grid, one launch
// for T rounds of all ranks, with no barrier between ranks.
//
// Replaces schwarz_tpu/ops/async_ras_2d.py async_ras_2d_rounds (:232).  The
// ranks form a cyclic pdx x pdy grid; a rank owns a (ply, plx) sub-grid of
// blocks folded into one row-major (FY, FX) tile, FY = ply*By, FX = plx*Bx,
// each block carrying a halo of HX columns and HY rows.  Per round a rank
//   - refreshes the halos between its own windows from the tile as it was
//     before the round (only when it holds more than one window),
//   - packs its four edge strips (columns HX:2HX and FX-2HX:FX-HX over the
//     full height, rows HY:2HY and FY-2HY:FY-HY over the full width) with its
//     known-converged bits into slot rings,
//   - at t >= B consumes its four neighbours' messages of round t-B: the
//     left/right strips land in columns 0:HX and FX-HX:FX, the up/down strips
//     in rows 0:HY and FY-HY:FY over the full width, so the up/down strips
//     own the corner cells and corner data arrives two hops late; in the
//     warm-up rounds t < B nothing is unpacked (the halos in the tile are the
//     state carried between launches),
//   - computes the masked residual of the 9-point operator, its ||r||^2 over
//     the owned cells of the whole tile and the convergence bit, merges the
//     gossip, runs its correction solve (Jacobi-PCG or BiCGStab, with the
//     O-RAS Robin diagonal when given) and adds the correction on owned cells
//     unless it knows every rank converged.
// After T rounds the message of round T-1 is unpacked once more.
//
// Layout.  One 1024-thread block per rank, launched cooperatively so that
// all D ranks are resident at once: a rank spins on its neighbours.  The
// operator is (D, 9, FY, FX): centre, E, W, S, N, SE, SW, NE, NW.  The
// shifted reads wrap cyclically over the tile; every wrapped or cross-window
// read meets a zero coefficient, since the outermost ring of each window is
// outside every solve domain.  Halo cells are written in place: the TPU
// kernel's lane-padded messages and its rebuilding of the tile by
// concatenation have no counterpart here.  The refresh between a rank's own
// windows reads full-length strips that include the source window's own halo
// rows, which are targets of the same refresh, so the new halo values are
// staged in a work vector before any is written.
//
// Sums.  Dot products are block reductions of float32 products summed in
// float64 and rounded once, and this file is built with -fmad=false, as the
// 1-D kernel (async_ras.cu) is: the plain PyTorch version does the same, so
// card and CPU detect convergence at the same round.  The step sizes of the
// correction solve are shared over the folded tile.  A frozen rank skips its
// correction solve.
//
// Messages.  Each (rank, direction) owns a ring of M = 2B+2 slots: the strip,
// the 128 known lanes and a 64-bit sequence word; directions 0..3 carry the
// left, right, top and bottom strips to the left, right, upper and lower
// rank.  What a rank unpacks into its left halo is therefore its left
// neighbour's direction-1 ring.  The producer writes a slot with all
// threads, __syncthreads, then thread 0 fences and release-stores t+1; all
// four directions are published before any message is awaited.  The
// consumer's thread 0 spins with acquire loads, __syncthreads, the block
// reads with __ldcg and thread 0 credits the producer's ack counter; a
// producer waits for ack >= t-M+1 before it reuses a slot at t >= M.
// Sequence words, acks and the error word are zeroed by the caller before
// each launch.  Every spin is bounded by clock64(): on timeout the error
// word is set, all spins leave and the wrapper raises.
//
// fresh_read: per direction thread 0 peeks the sequence words of the B-1
// newer slots and takes the newest message that has fully arrived.
//
// Bound on the card: coef, b, dinv, both masks and the tile read once and the
// tile written once (14 floats per cell), against T * ninner * (2*P + 13)
// float32 operations per cell for a P-point operator; at the 1M-row slice
// the operations bound it.  With one SM per rank this first version is far
// from that bound by design.
#include "async_common.cuh"

namespace {

struct Args {
  const float* coef;  // (D, 9, FY, FX)
  const float* b;     // (D, FY, FX), as dinv, md, mi, boost, x
  const float* dinv;
  const float* md;
  const float* mi;
  const float* boost;  // may be null
  const float* x_in;
  const float* known_in;  // (D, 128)
  const float* aux_in;
  float* x;
  float* known_out;
  float* aux_out;
  float* work;  // (D, nwork, FY*FX)
  float* ring;  // (D, 4, M, slot)
  unsigned long long* seq;  // (D, 4, M)
  unsigned int* ack;        // (D, 4)
  int* err;
  int D, pdx, pdy, ply, plx, By, Bx, HY, HX, T, B, M, ninner, nonsym, fresh;
  int slot, pay, nwork;
  float tol2;
};

enum Dir { kL = 0, kR = 1, kU = 2, kD = 3 };

// Row q = (y, x) of the stencil product over the folded tile:
// sum_k c[k, q] * (scale ? dv * v : v)[shift_k(q)], the shifts wrapping.
// NP is 5 when the four diagonal planes are all zero, else 9: a zero plane
// adds +-0 and changes no sum.
template <int NP, bool kScale>
__device__ __forceinline__ float stencil_row(const float* __restrict__ c,
                                             const float* v,
                                             const float* __restrict__ dv,
                                             int q, int FY, int FX) {
  const int n = FY * FX;
  const int y = q / FX, x = q - y * FX;
  const int e = x == FX - 1 ? q - (FX - 1) : q + 1;
  const int w = x == 0 ? q + (FX - 1) : q - 1;
  const int ds = y == FY - 1 ? FX - n : FX;   // to row y+1
  const int dn = y == 0 ? n - FX : -FX;       // to row y-1
  auto at = [&](int i) { return kScale ? dv[i] * v[i] : v[i]; };
  float acc = c[q] * at(q);
  acc = acc + c[n + q] * at(e);
  acc = acc + c[2 * n + q] * at(w);
  acc = acc + c[3 * n + q] * at(q + ds);
  acc = acc + c[4 * n + q] * at(q + dn);
  if (NP == 9) {
    acc = acc + c[5 * n + q] * at(e + ds);
    acc = acc + c[6 * n + q] * at(w + ds);
    acc = acc + c[7 * n + q] * at(e + dn);
    acc = acc + c[8 * n + q] * at(w + dn);
  }
  return acc;
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
    async_ras_2d_kernel(const Args a) {
  __shared__ float known[kLanes];
  __shared__ double red[3 * kWarps + 4];
  __shared__ int src[4];

  const int tid = threadIdx.x;
  const int me = blockIdx.x;
  const int D = a.D, T = a.T, B = a.B, M = a.M;
  const int HX = a.HX, HY = a.HY, By = a.By, Bx = a.Bx;
  const int FY = a.ply * By, FX = a.plx * Bx, n = FY * FX;
  const int nLR = FY * HX, nUD = HY * FX;
  const int dyy = me / a.pdx, dxx = me % a.pdx;
  // the rank grid is cyclic; with one rank in a direction a rank is its own
  // neighbour there
  const int nb[4] = {dyy * a.pdx + (dxx + a.pdx - 1) % a.pdx,
                     dyy * a.pdx + (dxx + 1) % a.pdx,
                     (dyy + a.pdy - 1) % a.pdy * a.pdx + dxx,
                     (dyy + 1) % a.pdy * a.pdx + dxx};
  // what lands in my left halo is the left rank's right strip, and so on
  const int from[4] = {kR, kL, kD, kU};
  const long long vb = (long long)me * n;
  const float* coef = a.coef + vb * 9;
  const float* bo = a.boost != nullptr ? a.boost + vb : nullptr;
  const float* b = a.b + vb;
  const float* dv = a.dinv + vb;
  const float* md = a.md + vb;
  const float* mi = a.mi + vb;
  float* x = a.x + vb;
  float* W = a.work + (long long)me * a.nwork * n;
  auto vec = [&](int i) { return W + (long long)i * n; };
  auto slot = [&](int rank, int dir, int j) {
    return a.ring + (((long long)rank * 4 + dir) * M + j) * a.slot;
  };
  auto seq = [&](int rank, int dir, int j) {
    return a.seq + ((long long)rank * 4 + dir) * M + j;
  };
  auto ack = [&](int rank, int dir) { return a.ack + rank * 4 + dir; };
  auto A_solve = [&](auto scaled, const float* v, int q) {
    float s = md[q] * stencil_row<NP, decltype(scaled)::value>(coef, v, dv, q,
                                                               FY, FX);
    if (bo != nullptr)
      s += bo[q] * (decltype(scaled)::value ? dv[q] * v[q] : v[q]);
    return s;
  };
  // Halos of the rank's edge windows from four messages: up/down strips
  // over the full width first in priority, left/right strips on the rows
  // between them; then the messages' known bits.
  auto unpack = [&](const float* const (&m)[4]) {
    for (int i = tid; i < 2 * nUD; i += kThreads) {
      const bool top = i < nUD;
      x[top ? i : (FY - 2 * HY) * FX + i] =
          __ldcg(top ? m[kU] + i : m[kD] + i - nUD);
    }
    for (int i = tid; i < (FY - 2 * HY) * 2 * HX; i += kThreads) {
      const int y = HY + i / (2 * HX), c = i % (2 * HX);
      x[y * FX + (c < HX ? c : FX - 2 * HX + c)] =
          __ldcg(c < HX ? m[kL] + y * HX + c : m[kR] + y * HX + c - HX);
    }
    if (tid < kLanes) {
      float k = known[tid];
      for (int d = 0; d < 4; ++d) k = fmaxf(k, __ldcg(m[d] + a.pay + tid));
      known[tid] = k;
    }
    __syncthreads();
  };

  for (int l = tid; l < kLanes; l += kThreads)
    known[l] = fmaxf(a.known_in[me * kLanes + l], l >= D ? 1.f : 0.f);
  for (int i = tid; i < n; i += kThreads) x[i] = a.x_in[vb + i];
  float rn0 = a.aux_in[me * kLanes + 0];
  float done_at = a.aux_in[me * kLanes + 1];
  const float base_t = a.aux_in[me * kLanes + 2];
  float hits = fmaxf(a.aux_in[me * kLanes + 4], 0.f);  // thread 0's count
  float rn = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int j = t % M;
    // ---- halos between the rank's own windows, from the tile as it is now:
    // stage every new halo value, then write them
    if (a.ply > 1 || a.plx > 1) {
      float* stage = vec(a.nwork - 1);
      auto source = [&](int q) {
        const int y = q / FX, c = q - y * FX;
        const int wy = y / By, ly = y - wy * By;
        const int wx = c / Bx, lx = c - wx * Bx;
        if (ly < HY && wy > 0) return q - 2 * HY * FX;
        if (ly >= By - HY && wy < a.ply - 1) return q + 2 * HY * FX;
        if (lx < HX && wx > 0) return q - 2 * HX;
        if (lx >= Bx - HX && wx < a.plx - 1) return q + 2 * HX;
        return q;
      };
      for (int q = tid; q < n; q += kThreads) {
        const int s = source(q);
        if (s != q) stage[q] = x[s];
      }
      __syncthreads();
      for (int q = tid; q < n; q += kThreads)
        if (source(q) != q) x[q] = stage[q];
      __syncthreads();
    }
    // ---- flow control: slot j is free once its last message was acked
    if (t >= M) {
      if (tid == 0) {
        const unsigned int want = t - M + 1;
        for (int d = 0; d < 4; ++d)
          if (!spin_until(ack(me, d), want, a.err, kWaitAck)) break;
      }
      __syncthreads();
    }
    // ---- pack and publish the four edge strips with the known bits
    {
      float* sl = slot(me, kL, j);
      float* sr = slot(me, kR, j);
      float* su = slot(me, kU, j);
      float* sd = slot(me, kD, j);
      for (int i = tid; i < nLR; i += kThreads) {
        const int y = i / HX, c = i - y * HX;
        sl[i] = x[y * FX + HX + c];
        sr[i] = x[y * FX + FX - 2 * HX + c];
      }
      for (int i = tid; i < nUD; i += kThreads) {
        su[i] = x[HY * FX + i];
        sd[i] = x[(FY - 2 * HY) * FX + i];
      }
      if (tid < kLanes) {
        const float k = known[tid];
        sl[a.pay + tid] = k;
        sr[a.pay + tid] = k;
        su[a.pay + tid] = k;
        sd[a.pay + tid] = k;
      }
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        for (int d = 0; d < 4; ++d)
          st_release(seq(me, d, j), (unsigned long long)t + 1);
      }
    }
    // ---- consume the neighbours' messages of round t - B
    if (t >= B) {
      if (tid == 0) {
        const int u = t - B;
        for (int d = 0; d < 4; ++d) {
          src[d] = u % M;
          if (!spin_until(seq(nb[d], from[d], u % M),
                          (unsigned long long)u + 1, a.err, kWaitMessage))
            break;
        }
        if (a.fresh && B > 1) {
          for (int d = 0; d < 4; ++d) {
            for (int k = 1; k < B; ++k) {
              const int un = u + k;
              if (ld_acquire(seq(nb[d], from[d], un % M)) >=
                  (unsigned long long)un + 1) {
                src[d] = un % M;
                hits += 1.f;
              }
            }
          }
        }
      }
      __syncthreads();
      const float* const m[4] = {
          slot(nb[kL], kR, src[kL]), slot(nb[kR], kL, src[kR]),
          slot(nb[kU], kD, src[kU]), slot(nb[kD], kU, src[kD])};
      unpack(m);
      if (tid == 0)
        for (int d = 0; d < 4; ++d) red_release_add(ack(nb[d], from[d]), 1u);
    }
    // ---- masked residual, its norm over owned cells, solver start vectors
    float* r = vec(0);
    double acc[2] = {0.0, 0.0};
    for (int q = tid; q < n; q += kThreads) {
      const float rq =
          md[q] * (b[q] - stencil_row<NP, false>(coef, x, dv, q, FY, FX));
      r[q] = rq;
      const float m = mi[q] * rq;
      acc[0] += (double)(m * m);
      if (!a.nonsym) {
        const float s0 = dv[q] * rq;
        vec(1)[q] = s0;   // p
        vec(2)[q] = 0.f;  // z
        acc[1] += (double)(rq * s0);
      } else {
        acc[1] += (double)(rq * rq);
        vec(1)[q] = 0.f;  // zz
        vec(2)[q] = rq;   // rr
        vec(3)[q] = 0.f;  // p
        vec(4)[q] = 0.f;  // v
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

    // ---- correction solve z ~= A_solve^-1 r, added on owned cells
    if (!frozen) {
      const float* z;
      if (!a.nonsym) {
        jacobi_pcg(A_solve, n, a.ninner, (float)acc[1], r, vec(1), vec(2),
                   vec(3), dv, red);
        z = vec(2);
      } else {
        // acc[1] is dot(r, rr) with rr = r
        jacobi_bicgstab(A_solve, n, a.ninner, (float)acc[1], r, vec(1),
                        vec(2), vec(3), vec(4), vec(5), vec(6), dv, red);
        z = vec(1);
      }
      for (int q = tid; q < n; q += kThreads)
        if (mi[q] != 0.f) x[q] = x[q] + mi[q] * z[q];
    }
    if (done_at < 0.f && all_known) done_at = base_t + (float)t;
    __syncthreads();  // x and known are read by the next round's pack
  }

  // ---- the message of round T-1 was sent but not consumed: its strips are
  // the halos, and its flags the gossip, carried to the next launch
  {
    const int jl = (T - 1) % M;
    if (tid == 0) {
      for (int d = 0; d < 4; ++d)
        if (!spin_until(seq(nb[d], from[d], jl), (unsigned long long)T,
                        a.err, kWaitDrain))
          break;
    }
    __syncthreads();
    const float* const m[4] = {slot(nb[kL], kR, jl), slot(nb[kR], kL, jl),
                               slot(nb[kU], kD, jl), slot(nb[kD], kU, jl)};
    unpack(m);
  }
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

template <class F>
int dispatch_points(int points, F&& f) {
  return points == 5 ? f(std::integral_constant<int, 5>{})
                     : f(std::integral_constant<int, 9>{});
}

}  // namespace

extern "C" {

// Co-resident blocks of the kernel on this card: the largest rank count a
// cooperative launch can hold (0 without cooperative launch support).
int async_ras_2d_max_ranks(int points) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return 0;
  const int e = dispatch_points(points, [&](auto np) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, async_ras_2d_kernel<decltype(np)::value>, kThreads, 0);
  });
  return e == 0 ? per_sm * sms : 0;
}

// See ops/async_ras_2d_kernel.py for the operand layout.  ``sync`` holds the
// (D, 4, M) sequence words, the (D, 4) ack counters and the error word,
// zeroed by the caller before the launch; ``points`` is 5 when the four
// diagonal planes of ``coef`` are all zero, else 9.
int async_ras_2d_f32(const float* coef, const float* b, const float* dinv,
                     const float* md, const float* mi, const float* boost,
                     const float* x_in, const float* known_in,
                     const float* aux_in, float* x, float* known, float* aux,
                     float* work, float* ring, void* sync, int pdx, int pdy,
                     int ply, int plx, int By, int Bx, int HY, int HX, int T,
                     int B, int ninner, int nonsym, int fresh, int points,
                     float tol2, void* stream) {
  const int D = pdx * pdy;
  if (D < 1 || D > kLanes || T < 1 || B < 1 || ply < 1 || plx < 1 ||
      By <= 2 * HY || Bx <= 2 * HX || (points != 5 && points != 9))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.coef = coef;
  a.b = b;
  a.dinv = dinv;
  a.md = md;
  a.mi = mi;
  a.boost = boost;
  a.x_in = x_in;
  a.known_in = known_in;
  a.aux_in = aux_in;
  a.x = x;
  a.known_out = known;
  a.aux_out = aux;
  a.work = work;
  a.ring = ring;
  a.D = D;
  a.pdx = pdx;
  a.pdy = pdy;
  a.ply = ply;
  a.plx = plx;
  a.By = By;
  a.Bx = Bx;
  a.HY = HY;
  a.HX = HX;
  a.T = T;
  a.B = B;
  a.M = 2 * B + 2;
  a.ninner = ninner;
  a.nonsym = nonsym;
  a.fresh = fresh;
  const int nLR = ply * By * HX, nUD = HY * plx * Bx;
  a.pay = (nLR > nUD ? nLR : nUD);
  a.slot = a.pay + kLanes;
  a.nwork = (nonsym ? 7 : 4) + (ply * plx > 1 ? 1 : 0);
  a.tol2 = tol2;
  auto* s = static_cast<unsigned long long*>(sync);
  a.seq = s;
  a.ack = reinterpret_cast<unsigned int*>(s + (long long)D * 4 * a.M);
  a.err = reinterpret_cast<int*>(s + (long long)D * 4 * a.M + D * 2);
  return dispatch_points(points, [&](auto np) {
    void* params[] = {&a};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)async_ras_2d_kernel<decltype(np)::value>, dim3(D),
        dim3(kThreads), params, 0, (cudaStream_t)stream);
  });
}

}  // extern "C"
