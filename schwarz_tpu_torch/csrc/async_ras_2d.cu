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
// Layout.  A rank is a cluster of C thread blocks of 512 threads on C SMs
// (C from 1 to 8, chosen by the wrapper), launched cooperatively with a
// cluster dimension so that all D ranks are resident at once: a rank spins
// on its neighbours.  Block c of the cluster owns the band of tile rows
// [c*band, (c+1)*band) and every cell of it, in every vector: it alone
// writes them (the tile's halo cells included: a strip is unpacked, and a
// halo refreshed, by the block that owns its rows).  The operator is
// (D, 9, FY, FX): centre, E, W, S, N, SE, SW, NE, NW.  The shifted reads
// wrap cyclically over the tile; every wrapped or cross-window read meets a
// zero coefficient, since the outermost ring of each window is outside
// every solve domain.  Reads in the next or previous row reach other
// blocks' bands: they come after a cluster barrier, with __ldcg (L1 is not
// coherent across SMs).  A cell's (y, x) comes from its flat index through
// a float reciprocal of FX corrected by one compare (exact below 2^24
// cells), not an integer division.  The refresh between a rank's own
// windows reads strips that include the source window's own halo rows,
// which are targets of the same refresh, so every block stages its new
// halo values, a cluster barrier follows, and then it writes them.  Work
// vectors live in device memory (the wrapper allocates them): a band of the
// slice (46 x 384 cells at C = 6) times five vectors does not fit one SM's
// shared memory.  Each block's loops keep several rows' loads in flight
// (for_rows in async_common.cuh).
//
// Sums.  Dot products are float32 products summed in float64, per block and
// then over the cluster in block order (ClusterTeam), and rounded to float32
// once; this file is built with -fmad=false.  The plain PyTorch version does
// the same, so card and CPU detect convergence at the same round, and every
// block of a rank holds the same step sizes, known bits and done_at.  The
// step sizes of the correction solve are shared over the folded tile.  A
// frozen rank skips its correction solve.
//
// Messages.  Each (rank, direction) owns a ring of M = 2B+2 slots: the strip,
// the 128 known lanes and a 64-bit sequence word; directions 0..3 carry the
// left, right, top and bottom strips to the left, right, upper and lower
// rank.  What a rank unpacks into its left halo is therefore its left
// neighbour's direction-1 ring.  The protocol runs on the cluster's block 0
// (the leader).  Producer: every block writes the part of each strip that
// lies in its band, a cluster barrier orders them, then the leader's thread
// 0 fences and release-stores t+1; all four directions are published before
// any message is awaited.  Consumer: the leader's thread 0 spins with
// acquire loads, a cluster barrier follows, every block reads the slots
// with __ldcg into its band, and after another cluster barrier the leader
// credits the producer's ack counter; a producer waits for ack >= t-M+1
// before it reuses a slot at t >= M.  Sequence words, acks and the error
// word are zeroed by the caller before each launch.  Every spin is bounded
// by clock64() in one process and by the global timer across processes: on
// timeout the group's error word is set, all spins
// leave and the wrapper raises.  Across processes each process launches its
// Dl = D / P ranks of the row-major rank grid (me = first + blockIdx.x / C)
// and reaches its neighbours' rings through the table of windows
// (RankRings in async_common.cuh, ops/rank_rings.py).
//
// fresh_read: per direction the leader's thread 0 peeks the sequence words
// of the B-1 newer slots and takes the newest message that has fully
// arrived; the other blocks read its choice through distributed shared
// memory.
//
// Bound on the card: coef, b, dinv, both masks and the tile read once and the
// tile written once (14 floats per cell), against T * ninner * (2*P + 13)
// float32 operations per cell for a P-point operator; at the 1M-row slice
// the operations bound it.  The first version ran a rank on one SM (16 of
// 132 at the slice) and streamed every vector through it once per inner
// iteration; the cluster spreads a rank over C SMs, and the product no
// longer divides by FX.
#include "async_common.cuh"

namespace {

namespace cg = cooperative_groups;

// Threads of a block: 512, not the 1024 of K5, leaves a thread 128
// registers; at 1024 the kernel spills ~500 bytes a thread (ptxas) and ran
// slower on the 2-D slice.
constexpr int kNT = 512;
using Team = ClusterTeamT<kNT>;

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
  float* work;  // (Dl, nwork, FY*FX)
  float* ring;  // (D, 4, M, slot): in one process
  unsigned long long* seq;  // (D, 4, M)
  unsigned int* ack;        // (D, 4)
  int* err;
  int D, pdx, pdy, ply, plx, By, Bx, HY, HX, T, B, M, ninner, nonsym, fresh;
  int slot, pay, nwork, C, band;
  float tol2, inv_fx;
};

enum Dir { kL = 0, kR = 1, kU = 2, kD = 3 };

// The folded tile's shape, and 1/FX for the row of a flat index.
struct Tile {
  int FY, FX, n;
  float inv;
};

// Row of flat index q < 2^24: the float quotient is within one of q / FX.
__device__ __forceinline__ int row_of(int q, const Tile& t) {
  const int y = __float2int_rz((float)q * t.inv);
  const int x = q - y * t.FX;
  return x < 0 ? y - 1 : (x >= t.FX ? y + 1 : y);
}

// Row q = (y, x) of the stencil product over the folded tile:
// sum_k c[k, q] * (scale ? dv * v : v)[shift_k(q)], the shifts wrapping.
// NP is 5 when the four diagonal planes are all zero, else 9: a zero plane
// adds +-0 and changes no sum.  The reads of v reach other blocks' bands:
// __ldcg.
template <int NP, bool kScale>
__device__ __forceinline__ float stencil_row(const float* __restrict__ c,
                                             const float* v,
                                             const float* __restrict__ dv,
                                             int q, const Tile& t) {
  const int n = t.n, FX = t.FX;
  const int y = row_of(q, t), x = q - y * FX;
  const int e = x == FX - 1 ? q - (FX - 1) : q + 1;
  const int w = x == 0 ? q + (FX - 1) : q - 1;
  const int ds = y == t.FY - 1 ? FX - n : FX;   // to row y+1
  const int dn = y == 0 ? n - FX : -FX;         // to row y-1
  auto at = [&](int i) {
    const float vi = __ldcg(v + i);
    return kScale ? dv[i] * vi : vi;
  };
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

// kCross: the ranks span processes (RankRings in async_common.cuh)
template <int NP, bool kCross>
__global__ void __launch_bounds__(kNT, 1)
    async_ras_2d_kernel(const ArgsFor<Args, kCross> a) {
  __shared__ float known[kLanes];
  __shared__ double red[kSumScratch];
  __shared__ double part[2 * kMaxSum];
  __shared__ int src[4];

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int crank = (int)cluster.block_rank();
  const bool lead = crank == 0;   // the cluster's block 0 runs the protocol
  const int ml = blockIdx.x / a.C;  // the rank in this process's launch
  const int me = group_rank<kCross>(a, ml);  // in the group
  const int D = a.D, T = a.T, B = a.B, M = a.M;
  const int HX = a.HX, HY = a.HY, By = a.By, Bx = a.Bx;
  const int FY = a.ply * By, FX = a.plx * Bx, n = FY * FX;
  const Tile tile{FY, FX, n, a.inv_fx};
  // this block's band of rows [y0, y1), cells [q0, q1)
  const int y0 = min(FY, crank * a.band), y1 = min(FY, (crank + 1) * a.band);
  Team team{y0 * FX, y1 * FX, part, 0};
  const int q0 = team.q0, q1 = team.q1;
  const int dyy = me / a.pdx, dxx = me % a.pdx;
  // the rank grid is cyclic; with one rank in a direction a rank is its own
  // neighbour there
  const int nb[4] = {dyy * a.pdx + (dxx + a.pdx - 1) % a.pdx,
                     dyy * a.pdx + (dxx + 1) % a.pdx,
                     (dyy + a.pdy - 1) % a.pdy * a.pdx + dxx,
                     (dyy + 1) % a.pdy * a.pdx + dxx};
  // what lands in my left halo is the left rank's right strip, and so on
  const int from[4] = {kR, kL, kD, kU};
  const long long vb = (long long)ml * n;
  const float* coef = a.coef + vb * 9;
  const float* bo = a.boost != nullptr ? a.boost + vb : nullptr;
  const float* b = a.b + vb;
  const float* dv = a.dinv + vb;
  const float* md = a.md + vb;
  const float* mi = a.mi + vb;
  float* x = a.x + vb;
  float* W = a.work + (long long)ml * a.nwork * n;
  auto vec = [&](int i) { return W + (long long)i * n; };
  auto slot = [&](int rank, int dir, int j) {
    if constexpr (kCross)
      return a.rings.at(rank, dir, j);
    else
      return a.ring + (((long long)rank * 4 + dir) * M + j) * a.slot;
  };
  auto seq = [&](int rank, int dir, int j) {
    if constexpr (kCross)
      return a.rings.seq(rank, dir, j);
    else
      return a.seq + ((long long)rank * 4 + dir) * M + j;
  };
  auto ack = [&](int rank, int dir) {
    if constexpr (kCross)
      return a.rings.ack(rank, dir);
    else
      return a.ack + rank * 4 + dir;
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
  auto A_solve = [&](auto scaled, const float* v, int q) {
    constexpr bool kS = decltype(scaled)::value;
    float s = md[q] * stencil_row<NP, kS>(coef, v, dv, q, tile);
    if (bo != nullptr) {
      const float vq = v[q];  // an own cell
      s += bo[q] * (kS ? dv[q] * vq : vq);
    }
    return s;
  };
  // Halos of the rank's edge windows from four messages, the cells of this
  // block's band: up/down strips over the full width, left/right strips on
  // the rows between them; then the messages' known bits.
  auto unpack = [&](const float* const (&m)[4]) {
    const int top = min(q1, HY * FX), bot = (FY - HY) * FX;
    for (int q = q0 + tid; q < top; q += kNT) x[q] = __ldcg(m[kU] + q);
    for (int q = max(q0, bot) + tid; q < q1; q += kNT)
      x[q] = __ldcg(m[kD] + q - bot);
    const int ya = max(y0, HY), yb = min(y1, FY - HY);
    for (int i = tid; i < (yb - ya) * 2 * HX; i += kNT) {
      const int y = ya + i / (2 * HX), c = i - (y - ya) * 2 * HX;
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

  for (int l = tid; l < kLanes; l += kNT)
    known[l] = fmaxf(a.known_in[ml * kLanes + l], l >= D ? 1.f : 0.f);
  for (int q = q0 + tid; q < q1; q += kNT) x[q] = a.x_in[vb + q];
  float rn0 = a.aux_in[ml * kLanes + 0];
  float done_at = a.aux_in[ml * kLanes + 1];
  const float base_t = a.aux_in[ml * kLanes + 2];
  float hits = fmaxf(a.aux_in[ml * kLanes + 4], 0.f);  // the leader's count
  float rn = 0.f;
  cluster.sync();  // x is read across bands from here on

  for (int t = 0; t < T; ++t) {
    const int j = t % M;
    // ---- halos between the rank's own windows, from the tile as it is now:
    // stage every new halo value of the band, then write them
    if (a.ply > 1 || a.plx > 1) {
      float* stage = vec(a.nwork - 1);
      auto source = [&](int q) {
        const int y = row_of(q, tile), c = q - y * FX;
        const int wy = y / By, ly = y - wy * By;
        const int wx = c / Bx, lx = c - wx * Bx;
        if (ly < HY && wy > 0) return q - 2 * HY * FX;
        if (ly >= By - HY && wy < a.ply - 1) return q + 2 * HY * FX;
        if (lx < HX && wx > 0) return q - 2 * HX;
        if (lx >= Bx - HX && wx < a.plx - 1) return q + 2 * HX;
        return q;
      };
      for (int q = q0 + tid; q < q1; q += kNT) {
        const int s = source(q);
        if (s != q) stage[q] = __ldcg(x + s);
      }
      cluster.sync();  // every source read before any target is written
      for (int q = q0 + tid; q < q1; q += kNT)
        if (source(q) != q) x[q] = stage[q];
      __syncthreads();
    }
    // ---- flow control: slot j is free once its last message was acked
    if (t >= M) {
      if (lead && tid == 0) {
        const unsigned int want = t - M + 1;
        for (int d = 0; d < 4; ++d)
          if (!spin<kCross>(ack(me, d), want, err(), kWaitAck,
                            longest()))
            break;
      }
      cluster.sync();
    }
    // ---- pack the band's part of the four edge strips, then publish them
    // with the known bits
    {
      float* sl = slot(me, kL, j);
      float* sr = slot(me, kR, j);
      float* su = slot(me, kU, j);
      float* sd = slot(me, kD, j);
      for (int i = y0 * HX + tid; i < y1 * HX; i += kNT) {
        const int y = i / HX, c = i - y * HX;
        sl[i] = x[y * FX + HX + c];
        sr[i] = x[y * FX + FX - 2 * HX + c];
      }
      const int uo = HY * FX, dof = (FY - 2 * HY) * FX, nUD = HY * FX;
      for (int q = max(q0, uo) + tid; q < min(q1, uo + nUD); q += kNT)
        su[q - uo] = x[q];
      for (int q = max(q0, dof) + tid; q < min(q1, dof + nUD); q += kNT)
        sd[q - dof] = x[q];
      if (lead && tid < kLanes) {
        const float k = known[tid];
        sl[a.pay + tid] = k;
        sr[a.pay + tid] = k;
        su[a.pay + tid] = k;
        sd[a.pay + tid] = k;
      }
      cluster.sync();
      if (lead && tid == 0) {
        __threadfence();
        for (int d = 0; d < 4; ++d)
          st_release(seq(me, d, j), (unsigned long long)t + 1);
      }
    }
    // ---- consume the neighbours' messages of round t - B
    if (t >= B) {
      if (lead && tid == 0) {
        const int u = t - B;
        for (int d = 0; d < 4; ++d) {
          src[d] = u % M;
          if (!spin<kCross>(seq(nb[d], from[d], u % M),
                            (unsigned long long)u + 1, err(),
                            kWaitMessage, longest()))
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
      cluster.sync();
      const int* ls = cluster.map_shared_rank(src, 0);
      const float* const m[4] = {
          slot(nb[kL], kR, ls[kL]), slot(nb[kR], kL, ls[kR]),
          slot(nb[kU], kD, ls[kU]), slot(nb[kD], kU, ls[kD])};
      unpack(m);
      cluster.sync();  // every block has read the slots; halos are read
                       // across bands
      if (lead && tid == 0)
        for (int d = 0; d < 4; ++d) red_release_add(ack(nb[d], from[d]), 1u);
    }
    // ---- masked residual, its norm over owned cells, solver start vectors
    float* r = vec(0);
    double acc[2] = {0.0, 0.0};
    for_rows<kProductRowsInFlight>(
        team,
        [&](int q) {
          return Vals<5>{{stencil_row<NP, false>(coef, x, dv, q, tile),
                          md[q], b[q], mi[q], dv[q]}};
        },
        [&](int q, Vals<5> l) {
          const float rq = l.v[1] * (l.v[2] - l.v[0]);
          r[q] = rq;
          const float m = l.v[3] * rq;
          acc[0] += (double)(m * m);
          if (!a.nonsym) {
            const float s0 = l.v[4] * rq;
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
        });
    team.sum(acc, red);
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
        cluster_pcg(team, A_solve, a.ninner, (float)acc[1], r, vec(1),
                    vec(2), vec(3), dv, red);
        z = vec(2);
      } else {
        // acc[1] is dot(r, rr) with rr = r
        cluster_bicgstab(team, A_solve, a.ninner, (float)acc[1], r, vec(1),
                         vec(2), vec(3), vec(4), vec(5), vec(6), dv, red);
        z = vec(1);
      }
      for_rows(
          team, [&](int q) { return Vals<3>{{mi[q], x[q], z[q]}}; },
          [&](int q, Vals<3> l) {
            if (l.v[0] != 0.f) x[q] = l.v[1] + l.v[0] * l.v[2];
          });
    }
    if (done_at < 0.f && all_known) done_at = base_t + (float)t;
    cluster.sync();  // x and known are read by the next round
  }

  // ---- the message of round T-1 was sent but not consumed: its strips are
  // the halos, and its flags the gossip, carried to the next launch
  {
    const int jl = (T - 1) % M;
    if (lead && tid == 0) {
      for (int d = 0; d < 4; ++d)
        if (!spin<kCross>(seq(nb[d], from[d], jl), (unsigned long long)T,
                          err(), kWaitDrain, longest()))
          break;
    }
    cluster.sync();
    const float* const m[4] = {slot(nb[kL], kR, jl), slot(nb[kR], kL, jl),
                               slot(nb[kU], kD, jl), slot(nb[kD], kU, jl)};
    unpack(m);
  }
  if (lead) {
    for (int l = tid; l < kLanes; l += kNT) {
      a.known_out[ml * kLanes + l] = known[l];
      float v = 0.f;
      if (l == 0) v = rn0;
      if (l == 1) v = done_at;
      if (l == 2) v = base_t + (float)T;
      if (l == 3) v = rn;
      a.aux_out[ml * kLanes + l] = v;
    }
    if (tid == 0) a.aux_out[ml * kLanes + 4] = hits;
  }
  cluster.sync();  // no block leaves while another may read its shared data
}

template <class F>
int dispatch_points(int points, F&& f) {
  return points == 5 ? f(std::integral_constant<int, 5>{})
                     : f(std::integral_constant<int, 9>{});
}

// D ranks of C blocks: a cooperative launch of D clusters of C blocks.
cudaLaunchConfig_t launch_config(int D, int C, cudaLaunchAttribute* at,
                                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(D * C);
  cfg.blockDim = dim3(kNT);
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
int async_ras_2d_max_clusters(int points, int C) {
  int dev = 0, coop = 0, clus = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&clus, cudaDevAttrClusterLaunch, dev);
  if (!coop || !clus || C < 1 || C > 8) return 0;
  int n = 0;
  const int e = dispatch_points(points, [&](auto np) {
    cudaLaunchAttribute at[2];
    cudaLaunchConfig_t cfg = launch_config(1, C, at, 0);
    return (int)cudaOccupancyMaxActiveClusters(
        &n, async_ras_2d_kernel<decltype(np)::value, false>, &cfg);
  });
  if (e != 0) cudaGetLastError();  // a refused size is not a launch error
  return e == 0 ? n : 0;
}

// See ops/async_ras_2d_kernel.py for the operand layout: the per-rank
// operands hold this process's Dl ranks, which start at ``first``.
// ``table`` (P,) holds every process's window (the rings, then the sequence
// words, acks and error word at the byte offsets, zeroed by the caller
// before the launch; in one process ``table`` is not read and ``own`` is
// the process's window); ``points`` is 5 when the four diagonal planes of ``coef`` are all zero, else 9.  C: blocks per rank;
// band: tile rows per block.
int async_ras_2d_f32(const float* coef, const float* b, const float* dinv,
                     const float* md, const float* mi, const float* boost,
                     const float* x_in, const float* known_in,
                     const float* aux_in, float* x, float* known, float* aux,
                     float* work, const void* table, void* own,
                     long long seq_off, long long ack_off, long long err_off,
                     int Dl, int first,
                     int pdx, int pdy, int ply, int plx, int By, int Bx,
                     int HY, int HX, int T, int B, int ninner, int nonsym,
                     int fresh, int points, float tol2, int C, int band,
                     void* stream) {
  const int D = pdx * pdy;
  if (D < 1 || D > kLanes || Dl < 1 || D % Dl || first % Dl || first >= D ||
      T < 1 || B < 1 || ply < 1 || plx < 1 ||
      By <= 2 * HY || Bx <= 2 * HX || (points != 5 && points != 9) ||
      C < 1 || C > 8 || band < 1 || (long long)band * C < (long long)ply * By ||
      (long long)ply * By * plx * Bx >= (1LL << 24))
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
  a.C = C;
  a.band = band;
  a.tol2 = tol2;
  a.inv_fx = 1.f / (float)(plx * Bx);
  char* w = static_cast<char*>(own);
  a.ring = reinterpret_cast<float*>(w);
  a.seq = reinterpret_cast<unsigned long long*>(w + seq_off);
  a.ack = reinterpret_cast<unsigned int*>(w + ack_off);
  a.err = reinterpret_cast<int*>(w + err_off);
  return dispatch_points(points, [&](auto np) {
    cudaLaunchAttribute at[2];
    cudaLaunchConfig_t cfg = launch_config(Dl, C, at, (cudaStream_t)stream);
    constexpr int P = decltype(np)::value;
    if (Dl == D)
      return (int)cudaLaunchKernelEx(&cfg, async_ras_2d_kernel<P, false>, a);
    const WithRings<Args> c{a, make_rings(table, own, seq_off, ack_off,
                                          err_off, Dl, 4, a.M, a.slot,
                                          first)};
    return (int)cudaLaunchKernelEx(&cfg, async_ras_2d_kernel<P, true>, c);
  });
}

}  // extern "C"
