// K1: batched DIA SpMV  y[s, r] = sum_k dia[s, k, r] * x[s, r + off_k],
// and its chained form  z = DIA_out (DIA_in x)  in one launch (FSAI's apply
// z = G^T (G r)).
//
// Replaces the Pallas kernels of schwarz_tpu/ops/pallas_kernels.py
// (dia_spmv_pallas3 and its two earlier generations).  Reads of x outside
// [0, R) are zero, as in the zero-padded window of ops/dia.py dia_spmv.
//
// Bound on the card: bytes.  Each output reads K diagonal values and K x
// values and does 2K flops, far below the H100's flop-per-byte balance, so
// the least time is (dia + x + y) bytes over the memory rate.  At the
// solver's shapes (16 x 21504 rows: 7-11 MB, 2-3 us of bytes) the launch is
// most of the time: K8, which moves almost nothing, reads 5.4 us under the
// same timing.
//
// One product: one thread per output on a grid that covers (R, S) at once,
// neighbouring threads on neighbouring rows, so every dia, x and y access
// of a warp is one coalesced line and the K shifted x reads of a warp hit
// the same few lines in L1.  Against 2-8 rows a thread (16-byte loads of
// dia, or rows strided by the block) on a grid of one wave, and against x
// staged per tile in shared memory, this mapping measured fastest at the
// solver's shapes: more threads in flight hide the memory latency that
// loads in flight inside a thread did not.
//
// The chain: a block of 512 threads owns a tile of rows [a, b).  It first
// fills a shared window w = t on rows [a + lo, b + hi), t = DIA_in x (lo,
// hi the least and greatest off_out), zero outside [0, R); the window's
// halo rows are computed by the neighbouring tile too (their diagonals come
// from L2).  Then it writes its rows of DIA_out w: one launch, and t never
// in device memory.  Two single launches give the same bits: the second
// reads t as zero outside [0, R), as w holds it, and every row is summed by
// k1_row in both.  Rows go to threads strided by the block, four a thread
// per pass, so the window's accesses are conflict-free and a thread keeps
// 4K loads in flight; the grid is one wave of resident blocks at most,
// walking the (s, tile) space.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;         // one product, a thread per output
constexpr int kChainThreads = 512;    // the chain
constexpr int kChainRows = 4;         // rows a thread per pass
constexpr int kSmemMax = 48 * 1024;   // no opt-in attribute below this

// x in device memory.
template <typename T>
struct GlobalX {
  const T* p;
  __device__ __forceinline__ T operator()(long long i) const { return p[i]; }
};

// The block's shared window, whose first element is row ``base``.
template <typename T>
struct SharedX {
  const T* w;
  long long base;
  __device__ __forceinline__ T operator()(long long i) const {
    return w[i - base];
  }
};

// Row i (0 <= i < R) of DIA @ x: sum_k d[k, i] * x(i + off_k), k
// ascending, acc += d * x, x zero outside [0, R); ``d`` is one subdomain's
// (K, R) block, KC is K when known at compile time, else 0.  The one sum of
// every K1 entry point (term for term the first version's), so they agree
// bit for bit.
template <int KC, typename T, typename X>
__device__ __forceinline__ T k1_row(const T* __restrict__ d, const X& x,
                                    long long i, int K, int R,
                                    const Offsets& offs) {
  const int nk = KC > 0 ? KC : K;
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < nk; ++k) {
    const long long c = i + offs.v[k];
    const T xv = (c >= 0 && c < R) ? x(c) : T(0);
    acc += d[(long long)k * R + i] * xv;
  }
  return acc;
}

template <int KC, typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ dia, const T* __restrict__ x,
                T* __restrict__ y, int K, int R, long long ldx,
                Offsets offs) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long s = blockIdx.y;
  if (r >= R) return;
  y[s * R + r] = k1_row<KC>(dia + s * K * (long long)R,
                            GlobalX<T>{x + s * ldx}, r, K, R, offs);
}

// Row c0 + threadIdx.x + j * kChainThreads of a pass for each j, f(row) for
// rows below ``end``, all computed before any is stored.
template <typename T, typename F, typename G>
__device__ __forceinline__ void window_pass(long long c0, long long end,
                                            F&& f, G&& store) {
  T v[kChainRows];
#pragma unroll
  for (int j = 0; j < kChainRows; ++j) {
    const long long i = c0 + threadIdx.x + (long long)j * kChainThreads;
    if (i < end) v[j] = f(i);
  }
#pragma unroll
  for (int j = 0; j < kChainRows; ++j) {
    const long long i = c0 + threadIdx.x + (long long)j * kChainThreads;
    if (i < end) store(i, v[j]);
  }
}

// z = DIA_out (DIA_in x) over tiles of ``tile`` rows, a shared window of
// t = DIA_in x per tile; lo, hi: the least and greatest off_out.
template <int KI, int KO, typename T>
__global__ void __launch_bounds__(kChainThreads)
dia_spmv_chain_kernel(const T* __restrict__ din, const T* __restrict__ dout,
                      const T* __restrict__ x, T* __restrict__ z, int S,
                      int Kin, int Kout, int R, long long ldx, int tile,
                      int lo, int hi, Offsets oin, Offsets oout) {
  constexpr long long kPass = (long long)kChainRows * kChainThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  T* w = reinterpret_cast<T*>(smem);
  const long long tiles = (R + tile - 1) / tile;
  for (long long item = blockIdx.x; item < S * tiles; item += gridDim.x) {
    const long long s = item / tiles;
    const long long a = (item % tiles) * tile;
    const long long b = a + tile < R ? a + tile : R;
    const long long base = a + lo, end = b + hi;
    const T* xs = x + s * ldx;
    const T* di = din + s * Kin * (long long)R;
    const T* dd = dout + s * Kout * (long long)R;
    T* zs = z + s * (long long)R;
    for (long long c0 = base; c0 < end; c0 += kPass) {
      window_pass<T>(
          c0, end,
          [&](long long i) {
            return i < 0 || i >= R
                       ? T(0)
                       : k1_row<KI>(di, GlobalX<T>{xs}, i, Kin, R, oin);
          },
          [&](long long i, T v) { w[i - base] = v; });
    }
    __syncthreads();
    for (long long c0 = a; c0 < b; c0 += kPass) {
      window_pass<T>(
          c0, b,
          [&](long long i) {
            return k1_row<KO>(dd, SharedX<T>{w, base}, i, Kout, R, oout);
          },
          [&](long long i, T v) { zs[i] = v; });
    }
    __syncthreads();   // the window is rewritten for the next tile
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename T>
int spmv(const T* dia, const T* x, T* y, int S, int K, int R, long long ldx,
         const int* offs, void* stream) {
  if (K < 1 || K > kMaxDiags || S < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + kThreads - 1) / kThreads, S);
  const Offsets o = make_offsets(offs, K);
  return dispatch_diags(K, [&](auto kc) {
    dia_spmv_kernel<decltype(kc)::value, T>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(dia, x, y, K, R, ldx, o);
    return (int)cudaGetLastError();
  });
}

// The chain on a grid of one wave of resident blocks at most (the
// occupancy query kept per kernel for its last shared-memory size).
template <int KI, int KO, typename T>
int launch_chain(const T* din, const T* dout, const T* x, T* z, int S,
                 int Kin, int Kout, int R, long long ldx, int tile,
                 const Offsets& oin, const Offsets& oout, void* stream) {
  static int cached_smem = -1, per_sm = 1;
  int lo = oout.v[0], hi = oout.v[0];
  for (int k = 1; k < Kout; ++k) {
    lo = oout.v[k] < lo ? oout.v[k] : lo;
    hi = oout.v[k] > hi ? oout.v[k] : hi;
  }
  const long long smem = ((long long)tile + hi - lo) * (long long)sizeof(T);
  if (tile < 1 || smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (cached_smem != (int)smem) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, dia_spmv_chain_kernel<KI, KO, T>, kChainThreads, (size_t)smem);
    cached_smem = (int)smem;
    per_sm = n > 0 ? n : 1;
  }
  const long long items = (long long)S * ((R + tile - 1) / tile);
  const long long wave = (long long)per_sm * sm_count();
  const unsigned grid = (unsigned)(items < wave ? items : wave);
  dia_spmv_chain_kernel<KI, KO, T>
      <<<grid, kChainThreads, (int)smem, (cudaStream_t)stream>>>(
          din, dout, x, z, S, Kin, Kout, R, ldx, tile, lo, hi, oin, oout);
  return (int)cudaGetLastError();
}

template <typename T>
int chain(const T* din, const T* dout, const T* x, T* z, int S, int Kin,
          int Kout, int R, long long ldx, const int* offs_in,
          const int* offs_out, int tile, void* stream) {
  if (Kin < 1 || Kin > kMaxDiags || Kout < 1 || Kout > kMaxDiags || S < 1 ||
      R < 1)
    return (int)cudaErrorInvalidValue;
  const Offsets oi = make_offsets(offs_in, Kin);
  const Offsets oo = make_offsets(offs_out, Kout);
  // K known at compile time when both factors have the same count (FSAI's
  // G and G^T do), else both at run time
  return dispatch_diags(Kin == Kout ? Kin : 0, [&](auto kc) {
    constexpr int KC = decltype(kc)::value;
    return launch_chain<KC, KC, T>(din, dout, x, z, S, Kin, Kout, R, ldx,
                                   tile, oi, oo, stream);
  });
}

}  // namespace

extern "C" {

// dia (S, K, R) and y (S, R) contiguous; x rows start ldx elements apart.
int dia_spmv_f32(const float* dia, const float* x, float* y, int S, int K,
                 int R, long long ldx, const int* offs, void* stream) {
  return spmv<float>(dia, x, y, S, K, R, ldx, offs, stream);
}

int dia_spmv_f64(const double* dia, const double* x, double* y, int S, int K,
                 int R, long long ldx, const int* offs, void* stream) {
  return spmv<double>(dia, x, y, S, K, R, ldx, offs, stream);
}

// z (S, R) = DIA_out (DIA_in x): din (S, Kin, R), dout (S, Kout, R) and z
// contiguous, x rows ldx apart; ``tile`` rows a block, its window (tile +
// the span of offs_out) within 48 KB of shared memory.
int dia_spmv_chain_f32(const float* din, const float* dout, const float* x,
                       float* z, int S, int Kin, int Kout, int R,
                       long long ldx, const int* offs_in, const int* offs_out,
                       int tile, void* stream) {
  return chain<float>(din, dout, x, z, S, Kin, Kout, R, ldx, offs_in,
                      offs_out, tile, stream);
}

int dia_spmv_chain_f64(const double* din, const double* dout,
                       const double* x, double* z, int S, int Kin, int Kout,
                       int R, long long ldx, const int* offs_in,
                       const int* offs_out, int tile, void* stream) {
  return chain<double>(din, dout, x, z, S, Kin, Kout, R, ldx, offs_in,
                       offs_out, tile, stream);
}

}  // extern "C"
