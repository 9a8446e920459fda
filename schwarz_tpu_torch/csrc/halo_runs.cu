// K2: the extended iterate x_ext, every element of it, in one launch.
//
// Replaces schwarz_tpu/ops/halo_pallas.py assemble_x_ext_fused (:216): the
// XLA window insert (window_insert_xla, :119) and the DMA copy of the halo
// runs (assemble_runs_fused, :142, the TPU kernel).  It computes
// schwarz_tpu/parallel/exchange.py exchange_halo_allgather (:230) and
// assemble_x_ext (:128) in their write order: zeros, then the interior
// window, then the halo, which overwrites window-covered slots.
//
// The host paints that order once per plan into a table of segments
// (parallel/exchange.py build_segments): each row of x_ext is cut into
// sorted, non-overlapping pieces (dst0, len, kind, src0), kind one of
//
//   zero    x_ext[s, dst0 : dst0 + len] = 0
//   window  ... = x_own_flat[src0 : src0 + len]
//   halo    ... = round(halo_src[src0 : src0 + len])
//
// where halo_src is the gathered interior x_own_flat itself (all_gather;
// round() goes through the halo type in registers, as a halo that travelled
// in it) or the neighbour strategies' compact halo values (no rounding:
// they arrive rounded).  A block writes one tile of columns of one row; a
// second table gives each (row, tile) its first segment, so a block finds
// its segments without searching and reads no per-element index.
//
// Bound on the card: bytes.  x_ext is written once, each window and halo
// element read once, the tables read once; no arithmetic beyond the
// rounding.  The grid is subdomains x tiles of 4096 columns (16 rows x 18
// tiles = 288 blocks on the 1M-row slice, all resident at once on the 132
// SMs).  Each thread issues four 16-byte loads before their stores, where
// source and destination share their alignment (element by element around
// the edges and otherwise), so a tile's whole 16 KB (float32) is in flight.
// The output is a fresh tensor: no memset precedes the launch.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // loads in flight per thread before the stores

enum Kind { kZero = 0, kWindow = 1, kHalo = 2 };

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

// round a value (or each lane of a 16-byte vector) through the halo type
template <typename T, typename H>
__device__ __forceinline__ T rounded(T v) {
  return convert<T>(convert<H>(v));
}
template <typename T, typename H>
__device__ __forceinline__ float4 rounded(float4 v) {
  return make_float4(rounded<T, H>(v.x), rounded<T, H>(v.y),
                     rounded<T, H>(v.z), rounded<T, H>(v.w));
}
template <typename T, typename H>
__device__ __forceinline__ double2 rounded(double2 v) {
  return make_double2(rounded<T, H>(v.x), rounded<T, H>(v.y));
}

// n elements of type E from in[0..n) (or zeros) to out[0..n), kUnroll
// loads a thread issued before their stores
template <int K, typename T, typename H, typename E>
__device__ __forceinline__ void stream(E* __restrict__ out,
                                       const E* __restrict__ in, int n) {
  for (int base = 0; base < n; base += kThreads * kUnroll) {
    E r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < n) {
        if constexpr (K == kZero) {
          r[u] = E{};
        } else {
          r[u] = __ldg(in + i);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < n) {
        if constexpr (K == kHalo && !std::is_same_v<T, H>) {
          out[i] = rounded<T, H>(r[u]);
        } else {
          out[i] = r[u];
        }
      }
    }
  }
}

// One piece of a segment: 16-byte accesses when out and in share their
// alignment (a zero piece always does), element by element otherwise.
template <int K, typename T, typename H>
__device__ __forceinline__ void piece(T* __restrict__ out,
                                      const T* __restrict__ in, int n) {
  using V = typename Vec16<T>::type;
  constexpr int W = sizeof(V) / sizeof(T);
  const int ao = (int)((reinterpret_cast<uintptr_t>(out) / sizeof(T)) % W);
  const bool vec = K == kZero ||
      (int)((reinterpret_cast<uintptr_t>(in) / sizeof(T)) % W) == ao;
  if (!vec) {
    stream<K, T, H>(out, in, n);
    return;
  }
  int head = ao ? W - ao : 0;
  if (head > n) head = n;
  const int nvec = (n - head) / W;
  const int done = head + nvec * W;
  const auto at = [in](int i) { return K == kZero ? in : in + i; };
  stream<K, T, H>(out, in, head);
  stream<K, T, H>(reinterpret_cast<V*>(out + head),
                  reinterpret_cast<const V*>(at(head)), nvec);
  stream<K, T, H>(out + done, at(done), n - done);
}

template <typename T, typename H>
__global__ void __launch_bounds__(kThreads)
assemble_kernel(T* __restrict__ out, const T* __restrict__ x_own,
                const T* __restrict__ halo_src,
                const int4* __restrict__ segs, const int* __restrict__ first,
                int r_ext, int n_tiles, int tile) {
  const int t = blockIdx.x;
  const long long s = blockIdx.y;
  const int c0 = t * tile;
  const int c1 = min(c0 + tile, r_ext);
  const int* f = first + s * (n_tiles + 1);
  const int end = f[n_tiles];
  T* row = out + s * r_ext;
  for (int i = f[t]; i < end; ++i) {
    const int4 g = segs[i];          // dst0, len, kind, src0
    if (g.x >= c1) break;
    const int a = max(g.x, c0);
    const int n = min(g.x + g.y, c1) - a;
    const long long src = (long long)g.w + (a - g.x);
    if (g.z == kZero) {
      piece<kZero, T, T>(row + a, nullptr, n);
    } else if (g.z == kWindow) {
      piece<kWindow, T, T>(row + a, x_own + src, n);
    } else {
      piece<kHalo, T, H>(row + a, halo_src + src, n);
    }
  }
}

template <typename T, typename H>
int launch(T* out, const T* x_own, const T* halo_src, const int* segs,
           const int* first, int S, int r_ext, int n_tiles, int tile,
           void* stream) {
  if (S == 0 || n_tiles == 0) return (int)cudaSuccess;
  const dim3 grid(n_tiles, S);
  assemble_kernel<T, H><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      out, x_own, halo_src, reinterpret_cast<const int4*>(segs), first,
      r_ext, n_tiles, tile);
  return (int)cudaGetLastError();
}

// halo type codes: 1 float32, 2 float64, 3 bfloat16, 4 float16 (the
// compute type's own code: no rounding)
template <typename T>
int dispatch(int halo, T* out, const T* x_own, const T* halo_src,
             const int* segs, const int* first, int S, int r_ext,
             int n_tiles, int tile, void* stream) {
  switch (halo) {
    case 1: return launch<T, float>(out, x_own, halo_src, segs, first, S,
                                    r_ext, n_tiles, tile, stream);
    case 2: return launch<T, double>(out, x_own, halo_src, segs, first, S,
                                     r_ext, n_tiles, tile, stream);
    case 3: return launch<T, __nv_bfloat16>(out, x_own, halo_src, segs,
                                            first, S, r_ext, n_tiles, tile,
                                            stream);
    case 4: return launch<T, __half>(out, x_own, halo_src, segs, first, S,
                                     r_ext, n_tiles, tile, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out (S, r_ext) contiguous; x_own (S, R_int) contiguous; halo_src the
// flat source the halo segments index (x_own itself, or (S, H) halo
// values); segs (NSEG, 4) int32 and first (S, n_tiles + 1) int32, all on
// the device.  The tables must come from build_segments, which checks that
// every segment lies inside its source and its row.
int halo_assemble_f32(float* out, const float* x_own, const float* halo_src,
                      const int* segs, const int* first, int S, int r_ext,
                      int n_tiles, int tile, int halo, void* stream) {
  return dispatch<float>(halo, out, x_own, halo_src, segs, first, S, r_ext,
                         n_tiles, tile, stream);
}

int halo_assemble_f64(double* out, const double* x_own,
                      const double* halo_src, const int* segs,
                      const int* first, int S, int r_ext, int n_tiles,
                      int tile, int halo, void* stream) {
  return dispatch<double>(halo, out, x_own, halo_src, segs, first, S, r_ext,
                          n_tiles, tile, stream);
}

}  // extern "C"
