// K2: halo-run copy of the extended iterate x_ext.
//
// Replaces schwarz_tpu/ops/halo_pallas.py assemble_runs_fused (one DMA per
// run, tile-aligned).  Every contiguous halo run of every subdomain is one
// block: buf[s, dst : dst + len] = x_all[src : src + len], with entries whose
// dst equals r_ext (the plan's sentinel) skipped.  The runs of all length
// classes come flattened into one (src, dst, len) table, so one launch does
// every copy and no alignment is required.
//
// The caller has already written the interior window into buf; this kernel
// overwrites the halo runs IN PLACE, after the window, which is the write
// order of the XLA paths (window first, runs after).
//
// Bound on the card: bytes (read each run once, write it once).  Each block
// copies with 16-byte vector accesses when source and destination share
// their alignment, and element by element around the edges otherwise.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
halo_runs_kernel(T* __restrict__ buf, long long ldb,
                 const T* __restrict__ x_all, const int* __restrict__ src,
                 const int* __restrict__ dst, const int* __restrict__ lens,
                 int NR, int r_ext) {
  const int j = blockIdx.x;
  const long long s = blockIdx.y;
  const int d = dst[s * NR + j];
  if (d >= r_ext) return;  // unused table entry
  const int len = lens[j];
  const T* in = x_all + src[s * NR + j];
  T* out = buf + s * ldb + d;
  constexpr int W = sizeof(V) / sizeof(T);
  const uintptr_t ai = reinterpret_cast<uintptr_t>(in) % sizeof(V);
  const uintptr_t ao = reinterpret_cast<uintptr_t>(out) % sizeof(V);
  int done = 0;
  if (ai == ao) {
    int head = ai ? (int)((sizeof(V) - ai) / sizeof(T)) : 0;
    if (head > len) head = len;
    for (int i = threadIdx.x; i < head; i += kThreads) out[i] = in[i];
    const int nvec = (len - head) / W;
    const V* vin = reinterpret_cast<const V*>(in + head);
    V* vout = reinterpret_cast<V*>(out + head);
    for (int i = threadIdx.x; i < nvec; i += kThreads) vout[i] = vin[i];
    done = head + nvec * W;
  }
  for (int i = done + threadIdx.x; i < len; i += kThreads) out[i] = in[i];
}

template <typename T, typename V>
int launch(T* buf, long long ldb, const T* x_all, const int* src,
           const int* dst, const int* lens, int S, int NR, int r_ext,
           void* stream) {
  if (S == 0 || NR == 0) return (int)cudaSuccess;
  const dim3 grid(NR, S);
  halo_runs_kernel<T, V><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      buf, ldb, x_all, src, dst, lens, NR, r_ext);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// buf rows start ldb elements apart; src/dst are (S, NR) int32 on the
// device, lens (NR,) int32 on the device.
int halo_runs_f32(float* buf, long long ldb, const float* x_all,
                  const int* src, const int* dst, const int* lens, int S,
                  int NR, int r_ext, void* stream) {
  return launch<float, float4>(buf, ldb, x_all, src, dst, lens, S, NR,
                               r_ext, stream);
}

int halo_runs_f64(double* buf, long long ldb, const double* x_all,
                  const int* src, const int* dst, const int* lens, int S,
                  int NR, int r_ext, void* stream) {
  return launch<double, double2>(buf, ldb, x_all, src, dst, lens, S, NR,
                                 r_ext, stream);
}

}  // extern "C"
