// K1: batched DIA SpMV  y[s, r] = sum_k dia[s, k, r] * x[s, r + off_k].
//
// Replaces the Pallas kernels of schwarz_tpu/ops/pallas_kernels.py
// (dia_spmv_pallas3 and its two earlier generations).  Reads of x outside
// [0, R) are zero, as in the zero-padded window of ops/dia.py dia_spmv.
//
// Bound on the card: bytes.  Each output reads K diagonal values and K x
// values and does 2K flops, far below the H100's flop-per-byte balance, so
// the least time is (dia + x + y) bytes over the memory rate.  One thread per
// (s, r) output: neighbouring threads read neighbouring dia and x entries
// (coalesced), and the K shifted x reads of a warp hit the same few cache
// lines, so x is fetched from device memory about once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int KC, typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ dia, const T* __restrict__ x,
                T* __restrict__ y, int K, int R, long long ldx,
                Offsets offs) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long s = blockIdx.y;
  if (r >= R) return;
  y[s * R + r] = dia_row<KC>(dia + s * K * (long long)R, x + s * ldx, r, K,
                             R, offs);
}

template <typename T>
int launch(const T* dia, const T* x, T* y, int S, int K, int R,
           long long ldx, const int* offs, void* stream) {
  if (K < 1 || K > kMaxDiags) return (int)cudaErrorInvalidValue;
  const dim3 grid((R + kThreads - 1) / kThreads, S);
  const Offsets o = make_offsets(offs, K);
  return dispatch_diags(K, [&](auto kc) {
    dia_spmv_kernel<decltype(kc)::value, T>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(dia, x, y, K, R, ldx, o);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// dia (S, K, R) and y (S, R) contiguous; x rows start ldx elements apart.
int dia_spmv_f32(const float* dia, const float* x, float* y, int S, int K,
                 int R, long long ldx, const int* offs, void* stream) {
  return launch<float>(dia, x, y, S, K, R, ldx, offs, stream);
}

int dia_spmv_f64(const double* dia, const double* x, double* y, int S, int K,
                 int R, long long ldx, const int* offs, void* stream) {
  return launch<double>(dia, x, y, S, K, R, ldx, offs, stream);
}

}  // extern "C"
