// The port's diagnostics kernels, counterparts of the two Pallas kernels of
// scripts/tpu_diagnostics.py.
//
// K8 (replaces run_smoke, :53): y = x * 2, the "does a kernel launch at
// all" probe.  One thread per element; bound by its bytes.
//
// K9 (replaces run_semread, :214): the flag-order probe behind K5's
// fresh_read.  On the TPU the probe calibrated the DMA semaphore's
// completion unit; on the card a message's arrival is a sequence number in
// device memory, so the probe checks what fresh_read relies on: that a flag
// published with a release orders with the data it guards.  A producer block
// and a consumer block on two different SMs pass a ring of M slots of n
// floats, the round number in every element, through K5's protocol: the
// producer writes the slot, __syncthreads, thread 0 fences and
// release-stores the sequence number; the consumer's thread 0 spins with
// acquire loads, __syncthreads, the block reads the slot with __ldcg and
// counts elements that are not the round number, and thread 0 releases an
// ack that frees the slot.  The count must be 0.  Each block asks for more
// than half an SM's shared memory, so the two cannot share an SM; the probe
// reports both SM ids.  Bound by its bytes: n floats written and read per
// round.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kProbeThreads = 256;
constexpr int kProbePadBytes = 160 * 1024;  // > half of a 228 KB SM
constexpr long long kWatchdogCycles = 8000000000LL;

__global__ void smoke_x2_kernel(const float* __restrict__ x,
                                float* __restrict__ y, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    y[i] = x[i] * 2.f;
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ bool spin_until(const unsigned long long* p,
                           unsigned long long want, int* err) {
  const long long t0 = clock64();
  while (ld_acquire(p) < want) {
    if (*(volatile int*)err != 0) return false;
    if (clock64() - t0 > kWatchdogCycles) {
      atomicCAS(err, 0, 1);
      return false;
    }
    __nanosleep(32);
  }
  return true;
}

// out: [0] mismatching elements, [1] watchdog error, [2] producer SM,
// [3] consumer SM.  sync: M sequence words, then the ack counter.
__global__ void __launch_bounds__(kProbeThreads)
flag_order_kernel(float* buf, unsigned long long* sync, int* out, int n,
                  int rounds, int M) {
  extern __shared__ unsigned char pad[];
  unsigned long long* seq = sync;
  unsigned long long* ack = sync + M;
  int* err = out + 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
    unsigned int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    out[2 + blockIdx.x] = (int)sm;
    pad[0] = 0;
  }
  __shared__ unsigned long long bad_sh[kProbeThreads / 32];
  unsigned long long bad = 0;
  for (int r = 0; r < rounds; ++r) {
    const int j = r % M;
    float* s = buf + (long long)j * n;
    if (blockIdx.x == 0) {  // producer
      if (r >= M && tid == 0)
        spin_until(ack, (unsigned long long)(r - M + 1), err);
      __syncthreads();
      for (int i = tid; i < n; i += kProbeThreads) s[i] = (float)r;
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        st_release(seq + j, (unsigned long long)r + 1);
      }
    } else {  // consumer
      if (tid == 0) spin_until(seq + j, (unsigned long long)r + 1, err);
      __syncthreads();
      for (int i = tid; i < n; i += kProbeThreads)
        bad += __ldcg(s + i) != (float)r;
      __syncthreads();
      if (tid == 0)
        asm volatile("red.release.gpu.global.add.u64 [%0], %1;" ::"l"(ack),
                     "l"(1ull)
                     : "memory");
    }
  }
  if (blockIdx.x == 1) {
    for (int o = 16; o > 0; o >>= 1)
      bad += __shfl_down_sync(0xffffffffu, bad, o);
    if ((tid & 31) == 0) bad_sh[tid >> 5] = bad;
    __syncthreads();
    if (tid == 0) {
      unsigned long long total = 0;
      for (int w = 0; w < kProbeThreads / 32; ++w) total += bad_sh[w];
      out[0] = (int)(total > 0x7fffffffull ? 0x7fffffffull : total);
    }
  }
}

}  // namespace

extern "C" {

int smoke_x2_f32(const float* x, float* y, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long blocks = (n + 255) / 256;
  smoke_x2_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), 256, 0,
                    (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

// buf (M, n) float32; sync (M + 1) uint64 and out (4) int32, zeroed by the
// caller.  Two co-resident blocks, one per SM.
int flag_order_probe(float* buf, void* sync, int* out, int n, int rounds,
                     int M, void* stream) {
  if (n < 1 || rounds < 1 || M < 2) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flag_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kProbePadBytes);
  if (e != cudaSuccess) return (int)e;
  auto* s = static_cast<unsigned long long*>(sync);
  void* params[] = {&buf, &s, &out, &n, &rounds, &M};
  return (int)cudaLaunchCooperativeKernel((const void*)flag_order_kernel,
                                          dim3(2), dim3(kProbeThreads),
                                          params, kProbePadBytes,
                                          (cudaStream_t)stream);
}

}  // extern "C"
