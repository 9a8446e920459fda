// The port's diagnostics kernels, counterparts of the two Pallas kernels of
// scripts/tpu_diagnostics.py.
//
// K8 (replaces run_smoke, :53): y = x * 2, the "does a kernel launch at
// all" probe.  Four elements a thread, one 16-byte load and store each when
// both pointers are 16-byte aligned (PyTorch's own elementwise layout), a
// grid of threads x 4 that covers n, and scalar accesses for the tail and
// for unaligned pointers.  Bound by its bytes, and at (256, 256) by the
// launch.
//
// K9 (replaces run_semread, :214): the flag-order probe behind the
// free-running kernels' fresh_read.  On the TPU the probe calibrated the DMA
// semaphore's completion unit; on the card a message's arrival is a
// sequence number in device memory, so the probe checks what fresh_read
// relies on: that a flag published with a release orders with the data it
// guards, where the data was written by every block of a thread-block
// cluster and the flag by one of them.  A producer cluster and a consumer
// cluster of C blocks each pass a ring of M slots of n floats, the round
// number in every element, through the protocol of K5 and K6
// (async_ras.cu): every producer block writes its share of the slot with
// 16-byte stores, a cluster barrier orders the blocks' writes, and the
// leader block's thread 0 fences and release-stores the sequence number;
// the consumer leader's thread 0 spins with acquire loads, a cluster
// barrier follows, every consumer block reads its share with 16-byte __ldcg
// loads and counts elements that are not the round number, a second
// cluster barrier ends the reads, and the leader releases an ack that frees
// the slot.  The count must be 0.  Each block asks for more than half an
// SM's shared memory, so no two blocks share an SM; the probe reports all
// 2C SM ids.  One block (C = 1) is the leader alone.  Bound by its bytes:
// n floats written and read per round, ~16 KB per SM each way at C = 8.
#include "async_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kSmokeThreads = 256;
constexpr int kProbeThreads = 256;
constexpr int kProbePadBytes = 160 * 1024;  // > half of a 228 KB SM
constexpr int kVecInFlight = 4;             // 16-byte accesses a thread

__global__ void __launch_bounds__(kSmokeThreads)
    smoke_x2_kernel(const float* __restrict__ x, float* __restrict__ y,
                    long long n, bool vec) {
  const long long i = 4 * (blockIdx.x * (long long)kSmokeThreads +
                           threadIdx.x);
  if (vec && i + 3 < n) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    *reinterpret_cast<float4*>(y + i) =
        make_float4(v.x * 2.f, v.y * 2.f, v.z * 2.f, v.w * 2.f);
    return;
  }
  for (long long k = i; k < i + 4 && k < n; ++k) y[k] = x[k] * 2.f;
}

// out: [0] mismatching elements, [1] watchdog error, [2 + b] the SM of
// block b (producer blocks 0..C-1, consumer blocks C..2C-1).  sync: M
// sequence words, then the ack counter.  A slot is ld floats (n rounded up
// to 4, so every slot starts 16-byte aligned).
__global__ void __launch_bounds__(kProbeThreads)
    flag_order_kernel(float* buf, unsigned long long* sync, int* out, int n,
                      int rounds, int M) {
  extern __shared__ unsigned char pad[];
  __shared__ unsigned long long bad_sh[kProbeThreads / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int crank = (int)cluster.block_rank();
  const bool producer = (int)blockIdx.x < C;
  const bool lead = crank == 0;
  unsigned long long* seq = sync;
  auto* ack = reinterpret_cast<unsigned int*>(sync + M);
  int* err = out + 1;
  const int tid = threadIdx.x;
  const int ld = (n + 3) / 4 * 4;
  // this block's share [i0, i1) of a slot: n4 whole float4s from i0 (a
  // multiple of 4), then a scalar tail
  const int share = ((n + C - 1) / C + 3) / 4 * 4;
  const int i0 = min(n, crank * share), i1 = min(n, (crank + 1) * share);
  const int n4 = (i1 - i0) / 4;
  if (tid == 0) {
    unsigned int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    out[2 + blockIdx.x] = (int)sm;
    pad[0] = 0;
  }
  unsigned long long bad = 0;
  for (int r = 0; r < rounds; ++r) {
    const int j = r % M;
    float* s = buf + (long long)j * ld;
    const float fr = (float)r;
    if (producer) {
      if (r >= M) {
        if (lead && tid == 0)
          spin_until(ack, (unsigned int)(r - M + 1), err, kWaitAck);
        cluster.sync();
      }
#pragma unroll 4
      for (int v = tid; v < n4; v += kProbeThreads)
        *reinterpret_cast<float4*>(s + i0 + 4 * v) =
            make_float4(fr, fr, fr, fr);
      for (int i = i0 + 4 * n4 + tid; i < i1; i += kProbeThreads) s[i] = fr;
      cluster.sync();
      if (lead && tid == 0) {
        __threadfence();
        st_release(seq + j, (unsigned long long)r + 1);
      }
    } else {
      if (lead && tid == 0)
        spin_until(seq + j, (unsigned long long)r + 1, err, kWaitMessage);
      cluster.sync();
      for (int v = tid; v < n4; v += kVecInFlight * kProbeThreads) {
        float4 w[kVecInFlight];
#pragma unroll
        for (int u = 0; u < kVecInFlight; ++u)
          if (v + u * kProbeThreads < n4)
            w[u] = __ldcg(reinterpret_cast<const float4*>(
                s + i0 + 4 * (v + u * kProbeThreads)));
#pragma unroll
        for (int u = 0; u < kVecInFlight; ++u)
          if (v + u * kProbeThreads < n4)
            bad += (w[u].x != fr) + (w[u].y != fr) + (w[u].z != fr) +
                   (w[u].w != fr);
      }
      for (int i = i0 + 4 * n4 + tid; i < i1; i += kProbeThreads)
        bad += __ldcg(s + i) != fr;
      cluster.sync();
      if (lead && tid == 0) red_release_add(ack, 1u);
    }
  }
  if (!producer) {
    for (int o = 16; o > 0; o >>= 1)
      bad += __shfl_down_sync(0xffffffffu, bad, o);
    if ((tid & 31) == 0) bad_sh[tid >> 5] = bad;
    __syncthreads();
    if (tid == 0) {
      unsigned long long total = 0;
      for (int w = 0; w < kProbeThreads / 32; ++w) total += bad_sh[w];
      atomicAdd(out, (int)(total > 0x3fffffffull ? 0x3fffffffull : total));
    }
  }
}

// A producer and a consumer cluster of C blocks: a cooperative launch of
// two clusters.
cudaLaunchConfig_t probe_config(int C, cudaLaunchAttribute* at,
                                cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * C);
  cfg.blockDim = dim3(kProbeThreads);
  cfg.dynamicSmemBytes = kProbePadBytes;
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

int smoke_x2_f32(const float* x, float* y, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const long long threads = (n + 3) / 4;
  const long long blocks = (threads + kSmokeThreads - 1) / kSmokeThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  smoke_x2_kernel<<<(unsigned)blocks, kSmokeThreads, 0,
                    (cudaStream_t)stream>>>(x, y, n, vec);
  return (int)cudaGetLastError();
}

// Clusters of C probe blocks the card holds at once (the probe needs 2); 0
// without cooperative or cluster launch support.
int flag_order_max_clusters(int C) {
  int dev = 0, coop = 0, clus = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&clus, cudaDevAttrClusterLaunch, dev);
  if (!coop || !clus || C < 1 || C > 8) return 0;
  if (cudaFuncSetAttribute(flag_order_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kProbePadBytes) != cudaSuccess)
    return 0;
  cudaLaunchAttribute at[2];
  cudaLaunchConfig_t cfg = probe_config(C, at, 0);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, flag_order_kernel, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();  // a refused size is not a launch error
    return 0;
  }
  return n;
}

// buf (M, ld) float32 with ld = n rounded up to 4; sync (M + 1) uint64 and
// out (2 + 2C) int32, zeroed by the caller.  Two co-resident clusters of C
// blocks, one block per SM.
int flag_order_probe(float* buf, void* sync, int* out, int n, int rounds,
                     int M, int C, void* stream) {
  if (n < 1 || rounds < 1 || M < 2 || C < 1 || C > 8)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flag_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kProbePadBytes);
  if (e != cudaSuccess) return (int)e;
  auto* s = static_cast<unsigned long long*>(sync);
  cudaLaunchAttribute at[2];
  cudaLaunchConfig_t cfg = probe_config(C, at, (cudaStream_t)stream);
  return (int)cudaLaunchKernelEx(&cfg, flag_order_kernel, buf, s, out, n,
                                 rounds, M);
}

}  // extern "C"
