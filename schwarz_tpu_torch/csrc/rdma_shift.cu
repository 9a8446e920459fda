// K4: the one-sided cyclic shift of packed halo buffers between ranks.
//
// Replaces _rdma_cyclic_shift (schwarz_tpu/parallel/neighbor_exchange.py:167,
// kernel body :202): rank ``me`` moves its packed buffer into the receive
// window of rank (me + offset) % D and returns what (me - offset) % D sent,
//
//     out[(d + offset) % D, :] = buf[d, :]        buf, out: (D, H)
//
// On the TPU a rank is a device and the move is a remote DMA with DMA
// semaphores.  On the card a rank is a thread block, as in the free-running
// kernels: one cooperative launch of D co-resident blocks.  Rank ``me``
// writes only into the window of its target and learns that its own window
// is full only from a counter in device memory that its source bumps with a
// release; there is no grid-wide barrier.  The variants of the reference's
// one-sided strategy matrix (comm_helpers.hpp:55-180):
//
//   put         copy the row, __syncthreads, fence, one release on the
//               target's receive counter; then acquire-spin on the own one.
//   get         receiver-initiated, as request + reply: first signal the
//               request counter of the source rank, then serve (as put)
//               only after the own request counter was signalled by the
//               target.  Every rank posts its request before it waits for
//               one, so a ring of ranks cannot deadlock (with D = 2 source
//               and target are the same rank and the two requests cross).
//   one_by_one  one completion signal per element (a red.release add)
//               instead of one per buffer; the receiver waits for H.
//   flush_local with one_by_one: a thread completes each of its elements
//               (write, fence, signal) before it starts its next; without
//               it (flush-all) a thread makes all its element writes, then
//               sends all their signals.  For a gathered transfer the two
//               coincide.
//
// So that the variants can be told apart by more than their (identical)
// data, each rank reports the completion signals it received (1 or H) and
// the requests it served (0 or 1) in ``status``.
//
// The counters are zeroed by the caller on the launch's stream before each
// launch.  A wait that outlasts the watchdog sets the error word
// (kWaitRequest, kWaitData) and every rank runs to its end; the wrapper
// raises.
//
// Bound: bytes (each element read once and written once; no arithmetic).
// At the halo sizes of a solve (tens of KB) the launch and the handoff
// latency are the whole time, not the bytes.
#include "common.cuh"

#include "async_common.cuh"

namespace {

constexpr int kShiftThreads = 256;

enum ShiftWait { kWaitRequest = 4, kWaitData = 5 };

struct ShiftArgs {
  const void* buf;
  void* out;
  unsigned int* recv;  // (D,) completion signals that reached each rank
  unsigned int* req;   // (D,) requests that reached each rank
  int* status;         // (D, 2) signals received, requests served; then err
  int D, H, offset, get, one_by_one, flush_local;
};

template <typename T>
__global__ void __launch_bounds__(kShiftThreads)
rdma_shift_kernel(ShiftArgs a) {
  const int me = blockIdx.x;
  const int tid = threadIdx.x;
  const int dst = (me + a.offset) % a.D;
  const int src = (me - a.offset + a.D) % a.D;
  int* err = a.status + 2 * a.D;
  int served = 0;
  if (a.get) {
    if (tid == 0) {
      // origin side: ask the rank whose data this rank needs
      red_release_add(a.req + src, 1u);
      // target side: serve only after the rank that needs ours asked
      spin_until(a.req + me, 1u, err, (int)kWaitRequest);
      served = (int)ld_acquire(a.req + me);
    }
    __syncthreads();
  }
  const T* x = static_cast<const T*>(a.buf) + (long long)me * a.H;
  T* o = static_cast<T*>(a.out) + (long long)dst * a.H;
  unsigned int* done = a.recv + dst;
  if (!a.one_by_one) {
    for (int i = tid; i < a.H; i += kShiftThreads) o[i] = x[i];
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      red_release_add(done, 1u);
    }
  } else if (a.flush_local) {
    for (int i = tid; i < a.H; i += kShiftThreads) {
      o[i] = x[i];
      __threadfence();
      red_release_add(done, 1u);
    }
  } else {
    for (int i = tid; i < a.H; i += kShiftThreads) o[i] = x[i];
    __threadfence();
    for (int i = tid; i < a.H; i += kShiftThreads) red_release_add(done, 1u);
  }
  // the own window is full when every expected signal has arrived
  if (tid == 0) {
    const unsigned int want = a.one_by_one ? (unsigned int)a.H : 1u;
    spin_until(a.recv + me, want, err, (int)kWaitData);
    a.status[2 * me] = (int)ld_acquire(a.recv + me);
    a.status[2 * me + 1] = served;
  }
}

template <typename F>
int dispatch_elem(int elem, F&& f) {
  switch (elem) {
    case 2: return f((unsigned short)0);
    case 4: return f((unsigned int)0);
    case 8: return f((unsigned long long)0);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Co-resident blocks of the kernel on this card: the largest rank count a
// cooperative launch can hold (0 without cooperative launch support).
int rdma_shift_max_ranks(int elem) {
  int dev = 0, sms = 0, coop = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return 0;
  int per_sm = 0;
  const int rc = dispatch_elem(elem, [&](auto t) {
    using T = decltype(t);
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rdma_shift_kernel<T>, kShiftThreads, 0);
  });
  return rc == (int)cudaSuccess ? per_sm * sms : 0;
}

// buf, out: (D, H) elements of ``elem`` bytes (2, 4 or 8).  sync: 2 D
// uint32 counters (receive, request); status: 2 D + 1 int32; both zeroed by
// the caller on ``stream`` before the launch.
int rdma_shift(const void* buf, void* out, void* sync, int* status, int D,
               int H, int elem, int offset, int get, int one_by_one,
               int flush_local, void* stream) {
  if (D < 1 || H < 1 || offset < 0 || offset >= D)
    return (int)cudaErrorInvalidValue;
  ShiftArgs a{};
  a.buf = buf;
  a.out = out;
  a.recv = static_cast<unsigned int*>(sync);
  a.req = a.recv + D;
  a.status = status;
  a.D = D;
  a.H = H;
  a.offset = offset;
  a.get = get;
  a.one_by_one = one_by_one;
  a.flush_local = flush_local;
  void* params[] = {&a};
  return dispatch_elem(elem, [&](auto t) {
    using T = decltype(t);
    return (int)cudaLaunchCooperativeKernel(
        (const void*)rdma_shift_kernel<T>, dim3(D), dim3(kShiftThreads),
        params, 0, (cudaStream_t)stream);
  });
}

}  // extern "C"
