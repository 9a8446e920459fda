// K4: the one-sided neighbour halo exchange, every round in one launch.
//
// Replaces _rdma_cyclic_shift (schwarz_tpu/parallel/neighbor_exchange.py:167,
// kernel body :202) together with the pack and unpack gathers around it
// (:212-228).  In round k with offset r_k rank ``me`` moves its packed
// buffer into the receive window of rank (me + r_k) % D:
//
//     win_k[(d + r_k) % D, i] = halo_type(x[d, send_k[d, i]])   (D, H_k)
//
// and after the last round unpacks its own subdomains' halo slots,
//
//     halo[s, j] = x[me, local_src[s, j]]             slot owned on the rank
//                = x_type(win_k[me, pos[s, j]])       slot that crossed
//
// On the TPU a rank is a device and the move is a remote DMA with DMA
// semaphores.  On the card a rank is a thread block of one cooperative
// launch of D co-resident blocks.  Rank ``me`` writes only into the windows
// of its targets and learns that its own window is full only from a counter
// in device memory that its source bumps with a release; there is no
// grid-wide barrier.  The variants of the reference's one-sided strategy
// matrix (comm_helpers.hpp:55-180):
//
//   put         copy the row, __syncthreads, fence, one release on the
//               target's receive counter.
//   get         receiver-initiated, as request + reply: a rank first posts
//               its requests to the source of every round, then serves (as
//               put) each round only after its target's request arrived.
//               Every rank posts all its requests before it waits for any,
//               so a ring of ranks cannot deadlock (with D = 2 source and
//               target are the same rank and the two requests cross).
//   one_by_one  one completion signal per element (a red.release add)
//               instead of one per buffer; the receiver waits for H_k.
//   flush_local with one_by_one: a thread completes each of its elements
//               (write, fence, signal) before it starts its next; without
//               it (flush-all) a thread makes all its element writes, then
//               sends all their signals.
//
// So that the variants can be told apart by more than their (identical)
// data, each rank reports per round the completion signals it received (1
// or H_k) and the requests it served (0 or 1) in ``status``.
//
// Sequence words.  The counters are 64-bit and cumulative: they are zeroed
// once, when the caller allocates them for a plan, and never again.  The
// caller counts the launches made on them by kind and passes the totals
// before this launch; a rank derives the value each wait must reach from
// them, so no memset and no host-to-device copy precedes a launch.  Counts
// and the error word are written with stores.  The error word is written by
// the last rank to finish (a cumulative counter tells it), after every
// other rank has set the sticky abort word or not.  A wait that outlasts
// the watchdog sets the abort word (kWaitRequest, kWaitData), every rank
// runs to its end, and the caller raises and drops the counters.
//
// The one-round shift of a whole buffer (rdma_cyclic_shift) is the same
// kernel with an identity pack and no unpack; it moves bits.
//
// Bound: bytes (each packed value read once, the index tables read once,
// each window element written once and read once, the halo written once; no
// arithmetic).  At the halo sizes of a solve (tens of KB) the launch and the
// handoff latency are the whole time, not the bytes: hence one launch for
// all rounds with the pack and unpack inside it, 1024 threads a rank, each
// with the loads of four elements in flight (a gather is an index load, then
// a dependent value load).
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

#include "async_common.cuh"

namespace {

constexpr int kShiftThreads = 1024;
constexpr int kUnroll = 4;

enum ShiftWait { kWaitRequest = 4, kWaitData = 5 };

// element types: bits for the shift, values for the exchange
enum Elem { kU16 = 0, kU32 = 1, kU64 = 2, kF32 = 3, kF64 = 4, kBF16 = 5,
            kF16 = 6 };

struct XArgs {
  const void* x;             // (D, n_own) compute type
  const int* pack;           // per round (D, H_k), concatenated; or null
  const int* unpack;         // (D * Sl, Hs): >= 0 own offset, < 0 -(1 + win)
  void* halo;                // (D * Sl, Hs) compute type; null: no unpack
  void* win;                 // per round (D, H_k) halo type, concatenated
  const int* rounds;         // (n_rounds, 3): offset, H_k, window base
  unsigned long long* seq;   // recv, req (n_rounds, D); finished; abort
  int* status;               // (n_rounds, D, 2); then the error word
  unsigned long long n_whole, n_obo, n_get, n_launch;  // before this launch
  long long n_own;
  int D, n_rounds, Sl, Hs, get, one_by_one, flush_local;
};

__device__ __forceinline__ void red_release_add(unsigned long long* p,
                                                unsigned long long v) {
  asm volatile("red.release.gpu.global.add.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long atom_acq_rel_add(
    unsigned long long* p, unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;"
               : "=l"(old) : "l"(p), "l"(v) : "memory");
  return old;
}

// An element of another SM's writes, read past L1 (not coherent across SMs).
template <typename T>
__device__ __forceinline__ T load_cg(const T* p) {
  if constexpr (sizeof(T) == 2) {
    const unsigned short u =
        __ldcg(reinterpret_cast<const unsigned short*>(p));
    if constexpr (std::is_same_v<T, __nv_bfloat16>)
      return __ushort_as_bfloat16(u);
    else if constexpr (std::is_same_v<T, __half>)
      return __ushort_as_half(u);
    else
      return u;
  } else {
    return __ldcg(p);
  }
}

// store(i, load(i)) for every i < n, kUnroll elements a thread at a time:
// the loads of all kUnroll elements (an index, then the value it points
// at) are in flight together before the first store.
template <class Load, class Store>
__device__ __forceinline__ void each(long long n, Load&& load,
                                     Store&& store) {
  for (long long i = threadIdx.x; i < n; i += kUnroll * kShiftThreads) {
    decltype(load(i)) v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = i + (long long)u * kShiftThreads;
      if (k < n) v[u] = load(k);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = i + (long long)u * kShiftThreads;
      if (k < n) store(k, v[u]);
    }
  }
}

template <typename TC, typename TW>
__global__ void __launch_bounds__(kShiftThreads)
rdma_exchange_kernel(XArgs a) {
  const int me = blockIdx.x;
  const int tid = threadIdx.x;
  const int D = a.D;
  unsigned long long* recv = a.seq;
  unsigned long long* req = a.seq + (long long)a.n_rounds * D;
  unsigned long long* finished = req + (long long)a.n_rounds * D;
  int* abort = reinterpret_cast<int*>(finished + 1);
  const TC* x = static_cast<const TC*>(a.x) + (long long)me * a.n_own;
  TW* win = static_cast<TW*>(a.win);

  // origin side of get: ask the source of every round before any wait
  if (a.get && tid == 0) {
    for (int k = 0; k < a.n_rounds; ++k) {
      const int src = (me - a.rounds[3 * k] + D) % D;
      red_release_add(req + (long long)k * D + src, 1ull);
    }
  }
  for (int k = 0; k < a.n_rounds; ++k) {
    const int off = a.rounds[3 * k], H = a.rounds[3 * k + 1];
    const long long base = a.rounds[3 * k + 2];
    const int dst = (me + off) % D;
    if (a.get) {
      // target side: serve only after the rank that needs ours asked
      if (tid == 0)
        spin_until(req + (long long)k * D + me, a.n_get + 1, abort,
                   (int)kWaitRequest);
      __syncthreads();
    }
    const int* pk = a.pack != nullptr ? a.pack + base + (long long)me * H
                                      : nullptr;
    TW* o = win + base + (long long)dst * H;
    unsigned long long* done = recv + (long long)k * D + dst;
    auto value = [&](long long i) {
      return convert<TW>(x[pk != nullptr ? pk[i] : i]);
    };
    auto put = [&](long long i, TW v) { o[i] = v; };
    if (!a.one_by_one) {
      each(H, value, put);
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        red_release_add(done, 1ull);
      }
    } else if (a.flush_local) {
      for (int i = tid; i < H; i += kShiftThreads) {
        o[i] = value(i);
        __threadfence();
        red_release_add(done, 1ull);
      }
    } else {
      each(H, value, put);
      __threadfence();
      for (int i = tid; i < H; i += kShiftThreads) red_release_add(done, 1ull);
    }
  }
  // the own windows are full when every expected signal has arrived
  if (tid == 0) {
    for (int k = 0; k < a.n_rounds; ++k) {
      const unsigned long long H = a.rounds[3 * k + 1];
      const unsigned long long before = a.n_whole + a.n_obo * H;
      unsigned long long* mine = recv + (long long)k * D + me;
      spin_until(mine, before + (a.one_by_one ? H : 1ull), abort,
                 (int)kWaitData);
      int* st = a.status + 2 * ((long long)k * D + me);
      st[0] = (int)(ld_acquire(mine) - before);
      st[1] = a.get ? (int)(ld_acquire(req + (long long)k * D + me) - a.n_get)
                    : 0;
    }
  }
  __syncthreads();
  if (a.halo != nullptr) {
    const long long n = (long long)a.Sl * a.Hs;
    const int* src = a.unpack + me * n;
    TC* h = static_cast<TC*>(a.halo) + me * n;
    each(
        n,
        [&](long long j) {
          const int s = src[j];
          return s >= 0 ? x[s] : convert<TC>(load_cg(win - 1 - s));
        },
        [&](long long j, TC v) { h[j] = v; });
  }
  // the last rank out reports whether any rank's wait timed out
  if (tid == 0 && atom_acq_rel_add(finished, 1ull) + 1 ==
                      (a.n_launch + 1) * (unsigned long long)D)
    a.status[2LL * a.n_rounds * D] = *(volatile int*)abort;
}

// Calls f(TC{}, TW{}) for a pair of element codes.
template <typename F>
int dispatch_pair(int tc, int tw, F&& f) {
  if (tc == tw) {
    switch (tc) {
      case kU16: return f((unsigned short)0, (unsigned short)0);
      case kU32: return f(0u, 0u);
      case kU64: return f(0ull, 0ull);
    }
  }
  auto halo = [&](auto c) -> int {
    switch (tw) {
      case kF32: return f(c, 0.f);
      case kF64: return f(c, 0.0);
      case kBF16: return f(c, __nv_bfloat16{});
      case kF16: return f(c, __half{});
      default: return (int)cudaErrorInvalidValue;
    }
  };
  switch (tc) {
    case kF32: return halo(0.f);
    case kF64: return halo(0.0);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Co-resident blocks of the kernel on this card: the largest rank count a
// cooperative launch can hold (0 without cooperative launch support).
int rdma_shift_max_ranks(int tc, int tw) {
  int dev = 0, sms = 0, coop = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return 0;
  int per_sm = 0;
  const int rc = dispatch_pair(tc, tw, [&](auto c, auto w) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rdma_exchange_kernel<decltype(c), decltype(w)>,
        kShiftThreads, 0);
  });
  return rc == (int)cudaSuccess ? per_sm * sms : 0;
}

// One exchange of ``n_rounds`` rounds over D ranks; see XArgs for the
// operands.  ``totals``: launches made on ``seq`` before this one with
// whole-buffer signals, with one-by-one signals, in get mode, and in all.
int rdma_exchange(const void* x, const int* pack, const int* unpack,
                  void* halo, void* win, const int* rounds, void* seq,
                  int* status, const unsigned long long* totals,
                  long long n_own, int D, int n_rounds, int Sl, int Hs, int tc,
                  int tw, int get, int one_by_one, int flush_local,
                  void* stream) {
  if (D < 1 || n_rounds < 1 || n_own < 1) return (int)cudaErrorInvalidValue;
  XArgs a{};
  a.x = x;
  a.pack = pack;
  a.unpack = unpack;
  a.halo = halo;
  a.win = win;
  a.rounds = rounds;
  a.seq = static_cast<unsigned long long*>(seq);
  a.status = status;
  a.n_whole = totals[0];
  a.n_obo = totals[1];
  a.n_get = totals[2];
  a.n_launch = totals[3];
  a.n_own = n_own;
  a.D = D;
  a.n_rounds = n_rounds;
  a.Sl = Sl;
  a.Hs = Hs;
  a.get = get;
  a.one_by_one = one_by_one;
  a.flush_local = flush_local;
  void* params[] = {&a};
  return dispatch_pair(tc, tw, [&](auto c, auto w) {
    return (int)cudaLaunchCooperativeKernel(
        (const void*)rdma_exchange_kernel<decltype(c), decltype(w)>, dim3(D),
        dim3(kShiftThreads), params, 0, (cudaStream_t)stream);
  });
}

}  // extern "C"
