// Shared pieces of the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

// One value from type From to type To, as PyTorch's cast computes it: a
// double goes to bfloat16 and float16 through float.  K2 rounds halo values
// through the halo type with it, K4 packs and unpacks with it.
template <typename To, typename From>
__device__ __forceinline__ To convert(From v) {
  if constexpr (std::is_same_v<To, From>) {
    return v;
  } else if constexpr (std::is_same_v<To, __nv_bfloat16>) {
    return __float2bfloat16((float)v);   // via float, as PyTorch's cast
  } else if constexpr (std::is_same_v<To, __half>) {
    return __float2half((float)v);
  } else if constexpr (std::is_same_v<From, __nv_bfloat16>) {
    return (To)__bfloat162float(v);
  } else if constexpr (std::is_same_v<From, __half>) {
    return (To)__half2float(v);
  } else {
    return (To)v;
  }
}

// Diagonal offsets of a DIA operator, passed by value in the kernel
// parameters (the host copies the wrapper's offsets in).
constexpr int kMaxDiags = 32;
struct Offsets {
  int v[kMaxDiags];
};

inline Offsets make_offsets(const int* offs, int K) {
  Offsets o{};
  for (int k = 0; k < K && k < kMaxDiags; ++k) o.v[k] = offs[k];
  return o;
}

// Row i of a pure-DIA product: sum_k d[k, i] * v[i + off_k], reading zero
// outside [0, R).  ``d`` points at one subdomain's (K, R) diagonal block.
// KC is K when known at compile time (the loop unrolls, so all 2K loads are
// in flight at once and the offsets stay in the parameter space), else 0.
template <int KC, typename T>
__device__ __forceinline__ T dia_row(const T* __restrict__ d, const T* v,
                                     long long i, int K, int R,
                                     const Offsets& offs) {
  const int nk = KC > 0 ? KC : K;
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < nk; ++k) {
    const long long c = i + offs.v[k];
    const T xv = (c >= 0 && c < R) ? v[c] : T(0);
    acc += d[(long long)k * R + i] * xv;
  }
  return acc;
}

// Calls f(std::integral_constant<int, K>) for the common diagonal counts
// 1..9, and f(std::integral_constant<int, 0>) (run-time K) otherwise.
template <typename F>
int dispatch_diags(int K, F&& f) {
  switch (K) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 9: return f(std::integral_constant<int, 9>{});
    default: return f(std::integral_constant<int, 0>{});
  }
}
