// Device windows shared by the processes of a group on one host, through
// CUDA IPC: the role of MPI_Win_create in the reference and of the remote
// memory a multi-controller JAX mesh reaches over ICI.
//
// Replaces no TPU kernel: it holds no kernel at all.  It is the mapping
// under K4 (rdma_shift.cu) and K5-K7 (async_ras*.cu) across processes:
// each process allocates its window with cudaMalloc (not PyTorch's caching
// allocator, whose blocks are sub-allocated and may sit in expandable
// segments that IPC cannot export), exports its 64-byte handle, and opens
// every peer's handle; the kernels then address rank q's rings at
// table[q / Dl] + (q % Dl) * stride (async_common.cuh RankRings).
//
// Every entry point returns a cudaError_t as int (0 on success).
#include <cuda_runtime.h>

#include <cstring>

extern "C" {

// A zeroed device buffer of ``nbytes`` on the current device; its address
// goes to *ptr.
int peer_window_alloc(unsigned long long nbytes, unsigned long long* ptr) {
  void* p = nullptr;
  cudaError_t e = cudaMalloc(&p, nbytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(p, 0, nbytes);
  if (e != cudaSuccess) {
    cudaFree(p);
    return (int)e;
  }
  *ptr = (unsigned long long)p;
  return 0;
}

// The IPC handle of a buffer from peer_window_alloc, as 64 bytes.
int peer_window_handle(unsigned long long ptr, unsigned char* out) {
  static_assert(sizeof(cudaIpcMemHandle_t) == 64, "64-byte IPC handles");
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, (void*)ptr);
  if (e != cudaSuccess) return (int)e;
  std::memcpy(out, &h, sizeof(h));
  return 0;
}

// A peer's buffer mapped into this process; its address here goes to *ptr.
int peer_window_open(const unsigned char* handle, unsigned long long* ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  void* p = nullptr;
  const cudaError_t e =
      cudaIpcOpenMemHandle(&p, h, cudaIpcMemLazyEnablePeerAccess);
  if (e != cudaSuccess) return (int)e;
  *ptr = (unsigned long long)p;
  return 0;
}

int peer_window_close(unsigned long long ptr) {
  return (int)cudaIpcCloseMemHandle((void*)ptr);
}

int peer_window_free(unsigned long long ptr) {
  return (int)cudaFree((void*)ptr);
}

// Stream-ordered zeroing of bytes [offset, offset + n) of an own window.
int peer_window_zero(unsigned long long ptr, unsigned long long offset,
                     unsigned long long n, void* stream) {
  return (int)cudaMemsetAsync((char*)ptr + offset, 0, n,
                              (cudaStream_t)stream);
}

// Copies n bytes at ptr + offset (an own or a mapped peer window) to host
// memory; the caller has synchronized the work that writes them.
int peer_window_read(unsigned long long ptr, unsigned long long offset,
                     void* host, unsigned long long n) {
  return (int)cudaMemcpy(host, (const char*)ptr + offset, n,
                         cudaMemcpyDeviceToHost);
}

}  // extern "C"
