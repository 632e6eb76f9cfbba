// A chain of block barriers in one thread block, for timing one barrier's
// latency on the card: the auction kernel's chain bound (csrc/auction.cu)
// is its rounds times its barriers a round times that latency. Built and
// timed by scripts/time_auction.py (barrier_ms).

#include <cuda_runtime.h>

namespace {

__global__ void barrier_chain(int iters, int* sink) {
  __shared__ int x;
  if (threadIdx.x == 0) x = 0;
  __syncthreads();
  for (int i = 0; i < iters; ++i) {
    if (threadIdx.x == (unsigned)(i & 31)) x += i;
    __syncthreads();
  }
  if (threadIdx.x == 0) *sink = x;
}

}  // namespace

extern "C" {

// Launches `iters` block barriers in one block of `threads` threads on
// `stream` (sink: one int of device memory). Returns the CUDA error code.
int adlb_barrier_chain(int threads, int iters, int* sink, void* stream) {
  barrier_chain<<<1, threads, 0, (cudaStream_t)stream>>>(iters, sink);
  return (int)cudaGetLastError();
}

}  // extern "C"
