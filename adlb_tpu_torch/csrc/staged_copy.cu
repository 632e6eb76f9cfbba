// A staged upload in one call: an asynchronous host-to-device copy from
// pinned memory on a stream, then an event recorded there that marks the
// copy landed. The sharded planner ships its changed task and requester
// rows this way (adlb_tpu_torch/balancer/staged_copy.py, loaded with
// ctypes); through torch the copy, the event and the card made current
// cost about three times the host time of this call.

#include <cuda_runtime.h>

extern "C" {

// Copies `nbytes` of pinned host memory to the device on `stream`, then
// records `event` there (when not null). Returns the CUDA error code; does
// not synchronise.
int adlb_staged_copy(void* dst, const void* src, long long nbytes,
                     void* stream, void* event) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(dst, src, (size_t)nbytes,
                                    cudaMemcpyHostToDevice, st);
  if (err == cudaSuccess && event != nullptr)
    err = cudaEventRecord((cudaEvent_t)event, st);
  return (int)err;
}

const char* adlb_staged_copy_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
