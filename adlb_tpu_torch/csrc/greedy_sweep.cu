// Greedy assignment sweep for the planned balancer, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel adlb_tpu/balancer/pallas_solve.py
// (_greedy_sweep_kernel under pallas_greedy_assign): tasks are taken in
// stable descending-priority order, and each live task takes the
// lowest-index open requester whose type mask accepts it; that requester
// then closes. The output is assign[NR]: the task index each requester got,
// or -1.
//
// Inputs, prepared by the wrapper (adlb_tpu_torch/balancer/greedy_sweep.py):
//   s_type   [NT] int32  type index of the k-th task in priority order, or -1
//                        when that task is not live (padding, or a type >= T)
//   order    [NT] int32  original index of the k-th task in priority order
//   typebits [T, W] u32  bit r of row t: requester r is valid and accepts t
//                        (W = ceil(NR / 32))
//
// What bounds it on this card: the sweep is a dependent chain, one step per
// live task until no open requester is left, run by a single warp; besides
// the chain it reads about 8 * NT + T * NR / 8 bytes, microseconds of HBM
// time at the main path's shapes. So the design keeps each step short and
// skips steps rather than widening them:
//   * A compat row depends only on the task's type, so no [NT, NR] matrix
//     exists: a step ANDs the type's row of typebits with the open bitmask
//     (shared memory), 32 words per warp-wide probe, and takes the first set
//     bit with __ballot_sync / __ffs.
//   * Open bits only ever clear, so the lowest open compatible requester of a
//     type only moves up: each type keeps a cursor to the first word that may
//     still hold one, and a probe starts there. A type whose cursor runs off
//     the end is dead; its later tasks cost one shared-memory read. In all,
//     the probes read O(NT + T * NR / 32) words.
//   * The sweep stops once the count of open matchable requesters is zero.
//   * The winner is written straight into assign[], so no inversion pass
//     follows.
//   * Task rows stream through double-buffered shared-memory tiles, loaded by
//     the other seven warps while warp 0 sweeps the current tile.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // warp 0 sweeps, warps 1..7 load tiles
constexpr int kTile = 4096;    // tasks per shared-memory tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load_tile(int* tile_type, int* tile_order,
                                          const int* __restrict__ s_type,
                                          const int* __restrict__ order,
                                          int base, int n, int first,
                                          int stride) {
  for (int x = first; x < n; x += stride) {
    tile_type[x] = s_type[base + x];
    tile_order[x] = order[base + x];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
greedy_sweep_kernel(const int* __restrict__ s_type,
                    const int* __restrict__ order,
                    const unsigned* __restrict__ typebits,
                    int* __restrict__ assign, int nt, int nr, int ntypes,
                    int nwords) {
  extern __shared__ unsigned smem[];
  unsigned* open = smem;                          // [nwords]
  int* cursor = reinterpret_cast<int*>(open + nwords);  // [ntypes]
  int* tile_type = cursor + ntypes;               // [2][kTile]
  int* tile_order = tile_type + 2 * kTile;        // [2][kTile]
  // open matchable requesters at the start of tile i, in slot i & 1: warp 0
  // writes slot (i + 1) & 1 while the others may still read slot i & 1
  __shared__ int nopen_s[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) nopen_s[0] = 0;
  __syncthreads();
  int cnt = 0;
  for (int w = tid; w < nwords; w += kThreads) {
    unsigned m = 0u;
    for (int t = 0; t < ntypes; ++t) m |= typebits[(size_t)t * nwords + w];
    open[w] = m;  // matchable = valid with a non-empty type mask
    cnt += __popc(m);
  }
  if (cnt) atomicAdd(&nopen_s[0], cnt);
  for (int t = tid; t < ntypes; t += kThreads) cursor[t] = 0;
  for (int r = tid; r < nr; r += kThreads) assign[r] = -1;
  const int ntiles = (nt + kTile - 1) / kTile;
  if (ntiles > 0)
    load_tile(tile_type, tile_order, s_type, order, 0, min(kTile, nt), tid,
              kThreads);
  __syncthreads();

  for (int i = 0; i < ntiles; ++i) {
    if (nopen_s[i & 1] == 0) break;  // uniform: read after the barrier
    const int buf = (i & 1) * kTile;
    const int n = min(kTile, nt - i * kTile);
    if (warp == 0) {
      const int* ty = tile_type + buf;
      const int* od = tile_order + buf;
      int nopen = nopen_s[i & 1];  // the same value in every lane
      for (int g = 0; g < n && nopen > 0; g += 32) {
        const int myt = (g + lane < n) ? ty[g + lane] : -1;
        // a superset of the tasks that can still match: a type may die
        // later in this group, which the probe loop below sees
        unsigned pend = __ballot_sync(kFull, myt >= 0 && cursor[myt] < nwords);
        while (pend && nopen > 0) {
          const int j = __ffs(pend) - 1;
          pend &= pend - 1;
          const int t = __shfl_sync(kFull, myt, j);
          const unsigned* row = typebits + (size_t)t * nwords;
          int c = cursor[t];
          bool found = false;
          while (c < nwords) {
            const int w = c + lane;
            const unsigned bits = (w < nwords) ? (__ldg(row + w) & open[w]) : 0u;
            const unsigned hit = __ballot_sync(kFull, bits != 0u);
            if (hit) {
              if (lane == __ffs(hit) - 1) {
                const int b = __ffs(bits) - 1;
                open[w] = open[w] & ~(1u << b);
                assign[w * 32 + b] = od[g + j];
                cursor[t] = w;
              }
              found = true;
              break;
            }
            c += 32;
          }
          if (found) {
            --nopen;
          } else if (lane == 0) {
            cursor[t] = nwords;  // dead type: no open requester takes it
          }
          __syncwarp();  // lane writes to open/cursor visible to the warp
        }
      }
      if (lane == 0) nopen_s[(i + 1) & 1] = nopen;
    } else if (i + 1 < ntiles) {
      const int base = (i + 1) * kTile;
      load_tile(tile_type + (kTile - buf), tile_order + (kTile - buf), s_type,
                order, base, min(kTile, nt - base), tid - 32, kThreads - 32);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the launch needs, in bytes.
long long adlb_greedy_sweep_smem(int nr, int ntypes) {
  const long long nwords = (nr + 31) / 32;
  return 4LL * (nwords + ntypes + 4LL * kTile);
}

// Launches the sweep on `stream`; returns the CUDA error code of the
// attribute call or of the launch (0 = cudaSuccess). Does not synchronise.
int adlb_greedy_sweep(const int* s_type, const int* order,
                      const unsigned* typebits, int* assign, int nt, int nr,
                      int ntypes, void* stream) {
  const int nwords = (nr + 31) / 32;
  const int smem = (int)adlb_greedy_sweep_smem(nr, ntypes);
  cudaError_t err = cudaFuncSetAttribute(
      greedy_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  greedy_sweep_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      s_type, order, typebits, assign, nt, nr, ntypes, nwords);
  return (int)cudaGetLastError();
}

const char* adlb_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
