// Candidates of the sharded planner, with the cross-shard merge, hand-written
// for Hopper (sm_90a).
//
// Replaces two device steps of the JAX package's planning program
// (adlb_tpu/balancer/distributed.py):
//   * _shard_candidates (:88): per shard, a stable three-key sort of the
//     shard's [Sl, K] task block by (type, prio desc, gid) (_stable_argsort3,
//     adlb_tpu/balancer/solve.py:53) and a top-D window cut from each type's
//     segment, giving cand (prio, gid) [nshards, T, D];
//   * the cross-shard merge of _build_plan_fn (:170-179): the all_gather and
//     two stable sorts of [T, nshards * D] into per-type (prio desc, gid asc)
//     lists.
// gid = rank * K + ki (int32, wrapping as the JAX program's does); prio is
// clamped to +-1e9; a slot is live when prio > -(2^31) + 1 and its type is
// >= 0; padding is (-(2^31) + 1, 2^31 - 1).
//
// One block per (shard, type): nshards * T blocks. Each (prio, gid) pair is
// one 64-bit key whose unsigned order is (prio desc, gid asc), so each block
//   1. streams its shard's slots (several loads in flight per thread; the T
//      blocks of a shard share the rows through L2), keeps the live slots of
//      its type and compacts their keys with warp ballots and one
//      shared-memory atomic per warp;
//   2. when more than D are live, finds the D-th smallest key by a radix
//      select, 8 bits a pass over a 256-bin shared-memory histogram (lanes
//      that share a bin add once, __match_any_sync), stopping at the first
//      pass whose bin is taken whole;
//   3. compacts the survivors (at most D) and sorts them with a bitonic sort
//      in shared memory, padded to a power of two with the padding key.
// Equal keys are equal (prio, gid) pairs, so which of several equal keys
// survives cannot change the output: the result is the JAX sort's, whatever
// its tie order.
//
// With `merge` set, the block writes its sorted keys to `runs` [T, nshards,
// D] instead of the per-shard lists, and the last block of each type to
// finish (a __threadfence, then a per-type atomic ticket that the kernel
// resets itself) merges that type's nshards runs: each key's place in the
// merge is its own index plus, in every other run, the count of smaller keys
// (of keys not larger, for the runs before its own), by binary search over
// the runs staged in shared memory. Keys placed at or past D are dropped. The
// first D entries of the full merge of [T, nshards * D] are the first D of
// the top-D runs (an entry of the global top D is in its own shard's top D),
// and the auction never reads past index C + m < D, so gp, gg [T, D] are all
// the device plan needs: one launch, no sort left on the card.
//
// What bounds it on this card: the bytes are the task table read once (at the
// 10k-row shape 8 x 1250 x 16 slots, 1.3 MB) and [T, D] written, well under a
// microsecond of HBM time; the block's work is a chain of barrier-separated
// passes (the radix passes only when a type has more than D live slots in a
// shard, about log2(D)^2 / 2 bitonic steps over the survivors, the merge's
// binary searches in the last block of each type), so it is latency bound.
// The keys live in shared memory when the shard's slots and the runs fit
// (the 10k-row shape: 20,000 keys, 160 KB), else in a scratch buffer in
// device memory that the caller provides (adlb_candidates_scratch_bytes);
// the kernel is instantiated once for each.
//
// The merge alone (adlb_candidates_merge) serves the device plan across
// cards: each card runs the kernel above without `merge` over its own shard,
// and the merge reads the n cards' [T, D] lists where kernel A wrote them,
// through a table of 2n run base pointers (prio, gid of each card; peer
// pointers under peer access), keeping the first D entries of each type's
// merge by the same rank counting as step 4. It replaces the same JAX step
// (the all_gather and the two stable sorts of _build_plan_fn, :170-179),
// which the JAX program runs replicated on every device. Its bytes are the
// runs read once (n * T * D pairs, n - 1 of them over NVLink across cards)
// and [T, D] written, a few tens of KB at the 10k row, so it is latency
// bound: the design cuts the chain of dependent steps, not the bytes.
//   * n <= 8 (the portable cluster size): one thread-block cluster of n
//     blocks per type, T * n blocks. Block q stages run q of its type only
//     (D pairs, 16-byte loads over the aligned middle), so each run crosses
//     NVLink once and the n runs load in parallel; after a cluster barrier
//     each thread ranks its own key against the other n - 1 runs in their
//     blocks' shared memory (distributed shared memory), the n - 1 binary
//     searches in lockstep so their loads overlap, and writes it straight to
//     its place in gp, gg when that is below D. Block 0 writes the padding
//     past the type's live total; a second cluster barrier keeps every
//     block's shared memory alive until its siblings are done reading.
//   * n > 8: one block per type stages all n runs in shared memory when they
//     fit beside the output (8 (n + 1) D bytes), else each probe reads the
//     pair from device memory; each thread ranks n * D / blockDim keys.

#include <cstddef>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -2147483647;  // padding priority, -(2^31) + 1
constexpr int kPrioClip = 1000000000;
constexpr int kMaxD = 4096;
// The key of the padding pair (kNeg, 2^31 - 1): larger than any live key.
constexpr u64 kPad = 0xFFFFFFFEFFFFFFFFull;

__host__ __device__ __forceinline__ u64 make_key(int p, int g) {
  const unsigned hi = ~((unsigned)p ^ 0x80000000u);
  const unsigned lo = (unsigned)g ^ 0x80000000u;
  return ((u64)hi << 32) | lo;
}
__device__ __forceinline__ int key_prio(u64 k) {
  return (int)(~(unsigned)(k >> 32) ^ 0x80000000u);
}
__device__ __forceinline__ int key_gid(u64 k) {
  return (int)((unsigned)k ^ 0x80000000u);
}

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Byte offsets of the dynamic shared memory: the sort buffer (a power of two
// >= D keys) and, in the shared variant, the key array (the shard's slots, or
// the nshards runs in the merge, whichever is larger).
struct Layout {
  size_t sorted, keys, bytes;
  int P, cap;
};

__host__ __device__ inline Layout layout(int ns, int Sl, int K, int D,
                                         bool shared_keys) {
  Layout l;
  l.P = pow2_at_least(D);
  const long long slots = (long long)Sl * K, runs = (long long)ns * D;
  l.cap = (int)(slots > runs ? slots : runs);
  l.sorted = 0;
  l.keys = 8 * (size_t)l.P;
  l.bytes = l.keys + (shared_keys ? 8 * (size_t)l.cap : 0);
  return l;
}

// Dynamic shared memory the shared variant may take (set at init).
int g_max_dyn = 0;

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
candidates_kernel(const int* __restrict__ tp, const int* __restrict__ tt,
                  const int* __restrict__ rk, long long tp_rs, long long tt_rs,
                  long long rk_rs, int ns, int Sl, int K, int T, int D,
                  int merge, int* __restrict__ cp, int* __restrict__ cg,
                  int* __restrict__ gp, int* __restrict__ gg,
                  u64* __restrict__ runs, int* __restrict__ counters,
                  u64* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned hist[256];
  __shared__ int s_n, s_cnt, s_eq, s_digit, s_before, s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1;
  const int s = blockIdx.x / T, t = blockIdx.x - s * T;
  const Layout lay = layout(ns, Sl, K, D, kShared);
  u64* sorted = (u64*)(smem + lay.sorted);
  u64* keys = kShared ? (u64*)(smem + lay.keys)
                      : scratch + (size_t)blockIdx.x * lay.cap;
  const int nslots = Sl * K;

  if (tid == 0) {
    s_n = 0;
    s_cnt = 0;
    s_eq = 0;
  }
  __syncthreads();

  // 1. the live slots of type t in shard s, one key each, compacted
  for (int i0 = 0; i0 < nslots; i0 += kThreads * kUnroll) {
    int pv[kUnroll], tv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads + tid;
      pv[u] = kNeg;
      tv[u] = -1;
      gv[u] = 0;
      if (i < nslots) {
        const int row = i / K, ki = i - row * K;
        const size_t r = (size_t)s * Sl + row;
        pv[u] = tp[r * tp_rs + ki];
        tv[u] = tt[r * tt_rs + ki];
        gv[u] = (int)((unsigned)rk[r * rk_rs] * (unsigned)K + (unsigned)ki);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool hit = pv[u] > kNeg && tv[u] == t;
      const unsigned b = __ballot_sync(kFull, hit);
      int base = 0;
      if (lane == 0 && b) base = atomicAdd(&s_n, __popc(b));
      base = __shfl_sync(kFull, base, 0);
      if (hit) {
        const int p = min(max(pv[u], -kPrioClip), kPrioClip);
        keys[base + __popc(b & below)] = make_key(p, gv[u]);
      }
    }
  }
  __syncthreads();
  const int n = s_n;

  // 2. the survivors: every key whose bits under `mask` are below `prefix`,
  // and `rank` of the keys equal to it there (all n when n <= D)
  u64 prefix = 0, mask = 0;
  int rank = n;
  if (n > D) {
    rank = D;
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int i = tid; i < 256; i += kThreads) hist[i] = 0;
      __syncthreads();
      for (int i0 = 0; i0 < n; i0 += kThreads) {
        const int i = i0 + tid;
        int d = -1;
        if (i < n) {
          const u64 k = keys[i];
          if ((k & mask) == prefix) d = (int)((k >> shift) & 255u);
        }
        const unsigned peers = __match_any_sync(kFull, d);
        if (d >= 0 && lane == __ffs(peers) - 1)
          atomicAdd(&hist[d], (unsigned)__popc(peers));
      }
      __syncthreads();
      if (warp == 0) {
        unsigned c[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c[j] = hist[lane * 8 + j];
          sum += c[j];
        }
        unsigned incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        const unsigned excl = incl - sum, want = (unsigned)rank;
        if (excl < want && want <= incl) {
          unsigned acc = excl;
          int j = 0;
          while (acc + c[j] < want) acc += c[j++];
          s_digit = lane * 8 + j;
          s_before = (int)acc;
        }
      }
      __syncthreads();
      const int digit = s_digit;
      rank -= s_before;
      prefix |= (u64)digit << shift;
      mask |= (u64)255 << shift;
      const bool whole = (unsigned)rank == hist[digit];
      __syncthreads();  // hist is cleared next pass
      if (whole) break;  // every key of this bin survives
    }
  }
  const bool all = n <= D;
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + tid;
    bool keep = false, eq = false;
    u64 k = 0;
    if (i < n) {
      k = keys[i];
      const u64 hi = k & mask;
      keep = all || hi < prefix;
      eq = !keep && hi == prefix;
    }
    const unsigned be = __ballot_sync(kFull, eq);
    if (be) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&s_eq, __popc(be));
      base = __shfl_sync(kFull, base, 0);
      if (eq) keep = base + __popc(be & below) < rank;
    }
    const unsigned bk = __ballot_sync(kFull, keep);
    if (bk) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&s_cnt, __popc(bk));
      base = __shfl_sync(kFull, base, 0);
      if (keep) sorted[base + __popc(bk & below)] = k;
    }
  }
  const int take = all ? n : D;
  for (int i = take + tid; i < lay.P; i += kThreads) sorted[i] = kPad;
  __syncthreads();

  // 3. bitonic sort of the survivors, ascending
  const int P = pow2_at_least(take > 1 ? take : 1);
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < (P >> 1); i += kThreads) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1)), hi = lo + j;
        const u64 a = sorted[lo], b = sorted[hi];
        if ((a > b) == ((lo & k) == 0)) {
          sorted[lo] = b;
          sorted[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  if (!merge) {
    const size_t at = ((size_t)s * T + t) * D;
    for (int i = tid; i < D; i += kThreads) {
      const u64 k = sorted[i];
      cp[at + i] = key_prio(k);
      cg[at + i] = key_gid(k);
    }
    return;
  }
  u64* run = runs + ((size_t)t * ns + s) * D;
  for (int i = tid; i < D; i += kThreads) run[i] = sorted[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[t], 1) == ns - 1;
  __syncthreads();
  if (!s_last) return;

  // 4. the last block of type t merges the type's nshards runs
  if (tid == 0) counters[t] = 0;  // ready for the next launch
  const int L = ns * D;
  const u64* src = runs + (size_t)t * L;
  for (int i = tid; i < L; i += kThreads) keys[i] = __ldcg(src + i);
  for (int i = tid; i < D; i += kThreads) sorted[i] = kPad;
  __syncthreads();
  for (int e = tid; e < L; e += kThreads) {
    const u64 k = keys[e];
    if (k == kPad) continue;  // padding: the output starts padded
    const int r = e / D;
    int pos = e - r * D;
    for (int q = 0; q < ns && pos < D; ++q) {
      if (q == r) continue;
      const u64* other = keys + (size_t)q * D;
      int lo = 0, hi = D - pos;  // counts past D - pos place it past D
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const u64 v = other[mid];
        if (q < r ? v <= k : v < k)
          lo = mid + 1;
        else
          hi = mid;
      }
      pos += lo;
    }
    if (pos < D) sorted[pos] = k;
  }
  __syncthreads();
  for (int i = tid; i < D; i += kThreads) {
    const u64 k = sorted[i];
    gp[(size_t)t * D + i] = key_prio(k);
    gg[(size_t)t * D + i] = key_gid(k);
  }
}

bool fits_shared(int ns, int Sl, int K, int D) {
  return layout(ns, Sl, K, D, true).bytes <= (size_t)g_max_dyn;
}

// Dynamic shared memory the merge's staged variant may take (set at init).
int g_merge_max_dyn = 0;

// The largest cluster the merge launches (the portable limit).
constexpr int kMaxCluster = 8;

// Writes one word of each of the D keys at `words` (two words a key, low
// first) from the D int32 at `src`: the high word from a prio (kPrio), the
// low word from a gid, as make_key packs them. 16-byte loads over the
// aligned middle of `src`, one int at a time over its ragged ends.
template <bool kPrio>
__device__ __forceinline__ void put_word(unsigned* words, int i, int x) {
  if (kPrio)
    words[2 * i + 1] = ~((unsigned)x ^ 0x80000000u);
  else
    words[2 * i] = (unsigned)x ^ 0x80000000u;
}

template <bool kPrio>
__device__ __forceinline__ void stage_words(const int* __restrict__ src,
                                            unsigned* words, int D) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int head = min(D, (int)((16 - ((size_t)src & 15)) & 15) >> 2);
  const int nvec = (D - head) >> 2, tail = head + 4 * nvec;
  const int4* v = reinterpret_cast<const int4*>(src + head);
  for (int j = tid; j < nvec; j += nth) {
    const int4 x = v[j];
    const int i = head + 4 * j;
    put_word<kPrio>(words, i, x.x);
    put_word<kPrio>(words, i + 1, x.y);
    put_word<kPrio>(words, i + 2, x.z);
    put_word<kPrio>(words, i + 3, x.w);
  }
  for (int j = tid; j < head + D - tail; j += nth) {
    const int i = j < head ? j : tail + (j - head);
    put_word<kPrio>(words, i, src[i]);
  }
}

// The first D entries of each type's merge of n <= kMaxCluster runs, one
// cluster of n blocks per type: block q of cluster t holds run q of type t,
// the (prio, gid) pairs at table[2q] + t * D and table[2q + 1] + t * D,
// ascending by key (prio desc, gid asc) and padded. Equal keys keep the
// order of their runs (the stable merge of the runs in card order).
__global__ void __launch_bounds__(kThreads)
merge_cluster_kernel(const int* const* __restrict__ table, int D,
                     int* __restrict__ gp, int* __restrict__ gg) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_live;
  u64* keys = (u64*)smem;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int tid = threadIdx.x, nth = blockDim.x;
  const size_t at = (size_t)(blockIdx.x / n) * D;

  if (tid == 0) s_live = 0;
  stage_words<true>(table[2 * q] + at, (unsigned*)keys, D);
  stage_words<false>(table[2 * q + 1] + at, (unsigned*)keys, D);
  __syncthreads();
  // the run's live length: padding sorts last
  for (int i = tid; i < D; i += nth)
    if (keys[i] != kPad && (i + 1 == D || keys[i + 1] == kPad)) s_live = i + 1;
  cluster.sync();

  const u64* other[kMaxCluster];
#pragma unroll
  for (int p = 0; p < kMaxCluster; ++p)
    other[p] = cluster.map_shared_rank(keys, p < n ? p : q);
  int top = 1;
  while (2 * top <= D) top <<= 1;
  const int live = s_live;
  for (int i = tid; i < live; i += nth) {
    const u64 k = keys[i];
    // in each other run, the count of keys placed before k: smaller ones,
    // and equal ones of the runs before q
    int cnt[kMaxCluster];
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p) cnt[p] = 0;
    for (int step = top; step > 0; step >>= 1) {
#pragma unroll
      for (int p = 0; p < kMaxCluster; ++p) {
        const int j = cnt[p] + step;
        if (p < n && p != q && j <= D) {
          const u64 v = other[p][j - 1];
          if (p < q ? v <= k : v < k) cnt[p] = j;
        }
      }
    }
    int pos = i;
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p) pos += cnt[p];
    if (pos < D) {
      gp[at + pos] = key_prio(k);
      gg[at + pos] = key_gid(k);
    }
  }
  if (q == 0) {  // the live keys fill [0, total); padding after them
    int total = 0;
    for (int p = 0; p < n; ++p) total += *cluster.map_shared_rank(&s_live, p);
    for (int i = min(total, D) + tid; i < D; i += nth) {
      gp[at + i] = kNeg;
      gg[at + i] = 0x7FFFFFFF;
    }
  }
  cluster.sync();  // no block leaves while a sibling reads its keys
}

// The first D entries of each type's merge of n runs, one block per type:
// run q of type t at table[2q] + t * D (prio) and table[2q + 1] + t * D
// (gid), ascending by key (prio desc, gid asc) and padded. Equal keys keep
// the order of their runs (the stable merge of the runs in card order).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
merge_kernel(const int* const* __restrict__ table, int n, int D,
             int* __restrict__ gp, int* __restrict__ gg) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* sorted = (u64*)smem;
  u64* keys = sorted + D;  // staged variant only
  const int tid = threadIdx.x, t = blockIdx.x, L = n * D;
  auto key_at = [&](int q, int i) -> u64 {
    if constexpr (kStaged) {
      return keys[(size_t)q * D + i];
    } else {
      const size_t at = (size_t)t * D + i;
      return make_key(__ldg(table[2 * q] + at), __ldg(table[2 * q + 1] + at));
    }
  };
  if constexpr (kStaged) {
    for (int e = tid; e < L; e += kThreads) {
      const int q = e / D;
      const size_t at = (size_t)t * D + (e - q * D);
      keys[e] = make_key(table[2 * q][at], table[2 * q + 1][at]);
    }
  }
  for (int i = tid; i < D; i += kThreads) sorted[i] = kPad;
  __syncthreads();
  for (int e = tid; e < L; e += kThreads) {
    const int r = e / D;
    int pos = e - r * D;
    const u64 k = key_at(r, pos);
    if (k == kPad) continue;  // padding: the output starts padded
    for (int q = 0; q < n && pos < D; ++q) {
      if (q == r) continue;
      int lo = 0, hi = D - pos;  // counts past D - pos place it past D
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const u64 v = key_at(q, mid);
        if (q < r ? v <= k : v < k)
          lo = mid + 1;
        else
          hi = mid;
      }
      pos += lo;
    }
    if (pos < D) sorted[pos] = k;
  }
  __syncthreads();
  for (int i = tid; i < D; i += kThreads) {
    const u64 k = sorted[i];
    gp[(size_t)t * D + i] = key_prio(k);
    gg[(size_t)t * D + i] = key_gid(k);
  }
}

size_t merge_staged_bytes(int n, int D) { return 8 * ((size_t)n + 1) * D; }

}  // namespace

extern "C" {

// Once per card, after loading, with that card current: lets every variant
// use all the shared memory a block may have there (a function attribute is
// kept per card; the limits read are the same on cards of one kind).
// Returns the CUDA error code.
int adlb_candidates_init() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr, mattr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, candidates_kernel<true>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&mattr, merge_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  g_max_dyn = optin - (int)attr.sharedSizeBytes;
  g_merge_max_dyn = optin - (int)mattr.sharedSizeBytes;
  err = cudaFuncSetAttribute(candidates_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g_max_dyn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(candidates_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               g_max_dyn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(merge_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               g_merge_max_dyn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(merge_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               8 * kMaxD);
  return (int)err;
}

// With the planning card current: lets its kernels read `peer`'s memory
// (cudaDeviceEnablePeerAccess). Access that is already enabled, by an
// earlier call or by PyTorch, counts as success. Returns the CUDA error
// code.
int adlb_candidates_enable_peer(int peer) {
  const cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  cudaGetLastError();  // returned here: leave no error for the next launch
  return err == cudaErrorPeerAccessAlreadyEnabled ? 0 : (int)err;
}

// Bytes of device scratch a launch at (nshards, Sl, K, T, D) needs: 0 when
// the keys fit in shared memory (after adlb_candidates_init), else one key
// array per block.
long long adlb_candidates_scratch_bytes(int ns, int Sl, int K, int T, int D) {
  if (fits_shared(ns, Sl, K, D)) return 0;
  return 8LL * ns * T * layout(ns, Sl, K, D, false).cap;
}

// The largest D a launch takes (the sort buffer's power of two stays in
// shared memory).
int adlb_candidates_max_d() { return kMaxD; }

// Launches the candidates on `stream`. tp, tt: int32, element (shard, row,
// ki) at (shard * Sl + row) * *_rs + ki; rk: int32 at (shard * Sl + row) *
// rk_rs. merge == 0: writes cp, cg [nshards, T, D]; merge != 0: writes gp, gg
// [T, D], with runs holding T * nshards * D keys and counters T ints that
// are 0 before the first launch (the kernel leaves them 0). `scratch` holds
// adlb_candidates_scratch_bytes bytes, or is null when that is 0. Returns
// the CUDA error code of the launch; does not synchronise.
int adlb_candidates(const int* tp, const int* tt, const int* rk,
                    long long tp_rs, long long tt_rs, long long rk_rs, int ns,
                    int Sl, int K, int T, int D, int merge, int* cp, int* cg,
                    int* gp, int* gg, u64* runs, int* counters, u64* scratch,
                    void* stream) {
  if (ns < 1 || Sl < 1 || K < 1 || T < 1 || D < 1 || D > kMaxD ||
      (long long)Sl * K >= (1LL << 31) || (long long)ns * D >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (merge ? (gp == nullptr || gg == nullptr || runs == nullptr ||
               counters == nullptr)
            : (cp == nullptr || cg == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(ns * T));
  if (fits_shared(ns, Sl, K, D)) {
    candidates_kernel<true><<<grid, kThreads, layout(ns, Sl, K, D, true).bytes,
                              (cudaStream_t)stream>>>(
        tp, tt, rk, tp_rs, tt_rs, rk_rs, ns, Sl, K, T, D, merge, cp, cg, gp,
        gg, runs, counters, nullptr);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    candidates_kernel<false>
        <<<grid, kThreads, layout(ns, Sl, K, D, false).bytes,
           (cudaStream_t)stream>>>(tp, tt, rk, tp_rs, tt_rs, rk_rs, ns, Sl, K,
                                   T, D, merge, cp, cg, gp, gg, runs, counters,
                                   scratch);
  }
  return (int)cudaGetLastError();
}

// The variant a merge of n runs of D takes (after adlb_candidates_init):
// 0, one cluster of n blocks per type (n <= 8); 1, one block per type with
// the runs staged in shared memory; 2, one block per type reading the runs
// from device memory.
int adlb_candidates_merge_variant(int n, int D) {
  if (n <= kMaxCluster) return 0;
  return merge_staged_bytes(n, D) <= (size_t)g_merge_max_dyn ? 1 : 2;
}

// Launches the merge alone on `stream`. `table`: 2n device pointers, readable
// from the current card (its own memory, or a peer's under peer access):
// run q's prios at table[2q] and gids at table[2q + 1], type t's D pairs
// from + t * D, each run sorted by (prio desc, gid asc) and padded with
// (-(2^31) + 1, 2^31 - 1). Writes gp, gg [T, D], the first D entries of each
// type's merge. Returns the CUDA error code of the launch; does not
// synchronise.
int adlb_candidates_merge(const int* const* table, int n, int T, int D,
                          int* gp, int* gg, void* stream) {
  if (n < 1 || T < 1 || D < 1 || D > kMaxD ||
      (long long)n * D >= (1LL << 31) || (long long)n * T >= (1LL << 31) ||
      table == nullptr || gp == nullptr || gg == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (adlb_candidates_merge_variant(n, D)) {
    case 0: {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3((unsigned)(n * T));
      // one thread a key, in whole warps
      const int threads = (D + 31) / 32 * 32;
      cfg.blockDim = dim3((unsigned)(threads < kThreads ? threads : kThreads));
      cfg.dynamicSmemBytes = 8 * (size_t)D;
      cfg.stream = s;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = (unsigned)n;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      const cudaError_t err =
          cudaLaunchKernelEx(&cfg, merge_cluster_kernel, table, D, gp, gg);
      if (err != cudaSuccess) {
        cudaGetLastError();  // returned here: leave no stale error behind
        return (int)err;
      }
      break;
    }
    case 1:
      merge_kernel<true><<<(unsigned)T, kThreads, merge_staged_bytes(n, D),
                           s>>>(table, n, D, gp, gg);
      break;
    default:
      merge_kernel<false><<<(unsigned)T, kThreads, 8 * (size_t)D, s>>>(
          table, n, D, gp, gg);
  }
  return (int)cudaGetLastError();
}

const char* adlb_candidates_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
