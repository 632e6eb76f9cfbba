// Auction rounds of the sharded planner, hand-written for Hopper (sm_90a).
//
// Replaces the device loop of the JAX package's fused planning program:
// adlb_tpu/balancer/distributed.py, _build_plan_fn (:136), the
// lax.while_loop over `body` (:190-240) and `cond` (:242-243); its
// candidates and merge are csrc/candidates.cu. Given the merged per-type
// candidate lists (prio desc, gid asc) and the requester slot tables over
// host-compacted requester ids, each round
//   1. takes the next m + 1 untaken candidates of each type (the head slice;
//      the (m + 1)-th is the type's truncation sentinel),
//   2. pairs the rank-j candidate with the type's j-th open slot,
//   3. resolves each requester's conflicts by (max prio, then min gid),
//   4. sets a global threshold: the best key among the losers and among the
//      sentinels of the types that still have an open slot,
//   5. commits, per type, the winners above the threshold that no loss of a
//      lower rank blocks (a prefix), closing their requesters,
// and the loop ends after `rounds` rounds or after a round with no commit.
// The output is assigned[T, C + 1]: the gid committed to each slot, or -1
// (column C is the JAX program's scatter dump and stays -1), then one int:
// the number of rounds run.
//
// Inputs (the wrapper is adlb_tpu_torch/balancer/auction.py):
//   gp, gg  [T, L] int32  merged candidate (prio, gid) lists; padding is
//                         (-(2^31) + 1, 2^31 - 1). The device plan hands
//                         over L = D = C + m + 1 (candidates.cu's merge);
//                         any L works, and no round reads past C + m.
//   rwc     [T, C] int32  compacted requester id per slot (U = T * C for an
//                         empty slot: the dump id)
//   lens    [T]    int32  slots per type
//   open0   [U+1]  u8     bool: compacted id u is a real, open requester
//
// What bounds it on this card: the rounds are a dependent chain (each reads
// what the last one closed), so the whole loop runs in one thread block, and
// its bytes (at most C + m + 1 entries of each type's list, plus the tables)
// take well under a microsecond of HBM time: it is latency bound, by the
// rounds' block barriers and what runs between them. The design:
//   * the lists' first C + m + 1 columns (35 KB at the 10k-row shape), the
//     slot table and the open flags are staged into shared memory once, at
//     the start, with cp.async (16 bytes a copy where aligned), while the
//     rest of the working set is initialised; the rounds' head slices and
//     slot scans then read shared memory, not L2;
//   * a (prio, gid) pair is one 64-bit key ordered as (prio asc, gid desc),
//     so "max prio, then min gid" is one atomicMax per entry, for the
//     per-requester winner and for the global threshold alike, and the
//     commit test is one compare;
//   * a block with as many threads as a round has work (a warp per type, a
//     thread per (type, rank) entry; 256 at the 10k-row shape), since a
//     barrier's cost grows with the warps it waits for;
//   * three barriers a round: one warp per type finds its first m open
//     slots (__ballot_sync ranks them; the first slot that may still be
//     open is kept, since slots only ever close), reads its head slice,
//     pairs it and posts each requester's best key; then every entry
//     learns whether it won (losers and the sentinels of the types with an
//     open slot raise the threshold); then one warp per type commits its
//     prefix. Each shared scalar is reset by one thread between the barrier
//     after its last read and the barrier before its next write, so no
//     barrier is spent on resets.
// The working set (requester winners over U + 1 ids, open flags, the slot
// table and the per-entry state, about 13 T C + 21 T m bytes, plus the
// staged lists, 8 T (C + m + 1) bytes) lives in shared memory with the
// lists staged when it all fits; else in shared memory with the lists read
// where they lie (L2); else in a scratch buffer in device memory that the
// caller provides (adlb_auction_scratch_bytes), the lists read where they
// lie. The kernel is instantiated once for each tier, so no access is
// generic.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -2147483647;  // padding priority, -(2^31) + 1
constexpr int kI32Max = 2147483647;

// (p, g) -> one key whose unsigned order is (p ascending, g descending).
__host__ __device__ __forceinline__ unsigned long long pack_key(int p, int g) {
  const unsigned hi = (unsigned)p ^ 0x80000000u;
  const unsigned lo = ~((unsigned)g ^ 0x80000000u);
  return ((unsigned long long)hi << 32) | lo;
}

// The threshold with no loser and no sentinel: (prio _NEG, gid I32MAX), as
// the JAX program's empty max / min give.
constexpr unsigned long long kThresholdNone =
    ((unsigned long long)((unsigned)kNeg ^ 0x80000000u) << 32) |
    (unsigned)~((unsigned)kI32Max ^ 0x80000000u);

// Byte offsets of the working set; `lists` columns of each type's (prio,
// gid) lists are staged (0: not staged).
struct Layout {
  size_t best, ekey, lp, lg, rwc, eg, eslot, erid, head, nlive, start, len,
      hasopen, eflag, open, bytes;
};

__host__ __device__ inline size_t up16(size_t o) {
  return (o + 15) & ~(size_t)15;
}

__host__ __device__ inline Layout layout(int T, int C, int m, int lists) {
  const size_t u1 = (size_t)T * C + 1, e = (size_t)T * m, tc = (size_t)T * C,
               tl = (size_t)T * lists;
  Layout l;
  size_t o = 0;
  l.best = o;    o += 8 * u1;           // best key per compacted requester
  l.ekey = o;    o += 8 * e;            // key per (type, rank) entry
  l.lp = up16(o); o = up16(l.lp + 4 * tl);  // staged prio lists
  l.lg = o;      o = up16(o + 4 * tl);  // staged gid lists
  l.rwc = o;     o = up16(o + 4 * tc);  // the slot table
  l.eg = o;      o += 4 * e;            // gid per entry
  l.eslot = o;   o += 4 * e;            // slot paired with the entry, or C
  l.erid = o;    o += 4 * e;            // requester of that slot, or U
  l.head = o;    o += 4 * T;            // candidates taken per type
  l.nlive = o;   o += 4 * T;            // live candidates per type
  l.start = o;   o += 4 * T;            // first slot that may still be open
  l.len = o;     o += 4 * T;            // slots per type
  l.hasopen = o; o += 4 * T;            // the type has an open slot
  l.eflag = o;   o += e;                // bit 0 valid, bit 1 winner
  l.open = up16(o); o = l.open + u1;    // requester still open
  l.bytes = up16(o);
  return l;
}

// Threads of a launch at (T, m): a warp per type and a thread per entry,
// within [128, 1024] (a barrier's cost grows with the warps it waits for).
__host__ __device__ inline int block_threads(int T, int m) {
  long long want = 32LL * T;
  if ((long long)T * m > want) want = (long long)T * m;
  want = (want + 31) / 32 * 32;
  return (int)(want < 128 ? 128 : want > kMaxThreads ? kMaxThreads : want);
}

// Dynamic shared memory the shared-memory variants may take (set at init).
int g_max_dyn = 0;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// Copies n bytes into shared memory (16-byte aligned), asynchronously in
// 4-byte words where the source is 4-byte aligned; the rest now.
__device__ void stage_bytes(unsigned char* dst, const unsigned char* src,
                            int n) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int words = ((uintptr_t)src & 3) == 0 ? n >> 2 : 0;
  for (int i = tid; i < words; i += nth) cp_async4(dst + 4 * i, src + 4 * i);
  for (int i = 4 * words + tid; i < n; i += nth) dst[i] = src[i];
}

// Copies `cols` columns of each of `rows` rows of a [rows, ld] int32 matrix
// into shared memory as [rows, cols], asynchronously: 16 bytes a copy when
// the rows are whole and the source is aligned, else 4. The destination is
// 16-byte aligned (Layout).
__device__ void stage(int* dst, const int* src, int rows, int cols, int ld) {
  const int tid = threadIdx.x, nth = blockDim.x, n = rows * cols;
  if (cols == ld && ((uintptr_t)src & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = tid; i < n4; i += nth) cp_async16(dst + 4 * i, src + 4 * i);
    for (int i = 4 * n4 + tid; i < n; i += nth) cp_async4(dst + i, src + i);
  } else {
    for (int i = tid; i < n; i += nth) {
      const int r = i / cols;
      cp_async4(dst + i, src + (size_t)r * ld + (i - r * cols));
    }
  }
}

// kShared: the working set lies in shared memory (else in `scratch`);
// kStage: the lists' first C + m + 1 columns are staged there too.
template <bool kShared, bool kStage>
__global__ void __launch_bounds__(kMaxThreads, 1)
auction_kernel(const int* __restrict__ gp, const int* __restrict__ gg, int L,
               const int* __restrict__ rwc_in, const int* __restrict__ lens,
               const unsigned char* __restrict__ open0, int T, int C, int m,
               int rounds, int* __restrict__ out, unsigned char* scratch) {
  static_assert(kShared || !kStage, "the lists are staged in shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_thr;
  __shared__ int s_total;
  unsigned char* ws = kShared ? smem : scratch;
  // no head slice reaches past index C + m (a type commits at most C times,
  // one per slot, and slots never reopen), so the first C + m + 1 columns
  // decide every read, the live counts included
  const int scan = L < C + m + 1 ? L : C + m + 1;
  const Layout lay = layout(T, C, m, kStage ? scan : 0);
  unsigned long long* best = (unsigned long long*)(ws + lay.best);
  unsigned long long* ekey = (unsigned long long*)(ws + lay.ekey);
  int* rwc = (int*)(ws + lay.rwc);
  int* eg = (int*)(ws + lay.eg);
  int* eslot = (int*)(ws + lay.eslot);
  int* erid = (int*)(ws + lay.erid);
  int* head = (int*)(ws + lay.head);
  int* nlive = (int*)(ws + lay.nlive);
  int* start = (int*)(ws + lay.start);
  int* slen = (int*)(ws + lay.len);
  int* hasopen = (int*)(ws + lay.hasopen);
  unsigned char* eflag = ws + lay.eflag;
  unsigned char* open = ws + lay.open;
  const int* lp = kStage ? (const int*)(ws + lay.lp) : gp;
  const int* lg = kStage ? (const int*)(ws + lay.lg) : gg;
  const int ls = kStage ? scan : L;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nth = blockDim.x, nwarps = nth >> 5;
  const int U = T * C, E = T * m;
  const unsigned below = (1u << lane) - 1;

  if (kShared) {
    if (kStage) {
      stage((int*)(ws + lay.lp), gp, T, scan, L);
      stage((int*)(ws + lay.lg), gg, T, scan, L);
    }
    stage(rwc, rwc_in, T, C, C);
    stage_bytes(open, open0, U + 1);
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int i = tid; i < U; i += nth) rwc[i] = rwc_in[i];
    for (int i = tid; i <= U; i += nth) open[i] = open0[i];
  }
  for (int i = tid; i < T * (C + 1); i += nth) out[i] = -1;
  for (int i = tid; i <= U; i += nth) best[i] = 0;
  for (int t = tid; t < T; t += nth) {
    head[t] = start[t] = 0;
    slen[t] = lens[t];
  }
  if (tid == 0) {
    s_thr = kThresholdNone;
    s_total = 0;
  }
  if (kShared) asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  // live candidates per type: (gp[t] > _NEG).sum(), one warp per type (the
  // lists are prio desc, _NEG-padded at the end)
  for (int t = warp; t < T; t += nwarps) {
    int n = 0;
    for (int i = lane; i < scan; i += 32) n += lp[(size_t)t * ls + i] > kNeg;
    for (int o = 16; o; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
    if (lane == 0) nlive[t] = n;
  }
  __syncthreads();

  int rnd = 0;
  while (rnd < rounds) {
    // 1. per type, one warp: the first m open slots, the head slice paired
    // with them, each requester's best key
    for (int t = warp; t < T; t += nwarps) {
      const int len = slen[t];
      const int* row = rwc + (size_t)t * C;
      int* slots = eslot + (size_t)t * m;
      int c0 = start[t], first = c0, found = 0;
      for (; c0 < len && found < m; c0 += 32) {
        const int c = c0 + lane;
        const bool o = c < len && open[row[c]];
        const unsigned b = __ballot_sync(kFull, o);
        if (o) {
          const int r = found + __popc(b & below);
          if (r < m) slots[r] = c;
        }
        if (found == 0 && b == 0) first = c0 + 32;  // all closed for good
        found += __popc(b);
      }
      for (int j = (found < m ? found : m) + lane; j < m; j += 32) slots[j] = C;
      __syncwarp();
      const int h = head[t], live = nlive[t];
      for (int j = lane; j < m; j += 32) {
        const int e = t * m + j, cidx = h + j;
        int p = kNeg, g = kI32Max;
        if (cidx < live) {
          p = lp[(size_t)t * ls + cidx];
          g = lg[(size_t)t * ls + cidx];
        }
        const int slot = slots[j];
        const bool valid = p > kNeg && slot < C;
        const int rid = valid ? row[slot] : U;
        const unsigned long long key = pack_key(p, g);
        ekey[e] = key;
        eg[e] = g;
        erid[e] = rid;
        eflag[e] = valid;
        if (valid) atomicMax(&best[rid], key);
      }
      if (lane == 0) {
        start[t] = first;
        hasopen[t] = found > 0;
      }
    }
    __syncthreads();
    // everyone read last round's count before the barrier above; it is next
    // written in step 3
    if (tid == 0) s_total = 0;
    // 2. winners; each loser, and the sentinel of each type that still has
    // an open slot, raises the threshold
    for (int e = tid; e < E; e += nth) {
      if (eflag[e]) {
        if (best[erid[e]] == ekey[e])
          eflag[e] = 3;
        else
          atomicMax(&s_thr, ekey[e]);
      }
    }
    for (int t = tid; t < T; t += nth) {
      const int at = head[t] + m;
      if (hasopen[t] && at < nlive[t])
        atomicMax(&s_thr, pack_key(lp[(size_t)t * ls + at],
                                   lg[(size_t)t * ls + at]));
    }
    __syncthreads();
    // 3. prefix commits above the threshold, one warp per type
    const unsigned long long thr = s_thr;
    for (int t = warp; t < T; t += nwarps) {
      int cnt = 0;
      for (int j0 = 0; j0 < m; j0 += 32) {
        const int j = j0 + lane;
        const size_t e = (size_t)t * m + j;
        const unsigned char f = j < m ? eflag[e] : 0;
        const unsigned lost = __ballot_sync(kFull, f == 1);
        const bool commit = f == 3 && (lost & below) == 0 && ekey[e] > thr;
        if (commit) {
          out[(size_t)t * (C + 1) + eslot[e]] = eg[e];
          open[erid[e]] = 0;
        }
        cnt += __popc(__ballot_sync(kFull, commit));
        if (lost) break;  // a loss blocks every later rank this round
      }
      if (lane == 0 && cnt) {
        head[t] += cnt;
        atomicAdd(&s_total, cnt);
      }
    }
    for (int e = tid; e < E; e += nth)
      if (eflag[e]) best[erid[e]] = 0;
    __syncthreads();
    const int n = s_total;
    // everyone read the threshold before the barrier above; it is next
    // written in step 2, after the next round's first barrier
    if (tid == 0) s_thr = kThresholdNone;
    ++rnd;
    if (n == 0) break;  // maximal: nothing more can commit
  }
  if (tid == 0) out[(size_t)T * (C + 1)] = rnd;
}

}  // namespace

extern "C" {

// Once per process, after loading: lets the shared-memory variants use all
// the shared memory a block may have. Returns the CUDA error code.
int adlb_auction_init() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, auction_kernel<true, true>);
  if (err != cudaSuccess) return (int)err;
  g_max_dyn = optin - (int)attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(auction_kernel<true, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g_max_dyn);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(auction_kernel<true, false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   g_max_dyn);
}

// 1 when a launch at (T, C, m) stages the lists' first C + m + 1 columns in
// shared memory with the rest of the working set (after adlb_auction_init).
int adlb_auction_stages_lists(int T, int C, int m) {
  return layout(T, C, m, C + m + 1).bytes <= (size_t)g_max_dyn;
}

// Threads per block of a launch at (T, m).
int adlb_auction_threads(int T, int m) { return block_threads(T, m); }

// Bytes of device scratch a launch at (T, C, m) needs: 0 when the working
// set without the lists fits in shared memory (after adlb_auction_init),
// else its size.
long long adlb_auction_scratch_bytes(int T, int C, int m) {
  const size_t bytes = layout(T, C, m, 0).bytes;
  return bytes <= (size_t)g_max_dyn ? 0 : (long long)bytes;
}

// Launches the auction on `stream`: gp, gg [T, L], rwc [T, C], lens [T] int32,
// open0 [T * C + 1] bytes; out holds T * (C + 1) + 1 ints. `scratch` holds
// adlb_auction_scratch_bytes(T, C, m) bytes of device memory, or is null when
// that is 0. Returns the CUDA error code of the launch; does not synchronise.
int adlb_auction(const int* gp, const int* gg, int L, const int* rwc,
                 const int* lens, const unsigned char* open0, int T, int C,
                 int m, int rounds, int* out, unsigned char* scratch,
                 void* stream) {
  if (T < 1 || C < 1 || L < 1 || m < 1 || rounds < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = block_threads(T, m);
  if (adlb_auction_stages_lists(T, C, m)) {
    const int scan = L < C + m + 1 ? L : C + m + 1;
    auction_kernel<true, true><<<1, threads, layout(T, C, m, scan).bytes,
                                 st>>>(gp, gg, L, rwc, lens, open0, T, C, m,
                                       rounds, out, nullptr);
  } else if (adlb_auction_scratch_bytes(T, C, m) == 0) {
    auction_kernel<true, false><<<1, threads, layout(T, C, m, 0).bytes,
                                  st>>>(gp, gg, L, rwc, lens, open0, T, C, m,
                                        rounds, out, nullptr);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    auction_kernel<false, false><<<1, threads, 0, st>>>(
        gp, gg, L, rwc, lens, open0, T, C, m, rounds, out, scratch);
  }
  return (int)cudaGetLastError();
}

const char* adlb_auction_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
