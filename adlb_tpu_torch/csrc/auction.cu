// Auction rounds of the sharded planner, hand-written for Hopper (sm_90a).
//
// Replaces the device loop of the JAX package's fused planning program:
// adlb_tpu/balancer/distributed.py, _build_plan_fn, the lax.while_loop over
// `body` (:190-240) and `cond` (:242-243). That loop is XLA, not Pallas; it
// is the one device step of the sharded planner that is neither a sort nor a
// gather. Given the merged per-type candidate lists (prio desc, gid asc) and
// the requester slot tables over host-compacted requester ids, each round
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
//                         (-(2^31) + 1, 2^31 - 1)
//   rwc     [T, C] int32  compacted requester id per slot (U = T * C for an
//                         empty slot: the dump id)
//   lens    [T]    int32  slots per type
//   open0   [U+1]  u8     bool: compacted id u is a real, open requester
//
// What bounds it on this card: the rounds are a dependent chain (each reads
// what the last one closed), so the whole loop runs in one thread block,
// with the round's state in shared memory and five block barriers a round;
// its bytes (at most C + m + 1 entries of each type's list, plus the
// tables) take well under a
// microsecond of HBM time, so it is latency bound: barriers, shared-memory
// atomics and the L2 round trips of the head slices. The design keeps every
// step parallel across (type, rank) pairs and makes the scatter passes of
// the JAX program single atomics: a (prio, gid) pair is packed into one
// 64-bit key ordered as (prio asc, gid desc), so "max prio, then min gid" is
// one atomicMax per entry, for the per-requester winner and for the global
// threshold alike, and the commit test is one compare. Step 2 and step 5 run
// one warp per type (__ballot_sync ranks the open slots and finds the first
// loss), 32 slots or ranks at a time, so any m works. Each type keeps the
// first slot that may still be open, since slots only ever close. The
// working set (the requester winners over U + 1 ids, the open flags, the
// slot table and the per-entry state, about 13 * T * C + 21 * T * m bytes)
// lives in shared memory when it fits, else in a scratch buffer in device
// memory that the caller provides (adlb_auction_scratch_bytes); the kernel
// is instantiated once for each, so no access is generic.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
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

// Byte offsets of the working set.
struct Layout {
  size_t best, ekey, rwc, eg, eslot, erid, head, nlive, start, hasopen, eflag,
      open, bytes;
};

__host__ __device__ inline Layout layout(int T, int C, int m) {
  const size_t u1 = (size_t)T * C + 1, e = (size_t)T * m, tc = (size_t)T * C;
  Layout l;
  size_t o = 0;
  l.best = o;    o += 8 * u1;  // best key per compacted requester
  l.ekey = o;    o += 8 * e;   // key per (type, rank) entry
  l.rwc = o;     o += 4 * tc;  // the slot table
  l.eg = o;      o += 4 * e;   // gid per entry
  l.eslot = o;   o += 4 * e;   // slot paired with the entry, or C
  l.erid = o;    o += 4 * e;   // requester of that slot, or U
  l.head = o;    o += 4 * T;   // candidates taken per type
  l.nlive = o;   o += 4 * T;   // live candidates per type
  l.start = o;   o += 4 * T;   // first slot that may still be open
  l.hasopen = o; o += 4 * T;   // the type has an open slot this round
  l.eflag = o;   o += e;       // bit 0 valid, bit 1 winner
  l.open = o;    o += u1;      // requester still open
  l.bytes = (o + 15) & ~(size_t)15;
  return l;
}

// Dynamic shared memory the shared-memory variant may take (set at init).
int g_max_dyn = 0;

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
auction_kernel(const int* __restrict__ gp, const int* __restrict__ gg, int L,
               const int* __restrict__ rwc_in, const int* __restrict__ lens,
               const unsigned char* __restrict__ open0, int T, int C, int m,
               int rounds, int* __restrict__ out, unsigned char* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_thr;
  __shared__ int s_total;
  unsigned char* ws = kShared ? smem : scratch;
  const Layout lay = layout(T, C, m);
  unsigned long long* best = (unsigned long long*)(ws + lay.best);
  unsigned long long* ekey = (unsigned long long*)(ws + lay.ekey);
  int* rwc = (int*)(ws + lay.rwc);
  int* eg = (int*)(ws + lay.eg);
  int* eslot = (int*)(ws + lay.eslot);
  int* erid = (int*)(ws + lay.erid);
  int* head = (int*)(ws + lay.head);
  int* nlive = (int*)(ws + lay.nlive);
  int* start = (int*)(ws + lay.start);
  int* hasopen = (int*)(ws + lay.hasopen);
  unsigned char* eflag = ws + lay.eflag;
  unsigned char* open = ws + lay.open;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int U = T * C, E = T * m;
  const unsigned below = (1u << lane) - 1;

  for (int i = tid; i < T * (C + 1); i += kThreads) out[i] = -1;
  for (int i = tid; i <= U; i += kThreads) {
    best[i] = 0;
    open[i] = open0[i];
  }
  for (int i = tid; i < U; i += kThreads) rwc[i] = rwc_in[i];
  for (int t = tid; t < T; t += kThreads) head[t] = start[t] = 0;
  if (tid == 0) {
    s_thr = kThresholdNone;
    s_total = 0;
  }
  // live candidates per type: (gp[t] > _NEG).sum(), one warp per type. A
  // type commits at most C times (one per slot, and slots never reopen), so
  // no head slice reaches past index C + m: counting the live prefix of the
  // first C + m + 1 entries (the lists are prio desc, _NEG-padded at the
  // end) decides every `cidx < nlive` as the full count would.
  const int scan = L < C + m + 1 ? L : C + m + 1;
  for (int t = warp; t < T; t += kWarps) {
    int n = 0;
    for (int i = lane; i < scan; i += 32) n += gp[(size_t)t * L + i] > kNeg;
    for (int o = 16; o; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
    if (lane == 0) nlive[t] = n;
  }
  __syncthreads();

  int rnd = 0;
  while (rnd < rounds) {
    // 1. the first m open slots of each type, one warp per type
    for (int t = warp; t < T; t += kWarps) {
      const int len = lens[t];
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
      if (lane == 0) {
        start[t] = first;
        hasopen[t] = found > 0;
      }
    }
    __syncthreads();
    // 2. head slices, pairs, each requester's best key; the sentinels
    for (int e = tid; e < E; e += kThreads) {
      const int t = e / m, j = e - t * m;
      const int cidx = head[t] + j;
      int p = kNeg, g = kI32Max;
      if (cidx < nlive[t]) {
        const size_t at = (size_t)t * L + (cidx < L - 1 ? cidx : L - 1);
        p = gp[at];
        g = gg[at];
      }
      const int slot = eslot[e];
      const bool valid = p > kNeg && slot < C;
      const int rid = valid ? rwc[(size_t)t * C + slot] : U;
      const unsigned long long key = pack_key(p, g);
      ekey[e] = key;
      eg[e] = g;
      erid[e] = rid;
      eflag[e] = valid;
      if (valid) atomicMax(&best[rid], key);
    }
    for (int t = tid; t < T; t += kThreads) {
      const int cidx = head[t] + m;
      if (hasopen[t] && cidx < nlive[t]) {
        const size_t at = (size_t)t * L + (cidx < L - 1 ? cidx : L - 1);
        if (gp[at] > kNeg) atomicMax(&s_thr, pack_key(gp[at], gg[at]));
      }
    }
    __syncthreads();
    // 3. winners; each loser raises the threshold
    for (int e = tid; e < E; e += kThreads) {
      if (eflag[e]) {
        if (best[erid[e]] == ekey[e])
          eflag[e] = 3;
        else
          atomicMax(&s_thr, ekey[e]);
      }
    }
    __syncthreads();
    // 4. prefix commits above the threshold, one warp per type
    const unsigned long long thr = s_thr;
    for (int t = warp; t < T; t += kWarps) {
      int cnt = 0;
      for (int j0 = 0; j0 < m; j0 += 32) {
        const int j = j0 + lane;
        const size_t e = (size_t)t * m + j;
        const unsigned char f = j < m ? eflag[e] : 0;
        const unsigned lost = __ballot_sync(kFull, f == 1);
        const bool commit =
            f == 3 && (lost & below) == 0 && ekey[e] > thr;
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
    for (int e = tid; e < E; e += kThreads)
      if (eflag[e]) best[erid[e]] = 0;
    __syncthreads();
    const int n = s_total;
    __syncthreads();
    if (tid == 0) {
      s_total = 0;
      s_thr = kThresholdNone;
    }
    ++rnd;
    if (n == 0) break;  // maximal: nothing more can commit
  }
  if (tid == 0) out[(size_t)T * (C + 1)] = rnd;
}

}  // namespace

extern "C" {

// Once per process, after loading: lets the shared-memory variant use all
// the shared memory a block may have. Returns the CUDA error code.
int adlb_auction_init() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, auction_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  g_max_dyn = optin - (int)attr.sharedSizeBytes;
  return (int)cudaFuncSetAttribute(auction_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   g_max_dyn);
}

// Bytes of device scratch a launch at (T, C, m) needs: 0 when the working
// set fits in shared memory (after adlb_auction_init), else its size.
long long adlb_auction_scratch_bytes(int T, int C, int m) {
  const size_t need = layout(T, C, m).bytes;
  return need <= (size_t)g_max_dyn ? 0LL : (long long)need;
}

// Launches the auction on `stream`: gp, gg [T, L], rwc [T, C], lens [T] int32,
// open0 [T * C + 1] bytes; out holds T * (C + 1) + 1 ints. `scratch` holds
// adlb_auction_scratch_bytes(T, C, m) bytes of device memory, or is null when
// that is 0. Returns the CUDA error code of the launch; does not synchronise.
int adlb_auction(const int* gp, const int* gg, int L, const int* rwc,
                 const int* lens, const unsigned char* open0, int T, int C,
                 int m, int rounds, int* out, unsigned char* scratch,
                 void* stream) {
  const long long need = adlb_auction_scratch_bytes(T, C, m);
  if (T < 1 || C < 1 || L < 1 || m < 1 || rounds < 0)
    return (int)cudaErrorInvalidValue;
  if (need == 0) {
    auction_kernel<true><<<1, kThreads, layout(T, C, m).bytes,
                           (cudaStream_t)stream>>>(
        gp, gg, L, rwc, lens, open0, T, C, m, rounds, out, nullptr);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    auction_kernel<false><<<1, kThreads, 0, (cudaStream_t)stream>>>(
        gp, gg, L, rwc, lens, open0, T, C, m, rounds, out, scratch);
  }
  return (int)cudaGetLastError();
}

const char* adlb_auction_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
