// Auction rounds of the sharded planner, hand-written for Hopper (sm_90a).
//
// Replaces the device loop of the JAX package's fused planning program:
// adlb_tpu/balancer/distributed.py, _build_plan_fn (:136), the
// lax.while_loop over `body` (:190-240) and `cond` (:242-243); its
// candidates and merge are csrc/candidates.cu. Given the merged per-type
// candidate lists (prio desc, gid asc), it builds the requester windows in
// a prologue from the requester table resident on the card (below), then
// runs the rounds over them; each round
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
// (column C is the JAX program's scatter dump and stays -1), then the rows
// of the windows, then the number of rounds run, then `scanned` (below),
// then `lost`: the entries that lost their requester to another type's
// candidate, summed over the rounds (step 3's losers; a requester sits at
// most once in a type's window, so every loser lost to another type).
//
// Inputs (the wrapper is adlb_tpu_torch/balancer/auction.py):
//   gp, gg  [T, L] int32  merged candidate (prio, gid) lists; padding is
//                         (-(2^31) + 1, 2^31 - 1). The device plan hands
//                         over L = D = C + m + 1 (candidates.cu's merge);
//                         any L works, and no round reads past C + m.
//   table   [NR, W] int32 one bitmask a requester row: bit t of word t / 32
//                         set when the row is valid and accepts type t;
//                         rows R at a time per server slot, updated in place
//   order   [1 + S] int32 the number of slots in use, then the slots in
//                         rank order (the scan order of the greedy)
//   delta   int32         the rows the last ingest rewrote, packed into
//                         `table` before the scan: n_delta slots, then
//                         each of their R rows' T type-flag bytes (all 0
//                         on a row that is not valid), padded to a word
// The prologue replaces the host's window scan (distributed.py `_reqwin`)
// and compaction (`_compact_reqwin`, the slot table rwc [T, C] over dense
// requester ids, U = T * C marking an empty slot, the window lengths and
// the open flags over the ids) of every round, for the live types: a type
// is live when its list's first candidate is not padding (one read a type
// where the scan needs it). A type that is not live can commit nothing, so
// its window is not needed: the scan counts it full from the start (its
// ranks start at C, so it takes no row and gives no row a dense id) and it
// is left empty, a prefix of the host's window. It scans the rows of the
// slots in use in rank order, spans of kRowsPerThread block widths at a time
// (the kernel launches at least 512
// threads, so that the SM's schedulers interleave warps through the scan's
// instruction stream, which bounds it): a ballot per type and warp, a prefix
// over the warps gives each row its rank in each type's window (the first C
// accepting rows), a second ballot and prefix give each row that some window
// takes a dense id in scan order (the auction uses an id only as an
// identity: atomicMax on the task key decides conflicts, so the commits are
// those of the host's sorted ids), and the scan stops once every live
// type's window holds C rows. Its output after assigned: rows[T, C + 1], the
// physical row of each slot (-1 past its window) with column C holding the
// window's length, then the rounds run, then `scanned`: the rows the windows
// took in (up to the row that filled the last live window, none when no type
// is live, or every row in use when a live window stays short; the block
// reads at most one span of kRowsPerThread x threads rows past it), then
// `lost`.
//
// What bounds it on this card: the rounds are a dependent chain (each reads
// what the last one closed), so the whole loop runs in one thread block, and
// its bytes (at most C + m + 1 entries of each type's list, plus the tables)
// take well under a microsecond of HBM time: it is latency bound, by the
// rounds' block barriers and what runs between them. The design:
//   * the lists' first C + m + 1 columns (35 KB at the 10k-row shape) are
//     staged into shared memory once, at the start, with cp.async (16 bytes
//     a copy where aligned), while the rest of the working set is
//     initialised and the windows built there; the rounds' head slices and
//     slot scans then read shared memory, not L2;
//   * a (prio, gid) pair is one 64-bit key ordered as (prio asc, gid desc),
//     so "max prio, then min gid" is one atomicMax per entry, for the
//     per-requester winner and for the global threshold alike, and the
//     commit test is one compare;
//   * a block with as many threads as a round has work (a warp per type, a
//     thread per (type, rank) entry; 256 at the 10k-row shape), since a
//     barrier's cost grows with the warps it waits for, and at least 512
//     for the prologue's scan;
//   * three barriers a round: one warp per type finds its first m open
//     slots (__ballot_sync ranks them; the first slot that may still be
//     open is kept, since slots only ever close), reads its head slice,
//     pairs it and posts each requester's best key; then every entry
//     learns whether it won (losers and the sentinels of the types with an
//     open slot raise the threshold); then one warp per type commits its
//     prefix. Each shared scalar is reset by one thread between the barrier
//     after its last read and the barrier before its next write, so no
//     barrier is spent on resets. Each loser is counted where it loses, in
//     a shared count read after the last round.
// The working set (requester winners over U + 1 ids, open flags, the slot
// table, the per-entry state and the scan's counts, about 13 T C + 21 T m
// bytes, plus the staged lists, 8 T (C + m + 1) bytes) lives in shared
// memory with the lists staged when it all fits; else in shared memory with
// the lists read where they lie (L2); else in a scratch buffer in device
// memory that the caller provides (adlb_auction_windows_scratch_bytes), the
// lists read where they lie. The kernel is instantiated once for each tier,
// so no access is generic.

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
// gid) lists are staged (0: not staged); the windows' scan takes
// `scan_words` ints.
struct Layout {
  size_t best, ekey, lp, lg, rwc, eg, eslot, erid, head, nlive, start, len,
      hasopen, eflag, open, scan, bytes;
};

__host__ __device__ inline size_t up16(size_t o) {
  return (o + 15) & ~(size_t)15;
}

__host__ __device__ inline Layout layout(int T, int C, int m, int lists,
                                         int scan_words) {
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
  l.scan = up16(o); o = l.scan + 4 * (size_t)scan_words;  // the scan's counts
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

// Rows of the windows' scan each thread takes per span of the requester
// table: a span is this many block widths of rows.
constexpr int kRowsPerThread = 4;

// Threads of a launch: at least 512, so that each
// scheduler of the SM interleaves four warps through the prologue's scan
// (with one warp each, the scan's instructions run at their full latency);
// the rounds' barriers take a few hundred ns more at this size.
__host__ __device__ inline int windows_threads(int T, int m) {
  const int n = block_threads(T, m);
  return n < 512 ? 512 : n;
}

// Ints the windows' scan keeps: for each of the span's kRowsPerThread block
// widths and each warp, its count of accepting rows per type, then of the
// rows some window took (each turned into a prefix in place), and per type
// the scan position after its window's C-th row.
__host__ __device__ inline int scan_words(int T, int m) {
  return kRowsPerThread * (windows_threads(T, m) / 32) * (T + 1) + T;
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

// The exclusive prefix of the K counts cnt[k * stride + col], from `base`,
// in place, by one warp (lanes take 32 counts a step); returns the total.
__device__ int warp_prefix(int* cnt, int stride, int col, int K, int base) {
  const int lane = threadIdx.x & 31;
  int run = base;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const int v = k < K ? cnt[k * stride + col] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (k < K) cnt[k * stride + col] = run + x - v;
    run += __shfl_sync(kFull, x, 31);
  }
  return run;
}

// The windows' prologue, after the staged rows were packed into `table`:
// the requester rows scanned in rank order into each live type's window
// (see the header; type t is live when its list's first priority, lp[t *
// ls], is not padding). Each thread holds its rows of a span and their first
// mask word in registers, loaded together; `table` is written earlier in the
// same launch, so it is read with plain loads, not through the read-only
// path. Leaves rwc, slen and open as the host's tables would give them for
// the live types (the other windows empty), writes the rows part of `out`,
// and raises `reach` (0 before) to the row that filled each live window, or
// to kI32Max where one stays short: `scanned`, written after the rounds.
// Every thread of the block calls it.
__device__ void build_windows(const int* table,
                              const int* __restrict__ order, int R, int W,
                              int T, int C, const int* lp, int ls, int* rwc,
                              int* slen, unsigned char* open, int* cnt,
                              int* out, int* s_uniq, int* reach) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nth = blockDim.x, nwarps = nth >> 5;
  const int U = T * C, T1 = T + 1, K = kRowsPerThread * nwarps;
  const unsigned below = (1u << lane) - 1;
  int* fill = cnt + K * T1;
  int* rows = out + (size_t)T * (C + 1);
  const int nrows = order[0] * R;
  const int* slots = order + 1;
  const int span = kRowsPerThread * nth;
  // the thread's first row of a span as (slot index, row in the slot),
  // stepped by a block width: no division a row
  const int dq = nth / R, dr = nth % R;
  int row[kRowsPerThread] = {};
  unsigned word0[kRowsPerThread] = {};
  // row j's accepting types, t = 0 .. T-1, each as a warp ballot (words past
  // the first are read where a type needs them)
  auto each_type = [&](int j, auto&& fn) {
    unsigned word = word0[j];
    for (int t = 0; t < T; ++t) {
      if (t && (t & 31) == 0)
        word = row[j] >= 0 ? (unsigned)table[(size_t)row[j] * W + (t >> 5)]
                           : 0u;
      const bool b = (word >> (t & 31)) & 1u;
      fn(t, b, __ballot_sync(kFull, b));
    }
  };
  for (int base = 0; base < nrows; base += span) {
    int q = (base + tid) / R, r = (base + tid) % R;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      row[j] = base + j * nth + tid < nrows ? slots[q] * R + r : -1;
      q += dq;
      r += dr;
      if (r >= R) {
        r -= R;
        ++q;
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      word0[j] = row[j] >= 0 ? (unsigned)table[(size_t)row[j] * W] : 0u;
    // 1. each warp's accepting rows per type, per block width of the span
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      int* c = cnt + (j * nwarps + warp) * T1;
      each_type(j, [&](int t, bool, unsigned bal) {
        if (lane == 0) c[t] = __popc(bal);
      });
    }
    __syncthreads();
    // 2. per type, one warp: the counts turned into each warp's first rank,
    // in scan order, from the window's length so far (from C where the type
    // is not live: its window takes no row and counts as full)
    for (int t = warp; t < T; t += nwarps) {
      const int run = warp_prefix(cnt, T1, t, K,
                                  lp[(size_t)t * ls] > kNeg ? slen[t] : C);
      __syncwarp();
      if (lane == 0) slen[t] = run < C ? run : C;
    }
    __syncthreads();
    // 3. the rows some window takes, counted per warp
    unsigned taken = 0;  // bit j: row j of the span is taken
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      int* c = cnt + (j * nwarps + warp) * T1;
      bool took = false;
      each_type(j, [&](int t, bool b, unsigned bal) {
        took |= b && c[t] + __popc(bal & below) < C;
      });
      const unsigned tb = __ballot_sync(kFull, took);
      if (lane == 0) c[T] = __popc(tb);
      taken |= (unsigned)took << j;
    }
    __syncthreads();
    // 4. their first dense id per warp, in scan order
    if (warp == 0) {
      const int run = warp_prefix(cnt, T1, T, K, *s_uniq);
      __syncwarp();
      if (lane == 0) *s_uniq = run;
    }
    __syncthreads();
    // 5. each taken row into its windows: its dense id, its physical row
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int* c = cnt + (j * nwarps + warp) * T1;
      const bool took = (taken >> j) & 1u;
      const int id = c[T] + __popc(__ballot_sync(kFull, took) & below);
      const int at = base + j * nth + tid + 1;
      each_type(j, [&](int t, bool b, unsigned bal) {
        const int rank = c[t] + __popc(bal & below);
        if (b && rank < C) {
          rwc[t * C + rank] = id;
          rows[(size_t)t * (C + 1) + rank] = row[j];
          if (rank == C - 1) fill[t] = at;
        }
      });
    }
    __syncthreads();
    bool full = true;
    for (int t = 0; t < T; ++t) full &= slen[t] >= C;
    if (full) break;
  }
  const int nuniq = *s_uniq;
  for (int i = tid; i <= U; i += nth) open[i] = i < nuniq;
  // a window no plan needs is empty (the rounds read none of its slots);
  // the live windows, each full, give the row that filled the last of them
  for (int t = tid; t < T; t += nth) {
    const bool live = lp[(size_t)t * ls] > kNeg;
    const int n = live ? slen[t] : 0;
    slen[t] = n;
    rows[(size_t)t * (C + 1) + C] = n;
    if (live) atomicMax(reach, n < C ? kI32Max : fill[t]);
  }
}

// kShared: the working set lies in shared memory (else in `scratch`);
// kStage: the lists' first C + m + 1 columns are staged there too.
template <bool kShared, bool kStage>
__global__ void __launch_bounds__(kMaxThreads, 1)
auction_kernel(const int* __restrict__ gp, const int* __restrict__ gg, int L,
               int T, int C, int m, int rounds, int* __restrict__ out,
               unsigned char* scratch, int* table,
               const int* __restrict__ order, const int* __restrict__ delta,
               int n_delta, int R, int W) {
  static_assert(kShared || !kStage, "the lists are staged in shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_thr;
  __shared__ int s_total, s_uniq, s_lost, s_reach;
  unsigned char* ws = kShared ? smem : scratch;
  // no head slice reaches past index C + m (a type commits at most C times,
  // one per slot, and slots never reopen), so the first C + m + 1 columns
  // decide every read, the live counts included
  const int scan = L < C + m + 1 ? L : C + m + 1;
  const Layout lay = layout(T, C, m, kStage ? scan : 0, scan_words(T, m));
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

  if (kStage) {
    stage((int*)(ws + lay.lp), gp, T, scan, L);
    stage((int*)(ws + lay.lg), gg, T, scan, L);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // the rows the last ingest rewrote, packed into the resident table, a
  // thread a row word; the table is read back below, so it is never read
  // through the read-only path
  const int staged_rows = n_delta * R;
  const unsigned char* flags = (const unsigned char*)(delta + n_delta);
#pragma unroll 4
  for (int i = tid; i < staged_rows * W; i += nth) {
    const int k = i / W, w = i - k * W;
    const int t1 = T < 32 * w + 32 ? T : 32 * w + 32;
    unsigned word = 0;
    for (int t = 32 * w; t < t1; ++t)
      word |= (unsigned)(flags[(size_t)k * T + t] != 0) << (t & 31);
    table[((size_t)delta[k / R] * R + k % R) * W + w] = (int)word;
  }
  for (int i = tid; i < U; i += nth) rwc[i] = U;
  for (int i = tid; i < 2 * T * (C + 1); i += nth) out[i] = -1;
  for (int i = tid; i <= U; i += nth) best[i] = 0;
  for (int t = tid; t < T; t += nth) head[t] = start[t] = slen[t] = 0;
  if (tid == 0) {
    s_thr = kThresholdNone;
    s_total = 0;
    s_uniq = 0;
    s_lost = 0;
    s_reach = 0;
  }
  if (kStage) asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  build_windows(table, order, R, W, T, C, lp, ls, rwc, slen, open,
                (int*)(ws + lay.scan), out, &s_uniq, &s_reach);
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
        if (best[erid[e]] == ekey[e]) {
          eflag[e] = 3;
        } else {
          atomicMax(&s_thr, ekey[e]);
          atomicAdd(&s_lost, 1);
        }
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
  // the windows' reach and every loss were posted before the last barrier
  if (tid == 0) {
    int* counts = out + 2 * (size_t)T * (C + 1);
    counts[0] = rnd;
    counts[1] = s_reach == kI32Max ? order[0] * R : s_reach;
    counts[2] = s_lost;
  }
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
  const void* shared[] = {(const void*)auction_kernel<true, true>,
                          (const void*)auction_kernel<true, false>};
  int most_static = 0;
  for (const void* fn : shared) {
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
    if (err == cudaSuccess && (int)attr.sharedSizeBytes > most_static)
      most_static = (int)attr.sharedSizeBytes;
  }
  if (err != cudaSuccess) return (int)err;
  g_max_dyn = optin - most_static;
  for (const void* fn : shared) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               g_max_dyn);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// 1 when a launch at (T, C, m) stages the lists' first C + m + 1 columns in
// shared memory with the rest of the working set (after adlb_auction_init).
int adlb_auction_windows_stages_lists(int T, int C, int m) {
  return layout(T, C, m, C + m + 1, scan_words(T, m)).bytes <=
         (size_t)g_max_dyn;
}

// Threads per block of a launch at (T, m).
int adlb_auction_windows_threads(int T, int m) {
  return windows_threads(T, m);
}

// Bytes of device scratch a launch at (T, C, m) needs: 0 when the working
// set without the lists fits in shared memory (after adlb_auction_init),
// else its size.
long long adlb_auction_windows_scratch_bytes(int T, int C, int m) {
  const size_t bytes = layout(T, C, m, 0, scan_words(T, m)).bytes;
  return bytes <= (size_t)g_max_dyn ? 0 : (long long)bytes;
}

// Launches the auction on `stream`, the variant that fits: the lists staged
// with the working set in shared memory, the working set there alone, or
// all in `scratch`. gp, gg [T, L]; the resident requester table [S * R, W]
// int32 (W * 32 >= T), updated in place by the first n_delta entries of
// `delta`; the rank order [1 + S] int32; out holds 2 * T * (C + 1) + 3 ints
// (assigned, rows, rounds run, scanned, lost). `scratch` holds
// adlb_auction_windows_scratch_bytes(T, C, m) bytes of device memory, or is
// null when that is 0. Returns the CUDA error code of the launch; does not
// synchronise.
int adlb_auction_windows(const int* gp, const int* gg, int L, int* table,
                         const int* order, const int* delta, int n_delta,
                         int R, int W, int T, int C, int m, int rounds,
                         int* out, unsigned char* scratch, void* stream) {
  if (T < 1 || C < 1 || L < 1 || m < 1 || rounds < 0 || R < 1 || W < 1 ||
      32 * W < T || n_delta < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = windows_threads(T, m), sw = scan_words(T, m);
  if (adlb_auction_windows_stages_lists(T, C, m)) {
    const int scan = L < C + m + 1 ? L : C + m + 1;
    auction_kernel<true, true>
        <<<1, threads, layout(T, C, m, scan, sw).bytes, st>>>(
            gp, gg, L, T, C, m, rounds, out, nullptr, table, order, delta,
            n_delta, R, W);
  } else if (adlb_auction_windows_scratch_bytes(T, C, m) == 0) {
    auction_kernel<true, false>
        <<<1, threads, layout(T, C, m, 0, sw).bytes, st>>>(
            gp, gg, L, T, C, m, rounds, out, nullptr, table, order, delta,
            n_delta, R, W);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    auction_kernel<false, false><<<1, threads, 0, st>>>(
        gp, gg, L, T, C, m, rounds, out, scratch, table, order, delta,
        n_delta, R, W);
  }
  return (int)cudaGetLastError();
}

const char* adlb_auction_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
