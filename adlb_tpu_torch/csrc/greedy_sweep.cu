// Greedy assignment solve for the planned balancer, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel adlb_tpu/balancer/pallas_solve.py
// (_greedy_sweep_kernel under pallas_greedy_assign): tasks are taken in
// stable descending-priority order, and each live task takes the
// lowest-index open requester that is valid and whose type mask accepts it;
// that requester then closes. The output is assign[NR]: the task index each
// requester got, or -1.
//
// Inputs (the wrapper, adlb_tpu_torch/balancer/greedy_sweep.py, sorts the
// priorities with one torch.sort and hands over everything else as is):
//   s_prio    [NT] int32   priorities in stable descending order; padding
//                          (-(2^31) + 1) sorts last
//   order     [NT] int64   original index of the k-th task in that order
//   task_type [NT] int32   type index per task (original order); -1 or a
//                          type >= T is not live
//   mask      [NR, T] u8   bool: requester r accepts type t
//   valid     [NR] u8      bool: requester r is real
// Output: out[NR + 1] int32: assign, then the route taken (1, 2 or 3). The
// kernel also tallies its launches per route in device memory
// (adlb_greedy_sweep_route_counts).
//
// What bounds it on this card: the greedy is a dependent chain, one step per
// live task until no open requester is left; its bytes (about 16 * NT +
// (T + 5) * NR) take microseconds of HBM time. The design rests on one
// property the TPU kernel never used. A requester's compat row depends only
// on its (valid and) type mask; call requesters with the same non-empty mask
// a class. A task of type t takes the lowest open requester in the union of
// the classes that hold t, and if that requester is in class c, every open
// member of c below it would also take t: each class is used up in index
// order. So the greedy state is one pointer per class, and a step is a min,
// over the classes that hold the task's type, of each class's next member.
// The kernel (one block: the chain is sequential) builds the classes itself
// and picks one of three exact routes from the data:
//   R1 partition: every type lies in at most one class (T <= 64). Then the
//      n-th live task whose type lies in class c takes c's n-th member: a
//      prefix count, no chain. The block ranks the ordered tasks 4096 at a
//      time (__match_any_sync within a warp, a scan across warps) and stops
//      when every class is full or the live tasks run out.
//   R2 class chain: T <= 10 and at most 32 classes. One warp runs the chain
//      with one lane per class; a step is one __reduce_min_sync over the
//      next members of the classes that hold the type. The winner advances
//      to a member it prefetched from the member lists. A type whose classes
//      are all used up is dropped from a live-type bitmask, so its later
//      tasks are filtered 32 at a time by one __ballot_sync.
//   R3 bitmask sweep: everything else (T > 10 with overlapping classes,
//      more than 32 classes). One requester bitmask per type and the open
//      bitmask form its working set; a step ANDs the type's row with the
//      open bits from a forward-only per-type cursor, 32 words per probe,
//      and takes the first set bit with __ballot_sync / __ffs.
// In R2 and R3 the other warps stage the next tiles of ordered (type,
// index) pairs into shared memory while warp 0 runs the chain. The class
// member lists (R1, R2) are built in index order by a stable counting
// partition. A route's working set (the member lists, one word per
// requester; or R3's T + 1 bitmask rows) lives in shared memory when it
// fits beside the tiles, else in a scratch buffer in device memory that the
// caller provides (adlb_greedy_sweep_scratch_bytes), so any NR runs.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;                   // items per thread per chunk
constexpr int kChunk = kThreads * kRounds;   // items ranked per block pass
constexpr int kTile = 2048;                  // tasks per staged tile (R2, R3)
constexpr int kPatTypes = 64;                // masks as 64-bit patterns
constexpr int kHistTypes = 10;               // R2: a 2^T-bin histogram
constexpr int kLanes = 32;                   // R2: one lane per class
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -2147483647;            // padding priority
constexpr int kNone = INT_MAX;

enum Route { kPartition = 1, kClasses = 2, kSweep = 3 };

__device__ unsigned long long g_route_launches[3];  // launches per route

// Words of a route's working set: the member lists (R1, R2) or R3's
// typebits [T][W], open bits [W] and one cursor per type.
__host__ __device__ __forceinline__ long long region_words(int route, int nr,
                                                           int ntypes) {
  const long long nwords = (nr + 31) / 32;
  return route == kSweep ? (ntypes + 1LL) * nwords + ntypes : (long long)nr;
}

struct Shared {
  unsigned long long tand[kPatTypes];  // AND of the patterns holding type t
  unsigned long long tor[kPatTypes];   // OR of the patterns holding type t
  int hist[1 << kHistTypes];  // requesters per pattern, then class per pattern
  int wcnt[kWarps][kPatTypes];  // per-warp class counts of a chunk
  int woff[kWarps][kPatTypes];  // per-warp class offsets of a chunk
  int csize[kPatTypes];   // members per class
  int cstart[kPatTypes];  // first member of each class in the member lists
  int cfill[kPatTypes];   // items ranked so far per class
  int tclass[kPatTypes];  // R1: the class holding type t, or -1
  unsigned cpat[kLanes];  // R2: each class's pattern
  int route, nclasses, nlive, remaining;
  int nopen[2];  // open requesters at the start of tile i, in slot i & 1
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = lane_id();
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__device__ __forceinline__ unsigned long long warp_or64(unsigned long long x) {
  const unsigned lo = __reduce_or_sync(kFull, (unsigned)x);
  const unsigned hi = __reduce_or_sync(kFull, (unsigned)(x >> 32));
  return ((unsigned long long)hi << 32) | lo;
}

__device__ __forceinline__ unsigned long long warp_and64(unsigned long long x) {
  const unsigned lo = __reduce_and_sync(kFull, (unsigned)x);
  const unsigned hi = __reduce_and_sync(kFull, (unsigned)(x >> 32));
  return ((unsigned long long)hi << 32) | lo;
}

// Bits t0 .. t0 + n - 1 (n <= 64) of requester r's mask row. `vec`: rows
// are 16-byte aligned and n is a multiple of 16.
__device__ __forceinline__ unsigned long long load_bits(
    const unsigned char* __restrict__ mask, int ntypes, int r, int t0, int n,
    bool vec) {
  const unsigned char* row = mask + (size_t)r * ntypes + t0;
  unsigned long long b = 0;
  if (vec) {
    for (int q = 0; q < n; q += 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + q));
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if ((w[i >> 2] >> (8 * (i & 3))) & 0xffu) b |= 1ull << (q + i);
    }
  } else {
    for (int t = 0; t < n; ++t)
      if (__ldg(row + t)) b |= 1ull << t;
  }
  return b;
}

// Requester r's pattern: its mask bits when valid, else 0 (T <= 64).
__device__ __forceinline__ unsigned long long pattern(
    const unsigned char* __restrict__ mask,
    const unsigned char* __restrict__ valid, int nr, int ntypes, int r,
    bool vec) {
  if (r >= nr || !__ldg(valid + r)) return 0;
  return load_bits(mask, ntypes, r, 0, ntypes, vec);
}

// Stable ranking of one chunk of items within their classes. Item j of a
// thread sits at chunk position warp * 32 * kRounds + j * 32 + lane; key -1
// is no class. On return rank[j] is the item's place in its class counting
// every earlier chunk (s.cfill carries the counts). With track_full, a
// class whose count reaches its size is taken off s.remaining. Every thread
// of the block calls it (it holds two block barriers).
__device__ void rank_chunk(const int (&key)[kRounds], int (&rank)[kRounds],
                           int nclasses, Shared& s, bool track_full) {
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int* wc = s.wcnt[warp];
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int k = key[j];
    const unsigned peers = __match_any_sync(kFull, k);
    const int before = k >= 0 ? wc[k] : 0;
    __syncwarp();
    if (k >= 0 && (peers & below) == 0) wc[k] = before + __popc(peers);
    __syncwarp();
    rank[j] = before + __popc(peers & below);
  }
  __syncthreads();
  for (int c = warp; c < nclasses; c += kWarps) {
    const int v = lane < kWarps ? s.wcnt[lane][c] : 0;
    const int incl = warp_incl_scan(v);
    const int base = s.cfill[c];
    if (lane < kWarps) {
      s.woff[lane][c] = base + incl - v;
      s.wcnt[lane][c] = 0;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    if (lane == 0) {
      s.cfill[c] = base + total;
      if (track_full && base < s.csize[c] && base + total >= s.csize[c])
        atomicSub(&s.remaining, 1);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRounds; ++j)
    if (key[j] >= 0) rank[j] += s.woff[warp][key[j]];
}

// Ordered tasks base .. base + n - 1 into a shared tile: their type (-1 when
// not live) and their original index.
__device__ __forceinline__ void stage(int* tile_type, int* tile_order,
                                      const long long* __restrict__ order,
                                      const int* __restrict__ task_type,
                                      int ntypes, int base, int n, int first,
                                      int stride) {
  for (int x = first; x < n; x += stride) {
    const int o = (int)order[base + x];
    const int t = task_type[o];
    tile_type[x] = (t >= 0 && t < ntypes) ? t : -1;
    tile_order[x] = o;
  }
}

// Everything after the choice of route: the member lists, then the route
// itself, with its working set at `region`. Every thread of the block calls
// it.
__device__ __forceinline__ void run_route(
    Shared& s, int* region, const long long* __restrict__ order,
    const int* __restrict__ task_type, const unsigned char* __restrict__ mask,
    const unsigned char* __restrict__ valid, int* __restrict__ out, int nr,
    int ntypes, bool vec, int* tile_type, int* tile_order, int route,
    int nclasses, int nlive) {
  const int nwords = (nr + 31) / 32;
  const int tid = threadIdx.x;
  const int lane = lane_id();
  const int warp = tid >> 5;

  if (route != kSweep) {
    // pass 2: the member lists, each in index order (a stable counting
    // partition of the requesters by class)
    for (int base = 0; base < nr; base += kChunk) {
      int key[kRounds], rank[kRounds];
#pragma unroll
      for (int j = 0; j < kRounds; ++j) {
        const int r = base + warp * 32 * kRounds + j * 32 + lane;
        const unsigned long long p = pattern(mask, valid, nr, ntypes, r, vec);
        key[j] = p == 0 ? -1
                 : route == kPartition ? __ffsll((long long)p) - 1
                                       : s.hist[(int)p];
      }
      rank_chunk(key, rank, nclasses, s, false);
#pragma unroll
      for (int j = 0; j < kRounds; ++j)
        if (key[j] >= 0)
          region[s.cstart[key[j]] + rank[j]] =
              base + warp * 32 * kRounds + j * 32 + lane;
    }
    for (int c = tid; c < nclasses; c += kThreads) s.cfill[c] = 0;
    __syncthreads();
  }

  if (route == kPartition) {
    // R1: the n-th live task of class c's types takes c's n-th member
    for (int base = 0; base < nlive && s.remaining > 0; base += kChunk) {
      int key[kRounds], rank[kRounds], od[kRounds];
#pragma unroll
      for (int j = 0; j < kRounds; ++j) {
        const int k = base + warp * 32 * kRounds + j * 32 + lane;
        od[j] = k < nlive ? (int)order[k] : -1;
      }
#pragma unroll
      for (int j = 0; j < kRounds; ++j) {
        const int t = od[j] >= 0 ? task_type[od[j]] : -1;
        key[j] = (t >= 0 && t < ntypes) ? s.tclass[t] : -1;
      }
      rank_chunk(key, rank, nclasses, s, true);
#pragma unroll
      for (int j = 0; j < kRounds; ++j)
        if (key[j] >= 0 && rank[j] < s.csize[key[j]])
          out[region[s.cstart[key[j]] + rank[j]]] = od[j];
    }
    return;
  }

  // R3: typebits [T][W] (bit r of row t: requester r is valid and accepts
  // t), the open bits [W] and one cursor per type, the first word that may
  // still hold an open requester of that type
  unsigned* typebits = reinterpret_cast<unsigned*>(region);
  unsigned* open = typebits + (size_t)ntypes * nwords;
  int* cursor = reinterpret_cast<int*>(open + nwords);
  if (route == kSweep) {
    int cnt = 0;
    for (int w = warp; w < nwords; w += kWarps) {
      const int r = w * 32 + lane;
      const bool v = r < nr && __ldg(valid + r);
      unsigned any = 0;
      for (int t0 = 0; t0 < ntypes; t0 += 64) {
        const int n = min(64, ntypes - t0);
        const unsigned long long bits =
            v ? load_bits(mask, ntypes, r, t0, n, vec) : 0ull;
        for (int t = 0; t < n; ++t) {
          const unsigned b = __ballot_sync(kFull, (bits >> t) & 1ull);
          if (lane == (t & 31)) typebits[(size_t)(t0 + t) * nwords + w] = b;
          any |= b;
        }
      }
      if (lane == 0) {
        open[w] = any;  // matchable: valid with a non-empty mask
        cnt += __popc(any);
      }
    }
    if (cnt) atomicAdd(&s.nopen[0], cnt);
    for (int t = tid; t < ntypes; t += kThreads) cursor[t] = 0;
  }

  const int ntiles = (nlive + kTile - 1) / kTile;
  if (ntiles > 0)
    stage(tile_type, tile_order, order, task_type, ntypes, 0,
          min(kTile, nlive), tid, kThreads);
  __syncthreads();

  // R2 lane state (warp 0): the class's pattern, its next two members and
  // where the one after them is in the member lists
  unsigned pat = 0, live = 0;
  int nxt = kNone, nxt2 = kNone, pos = 0, end = 0;
  if (route == kClasses && warp == 0) {
    if (lane < nclasses) {
      pat = s.cpat[lane];
      pos = s.cstart[lane];
      end = pos + s.csize[lane];
      nxt = pos < end ? region[pos] : kNone;
      nxt2 = pos + 1 < end ? region[pos + 1] : kNone;
      pos += 2;
    }
    live = __reduce_or_sync(kFull, pat);  // types some open class holds
  }

  for (int i = 0; i < ntiles; ++i) {
    if (s.nopen[i & 1] == 0) break;  // uniform: read after the barrier
    const int buf = (i & 1) * kTile;
    const int n = min(kTile, nlive - i * kTile);
    if (warp == 0) {
      const int* ty = tile_type + buf;
      const int* od = tile_order + buf;
      int nopen = s.nopen[i & 1];  // the same value in every lane
      if (route == kClasses) {
        for (int g = 0; g < n && nopen > 0 && live; g += 32) {
          const int myt = g + lane < n ? ty[g + lane] : -1;
          // bit j: this lane's class holds the type of the group's task j,
          // so a step needs no shuffle of the task's type. A task that is
          // not live (-1) tests bit 31, which no pattern has (T <= 10).
          unsigned holds = 0;
#pragma unroll 8
          for (int j = 0; j < 32; ++j) {
            const int tj = __shfl_sync(kFull, myt, j);
            holds |= ((pat >> (tj & 31)) & 1u) << j;
          }
          unsigned pend = __ballot_sync(kFull, myt >= 0 && ((live >> myt) & 1u));
          while (pend) {
            const int j = __ffs(pend) - 1;
            pend &= pend - 1;
            // shared loads first, so their latency hides behind the reduce
            const int o = od[g + j];
            const int ahead = region[pos < end ? pos : 0];
            const int cand = ((holds >> j) & 1u) ? nxt : kNone;
            const int m = __reduce_min_sync(kFull, cand);
            if (m == kNone) {  // every class holding the type is used up
              const int t = __shfl_sync(kFull, myt, j);
              live &= ~(1u << t);
              pend &= ~__ballot_sync(kFull, myt == t);
              continue;
            }
            // members are distinct, so one lane wins; it advances without
            // a branch, to the member it prefetched
            const bool win = cand == m;
            if (win) out[m] = o;
            nxt = win ? nxt2 : nxt;
            nxt2 = win ? (pos < end ? ahead : kNone) : nxt2;
            pos += win;
            if (--nopen == 0) break;
          }
        }
        if (!live) nopen = 0;
      } else {
        for (int g = 0; g < n && nopen > 0; g += 32) {
          const int myt = g + lane < n ? ty[g + lane] : -1;
          // a superset of the tasks that can still match: a type may die
          // later in this group, which the probe loop below sees
          unsigned pend =
              __ballot_sync(kFull, myt >= 0 && cursor[myt] < nwords);
          while (pend && nopen > 0) {
            const int j = __ffs(pend) - 1;
            pend &= pend - 1;
            const int t = __shfl_sync(kFull, myt, j);
            const int o = od[g + j];  // loaded ahead of the probe
            const unsigned* row = typebits + (size_t)t * nwords;
            int c = cursor[t];
            bool found = false;
            while (c < nwords) {
              const int w = c + lane;
              const unsigned bits = w < nwords ? (row[w] & open[w]) : 0u;
              const unsigned hit = __ballot_sync(kFull, bits != 0u);
              if (hit) {
                if (lane == __ffs(hit) - 1) {
                  const int b = __ffs(bits) - 1;
                  open[w] = open[w] & ~(1u << b);
                  out[w * 32 + b] = o;
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
      }
      if (lane == 0) s.nopen[(i + 1) & 1] = nopen;
    } else if (i + 1 < ntiles) {
      const int base = (i + 1) * kTile;
      stage(tile_type + (kTile - buf), tile_order + (kTile - buf), order,
            task_type, ntypes, base, min(kTile, nlive - base), tid - 32,
            kThreads - 32);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
greedy_sweep_kernel(const int* __restrict__ s_prio,
                    const long long* __restrict__ order,
                    const int* __restrict__ task_type,
                    const unsigned char* __restrict__ mask,
                    const unsigned char* __restrict__ valid,
                    int* __restrict__ out, int* scratch, int nt, int nr,
                    int ntypes, int region_cap, bool vec) {
  __shared__ Shared s;
  // the staged tiles, then region_cap words for the route's working set
  extern __shared__ int dyn[];
  int* tile_type = dyn;  // [2][kTile]
  int* tile_order = tile_type + 2 * kTile;

  const int tid = threadIdx.x;
  const int lane = lane_id();
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;

  for (int i = tid; i < kPatTypes; i += kThreads) {
    s.tand[i] = ~0ull;
    s.tor[i] = 0ull;
    s.csize[i] = 0;
    s.cfill[i] = 0;
    s.tclass[i] = -1;
  }
  for (int i = tid; i < (1 << kHistTypes); i += kThreads) s.hist[i] = 0;
  for (int i = tid; i < kWarps * kPatTypes; i += kThreads)
    (&s.wcnt[0][0])[i] = 0;
  for (int r = tid; r < nr; r += kThreads) out[r] = -1;
  if (warp == 0) {
    // live tasks are the prefix with s_prio > kNeg: search with 32 probes a
    // round; the answer lies in [lo, hi]
    int lo = 0, hi = nt;
    while (hi - lo > 32) {
      const long long span = hi - lo;
      const int p = lo + (int)(span * (lane + 1) / 33);
      const unsigned dead = __ballot_sync(kFull, s_prio[p] <= kNeg);
      const int nlow = __popc(~dead);  // live probes come first
      const int plo = __shfl_sync(kFull, p, nlow > 0 ? nlow - 1 : 0);
      const int phi = __shfl_sync(kFull, p, nlow < 32 ? nlow : 31);
      if (nlow > 0) lo = plo + 1;
      if (nlow < 32) hi = phi;
    }
    const int p = lo + lane;
    const unsigned dead = __ballot_sync(kFull, p >= hi || s_prio[p] <= kNeg);
    if (lane == 0) s.nlive = dead ? lo + __ffs(dead) - 1 : hi;
  }
  __syncthreads();

  if (ntypes <= kPatTypes) {
    // pass 1: per-type AND / OR of the patterns holding it, members per
    // lowest type (R1's class sizes) and, for T <= 10, per pattern
    for (int base = warp * 32; base < nr; base += kThreads) {
      const unsigned long long p =
          pattern(mask, valid, nr, ntypes, base + lane, vec);
      unsigned long long present = warp_or64(p);
      while (present) {
        const int t = __ffsll((long long)present) - 1;
        present &= present - 1;
        const bool has = (p >> t) & 1ull;
        const unsigned long long a = warp_and64(has ? p : ~0ull);
        const unsigned long long o = warp_or64(has ? p : 0ull);
        if (lane == 0) {
          atomicAnd(&s.tand[t], a);
          atomicOr(&s.tor[t], o);
        }
      }
      const int low = p ? __ffsll((long long)p) - 1 : -1;
      const unsigned lpeers = __match_any_sync(kFull, low);
      if (low >= 0 && (lpeers & below) == 0)
        atomicAdd(&s.csize[low], __popc(lpeers));
      if (ntypes <= kHistTypes) {
        const int key = (int)p;
        const unsigned ppeers = __match_any_sync(kFull, key);
        if (key && (ppeers & below) == 0)
          atomicAdd(&s.hist[key], __popc(ppeers));
      }
    }
  }
  __syncthreads();

  if (warp == 0) {
    // the route, the classes and where their member lists start
    int route = kSweep, nclasses = 0;
    if (ntypes <= kPatTypes) {
      bool ok = true;
      for (int t = lane; t < ntypes; t += 32)
        if (s.tor[t] && s.tand[t] != s.tor[t]) ok = false;
      if (__all_sync(kFull, ok)) {
        route = kPartition;  // class id: the lowest type of its pattern
        nclasses = ntypes;
        for (int t = lane; t < ntypes; t += 32)
          s.tclass[t] = s.tor[t] ? __ffsll((long long)s.tor[t]) - 1 : -1;
      } else if (ntypes <= kHistTypes) {
        const int nbins = 1 << ntypes;
        for (int b0 = 0; b0 < nbins; b0 += 32) {
          const int b = b0 + lane;
          const int cnt = (b > 0 && b < nbins) ? s.hist[b] : 0;
          const unsigned present = __ballot_sync(kFull, cnt > 0);
          if (cnt > 0) {
            const int id = nclasses + __popc(present & below);
            if (id < kLanes) {
              s.csize[id] = cnt;
              s.cpat[id] = (unsigned)b;
            }
            s.hist[b] = id;  // class id per pattern, in pattern order
          }
          nclasses += __popc(present);
        }
        if (nclasses <= kLanes) route = kClasses;
      }
    }
    __syncwarp();  // the lanes' csize writes, read by other lanes below
    if (route != kSweep) {
      const int v0 = lane < nclasses ? s.csize[lane] : 0;
      const int v1 = lane + 32 < nclasses ? s.csize[lane + 32] : 0;
      const int i0 = warp_incl_scan(v0);
      const int i1 = warp_incl_scan(v1);
      const int t0 = __shfl_sync(kFull, i0, 31);
      const int t1 = __shfl_sync(kFull, i1, 31);
      if (lane < nclasses) s.cstart[lane] = i0 - v0;
      if (lane + 32 < nclasses) s.cstart[lane + 32] = t0 + i1 - v1;
      const int nonempty = __popc(__ballot_sync(kFull, v0 > 0)) +
                           __popc(__ballot_sync(kFull, v1 > 0));
      if (lane == 0) {
        s.remaining = nonempty;
        s.nopen[0] = t0 + t1;  // R2: every member starts open
      }
    } else if (lane == 0) {
      s.nopen[0] = 0;  // R3: counted while the bitmasks are built
    }
    if (lane == 0) {
      s.route = route;
      s.nclasses = nclasses;
      out[nr] = route;
      atomicAdd(&g_route_launches[route - 1], 1ull);
    }
  }
  __syncthreads();
  const int route = s.route;
  const int nclasses = s.nclasses;
  const int nlive = s.nlive;
  // two copies of the routes, so that the one whose working set sits in
  // shared memory addresses it as such and not through generic pointers
  if (region_words(route, nr, ntypes) <= region_cap)
    run_route(s, tile_order + 2 * kTile, order, task_type, mask, valid, out,
              nr, ntypes, vec, tile_type, tile_order, route, nclasses, nlive);
  else
    run_route(s, scratch, order, task_type, mask, valid, out, nr, ntypes, vec,
              tile_type, tile_order, route, nclasses, nlive);
}

int g_max_dyn = -1;  // dynamic shared memory a launch may use, in bytes

// Words of shared memory a launch gives the route's working set: what the
// largest route needs, up to what is left beside the tiles.
long long shared_region_words(int nr, int ntypes) {
  const long long need = std::max(region_words(kPartition, nr, ntypes),
                                  region_words(kSweep, nr, ntypes));
  return std::min(need, g_max_dyn / 4LL - 4LL * kTile);
}

}  // namespace

extern "C" {

// Once per process, after loading: lets the kernel use all the shared
// memory a block may have. Returns the CUDA error code (0 = cudaSuccess).
int adlb_greedy_sweep_init() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, greedy_sweep_kernel);
  if (err != cudaSuccess) return (int)err;
  g_max_dyn = optin - (int)attr.sharedSizeBytes;
  return (int)cudaFuncSetAttribute(
      greedy_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      g_max_dyn);
}

// Bytes of device scratch a launch at NR x T needs: 0 when every route's
// working set fits in shared memory, else the largest one's (after
// adlb_greedy_sweep_init).
long long adlb_greedy_sweep_scratch_bytes(int nr, int ntypes) {
  const long long need = std::max(region_words(kPartition, nr, ntypes),
                                  region_words(kSweep, nr, ntypes));
  return need > shared_region_words(nr, ntypes) ? 4LL * need : 0LL;
}

// Launches the solve on `stream`; `scratch` holds
// adlb_greedy_sweep_scratch_bytes(nr, ntypes) bytes of device memory, or is
// null when that is 0. Returns the CUDA error code of the launch
// (0 = cudaSuccess). Does not synchronise.
int adlb_greedy_sweep(const int* s_prio, const long long* order,
                      const int* task_type, const unsigned char* mask,
                      const unsigned char* valid, int* out, int* scratch,
                      int nt, int nr, int ntypes, void* stream) {
  if (scratch == nullptr && adlb_greedy_sweep_scratch_bytes(nr, ntypes) > 0)
    return (int)cudaErrorInvalidValue;
  const bool vec = ntypes % 16 == 0 && ((uintptr_t)mask & 15) == 0;
  const long long cap = shared_region_words(nr, ntypes);
  greedy_sweep_kernel<<<1, kThreads, (size_t)(4 * (4LL * kTile + cap)),
                        (cudaStream_t)stream>>>(
      s_prio, order, task_type, mask, valid, out, scratch, nt, nr, ntypes,
      (int)cap, vec);
  return (int)cudaGetLastError();
}

// The kernel's launches per route on the current device so far, into
// counts[3] (partition, classes, sweep); synchronous.
int adlb_greedy_sweep_route_counts(unsigned long long* counts) {
  return (int)cudaMemcpyFromSymbol(counts, g_route_launches,
                                   sizeof(g_route_launches));
}

int adlb_greedy_sweep_reset_route_counts() {
  const unsigned long long zero[3] = {0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_route_launches, zero, sizeof(zero));
}

// One asynchronous copy on `stream` between pinned host and device memory
// (either way); returns the CUDA error code. Called through ctypes.PyDLL,
// it keeps the interpreter lock, unlike a torch copy.
int adlb_copy_async(void* dst, const void* src, long long nbytes,
                    void* stream) {
  return (int)cudaMemcpyAsync(dst, src, (size_t)nbytes, cudaMemcpyDefault,
                              (cudaStream_t)stream);
}

const char* adlb_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
