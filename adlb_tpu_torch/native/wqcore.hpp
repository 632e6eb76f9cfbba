// Indexed work-queue core, shared between the ctypes library (wqcore.cpp,
// used under the Python server) and the native server daemon (serverd.cpp).
//
// The reference implements its queues as linked lists with O(n) priority
// scans (reference src/xq.c:190-247); this is the rebuild's indexed
// equivalent: per-(type) and per-(target,type) lazy-deletion binary heaps
// over a dense unit table, so insert/match/pin/remove are O(log n).
// Semantics match adlb_tpu_torch.runtime.queues.WorkQueue (property-tested):
// algebraically-largest priority first, FIFO by seqno among equals,
// targeted-before-untargeted for the requesting rank, pinned invisible.

#pragma once

#include <algorithm>
#include <cstdint>
#include <queue>
#include <unordered_map>
#include <vector>

namespace adlbwq {

struct HeapKey {
    int32_t neg_prio;  // -prio: min-heap top = max priority
    int64_t seqno;     // FIFO tie-break
    bool operator>(const HeapKey& o) const {
        if (neg_prio != o.neg_prio) return neg_prio > o.neg_prio;
        return seqno > o.seqno;
    }
};

using MinHeap =
    std::priority_queue<HeapKey, std::vector<HeapKey>, std::greater<HeapKey>>;

struct Unit {
    int64_t seqno;
    int32_t work_type;
    int32_t prio;
    int32_t target_rank;  // -1 = untargeted
    int32_t pin_rank;     // -1 = unpinned
    int64_t payload_len;
};

struct PairHash {
    size_t operator()(const std::pair<int32_t, int32_t>& p) const {
        return std::hash<int64_t>()((int64_t(p.first) << 32) ^
                                    uint32_t(p.second));
    }
};

struct WorkQueue {
    std::unordered_map<int64_t, Unit> units;
    std::unordered_map<int32_t, MinHeap> untargeted;  // type -> heap
    std::unordered_map<std::pair<int32_t, int32_t>, MinHeap, PairHash>
        targeted;  // (target, type) -> heap
    std::unordered_map<int32_t, std::vector<int32_t>>
        targeted_types;  // target -> types with (possibly stale) buckets
    int64_t count = 0;
    int64_t max_count = 0;
    int64_t total_bytes = 0;
    // O(1) mirror of "unpinned && untargeted" (the balancer's
    // availability signal, read every periodic tick): maintained at
    // add/remove/pin/unpin so the tick never walks the unit table
    int64_t unpinned_untargeted = 0;

    void index(const Unit& u) {
        HeapKey k{-u.prio, u.seqno};
        if (u.target_rank < 0) {
            untargeted[u.work_type].push(k);
        } else {
            targeted[{u.target_rank, u.work_type}].push(k);
            auto& types = targeted_types[u.target_rank];
            bool present = false;
            for (int32_t t : types)
                if (t == u.work_type) { present = true; break; }
            if (!present) types.push_back(u.work_type);
        }
    }

    // Best live unit on a heap, popping stale tops. targeted_to >= 0 checks
    // target identity; -1 requires untargeted.
    const Unit* peek_best(MinHeap* heap, int32_t targeted_to) {
        if (heap == nullptr) return nullptr;
        while (!heap->empty()) {
            HeapKey k = heap->top();
            auto it = units.find(k.seqno);
            if (it == units.end() || it->second.pin_rank >= 0 ||
                it->second.prio != -k.neg_prio ||
                (targeted_to >= 0 && it->second.target_rank != targeted_to) ||
                (targeted_to < 0 && it->second.target_rank >= 0)) {
                heap->pop();
                continue;
            }
            return &it->second;
        }
        return nullptr;
    }

    static bool better(const Unit* a, const Unit* b) {  // a beats b?
        if (b == nullptr) return true;
        if (a->prio != b->prio) return a->prio > b->prio;
        return a->seqno < b->seqno;
    }

    const Unit* find_targeted(int32_t rank, const int32_t* req_types,
                              int32_t ntypes) {
        auto tit = targeted_types.find(rank);
        if (tit == targeted_types.end()) return nullptr;
        const Unit* best = nullptr;
        auto& types = tit->second;
        for (size_t i = 0; i < types.size();) {
            int32_t t = types[i];
            bool wanted = (ntypes == 0);
            for (int32_t j = 0; j < ntypes && !wanted; ++j)
                wanted = (req_types[j] == t);
            if (!wanted) { ++i; continue; }
            auto hit = targeted.find({rank, t});
            MinHeap* heap = (hit == targeted.end()) ? nullptr : &hit->second;
            const Unit* u = peek_best(heap, rank);
            if (u == nullptr) {
                if (heap == nullptr || heap->empty()) {
                    // drained bucket: prune (unpin re-indexes)
                    if (hit != targeted.end()) targeted.erase(hit);
                    types[i] = types.back();
                    types.pop_back();
                    continue;
                }
                ++i;
                continue;
            }
            if (better(u, best)) best = u;
            ++i;
        }
        if (types.empty()) targeted_types.erase(tit);
        return best;
    }

    const Unit* find_untargeted(const int32_t* req_types, int32_t ntypes) {
        const Unit* best = nullptr;
        if (ntypes == 0) {
            for (auto& kv : untargeted) {
                const Unit* u = peek_best(&kv.second, -1);
                if (u != nullptr && better(u, best)) best = u;
            }
        } else {
            for (int32_t j = 0; j < ntypes; ++j) {
                auto it = untargeted.find(req_types[j]);
                if (it == untargeted.end()) continue;
                const Unit* u = peek_best(&it->second, -1);
                if (u != nullptr && better(u, best)) best = u;
            }
        }
        return best;
    }
};

}  // namespace adlbwq
