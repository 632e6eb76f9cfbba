// Native work-queue core: the server's hot matching path in C++.
//
// The reference implements its entire data plane in C (queues:
// reference src/xq.c, with O(n) linked-list priority scans at
// src/xq.c:190-247). This library is the tpu-native rebuild's equivalent,
// but indexed: per-(type) and per-(target,type) lazy-deletion binary heaps
// over a dense unit table, so insert/match/pin/remove are O(log n).
// Semantics are identical to the pure-Python adlb_tpu_torch.runtime.queues
// WorkQueue (property-tested against it): algebraically-largest priority
// first, FIFO by seqno among equals, targeted-before-untargeted for the
// requesting rank, pinned units invisible.
//
// Exposed as a minimal C ABI consumed via ctypes (no pybind11 in this
// environment); payload bytes never cross the boundary — Python keeps them,
// C++ keeps the metadata index.

#include "wqcore.hpp"

using namespace adlbwq;


extern "C" {

void* adlb_wq_new() { return new WorkQueue(); }

void adlb_wq_free(void* h) { delete static_cast<WorkQueue*>(h); }

// 0 on success, -1 on duplicate seqno
int32_t adlb_wq_add(void* h, int64_t seqno, int32_t work_type, int32_t prio,
                    int32_t target_rank, int32_t pinned, int32_t pin_rank,
                    int64_t payload_len) {
    auto* wq = static_cast<WorkQueue*>(h);
    if (wq->units.count(seqno)) return -1;
    Unit u{seqno, work_type, prio, target_rank, pinned ? pin_rank : -1,
           payload_len};
    wq->units.emplace(seqno, u);
    wq->count += 1;
    if (wq->count > wq->max_count) wq->max_count = wq->count;
    wq->total_bytes += payload_len;
    if (!pinned && target_rank < 0) wq->unpinned_untargeted += 1;
    if (!pinned) wq->index(u);
    return 0;
}

int32_t adlb_wq_remove(void* h, int64_t seqno) {
    auto* wq = static_cast<WorkQueue*>(h);
    auto it = wq->units.find(seqno);
    if (it == wq->units.end()) return -1;
    wq->total_bytes -= it->second.payload_len;
    if (it->second.pin_rank < 0 && it->second.target_rank < 0)
        wq->unpinned_untargeted -= 1;
    wq->units.erase(it);
    wq->count -= 1;
    return 0;
}

int32_t adlb_wq_pin(void* h, int64_t seqno, int32_t rank) {
    auto* wq = static_cast<WorkQueue*>(h);
    auto it = wq->units.find(seqno);
    if (it == wq->units.end()) return -1;
    if (it->second.pin_rank < 0 && rank >= 0 &&
        it->second.target_rank < 0)
        wq->unpinned_untargeted -= 1;
    it->second.pin_rank = rank;
    return 0;
}

int32_t adlb_wq_unpin(void* h, int64_t seqno) {
    auto* wq = static_cast<WorkQueue*>(h);
    auto it = wq->units.find(seqno);
    if (it == wq->units.end()) return -1;
    if (it->second.pin_rank >= 0 && it->second.target_rank < 0)
        wq->unpinned_untargeted += 1;
    it->second.pin_rank = -1;
    wq->index(it->second);
    return 0;
}

// Reference match order (src/adlb.c:1204-1237): targeted at `rank` first,
// then best untargeted. ntypes==0 means any type. Returns seqno or -1.
int64_t adlb_wq_find_match(void* h, int32_t rank, const int32_t* req_types,
                           int32_t ntypes) {
    auto* wq = static_cast<WorkQueue*>(h);
    const Unit* u = wq->find_targeted(rank, req_types, ntypes);
    if (u == nullptr) u = wq->find_untargeted(req_types, ntypes);
    return u == nullptr ? -1 : u->seqno;
}

int64_t adlb_wq_find_targeted(void* h, int32_t rank, const int32_t* req_types,
                              int32_t ntypes) {
    auto* wq = static_cast<WorkQueue*>(h);
    const Unit* u = wq->find_targeted(rank, req_types, ntypes);
    return u == nullptr ? -1 : u->seqno;
}

int64_t adlb_wq_find_untargeted(void* h, const int32_t* req_types,
                                int32_t ntypes) {
    auto* wq = static_cast<WorkQueue*>(h);
    const Unit* u = wq->find_untargeted(req_types, ntypes);
    return u == nullptr ? -1 : u->seqno;
}

int32_t adlb_wq_hi_prio_of_type(void* h, int32_t work_type, int32_t* out_prio) {
    auto* wq = static_cast<WorkQueue*>(h);
    auto it = wq->untargeted.find(work_type);
    const Unit* u =
        (it == wq->untargeted.end()) ? nullptr : wq->peek_best(&it->second, -1);
    if (u == nullptr) return -1;
    *out_prio = u->prio;
    return 0;
}

int64_t adlb_wq_count(void* h) { return static_cast<WorkQueue*>(h)->count; }

int64_t adlb_wq_max_count(void* h) {
    return static_cast<WorkQueue*>(h)->max_count;
}

int64_t adlb_wq_total_bytes(void* h) {
    return static_cast<WorkQueue*>(h)->total_bytes;
}

int64_t adlb_wq_num_unpinned(void* h) {
    auto* wq = static_cast<WorkQueue*>(h);
    int64_t n = 0;
    for (auto& kv : wq->units)
        if (kv.second.pin_rank < 0) n += 1;
    return n;
}

int64_t adlb_wq_num_unpinned_untargeted(void* h) {
    // O(1): the counter is maintained at add/remove/pin/unpin — this is
    // the balancer's per-tick availability signal, and the old O(n)
    // walk (paired with the per-call GIL release/re-acquire) was a
    // measurable slice of tpu-mode pop latency
    return static_cast<WorkQueue*>(h)->unpinned_untargeted;
}

// (count, unpinned-untargeted, bytes) in ONE call: the periodic tick's
// queue-depth gauges. Every ctypes crossing releases and re-acquires
// the GIL; on a loaded host each re-acquire can cost milliseconds on
// the reactor thread, so the tick pays one crossing, not three.
void adlb_wq_depth_sample(void* h, int64_t* out) {
    auto* wq = static_cast<WorkQueue*>(h);
    out[0] = wq->count;
    out[1] = wq->unpinned_untargeted;
    out[2] = wq->total_bytes;
}

// Fill out arrays with up to `cap` unpinned untargeted units, sorted by
// descending priority then seqno — the balancer snapshot fast path.
int64_t adlb_wq_snapshot_untargeted(void* h, int64_t cap, int64_t* out_seqnos,
                                    int32_t* out_types, int32_t* out_prios,
                                    int64_t* out_lens) {
    auto* wq = static_cast<WorkQueue*>(h);
    std::vector<const Unit*> avail;
    avail.reserve(wq->units.size());
    for (auto& kv : wq->units)
        if (kv.second.pin_rank < 0 && kv.second.target_rank < 0)
            avail.push_back(&kv.second);
    std::sort(avail.begin(), avail.end(), [](const Unit* a, const Unit* b) {
        if (a->prio != b->prio) return a->prio > b->prio;
        return a->seqno < b->seqno;
    });
    int64_t n = std::min<int64_t>(cap, avail.size());
    for (int64_t i = 0; i < n; ++i) {
        out_seqnos[i] = avail[i]->seqno;
        out_types[i] = avail[i]->work_type;
        out_prios[i] = avail[i]->prio;
        out_lens[i] = avail[i]->payload_len;
    }
    return n;
}

int32_t adlb_wq_get(void* h, int64_t seqno, int32_t* out_type,
                    int32_t* out_prio, int32_t* out_target,
                    int32_t* out_pin_rank, int64_t* out_len) {
    auto* wq = static_cast<WorkQueue*>(h);
    auto it = wq->units.find(seqno);
    if (it == wq->units.end()) return -1;
    *out_type = it->second.work_type;
    *out_prio = it->second.prio;
    *out_target = it->second.target_rank;
    *out_pin_rank = it->second.pin_rank;
    *out_len = it->second.payload_len;
    return 0;
}

}  // extern "C"
