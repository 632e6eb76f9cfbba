// Native server daemon: the C++ twin of the Python server reactor
// (adlb_tpu_torch/runtime/server.py), covering the reference's full steal-mode
// protocol — the equivalent of ADLBP_Server's ~2,100-line event loop
// (reference src/adlb.c:382-2506): Put admission + immediate rq match,
// Reserve with targeted-first indexed matching, Get/common fetch, qmstat
// state broadcast (reference src/adlb.c:806-822), RFR pull stealing with
// stale-state patching and UNRESERVE compensation (reference
// src/adlb.c:1802-2070), memory-pressure push with PUSH_DEL cancellation
// (reference src/adlb.c:509-556,2109-2362), the double-pass exhaustion vote
// (reference src/adlb.c:754-785,1575-1650), held two-phase shutdown ring
// (reference src/adlb.c:1493-1574), abort fan-out, and the Info stats
// surface (reference src/adlb.c:3072-3141).
//
// Runs one process per server rank. Clients may be Python (binary-codec
// frames; spawn_world declares native servers as binary peers) or native C
// (libadlb.cpp). Server<->server frames reuse the same TLV form with
// field ids >= 27, which exist only here: worlds never mix native and
// Python servers, so those ids never reach the Python decoder.
//
// Bootstrap protocol with the Python wrapper (transport_tcp._child_main):
//   stdin:  config lines ... "endconfig"
//   stdout: "PORT <n>"
//   stdin:  "addr <rank> <host> <port>" lines ... "endaddrs"
//   ... runs ...
//   stdout: "STATS {json}"   (finalize_stats), or "ABORT <code>"
//
// The balancer brain stays in Python (SURVEY §7's language split);
// balancer="tpu" worlds use the Python server.

#include <arpa/inet.h>
#include <dirent.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <deque>
#include <iostream>
#include <array>
#include <map>
#include <mutex>
#include <set>
#include <sstream>
#include <stdexcept>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "wqcore.hpp"

namespace {

// ---- constants (adlb_tpu_torch/types.py) ----------------------------------------
constexpr int ADLB_SUCCESS = 1;
constexpr int ADLB_NO_MORE_WORK = -999999999;
constexpr int ADLB_DONE_BY_EXHAUSTION = -999999998;
constexpr int ADLB_NO_CURRENT_WORK = -999999997;
constexpr int ADLB_PUT_REJECTED = -999999996;
// Python-plane extension rcs (this daemon never issues them — no lease
// table, no watermark backpressure — but the constants are registered so
// the rc space stays in sync with adlb.h / adlb_tpu_torch/types.py)
constexpr int ADLB_RETRY = -999999995;
constexpr int ADLB_FENCED = -999999994;
constexpr int ADLB_BACKOFF = -999999993;
constexpr int ADLB_LOWEST_PRIO = -999999999;

// InfoKey (adlb_tpu_torch/types.py InfoKey)
enum InfoKey {
  K_MALLOC_HWM = 1,
  K_AVG_TIME_ON_RQ = 2,
  K_NPUSHED_FROM_HERE = 3,
  K_NPUSHED_TO_HERE = 4,
  K_NREJECTED_PUTS = 5,
  K_LOOP_TOP_TIME = 6,
  K_MAX_QMSTAT_TRIP_TIME = 7,
  K_AVG_QMSTAT_TRIP_TIME = 8,
  K_NUM_QMS_EXCEED_INT = 9,
  K_NUM_RESERVES = 10,
  K_NUM_RESERVES_PUT_ON_RQ = 11,
  K_MAX_WQ_COUNT = 12,
  K_LAST = 13,  // bound of the stats_[] table; keys below are NOT stats slots
  // introspection keys answered from live probes, not the stats_[] table
  // (must match ADLB_INFO_RSS_KB / ADLB_INFO_TRANSPORT_BACKLOG in
  // include/adlb/adlb.h and types.py InfoKey)
  K_RSS_KB = 13,
  K_TRANSPORT_BACKLOG = 14,
};

// ---- wire tags (codec.py WIRE_TAG) ----------------------------------------
enum WireTag : uint16_t {
  T_FA_PUT = 1001,
  T_FA_PUT_COMMON = 1003,
  T_FA_BATCH_DONE = 1005,
  T_FA_DID_PUT_AT_REMOTE = 1006,
  T_FA_RESERVE = 1007,
  T_TA_RESERVE_RESP = 1008,
  T_FA_GET_RESERVED = 1009,
  T_TA_GET_RESERVED_RESP = 1010,
  T_FA_NO_MORE_WORK = 1011,
  T_FA_LOCAL_APP_DONE = 1012,
  T_TA_PUT_RESP = 1020,
  T_FA_ABORT = 1027,
  T_FA_INFO_NUM_WORK_UNITS = 1037,
  T_FA_GET_COMMON = 1038,
  T_TA_GET_COMMON_RESP = 1039,
  T_FA_INFO_GET = 1041,
  T_TA_PUT_COMMON_RESP = 1042,
  T_TA_INFO_NUM_RESP = 1043,
  T_TA_INFO_GET_RESP = 1044,
  T_TA_ABORT = 1046,
  // server <-> server (codec.py 11xx block)
  T_SS_QMSTAT = 1101,
  T_SS_RFR = 1102,
  T_SS_RFR_RESP = 1103,
  T_SS_UNRESERVE = 1104,
  T_SS_PUSH_QUERY = 1105,
  T_SS_PUSH_QUERY_RESP = 1106,
  T_SS_PUSH_WORK = 1107,
  T_SS_PUSH_DEL = 1108,
  T_SS_MOVING_TARGETED_WORK = 1109,
  T_SS_NO_MORE_WORK = 1110,
  T_SS_EXHAUST_CHK_1 = 1111,
  T_SS_EXHAUST_CHK_2 = 1112,
  T_SS_DONE_BY_EXHAUSTION = 1113,
  T_SS_END_1 = 1114,
  T_SS_END_2 = 1115,
  T_SS_ABORT = 1116,
  T_SS_PERIODIC_STATS = 1122,
  T_SS_STATE = 1117,
  T_SS_STATE_DELTA = 1125,
  T_SS_HUNGRY = 1124,
  T_SS_PLAN_MATCH = 1118,
  T_SS_PLAN_MIGRATE = 1119,
  T_SS_MIGRATE_WORK = 1120,
  T_SS_MIGRATE_ACK = 1121,
  T_DS_LOG = 1131,
  T_DS_END = 1132,
  // checkpoint/resume (runtime/checkpoint.py; no reference analogue)
  T_FA_CHECKPOINT = 1048,
  T_TA_CHECKPOINT_RESP = 1049,
  T_SS_CHECKPOINT = 1123,
  // gray-failure surface (Python servers only): a liveness beacon this
  // daemon parses-and-ignores — it keeps no lease table, so a client
  // heartbeating across a mixed-version world must not be fatal
  T_FA_HEARTBEAT = 1054,
  T_PEER_EOF = 1999,  // transport-internal synthetic signal (never on wire)
};

// ---- field ids ------------------------------------------------------------
// 1..26 mirror codec.py FIELDS (shared with Python/native clients);
// >= 27 are native-server-only (server<->server frames).
enum FieldId : uint8_t {
  F_PAYLOAD = 1,       // bytes
  F_WORK_TYPE = 2,     // i64
  F_PRIO = 3,          // i64
  F_TARGET_RANK = 4,   // i64
  F_ANSWER_RANK = 5,   // i64
  F_COMMON_LEN = 6,    // i64
  F_COMMON_SERVER = 7, // i64
  F_COMMON_SEQNO = 8,  // i64
  F_RC = 9,            // i64
  F_HINT = 10,         // i64
  F_REQ_TYPES = 11,    // list
  F_HANG = 12,         // i64
  F_RQSEQNO = 13,      // i64
  F_HANDLE = 14,       // list
  F_WORK_LEN = 15,     // i64
  F_TIME_ON_Q = 16,    // f64
  F_COUNT = 17,        // i64
  F_NBYTES = 18,       // i64
  F_MAX_WQ = 19,       // i64
  F_CODE = 20,         // i64
  F_SEQNO = 21,        // i64
  F_REFCNT = 22,       // i64
  F_SERVER_RANK = 23,  // i64
  F_KEY = 24,          // i64
  F_VALUE = 25,        // f64
  // -- native-only --
  F_QLEN = 27,            // i64
  F_HI_PRIO = 28,         // list: prios in world-types order
  F_FOR_RANK = 29,        // i64
  F_TARGETED_LOOKUP = 30, // i64
  F_LOOKUP_TYPE = 31,     // i64
  F_FOUND = 32,           // i64
  F_QUERY_ID = 33,        // i64
  F_ACCEPT = 34,          // i64
  F_HOME_SERVER = 35,     // i64
  F_TIME_STAMP = 36,      // f64
  F_APP_RANK = 37,        // i64
  F_FROM_SERVER = 38,     // i64
  F_TO_SERVER = 39,       // i64
  F_ORIGIN = 40,          // i64
  F_VOTE_OK = 41,              // i64
  F_COMPLETE = 42,        // i64
  F_NPARKED = 43,         // i64
  F_ACT = 44,             // list: alternating (rank, activity)
  F_PARKED = 45,          // list: flattened (rank, ntypes, t0..tn)*
  F_TOKEN_ID = 62,        // i64: exhaustion-token id (lost-token recovery)
  F_EVENTS = 63,          // i64 (DS_LOG: msgs handled since last log)
  F_WQ_TARGETED = 64,     // i64 (DS_LOG)
  F_RESERVES = 65,        // i64 (DS_LOG, since last log)
  F_RESERVES_IMMED = 66,  // i64 (DS_LOG, since last log)
  F_RESERVES_PARKED = 67, // i64 (DS_LOG, since last log)
  F_RFR_FAILED = 68,      // i64 (DS_LOG, since last log)
  F_SS_MSGS = 69,         // i64 (DS_LOG, since last log)
  F_BACKLOG = 70,         // i64 (DS_LOG: unhandled inbox frames)
  F_RSS_KB = 71,          // i64 (DS_LOG: /proc/self/status VmRSS)
  // checkpoint ring token (shared with codec.py: the requesting client
  // may be a Python rank)
  F_PATH = 72,            // bytes: shard path prefix
  F_CLIENT = 73,          // i64: requesting client's world rank
  F_STARTED = 74,         // i64: 0 = fresh request at master, 1 = ring token
  F_CK_COUNTS = 76,       // list: units captured, one entry per ring hop
  // -- balancer sidecar (shared with codec.py: the sidecar is Python) --
  F_REQ_HOME = 46,        // i64
  F_DEST = 47,            // i64
  F_SEQNOS = 48,          // list
  F_TASKS_FLAT = 49,      // list: (seqno, type, prio, len)*
  F_REQS_FLAT = 50,       // list: (rank, rqseqno, ntypes, t0..tn)*
  F_CONSUMERS = 51,       // i64
  F_BOUNCED = 52,         // i64
  F_UNITS_BLOB = 53,      // bytes: packed migrate batch
  F_WQ_COUNT = 54,        // i64 (DS_LOG heartbeat)
  F_RQ_COUNT = 55,        // i64 (DS_LOG heartbeat)
  F_QM_TABLE = 56,        // list: (rank, nbytes, qlen, prio[T])* ring token
  F_PUT_ID = 58,          // i64: pipelined-put id echoed in TA_PUT_RESP
  F_FETCH = 59,           // i64: fused reserve+get request (get_work)
  F_HUNGRY = 60,          // i64: balancer -> servers, parked reqs exist
  F_GREW = 61,            // i64: the hungry wanted-set grew
  F_PSTATS_BLOB = 57,     // bytes: packed periodic-stats ring token entries
  // migration-batch ack: planner batch id on SS_PLAN_MIGRATE /
  // SS_MIGRATE_WORK; highest id received PER SOURCE reported in
  // snapshots (flattened (src, id) pairs) so the planner's in-flight
  // credits clear exactly when the batch lands
  F_MIG_ID = 77,          // i64
  F_MIG_ACKS = 78,        // list
  // batched fused fetch (get_work_batch): request cap + the batch
  // response's parallel per-unit fields (codec.py ids 79-84)
  F_FETCH_MAX = 79,       // i64
  F_PAYLOADS = 80,        // blist
  F_WORK_TYPES = 81,      // list
  F_PRIOS = 82,           // list
  F_ANSWER_RANKS = 83,    // list
  F_TIMES_ON_Q = 84,      // flist
  // batched SS_STATE_DELTA (round 4): parallel per-unit lists so a
  // streaming producer's inventory reaches the balancer within one
  // rate-limit gap instead of one unit per gap (codec.py id 85;
  // F_SEQNOS/F_WORK_TYPES/F_PRIOS are shared with other messages)
  F_WORK_LENS = 85,       // list
};

enum Kind : uint8_t {
  KIND_I64 = 0, KIND_BYTES = 1, KIND_LIST = 2, KIND_F64 = 3,
  KIND_BLIST = 4,  // list of byte strings: u16 count, (u32 len + bytes)*
  KIND_FLIST = 5,  // list of f64: u16 count, f64*
};

struct FieldVal {
  uint8_t kind = KIND_I64;
  int64_t i = 0;
  double d = 0.0;
  std::string b;
  std::vector<int64_t> l;
  std::vector<std::string> bl;
  std::vector<double> fl;
};

struct NMsg {
  uint16_t tag = 0;
  int32_t src = -1;
  std::map<uint8_t, FieldVal> f;

  bool has(uint8_t id) const { return f.count(id) != 0; }
  int64_t geti(uint8_t id, int64_t dflt = 0) const {
    auto it = f.find(id);
    return it == f.end() ? dflt : it->second.i;
  }
  double getd(uint8_t id, double dflt = 0.0) const {
    auto it = f.find(id);
    return it == f.end() ? dflt : it->second.d;
  }
  const std::string* getb(uint8_t id) const {
    auto it = f.find(id);
    return it == f.end() ? nullptr : &it->second.b;
  }
  const std::vector<int64_t>* getl(uint8_t id) const {
    auto it = f.find(id);
    return it == f.end() ? nullptr : &it->second.l;
  }
  NMsg& seti(uint8_t id, int64_t v) {
    FieldVal& fv = f[id];
    fv.kind = KIND_I64;
    fv.i = v;
    return *this;
  }
  NMsg& setd(uint8_t id, double v) {
    FieldVal& fv = f[id];
    fv.kind = KIND_F64;
    fv.d = v;
    return *this;
  }
  NMsg& setb(uint8_t id, std::string v) {
    FieldVal& fv = f[id];
    fv.kind = KIND_BYTES;
    fv.b = std::move(v);
    return *this;
  }
  NMsg& setl(uint8_t id, std::vector<int64_t> v) {
    FieldVal& fv = f[id];
    fv.kind = KIND_LIST;
    fv.l = std::move(v);
    return *this;
  }
  NMsg& setbl(uint8_t id, std::vector<std::string> v) {
    FieldVal& fv = f[id];
    fv.kind = KIND_BLIST;
    fv.bl = std::move(v);
    return *this;
  }
  NMsg& setfl(uint8_t id, std::vector<double> v) {
    FieldVal& fv = f[id];
    fv.kind = KIND_FLIST;
    fv.fl = std::move(v);
    return *this;
  }
};

[[noreturn]] void die(const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  std::fprintf(stderr, "[adlb_serverd] fatal: ");
  std::vfprintf(stderr, fmt, ap);
  std::fprintf(stderr, "\n");
  va_end(ap);
  std::exit(1);
}

double monotonic() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return double(ts.tv_sec) + double(ts.tv_nsec) * 1e-9;
}

// ---- TLV codec (codec.py encode_binary/decode_binary) ---------------------

void put_u16(std::string& out, uint16_t v) { out.append((const char*)&v, 2); }
void put_u32(std::string& out, uint32_t v) { out.append((const char*)&v, 4); }
void put_i32(std::string& out, int32_t v) { out.append((const char*)&v, 4); }
void put_i64(std::string& out, int64_t v) { out.append((const char*)&v, 8); }
void put_f64(std::string& out, double v) { out.append((const char*)&v, 8); }

std::string encode(const NMsg& m) {
  std::string out;
  out.push_back(char(0x01));  // BINARY_MAGIC
  put_u16(out, m.tag);
  put_i32(out, m.src);
  put_u16(out, uint16_t(m.f.size()));
  for (const auto& kv : m.f) {
    out.push_back(char(kv.first));
    out.push_back(char(kv.second.kind));
    switch (kv.second.kind) {
      case KIND_I64: put_i64(out, kv.second.i); break;
      case KIND_F64: put_f64(out, kv.second.d); break;
      case KIND_BYTES:
        put_u32(out, uint32_t(kv.second.b.size()));
        out.append(kv.second.b);
        break;
      case KIND_LIST:
        // the codec's element count is a u16; silent wrap-around would
        // make the frame undecodable at the receiver — fail fast instead
        if (kv.second.l.size() > 65535)
          die("list field %u overflows the u16 codec bound (%zu elements)",
              kv.first, kv.second.l.size());
        put_u16(out, uint16_t(kv.second.l.size()));
        for (int64_t x : kv.second.l) put_i64(out, x);
        break;
      case KIND_BLIST:
        if (kv.second.bl.size() > 65535)
          die("blist field %u overflows the u16 codec bound", kv.first);
        put_u16(out, uint16_t(kv.second.bl.size()));
        for (const std::string& b : kv.second.bl) {
          put_u32(out, uint32_t(b.size()));
          out.append(b);
        }
        break;
      case KIND_FLIST:
        if (kv.second.fl.size() > 65535)
          die("flist field %u overflows the u16 codec bound", kv.first);
        put_u16(out, uint16_t(kv.second.fl.size()));
        for (double x : kv.second.fl) put_f64(out, x);
        break;
    }
  }
  return out;
}

// Malformed frames throw (the reader drops them and keeps serving, like
// the Python TcpEndpoint) rather than die(): one garbage connection must
// not take down a server that other ranks depend on.
struct FrameError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

NMsg decode(const std::string& body) {
  if (body.size() < 9 || body[0] != 0x01) throw FrameError("bad frame magic");
  NMsg m;
  size_t off = 1;
  std::memcpy(&m.tag, body.data() + off, 2); off += 2;
  std::memcpy(&m.src, body.data() + off, 4); off += 4;
  uint16_t nfields;
  std::memcpy(&nfields, body.data() + off, 2); off += 2;
  auto need = [&](size_t n) {
    if (off + n > body.size())
      throw FrameError("truncated frame (tag " + std::to_string(m.tag) + ")");
  };
  for (uint16_t i = 0; i < nfields; ++i) {
    need(2);
    uint8_t fid = uint8_t(body[off]);
    uint8_t kind = uint8_t(body[off + 1]);
    off += 2;
    FieldVal fv;
    fv.kind = kind;
    switch (kind) {
      case KIND_I64:
        need(8);
        std::memcpy(&fv.i, body.data() + off, 8); off += 8;
        break;
      case KIND_F64:
        need(8);
        std::memcpy(&fv.d, body.data() + off, 8); off += 8;
        break;
      case KIND_BYTES: {
        need(4);
        uint32_t n;
        std::memcpy(&n, body.data() + off, 4); off += 4;
        need(n);
        fv.b.assign(body.data() + off, n); off += n;
        break;
      }
      case KIND_LIST: {
        need(2);
        uint16_t cnt;
        std::memcpy(&cnt, body.data() + off, 2); off += 2;
        need(size_t(cnt) * 8);
        fv.l.resize(cnt);
        for (uint16_t j = 0; j < cnt; ++j) {
          std::memcpy(&fv.l[j], body.data() + off, 8); off += 8;
        }
        break;
      }
      case KIND_BLIST: {
        need(2);
        uint16_t cnt;
        std::memcpy(&cnt, body.data() + off, 2); off += 2;
        fv.bl.reserve(cnt);
        for (uint16_t j = 0; j < cnt; ++j) {
          need(4);
          uint32_t n;
          std::memcpy(&n, body.data() + off, 4); off += 4;
          need(n);
          fv.bl.emplace_back(body.data() + off, n); off += n;
        }
        break;
      }
      case KIND_FLIST: {
        need(2);
        uint16_t cnt;
        std::memcpy(&cnt, body.data() + off, 2); off += 2;
        need(size_t(cnt) * 8);
        fv.fl.resize(cnt);
        for (uint16_t j = 0; j < cnt; ++j) {
          std::memcpy(&fv.fl[j], body.data() + off, 8); off += 8;
        }
        break;
      }
      default:
        throw FrameError("bad field kind " + std::to_string(kind));
    }
    m.f.emplace(fid, std::move(fv));
  }
  // every legitimate encoder (codec.py, libadlb, this file) emits exact
  // frames; trailing bytes mean garbage that decoded by luck
  if (off != body.size())
    throw FrameError("trailing bytes after field " +
                     std::to_string(nfields));
  // tag outside the wire ranges (client block 1001-1049 plus the
  // heartbeat beacon 1054, server/debug block 1101-1132): a crafted or
  // version-skewed frame — it must not reach the dispatch switch, whose
  // unhandled-tag arm is fatal
  if (!((m.tag >= 1001 && m.tag <= 1049) || m.tag == T_FA_HEARTBEAT ||
        (m.tag >= 1101 && m.tag <= 1132)))
    throw FrameError("unknown wire tag " + std::to_string(m.tag));
  return m;
}

// ---- endpoint: acceptor + readers -> inbox, lazy outbound -----------------
// Same shape as the native client's transport (libadlb.cpp) and the Python
// TcpEndpoint: one listener, one reader thread per inbound connection,
// persistent outbound sockets, 4-byte LE length prefix per frame.

class Endpoint {
 public:
  Endpoint() = default;

  int listen_any() {
    lsock_ = socket(AF_INET, SOCK_STREAM, 0);
    if (lsock_ < 0) die("socket: %s", strerror(errno));
    int one = 1;
    setsockopt(lsock_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = 0;
    if (bind(lsock_, (sockaddr*)&addr, sizeof(addr)) < 0)
      die("bind: %s", strerror(errno));
    if (listen(lsock_, 64) < 0) die("listen: %s", strerror(errno));
    socklen_t len = sizeof(addr);
    getsockname(lsock_, (sockaddr*)&addr, &len);
    port_ = ntohs(addr.sin_port);
    acceptor_ = std::thread([this] { accept_loop(); });
    return port_;
  }

  void set_addr(int rank, std::string host, int port) {
    addr_map_[rank] = {std::move(host), port};
  }

  void send(int dest, const NMsg& m) {
    std::string body = encode(m);
    std::string frame;
    put_u32(frame, uint32_t(body.size()));
    frame += body;
    std::unique_lock<std::mutex> lk(out_mu_);
    int& sock = out_socks_[dest];
    if (sock == 0) sock = connect_to(dest);
    if (sock < 0) {
      // peer unreachable after the retry window (shutdown races): drop this
      // frame loudly, but leave the slot retryable so a recovered peer is
      // reconnected on the next send instead of being black-holed forever
      sock = 0;
      std::fprintf(stderr,
                   "[adlb_serverd] dropping frame tag %u to unreachable "
                   "rank %d\n", m.tag, dest);
      return;
    }
    const char* p = frame.data();
    size_t left = frame.size();
    while (left > 0) {
      ssize_t n = ::send(sock, p, left, MSG_NOSIGNAL);
      if (n <= 0) {
        close(sock);
        sock = connect_to(dest);  // one reconnect attempt
        if (sock < 0) return;
        p = frame.data();
        left = frame.size();
        continue;
      }
      p += n;
      left -= size_t(n);
    }
  }

  // blocking receive with timeout (seconds); false on timeout
  bool recv(NMsg* out, double timeout) {
    std::unique_lock<std::mutex> lk(in_mu_);
    if (inbox_.empty()) {
      in_cv_.wait_for(lk, std::chrono::duration<double>(timeout),
                      [this] { return !inbox_.empty(); });
    }
    if (inbox_.empty()) return false;
    *out = std::move(inbox_.front());
    inbox_.pop_front();
    return true;
  }

  bool recv_now(NMsg* out) {
    std::unique_lock<std::mutex> lk(in_mu_);
    if (inbox_.empty()) return false;
    *out = std::move(inbox_.front());
    inbox_.pop_front();
    return true;
  }

  // received-but-unhandled frames: the TCP analogue of the reference's
  // MPI unexpected-message-queue probe (src/adlb.c:3645-3719)
  size_t backlog() {
    std::unique_lock<std::mutex> lk(in_mu_);
    return inbox_.size();
  }

  void close_all() {
    closed_ = true;
    if (lsock_ >= 0) { shutdown(lsock_, SHUT_RDWR); close(lsock_); }
    std::unique_lock<std::mutex> lk(out_mu_);
    for (auto& kv : out_socks_)
      if (kv.second > 0) { shutdown(kv.second, SHUT_WR); close(kv.second); }
  }

 private:
  void accept_loop() {
    while (!closed_) {
      int conn = accept(lsock_, nullptr, nullptr);
      if (conn < 0) return;
      std::thread([this, conn] { reader(conn); }).detach();
    }
  }

  void reader(int conn) {
    // Robustness policy (mirrors libadlb.cpp's reader): garbage on a
    // connection that has never delivered a decodable frame closes that
    // connection and nothing else — a stray scanner must not kill a
    // server other ranks depend on. Corruption on an ESTABLISHED stream
    // is a protocol error between real ranks and fails fast: silently
    // dropping a request would leave its sender parked forever.
    // The length cap guards resize(): a hostile 4 GB prefix must not
    // become the allocation that kills the daemon.
    static constexpr uint32_t kMaxFrame = 1u << 28;  // 256 MB
    int32_t last_src = -1;
    bool established = false;
    for (;;) {
      uint32_t n;
      if (!read_exact(conn, (char*)&n, 4)) break;
      if (n > kMaxFrame) {
        if (established)
          die("frame length %u from rank %d exceeds %u cap", n, last_src,
              kMaxFrame);
        std::fprintf(stderr,
                     "[adlb_serverd] frame length %u exceeds %u cap; "
                     "closing connection\n", n, kMaxFrame);
        break;
      }
      std::string body;
      if (!read_body(conn, n, &body)) break;
      if (n == 0 || body[0] != 0x01) {
        if (established)
          // never legitimate: Python peers raise rather than pickle to a
          // declared-binary destination, so mid-stream non-TLV is
          // corruption (or a misconfigured peer), and dropping it could
          // park its sender forever
          die("non-binary frame (%u bytes) from rank %d", n, last_src);
        std::fprintf(stderr,
                     "[adlb_serverd] closing connection after non-binary "
                     "frame (%u B)\n", n);
        break;
      }
      NMsg m;
      try {
        m = decode(body);
      } catch (const FrameError& e) {
        if (!established) {
          std::fprintf(stderr,
                       "[adlb_serverd] closing connection after "
                       "undecodable first frame (%u B): %s — stray "
                       "connection, or a version-skewed peer (if a rank "
                       "now hangs, rebuild both sides from one tree)\n",
                       n, e.what());
          break;
        }
        die("undecodable frame (%u bytes) from rank %d: %s", n, last_src,
            e.what());
      }
      established = true;
      last_src = m.src;
      {
        std::lock_guard<std::mutex> lk(in_mu_);
        inbox_.push_back(std::move(m));
      }
      in_cv_.notify_one();
    }
    // EOF after the peer's frames: synthetic in-order signal so the
    // reactor can tell a finalized peer from a dead one (the reference's
    // failure model is rank-death-kills-job, src/adlb.c:2508-2526)
    if (last_src >= 0 && !closed_) {
      NMsg eof;
      eof.tag = T_PEER_EOF;
      eof.src = last_src;
      {
        std::lock_guard<std::mutex> lk(in_mu_);
        inbox_.push_back(std::move(eof));
      }
      in_cv_.notify_one();
    }
    close(conn);
  }

  static bool read_exact(int fd, char* buf, size_t n) {
    size_t got = 0;
    while (got < n) {
      ssize_t r = ::recv(fd, buf + got, n - got, 0);
      if (r <= 0) return false;
      got += size_t(r);
    }
    return true;
  }

  // Body reads grow with the bytes actually received instead of
  // pre-allocating the advertised length: a connection that sends only a
  // large length prefix (and then stalls) must not pin the whole frame's
  // memory while blocked in recv.
  static bool read_body(int fd, uint32_t n, std::string* body) {
    body->clear();
    char chunk[65536];
    while (body->size() < n) {
      size_t want = std::min(sizeof chunk, size_t(n) - body->size());
      ssize_t r = ::recv(fd, chunk, want, 0);
      if (r <= 0) return false;
      body->append(chunk, size_t(r));
    }
    return true;
  }

  int connect_to(int dest) {
    auto it = addr_map_.find(dest);
    if (it == addr_map_.end()) die("no address for rank %d", dest);
    double deadline = monotonic() + 15.0;
    for (;;) {
      int sock = socket(AF_INET, SOCK_STREAM, 0);
      sockaddr_in addr{};
      addr.sin_family = AF_INET;
      inet_pton(AF_INET, it->second.first.c_str(), &addr.sin_addr);
      addr.sin_port = htons(uint16_t(it->second.second));
      if (connect(sock, (sockaddr*)&addr, sizeof(addr)) == 0) {
        int one = 1;
        setsockopt(sock, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        return sock;
      }
      close(sock);
      if (monotonic() >= deadline || closed_) return -1;
      usleep(50000);
    }
  }

  int lsock_ = -1;
  int port_ = 0;
  bool closed_ = false;
  std::thread acceptor_;
  std::map<int, std::pair<std::string, int>> addr_map_;
  std::map<int, int> out_socks_;
  std::mutex out_mu_;
  std::deque<NMsg> inbox_;
  std::mutex in_mu_;
  std::condition_variable in_cv_;
};

// ---- world / config -------------------------------------------------------

struct World {
  int nranks = 0;
  int nservers = 0;
  bool use_debug_server = false;
  std::vector<int> types;

  int num_app_ranks() const {
    return nranks - nservers - (use_debug_server ? 1 : 0);
  }
  int master_server_rank() const { return num_app_ranks(); }
  bool is_server(int r) const {
    return r >= num_app_ranks() && r < num_app_ranks() + nservers;
  }
  bool is_app(int r) const { return r < num_app_ranks(); }
  int home_server(int app) const {
    return num_app_ranks() + (app % nservers);
  }
  int ring_next(int s) const {
    int i = s - num_app_ranks();
    return num_app_ranks() + (i + 1) % nservers;
  }
};

struct Cfg {
  double qmstat_interval = 0.05;
  bool qmstat_ring = false;  // reference-faithful ring token gossip
  double exhaust_check_interval = 0.25;
  double max_malloc = 0.0;
  // tpu mode: stream snapshots to a Python balancer sidecar and enact
  // its plan (SURVEY §7 language split: C++ data plane, Python planner)
  bool tpu_mode = false;
  double periodic_log_interval = 0.0;  // 0 = off (reference src/adlb.c:712)
  double debug_log_interval = 1.0;
  int balancer_rank = -1;
  double balancer_interval = 0.02;
  double balancer_min_gap = 0.002;
  int64_t balancer_max_tasks = 256;
  int64_t balancer_max_requesters = 64;
  // reload this rank's <prefix>.<rank>.ckpt shard at startup (same shard
  // bytes as the Python servers: runtime/checkpoint.py ACK1 format)
  std::string restore_path;
};

// ---- server state ---------------------------------------------------------

struct Meta {  // per-unit fields beyond the matching index
  std::string payload;
  int32_t answer_rank = -1;
  int32_t home_server = -1;
  int64_t common_len = 0, common_server = -1, common_seqno = -1;
  double time_stamp = 0.0;
};

struct RqEntry {
  int world_rank;
  int64_t rqseqno;
  bool any_type;
  std::vector<int32_t> req_types;  // sorted when !any_type
  double time_stamp;
  bool fetch = false;  // fused reserve+get (this framework's extension)

  bool wants(int32_t t) const {
    if (any_type) return true;
    for (int32_t x : req_types)
      if (x == t) return true;
    return false;
  }
};

struct PeerState {  // reference qmstat entry (src/adlb.c:151-159)
  int64_t nbytes = 0;
  int64_t qlen = 0;
  std::unordered_map<int32_t, int32_t> hi_prio;
};

struct CommonEntry {
  std::string buf;
  int64_t refcnt = -1;
  int64_t ngets = 0;
};

class Server {
 public:
  Server(World w, Cfg cfg, int rank, Endpoint* ep)
      : w_(w), cfg_(cfg), rank_(rank), ep_(ep) {
    master_ = (rank_ == w_.master_server_rank());
    for (int r = 0; r < w_.num_app_ranks(); ++r)
      if (w_.home_server(r) == rank_) local_apps_.insert(r);
    for (int s = w_.num_app_ranks(); s < w_.num_app_ranks() + w_.nservers; ++s)
      peers_[s];  // default entries
    stats_.assign(K_LAST, 0.0);
    if (!cfg_.restore_path.empty()) restore_from(cfg_.restore_path);
  }

  void run() {
    double now = monotonic();
    next_qmstat_ = now;
    next_exhaust_ = now + cfg_.exhaust_check_interval;
    next_pstats_ = now + cfg_.periodic_log_interval;
    while (!done_) {
      now = monotonic();
      periodic(now);
      double deadline = next_qmstat_;
      if (master_ && next_exhaust_ < deadline) deadline = next_exhaust_;
      if (!pend_seqnos_.empty()) {
        double d = last_event_snap_ + cfg_.balancer_min_gap;
        if (d < deadline) deadline = d;  // pending delta flush is due
      }
      NMsg m;
      bool got = ep_->recv(&m, std::max(deadline - monotonic(), 0.0));
      double t0 = monotonic();
      if (got) {
        dispatch(m);
        // bounded drain before paying the poll timeout again
        for (int i = 0; i < 128 && !done_; ++i) {
          if (monotonic() >= deadline) break;
          NMsg m2;
          if (!ep_->recv_now(&m2)) break;
          dispatch(m2);
        }
      }
      stats_[K_LOOP_TOP_TIME] += monotonic() - t0;
    }
  }

  void print_stats() {
    stats_[K_MALLOC_HWM] = double(mem_hwm_);
    stats_[K_AVG_TIME_ON_RQ] =
        rq_wait_n_ ? rq_wait_sum_ / double(rq_wait_n_) : 0.0;
    stats_[K_MAX_WQ_COUNT] = double(wq_.max_count);
    std::ostringstream os;
    os << "STATS {";
    char num[64];
    for (int k = 1; k < K_LAST; ++k) {
      if (k > 1) os << ", ";
      // full precision: default ostream formatting rounds to 6 significant
      // digits, corrupting large counters and MALLOC_HWM
      std::snprintf(num, sizeof(num), "%.17g", stats_[k]);
      os << "\"" << k << "\": " << num;
    }
    os << "}";
    std::printf("%s\n", os.str().c_str());
    std::fflush(stdout);
  }

  bool aborted() const { return aborted_; }
  int abort_code() const { return abort_code_; }

  void notify_balancer_end() {
    if (cfg_.tpu_mode && cfg_.balancer_rank >= 0)
      ep_->send(cfg_.balancer_rank, mk(T_DS_END));
    if (w_.use_debug_server)
      ep_->send(w_.nranks - 1, mk(T_DS_END));
  }

 private:
  // ---- memory accounting (reference src/adlb.c:3419-3474) -----------------
  bool mem_try_alloc(int64_t n) {
    if (cfg_.max_malloc > 0 && double(mem_curr_ + n) > cfg_.max_malloc)
      return false;
    mem_alloc(n);
    return true;
  }
  void mem_alloc(int64_t n) {
    mem_curr_ += n;
    if (mem_curr_ > mem_hwm_) mem_hwm_ = mem_curr_;
  }
  void mem_free(int64_t n) { mem_curr_ -= n; }
  bool mem_under_pressure() const {
    return cfg_.max_malloc > 0 && double(mem_curr_) > 0.95 * cfg_.max_malloc;
  }
  bool mem_has_room(int64_t n) const {
    return cfg_.max_malloc <= 0 ||
           double(mem_curr_ + n) <= 0.95 * cfg_.max_malloc;
  }

  // ---- small helpers ------------------------------------------------------
  const adlbwq::Unit* wq_find_match(int rank, const RqEntry& e) {
    const int32_t* tp = e.any_type ? nullptr : e.req_types.data();
    int32_t nt = e.any_type ? 0 : int32_t(e.req_types.size());
    const adlbwq::Unit* u = wq_.find_targeted(rank, tp, nt);
    if (u == nullptr) u = wq_.find_untargeted(tp, nt);
    return u;
  }

  int64_t wq_num_unpinned() const {
    int64_t n = 0;
    for (const auto& kv : wq_.units)
      if (kv.second.pin_rank < 0) n += 1;
    return n;
  }

  int64_t wq_num_unpinned_untargeted() const {
    int64_t n = 0;
    for (const auto& kv : wq_.units)
      if (kv.second.pin_rank < 0 && kv.second.target_rank < 0) n += 1;
    return n;
  }

  // remove a unit and its metadata from the queue, returning the Meta
  // (payload + bookkeeping); shared by Get_reserved and the fused path
  Meta consume_unit(int64_t seqno) {
    Meta meta = std::move(meta_[seqno]);
    meta_.erase(seqno);
    auto it = wq_.units.find(seqno);
    wq_.total_bytes -= it->second.payload_len;
    wq_.units.erase(it);
    wq_.count -= 1;
    mem_free(int64_t(meta.payload.size()));
    return meta;
  }

  RqEntry* rq_find_rank(int world_rank) {
    for (auto& e : rq_)
      if (e.world_rank == world_rank) return &e;
    return nullptr;
  }

  void rq_remove(int world_rank) {
    for (auto it = rq_.begin(); it != rq_.end(); ++it)
      if (it->world_rank == world_rank) { rq_.erase(it); return; }
  }

  // parked requester matching a freshly available (type, target) — the
  // reference's rq_find_rank_queued_for_type (src/adlb.c:988-1042)
  RqEntry* rq_find_for_type(int32_t work_type, int32_t target_rank) {
    if (target_rank >= 0) {
      RqEntry* e = rq_find_rank(target_rank);
      return (e != nullptr && e->wants(work_type)) ? e : nullptr;
    }
    for (auto& e : rq_)
      if (e.wants(work_type)) return &e;
    return nullptr;
  }

  NMsg mk(uint16_t tag) {
    NMsg m;
    m.tag = tag;
    m.src = rank_;
    return m;
  }

  void reserve_resp_fail(int app, int rc) {
    NMsg r = mk(T_TA_RESERVE_RESP);
    r.seti(F_RC, rc);
    ep_->send(app, r);
  }

  void reserve_resp_ok(int app, const adlbwq::Unit& u, const Meta& meta,
                       int holder, bool fetch = false) {
    resolved_ctr_ += 1;
    if (fetch && holder == rank_ && meta.common_len == 0) {
      // fused reserve+get (no reference analogue): local prefix-free unit,
      // consume now and inline the payload in the reservation response
      NMsg r = mk(T_TA_RESERVE_RESP);
      r.seti(F_RC, ADLB_SUCCESS);
      r.seti(F_WORK_TYPE, u.work_type);
      r.seti(F_PRIO, u.prio);
      r.seti(F_WORK_LEN, u.payload_len);
      r.seti(F_ANSWER_RANK, meta.answer_rank);
      Meta m2 = consume_unit(u.seqno);
      r.setd(F_TIME_ON_Q, monotonic() - m2.time_stamp);
      r.setb(F_PAYLOAD, std::move(m2.payload));
      ep_->send(app, r);
      return;
    }
    NMsg r = mk(T_TA_RESERVE_RESP);
    r.seti(F_RC, ADLB_SUCCESS);
    r.seti(F_WORK_TYPE, u.work_type);
    r.seti(F_PRIO, u.prio);
    r.setl(F_HANDLE, {u.seqno, holder, meta.common_len, meta.common_server,
                      meta.common_seqno});
    r.seti(F_WORK_LEN, u.payload_len + meta.common_len);
    r.seti(F_ANSWER_RANK, meta.answer_rank);
    ep_->send(app, r);
  }

  void reserve_resp_batch(int app, const std::vector<int64_t>& seqnos) {
    resolved_ctr_ += int64_t(seqnos.size());
    double now = monotonic();
    std::vector<std::string> payloads;
    std::vector<int64_t> wtypes, prios, answers;
    std::vector<double> times;
    payloads.reserve(seqnos.size());
    for (int64_t sq : seqnos) {
      const adlbwq::Unit& u = wq_.units.at(sq);
      wtypes.push_back(u.work_type);
      prios.push_back(u.prio);
      Meta m2 = consume_unit(sq);
      answers.push_back(m2.answer_rank);
      times.push_back(now - m2.time_stamp);
      payloads.push_back(std::move(m2.payload));
    }
    NMsg r = mk(T_TA_RESERVE_RESP);
    r.seti(F_RC, ADLB_SUCCESS);
    r.setbl(F_PAYLOADS, std::move(payloads));
    r.setl(F_WORK_TYPES, std::move(wtypes));
    r.setl(F_PRIOS, std::move(prios));
    r.setl(F_ANSWER_RANKS, std::move(answers));
    r.setfl(F_TIMES_ON_Q, std::move(times));
    ep_->send(app, r);
  }

  void satisfy_parked(const RqEntry& e, const adlbwq::Unit& u,
                      const Meta& meta) {
    int app = e.world_rank;
    bool fetch = e.fetch;
    double wait = monotonic() - e.time_stamp;
    rq_remove(app);
    rfr_excluded_.erase(app);
    rq_wait_sum_ += wait;
    rq_wait_n_ += 1;
    activity_ += 1;
    reserve_resp_ok(app, u, meta, rank_, fetch);
  }

  void match_rq() {
    // local analogue of check_remote_work_for_queued_apps
    // (reference src/adlb.c:3536-3579)
    bool progressed = true;
    while (progressed) {
      progressed = false;
      for (auto& e : rq_) {
        const adlbwq::Unit* u = wq_find_match(e.world_rank, e);
        if (u != nullptr) {
          int64_t seqno = u->seqno;
          wq_.units[seqno].pin_rank = e.world_rank;
          RqEntry copy = e;
          satisfy_parked(copy, wq_.units[seqno], meta_[seqno]);
          progressed = true;
          break;
        }
      }
    }
  }

  int least_loaded_peer(int64_t nbytes_needed) {
    int best = -1, fallback = -1;
    int64_t best_bytes = 0, fallback_bytes = 0;
    for (const auto& kv : peers_) {
      if (kv.first == rank_) continue;
      if (fallback < 0 || kv.second.nbytes < fallback_bytes) {
        fallback = kv.first;
        fallback_bytes = kv.second.nbytes;
      }
      if (cfg_.max_malloc > 0 &&
          double(kv.second.nbytes + nbytes_needed) > cfg_.max_malloc)
        continue;
      if (best < 0 || kv.second.nbytes < best_bytes) {
        best = kv.first;
        best_bytes = kv.second.nbytes;
      }
    }
    return best >= 0 ? best : fallback;
  }

  // ---- dispatch -----------------------------------------------------------
  void dispatch(const NMsg& m) {
    events_ctr_ += 1;
    if (m.tag >= 1101 && m.tag <= 1125) ss_msgs_ctr_ += 1;
    switch (m.tag) {
      case T_FA_HEARTBEAT: break;  // liveness beacon: parse-and-ignore
      case T_FA_PUT: on_put(m); break;
      case T_FA_PUT_COMMON: on_put_common(m); break;
      case T_FA_BATCH_DONE: on_batch_done(m); break;
      case T_FA_DID_PUT_AT_REMOTE: on_did_put_at_remote(m); break;
      case T_FA_RESERVE: on_reserve(m); break;
      case T_FA_GET_RESERVED: on_get_reserved(m); break;
      case T_FA_GET_COMMON: on_get_common(m); break;
      case T_FA_NO_MORE_WORK: on_fa_no_more_work(m); break;
      case T_FA_LOCAL_APP_DONE: on_local_app_done(m); break;
      case T_FA_ABORT: do_abort(int(m.geti(F_CODE, -1)), true); break;
      case T_FA_INFO_NUM_WORK_UNITS: on_info_num(m); break;
      case T_FA_INFO_GET: on_info_get(m); break;
      case T_FA_CHECKPOINT: on_fa_checkpoint(m); break;
      case T_SS_CHECKPOINT: on_ss_checkpoint(m); break;
      case T_SS_QMSTAT: on_qmstat(m); break;
      case T_SS_RFR: on_rfr(m); break;
      case T_SS_RFR_RESP: on_rfr_resp(m); break;
      case T_SS_UNRESERVE: on_unreserve(m); break;
      case T_SS_PUSH_QUERY: on_push_query(m); break;
      case T_SS_PUSH_QUERY_RESP: on_push_query_resp(m); break;
      case T_SS_PUSH_WORK: on_push_work(m); break;
      case T_SS_PUSH_DEL: on_push_del(m); break;
      case T_SS_MOVING_TARGETED_WORK: on_moving_targeted(m); break;
      case T_SS_NO_MORE_WORK: on_ss_no_more_work(); break;
      case T_SS_EXHAUST_CHK_1: on_exhaust_chk(m, true); break;
      case T_SS_EXHAUST_CHK_2: on_exhaust_chk(m, false); break;
      case T_SS_DONE_BY_EXHAUSTION: on_done_by_exhaustion(); break;
      case T_SS_END_1: on_end_1(m); break;
      case T_SS_END_2: on_end_2(m); break;
      case T_SS_ABORT: do_abort(int(m.geti(F_CODE, -1)), false); break;
      // a client-directed abort frame reaching a server means the world
      // is already in an abort storm (misdirected fan-out / rank reuse);
      // treat it as the abort it is rather than dying on "no handler"
      // and cascading connection-loss aborts through every peer
      case T_TA_ABORT: do_abort(int(m.geti(F_CODE, -1)), false); break;
      case T_PEER_EOF: on_peer_eof(m); break;
      case T_SS_PERIODIC_STATS: on_periodic_stats(m); break;
      case T_SS_HUNGRY: {
        hungry_ = m.geti(F_HUNGRY, 0) != 0;
        const std::vector<int64_t>* ts = m.getl(F_REQ_TYPES);
        hungry_any_ = hungry_ && ts == nullptr;
        hungry_types_.clear();
        if (ts != nullptr)
          for (int64_t t : *ts) hungry_types_.insert(int32_t(t));
        // when the wanted-set grows our inventory of those types may be
        // heartbeat-stale at the sidecar: refresh so the solve sees it
        if (hungry_ && m.geti(F_GREW, 0) != 0) send_snapshot();
        break;
      }
      case T_SS_PLAN_MATCH: on_plan_match(m); break;
      case T_SS_PLAN_MIGRATE: on_plan_migrate(m); break;
      case T_SS_MIGRATE_WORK: on_migrate_work(m); break;
      case T_SS_MIGRATE_ACK:
        migrate_unacked_ -= 1;
        if (migrate_unacked_ == 0 && !held_ckpts_.empty()) {
          std::vector<NMsg> held;
          held.swap(held_ckpts_);
          for (const NMsg& h : held) process_checkpoint(h);
        }
        break;
      default: die("no handler for tag %u", m.tag);
    }
  }

  void periodic(double now) {
    if (!pend_seqnos_.empty() &&
        now - last_event_snap_ >= cfg_.balancer_min_gap)
      flush_event_deltas(now);
    if (now >= next_qmstat_) {
      next_qmstat_ = cfg_.tpu_mode ? now + cfg_.balancer_interval
                                   : now + cfg_.qmstat_interval;
      if (cfg_.tpu_mode) {
        // O(wq) walk: fast cadence only while someone is parked AND this
        // server could contribute (inventory for the solve, or its own
        // parked requesters whose fresh stamps keep them re-plannable),
        // or under memory pressure; slow heartbeat otherwise (parks send
        // event snapshots themselves)
        bool relevant = hungry_ && (!rq_.empty() || wq_has_untargeted());
        if (relevant || mem_under_pressure() || now >= next_idle_snap_) {
          next_idle_snap_ = now + 0.25;
          send_snapshot();
        }
      } else {
        broadcast_qmstat();
      }
      if (mem_under_pressure()) try_push();
    }
    if (master_ && now >= next_exhaust_) {
      next_exhaust_ = now + cfg_.exhaust_check_interval;
      check_exhaustion(now);
    }
    if (master_ && cfg_.periodic_log_interval > 0 && now >= next_pstats_) {
      next_pstats_ = now + cfg_.periodic_log_interval;
      kick_periodic_stats(now);
    }
    if (w_.use_debug_server && now >= next_ds_log_) {
      next_ds_log_ = now + cfg_.debug_log_interval;
      // the reference's 11-counter heartbeat (src/adlb.c:3222-3259); the
      // iq / unexpected-queue fields map to the inbox backlog
      int64_t wq_targeted = 0;
      for (const auto& kv : wq_.units)
        if (kv.second.target_rank >= 0) wq_targeted += 1;
      int64_t reserves = int64_t(stats_[K_NUM_RESERVES]);
      int64_t parked = int64_t(stats_[K_NUM_RESERVES_PUT_ON_RQ]);
      NMsg m = mk(T_DS_LOG);
      m.seti(F_EVENTS, events_ctr_ - ds_last_.events);
      m.seti(F_WQ_TARGETED, wq_targeted);
      m.seti(F_WQ_COUNT, wq_.count);
      m.seti(F_RQ_COUNT, int64_t(rq_.size()));
      m.seti(F_BACKLOG, int64_t(ep_->backlog()));
      m.seti(F_RESERVES, reserves - ds_last_.reserves);
      m.seti(F_RESERVES_IMMED, reserve_immed_ctr_ - ds_last_.immed);
      m.seti(F_RESERVES_PARKED, parked - ds_last_.parked);
      m.seti(F_RFR_FAILED, rfr_failed_ctr_ - ds_last_.rfr_failed);
      m.seti(F_SS_MSGS, ss_msgs_ctr_ - ds_last_.ss);
      m.seti(F_RSS_KB, rss_kb());
      m.seti(F_NBYTES, mem_curr_);
      ep_->send(w_.nranks - 1, m);  // debug server is the last world rank
      ds_last_.events = events_ctr_;
      ds_last_.ss = ss_msgs_ctr_;
      ds_last_.reserves = reserves;
      ds_last_.immed = reserve_immed_ctr_;
      ds_last_.parked = parked;
      ds_last_.rfr_failed = rfr_failed_ctr_;
    }
  }

  static int64_t rss_kb() {
    // the reference's /proc/self/status probe (src/adlb.c:3347-3369)
    FILE* f = fopen("/proc/self/status", "r");
    if (f == nullptr) return 0;
    char line[256];
    int64_t kb = 0;
    while (fgets(line, sizeof line, f) != nullptr)
      if (sscanf(line, "VmRSS: %lld", (long long*)&kb) == 1) break;
    fclose(f);
    return kb;
  }

  // ---- app handlers (reference src/adlb.c:889-1383) -----------------------
  void on_put(const NMsg& m) {
    puts_ctr_ += 1;
    bool has_pid = m.has(F_PUT_ID);
    int64_t pid = m.geti(F_PUT_ID);
    auto echo_pid = [&](NMsg& r) {
      if (has_pid) r.seti(F_PUT_ID, pid);
    };
    if (no_more_work_ || done_by_exhaustion_) {
      NMsg r = mk(T_TA_PUT_RESP);
      r.seti(F_RC, ADLB_NO_MORE_WORK);
      echo_pid(r);
      ep_->send(m.src, r);
      return;
    }
    const std::string* payload = m.getb(F_PAYLOAD);
    static const std::string kEmpty;
    if (payload == nullptr) payload = &kEmpty;
    if (!mem_try_alloc(int64_t(payload->size()))) {
      stats_[K_NREJECTED_PUTS] += 1;
      NMsg r = mk(T_TA_PUT_RESP);
      r.seti(F_RC, ADLB_PUT_REJECTED);
      r.seti(F_HINT, least_loaded_peer(int64_t(payload->size())));
      echo_pid(r);
      ep_->send(m.src, r);
      return;
    }
    int64_t seqno = next_seqno_++;
    adlbwq::Unit u{seqno, int32_t(m.geti(F_WORK_TYPE)),
                   int32_t(m.geti(F_PRIO)), int32_t(m.geti(F_TARGET_RANK, -1)),
                   -1, int64_t(payload->size())};
    wq_.units.emplace(seqno, u);
    wq_.count += 1;
    if (wq_.count > wq_.max_count) wq_.max_count = wq_.count;
    wq_.total_bytes += u.payload_len;
    wq_.index(u);
    Meta& meta = meta_[seqno];
    meta.payload = *payload;
    meta.answer_rank = int32_t(m.geti(F_ANSWER_RANK, -1));
    meta.home_server = rank_;
    meta.common_len = m.geti(F_COMMON_LEN, 0);
    meta.common_server = m.geti(F_COMMON_SERVER, -1);
    meta.common_seqno = m.geti(F_COMMON_SEQNO, -1);
    meta.time_stamp = monotonic();
    activity_ += 1;
    exhaust_held_ = false;
    RqEntry* e = rq_find_for_type(u.work_type, u.target_rank);
    if (e != nullptr) {
      wq_.units[seqno].pin_rank = e->world_rank;
      RqEntry copy = *e;
      satisfy_parked(copy, wq_.units[seqno], meta);
    }
    NMsg r = mk(T_TA_PUT_RESP);
    r.seti(F_RC, ADLB_SUCCESS);
    echo_pid(r);
    ep_->send(m.src, r);
    // event path for an untargeted put of a type some parked requester
    // wants (SS_HUNGRY): an O(1) DELTA carrying just this unit, not the
    // O(wq) snapshot walk; targeted puts match at the target's home
    // server and never enter snapshots, and the periodic heartbeat
    // covers everything else
    if (e == nullptr && u.target_rank < 0 && hungry_ &&
        (hungry_any_ || hungry_types_.count(u.work_type)))
      maybe_event_delta(seqno, u.work_type, u.prio, int64_t(u.payload_len));
  }

  void on_put_common(const NMsg& m) {
    const std::string* payload = m.getb(F_PAYLOAD);
    static const std::string kEmpty;
    if (payload == nullptr) payload = &kEmpty;
    NMsg r = mk(T_TA_PUT_COMMON_RESP);
    if (!mem_try_alloc(int64_t(payload->size()))) {
      r.seti(F_RC, ADLB_PUT_REJECTED);
      r.seti(F_COMMON_SEQNO, -1);
    } else {
      int64_t seqno = next_common_seqno_++;
      cq_[seqno].buf = *payload;
      r.seti(F_RC, ADLB_SUCCESS);
      r.seti(F_COMMON_SEQNO, seqno);
    }
    ep_->send(m.src, r);
  }

  void cq_maybe_gc(int64_t seqno) {
    auto it = cq_.find(seqno);
    if (it == cq_.end()) return;
    if (it->second.refcnt >= 0 && it->second.ngets >= it->second.refcnt) {
      mem_free(int64_t(it->second.buf.size()));
      cq_.erase(it);
    }
  }

  void on_batch_done(const NMsg& m) {
    int64_t seqno = m.geti(F_COMMON_SEQNO);
    auto it = cq_.find(seqno);
    if (it == cq_.end()) return;
    it->second.refcnt = m.geti(F_REFCNT);
    cq_maybe_gc(seqno);
  }

  // ---- checkpoint / resume (runtime/checkpoint.py ACK1 shard format) ------
  // No reference analogue (SURVEY §5: pool serialization absent upstream).
  // Same ring protocol and shard bytes as the Python servers, so a shard
  // written by either plane restores into the other.

  int64_t write_ckpt_shard(const std::string& prefix) {
    std::string body;
    int64_t n = 0;
    auto u32 = [](std::string& out, uint32_t v) {
      out.append((const char*)&v, 4);
    };
    auto i32 = [](std::string& out, int32_t v) {
      out.append((const char*)&v, 4);
    };
    auto i64 = [](std::string& out, int64_t v) {
      out.append((const char*)&v, 8);
    };
    // serialize in seqno order: restore assigns fresh seqnos in shard order,
    // so hash-map order would scramble FIFO-among-equal-priority dispatch
    // (the "FIFO by seqno among equals" contract in wqcore.hpp) that the
    // Python plane's insertion-ordered dict preserves
    std::vector<int64_t> seqnos;
    seqnos.reserve(wq_.units.size());
    for (const auto& kv : wq_.units) seqnos.push_back(kv.first);
    std::sort(seqnos.begin(), seqnos.end());
    for (int64_t sq : seqnos) {
      const adlbwq::Unit& u = wq_.units.at(sq);
      const Meta& meta = meta_.at(u.seqno);
      i32(body, u.work_type);
      i32(body, u.target_rank);
      i32(body, meta.answer_rank);
      i64(body, int64_t(u.prio));
      i64(body, meta.common_server);
      i64(body, meta.common_seqno);
      u32(body, uint32_t(meta.common_len));
      u32(body, uint32_t(meta.payload.size()));
      body.append(meta.payload);
      n += 1;
    }
    // ACK2 header: format version + world shape (nranks/nservers) so a
    // restore into a different shape fails loudly instead of silently
    // misrouting targeted units (ACK1 stays read-compatible below)
    std::string out("ACK2");
    u32(out, 2u);
    u32(out, uint32_t(w_.nranks));
    u32(out, uint32_t(w_.nservers));
    u32(out, uint32_t(n));
    out += body;
    u32(out, uint32_t(cq_.size()));
    for (const auto& kv : cq_) {
      i64(out, kv.first);
      i64(out, kv.second.refcnt);
      i64(out, kv.second.ngets);
      u32(out, uint32_t(kv.second.buf.size()));
      out += kv.second.buf;
    }
    std::string path = prefix + "." + std::to_string(rank_) + ".ckpt";
    std::string tmp = path + "." + std::to_string(getpid()) + ".tmp";
    FILE* f = std::fopen(tmp.c_str(), "wb");
    if (f == nullptr) die("checkpoint: cannot open %s", tmp.c_str());
    if (std::fwrite(out.data(), 1, out.size(), f) != out.size())
      die("checkpoint: short write to %s", tmp.c_str());
    std::fclose(f);
    if (std::rename(tmp.c_str(), path.c_str()) != 0)
      die("checkpoint: rename to %s failed", path.c_str());
    return n;
  }

  void restore_from(const std::string& prefix) {
    // stray-shard guard (mirrors runtime/server.py): shards for server
    // ranks outside this world mean the checkpoint came from a different
    // world shape — silently loading only our own shard would lose every
    // unit the extra shards hold
    // plain directory scan + prefix/suffix comparison rather than glob():
    // a restore_path containing glob metacharacters (*, ?, [) would make
    // the pattern match nothing (silently skipping this check) or match
    // unrelated files — the Python plane avoids the same trap with
    // re.escape in existing_shard_ranks
    std::string dir = ".", base = prefix;
    size_t slash = prefix.find_last_of('/');
    if (slash != std::string::npos) {
      // a root-anchored prefix ("/pool") must scan "/", not ""
      dir = slash == 0 ? "/" : prefix.substr(0, slash);
      base = prefix.substr(slash + 1);
    }
    if (DIR* d = opendir(dir.c_str())) {
      while (struct dirent* ent = readdir(d)) {
        std::string name = ent->d_name;
        if (name.size() <= base.size() + 6) continue;  // ".<r>.ckpt" min 7
        if (name.compare(0, base.size(), base) != 0 ||
            name[base.size()] != '.')
          continue;
        if (name.compare(name.size() - 5, 5, ".ckpt") != 0) continue;
        std::string mid = name.substr(base.size() + 1,
                                      name.size() - base.size() - 6);
        if (mid.empty() ||
            mid.find_first_not_of("0123456789") != std::string::npos)
          continue;
        long r = std::strtol(mid.c_str(), nullptr, 10);
        if (!w_.is_server(int(r)))
          die("checkpoint %s has a shard for rank %ld outside this world's "
              "servers; restore with the same world shape", prefix.c_str(),
              r);
      }
      closedir(d);
    }
    std::string path = prefix + "." + std::to_string(rank_) + ".ckpt";
    FILE* f = std::fopen(path.c_str(), "rb");
    if (f == nullptr)
      die("checkpoint shard missing: %s (was the checkpoint taken with the "
          "same world shape?)", path.c_str());
    std::string data;
    char buf[1 << 16];
    size_t got;
    while ((got = std::fread(buf, 1, sizeof buf, f)) > 0) data.append(buf, got);
    std::fclose(f);
    size_t off = 0;
    auto need = [&](size_t n) {
      if (off + n > data.size()) die("truncated shard %s", path.c_str());
    };
    auto rd_u32 = [&]() {
      need(4);
      uint32_t v;
      std::memcpy(&v, data.data() + off, 4);
      off += 4;
      return v;
    };
    auto rd_i32 = [&]() {
      need(4);
      int32_t v;
      std::memcpy(&v, data.data() + off, 4);
      off += 4;
      return v;
    };
    auto rd_i64 = [&]() {
      need(8);
      int64_t v;
      std::memcpy(&v, data.data() + off, 8);
      off += 8;
      return v;
    };
    need(4);
    bool v2 = data.compare(0, 4, "ACK2") == 0;
    if (!v2 && data.compare(0, 4, "ACK1") != 0)
      die("bad shard magic in %s", path.c_str());
    off = 4;
    if (v2) {
      uint32_t ver = rd_u32(), nranks = rd_u32(), nservers = rd_u32();
      if (ver > 2)
        die("shard %s: format version %u is newer than this build (2)",
            path.c_str(), ver);
      if (nranks != 0 && (int(nranks) != w_.nranks ||
                          int(nservers) != w_.nservers))
        die("shard %s: checkpoint world shape nranks=%u/nservers=%u does "
            "not match this world (%d/%d); restore with the same shape",
            path.c_str(), nranks, nservers, w_.nranks, w_.nservers);
    }
    uint32_t n = rd_u32();
    for (uint32_t i = 0; i < n; ++i) {
      int32_t wt = rd_i32(), tgt = rd_i32(), ans = rd_i32();
      int64_t prio = rd_i64(), cserver = rd_i64(), cseqno = rd_i64();
      uint32_t clen = rd_u32(), plen = rd_u32();
      need(plen);
      // the shard stores 64-bit priorities (the Python plane accepts
      // arbitrary ints); silently truncating would invert the dispatch
      // order of exactly the units marked most/least urgent
      if (prio > INT32_MAX || prio < INT32_MIN)
        die("shard %s: unit priority %lld does not fit this plane's "
            "int32 priorities; restore under Python servers",
            path.c_str(), (long long)prio);
      int64_t seqno = next_seqno_++;
      adlbwq::Unit u{seqno, wt, int32_t(prio), tgt, -1, int64_t(plen)};
      wq_.units.emplace(seqno, u);
      wq_.count += 1;
      if (wq_.count > wq_.max_count) wq_.max_count = wq_.count;
      wq_.total_bytes += u.payload_len;
      wq_.index(u);
      Meta& meta = meta_[seqno];
      meta.payload.assign(data.data() + off, plen);
      off += plen;
      meta.answer_rank = ans;
      meta.home_server = rank_;
      meta.common_len = clen;
      meta.common_server = cserver;
      meta.common_seqno = cseqno;
      meta.time_stamp = monotonic();
      mem_curr_ += plen;
      if (mem_curr_ > mem_hwm_) mem_hwm_ = mem_curr_;
    }
    uint32_t nc = rd_u32();
    for (uint32_t i = 0; i < nc; ++i) {
      int64_t seqno = rd_i64(), refcnt = rd_i64(), ngets = rd_i64();
      uint32_t blen = rd_u32();
      need(blen);
      CommonEntry& e = cq_[seqno];
      e.buf.assign(data.data() + off, blen);
      off += blen;
      e.refcnt = refcnt;
      e.ngets = ngets;
      mem_curr_ += blen;
      if (seqno >= next_common_seqno_) next_common_seqno_ = seqno + 1;
    }
    if (mem_curr_ > mem_hwm_) mem_hwm_ = mem_curr_;
    std::fprintf(stderr,
                 "[adlb_serverd %d] restored %u units, %u common entries "
                 "from %s\n", rank_, n, nc, path.c_str());
  }

  void on_fa_checkpoint(const NMsg& m) {
    const std::string* p = m.getb(F_PATH);
    if (p == nullptr) die("FA_CHECKPOINT without path");
    NMsg fwd = mk(T_SS_CHECKPOINT);
    fwd.setb(F_PATH, *p);
    fwd.seti(F_CLIENT, m.src);
    fwd.seti(F_STARTED, 0);
    if (master_) on_ss_checkpoint(fwd);
    else ep_->send(w_.master_server_rank(), fwd);
  }

  void on_ss_checkpoint(const NMsg& m) {
    // units inside an unacked SS_MIGRATE_WORK live in no wq anywhere;
    // holding the token until the ack lands keeps them out of the
    // lost-update window (runtime/server.py does the same). A queue, not
    // a slot: concurrent checkpoints from different clients must all
    // complete (each client blocks on its own TA_CHECKPOINT_RESP)
    if (migrate_unacked_ != 0) {
      held_ckpts_.push_back(m);
      return;
    }
    process_checkpoint(m);
  }

  void process_checkpoint(const NMsg& m) {
    const std::string* p = m.getb(F_PATH);
    if (p == nullptr) die("SS_CHECKPOINT without path");
    std::vector<int64_t> counts;
    if (m.getl(F_CK_COUNTS) != nullptr) counts = *m.getl(F_CK_COUNTS);
    if (master_ && m.geti(F_STARTED, 0) != 0) {  // token came back around
      ack_checkpoint(m.geti(F_CLIENT), counts);
      return;
    }
    int64_t nn = write_ckpt_shard(*p);
    counts.push_back(nn);
    if (master_ && w_.nservers == 1) {
      ack_checkpoint(m.geti(F_CLIENT), counts);
      return;
    }
    NMsg fwd = mk(T_SS_CHECKPOINT);
    fwd.setb(F_PATH, *p);
    fwd.seti(F_CLIENT, m.geti(F_CLIENT));
    fwd.seti(F_STARTED, 1);
    fwd.setl(F_CK_COUNTS, std::move(counts));
    ep_->send(w_.ring_next(rank_), fwd);
  }

  void ack_checkpoint(int64_t client, const std::vector<int64_t>& counts) {
    int64_t total = 0;
    for (int64_t c : counts) total += c;
    NMsg r = mk(T_TA_CHECKPOINT_RESP);
    r.seti(F_RC, ADLB_SUCCESS);
    r.seti(F_COUNT, total);
    ep_->send(int(client), r);
  }

  void on_did_put_at_remote(const NMsg& m) {
    // reference src/adlb.c:2845-2852 + tq (src/xq.h:73-79)
    int app = int(m.geti(F_TARGET_RANK));
    int32_t wt = int32_t(m.geti(F_WORK_TYPE));
    int server = int(m.geti(F_SERVER_RANK));
    tq_[app][wt][server] += 1;
    RqEntry* e = rq_find_rank(app);
    if (e != nullptr && e->wants(wt)) try_rfr(*e);
  }

  void on_reserve(const NMsg& m) {
    stats_[K_NUM_RESERVES] += 1;
    int app = m.src;
    RqEntry e;
    e.world_rank = app;
    e.rqseqno = m.geti(F_RQSEQNO);
    const std::vector<int64_t>* types = m.getl(F_REQ_TYPES);
    e.any_type = (types == nullptr);
    if (types != nullptr)
      for (int64_t t : *types) e.req_types.push_back(int32_t(t));
    e.time_stamp = monotonic();
    e.fetch = m.geti(F_FETCH, 0) != 0;
    if (no_more_work_) { reserve_resp_fail(app, ADLB_NO_MORE_WORK); return; }
    if (done_by_exhaustion_) {
      reserve_resp_fail(app, ADLB_DONE_BY_EXHAUSTION);
      return;
    }
    const adlbwq::Unit* u = wq_find_match(app, e);
    if (u != nullptr) {
      int64_t seqno = u->seqno;
      wq_.units[seqno].pin_rank = app;
      activity_ += 1;
      reserve_immed_ctr_ += 1;
      // clamp: a batch is bounded by the u16 element counts of the
      // codec's list kinds — an unclamped client value could push
      // encode() into its overflow guard and abort the daemon
      int64_t fetch_max = m.geti(F_FETCH_MAX, 1);
      if (fetch_max > 4096) fetch_max = 4096;
      if (e.fetch && fetch_max > 1 && meta_[seqno].common_len == 0) {
        // batched fused fetch: pop up to fetch_max local prefix-free
        // matches into ONE response (mirrors the Python server's
        // _reserve_resp_batch) — only locally pre-positioned inventory
        // can batch, so the balancer's locality is what amortizes the
        // consumer's round trips
        std::vector<int64_t> seqnos{seqno};
        while (int64_t(seqnos.size()) < fetch_max) {
          const adlbwq::Unit* extra = wq_find_match(app, e);
          if (extra == nullptr || meta_[extra->seqno].common_len != 0) break;
          wq_.units[extra->seqno].pin_rank = app;
          seqnos.push_back(extra->seqno);
        }
        reserve_resp_batch(app, seqnos);
        return;
      }
      reserve_resp_ok(app, wq_.units[seqno], meta_[seqno], rank_, e.fetch);
      return;
    }
    if (m.geti(F_HANG, 0) == 0) {
      reserve_resp_fail(app, ADLB_NO_CURRENT_WORK);
      return;
    }
    stats_[K_NUM_RESERVES_PUT_ON_RQ] += 1;
    rq_remove(app);  // re-park replaces (one entry per rank)
    rq_.push_back(e);
    rfr_excluded_.erase(app);
    try_rfr(rq_.back());
    maybe_event_snapshot();
  }

  void on_get_reserved(const NMsg& m) {
    int64_t seqno = m.geti(F_SEQNO);
    auto it = wq_.units.find(seqno);
    if (it == wq_.units.end() || it->second.pin_rank != m.src)
      die("invalid GET_RESERVED seqno %lld from rank %d",
          (long long)seqno, m.src);  // reference aborts too (src/adlb.c:1349)
    Meta meta = consume_unit(seqno);
    NMsg r = mk(T_TA_GET_RESERVED_RESP);
    r.seti(F_RC, ADLB_SUCCESS);
    r.setb(F_PAYLOAD, std::move(meta.payload));
    r.setd(F_TIME_ON_Q, monotonic() - meta.time_stamp);
    ep_->send(m.src, r);
  }

  void on_get_common(const NMsg& m) {
    int64_t seqno = m.geti(F_COMMON_SEQNO);
    auto it = cq_.find(seqno);
    if (it == cq_.end())
      die("invalid GET_COMMON seqno %lld", (long long)seqno);
    NMsg r = mk(T_TA_GET_COMMON_RESP);
    r.seti(F_RC, ADLB_SUCCESS);
    r.setb(F_PAYLOAD, it->second.buf);
    ep_->send(m.src, r);
    it->second.ngets += 1;
    cq_maybe_gc(seqno);
  }

  void on_info_num(const NMsg& m) {
    int32_t wt = int32_t(m.geti(F_WORK_TYPE));
    int64_t n = 0, nbytes = 0;
    for (const auto& kv : wq_.units)
      if (kv.second.work_type == wt) {
        n += 1;
        nbytes += kv.second.payload_len;
      }
    NMsg r = mk(T_TA_INFO_NUM_RESP);
    r.seti(F_RC, ADLB_SUCCESS);
    r.seti(F_COUNT, n);
    r.seti(F_NBYTES, nbytes);
    r.seti(F_MAX_WQ, wq_.max_count);
    ep_->send(m.src, r);
  }

  void on_info_get(const NMsg& m) {
    int key = int(m.geti(F_KEY));
    NMsg r = mk(T_TA_INFO_GET_RESP);
    if (key == K_RSS_KB) {
      r.seti(F_RC, ADLB_SUCCESS);
      r.setd(F_VALUE, double(rss_kb()));
      ep_->send(m.src, r);
      return;
    }
    if (key == K_TRANSPORT_BACKLOG) {
      r.seti(F_RC, ADLB_SUCCESS);
      r.setd(F_VALUE, double(ep_->backlog()));
      ep_->send(m.src, r);
      return;
    }
    if (key < 1 || key >= K_LAST) {
      r.seti(F_RC, -1);
      r.setd(F_VALUE, 0.0);
    } else {
      double v;
      if (key == K_MALLOC_HWM) v = double(mem_hwm_);
      else if (key == K_AVG_TIME_ON_RQ)
        v = rq_wait_n_ ? rq_wait_sum_ / double(rq_wait_n_) : 0.0;
      else if (key == K_MAX_WQ_COUNT) v = double(wq_.max_count);
      else v = stats_[key];
      r.seti(F_RC, ADLB_SUCCESS);
      r.setd(F_VALUE, v);
    }
    ep_->send(m.src, r);
  }

  // ---- stealing: RFR (reference src/adlb.c:1802-2070,3487-3579) -----------
  void try_rfr(const RqEntry& e) {
    int app = e.world_rank;
    if (rfr_out_.count(app)) return;
    auto& excluded = rfr_excluded_[app];
    // 1) targeted-directory hit
    auto tit = tq_.find(app);
    if (tit != tq_.end()) {
      for (const auto& by_type : tit->second) {
        if (!e.wants(by_type.first)) continue;
        for (const auto& by_server : by_type.second) {
          if (by_server.second <= 0) continue;
          int server = by_server.first;
          if (server == rank_ || excluded.count(server)) continue;
          send_rfr(e, server, true, by_type.first);
          return;
        }
      }
    }
    if (cfg_.tpu_mode) return;  // untargeted stealing is the planner's job
    // 2) best advertised untargeted priority among peers
    int best_server = -1;
    int32_t best_prio = ADLB_LOWEST_PRIO;
    for (const auto& kv : peers_) {
      if (kv.first == rank_ || excluded.count(kv.first)) continue;
      if (e.any_type) {
        for (const auto& tp : kv.second.hi_prio)
          if (tp.second > best_prio) {
            best_server = kv.first;
            best_prio = tp.second;
          }
      } else {
        for (int32_t t : e.req_types) {
          auto hit = kv.second.hi_prio.find(t);
          if (hit != kv.second.hi_prio.end() && hit->second > best_prio) {
            best_server = kv.first;
            best_prio = hit->second;
          }
        }
      }
    }
    if (best_server >= 0) send_rfr(e, best_server, false, -1);
  }

  void send_rfr(const RqEntry& e, int server, bool targeted, int32_t ltype) {
    rfr_out_.insert(e.world_rank);
    NMsg m = mk(T_SS_RFR);
    m.seti(F_FOR_RANK, e.world_rank);
    m.seti(F_RQSEQNO, e.rqseqno);
    if (!e.any_type) {
      std::vector<int64_t> ts(e.req_types.begin(), e.req_types.end());
      m.setl(F_REQ_TYPES, ts);
    }
    m.seti(F_TARGETED_LOOKUP, targeted ? 1 : 0);
    m.seti(F_LOOKUP_TYPE, ltype);
    ep_->send(server, m);
  }

  void on_rfr(const NMsg& m) {
    RqEntry probe;
    probe.world_rank = int(m.geti(F_FOR_RANK));
    probe.rqseqno = m.geti(F_RQSEQNO);
    const std::vector<int64_t>* types = m.getl(F_REQ_TYPES);
    probe.any_type = (types == nullptr);
    if (types != nullptr)
      for (int64_t t : *types) probe.req_types.push_back(int32_t(t));
    const adlbwq::Unit* u = wq_find_match(probe.world_rank, probe);
    if (u != nullptr) {
      int64_t seqno = u->seqno;
      adlbwq::Unit& unit = wq_.units[seqno];
      unit.pin_rank = probe.world_rank;
      activity_ += 1;
      exhaust_held_ = false;
      const Meta& meta = meta_[seqno];
      NMsg r = mk(T_SS_RFR_RESP);
      r.seti(F_FOUND, 1);
      r.seti(F_FOR_RANK, probe.world_rank);
      r.seti(F_RQSEQNO, probe.rqseqno);
      r.seti(F_SEQNO, seqno);
      r.seti(F_WORK_TYPE, unit.work_type);
      r.seti(F_PRIO, unit.prio);
      r.seti(F_TARGET_RANK, unit.target_rank);
      r.seti(F_WORK_LEN, unit.payload_len + meta.common_len);
      r.seti(F_ANSWER_RANK, meta.answer_rank);
      r.seti(F_COMMON_LEN, meta.common_len);
      r.seti(F_COMMON_SERVER, meta.common_server);
      r.seti(F_COMMON_SEQNO, meta.common_seqno);
      ep_->send(m.src, r);
    } else {
      NMsg r = mk(T_SS_RFR_RESP);
      r.seti(F_FOUND, 0);
      r.seti(F_FOR_RANK, probe.world_rank);
      r.seti(F_RQSEQNO, probe.rqseqno);
      if (types != nullptr) r.setl(F_REQ_TYPES, *types);
      r.seti(F_TARGETED_LOOKUP, m.geti(F_TARGETED_LOOKUP));
      r.seti(F_LOOKUP_TYPE, m.geti(F_LOOKUP_TYPE));
      ep_->send(m.src, r);
    }
  }

  void tq_remove(int app, int32_t wt, int server) {
    auto ait = tq_.find(app);
    if (ait == tq_.end()) return;
    auto tit = ait->second.find(wt);
    if (tit == ait->second.end()) return;
    auto sit = tit->second.find(server);
    if (sit == tit->second.end()) return;
    if (--sit->second <= 0) tit->second.erase(sit);
    if (tit->second.empty()) ait->second.erase(tit);
    if (ait->second.empty()) tq_.erase(ait);
  }

  void on_rfr_resp(const NMsg& m) {
    int app = int(m.geti(F_FOR_RANK));
    rfr_out_.erase(app);
    if (!m.geti(F_FOUND)) rfr_failed_ctr_ += 1;
    if (m.geti(F_FOUND)) {
      RqEntry* e = rq_find_rank(app);
      int32_t wt = int32_t(m.geti(F_WORK_TYPE));
      if (e == nullptr || e->rqseqno != m.geti(F_RQSEQNO) || !e->wants(wt)) {
        // satisfied while the RFR flew — compensate (reference SS_UNRESERVE,
        // src/adlb.c:1949-1963)
        NMsg u = mk(T_SS_UNRESERVE);
        u.seti(F_SEQNO, m.geti(F_SEQNO));
        ep_->send(m.src, u);
        return;
      }
      int64_t target = m.geti(F_TARGET_RANK, -1);
      if (target >= 0 && app == int(target)) tq_remove(app, wt, m.src);
      double wait = monotonic() - e->time_stamp;
      rq_remove(app);
      rfr_excluded_.erase(app);
      rq_wait_sum_ += wait;
      rq_wait_n_ += 1;
      activity_ += 1;
      resolved_ctr_ += 1;
      NMsg r = mk(T_TA_RESERVE_RESP);
      r.seti(F_RC, ADLB_SUCCESS);
      r.seti(F_WORK_TYPE, wt);
      r.seti(F_PRIO, m.geti(F_PRIO));
      r.setl(F_HANDLE, {m.geti(F_SEQNO), m.src, m.geti(F_COMMON_LEN),
                        m.geti(F_COMMON_SERVER), m.geti(F_COMMON_SEQNO)});
      r.seti(F_WORK_LEN, m.geti(F_WORK_LEN));
      r.seti(F_ANSWER_RANK, m.geti(F_ANSWER_RANK, -1));
      ep_->send(app, r);
    } else {
      // stale belief: patch it (reference src/adlb.c:1979-2005)
      if (m.geti(F_TARGETED_LOOKUP)) {
        tq_remove(app, int32_t(m.geti(F_LOOKUP_TYPE)), m.src);
      } else {
        auto pit = peers_.find(m.src);
        if (pit != peers_.end()) {
          const std::vector<int64_t>* types = m.getl(F_REQ_TYPES);
          if (types != nullptr) {
            for (int64_t t : *types)
              pit->second.hi_prio[int32_t(t)] = ADLB_LOWEST_PRIO;
          } else {
            for (auto& tp : pit->second.hi_prio) tp.second = ADLB_LOWEST_PRIO;
          }
        }
      }
      rfr_excluded_[app].insert(m.src);
      RqEntry* e = rq_find_rank(app);
      if (e != nullptr) try_rfr(*e);
    }
  }

  void on_unreserve(const NMsg& m) {
    int64_t seqno = m.geti(F_SEQNO);
    auto it = wq_.units.find(seqno);
    if (it != wq_.units.end() && it->second.pin_rank >= 0) {
      it->second.pin_rank = -1;
      wq_.index(it->second);
      match_rq();
    }
  }

  // ---- push (memory pressure; reference src/adlb.c:509-556,2109-2362) -----
  const adlbwq::Unit* find_unpinned_for_push() {
    // prefer untargeted lowest priority; else any unpinned
    const adlbwq::Unit* worst = nullptr;
    for (const auto& kv : wq_.units) {
      const adlbwq::Unit& u = kv.second;
      if (u.pin_rank >= 0) continue;
      if (u.target_rank < 0 && (worst == nullptr || u.prio < worst->prio))
        worst = &u;
    }
    if (worst != nullptr) return worst;
    for (const auto& kv : wq_.units)
      if (kv.second.pin_rank < 0) return &kv.second;
    return nullptr;
  }

  void try_push() {
    if (!push_offered_.empty()) return;  // one outstanding push at a time
    const adlbwq::Unit* u = find_unpinned_for_push();
    if (u == nullptr) return;
    int target = -1;
    for (const auto& kv : peers_) {
      if (kv.first == rank_) continue;
      if (cfg_.max_malloc <= 0 ||
          double(kv.second.nbytes + u->payload_len) <= 0.9 * cfg_.max_malloc) {
        if (target < 0 || kv.second.nbytes < peers_[target].nbytes)
          target = kv.first;
      }
    }
    if (target < 0) return;
    int64_t qid = (int64_t(rank_) << 20) | (++push_seq_);
    push_offered_[qid] = u->seqno;
    NMsg m = mk(T_SS_PUSH_QUERY);
    m.seti(F_QUERY_ID, qid);
    m.seti(F_NBYTES, u->payload_len);
    ep_->send(target, m);
  }

  void on_push_query(const NMsg& m) {
    int64_t nbytes = m.geti(F_NBYTES);
    bool ok = mem_has_room(nbytes);
    if (ok) {
      mem_alloc(nbytes);  // reserved until WORK or DEL
      push_reserved_[m.geti(F_QUERY_ID)] = nbytes;
    }
    NMsg r = mk(T_SS_PUSH_QUERY_RESP);
    r.seti(F_QUERY_ID, m.geti(F_QUERY_ID));
    r.seti(F_ACCEPT, ok ? 1 : 0);
    ep_->send(m.src, r);
  }

  void on_push_query_resp(const NMsg& m) {
    int64_t qid = m.geti(F_QUERY_ID);
    auto oit = push_offered_.find(qid);
    if (oit == push_offered_.end()) return;
    int64_t seqno = oit->second;
    push_offered_.erase(oit);
    if (!m.geti(F_ACCEPT)) return;
    auto uit = wq_.units.find(seqno);
    if (uit == wq_.units.end() || uit->second.pin_rank >= 0) {
      // reserved while the query flew — cancel (reference SS_PUSH_DEL,
      // src/adlb.c:2182-2192)
      NMsg d = mk(T_SS_PUSH_DEL);
      d.seti(F_QUERY_ID, qid);
      ep_->send(m.src, d);
      return;
    }
    adlbwq::Unit unit = uit->second;
    Meta meta = std::move(meta_[seqno]);
    meta_.erase(seqno);
    wq_.total_bytes -= unit.payload_len;
    wq_.units.erase(uit);
    wq_.count -= 1;
    mem_free(int64_t(meta.payload.size()));
    stats_[K_NPUSHED_FROM_HERE] += 1;
    if (unit.target_rank >= 0) {
      int home = w_.home_server(unit.target_rank);
      NMsg mv = mk(T_SS_MOVING_TARGETED_WORK);
      mv.seti(F_APP_RANK, unit.target_rank);
      mv.seti(F_WORK_TYPE, unit.work_type);
      mv.seti(F_FROM_SERVER, rank_);
      mv.seti(F_TO_SERVER, m.src);
      ep_->send(home, mv);
    }
    NMsg wk = mk(T_SS_PUSH_WORK);
    wk.seti(F_QUERY_ID, qid);
    wk.setb(F_PAYLOAD, std::move(meta.payload));
    wk.seti(F_WORK_TYPE, unit.work_type);
    wk.seti(F_PRIO, unit.prio);
    wk.seti(F_TARGET_RANK, unit.target_rank);
    wk.seti(F_ANSWER_RANK, meta.answer_rank);
    wk.seti(F_HOME_SERVER, meta.home_server);
    wk.seti(F_COMMON_LEN, meta.common_len);
    wk.seti(F_COMMON_SERVER, meta.common_server);
    wk.seti(F_COMMON_SEQNO, meta.common_seqno);
    wk.setd(F_TIME_STAMP, meta.time_stamp);
    ep_->send(m.src, wk);
  }

  void on_push_work(const NMsg& m) {
    push_reserved_.erase(m.geti(F_QUERY_ID));  // budget now owned by the unit
    const std::string* payload = m.getb(F_PAYLOAD);
    static const std::string kEmpty;
    if (payload == nullptr) payload = &kEmpty;
    int64_t seqno = next_seqno_++;
    adlbwq::Unit u{seqno, int32_t(m.geti(F_WORK_TYPE)),
                   int32_t(m.geti(F_PRIO)), int32_t(m.geti(F_TARGET_RANK, -1)),
                   -1, int64_t(payload->size())};
    wq_.units.emplace(seqno, u);
    wq_.count += 1;
    if (wq_.count > wq_.max_count) wq_.max_count = wq_.count;
    wq_.total_bytes += u.payload_len;
    wq_.index(u);
    Meta& meta = meta_[seqno];
    meta.payload = *payload;
    meta.answer_rank = int32_t(m.geti(F_ANSWER_RANK, -1));
    meta.home_server = int32_t(m.geti(F_HOME_SERVER, -1));
    meta.common_len = m.geti(F_COMMON_LEN, 0);
    meta.common_server = m.geti(F_COMMON_SERVER, -1);
    meta.common_seqno = m.geti(F_COMMON_SEQNO, -1);
    meta.time_stamp = m.getd(F_TIME_STAMP, monotonic());
    stats_[K_NPUSHED_TO_HERE] += 1;
    match_rq();
  }

  void on_push_del(const NMsg& m) {
    auto it = push_reserved_.find(m.geti(F_QUERY_ID));
    if (it != push_reserved_.end()) {
      mem_free(it->second);
      push_reserved_.erase(it);
    }
  }

  void on_moving_targeted(const NMsg& m) {
    // home-server directory fixup (reference src/adlb.c:2071-2108)
    int app = int(m.geti(F_APP_RANK));
    int32_t wt = int32_t(m.geti(F_WORK_TYPE));
    int from = int(m.geti(F_FROM_SERVER));
    int to = int(m.geti(F_TO_SERVER));
    if (from != rank_) tq_remove(app, wt, from);
    if (to != rank_) tq_[app][wt][to] += 1;
    RqEntry* e = rq_find_rank(app);
    if (e != nullptr && e->wants(wt)) try_rfr(*e);
  }

  // ---- qmstat state broadcast (reference src/adlb.c:806-822) --------------
  std::vector<int64_t> refresh_self_entry() {
    PeerState& self = peers_[rank_];
    self.nbytes = mem_curr_;
    self.qlen = wq_num_unpinned_untargeted();
    std::vector<int64_t> prios;
    prios.reserve(w_.types.size());
    for (int32_t t : w_.types) {
      auto it = wq_.untargeted.find(t);
      const adlbwq::Unit* u =
          (it == wq_.untargeted.end()) ? nullptr : wq_.peek_best(&it->second, -1);
      int32_t p = (u == nullptr) ? ADLB_LOWEST_PRIO : u->prio;
      self.hi_prio[t] = p;
      prios.push_back(p);
    }
    return prios;
  }

  // flattened ring-token entry layout: (rank, nbytes, qlen, prio[T])*
  void token_set_entry(std::vector<int64_t>& tbl, int rank,
                       const PeerState& st,
                       const std::vector<int64_t>* prios) {
    size_t stride = 3 + w_.types.size();
    for (size_t i = 0; i + stride <= tbl.size(); i += stride) {
      if (tbl[i] == rank) {
        tbl[i + 1] = st.nbytes;
        tbl[i + 2] = st.qlen;
        for (size_t j = 0; j < w_.types.size(); ++j)
          tbl[i + 3 + j] = prios != nullptr
                               ? (*prios)[j]
                               : st.hi_prio.count(w_.types[j])
                                     ? st.hi_prio.at(w_.types[j])
                                     : ADLB_LOWEST_PRIO;
        return;
      }
    }
    tbl.push_back(rank);
    tbl.push_back(st.nbytes);
    tbl.push_back(st.qlen);
    for (size_t j = 0; j < w_.types.size(); ++j)
      tbl.push_back(prios != nullptr
                        ? (*prios)[j]
                        : st.hi_prio.count(w_.types[j])
                              ? st.hi_prio.at(w_.types[j])
                              : ADLB_LOWEST_PRIO);
  }

  void broadcast_qmstat() {
    std::vector<int64_t> prios = refresh_self_entry();
    PeerState& self = peers_[rank_];
    if (cfg_.qmstat_ring) {
      // reference-faithful store-and-forward ring token: master-kicked,
      // full table, per-hop staleness (reference src/adlb.c:806-822,
      // 1705-1757)
      if (master_ && w_.nservers > 1) {
        std::vector<int64_t> tbl;
        for (const auto& kv : peers_)
          token_set_entry(tbl, kv.first, kv.second,
                          kv.first == rank_ ? &prios : nullptr);
        NMsg m = mk(T_SS_QMSTAT);
        m.setl(F_QM_TABLE, tbl);
        m.seti(F_ORIGIN, rank_);
        m.setd(F_TIME_STAMP, monotonic());
        ep_->send(w_.ring_next(rank_), m);
      }
      return;
    }
    for (int s = w_.num_app_ranks(); s < w_.num_app_ranks() + w_.nservers;
         ++s) {
      if (s == rank_) continue;
      NMsg m = mk(T_SS_QMSTAT);
      m.seti(F_NBYTES, self.nbytes);
      m.seti(F_QLEN, self.qlen);
      m.setl(F_HI_PRIO, prios);
      ep_->send(s, m);
    }
  }

  void apply_peer_entry(int src, int64_t nbytes, int64_t qlen,
                        const int64_t* prios, size_t nprios) {
    PeerState& st = peers_[src];
    st.nbytes = nbytes;
    st.qlen = qlen;
    bool any_work = false;
    for (size_t i = 0; i < w_.types.size() && i < nprios; ++i) {
      st.hi_prio[w_.types[i]] = int32_t(prios[i]);
      if (prios[i] > ADLB_LOWEST_PRIO) any_work = true;
    }
    if (any_work)
      for (auto& kv : rfr_excluded_) kv.second.erase(src);
  }

  void on_qmstat(const NMsg& m) {
    const std::vector<int64_t>* tbl = m.getl(F_QM_TABLE);
    if (tbl != nullptr) {
      // ring token: install every entry except our own, then either record
      // the trip (back at origin, reference src/adlb.c:1731-1743) or
      // refresh our entry and forward
      size_t stride = 3 + w_.types.size();
      for (size_t i = 0; i + stride <= tbl->size(); i += stride) {
        int src = int((*tbl)[i]);
        if (src != rank_)
          apply_peer_entry(src, (*tbl)[i + 1], (*tbl)[i + 2],
                           tbl->data() + i + 3, w_.types.size());
      }
      if (int(m.geti(F_ORIGIN)) == rank_) {
        double trip = monotonic() - m.getd(F_TIME_STAMP);
        if (trip > stats_[K_MAX_QMSTAT_TRIP_TIME])
          stats_[K_MAX_QMSTAT_TRIP_TIME] = trip;
        qm_trips_ += 1;
        stats_[K_AVG_QMSTAT_TRIP_TIME] +=
            (trip - stats_[K_AVG_QMSTAT_TRIP_TIME]) / double(qm_trips_);
        if (trip > cfg_.qmstat_interval) stats_[K_NUM_QMS_EXCEED_INT] += 1;
      } else {
        std::vector<int64_t> out = *tbl;
        std::vector<int64_t> prios = refresh_self_entry();
        token_set_entry(out, rank_, peers_[rank_], &prios);
        NMsg fwd = mk(T_SS_QMSTAT);
        fwd.setl(F_QM_TABLE, out);
        fwd.seti(F_ORIGIN, m.geti(F_ORIGIN));
        fwd.setd(F_TIME_STAMP, m.getd(F_TIME_STAMP));
        ep_->send(w_.ring_next(rank_), fwd);
      }
    } else {
      apply_peer_entry(m.src, m.geti(F_NBYTES), m.geti(F_QLEN),
                       m.getl(F_HI_PRIO) ? m.getl(F_HI_PRIO)->data() : nullptr,
                       m.getl(F_HI_PRIO) ? m.getl(F_HI_PRIO)->size() : 0);
    }
    for (auto& e : rq_)
      if (!rfr_out_.count(e.world_rank)) try_rfr(e);
  }

  // ---- termination (reference src/adlb.c:754-785,1385-1801) ---------------
  void flush_rq(int rc) {
    std::vector<RqEntry> entries = rq_;
    rq_.clear();
    for (const auto& e : entries) reserve_resp_fail(e.world_rank, rc);
  }

  void on_fa_no_more_work(const NMsg& m) {
    if (no_more_work_) return;
    if (master_) {
      on_ss_no_more_work();
    } else {
      ep_->send(w_.master_server_rank(), mk(T_SS_NO_MORE_WORK));
    }
  }

  void on_ss_no_more_work() {
    if (no_more_work_) return;
    no_more_work_ = true;
    if (master_) {
      for (int s = w_.num_app_ranks(); s < w_.num_app_ranks() + w_.nservers;
           ++s)
        if (s != rank_) ep_->send(s, mk(T_SS_NO_MORE_WORK));
    }
    flush_rq(ADLB_NO_MORE_WORK);
  }

  bool all_local_apps_parked() {
    for (int app : local_apps_) {
      if (finalized_.count(app)) continue;
      if (rq_find_rank(app) == nullptr) return false;
    }
    return true;
  }

  bool exhaust_vote(const std::vector<int64_t>* parked) {
    if (!all_local_apps_parked()) return false;
    if (migrate_unacked_ != 0) return false;  // units inside a message
    if (wq_.count != wq_num_unpinned()) return false;  // handoff in flight
    if (parked != nullptr) {
      // flattened (rank, ntypes, t0..tn)*
      size_t i = 0;
      while (i < parked->size()) {
        RqEntry probe;
        probe.world_rank = int((*parked)[i++]);
        int64_t nt = (*parked)[i++];
        probe.any_type = (nt < 0);
        for (int64_t j = 0; j < nt; ++j)
          probe.req_types.push_back(int32_t((*parked)[i++]));
        if (wq_find_match(probe.world_rank, probe) != nullptr) return false;
      }
    }
    return true;
  }

  std::vector<int64_t> parked_list() {
    std::vector<int64_t> out;
    for (const auto& e : rq_) {
      out.push_back(e.world_rank);
      if (e.any_type) {
        out.push_back(-1);
      } else {
        out.push_back(int64_t(e.req_types.size()));
        for (int32_t t : e.req_types) out.push_back(t);
      }
    }
    return out;
  }

  void forward_exhaust(uint16_t tag, NMsg token) {
    int nxt = w_.ring_next(rank_);
    token.tag = tag;
    token.src = rank_;
    token.seti(F_COMPLETE, nxt == int(token.geti(F_ORIGIN)) ? 1 : 0);
    ep_->send(nxt, token);
  }

  void check_exhaustion(double now) {
    if (no_more_work_ || done_by_exhaustion_) return;
    if (exhaust_inflight_) {
      // lost-token recovery: a ring pass over S servers takes well under
      // a second; if the token has not come home in 10 intervals, assume
      // it died (a peer dropped it mid-restart / message lost) and allow
      // a fresh vote. The token id makes any late straggler harmless.
      if (now - exhaust_sent_at_ < 10 * cfg_.exhaust_check_interval) return;
      exhaust_inflight_ = false;
    }
    if (!exhaust_vote(nullptr)) { exhaust_held_ = false; return; }
    if (!exhaust_held_) {
      exhaust_held_ = true;
      exhaust_held_since_ = now;
      return;
    }
    if (now - exhaust_held_since_ < cfg_.exhaust_check_interval) return;
    exhaust_inflight_ = true;
    exhaust_sent_at_ = now;
    exhaust_token_id_ += 1;
    NMsg token = mk(T_SS_EXHAUST_CHK_1);
    token.seti(F_ORIGIN, rank_);
    token.seti(F_TOKEN_ID, exhaust_token_id_);
    token.seti(F_VOTE_OK, 1);
    token.setl(F_ACT, {rank_, activity_});
    token.seti(F_NPARKED, int64_t(rq_.size()));
    token.setl(F_PARKED, parked_list());
    forward_exhaust(T_SS_EXHAUST_CHK_1, token);
  }

  int64_t act_for_self(const std::vector<int64_t>* act) {
    if (act == nullptr) return -1;
    for (size_t i = 0; i + 1 < act->size(); i += 2)
      if ((*act)[i] == rank_) return (*act)[i + 1];
    return -1;
  }

  void on_exhaust_chk(const NMsg& m, bool phase1) {
    NMsg token = m;  // copy; we mutate fields then forward
    if (m.geti(F_COMPLETE) && int(m.geti(F_ORIGIN)) == rank_) {
      if (m.geti(F_TOKEN_ID) != exhaust_token_id_)
        return;  // straggler from a token we already gave up on
      const std::vector<int64_t>* parked = m.getl(F_PARKED);
      bool ok = m.geti(F_VOTE_OK) != 0 && m.geti(F_NPARKED) > 0 &&
                exhaust_vote(parked) &&
                activity_ == act_for_self(m.getl(F_ACT));
      if (!ok) {
        exhaust_held_ = false;
        exhaust_inflight_ = false;
        return;
      }
      if (phase1) {
        token.f.erase(F_COMPLETE);
        forward_exhaust(T_SS_EXHAUST_CHK_2, token);
      } else {
        exhaust_inflight_ = false;
        declare_exhaustion();
      }
      return;
    }
    if (phase1) {
      bool vote = exhaust_vote(nullptr);
      token.seti(F_VOTE_OK, (m.geti(F_VOTE_OK) != 0 && vote) ? 1 : 0);
      std::vector<int64_t> act =
          m.getl(F_ACT) ? *m.getl(F_ACT) : std::vector<int64_t>{};
      act.push_back(rank_);
      act.push_back(activity_);
      token.setl(F_ACT, act);
      token.seti(F_NPARKED, m.geti(F_NPARKED) + int64_t(rq_.size()));
      std::vector<int64_t> parked =
          m.getl(F_PARKED) ? *m.getl(F_PARKED) : std::vector<int64_t>{};
      std::vector<int64_t> mine = parked_list();
      parked.insert(parked.end(), mine.begin(), mine.end());
      token.setl(F_PARKED, parked);
      forward_exhaust(uint16_t(m.tag), token);
    } else {
      bool ok = m.geti(F_VOTE_OK) != 0 && exhaust_vote(m.getl(F_PARKED)) &&
                activity_ == act_for_self(m.getl(F_ACT));
      token.seti(F_VOTE_OK, ok ? 1 : 0);
      forward_exhaust(uint16_t(m.tag), token);
    }
  }

  void declare_exhaustion() {
    for (int s = w_.num_app_ranks(); s < w_.num_app_ranks() + w_.nservers; ++s)
      if (s != rank_) ep_->send(s, mk(T_SS_DONE_BY_EXHAUSTION));
    on_done_by_exhaustion();
  }

  void on_done_by_exhaustion() {
    if (done_by_exhaustion_) return;
    done_by_exhaustion_ = true;
    flush_rq(ADLB_DONE_BY_EXHAUSTION);
  }

  void on_local_app_done(const NMsg& m) {
    finalized_.insert(m.src);
    bool all_done = true;
    for (int app : local_apps_)
      if (!finalized_.count(app)) { all_done = false; break; }
    if (all_done) {
      if (master_ && !end1_pending_) {
        end1_pending_ = true;
        NMsg token = mk(T_SS_END_1);
        token.seti(F_ORIGIN, rank_);
        forward_end1(token);
      } else if (end1_pending_) {
        end1_pending_ = false;
        forward_end1(held_end1_);
      }
    }
  }

  void forward_end1(NMsg token) {
    int nxt = w_.ring_next(rank_);
    token.tag = T_SS_END_1;
    token.src = rank_;
    token.seti(F_COMPLETE, nxt == int(token.geti(F_ORIGIN)) ? 1 : 0);
    ep_->send(nxt, token);
  }

  void on_end_1(const NMsg& m) {
    ending_ = true;
    if (m.geti(F_COMPLETE) && int(m.geti(F_ORIGIN)) == rank_) {
      int nxt = w_.ring_next(rank_);
      NMsg token = mk(T_SS_END_2);
      token.seti(F_ORIGIN, m.geti(F_ORIGIN));
      token.seti(F_COMPLETE, nxt == int(m.geti(F_ORIGIN)) ? 1 : 0);
      ep_->send(nxt, token);
      if (w_.nservers == 1) done_ = true;
      return;
    }
    bool all_done = true;
    for (int app : local_apps_)
      if (!finalized_.count(app)) { all_done = false; break; }
    if (all_done) {
      NMsg token = m;
      forward_end1(token);
    } else {
      // hold until our apps finish (reference held END_LOOP_1,
      // src/adlb.c:1790-1798)
      end1_pending_ = true;
      held_end1_ = m;
    }
  }

  void on_end_2(const NMsg& m) {
    ending_ = true;
    done_ = true;
    if (!m.geti(F_COMPLETE)) {
      int nxt = w_.ring_next(rank_);
      NMsg token = mk(T_SS_END_2);
      token.seti(F_ORIGIN, m.geti(F_ORIGIN));
      token.seti(F_COMPLETE, nxt == int(m.geti(F_ORIGIN)) ? 1 : 0);
      ep_->send(nxt, token);
    }
  }

  // ---- periodic cluster-wide stats ring (reference src/adlb.c:712-753,
  // 2391-2465): master kicks a token; each server appends its packed
  // contribution; back at the master the sum is printed as <=500-byte
  // STAT_APS chunks, same format as the Python side (stats.py), parsed by
  // scripts/get_stats.py. Entry layout:
  //   i32 rank, i64 wq_count, i64 rq, i64 puts, i64 resolved, i64 nbytes,
  //   u32 nhist, (i32 type, i32 tgt, i64 n)*

  void append_pstats_entry(std::string& blob) {
    blob_i32(blob, rank_);
    blob_i64(blob, wq_.count);
    blob_i64(blob, int64_t(rq_.size()));
    blob_i64(blob, puts_ctr_);
    blob_i64(blob, resolved_ctr_);
    blob_i64(blob, mem_curr_);
    std::map<std::pair<int32_t, int32_t>, int64_t> hist;
    for (const auto& kv : wq_.units) {
      int32_t tgt = kv.second.target_rank < 0 ? -1 : kv.second.target_rank;
      hist[{kv.second.work_type, tgt}] += 1;
    }
    blob_u32(blob, uint32_t(hist.size()));
    for (const auto& h : hist) {
      blob_i32(blob, h.first.first);
      blob_i32(blob, h.first.second);
      blob_i64(blob, h.second);
    }
  }

  void kick_periodic_stats(double now) {
    if (no_more_work_ || done_by_exhaustion_) return;  // peers may be gone
    pstats_seq_ += 1;
    std::string blob;
    append_pstats_entry(blob);
    if (w_.nservers == 1) {
      emit_stat_aps(blob, pstats_seq_, now);
      return;
    }
    NMsg m = mk(T_SS_PERIODIC_STATS);
    m.setb(F_PSTATS_BLOB, std::move(blob));
    m.seti(F_SEQNO, pstats_seq_);
    m.seti(F_ORIGIN, rank_);
    m.setd(F_TIME_STAMP, now);
    ep_->send(w_.ring_next(rank_), m);
  }

  void on_periodic_stats(const NMsg& m) {
    const std::string* blob = m.getb(F_PSTATS_BLOB);
    if (blob == nullptr) return;
    if (int(m.geti(F_ORIGIN)) == rank_) {
      emit_stat_aps(*blob, m.geti(F_SEQNO), m.getd(F_TIME_STAMP));
      return;
    }
    std::string out = *blob;
    append_pstats_entry(out);
    NMsg fwd = mk(T_SS_PERIODIC_STATS);
    fwd.setb(F_PSTATS_BLOB, std::move(out));
    fwd.seti(F_SEQNO, m.geti(F_SEQNO));
    fwd.seti(F_ORIGIN, m.geti(F_ORIGIN));
    fwd.setd(F_TIME_STAMP, m.getd(F_TIME_STAMP));
    ep_->send(w_.ring_next(rank_), fwd);
  }

  void emit_stat_aps(const std::string& blob, int64_t seq, double t0) {
    // aggregate the packed entries into the JSON record stats.py emits
    struct Cell { int64_t targeted = 0, untargeted = 0; };
    std::map<int32_t, Cell> by_type;
    int64_t twq = 0, trq = 0, tputs = 0, tres = 0, tnb = 0;
    std::map<int32_t, std::array<int64_t, 3>> per_server;  // wq, rq, nbytes
    size_t off = 0;
    auto rd_i32 = [&](int32_t* v) {
      std::memcpy(v, blob.data() + off, 4); off += 4;
    };
    auto rd_i64 = [&](int64_t* v) {
      std::memcpy(v, blob.data() + off, 8); off += 8;
    };
    while (off + 4 + 5 * 8 + 4 <= blob.size()) {
      int32_t rank; int64_t wq, rq, puts, res, nb; uint32_t nhist;
      rd_i32(&rank); rd_i64(&wq); rd_i64(&rq); rd_i64(&puts);
      rd_i64(&res); rd_i64(&nb);
      std::memcpy(&nhist, blob.data() + off, 4); off += 4;
      for (uint32_t i = 0; i < nhist && off + 16 <= blob.size(); ++i) {
        int32_t t, tgt; int64_t n;
        rd_i32(&t); rd_i32(&tgt); rd_i64(&n);
        if (tgt >= 0) by_type[t].targeted += n;
        else by_type[t].untargeted += n;
      }
      twq += wq; trq += rq; tputs += puts; tres += res; tnb += nb;
      per_server[rank] = {wq, rq, nb};
    }
    double now = monotonic();
    std::ostringstream js;
    char num[64];
    std::snprintf(num, sizeof(num), "%.6f", now);
    js << "{\"seq\":" << seq << ",\"t\":" << num;
    std::snprintf(num, sizeof(num), "%.6f", now - t0);
    js << ",\"trip_s\":" << num
       << ",\"nservers\":" << per_server.size() << ",\"by_type\":{";
    bool first = true;
    for (const auto& kv : by_type) {
      if (!first) js << ",";
      first = false;
      js << "\"" << kv.first << "\":{\"targeted\":" << kv.second.targeted
         << ",\"untargeted\":" << kv.second.untargeted << "}";
    }
    js << "},\"total\":{\"wq\":" << twq << ",\"rq\":" << trq
       << ",\"puts\":" << tputs << ",\"resolved\":" << tres
       << ",\"nbytes\":" << tnb << "},\"per_server\":{";
    first = true;
    for (const auto& kv : per_server) {
      if (!first) js << ",";
      first = false;
      js << "\"" << kv.first << "\":{\"wq\":" << kv.second[0]
         << ",\"rq\":" << kv.second[1] << ",\"nbytes\":" << kv.second[2]
         << "}";
    }
    js << "}}";
    std::string payload = js.str();
    size_t nparts = (payload.size() + 499) / 500;
    if (nparts == 0) nparts = 1;
    for (size_t i = 0; i < nparts; ++i) {
      std::printf("STAT_APS: seq=%lld part=%zu/%zu %s\n",
                  (long long)seq, i + 1, nparts,
                  payload.substr(i * 500, 500).c_str());
    }
    std::fflush(stdout);
  }

  // ---- balancer sidecar (tpu mode) ----------------------------------------
  // The planning brain runs in a Python sidecar process; this server streams
  // fixed-shape queue-state snapshots to it and enacts SS_PLAN_MATCH /
  // SS_PLAN_MIGRATE exactly like the Python server does (plan entries are
  // hints validated against live state; staleness is harmless).

  // Any available (unpinned, untargeted) unit? Amortized-cheap: peek_best
  // pops stale lazy-heap tops, each popped at most once over its lifetime.
  // A server holding only targeted work (gfmc's answer collectors) must
  // not count as snapshot-relevant — its walk would ship nothing.
  bool wq_has_untargeted() {
    for (auto& kv : wq_.untargeted)
      if (wq_.peek_best(&kv.second, -1) != nullptr) return true;
    return false;
  }

  void maybe_event_snapshot() {
    if (!cfg_.tpu_mode) return;
    double now = monotonic();
    if (now - last_event_snap_ < cfg_.balancer_min_gap) return;
    last_event_snap_ = now;
    send_snapshot();
  }

  void maybe_event_delta(int64_t seqno, int32_t wtype, int32_t prio,
                         int64_t len) {
    if (!cfg_.tpu_mode || cfg_.balancer_rank < 0) return;
    // accumulate; flush as ONE batched delta when the rate-limit gap
    // elapses (round 4): without batching a producer streaming puts was
    // visible to the balancer at one unit per gap — a lagging inventory
    // view that kept the fair-share pump's scarcity gate closed while
    // worker pools idled
    pend_seqnos_.push_back(seqno);
    pend_wtypes_.push_back(wtype);
    pend_prios_.push_back(prio);
    pend_lens_.push_back(len);
    double now = monotonic();
    if (now - last_event_snap_ >= cfg_.balancer_min_gap)
      flush_event_deltas(now);
  }

  void flush_event_deltas(double now) {
    if (pend_seqnos_.empty()) return;
    last_event_snap_ = now;
    NMsg m = mk(T_SS_STATE_DELTA);
    m.setl(F_SEQNOS, std::move(pend_seqnos_));
    m.setl(F_WORK_TYPES, std::move(pend_wtypes_));
    m.setl(F_PRIOS, std::move(pend_prios_));
    m.setl(F_WORK_LENS, std::move(pend_lens_));
    m.seti(F_NBYTES, mem_curr_);
    ep_->send(cfg_.balancer_rank, m);
    pend_seqnos_.clear();
    pend_wtypes_.clear();
    pend_prios_.clear();
    pend_lens_.clear();
  }

  void send_snapshot() {
    if (cfg_.balancer_rank < 0) return;
    // the full walk supersedes pending put deltas (units are in the wq)
    pend_seqnos_.clear();
    pend_wtypes_.clear();
    pend_prios_.clear();
    pend_lens_.clear();
    // top-K unpinned untargeted by (prio desc, seqno asc)
    std::vector<const adlbwq::Unit*> avail;
    avail.reserve(wq_.units.size());
    for (const auto& kv : wq_.units)
      if (kv.second.pin_rank < 0 && kv.second.target_rank < 0)
        avail.push_back(&kv.second);
    std::sort(avail.begin(), avail.end(),
              [](const adlbwq::Unit* a, const adlbwq::Unit* b) {
                if (a->prio != b->prio) return a->prio > b->prio;
                return a->seqno < b->seqno;
              });
    size_t k = std::min<size_t>(avail.size(), size_t(cfg_.balancer_max_tasks));
    std::vector<int64_t> tasks;
    tasks.reserve(4 * k);
    for (size_t i = 0; i < k; ++i) {
      tasks.push_back(avail[i]->seqno);
      tasks.push_back(avail[i]->work_type);
      tasks.push_back(avail[i]->prio);
      tasks.push_back(avail[i]->payload_len);
    }
    std::vector<int64_t> reqs;
    int64_t nreqs = 0;
    for (const auto& e : rq_) {
      if (nreqs >= cfg_.balancer_max_requesters) break;
      if (reqs.size() + 3 + e.req_types.size() > 60000) break;  // u16 codec
      if (rfr_out_.count(e.world_rank)) continue;  // RFR handoff pending
      reqs.push_back(e.world_rank);
      reqs.push_back(e.rqseqno);
      if (e.any_type) {
        reqs.push_back(-1);
      } else {
        reqs.push_back(int64_t(e.req_types.size()));
        for (int32_t t : e.req_types) reqs.push_back(t);
      }
      nreqs += 1;
    }
    // suppress repeat empty snapshots (an idle server must not wake the
    // sidecar every tick for nothing) — but an unreported mig_acks
    // change is NOT empty: the ack clears the planner's in-flight
    // credit, and swallowing it here would re-open the phantom-credit
    // stall the empty-batch ack exists to close
    bool empty = tasks.empty() && reqs.empty() &&
                 mig_acks_ == last_snap_acks_;
    if (empty && last_snap_empty_) return;
    last_snap_empty_ = empty;
    last_snap_acks_ = mig_acks_;
    int64_t consumers = 0;
    for (int app : local_apps_)
      if (!finalized_.count(app)) consumers += 1;
    NMsg m = mk(T_SS_STATE);
    m.setl(F_TASKS_FLAT, tasks);
    m.setl(F_REQS_FLAT, reqs);
    m.seti(F_NBYTES, mem_curr_);
    m.seti(F_CONSUMERS, consumers);
    std::vector<int64_t> acks;
    acks.reserve(2 * mig_acks_.size());
    for (const auto& kv : mig_acks_) {
      acks.push_back(kv.first);
      acks.push_back(kv.second);
    }
    m.setl(F_MIG_ACKS, std::move(acks));
    ep_->send(cfg_.balancer_rank, m);
  }

  void on_plan_match(const NMsg& m) {
    // enact one plan entry through the RFR response path (mirrors the
    // Python server's _on_plan_match)
    int64_t seqno = m.geti(F_SEQNO);
    auto it = wq_.units.find(seqno);
    if (it == wq_.units.end() || it->second.pin_rank >= 0 ||
        it->second.target_rank >= 0)
      return;  // stale plan entry; next round re-plans
    int for_rank = int(m.geti(F_FOR_RANK));
    it->second.pin_rank = for_rank;
    activity_ += 1;
    exhaust_held_ = false;
    const Meta& meta = meta_[seqno];
    NMsg r = mk(T_SS_RFR_RESP);
    r.seti(F_FOUND, 1);
    r.seti(F_FOR_RANK, for_rank);
    r.seti(F_RQSEQNO, m.geti(F_RQSEQNO));
    r.seti(F_SEQNO, seqno);
    r.seti(F_WORK_TYPE, it->second.work_type);
    r.seti(F_PRIO, it->second.prio);
    r.seti(F_TARGET_RANK, it->second.target_rank);
    r.seti(F_WORK_LEN, it->second.payload_len + meta.common_len);
    r.seti(F_ANSWER_RANK, meta.answer_rank);
    r.seti(F_COMMON_LEN, meta.common_len);
    r.seti(F_COMMON_SERVER, meta.common_server);
    r.seti(F_COMMON_SEQNO, meta.common_seqno);
    ep_->send(int(m.geti(F_REQ_HOME)), r);
  }

  static void blob_u32(std::string& b, uint32_t v) { b.append((const char*)&v, 4); }
  static void blob_i32(std::string& b, int32_t v) { b.append((const char*)&v, 4); }
  static void blob_i64(std::string& b, int64_t v) { b.append((const char*)&v, 8); }
  static void blob_f64(std::string& b, double v) { b.append((const char*)&v, 8); }

  void on_plan_migrate(const NMsg& m) {
    const std::vector<int64_t>* seqnos = m.getl(F_SEQNOS);
    if (seqnos == nullptr) return;
    // batch blob: [u32 n] then per unit
    // u32 plen, i32 type, i32 prio, i32 answer, i32 home,
    // i64 clen, i64 cserver, i64 cseqno, f64 ts, payload bytes
    std::string blob;
    uint32_t n = 0;
    blob_u32(blob, 0);  // patched below
    for (int64_t seqno : *seqnos) {
      auto it = wq_.units.find(seqno);
      if (it == wq_.units.end() || it->second.pin_rank >= 0 ||
          it->second.target_rank >= 0)
        continue;  // stale plan entry
      adlbwq::Unit unit = it->second;
      Meta meta = std::move(meta_[seqno]);
      meta_.erase(seqno);
      wq_.total_bytes -= unit.payload_len;
      wq_.units.erase(it);
      wq_.count -= 1;
      mem_free(int64_t(meta.payload.size()));
      stats_[K_NPUSHED_FROM_HERE] += 1;
      blob_u32(blob, uint32_t(meta.payload.size()));
      blob_i32(blob, unit.work_type);
      blob_i32(blob, unit.prio);
      blob_i32(blob, meta.answer_rank);
      blob_i32(blob, meta.home_server);
      blob_i64(blob, meta.common_len);
      blob_i64(blob, meta.common_server);
      blob_i64(blob, meta.common_seqno);
      blob_f64(blob, meta.time_stamp);
      blob.append(meta.payload);
      n += 1;
    }
    // a fully-stale batch is STILL sent, empty, carrying the planner's
    // batch id: the destination's ack clears the planner's in-flight
    // credit; silently dropping it left a phantom credit suppressing
    // solve+pump for that destination until the TTLs expired
    std::memcpy(blob.data(), &n, 4);
    if (n > 0) {
      activity_ += 1;
      exhaust_held_ = false;
    }
    migrate_unacked_ += 1;
    NMsg wk = mk(T_SS_MIGRATE_WORK);
    wk.setb(F_UNITS_BLOB, std::move(blob));
    wk.seti(F_BOUNCED, 0);
    wk.seti(F_MIG_ID, m.geti(F_MIG_ID));
    ep_->send(int(m.geti(F_DEST)), wk);
  }

  void on_migrate_work(const NMsg& m) {
    // ack the planner's batch id via the next snapshot, per source —
    // transport ordering only holds per sender pair (bounced resends
    // carry id 0: the original sighting already acked it)
    int64_t mid = m.geti(F_MIG_ID);
    if (mid > 0) {
      int64_t& slot = mig_acks_[m.src];
      slot = std::max(slot, mid);
    }
    const std::string* blob = m.getb(F_UNITS_BLOB);
    if (blob == nullptr || blob->size() < 4) return;
    bool bounced = m.geti(F_BOUNCED) != 0;
    size_t off = 0;
    uint32_t n;
    std::memcpy(&n, blob->data(), 4); off = 4;
    std::string bounce_blob;
    uint32_t n_bounced = 0;
    blob_u32(bounce_blob, 0);
    bool any_added = false;
    for (uint32_t i = 0; i < n; ++i) {
      if (off + 4 > blob->size()) die("truncated migrate blob");
      uint32_t plen;
      std::memcpy(&plen, blob->data() + off, 4);
      size_t rec = 4 + 4 * 4 + 3 * 8 + 8;
      if (off + rec + plen > blob->size()) die("truncated migrate blob");
      // admission control like every other ingress; an admitted unit is
      // never dropped — on a full server it bounces back ONCE, and the
      // sender must then keep it (overcommit beats losing work)
      if (!bounced && !mem_try_alloc(int64_t(plen))) {
        bounce_blob.append(*blob, off, rec + plen);
        n_bounced += 1;
        off += rec + plen;
        continue;
      }
      if (bounced) mem_alloc(int64_t(plen));
      int32_t wtype, prio, answer, home;
      int64_t clen, cserver, cseqno;
      double ts;
      size_t o = off + 4;
      std::memcpy(&wtype, blob->data() + o, 4); o += 4;
      std::memcpy(&prio, blob->data() + o, 4); o += 4;
      std::memcpy(&answer, blob->data() + o, 4); o += 4;
      std::memcpy(&home, blob->data() + o, 4); o += 4;
      std::memcpy(&clen, blob->data() + o, 8); o += 8;
      std::memcpy(&cserver, blob->data() + o, 8); o += 8;
      std::memcpy(&cseqno, blob->data() + o, 8); o += 8;
      std::memcpy(&ts, blob->data() + o, 8); o += 8;
      int64_t seqno = next_seqno_++;
      adlbwq::Unit u{seqno, wtype, prio, -1, -1, int64_t(plen)};
      wq_.units.emplace(seqno, u);
      wq_.count += 1;
      if (wq_.count > wq_.max_count) wq_.max_count = wq_.count;
      wq_.total_bytes += u.payload_len;
      wq_.index(u);
      Meta& meta = meta_[seqno];
      meta.payload.assign(blob->data() + o, plen);
      meta.answer_rank = answer;
      meta.home_server = home;
      meta.common_len = clen;
      meta.common_server = cserver;
      meta.common_seqno = cseqno;
      meta.time_stamp = ts;
      stats_[K_NPUSHED_TO_HERE] += 1;
      any_added = true;
      off += rec + plen;
    }
    ep_->send(m.src, mk(T_SS_MIGRATE_ACK));
    if (n_bounced > 0) {
      std::memcpy(bounce_blob.data(), &n_bounced, 4);
      migrate_unacked_ += 1;
      NMsg wk = mk(T_SS_MIGRATE_WORK);
      wk.setb(F_UNITS_BLOB, std::move(bounce_blob));
      wk.seti(F_BOUNCED, 1);
      ep_->send(m.src, wk);
    }
    if (any_added) match_rq();
    // immediate full snapshot: the batch ack and the post-batch
    // inventory reach the planner now, not a heartbeat later — the
    // follow-up top-up cadence rides on this. Sent for empty id-bearing
    // batches too: the ack clearing the phantom credit must not wait
    // for the next heartbeat.
    if (cfg_.tpu_mode && (any_added || mid > 0)) send_snapshot();
  }

  void on_peer_eof(const NMsg& m) {
    // benign during termination; before it, a rank died without finalizing
    // (connection-based: a rank that never sent a frame is invisible here).
    // Only the HOME server judges an app EOF — finalize knowledge is
    // home-local, and finished apps legitimately EOF at other servers.
    if (done_ || no_more_work_ || done_by_exhaustion_ || aborted_ || ending_)
      return;
    if (w_.is_app(m.src) && w_.home_server(m.src) == rank_ &&
        !finalized_.count(m.src)) {
      std::fprintf(stderr,
                   "[adlb_serverd %d] app rank %d connection lost before "
                   "finalize; aborting the world\n", rank_, m.src);
      do_abort(-3, true);
    } else if (w_.is_server(m.src)) {
      std::fprintf(stderr,
                   "[adlb_serverd %d] server rank %d connection lost "
                   "mid-run; aborting\n", rank_, m.src);
      do_abort(-3, true);
    }
  }

  // ---- abort --------------------------------------------------------------
  void do_abort(int code, bool broadcast) {
    if (aborted_) return;
    aborted_ = true;
    abort_code_ = code;
    if (broadcast) {
      for (int s = w_.num_app_ranks(); s < w_.num_app_ranks() + w_.nservers;
           ++s) {
        if (s == rank_) continue;
        NMsg a = mk(T_SS_ABORT);
        a.seti(F_CODE, code);
        ep_->send(s, a);
      }
    }
    for (int app : local_apps_) {
      NMsg a = mk(T_TA_ABORT);
      a.seti(F_CODE, code);
      ep_->send(app, a);
    }
    std::printf("ABORT %d\n", code);
    std::fflush(stdout);
    done_ = true;
  }

  World w_;
  Cfg cfg_;
  int rank_;
  Endpoint* ep_;
  bool master_ = false;
  std::set<int> local_apps_;

  adlbwq::WorkQueue wq_;
  std::unordered_map<int64_t, Meta> meta_;
  std::vector<RqEntry> rq_;  // insert-ordered, one per rank
  // tq: app -> type -> server -> count (reference src/xq.h:73-79)
  std::unordered_map<int, std::unordered_map<int32_t, std::map<int, int>>> tq_;
  std::unordered_map<int64_t, CommonEntry> cq_;
  std::map<int, PeerState> peers_;

  int64_t next_seqno_ = 1;
  int64_t next_common_seqno_ = 1;
  int64_t mem_curr_ = 0, mem_hwm_ = 0;

  std::unordered_set<int> rfr_out_;
  std::unordered_map<int, std::unordered_set<int>> rfr_excluded_;
  int64_t push_seq_ = 0;
  std::unordered_map<int64_t, int64_t> push_offered_;   // qid -> seqno
  std::unordered_map<int64_t, int64_t> push_reserved_;  // qid -> bytes
  int64_t migrate_unacked_ = 0;
  std::vector<NMsg> held_ckpts_;  // tokens parked on in-flight migrations
  double last_event_snap_ = 0.0;
  // put-event deltas pending behind the rate-limit gap (batched flush)
  std::vector<int64_t> pend_seqnos_, pend_wtypes_, pend_prios_, pend_lens_;
  bool hungry_ = false;  // sidecar says: parked requesters exist somewhere
  bool hungry_any_ = false;  // ... and one of them accepts any type
  std::set<int32_t> hungry_types_;  // the types parked requesters want
  double next_idle_snap_ = 0.0;  // slow snapshot heartbeat when not hungry
  bool last_snap_empty_ = false;
  // src server -> highest planner migration-batch id received from it
  std::map<int, int64_t> mig_acks_;
  std::map<int, int64_t> last_snap_acks_;  // acks as of last sent snapshot

  bool no_more_work_ = false;
  bool done_by_exhaustion_ = false;
  bool done_ = false;
  bool aborted_ = false;
  int abort_code_ = 0;
  std::set<int> finalized_;
  bool end1_pending_ = false;
  bool ending_ = false;  // shutdown ring underway: peer EOFs are benign
  NMsg held_end1_;
  bool exhaust_held_ = false;
  double exhaust_held_since_ = 0.0;
  bool exhaust_inflight_ = false;
  double exhaust_sent_at_ = 0.0;
  int64_t exhaust_token_id_ = 0;
  int64_t activity_ = 0;

  std::vector<double> stats_;
  double rq_wait_sum_ = 0.0;
  int64_t rq_wait_n_ = 0;
  double next_qmstat_ = 0.0, next_exhaust_ = 0.0, next_ds_log_ = 0.0;
  int64_t qm_trips_ = 0;
  int64_t puts_ctr_ = 0, resolved_ctr_ = 0, pstats_seq_ = 0;
  // since-last-DS_LOG counters (reference src/adlb.c:3222-3259)
  int64_t events_ctr_ = 0, ss_msgs_ctr_ = 0, reserve_immed_ctr_ = 0,
          rfr_failed_ctr_ = 0;
  struct { int64_t events = 0, ss = 0, reserves = 0, immed = 0, parked = 0,
                   rfr_failed = 0; } ds_last_;
  double next_pstats_ = 0.0;
};

}  // namespace

int main() {
  World w;
  Cfg cfg;
  int rank = -1;
  std::string line;
  // phase 1: config
  while (std::getline(std::cin, line)) {
    std::istringstream is(line);
    std::string key;
    is >> key;
    if (key == "endconfig") break;
    if (key == "nranks") is >> w.nranks;
    else if (key == "nservers") is >> w.nservers;
    else if (key == "use_debug_server") { int v; is >> v; w.use_debug_server = v != 0; }
    else if (key == "types") { int t; while (is >> t) w.types.push_back(t); }
    else if (key == "rank") is >> rank;
    else if (key == "qmstat_interval") is >> cfg.qmstat_interval;
    else if (key == "exhaust_check_interval") is >> cfg.exhaust_check_interval;
    else if (key == "max_malloc") is >> cfg.max_malloc;
    else if (key == "balancer") {
      std::string v; is >> v;
      cfg.tpu_mode = (v == "tpu");
    }
    else if (key == "balancer_rank") is >> cfg.balancer_rank;
    else if (key == "debug_log_interval") is >> cfg.debug_log_interval;
    else if (key == "periodic_log_interval") is >> cfg.periodic_log_interval;
    else if (key == "qmstat_mode") {
      std::string v; is >> v;
      cfg.qmstat_ring = (v == "ring");
    }
    else if (key == "balancer_interval") is >> cfg.balancer_interval;
    else if (key == "balancer_min_gap") is >> cfg.balancer_min_gap;
    else if (key == "balancer_max_tasks") is >> cfg.balancer_max_tasks;
    else if (key == "balancer_max_requesters") is >> cfg.balancer_max_requesters;
    else if (key == "restore_path") {
      is >> std::ws;
      std::getline(is, cfg.restore_path);  // rest of line: paths may have spaces
    }
    else if (!key.empty()) die("unknown config key '%s'", key.c_str());
  }
  if (rank < 0 || !w.is_server(rank)) die("bad or missing rank");
  Endpoint ep;
  int port = ep.listen_any();
  std::printf("PORT %d\n", port);
  std::fflush(stdout);
  // phase 2: address map
  while (std::getline(std::cin, line)) {
    std::istringstream is(line);
    std::string key;
    is >> key;
    if (key == "endaddrs") break;
    if (key == "addr") {
      int r, p;
      std::string host;
      is >> r >> host >> p;
      ep.set_addr(r, host, p);
    }
  }
  Server server(w, cfg, rank, &ep);
  server.run();
  server.notify_balancer_end();
  server.print_stats();
  ep.close_all();
  // readers may still be blocked in recv; exit hard after stats are out
  std::_Exit(server.aborted() ? 2 : 0);
}
