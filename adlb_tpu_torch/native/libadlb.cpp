// Native client library: the C API of include/adlb/adlb.h over the binary
// TLV wire codec (twin of adlb_tpu_torch/runtime/codec.py — keep tables in sync).
//
// This is the native equivalent of the reference's client-side protocol
// engine (reference src/adlb.c:2638-3176): Put routing + reject/retry with
// least-loaded hints, blocking/non-blocking Reserve, Get_reserved with
// batch-common prefix fetch, batch puts, Info queries, finalize/abort —
// re-targeted from tagged MPI sends to the framework's TCP fabric.
//
// Threads: one acceptor + one reader per inbound connection feed a single
// inbox (deque + condvar); the API itself is strictly request/response like
// the reference's client (blocking MPI_Wait), so no other locking is needed.
// Little-endian hosts assumed (as is the Python struct '<' side).

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "../../include/adlb/adlb.h"

namespace {

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
  T_FA_CHECKPOINT = 1048,
  T_TA_CHECKPOINT_RESP = 1049,
  T_AM_APP = 1047,
};

// ---- field ids (codec.py FIELDS) ------------------------------------------
enum Field : uint8_t {
  F_PAYLOAD = 1,
  F_WORK_TYPE = 2,
  F_PRIO = 3,
  F_TARGET_RANK = 4,
  F_ANSWER_RANK = 5,
  F_COMMON_LEN = 6,
  F_COMMON_SERVER = 7,
  F_COMMON_SEQNO = 8,
  F_RC = 9,
  F_HINT = 10,
  F_REQ_TYPES = 11,
  F_HANG = 12,
  F_RQSEQNO = 13,
  F_HANDLE = 14,
  F_WORK_LEN = 15,
  F_TIME_ON_Q = 16,
  F_COUNT = 17,
  F_NBYTES = 18,
  F_MAX_WQ = 19,
  F_CODE = 20,
  F_SEQNO = 21,
  F_REFCNT = 22,
  F_SERVER_RANK = 23,
  F_KEY = 24,
  F_VALUE = 25,
  F_APPTAG = 26,
  F_PUT_ID = 58,
  F_FETCH = 59,
  F_FETCH_MAX = 79,
  F_PAYLOADS = 80,
  F_WORK_TYPES = 81,
  F_PRIOS = 82,
  F_ANSWER_RANKS = 83,
  F_PATH = 72,
  F_RETRY_AFTER_MS = 93,
};

enum Kind : uint8_t {
  K_I64 = 0, K_BYTES = 1, K_LIST = 2, K_F64 = 3,
  K_BLIST = 4,  // list of byte strings: u16 count, (u32 len + bytes)*
  K_FLIST = 5,  // list of f64: u16 count, f64*
};

constexpr uint8_t BINARY_MAGIC = 0x01;

struct Msg {
  uint16_t tag = 0;
  int32_t src = -1;
  std::map<uint8_t, int64_t> ints;
  std::map<uint8_t, double> dbls;
  std::map<uint8_t, std::string> blobs;
  std::map<uint8_t, std::vector<int64_t>> lists;
  std::map<uint8_t, std::vector<std::string>> blists;
  std::map<uint8_t, std::vector<double>> flists;

  int64_t geti(uint8_t f, int64_t dflt = 0) const {
    auto it = ints.find(f);
    return it == ints.end() ? dflt : it->second;
  }
};

// ---- encoding -------------------------------------------------------------

void put_u16(std::string &b, uint16_t v) { b.append((const char *)&v, 2); }
void put_u32(std::string &b, uint32_t v) { b.append((const char *)&v, 4); }
void put_i32(std::string &b, int32_t v) { b.append((const char *)&v, 4); }
void put_i64(std::string &b, int64_t v) { b.append((const char *)&v, 8); }
void put_f64(std::string &b, double v) { b.append((const char *)&v, 8); }

struct Encoder {
  std::string body;
  uint16_t nfields = 0;

  explicit Encoder(uint16_t tag, int32_t src) {
    body.push_back((char)BINARY_MAGIC);
    put_u16(body, tag);
    put_i32(body, src);
    put_u16(body, 0);  // nfields backpatched in finish()
  }
  Encoder &i(uint8_t f, int64_t v) {
    body.push_back((char)f);
    body.push_back((char)K_I64);
    put_i64(body, v);
    nfields++;
    return *this;
  }
  Encoder &bytes(uint8_t f, const void *p, size_t n) {
    body.push_back((char)f);
    body.push_back((char)K_BYTES);
    put_u32(body, (uint32_t)n);
    body.append((const char *)p, n);
    nfields++;
    return *this;
  }
  Encoder &list(uint8_t f, const std::vector<int64_t> &v) {
    body.push_back((char)f);
    body.push_back((char)K_LIST);
    put_u16(body, (uint16_t)v.size());
    for (int64_t x : v) put_i64(body, x);
    nfields++;
    return *this;
  }
  std::string finish() {
    memcpy(&body[7], &nfields, 2);  // offset of nfields in the header
    return std::move(body);
  }
};

bool decode(const std::string &body, Msg *out) {
  if (body.size() < 9 || (uint8_t)body[0] != BINARY_MAGIC) return false;
  size_t off = 1;
  auto need = [&](size_t n) { return off + n <= body.size(); };
  auto rd = [&](void *p, size_t n) {
    memcpy(p, body.data() + off, n);
    off += n;
  };
  uint16_t nf;
  rd(&out->tag, 2);
  rd(&out->src, 4);
  rd(&nf, 2);
  for (uint16_t k = 0; k < nf; k++) {
    if (!need(2)) return false;
    uint8_t fid = body[off], kind = body[off + 1];
    off += 2;
    if (kind == K_I64) {
      if (!need(8)) return false;
      int64_t v;
      rd(&v, 8);
      out->ints[fid] = v;
    } else if (kind == K_BYTES) {
      if (!need(4)) return false;
      uint32_t n;
      rd(&n, 4);
      if (!need(n)) return false;
      out->blobs[fid].assign(body.data() + off, n);
      off += n;
    } else if (kind == K_LIST) {
      if (!need(2)) return false;
      uint16_t cnt;
      rd(&cnt, 2);
      if (!need((size_t)8 * cnt)) return false;
      auto &lst = out->lists[fid];
      lst.resize(cnt);
      for (uint16_t j = 0; j < cnt; j++) rd(&lst[j], 8);
    } else if (kind == K_F64) {
      if (!need(8)) return false;
      double v;
      rd(&v, 8);
      out->dbls[fid] = v;
    } else if (kind == K_BLIST) {
      if (!need(2)) return false;
      uint16_t cnt;
      rd(&cnt, 2);
      auto &bl = out->blists[fid];
      bl.reserve(cnt);
      for (uint16_t j = 0; j < cnt; j++) {
        if (!need(4)) return false;
        uint32_t n;
        rd(&n, 4);
        if (!need(n)) return false;
        bl.emplace_back(body.data() + off, n);
        off += n;
      }
    } else if (kind == K_FLIST) {
      if (!need(2)) return false;
      uint16_t cnt;
      rd(&cnt, 2);
      if (!need((size_t)8 * cnt)) return false;
      auto &fl = out->flists[fid];
      fl.resize(cnt);
      for (uint16_t j = 0; j < cnt; j++) rd(&fl[j], 8);
    } else {
      return false;
    }
  }
  // exact-frame check: every legitimate encoder emits no trailing bytes,
  // so leftovers mean garbage that decoded by luck
  if (off != body.size()) return false;
  // client-bound wire tags live in the 1001-1049 block; anything else is
  // crafted or version-skewed and must not reach the dispatch paths,
  // whose unexpected-tag arms are fatal
  if (out->tag < 1001 || out->tag > 1049) return false;
  return true;
}

// ---- context --------------------------------------------------------------

struct Ctx {
  int rank = -1, nranks = 0, nservers = 0, num_app_ranks = 0, home = -1;
  int aprintf_flag = 0;
  std::vector<int> types;
  std::vector<std::pair<std::string, int>> addr;  // per rank

  int listen_fd = -1;
  std::thread acceptor;
  std::vector<std::thread> readers;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Msg> inbox;
  std::deque<Msg> app_inbox;  // stashed AM_APP frames (the app_comm channel)
  std::map<int, int> out_fds;
  std::atomic<bool> closed{false};

  int rr = 0;       // round-robin cursor over servers
  bool route_home = false;  // ADLB_PUT_ROUTING=home: untargeted puts -> home
  int rqseqno = 0;  // reserve sequence number
  // batch-put state (reference src/adlb.c:2638-2751)
  bool batch_active = false;
  int batch_server = -1, batch_len = 0, batch_refcnt = 0;
  int64_t batch_seqno = -1;
};

Ctx *g = nullptr;

void die(const char *fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  fprintf(stderr, "[adlb rank %d] ", g ? g->rank : -1);
  vfprintf(stderr, fmt, ap);
  fprintf(stderr, "\n");
  va_end(ap);
  exit(1);
}

// ---- sockets --------------------------------------------------------------

bool read_exact(int fd, void *p, size_t n) {
  char *c = (char *)p;
  while (n > 0) {
    ssize_t r = read(fd, c, n);
    if (r <= 0) return false;
    c += r;
    n -= (size_t)r;
  }
  return true;
}

// Body reads grow with the bytes actually received instead of
// pre-allocating the advertised length: a connection that sends only a
// large length prefix (then stalls) must not pin that memory in recv.
bool read_body(int fd, uint32_t n, std::string *body) {
  body->clear();
  char chunk[65536];
  while (body->size() < n) {
    size_t want = n - body->size();
    if (want > sizeof chunk) want = sizeof chunk;
    ssize_t r = recv(fd, chunk, want, 0);
    if (r <= 0) return false;
    body->append(chunk, (size_t)r);
  }
  return true;
}

bool write_all(int fd, const void *p, size_t n) {
  const char *c = (const char *)p;
  while (n > 0) {
    ssize_t r = write(fd, c, n);
    if (r <= 0) return false;
    c += r;
    n -= (size_t)r;
  }
  return true;
}

void reader_loop(int fd) {
  // Robustness policy (mirrors serverd.cpp): a connection that has never
  // delivered a decodable frame is untrusted — garbage on it closes the
  // connection without touching the world (a stray scanner must not kill
  // a rank, and rank death kills the whole world). Once a frame has
  // decoded, the peer is a real rank: corruption on an ESTABLISHED
  // stream is a protocol error and fails fast — dropping it instead
  // could discard the response a blocking caller is parked on, turning
  // a diagnosable failure into a silent distributed hang.
  static const uint32_t kMaxFrame = 1u << 28;  // 256 MB
  bool established = false;
  for (;;) {
    uint32_t len;
    if (!read_exact(fd, &len, 4)) break;
    if (len > kMaxFrame) {
      // cap before resize(): a hostile 4 GB prefix must not become the
      // allocation that kills this rank
      if (established)
        die("frame length %u exceeds %u cap on an established connection",
            len, kMaxFrame);
      std::fprintf(stderr,
                   "[libadlb] frame length %u exceeds %u cap; closing "
                   "connection\n", len, kMaxFrame);
      break;
    }
    std::string body;
    if (!read_body(fd, len, &body)) break;
    Msg m;
    if (len == 0 || (uint8_t)body[0] != BINARY_MAGIC) {
      if (len > 0 && (uint8_t)body[0] == 0x80 &&
          body.find("adlb_tpu_torch") != std::string::npos) {
        // pickle protocol-2+ magic AND the pickled Msg's embedded module
        // path: a Python server that has not yet learned this rank is a
        // binary peer pickles its frames, and the only unsolicited
        // pickled client-bound message is the TA_ABORT fan-out — honor
        // it. (The module-path check keeps 0x80-prefixed line noise from
        // synthesizing a fatal abort; test_codec.py pins the invariant.)
        m.tag = T_TA_ABORT;
        m.ints[F_CODE] = ADLB_ERROR;
      } else if (!established) {
        std::fprintf(stderr,
                     "[libadlb] closing connection after non-binary "
                     "frame (%u B)\n", len);
        break;
      } else {
        die("non-binary frame (%u bytes) on an established connection",
            len);
      }
    } else if (!decode(body, &m)) {
      if (!established) {
        std::fprintf(stderr,
                     "[libadlb] closing connection after undecodable "
                     "first frame (%u B) — stray connection, or a "
                     "version-skewed peer (if a caller now hangs, "
                     "rebuild both sides from one tree)\n", len);
        break;
      }
      die("undecodable binary frame (%u bytes) from a live peer", len);
    } else {
      established = true;
    }
    {
      std::lock_guard<std::mutex> lk(g->mu);
      g->inbox.push_back(std::move(m));
    }
    g->cv.notify_all();
  }
  close(fd);
}

void accept_loop() {
  for (;;) {
    int fd = accept(g->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (g->closed.load()) return;
      continue;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    std::lock_guard<std::mutex> lk(g->mu);
    g->readers.emplace_back(reader_loop, fd);
  }
}

int connect_to(int dest) {
  auto &hp = g->addr[dest];
  struct addrinfo hints = {}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char port[16];
  snprintf(port, sizeof port, "%d", hp.second);
  // servers may come up after us: retry with backoff for ~15 s
  for (int attempt = 0; attempt < 60; attempt++) {
    if (getaddrinfo(hp.first.c_str(), port, &hints, &res) == 0) {
      int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
      if (fd >= 0 && connect(fd, res->ai_addr, res->ai_addrlen) == 0) {
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
        freeaddrinfo(res);
        return fd;
      }
      if (fd >= 0) close(fd);
      freeaddrinfo(res);
      res = nullptr;
    }
    usleep(250 * 1000);
  }
  die("cannot connect to rank %d at %s:%d", dest, hp.first.c_str(), hp.second);
  return -1;
}

void send_msg(int dest, Encoder &enc) {
  std::string body = enc.finish();
  uint32_t len = (uint32_t)body.size();
  auto it = g->out_fds.find(dest);
  int fd = it == g->out_fds.end() ? -1 : it->second;
  if (fd < 0) {
    fd = connect_to(dest);
    g->out_fds[dest] = fd;
  }
  if (!write_all(fd, &len, 4) || !write_all(fd, body.data(), body.size())) {
    close(fd);
    fd = connect_to(dest);  // one reconnect attempt
    g->out_fds[dest] = fd;
    if (!write_all(fd, &len, 4) || !write_all(fd, body.data(), body.size()))
      die("send to rank %d failed", dest);
  }
}

// Blocks until a frame with `want` arrives.  TA_ABORT terminates the process
// (the reference client dies inside MPI_Abort in the same situation,
// reference src/adlb.c:3165-3176).
// ---- pipelined puts (iput; no reference analogue — upstream's Put is one
// synchronous round trip per unit, src/adlb.c:2811-2843). Requests carry a
// put_id echoed in the response; settle out of band, replaying rejects at
// the hinted server with the synchronous path's pacing. ------------------
int home_server(int app_rank);
int next_server();

struct PendingPut {
  std::string payload;
  int work_type, prio, target_rank, answer_rank, attempts, server;
  int backoff_ms = 0;  // ADLB_BACKOFF retry-after hint awaiting replay
};
static std::map<int64_t, PendingPut> pending_puts;
static std::vector<int64_t> resend_queue;  // rejected ids awaiting replay
static int64_t next_put_id = 1;
static int failed_puts = 0;
static bool failed_nmw = false;

static void send_iput(int64_t id, const PendingPut &pp) {
  Encoder e(T_FA_PUT, g->rank);
  e.bytes(F_PAYLOAD, pp.payload.data(), pp.payload.size())
      .i(F_WORK_TYPE, pp.work_type)
      .i(F_PRIO, pp.prio)
      .i(F_TARGET_RANK, pp.target_rank)
      .i(F_ANSWER_RANK, pp.answer_rank)
      .i(F_COMMON_LEN, 0)
      .i(F_COMMON_SERVER, -1)
      .i(F_COMMON_SEQNO, -1)
      .i(F_PUT_ID, id);
  send_msg(pp.server, e);
}

static void settle_put(const Msg &m) {  // called with g->mu held
  int64_t id = m.geti(F_PUT_ID);
  auto it = pending_puts.find(id);
  if (it == pending_puts.end()) return;
  int rc = (int)m.geti(F_RC);
  if (rc == ADLB_BACKOFF) {
    // backpressured pipelined put: replay toward the same server without
    // burning the reject budget, pacing by the server's carried hint
    // (pump_resends sleeps it with the lock released — the fixed 2 ms
    // resend pace would hammer the saturated server ~12x faster than it
    // asked for, defeating the load shedding)
    it->second.backoff_ms = (int)m.geti(F_RETRY_AFTER_MS, 25);
    resend_queue.push_back(id);
    return;
  }
  if (rc == ADLB_PUT_REJECTED && ++it->second.attempts <= 10) {
    int hint = (int)m.geti(F_HINT, -1);
    it->second.server = hint >= 0 ? hint : next_server();
    // replay happens in pump_resends() with the lock RELEASED: sleeping or
    // sending here would stall the reader threads (and abort delivery)
    resend_queue.push_back(id);
    return;
  }
  if (rc != ADLB_SUCCESS) {
    failed_puts++;
    if (rc == ADLB_NO_MORE_WORK) failed_nmw = true;
  } else if (it->second.target_rank >= 0 &&
             it->second.server != home_server(it->second.target_rank)) {
    Encoder e(T_FA_DID_PUT_AT_REMOTE, g->rank);
    e.i(F_TARGET_RANK, it->second.target_rank)
        .i(F_WORK_TYPE, it->second.work_type)
        .i(F_SERVER_RANK, it->second.server);
    send_msg(home_server(it->second.target_rank), e);
  }
  pending_puts.erase(it);
}

// Replay rejected pipelined puts queued by settle_put. Call WITHOUT g->mu:
// the pacing sleep and the (possibly connect-blocking) send must not stall
// inbound frames.
static void pump_resends() {
  for (;;) {
    int64_t id = -1;
    PendingPut copy;
    {
      std::lock_guard<std::mutex> lk(g->mu);
      while (!resend_queue.empty()) {
        int64_t cand = resend_queue.front();
        resend_queue.erase(resend_queue.begin());
        auto it = pending_puts.find(cand);
        if (it != pending_puts.end()) {
          id = cand;
          copy = it->second;
          it->second.backoff_ms = 0;  // hint consumed by this replay
          break;
        }
      }
    }
    if (id < 0) return;
    // a backpressured put sleeps the server's retry-after hint; a
    // rejected-and-rerouted one paces like the synchronous retry loop
    usleep(copy.backoff_ms > 0 ? (useconds_t)copy.backoff_ms * 1000
                               : 2000);
    send_iput(id, copy);
  }
}

// Handle a frame that is not an awaited protocol response: abort frames
// terminate, app_comm traffic is stashed, anything else is fatal.
void dispatch_passive(Msg m) {
  if (m.tag == T_TA_ABORT) {
    int code = (int)m.geti(F_CODE, ADLB_ERROR);
    fprintf(stderr, "[adlb rank %d] world aborted (code %d)\n", g->rank,
            code);
    exit(code == 0 ? 1 : (code < 0 ? -code : code));
  }
  if (m.tag == T_AM_APP) {
    g->app_inbox.push_back(std::move(m));
    return;
  }
  if (m.tag == T_TA_PUT_RESP && m.ints.count(F_PUT_ID)) {
    settle_put(m);
    return;
  }
  die("unexpected tag %u outside a pending request", m.tag);
}

Msg wait_for(uint16_t want) {
  for (;;) {
    {
      std::unique_lock<std::mutex> lk(g->mu);
      g->cv.wait(lk, [] { return !g->inbox.empty(); });
      Msg m = std::move(g->inbox.front());
      g->inbox.pop_front();
      if (m.tag == want &&
          !(m.tag == T_TA_PUT_RESP && m.ints.count(F_PUT_ID)))
        return m;
      dispatch_passive(std::move(m));
    }
    pump_resends();  // lock released: replays queued by settle_put
  }
}

int home_server(int app_rank) {
  return g->num_app_ranks + (app_rank % g->nservers);
}

int next_server() {
  // data-locality routing (the Python runtime's put_routing="home"): all
  // of this rank's untargeted puts land on its home server, the scenario
  // shape where cross-server balancing is load-bearing
  if (g->route_home) return g->home;
  int s = g->num_app_ranks + g->rr;
  g->rr = (g->rr + 1) % g->nservers;
  return s;
}

bool valid_type(int t) {
  for (int x : g->types)
    if (x == t) return true;
  return false;
}

}  // namespace

// ---- public API -----------------------------------------------------------

extern "C" {

// ---- run-time tracing: the reference's MPE profiling wrapper layer
// (reference src/adlb_prof.c — compile-time LOG_ADLB_INTERNALS per-call
// state events and LOG_GUESS_USER_STATE inferred per-type user intervals
// between Get_reserved calls), gated here by ADLB_TRACE=<path prefix> at
// run time. ADLB_Finalize writes <prefix>.<rank>.trace.json in Chrome
// trace-event format (one file per rank; concatenate the arrays to merge).
static double trace_now() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return double(ts.tv_sec) + double(ts.tv_nsec) * 1e-9;
}
struct TraceEv {
  const char *name;
  int wt;  // work type for inferred user states, -1 for API calls
  double ts, dur;
};
static bool trace_on = false;
static std::string trace_prefix;
static std::vector<TraceEv> trace_events;
static double trace_user_t0 = -1.0;
static int trace_user_wt = -1;
static int trace_last_reserved_wt = -1;

static void trace_api_entry() {
  if (!trace_on) return;
  if (trace_user_t0 >= 0) {  // close the open inferred user-state span
    trace_events.push_back(
        {"user", trace_user_wt, trace_user_t0, trace_now() - trace_user_t0});
    trace_user_t0 = -1.0;
  }
}
static void trace_call(const char *name, double t0) {
  if (!trace_on) return;
  trace_events.push_back({name, -1, t0, trace_now() - t0});
}
static void trace_got_work() {  // successful Get_reserved opens a user span
  if (!trace_on) return;
  trace_user_t0 = trace_now();
  trace_user_wt = trace_last_reserved_wt;
}
static void trace_flush(int rank) {
  if (!trace_on) return;
  trace_api_entry();
  std::string path = trace_prefix + "." + std::to_string(rank) +
                     ".trace.json";
  FILE *f = fopen(path.c_str(), "w");
  if (f == nullptr) return;
  fprintf(f, "[");
  for (size_t i = 0; i < trace_events.size(); ++i) {
    const TraceEv &e = trace_events[i];
    if (i) fprintf(f, ",");
    if (e.wt >= 0)
      fprintf(f,
              "{\"name\":\"user:type%d\",\"ph\":\"X\",\"ts\":%.3f,"
              "\"dur\":%.3f,\"pid\":%d,\"tid\":%d}",
              e.wt, e.ts * 1e6, e.dur * 1e6, rank, rank);
    else
      fprintf(f,
              "{\"name\":\"%s\",\"ph\":\"X\",\"ts\":%.3f,"
              "\"dur\":%.3f,\"pid\":%d,\"tid\":%d}",
              e.name, e.ts * 1e6, e.dur * 1e6, rank, rank);
  }
  fprintf(f, "]\n");
  fclose(f);
}

int ADLBP_Init(int num_servers, int use_debug_server, int aprintf_flag,
               int ntypes, int type_vect[], int *am_server,
               int *am_debug_server, int *num_app_ranks) {
  if (g) return ADLB_ERROR;
  if (num_servers <= 0) {
    // without this, home_server()'s rank % num_servers dies with an
    // unexplained SIGFPE (the reference asserts the same way,
    // src/adlb.c:238)
    fprintf(stderr, "adlb: num_servers must be positive (got %d)\n",
            num_servers);
    return ADLB_ERROR;
  }
  const char *rv = getenv("ADLB_RENDEZVOUS");
  const char *rk = getenv("ADLB_RANK");
  if (!rv || !rk) {
    fprintf(stderr, "adlb: ADLB_RENDEZVOUS and ADLB_RANK must be set\n");
    return ADLB_ERROR;
  }
  g = new Ctx();
  g->rank = atoi(rk);
  g->aprintf_flag = aprintf_flag;
  g->types.assign(type_vect, type_vect + ntypes);

  FILE *f = fopen(rv, "r");
  if (!f) die("cannot open rendezvous file %s", rv);
  int r, port;
  char host[256];
  int maxrank = -1;
  std::map<int, std::pair<std::string, int>> entries;
  while (fscanf(f, "%d %255s %d", &r, host, &port) == 3) {
    entries[r] = {host, port};
    if (r > maxrank) maxrank = r;
  }
  fclose(f);
  g->nranks = maxrank + 1;
  g->addr.resize(g->nranks);
  for (auto &kv : entries) g->addr[kv.first] = kv.second;
  g->nservers = num_servers;
  g->num_app_ranks = g->nranks - num_servers - (use_debug_server ? 1 : 0);
  if (g->rank < 0 || g->rank >= g->num_app_ranks)
    die("ADLB_RANK %d is not an app rank (0..%d)", g->rank,
        g->num_app_ranks - 1);
  g->home = home_server(g->rank);
  g->rr = g->rank % g->nservers;
  const char *routing = getenv("ADLB_PUT_ROUTING");
  g->route_home = (routing != nullptr && strcmp(routing, "home") == 0);

  // bind our listener at the advertised address
  g->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(g->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  struct sockaddr_in sa = {};
  sa.sin_family = AF_INET;
  sa.sin_addr.s_addr = htonl(INADDR_ANY);
  sa.sin_port = htons((uint16_t)g->addr[g->rank].second);
  if (bind(g->listen_fd, (struct sockaddr *)&sa, sizeof sa) != 0)
    die("cannot bind port %d", g->addr[g->rank].second);
  if (listen(g->listen_fd, 64) != 0) die("listen failed");
  g->acceptor = std::thread(accept_loop);

  if (am_server) *am_server = 0;
  if (am_debug_server) *am_debug_server = 0;
  if (num_app_ranks) *num_app_ranks = g->num_app_ranks;
  return ADLB_SUCCESS;
}

int ADLB_Init(int num_servers, int use_debug_server, int aprintf_flag,
              int ntypes, int type_vect[], int *am_server,
              int *am_debug_server, int *num_app_ranks) {
  int rc = ADLBP_Init(num_servers, use_debug_server, aprintf_flag, ntypes,
                      type_vect, am_server, am_debug_server, num_app_ranks);
  const char *tp = getenv("ADLB_TRACE");
  if (rc == ADLB_SUCCESS && tp != nullptr && tp[0] != '\0') {
    trace_on = true;
    trace_prefix = tp;
  }
  return rc;
}

int ADLBP_Server(double, double) { return ADLB_ERROR; }
int ADLB_Server(double a, double b) { return ADLBP_Server(a, b); }
int ADLBP_Debug_server(double) { return ADLB_ERROR; }
int ADLB_Debug_server(double t) { return ADLBP_Debug_server(t); }


int ADLBP_Put(void *work_buf, int work_len, int target_rank, int answer_rank,
              int work_type, int work_prio) {
  if (!g) return ADLB_ERROR;
  if (!valid_type(work_type)) die("Put of unregistered type %d", work_type);
  if (g->batch_active) g->batch_refcnt++;
  int server;
  if (target_rank >= 0)
    server = home_server(target_rank);
  else
    server = next_server();
  int attempts = 0;
  int rc;
  for (;;) {
    Encoder e(T_FA_PUT, g->rank);
    e.bytes(F_PAYLOAD, work_buf, (size_t)work_len)
        .i(F_WORK_TYPE, work_type)
        .i(F_PRIO, work_prio)
        .i(F_TARGET_RANK, target_rank)
        .i(F_ANSWER_RANK, answer_rank)
        .i(F_COMMON_LEN, g->batch_active ? g->batch_len : 0)
        .i(F_COMMON_SERVER, g->batch_active ? g->batch_server : -1)
        .i(F_COMMON_SEQNO, g->batch_active ? g->batch_seqno : -1);
    send_msg(server, e);
    Msg resp = wait_for(T_TA_PUT_RESP);
    rc = (int)resp.geti(F_RC);
    if (rc == ADLB_BACKOFF) {
      // overload backpressure: the fleet is above its hard watermark, so
      // hopping servers would not help — wait out the carried hint and
      // retry the SAME server without burning the reject budget
      usleep((useconds_t)resp.geti(F_RETRY_AFTER_MS, 25) * 1000);
      continue;
    }
    if (rc != ADLB_PUT_REJECTED) break;
    if (++attempts > 10) {  // reference retry loop, src/adlb.c:2779-2796
      if (g->batch_active) g->batch_refcnt--;
      return ADLB_PUT_REJECTED;
    }
    int hint = (int)resp.geti(F_HINT, -1);
    server = hint >= 0 ? hint : next_server();
    usleep(2000);
  }
  if (rc != ADLB_SUCCESS && g->batch_active) g->batch_refcnt--;
  if (rc == ADLB_SUCCESS && target_rank >= 0 &&
      server != home_server(target_rank)) {
    Encoder e(T_FA_DID_PUT_AT_REMOTE, g->rank);
    e.i(F_TARGET_RANK, target_rank)
        .i(F_WORK_TYPE, work_type)
        .i(F_SERVER_RANK, server);
    send_msg(home_server(target_rank), e);
  }
  return rc;
}
int ADLB_Put(void *b, int l, int t, int a, int w, int p) {
  if (!trace_on) return ADLBP_Put(b, l, t, a, w, p);
  trace_api_entry();
  double t0 = trace_now();
  int rc = ADLBP_Put(b, l, t, a, w, p);
  trace_call("adlb:put", t0);
  return rc;
}

static int reserve_impl(int *req_types, int *work_type, int *work_prio,
                        int *work_handle, int *work_len, int *answer_rank,
                        int hang, int fetch = 0, Msg *raw = nullptr,
                        int fetch_max = 1) {
  if (!g) return ADLB_ERROR;
  std::vector<int64_t> types;
  bool any = false;
  if (!req_types || req_types[0] == ADLB_RESERVE_REQUEST_ANY) {
    any = true;
  } else {
    for (int i = 0; i < 16 && req_types[i] != ADLB_RESERVE_EOL; i++) {
      if (!valid_type(req_types[i]))
        die("Reserve of unregistered type %d", req_types[i]);
      types.push_back(req_types[i]);
    }
    if (types.empty()) any = true;
  }
  g->rqseqno++;
  Encoder e(T_FA_RESERVE, g->rank);
  e.i(F_HANG, hang).i(F_RQSEQNO, g->rqseqno);
  if (fetch) e.i(F_FETCH, 1);
  if (fetch_max > 1) e.i(F_FETCH_MAX, fetch_max);
  if (!any) e.list(F_REQ_TYPES, types);
  send_msg(g->home, e);
  Msg resp = wait_for(T_TA_RESERVE_RESP);
  int rc = (int)resp.geti(F_RC);
  if (rc != ADLB_SUCCESS) return rc;
  if (work_type) *work_type = (int)resp.geti(F_WORK_TYPE);
  trace_last_reserved_wt = (int)resp.geti(F_WORK_TYPE);
  if (work_prio) *work_prio = (int)resp.geti(F_PRIO);
  if (work_len) *work_len = (int)resp.geti(F_WORK_LEN);
  if (answer_rank) *answer_rank = (int)resp.geti(F_ANSWER_RANK, -1);
  if (raw != nullptr) {  // fused caller inspects payload-vs-handle itself
    *raw = std::move(resp);
    return ADLB_SUCCESS;
  }
  auto it = resp.lists.find(F_HANDLE);
  if (it == resp.lists.end() || it->second.size() != ADLB_HANDLE_SIZE)
    die("malformed reserve handle");
  for (int i = 0; i < ADLB_HANDLE_SIZE; i++)
    work_handle[i] = (int)it->second[i];
  return ADLB_SUCCESS;
}

int ADLBP_Reserve(int *rt, int *wt, int *wp, int *wh, int *wl, int *ar) {
  return reserve_impl(rt, wt, wp, wh, wl, ar, 1);
}
int ADLB_Reserve(int *rt, int *wt, int *wp, int *wh, int *wl, int *ar) {
  if (!trace_on) return reserve_impl(rt, wt, wp, wh, wl, ar, 1);
  trace_api_entry();
  double t0 = trace_now();
  int rc = reserve_impl(rt, wt, wp, wh, wl, ar, 1);
  trace_call("adlb:reserve", t0);
  return rc;
}
int ADLBP_Ireserve(int *rt, int *wt, int *wp, int *wh, int *wl, int *ar) {
  return reserve_impl(rt, wt, wp, wh, wl, ar, 0);
}
int ADLB_Ireserve(int *rt, int *wt, int *wp, int *wh, int *wl, int *ar) {
  if (!trace_on) return reserve_impl(rt, wt, wp, wh, wl, ar, 0);
  trace_api_entry();
  double t0 = trace_now();
  int rc = reserve_impl(rt, wt, wp, wh, wl, ar, 0);
  trace_call("adlb:ireserve", t0);
  return rc;
}

// Fetch a batch-common prefix into *out; advances *out past the prefix.
// Shared by the Get_reserved handle path and the fused suffix+common
// reservation response (the Python server inlines only the SUFFIX of a
// prefixed unit since the remote-fused-fetch change — the client
// assembles prefix + suffix itself). Returns the server's rc: a GC'd
// prefix (reclaim edge) must surface as an error, never as a silently
// truncated payload.
static int fetch_common_prefix(int common_server, int64_t common_seqno,
                               char **out) {
  Encoder e(T_FA_GET_COMMON, g->rank);
  e.i(F_COMMON_SEQNO, common_seqno);
  send_msg(common_server, e);
  Msg resp = wait_for(T_TA_GET_COMMON_RESP);
  int rc = (int)resp.geti(F_RC, ADLB_SUCCESS);
  if (rc != ADLB_SUCCESS) return rc;
  const std::string &prefix = resp.blobs[F_PAYLOAD];
  memcpy(*out, prefix.data(), prefix.size());
  *out += prefix.size();
  return ADLB_SUCCESS;
}

int ADLBP_Get_reserved_timed(void *work_buf, int *work_handle,
                             double *time_on_queue) {
  if (!g) return ADLB_ERROR;
  // handle = {seqno, holder server, common_len, common_server, common_seqno}
  // (reference src/adlb.c:2935-2947)
  int64_t seqno = work_handle[0];
  int holder = work_handle[1];
  int common_len = work_handle[2];
  int common_server = work_handle[3];
  int64_t common_seqno = work_handle[4];
  char *out = (char *)work_buf;
  if (common_len > 0) {
    int rc = fetch_common_prefix(common_server, common_seqno, &out);
    if (rc != ADLB_SUCCESS) return rc;
  }
  Encoder e(T_FA_GET_RESERVED, g->rank);
  e.i(F_SEQNO, seqno);
  send_msg(holder, e);
  Msg resp = wait_for(T_TA_GET_RESERVED_RESP);
  int rc = (int)resp.geti(F_RC);
  // ADLB_FENCED surfaces here as-is: this rank's lease expired while it
  // was silent (lease_timeout_s armed on a Python-server world) and the
  // unit went to another worker — drop the handle and re-reserve
  if (rc != ADLB_SUCCESS) return rc;
  const std::string &payload = resp.blobs[F_PAYLOAD];
  memcpy(out, payload.data(), payload.size());
  if (time_on_queue) {
    auto it = resp.dbls.find(F_TIME_ON_Q);
    *time_on_queue = it == resp.dbls.end() ? 0.0 : it->second;
  }
  return ADLB_SUCCESS;
}
int ADLB_Get_reserved_timed(void *b, int *h, double *t) {
  if (!trace_on) return ADLBP_Get_reserved_timed(b, h, t);
  trace_api_entry();
  double t0 = trace_now();
  int rc = ADLBP_Get_reserved_timed(b, h, t);
  trace_call("adlb:get_reserved", t0);
  if (rc == ADLB_SUCCESS) trace_got_work();
  return rc;
}
int ADLBP_Get_reserved(void *b, int *h) {
  return ADLBP_Get_reserved_timed(b, h, nullptr);
}
int ADLB_Get_reserved(void *b, int *h) {
  return ADLB_Get_reserved_timed(b, h, nullptr);
}

int ADLBP_Begin_batch_put(void *common_buf, int len_common) {
  if (!g || g->batch_active) return ADLB_ERROR;
  int server = next_server();
  Encoder e(T_FA_PUT_COMMON, g->rank);
  e.bytes(F_PAYLOAD, common_buf, (size_t)len_common);
  send_msg(server, e);
  Msg resp = wait_for(T_TA_PUT_COMMON_RESP);
  int rc = (int)resp.geti(F_RC);
  if (rc != ADLB_SUCCESS) return rc;
  g->batch_active = true;
  g->batch_server = server;
  g->batch_len = len_common;
  g->batch_seqno = resp.geti(F_COMMON_SEQNO, -1);
  g->batch_refcnt = 0;
  return ADLB_SUCCESS;
}
int ADLB_Begin_batch_put(void *b, int l) { return ADLBP_Begin_batch_put(b, l); }

int ADLBP_End_batch_put(void) {
  if (!g || !g->batch_active) return ADLB_ERROR;
  Encoder e(T_FA_BATCH_DONE, g->rank);
  e.i(F_COMMON_SEQNO, g->batch_seqno).i(F_REFCNT, g->batch_refcnt);
  send_msg(g->batch_server, e);
  g->batch_active = false;
  return ADLB_SUCCESS;
}
int ADLB_End_batch_put(void) { return ADLBP_End_batch_put(); }

int ADLBP_Set_problem_done(void) {
  if (!g) return ADLB_ERROR;
  Encoder e(T_FA_NO_MORE_WORK, g->rank);
  send_msg(g->home, e);
  return ADLB_SUCCESS;
}
int ADLB_Set_problem_done(void) { return ADLBP_Set_problem_done(); }
int ADLBP_Set_no_more_work(void) { return ADLBP_Set_problem_done(); }
int ADLB_Set_no_more_work(void) { return ADLBP_Set_problem_done(); }

int ADLBP_Info_get(int key, double *value) {
  if (!g) return ADLB_ERROR;
  Encoder e(T_FA_INFO_GET, g->rank);
  e.i(F_KEY, key);
  send_msg(g->home, e);
  Msg resp = wait_for(T_TA_INFO_GET_RESP);
  if (value) {
    auto it = resp.dbls.find(F_VALUE);
    *value = it == resp.dbls.end() ? 0.0 : it->second;
  }
  return (int)resp.geti(F_RC);
}
int ADLB_Info_get(int k, double *v) { return ADLBP_Info_get(k, v); }

int ADLBP_Checkpoint(const char *path_prefix, int *units_captured) {
  // Snapshot the whole pool to <prefix>.<server>.ckpt shards (this
  // framework's extension — the reference has no pool serialization;
  // restore via the daemon's restore_path config). Blocks until every
  // server has written its shard.
  if (!g || path_prefix == nullptr) return ADLB_ERROR;
  Encoder e(T_FA_CHECKPOINT, g->rank);
  e.bytes(F_PATH, path_prefix, strlen(path_prefix));
  send_msg(g->home, e);
  Msg resp = wait_for(T_TA_CHECKPOINT_RESP);
  if (units_captured) *units_captured = (int)resp.geti(F_COUNT);
  return (int)resp.geti(F_RC);
}
int ADLB_Checkpoint(const char *p, int *n) { return ADLBP_Checkpoint(p, n); }

int ADLBP_Info_num_work_units(int work_type, int *num_units, int *num_bytes,
                              int *max_wq_count) {
  if (!g) return ADLB_ERROR;
  Encoder e(T_FA_INFO_NUM_WORK_UNITS, g->rank);
  e.i(F_WORK_TYPE, work_type);
  send_msg(g->home, e);
  Msg resp = wait_for(T_TA_INFO_NUM_RESP);
  if (num_units) *num_units = (int)resp.geti(F_COUNT);
  if (num_bytes) *num_bytes = (int)resp.geti(F_NBYTES);
  if (max_wq_count) *max_wq_count = (int)resp.geti(F_MAX_WQ);
  return (int)resp.geti(F_RC);
}
int ADLB_Info_num_work_units(int w, int *n, int *b, int *m) {
  return ADLBP_Info_num_work_units(w, n, b, m);
}

int ADLBP_Finalize(void) {
  if (!g) return ADLB_ERROR;
  if (!pending_puts.empty()) {
    // un-settled pipelined puts must land before LOCAL_APP_DONE, or the
    // shutdown ring could outrun them
    int rc = ADLBP_Flush_puts();
    if (rc != ADLB_SUCCESS && rc != ADLB_NO_MORE_WORK)
      fprintf(stderr,
              "[adlb rank %d] finalize: pipelined puts terminally "
              "rejected (rc=%d)\n", g->rank, rc);
  }
  Encoder e(T_FA_LOCAL_APP_DONE, g->rank);
  send_msg(g->home, e);
  g->closed.store(true);
  for (auto &kv : g->out_fds) {
    shutdown(kv.second, SHUT_WR);  // FIN after data; no unread inbound
    close(kv.second);
  }
  shutdown(g->listen_fd, SHUT_RDWR);
  close(g->listen_fd);
  return ADLB_SUCCESS;
}
int ADLB_Finalize(void) {
  trace_flush(g ? g->rank : -1);
  return ADLBP_Finalize();
}

int ADLBP_Abort(int code) {
  if (g) {
    Encoder e(T_FA_ABORT, g->rank);
    e.i(F_CODE, code);
    send_msg(g->home, e);
    usleep(100 * 1000);  // let the frame flush before hard exit
  }
  fprintf(stderr, "[adlb rank %d] ADLB_Abort(%d)\n", g ? g->rank : -1, code);
  exit(code == 0 ? 1 : (code < 0 ? -code : code));
}
int ADLB_Abort(int code) { return ADLBP_Abort(code); }

// ---- app <-> app messaging (the reference's app_comm: ADLB_Init returns a
// communicator for direct point-to-point traffic among app ranks, e.g.
// c1.c's TAG_B_ANSWER flow; here the same fabric carries it as AM_APP
// frames with a user tag inside) --------------------------------------------

int ADLBP_App_send(int dest_app_rank, void *buf, int len, int apptag) {
  if (!g) return ADLB_ERROR;
  if (dest_app_rank < 0 || dest_app_rank >= g->num_app_ranks)
    die("App_send: %d is not an app rank", dest_app_rank);
  Encoder e(T_AM_APP, g->rank);
  e.bytes(F_PAYLOAD, buf, (size_t)len).i(F_APPTAG, apptag);
  send_msg(dest_app_rank, e);
  return ADLB_SUCCESS;
}
int ADLB_App_send(int d, void *b, int l, int t) {
  if (!trace_on) return ADLBP_App_send(d, b, l, t);
  trace_api_entry();
  double t0 = trace_now();
  int rc = ADLBP_App_send(d, b, l, t);
  trace_call("adlb:app_send", t0);
  return rc;
}

// drain frames already delivered while idle; call with g->mu held
static void drain_inbox_locked() {
  while (!g->inbox.empty()) {
    Msg m = std::move(g->inbox.front());
    g->inbox.pop_front();
    dispatch_passive(std::move(m));
  }
}

int ADLBP_App_iprobe(int *src, int *apptag, int *len) {
  if (!g) return ADLB_ERROR;
  std::unique_lock<std::mutex> lk(g->mu);
  drain_inbox_locked();
  if (g->app_inbox.empty()) return 0;
  const Msg &m = g->app_inbox.front();
  if (src) *src = m.src;
  if (apptag) *apptag = (int)m.geti(F_APPTAG, 0);
  if (len) {
    auto it = m.blobs.find(F_PAYLOAD);
    *len = it == m.blobs.end() ? 0 : (int)it->second.size();
  }
  return 1;
}
int ADLB_App_iprobe(int *s_, int *t, int *l) {
  if (!trace_on) return ADLBP_App_iprobe(s_, t, l);
  trace_api_entry();
  double t0 = trace_now();
  int rc = ADLBP_App_iprobe(s_, t, l);
  trace_call("adlb:app_iprobe", t0);
  return rc;
}

int ADLBP_App_recv(void *buf, int maxlen, int *src, int *apptag) {
  if (!g) return ADLB_ERROR;
  std::unique_lock<std::mutex> lk(g->mu);
  for (;;) {
    drain_inbox_locked();
    if (!g->app_inbox.empty()) break;
    g->cv.wait(lk, [] { return !g->inbox.empty(); });
  }
  Msg m = std::move(g->app_inbox.front());
  g->app_inbox.pop_front();
  auto it = m.blobs.find(F_PAYLOAD);
  int n = it == m.blobs.end() ? 0 : (int)it->second.size();
  if (n > maxlen)
    die("App_recv: message of %d bytes exceeds buffer of %d", n, maxlen);
  if (n > 0) memcpy(buf, it->second.data(), (size_t)n);
  if (src) *src = m.src;
  if (apptag) *apptag = (int)m.geti(F_APPTAG, 0);
  return n;
}
int ADLB_App_recv(void *b, int m, int *s_, int *t) {
  if (!trace_on) return ADLBP_App_recv(b, m, s_, t);
  trace_api_entry();
  double t0 = trace_now();
  int rc = ADLBP_App_recv(b, m, s_, t);
  trace_call("adlb:app_recv", t0);
  return rc;
}

// ---- pipelined puts + fused reserve/get (framework extensions) ----------

int ADLBP_Iput(void *work_buf, int work_len, int target_rank, int answer_rank,
               int work_type, int work_prio) {
  if (!g) return ADLB_ERROR;
  if (!valid_type(work_type)) die("Iput of unregistered type %d", work_type);
  if (g->batch_active)
    die("Iput inside Begin_batch_put is not supported (the common-prefix "
        "refcount must be exact)");
  if (target_rank >= 0 && target_rank >= g->num_app_ranks)
    die("Iput target rank %d is not an app rank", target_rank);
  PendingPut copy;
  int64_t id;
  {
    std::unique_lock<std::mutex> lk(g->mu);
    drain_inbox_locked();  // settle delivered responses: stay bounded
    PendingPut pp;
    pp.payload.assign((const char *)work_buf, (size_t)work_len);
    pp.work_type = work_type;
    pp.prio = work_prio;
    pp.target_rank = target_rank;
    pp.answer_rank = answer_rank;
    pp.attempts = 0;
    pp.server = target_rank >= 0 ? home_server(target_rank) : next_server();
    id = next_put_id++;
    pending_puts[id] = pp;
    copy = std::move(pp);
  }
  send_iput(id, copy);  // lock released: sends may block on connect
  pump_resends();
  return ADLB_SUCCESS;
}
int ADLB_Iput(void *b, int l, int t, int a, int w, int p) {
  if (!trace_on) return ADLBP_Iput(b, l, t, a, w, p);
  trace_api_entry();
  double t0 = trace_now();
  int rc = ADLBP_Iput(b, l, t, a, w, p);
  trace_call("adlb:iput", t0);
  return rc;
}

int ADLBP_Flush_puts(void) {
  if (!g) return ADLB_ERROR;
  for (;;) {
    {
      std::unique_lock<std::mutex> lk(g->mu);
      drain_inbox_locked();
      if (pending_puts.empty() && resend_queue.empty()) break;
      if (resend_queue.empty())
        g->cv.wait_for(lk, std::chrono::milliseconds(100),
                       [] { return !g->inbox.empty(); });
    }
    pump_resends();  // lock released: pacing + sends must not stall readers
  }
  std::lock_guard<std::mutex> lk(g->mu);
  int failed = failed_puts;
  bool nmw = failed_nmw;
  failed_puts = 0;
  failed_nmw = false;
  if (nmw) return ADLB_NO_MORE_WORK;
  return failed ? ADLB_PUT_REJECTED : ADLB_SUCCESS;
}
int ADLB_Flush_puts(void) {
  if (!trace_on) return ADLBP_Flush_puts();
  trace_api_entry();
  double t0 = trace_now();
  int rc = ADLBP_Flush_puts();
  trace_call("adlb:flush_puts", t0);
  return rc;
}

int ADLBP_Get_work(int *req_types, int *work_type, int *work_prio,
                   void *work_buf, int max_len, int *work_len,
                   int *answer_rank) {
  // the single-unit call IS a 1-slot batch (scalar out-pointers are
  // 1-element arrays); one copy of the fused/handle fallback logic
  int ng = 0, wl = 0;
  int rc = ADLBP_Get_work_batch(req_types, 1, &ng, work_type, work_prio,
                                work_buf, max_len, &wl, answer_rank);
  if (work_len) *work_len = wl;
  return rc;
}
int ADLBP_Get_work_batch(int *req_types, int max_units, int *num_got,
                         int *work_types, int *work_prios,
                         void *payload_buf, int max_len_per_unit,
                         int *work_lens, int *answer_ranks) {
  if (!g) return ADLB_ERROR;
  if (max_units < 1) die("Get_work_batch: max_units must be >= 1");
  if (num_got) *num_got = 0;
  Msg resp;
  int rc = reserve_impl(req_types, nullptr, nullptr, nullptr, nullptr,
                        nullptr, /*hang=*/1, /*fetch=*/1, &resp, max_units);
  if (rc != ADLB_SUCCESS) return rc;
  char *out = (char *)payload_buf;
  auto blit = resp.blists.find(F_PAYLOADS);
  if (blit != resp.blists.end()) {  // batch-fused: all units consumed
    const std::vector<std::string> &pl = blit->second;
    if ((int)pl.size() > max_units)
      die("Get_work_batch: server sent %zu units for a %d-slot buffer",
          pl.size(), max_units);
    const std::vector<int64_t> &wt = resp.lists[F_WORK_TYPES];
    const std::vector<int64_t> &wp = resp.lists[F_PRIOS];
    const std::vector<int64_t> &ar = resp.lists[F_ANSWER_RANKS];
    for (size_t i = 0; i < pl.size(); i++) {
      int n = (int)pl[i].size();
      if (n > max_len_per_unit)
        die("Get_work_batch: payload of %d bytes exceeds per-unit buffer "
            "of %d", n, max_len_per_unit);
      memcpy(out + (size_t)i * max_len_per_unit, pl[i].data(), (size_t)n);
      if (work_lens) work_lens[i] = n;
      if (work_types && i < wt.size()) work_types[i] = (int)wt[i];
      if (work_prios && i < wp.size()) work_prios[i] = (int)wp[i];
      if (answer_ranks && i < ar.size()) answer_ranks[i] = (int)ar[i];
    }
    trace_last_reserved_wt = wt.empty() ? trace_last_reserved_wt
                                        : (int)wt[0];
    if (num_got) *num_got = (int)pl.size();
    return ADLB_SUCCESS;
  }
  // single-unit shapes (a park wake-up, a remote/prefixed fallback, or a
  // peer that ignores fetch_max)
  if (work_types) work_types[0] = (int)resp.geti(F_WORK_TYPE);
  if (work_prios) work_prios[0] = (int)resp.geti(F_PRIO);
  if (answer_ranks) answer_ranks[0] = (int)resp.geti(F_ANSWER_RANK, -1);
  auto bit = resp.blobs.find(F_PAYLOAD);
  if (bit != resp.blobs.end()) {  // fused single
    // a batch-common unit inlines only its SUFFIX + the prefix handle;
    // assemble prefix + suffix here (one extra fetch per unit — the
    // Python client amortizes it through its prefix cache)
    int common_len = (int)resp.geti(F_COMMON_LEN, 0);
    int n = (int)bit->second.size() + common_len;
    if (n > max_len_per_unit)
      die("Get_work_batch: payload of %d bytes exceeds per-unit buffer of "
          "%d", n, max_len_per_unit);
    char *w = out;
    if (common_len > 0) {
      int prc = fetch_common_prefix((int)resp.geti(F_COMMON_SERVER, -1),
                                    resp.geti(F_COMMON_SEQNO, -1), &w);
      if (prc != ADLB_SUCCESS) return prc;
    }
    memcpy(w, bit->second.data(), bit->second.size());
    if (work_lens) work_lens[0] = n;
    if (num_got) *num_got = 1;
    return ADLB_SUCCESS;
  }
  auto hit = resp.lists.find(F_HANDLE);
  if (hit == resp.lists.end() || hit->second.size() != ADLB_HANDLE_SIZE)
    die("malformed reserve handle");
  int handle[ADLB_HANDLE_SIZE];
  for (int i = 0; i < ADLB_HANDLE_SIZE; i++)
    handle[i] = (int)hit->second[i];
  int wl = (int)resp.geti(F_WORK_LEN);
  if (wl > max_len_per_unit)
    die("Get_work_batch: payload of %d bytes exceeds per-unit buffer of %d",
        wl, max_len_per_unit);
  if (work_lens) work_lens[0] = wl;
  rc = ADLBP_Get_reserved_timed(out, handle, nullptr);
  if (rc == ADLB_SUCCESS && num_got) *num_got = 1;
  return rc;
}
int ADLB_Get_work_batch(int *rt, int max_units, int *ng, int *wt, int *wp,
                        void *b, int mlpu, int *wl, int *ar) {
  if (!trace_on)
    return ADLBP_Get_work_batch(rt, max_units, ng, wt, wp, b, mlpu, wl, ar);
  trace_api_entry();
  double t0 = trace_now();
  int rc = ADLBP_Get_work_batch(rt, max_units, ng, wt, wp, b, mlpu, wl, ar);
  trace_call("adlb:get_work_batch", t0);
  return rc;
}
int ADLB_Get_work(int *rt, int *wt, int *wp, void *b, int ml, int *wl,
                  int *ar) {
  if (!trace_on) return ADLBP_Get_work(rt, wt, wp, b, ml, wl, ar);
  trace_api_entry();
  double t0 = trace_now();
  int rc = ADLBP_Get_work(rt, wt, wp, b, ml, wl, ar);
  trace_call("adlb:get_work", t0);
  if (rc == ADLB_SUCCESS) trace_got_work();
  return rc;
}

// Stamped debug printing (reference src/adlb.c:3395-3417): rank, source
// line and seconds-since-init prefix, gated by both the call-site flag and
// the aprintf_flag given to ADLB_Init.
void adlbp_dbgprintf(int flag, int linenum, const char *fmt, ...) {
  if (!flag || g == nullptr || !g->aprintf_flag) return;
  static double t0 = trace_now();
  fprintf(stderr, "[r=%d] <%d> %.6f: ", g->rank, linenum, trace_now() - t0);
  va_list ap;
  va_start(ap, fmt);
  vfprintf(stderr, fmt, ap);
  va_end(ap);
  fflush(stderr);
}

int ADLB_World_rank(void) { return g ? g->rank : -1; }
int ADLB_World_size(void) { return g ? g->nranks : -1; }
int ADLB_Num_app_ranks(void) { return g ? g->num_app_ranks : -1; }

}  // extern "C"
