// transport.cc — native RPC transport: epoll loop driven by the caller.
//
// Role-equivalent to the reference's C++ rpc transport (reference:
// src/ray/rpc/grpc_server.h, grpc_client.h — event-loop IO off the Python
// interpreter). Design differences are deliberate: the framework keeps its
// 16-byte frame header (<QQ>: request id, payload length), and the event
// loop has NO internal thread:
// rt_poll() runs epoll_wait + socket reads + frame parsing inline on the
// calling (dispatcher) thread with the GIL released, returning a BATCH of
// parsed messages per call. A message therefore takes the same number of
// thread hops as a dedicated reader thread would — none extra — while all
// connections share one dispatcher and framing costs no interpreter time.
// (A first cut used an internal C++ loop thread + event queue; the extra
// wakeup per message measurably LOST to the threaded-Python transport on
// small hosts. This caller-driven design beats both.)
//
// Threading model:
//  - rt_send: caller threads append to a per-conn write queue under that
//    conn's mutex and attempt the writev inline (latency fast-path);
//    leftovers are flushed by the poller on EPOLLOUT. epoll_ctl is
//    thread-safe and takes effect during a concurrent epoll_wait, so
//    senders arm EPOLLOUT directly — no wakeup pipe needed for data.
//  - rt_poll: single consumer. Owns accepts, connect completion, reads,
//    queued-write flushes, and conn destruction (fd close happens only
//    here or under the conn mutex, so a send can never hit a reused fd).
//  - ops queue + eventfd: connect/close/stop requests from other threads
//    that must run on the poller.
//
// Flow control: per-conn write queues block the sender above
// RT_WQ_HIGH_BYTES (callers bind this GIL-released); inbound parsing is
// bounded per poll call by the caller's max_events window — unconsumed
// frames stay queued and reads pause above RT_INQ_HIGH_BYTES.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <pthread.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <deque>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr uint64_t RT_MAX_FRAME = 1ull << 40;   // corruption guard (1 TiB)
constexpr size_t RT_WQ_HIGH_BYTES = 256ull << 20;  // sender blocks above
constexpr size_t RT_WQ_LOW_BYTES = 128ull << 20;   // ...until below this
constexpr size_t RT_INQ_HIGH_BYTES = 512ull << 20; // pause reads above
constexpr size_t RT_INQ_LOW_BYTES = 256ull << 20;  // resume below
constexpr int RT_IOV_BATCH = 64;

enum EvType : uint8_t { EV_MSG = 1, EV_ACCEPT = 2, EV_DISCONNECT = 3 };

// Fast-path frames: request id carries RT_FAST_BIT and the payload is the
// binary KV protocol below — handled entirely inside the loop (no Python,
// no pickle, no GIL). This is the head's native kv/ping service (role of
// the reference's GcsInternalKVManager, src/ray/gcs/gcs_server/
// gcs_kv_manager.h — a C++ KV the Python layer also reads directly).
//   request:  u8 op | u8 flags | u32 klen | u64 vlen | key | val
//   reply:    u8 status | u64 vlen | val
constexpr uint64_t RT_FAST_BIT = 1ull << 62;
constexpr uint64_t RT_REPLY_BIT = 1ull << 63;

enum FastOp : uint8_t {
  FOP_PUT = 1,        // flags bit0 = overwrite; status = 1 if newly created
  FOP_GET = 2,        // status = 1 hit (val follows), 0 miss
  FOP_DEL = 3,        // status = 1 if the key existed
  FOP_PING = 4,       // status = 1, val = u64 incarnation
  FOP_LEASE_ACQ = 5,  // key = u64 shape sig; status 1 + grant blob, 0 miss
  FOP_LEASE_REL = 6,  // key = u64 lease key; status 1 re-pooled, 0 unknown
};

// Native lease grant pool (role of the reference raylet's worker-lease
// grant loop, src/ray/raylet/node_manager.cc:1908 HandleRequestWorkerLease
// — redesigned: Python placement policy pre-stocks fully-formed grants per
// resource-shape signature; acquire/release in the steady state are served
// entirely inside this event loop, no Python, no pickle, no GIL).
struct FastLease {
  struct Held {
    uint64_t conn_id;
    uint64_t sig;
    std::string grant;
  };
  // sig -> FIFO of (lease_key, grant blob) ready to hand out
  std::unordered_map<uint64_t,
                     std::deque<std::pair<uint64_t, std::string>>> pools;
  // lease_key -> holder (reclaimed by Python on conn disconnect)
  std::unordered_map<uint64_t, Held> held;
  uint64_t hits = 0, misses = 0, releases = 0;
};

struct FastKV {
  std::mutex mu;  // guards kv AND lease (one lock: ops touch one or other)
  std::unordered_map<std::string, std::string> kv;
  FastLease lease;
  uint64_t incarnation = 0;
  std::atomic<uint64_t> version{0};  // bumped on mutation (persist-dirty)
};

struct rt_event {
  uint8_t type;
  uint64_t conn_id;
  uint64_t req_id;   // MSG: request id; ACCEPT: listener id
  uint64_t len;
  const char* data;  // valid until the next rt_poll on this loop
};

struct Buf {
  char* data;
  size_t len;
  size_t off;  // bytes already written
};

struct Conn {
  uint64_t id = 0;
  int fd = -1;
  bool connecting = false;  // nonblocking connect in flight
  std::atomic<bool> closed{false};
  std::shared_ptr<FastKV> fastkv;  // set at accept if the listener has one

  // ---- write side + epoll mask (guarded by mu) ----
  std::mutex mu;
  std::condition_variable wcv;  // backpressure wakeup
  std::deque<Buf> wq;
  size_t wq_bytes = 0;
  bool registered = false;   // fd added to epoll
  bool read_paused = false;     // inbound event-queue flow control
  bool read_paused_wq = false;  // outbound (reply) backlog flow control
  uint32_t cur_mask = 0;
  uint64_t last_send_ns = 0;  // burst detection for write coalescing

  // ---- read state (poller only) ----
  char hdr[16];
  size_t hdr_got = 0;
  char* body = nullptr;
  uint64_t body_len = 0;
  uint64_t body_got = 0;
  uint64_t cur_req = 0;

  ~Conn() { free(body); }
};

struct Listener {
  uint64_t id = 0;
  int fd = -1;
  int port = 0;
  std::shared_ptr<FastKV> fastkv;  // non-null once rt_fastpath_enable ran
};

struct Op {
  enum Kind { CLOSE, STOP } kind;
  uint64_t id = 0;
};

struct Event {
  uint8_t type;
  uint64_t conn_id;
  uint64_t req_id;
  char* data;
  uint64_t len;
};

struct Loop {
  int epfd = -1;
  int evfd = -1;
  std::atomic<bool> stopping{false};

  std::mutex mu;  // conns/listeners maps + op queue + id alloc
  std::unordered_map<uint64_t, std::shared_ptr<Conn>> conns;
  std::unordered_map<uint64_t, std::shared_ptr<Listener>> listeners;
  std::deque<Op> ops;
  uint64_t next_id = 1;

  // poller-owned: parsed-but-undelivered events + last batch handed out
  std::deque<Event> q;
  size_t q_bytes = 0;
  bool reads_paused = false;
  std::vector<Event> delivered;
  std::atomic<unsigned long> poller_tid{0};  // last thread inside rt_poll

  void wake() {
    uint64_t one = 1;
    ssize_t r = write(evfd, &one, 8);
    (void)r;
  }
};

void set_nodelay(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

char* dup_bytes(const char* p, size_t n) {
  char* out = static_cast<char*>(malloc(n ? n : 1));
  if (n) memcpy(out, p, n);
  return out;
}

// epoll mask from canonical conn state; call with c->mu held
void sync_mask(Loop* L, Conn* c) {
  if (c->fd < 0 || !c->registered || c->closed.load()) return;
  uint32_t mask = 0;
  if (!c->read_paused && !c->read_paused_wq) mask |= EPOLLIN;
  if (c->connecting || !c->wq.empty()) mask |= EPOLLOUT;
  if (mask == c->cur_mask) return;
  epoll_event ev{};
  ev.data.u64 = c->id;
  ev.events = mask;
  if (epoll_ctl(L->epfd, EPOLL_CTL_MOD, c->fd, &ev) == 0) c->cur_mask = mask;
}

// poller only. Closes the fd under c->mu so a concurrent inline send can
// never write to a reused fd number.
void destroy_conn(Loop* L, std::shared_ptr<Conn> c, const char* reason,
                  bool emit_event) {
  if (c->closed.exchange(true)) return;
  {
    std::lock_guard<std::mutex> g(c->mu);
    if (c->fd >= 0) {
      epoll_ctl(L->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
      close(c->fd);
      c->fd = -1;
    }
    for (auto& b : c->wq) free(b.data);
    c->wq.clear();
    c->wq_bytes = 0;
    c->wcv.notify_all();
  }
  {
    std::lock_guard<std::mutex> g(L->mu);
    L->conns.erase(c->id);
  }
  if (emit_event) {
    size_t n = strlen(reason);
    L->q.push_back(Event{EV_DISCONNECT, c->id, 0, dup_bytes(reason, n),
                         static_cast<uint64_t>(n)});
    L->q_bytes += n;
  }
}

// flush queued writes; returns false on fatal socket error
bool flush_writes(Loop* L, Conn* c) {
  std::unique_lock<std::mutex> g(c->mu);
  while (!c->wq.empty()) {
    iovec iov[RT_IOV_BATCH];
    int n = 0;
    for (auto it = c->wq.begin(); it != c->wq.end() && n < RT_IOV_BATCH;
         ++it, ++n) {
      iov[n].iov_base = it->data + it->off;
      iov[n].iov_len = it->len - it->off;
    }
    ssize_t w = writev(c->fd, iov, n);
    if (w < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      if (errno == EINTR) continue;
      return false;
    }
    size_t left = static_cast<size_t>(w);
    c->wq_bytes -= left;
    while (left > 0 && !c->wq.empty()) {
      Buf& b = c->wq.front();
      size_t avail = b.len - b.off;
      if (left >= avail) {
        left -= avail;
        free(b.data);
        c->wq.pop_front();
      } else {
        b.off += left;
        left = 0;
      }
    }
    if (c->wq_bytes < RT_WQ_LOW_BYTES) c->wcv.notify_all();
  }
  // reply backlog drained: resume reading requests from this peer
  if (c->read_paused_wq && c->wq_bytes < RT_WQ_LOW_BYTES) {
    c->read_paused_wq = false;
  }
  sync_mask(L, c);
  return true;
}

// queue one frame on a conn and kick the write path (poller or any thread;
// no backpressure wait — used for fast-path replies). Burst-coalescing
// applies as in rt_send.
void enqueue_frame(Loop* L, Conn* c, uint64_t req_id, const char* data,
                   uint64_t len) {
  char* buf = static_cast<char*>(malloc(16 + len));
  memcpy(buf, &req_id, 8);
  memcpy(buf + 8, &len, 8);
  if (len) memcpy(buf + 16, data, len);
  std::lock_guard<std::mutex> g(c->mu);
  if (c->closed.load()) {
    free(buf);
    return;
  }
  bool was_empty = c->wq.empty();
  c->wq.push_back(Buf{buf, 16 + static_cast<size_t>(len), 0});
  c->wq_bytes += 16 + len;
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  uint64_t now_ns =
      static_cast<uint64_t>(ts.tv_sec) * 1000000000ull + ts.tv_nsec;
  bool bursting = now_ns - c->last_send_ns < 200000;
  c->last_send_ns = now_ns;
  if (was_empty && !bursting && !c->connecting && c->fd >= 0) {
    iovec iov{buf, 16 + static_cast<size_t>(len)};
    ssize_t w = writev(c->fd, &iov, 1);
    if (w > 0) {
      size_t sw = static_cast<size_t>(w);
      c->wq_bytes -= sw;
      if (sw == iov.iov_len) {
        free(buf);
        c->wq.pop_front();
      } else {
        c->wq.front().off = sw;
      }
    }
  }
  sync_mask(L, c);
}

// serve one fast-path KV frame inline on the poller; consumes (frees) body
void handle_fast(Loop* L, Conn* c, uint64_t req_id, char* body,
                 uint64_t blen) {
  uint8_t status = 0;
  std::string out;
  if (blen >= 14) {
    uint8_t op = static_cast<uint8_t>(body[0]);
    uint8_t flags = static_cast<uint8_t>(body[1]);
    uint32_t klen;
    uint64_t vlen;
    memcpy(&klen, body + 2, 4);
    memcpy(&vlen, body + 6, 8);
    // overflow-safe bounds: klen/vlen are attacker-controlled; summing
    // them can wrap and a wrapped check would std::length_error (and
    // terminate) on the string constructors below
    if (klen <= blen - 14 && vlen <= blen - 14 - klen) {
      const char* key = body + 14;
      const char* val = body + 14 + klen;
      FastKV* kv = c->fastkv.get();
      std::lock_guard<std::mutex> g(kv->mu);
      switch (op) {
        case FOP_PUT: {
          auto it = kv->kv.find(std::string(key, klen));
          bool exists = it != kv->kv.end();
          if ((flags & 1) || !exists) {
            kv->kv[std::string(key, klen)] = std::string(val, vlen);
            kv->version.fetch_add(1);
          }
          status = exists ? 0 : 1;
          break;
        }
        case FOP_GET: {
          auto it = kv->kv.find(std::string(key, klen));
          if (it != kv->kv.end()) {
            status = 1;
            out = it->second;
          }
          break;
        }
        case FOP_DEL: {
          status = kv->kv.erase(std::string(key, klen)) ? 1 : 0;
          if (status) kv->version.fetch_add(1);
          break;
        }
        case FOP_PING: {
          status = 1;
          out.assign(reinterpret_cast<const char*>(&kv->incarnation), 8);
          break;
        }
        case FOP_LEASE_ACQ: {
          if (klen == 8) {
            uint64_t sig;
            memcpy(&sig, key, 8);
            FastLease& fl = kv->lease;
            auto pit = fl.pools.find(sig);
            if (pit != fl.pools.end() && !pit->second.empty()) {
              auto& front = pit->second.front();
              uint64_t lkey = front.first;
              out = std::move(front.second);
              pit->second.pop_front();
              fl.held[lkey] = FastLease::Held{c->id, sig, out};
              fl.hits++;
              status = 1;
            } else {
              fl.misses++;
            }
          }
          break;
        }
        case FOP_LEASE_REL: {
          if (klen == 8) {
            uint64_t lkey;
            memcpy(&lkey, key, 8);
            FastLease& fl = kv->lease;
            auto hit = fl.held.find(lkey);
            // only the holding connection may re-pool: a stale or
            // malicious release from another conn (e.g. a retried
            // release racing a reconnect that re-acquired the key)
            // would hand the same grant to two workers. status 0 sends
            // the caller down the Python release_lease fallback, which
            // validates ownership under the head lock.
            if (hit != fl.held.end() && hit->second.conn_id == c->id) {
              fl.pools[hit->second.sig].emplace_back(
                  lkey, std::move(hit->second.grant));
              fl.held.erase(hit);
              fl.releases++;
              status = 1;
            }
          }
          break;
        }
        default:
          break;
      }
    }
  }
  free(body);
  std::string reply;
  reply.resize(9 + out.size());
  reply[0] = static_cast<char>(status);
  uint64_t vlen = out.size();
  memcpy(&reply[1], &vlen, 8);
  if (!out.empty()) memcpy(&reply[9], out.data(), out.size());
  enqueue_frame(L, c, req_id | RT_REPLY_BIT, reply.data(), reply.size());
}

// route one completed inbound frame: fast-path KV inline, else event queue
void deliver_frame(Loop* L, Conn* c) {
  if ((c->cur_req & RT_FAST_BIT) && c->fastkv &&
      !(c->cur_req & RT_REPLY_BIT)) {
    handle_fast(L, c, c->cur_req, c->body, c->body_len);
    // fast replies bypass the event queue, so the inbound q_bytes pause
    // never fires for them — bound the REPLY backlog instead: stop
    // reading a peer that streams requests faster than it drains replies
    // (resumed by flush_writes once wq falls below the low-water mark)
    if (c->wq_bytes > RT_WQ_HIGH_BYTES) {
      std::lock_guard<std::mutex> g(c->mu);
      c->read_paused_wq = true;
      sync_mask(L, c);
    }
  } else {
    L->q.push_back(Event{EV_MSG, c->id, c->cur_req, c->body, c->body_len});
    L->q_bytes += c->body_len;
  }
  c->body = nullptr;
  c->hdr_got = 0;
}

// read everything available; append MSG events. Returns false when the
// conn died (peer closed or protocol violation).
bool drain_reads(Loop* L, Conn* c) {
  char buf[256 * 1024];
  for (;;) {
    // fast path: read large bodies straight into their destination buffer
    if (c->hdr_got == 16 && c->body_len - c->body_got >= sizeof(buf)) {
      ssize_t r =
          read(c->fd, c->body + c->body_got, c->body_len - c->body_got);
      if (r == 0) return false;
      if (r < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) return true;
        if (errno == EINTR) continue;
        return false;
      }
      c->body_got += static_cast<uint64_t>(r);
    } else {
      ssize_t r = read(c->fd, buf, sizeof(buf));
      if (r == 0) return false;
      if (r < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) return true;
        if (errno == EINTR) continue;
        return false;
      }
      size_t off = 0;
      size_t got = static_cast<size_t>(r);
      while (off < got) {
        if (c->hdr_got < 16) {
          size_t take = std::min(16 - c->hdr_got, got - off);
          memcpy(c->hdr + c->hdr_got, buf + off, take);
          c->hdr_got += take;
          off += take;
          if (c->hdr_got < 16) break;  // need more header bytes
          memcpy(&c->cur_req, c->hdr, 8);
          memcpy(&c->body_len, c->hdr + 8, 8);
          if (c->body_len > RT_MAX_FRAME) return false;  // desynced stream
          c->body = static_cast<char*>(malloc(c->body_len ? c->body_len : 1));
          if (c->body == nullptr) return false;  // treat like corruption:
          c->body_got = 0;                       // kill the conn, not us
        }
        size_t take =
            std::min<uint64_t>(c->body_len - c->body_got, got - off);
        memcpy(c->body + c->body_got, buf + off, take);
        c->body_got += take;
        off += take;
        if (c->body_got == c->body_len) {
          deliver_frame(L, c);
        }
      }
    }
    if (c->hdr_got == 16 && c->body != nullptr && c->body_got == c->body_len) {
      deliver_frame(L, c);
    }
    if (L->q_bytes > RT_INQ_HIGH_BYTES) {
      // inbound pressure: stop reading this conn; resumed once the caller
      // drains the parsed queue below the low-water mark
      std::lock_guard<std::mutex> g(c->mu);
      c->read_paused = true;
      L->reads_paused = true;
      sync_mask(L, c);
      return true;
    }
  }
}

void handle_accept(Loop* L, Listener* lst) {
  for (;;) {
    sockaddr_storage ss{};
    socklen_t sl = sizeof(ss);
    int fd = accept4(lst->fd, reinterpret_cast<sockaddr*>(&ss), &sl,
                     SOCK_NONBLOCK | SOCK_CLOEXEC);
    if (fd < 0) return;
    set_nodelay(fd);
    auto c = std::make_shared<Conn>();
    c->fd = fd;
    c->fastkv = lst->fastkv;
    {
      std::lock_guard<std::mutex> g(L->mu);
      c->id = L->next_id++;
      L->conns[c->id] = c;
    }
    {
      std::lock_guard<std::mutex> g(c->mu);
      epoll_event ev{};
      ev.data.u64 = c->id;
      ev.events = EPOLLIN;
      epoll_ctl(L->epfd, EPOLL_CTL_ADD, fd, &ev);
      c->registered = true;
      c->cur_mask = EPOLLIN;
    }
    char peer[64] = "?";
    if (ss.ss_family == AF_INET) {
      auto* in = reinterpret_cast<sockaddr_in*>(&ss);
      char ip[INET_ADDRSTRLEN];
      inet_ntop(AF_INET, &in->sin_addr, ip, sizeof(ip));
      snprintf(peer, sizeof(peer), "%s:%d", ip, ntohs(in->sin_port));
    }
    size_t n = strlen(peer);
    L->q.push_back(Event{EV_ACCEPT, c->id, lst->id, dup_bytes(peer, n),
                         static_cast<uint64_t>(n)});
    L->q_bytes += n;
  }
}

void process_ops(Loop* L) {
  std::deque<Op> ops;
  {
    std::lock_guard<std::mutex> g(L->mu);
    ops.swap(L->ops);
  }
  for (auto& op : ops) {
    if (op.kind == Op::STOP) {
      L->stopping.store(true);
      continue;
    }
    std::shared_ptr<Conn> c;
    {
      std::lock_guard<std::mutex> g(L->mu);
      auto it = L->conns.find(op.id);
      if (it != L->conns.end()) c = it->second;
    }
    if (op.kind == Op::CLOSE && c) {
      destroy_conn(L, c, "closed locally", false);
    }
  }
}

// one epoll pass; parses frames into L->q
void poll_io(Loop* L, int timeout_ms) {
  epoll_event evs[128];
  int n = epoll_wait(L->epfd, evs, 128, timeout_ms);
  if (n <= 0) return;
  for (int i = 0; i < n; i++) {
    uint64_t id = evs[i].data.u64;
    if (id == 0) {  // eventfd: ops pending
      uint64_t junk;
      ssize_t r = read(L->evfd, &junk, 8);
      (void)r;
      process_ops(L);
      continue;
    }
    std::shared_ptr<Conn> c;
    std::shared_ptr<Listener> lst;
    {
      std::lock_guard<std::mutex> g(L->mu);
      auto it = L->conns.find(id);
      if (it != L->conns.end()) {
        c = it->second;
      } else {
        auto lit = L->listeners.find(id);
        if (lit != L->listeners.end()) lst = lit->second;
      }
    }
    if (lst) {
      handle_accept(L, lst.get());
      continue;
    }
    if (!c || c->closed.load()) continue;
    uint32_t flags = evs[i].events;
    if (flags & EPOLLERR) {
      destroy_conn(L, c,
                   c->connecting ? "connection refused" : "socket error",
                   true);
      continue;
    }
    if (flags & EPOLLOUT) {
      if (c->connecting) {
        int err = 0;
        socklen_t el = sizeof(err);
        getsockopt(c->fd, SOL_SOCKET, SO_ERROR, &err, &el);
        if (err != 0) {
          destroy_conn(L, c, "connection refused", true);
          continue;
        }
        c->connecting = false;
        {
          std::lock_guard<std::mutex> g(c->mu);
          sync_mask(L, c.get());
        }
      }
      if (!flush_writes(L, c.get())) {
        destroy_conn(L, c, "write failed: peer gone", true);
        continue;
      }
    }
    if (flags & (EPOLLIN | EPOLLHUP)) {
      if (!drain_reads(L, c.get())) {
        destroy_conn(L, c, "peer closed", true);
        continue;
      }
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI

extern "C" {

void* rt_loop_new(void) {
  auto* L = new Loop();
  L->epfd = epoll_create1(EPOLL_CLOEXEC);
  L->evfd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
  epoll_event ev{};
  ev.data.u64 = 0;  // id 0 reserved for the eventfd
  ev.events = EPOLLIN;
  epoll_ctl(L->epfd, EPOLL_CTL_ADD, L->evfd, &ev);
  return L;
}

void rt_loop_free(void* loop) {
  auto* L = static_cast<Loop*>(loop);
  L->stopping.store(true);
  std::lock_guard<std::mutex> g(L->mu);
  for (auto& kv : L->conns) {
    bool was_closed = kv.second->closed.exchange(true);
    std::lock_guard<std::mutex> wg(kv.second->mu);
    if (!was_closed && kv.second->fd >= 0) close(kv.second->fd);
    kv.second->fd = -1;
    for (auto& b : kv.second->wq) free(b.data);
    kv.second->wq.clear();
    kv.second->wcv.notify_all();
  }
  for (auto& kv : L->listeners) close(kv.second->fd);
  for (auto& e : L->delivered) free(e.data);
  for (auto& e : L->q) free(e.data);
  close(L->epfd);
  close(L->evfd);
  // L itself leaks deliberately: another thread may still be inside an
  // rt_send that looked the loop up; process teardown reclaims it
}

// returns listener id (>0) or 0 on failure
uint64_t rt_listen(void* loop, const char* host, int port) {
  auto* L = static_cast<Loop*>(loop);
  int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
  if (fd < 0) return 0;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
  }
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 1024) != 0) {
    close(fd);
    return 0;
  }
  sockaddr_in got{};
  socklen_t gl = sizeof(got);
  getsockname(fd, reinterpret_cast<sockaddr*>(&got), &gl);
  auto lst = std::make_shared<Listener>();
  lst->fd = fd;
  lst->port = ntohs(got.sin_port);
  uint64_t id;
  {
    std::lock_guard<std::mutex> g(L->mu);
    id = L->next_id++;
    lst->id = id;
    L->listeners[id] = lst;
  }
  epoll_event ev{};
  ev.data.u64 = id;
  ev.events = EPOLLIN;
  epoll_ctl(L->epfd, EPOLL_CTL_ADD, fd, &ev);
  return id;
}

int rt_listen_port(void* loop, uint64_t listener_id) {
  auto* L = static_cast<Loop*>(loop);
  std::lock_guard<std::mutex> g(L->mu);
  auto it = L->listeners.find(listener_id);
  return it == L->listeners.end() ? -1 : it->second->port;
}

// ---- fast-path KV (native head kv/ping service + direct host access) ----

static std::shared_ptr<FastKV> find_fastkv(Loop* L, uint64_t listener_id) {
  std::lock_guard<std::mutex> g(L->mu);
  auto it = L->listeners.find(listener_id);
  return it == L->listeners.end() ? nullptr : it->second->fastkv;
}

int rt_fastpath_enable(void* loop, uint64_t listener_id,
                       uint64_t incarnation) {
  auto* L = static_cast<Loop*>(loop);
  std::lock_guard<std::mutex> g(L->mu);
  auto it = L->listeners.find(listener_id);
  if (it == L->listeners.end()) return -1;
  if (!it->second->fastkv) it->second->fastkv = std::make_shared<FastKV>();
  it->second->fastkv->incarnation = incarnation;
  return 0;
  // NOTE: conns accepted BEFORE enable keep a null fastkv and route fast
  // frames to Python (no handler -> error reply); enable before serving.
}

// returns 1 if newly created, 0 if key existed (value replaced only when
// overwrite), -1 if no fastpath
int rt_fastpath_put(void* loop, uint64_t listener_id, const char* key,
                    uint32_t klen, const char* val, uint64_t vlen,
                    int overwrite) {
  auto kv = find_fastkv(static_cast<Loop*>(loop), listener_id);
  if (!kv) return -1;
  std::lock_guard<std::mutex> g(kv->mu);
  auto it = kv->kv.find(std::string(key, klen));
  bool exists = it != kv->kv.end();
  if (overwrite || !exists) {
    kv->kv[std::string(key, klen)] = std::string(val, vlen);
    kv->version.fetch_add(1);
  }
  return exists ? 0 : 1;
}

// returns 1 hit (out/out_len set, free with rt_buf_free), 0 miss, -1 no fp
int rt_fastpath_get(void* loop, uint64_t listener_id, const char* key,
                    uint32_t klen, char** out, uint64_t* out_len) {
  auto kv = find_fastkv(static_cast<Loop*>(loop), listener_id);
  if (!kv) return -1;
  std::lock_guard<std::mutex> g(kv->mu);
  auto it = kv->kv.find(std::string(key, klen));
  if (it == kv->kv.end()) return 0;
  *out = dup_bytes(it->second.data(), it->second.size());
  *out_len = it->second.size();
  return 1;
}

int rt_fastpath_del(void* loop, uint64_t listener_id, const char* key,
                    uint32_t klen) {
  auto kv = find_fastkv(static_cast<Loop*>(loop), listener_id);
  if (!kv) return -1;
  std::lock_guard<std::mutex> g(kv->mu);
  bool hit = kv->kv.erase(std::string(key, klen)) > 0;
  if (hit) kv->version.fetch_add(1);
  return hit ? 1 : 0;
}

uint64_t rt_fastpath_version(void* loop, uint64_t listener_id) {
  auto kv = find_fastkv(static_cast<Loop*>(loop), listener_id);
  return kv ? kv->version.load() : 0;
}

// dump the whole table: (u32 klen, key, u64 vlen, val)*; free via
// rt_buf_free. Returns entry count, -1 if no fastpath.
int64_t rt_fastpath_dump(void* loop, uint64_t listener_id, char** out,
                         uint64_t* out_len) {
  auto kv = find_fastkv(static_cast<Loop*>(loop), listener_id);
  if (!kv) return -1;
  std::lock_guard<std::mutex> g(kv->mu);
  size_t total = 0;
  for (auto& e : kv->kv) total += 12 + e.first.size() + e.second.size();
  char* buf = static_cast<char*>(malloc(total ? total : 1));
  char* p = buf;
  for (auto& e : kv->kv) {
    uint32_t kl = e.first.size();
    uint64_t vl = e.second.size();
    memcpy(p, &kl, 4);
    p += 4;
    memcpy(p, e.first.data(), kl);
    p += kl;
    memcpy(p, &vl, 8);
    p += 8;
    memcpy(p, e.second.data(), vl);
    p += vl;
  }
  *out = buf;
  *out_len = total;
  return static_cast<int64_t>(kv->kv.size());
}

// keys-only dump with C-side prefix filter: (u32 klen, key)*; free via
// rt_buf_free. Values never cross the boundary (they can be megabytes).
// Returns matching-key count, -1 if no fastpath.
int64_t rt_fastpath_keys(void* loop, uint64_t listener_id,
                         const char* prefix, uint32_t plen, char** out,
                         uint64_t* out_len) {
  auto kv = find_fastkv(static_cast<Loop*>(loop), listener_id);
  if (!kv) return -1;
  std::lock_guard<std::mutex> g(kv->mu);
  size_t total = 0;
  int64_t n = 0;
  for (auto& e : kv->kv) {
    if (e.first.size() >= plen && memcmp(e.first.data(), prefix, plen) == 0) {
      total += 4 + e.first.size();
      n++;
    }
  }
  char* buf = static_cast<char*>(malloc(total ? total : 1));
  char* p = buf;
  for (auto& e : kv->kv) {
    if (e.first.size() >= plen && memcmp(e.first.data(), prefix, plen) == 0) {
      uint32_t kl = e.first.size();
      memcpy(p, &kl, 4);
      p += 4;
      memcpy(p, e.first.data(), kl);
      p += kl;
    }
  }
  *out = buf;
  *out_len = total;
  return n;
}

void rt_buf_free(char* p) { free(p); }

// ---- fast-path lease pool (host-side policy APIs; see FastLease above) ----

// deposit one ready grant into the pool for `sig`. 0 ok, -1 no fastpath.
int rt_fastlease_stock(void* loop, uint64_t listener_id, uint64_t sig,
                       uint64_t lease_key, const char* grant, uint64_t glen) {
  auto kv = find_fastkv(static_cast<Loop*>(loop), listener_id);
  if (!kv) return -1;
  std::lock_guard<std::mutex> g(kv->mu);
  kv->lease.pools[sig].emplace_back(lease_key, std::string(grant, glen));
  return 0;
}

// pop one pooled (un-held) grant back out, e.g. for idle drain.
// 1 popped (out_key/out/out_len set, free out via rt_buf_free), 0 empty,
// -1 no fastpath.
int rt_fastlease_unstock(void* loop, uint64_t listener_id, uint64_t sig,
                         uint64_t* out_key, char** out, uint64_t* out_len) {
  auto kv = find_fastkv(static_cast<Loop*>(loop), listener_id);
  if (!kv) return -1;
  std::lock_guard<std::mutex> g(kv->mu);
  auto pit = kv->lease.pools.find(sig);
  if (pit == kv->lease.pools.end() || pit->second.empty()) return 0;
  auto& back = pit->second.back();  // LIFO: keep the hottest grants pooled
  *out_key = back.first;
  *out = dup_bytes(back.second.data(), back.second.size());
  *out_len = back.second.size();
  pit->second.pop_back();
  return 1;
}

// drop lease_key wherever it is (worker died / node lost):
// 2 = removed from held, 1 = removed from a pool, 0 = unknown, -1 = no fp.
int rt_fastlease_invalidate(void* loop, uint64_t listener_id,
                            uint64_t lease_key) {
  auto kv = find_fastkv(static_cast<Loop*>(loop), listener_id);
  if (!kv) return -1;
  std::lock_guard<std::mutex> g(kv->mu);
  if (kv->lease.held.erase(lease_key)) return 2;
  for (auto& p : kv->lease.pools) {
    for (auto it = p.second.begin(); it != p.second.end(); ++it) {
      if (it->first == lease_key) {
        p.second.erase(it);
        return 1;
      }
    }
  }
  return 0;
}

// reclaim every grant held by a disconnected conn. Out buffer:
// (u64 lease_key, u64 sig, u64 blen, blob)* — free via rt_buf_free.
// Returns reclaimed count, -1 if no fastpath.
int64_t rt_fastlease_reclaim_conn(void* loop, uint64_t listener_id,
                                  uint64_t conn_id, char** out,
                                  uint64_t* out_len) {
  auto kv = find_fastkv(static_cast<Loop*>(loop), listener_id);
  if (!kv) return -1;
  std::lock_guard<std::mutex> g(kv->mu);
  size_t total = 0;
  int64_t n = 0;
  for (auto& e : kv->lease.held) {
    if (e.second.conn_id == conn_id) {
      total += 24 + e.second.grant.size();
      n++;
    }
  }
  char* buf = static_cast<char*>(malloc(total ? total : 1));
  char* p = buf;
  for (auto it = kv->lease.held.begin(); it != kv->lease.held.end();) {
    if (it->second.conn_id == conn_id) {
      uint64_t lkey = it->first, sig = it->second.sig,
               blen = it->second.grant.size();
      memcpy(p, &lkey, 8);
      memcpy(p + 8, &sig, 8);
      memcpy(p + 16, &blen, 8);
      memcpy(p + 24, it->second.grant.data(), blen);
      p += 24 + blen;
      it = kv->lease.held.erase(it);
    } else {
      ++it;
    }
  }
  *out = buf;
  *out_len = total;
  return n;
}

// pooled (un-held, grantable) entries: (u64 sig, u64 lease_key)* — free
// via rt_buf_free. Returns count, -1 if no fastpath. Lets Python report
// pooled capacity as AVAILABLE (it is reclaimable in one drain call).
int64_t rt_fastlease_pooled(void* loop, uint64_t listener_id, char** out,
                            uint64_t* out_len) {
  auto kv = find_fastkv(static_cast<Loop*>(loop), listener_id);
  if (!kv) return -1;
  std::lock_guard<std::mutex> g(kv->mu);
  size_t n = 0;
  for (auto& p : kv->lease.pools) n += p.second.size();
  char* buf = static_cast<char*>(malloc(n ? n * 16 : 1));
  char* w = buf;
  for (auto& p : kv->lease.pools) {
    for (auto& e : p.second) {
      memcpy(w, &p.first, 8);
      memcpy(w + 8, &e.first, 8);
      w += 16;
    }
  }
  *out = buf;
  *out_len = n * 16;
  return static_cast<int64_t>(n);
}

// out4 = {hits, misses, pooled_total, held_total}. 0 ok, -1 no fastpath.
int rt_fastlease_stats(void* loop, uint64_t listener_id, uint64_t* out4) {
  auto kv = find_fastkv(static_cast<Loop*>(loop), listener_id);
  if (!kv) return -1;
  std::lock_guard<std::mutex> g(kv->mu);
  uint64_t pooled = 0;
  for (auto& p : kv->lease.pools) pooled += p.second.size();
  out4[0] = kv->lease.hits;
  out4[1] = kv->lease.misses;
  out4[2] = pooled;
  out4[3] = kv->lease.held.size();
  return 0;
}

// pool depth for one sig. -1 if no fastpath.
int64_t rt_fastlease_depth(void* loop, uint64_t listener_id, uint64_t sig) {
  auto kv = find_fastkv(static_cast<Loop*>(loop), listener_id);
  if (!kv) return -1;
  std::lock_guard<std::mutex> g(kv->mu);
  auto pit = kv->lease.pools.find(sig);
  return pit == kv->lease.pools.end()
             ? 0
             : static_cast<int64_t>(pit->second.size());
}

// resolve + start a nonblocking connect; the poller completes it.
// Returns conn id (>0), or 0 if the address didn't resolve.
uint64_t rt_connect(void* loop, const char* host, int port) {
  auto* L = static_cast<Loop*>(loop);
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portbuf[16];
  snprintf(portbuf, sizeof(portbuf), "%d", port);
  addrinfo* res = nullptr;
  if (getaddrinfo(host, portbuf, &hints, &res) != 0 || res == nullptr) {
    return 0;
  }
  auto c = std::make_shared<Conn>();
  {
    std::lock_guard<std::mutex> g(L->mu);
    c->id = L->next_id++;
    L->conns[c->id] = c;
  }
  int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
  if (fd < 0) {
    freeaddrinfo(res);
    std::lock_guard<std::mutex> g(L->mu);
    L->conns.erase(c->id);
    return 0;
  }
  set_nodelay(fd);
  int rc = connect(fd, res->ai_addr, res->ai_addrlen);
  freeaddrinfo(res);
  std::lock_guard<std::mutex> g(c->mu);
  c->fd = fd;
  if (rc == 0) {
    c->connecting = false;
  } else if (errno == EINPROGRESS) {
    c->connecting = true;
  } else {
    // immediate refusal: keep the conn registered and let the poller
    // deliver the DISCONNECT via EPOLLERR after ADD below
    c->connecting = true;
  }
  epoll_event ev{};
  ev.data.u64 = c->id;
  ev.events = EPOLLIN | (c->connecting ? EPOLLOUT : 0);
  epoll_ctl(L->epfd, EPOLL_CTL_ADD, fd, &ev);
  c->registered = true;
  c->cur_mask = ev.events;
  return c->id;
}

// 0 = ok, -1 = unknown/closed conn
int rt_send(void* loop, uint64_t conn_id, uint64_t req_id, const char* data,
            uint64_t len) {
  auto* L = static_cast<Loop*>(loop);
  std::shared_ptr<Conn> c;
  {
    std::lock_guard<std::mutex> g(L->mu);
    auto it = L->conns.find(conn_id);
    if (it != L->conns.end()) c = it->second;
  }
  if (!c || c->closed.load()) return -1;
  char* buf = static_cast<char*>(malloc(16 + len));
  memcpy(buf, &req_id, 8);
  memcpy(buf + 8, &len, 8);
  if (len) memcpy(buf + 16, data, len);
  std::unique_lock<std::mutex> g(c->mu);
  // Backpressure: block until the poller drains the queue. Exemptions keep
  // it deadlock-free: the poller thread itself must never wait (it is the
  // only flusher), tiny control frames pass (a blocked GIL-holding sender
  // of small frames would freeze the Python side that drives the poller),
  // and the wait is bounded — unbounded memory is worse than a stall, but
  // a stall must not be forever.
  if (len >= 65536 &&
      L->poller_tid.load() != (unsigned long)pthread_self()) {
    int waited_ms = 0;
    while (c->wq_bytes > RT_WQ_HIGH_BYTES && !c->closed.load() &&
           waited_ms < 10000) {
      c->wcv.wait_for(g, std::chrono::milliseconds(200));
      waited_ms += 200;
    }
  }
  if (c->closed.load()) {
    free(buf);
    return -1;
  }
  bool was_empty = c->wq.empty();
  c->wq.push_back(Buf{buf, 16 + static_cast<size_t>(len), 0});
  c->wq_bytes += 16 + len;
  // Burst detection: every small writev to a watched socket wakes the
  // receiver process — on a busy single-CPU host that's a ~100µs scheduler
  // round-trip PER FRAME. If another send hit this conn within the last
  // 200µs we are in a burst: leave the frame queued so the poller flushes
  // many frames in ONE writev (receiver wakes once per batch). Isolated
  // sends keep the inline write for latency.
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  uint64_t now_ns =
      static_cast<uint64_t>(ts.tv_sec) * 1000000000ull + ts.tv_nsec;
  bool bursting = now_ns - c->last_send_ns < 200000;
  c->last_send_ns = now_ns;
  if (was_empty && !bursting && !c->connecting && c->fd >= 0) {
    // latency fast-path: try the write inline; leftovers flushed on
    // EPOLLOUT by the poller
    iovec iov{buf, 16 + static_cast<size_t>(len)};
    ssize_t w = writev(c->fd, &iov, 1);
    if (w > 0) {
      size_t sw = static_cast<size_t>(w);
      c->wq_bytes -= sw;
      if (sw == iov.iov_len) {
        free(buf);
        c->wq.pop_front();
      } else {
        c->wq.front().off = sw;
      }
    }
    // fatal errors surface via the poller (EPOLLERR/read) — frame stays
    // queued and is dropped at destroy
  }
  sync_mask(L, c.get());  // arms EPOLLOUT if bytes remain queued
  return 0;
}

void rt_close_conn(void* loop, uint64_t conn_id) {
  auto* L = static_cast<Loop*>(loop);
  {
    std::lock_guard<std::mutex> g(L->mu);
    if (L->conns.find(conn_id) == L->conns.end()) return;
    L->ops.push_back(Op{Op::CLOSE, conn_id});
  }
  L->wake();
}

void rt_close_listener(void* loop, uint64_t listener_id) {
  auto* L = static_cast<Loop*>(loop);
  std::shared_ptr<Listener> lst;
  {
    std::lock_guard<std::mutex> g(L->mu);
    auto it = L->listeners.find(listener_id);
    if (it == L->listeners.end()) return;
    lst = it->second;
    L->listeners.erase(it);
  }
  epoll_ctl(L->epfd, EPOLL_CTL_DEL, lst->fd, nullptr);
  close(lst->fd);
}

// Single consumer. Frees payloads handed out by the PREVIOUS call, runs
// one IO pass (epoll + reads, GIL released by the ctypes binding), and
// returns up to max_events parsed messages.
int rt_poll(void* loop, rt_event* out, int max_events, int timeout_ms) {
  auto* L = static_cast<Loop*>(loop);
  L->poller_tid.store((unsigned long)pthread_self());
  for (auto& e : L->delivered) free(e.data);
  L->delivered.clear();
  if (L->stopping.load()) return 0;
  if (L->q.empty()) {
    poll_io(L, timeout_ms);
  } else if (static_cast<int>(L->q.size()) < max_events) {
    poll_io(L, 0);  // opportunistic top-up, no sleep
  }
  int n = 0;
  while (!L->q.empty() && n < max_events) {
    Event e = L->q.front();
    L->q.pop_front();
    L->q_bytes -= e.len;
    out[n].type = e.type;
    out[n].conn_id = e.conn_id;
    out[n].req_id = e.req_id;
    out[n].len = e.len;
    out[n].data = e.data;
    n++;
    L->delivered.push_back(e);
  }
  if (L->reads_paused && L->q_bytes < RT_INQ_LOW_BYTES) {
    L->reads_paused = false;
    std::lock_guard<std::mutex> g(L->mu);
    for (auto& kv : L->conns) {
      std::lock_guard<std::mutex> cg(kv.second->mu);
      if (kv.second->read_paused) {
        kv.second->read_paused = false;
        sync_mask(L, kv.second.get());
      }
    }
  }
  return n;
}

}  // extern "C"
