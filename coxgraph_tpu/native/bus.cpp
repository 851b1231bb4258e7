// Host-level message bus — this framework's stand-in for the
// reference's ROS1 TCPROS substrate (SURVEY.md §5.8): latched pub/sub
// topics for streams (timelines, pose updates, meshes) and synchronous
// request/reply services for bulk pulls (submap requests,
// client_handler.cpp:82-160). One tiny broker + N clients over TCP;
// everything length-prefixed binary, payloads produced by the wire
// serializer (serializer.cpp) or comm/wire.py.
//
// Frame layout (little-endian):
//   u32 body_len   (bytes after this field)
//   u8  type       (1=SUB, 2=PUB, 3=ADV, 4=REQ, 5=REP)
//   u64 reqid      (REQ/REP routing id; 0 otherwise)
//   u16 topic_len
//   topic bytes
//   payload bytes
//
// The broker rewrites REQ ids so concurrent requesters can never
// collide, and routes the REP back to the original requester with its
// own id restored.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  uint8_t type = 0;
  uint64_t reqid = 0;
  std::string topic;
  std::vector<uint8_t> payload;
};

bool read_exact(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool read_frame(int fd, Frame* f) {
  uint32_t body_len;
  if (!read_exact(fd, &body_len, 4)) return false;
  if (body_len < 1 + 8 + 2 || body_len > (1u << 30)) return false;
  std::vector<uint8_t> body(body_len);
  if (!read_exact(fd, body.data(), body_len)) return false;
  f->type = body[0];
  std::memcpy(&f->reqid, body.data() + 1, 8);
  uint16_t tl;
  std::memcpy(&tl, body.data() + 9, 2);
  if (11u + tl > body_len) return false;
  f->topic.assign(reinterpret_cast<char*>(body.data() + 11), tl);
  f->payload.assign(body.begin() + 11 + tl, body.end());
  return true;
}

bool write_frame(int fd, std::mutex& wmu, const Frame& f) {
  uint16_t tl = static_cast<uint16_t>(f.topic.size());
  uint32_t body_len = 1 + 8 + 2 + tl + static_cast<uint32_t>(
      f.payload.size());
  std::vector<uint8_t> buf(4 + body_len);
  std::memcpy(buf.data(), &body_len, 4);
  buf[4] = f.type;
  std::memcpy(buf.data() + 5, &f.reqid, 8);
  std::memcpy(buf.data() + 13, &tl, 2);
  std::memcpy(buf.data() + 15, f.topic.data(), tl);
  std::memcpy(buf.data() + 15 + tl, f.payload.data(), f.payload.size());
  std::lock_guard<std::mutex> g(wmu);
  return write_exact(fd, buf.data(), buf.size());
}

// ---------------------------------------------------------------------------
// Broker
// ---------------------------------------------------------------------------

struct Broker {
  int listen_fd = -1;
  std::atomic<bool> running{true};
  std::thread accept_thread;
  std::mutex mu;  // guards all maps below
  struct Conn {
    int fd;
    std::shared_ptr<std::mutex> wmu;
  };
  std::map<int, Conn> conns;                       // fd → conn
  std::map<std::string, std::vector<int>> subs;    // topic → fds
  std::map<std::string, Frame> latched;            // topic → last PUB
  std::map<std::string, int> services;             // service → provider fd
  std::map<uint64_t, std::pair<int, uint64_t>> pending;  // bid → (fd, cid)
  std::atomic<uint64_t> next_bid{1};
  // Requests for not-yet-advertised services are parked and re-dispatched
  // when the provider's ADV arrives (ROS waitForService semantics — a
  // request racing the provider's advertisement must not fail). A reaper
  // answers expired waits with an empty REP; the grace stays well under
  // typical requester timeouts so a truly unknown service still resolves
  // to an empty reply rather than a client-side timeout.
  static constexpr int kServiceWaitMs = 1000;
  struct Waiting {
    Frame f;
    int requester_fd;
    std::chrono::steady_clock::time_point deadline;
  };
  std::map<std::string, std::vector<Waiting>> waiting;
  std::thread reaper_thread;

  void reap_loop() {
    while (running.load()) {
      std::this_thread::sleep_for(std::chrono::milliseconds(100));
      auto now = std::chrono::steady_clock::now();
      std::vector<std::pair<Conn, Frame>> expired;
      {
        std::lock_guard<std::mutex> g(mu);
        for (auto& kv : waiting) {
          auto& v = kv.second;
          for (auto it = v.begin(); it != v.end();) {
            if (it->deadline <= now) {
              auto c = conns.find(it->requester_fd);
              if (c != conns.end()) {
                Frame rep;
                rep.type = 5;
                rep.reqid = it->f.reqid;
                rep.topic = it->f.topic;
                expired.emplace_back(c->second, rep);
              }
              it = v.erase(it);
            } else {
              ++it;
            }
          }
        }
      }
      for (auto& e : expired) write_frame(e.first.fd, *e.first.wmu, e.second);
    }
  }

  void drop(int fd) {
    std::lock_guard<std::mutex> g(mu);
    conns.erase(fd);
    for (auto& kv : subs) {
      auto& v = kv.second;
      v.erase(std::remove(v.begin(), v.end(), fd), v.end());
    }
    for (auto it = services.begin(); it != services.end();) {
      if (it->second == fd) it = services.erase(it); else ++it;
    }
    for (auto& kv : waiting) {
      auto& v = kv.second;
      v.erase(std::remove_if(v.begin(), v.end(),
                             [fd](const Waiting& w) {
                               return w.requester_fd == fd;
                             }),
              v.end());
    }
    ::close(fd);
  }

  void handle(int fd, std::shared_ptr<std::mutex> wmu) {
    Frame f;
    while (running.load() && read_frame(fd, &f)) {
      switch (f.type) {
        case 1: {  // SUB — deliver the latched message if any
          Frame replay;
          bool has = false;
          {
            std::lock_guard<std::mutex> g(mu);
            subs[f.topic].push_back(fd);
            auto it = latched.find(f.topic);
            if (it != latched.end()) { replay = it->second; has = true; }
          }
          if (has) write_frame(fd, *wmu, replay);
          break;
        }
        case 2: {  // PUB — fan out to subscribers, remember (latched)
          std::vector<Conn> targets;
          {
            std::lock_guard<std::mutex> g(mu);
            latched[f.topic] = f;
            for (int sfd : subs[f.topic]) {
              auto it = conns.find(sfd);
              if (it != conns.end()) targets.push_back(it->second);
            }
          }
          for (auto& c : targets) write_frame(c.fd, *c.wmu, f);
          break;
        }
        case 3: {  // ADV — register and re-dispatch any parked requests
          std::vector<std::pair<Frame, uint64_t>> parked;
          {
            std::lock_guard<std::mutex> g(mu);
            services[f.topic] = fd;
            auto it = waiting.find(f.topic);
            if (it != waiting.end()) {
              for (auto& w : it->second) {
                uint64_t bid = next_bid.fetch_add(1);
                pending[bid] = {w.requester_fd, w.f.reqid};
                parked.emplace_back(w.f, bid);
              }
              waiting.erase(it);
            }
          }
          for (auto& p : parked) {
            Frame fwd = p.first;
            fwd.reqid = p.second;
            write_frame(fd, *wmu, fwd);
          }
          break;
        }
        case 4: {  // REQ — rewrite id, forward to provider
          // lookup and park must be ONE critical section: an ADV landing
          // between them would drain the waiting list before the park,
          // stranding the request until the reaper answers it empty
          Conn provider{-1, nullptr};
          uint64_t bid = next_bid.fetch_add(1);
          {
            std::lock_guard<std::mutex> g(mu);
            auto it = services.find(f.topic);
            if (it != services.end()) {
              auto c = conns.find(it->second);
              if (c != conns.end()) provider = c->second;
            }
            if (provider.fd >= 0) {
              pending[bid] = {fd, f.reqid};
            } else {
              // no provider yet: park until an ADV arrives or the grace
              // period expires (reaper then sends the empty REP)
              waiting[f.topic].push_back(
                  {f, fd, std::chrono::steady_clock::now() +
                              std::chrono::milliseconds(kServiceWaitMs)});
            }
          }
          if (provider.fd >= 0) {
            Frame fwd = f;
            fwd.reqid = bid;
            write_frame(provider.fd, *provider.wmu, fwd);
          }
          break;
        }
        case 5: {  // REP — route back to the requester
          Conn req{-1, nullptr};
          uint64_t cid = 0;
          {
            std::lock_guard<std::mutex> g(mu);
            auto it = pending.find(f.reqid);
            if (it != pending.end()) {
              auto c = conns.find(it->second.first);
              if (c != conns.end()) req = c->second;
              cid = it->second.second;
              pending.erase(it);
            }
          }
          if (req.fd >= 0) {
            Frame back = f;
            back.reqid = cid;
            write_frame(req.fd, *req.wmu, back);
          }
          break;
        }
        default:
          break;
      }
    }
    drop(fd);
  }

  void accept_loop() {
    while (running.load()) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) break;
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      auto wmu = std::make_shared<std::mutex>();
      {
        std::lock_guard<std::mutex> g(mu);
        conns[fd] = {fd, wmu};
      }
      std::thread(&Broker::handle, this, fd, wmu).detach();
    }
  }
};

// ---------------------------------------------------------------------------
// Client
// ---------------------------------------------------------------------------

struct Client {
  int fd = -1;
  std::mutex wmu;
  std::mutex rmu;  // one reader at a time
  std::deque<Frame> inbox;
  Frame slot;      // last message exposed to the caller
  std::atomic<uint64_t> next_id{1};

  // read one frame with timeout; -1 error, 0 timeout, 1 ok
  int read_one(Frame* f, int timeout_ms) {
    struct pollfd p = {fd, POLLIN, 0};
    int r = ::poll(&p, 1, timeout_ms);
    if (r == 0) return 0;
    if (r < 0) return -1;
    return read_frame(fd, f) ? 1 : -1;
  }
};

std::mutex g_mu;
std::vector<std::unique_ptr<Broker>> g_brokers;
std::vector<std::unique_ptr<Client>> g_clients;

}  // namespace

extern "C" {

int cox_bus_serve(uint16_t port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(port);
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, 64) < 0) {
    ::close(fd);
    return -1;
  }
  auto b = std::make_unique<Broker>();
  b->listen_fd = fd;
  b->accept_thread = std::thread(&Broker::accept_loop, b.get());
  b->reaper_thread = std::thread(&Broker::reap_loop, b.get());
  std::lock_guard<std::mutex> g(g_mu);
  g_brokers.push_back(std::move(b));
  return static_cast<int>(g_brokers.size()) - 1;
}

void cox_bus_stop(int broker) {
  std::lock_guard<std::mutex> g(g_mu);
  if (broker < 0 || broker >= static_cast<int>(g_brokers.size())) return;
  auto& b = g_brokers[broker];
  if (!b) return;
  b->running.store(false);
  ::shutdown(b->listen_fd, SHUT_RDWR);
  ::close(b->listen_fd);
  {
    std::lock_guard<std::mutex> g2(b->mu);
    for (auto& kv : b->conns) ::shutdown(kv.first, SHUT_RDWR);
  }
  if (b->accept_thread.joinable()) b->accept_thread.join();
  if (b->reaper_thread.joinable()) b->reaper_thread.join();
}

int cox_bus_connect(const char* host, uint16_t port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return -1;
  }
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    return -1;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto c = std::make_unique<Client>();
  c->fd = fd;
  std::lock_guard<std::mutex> g(g_mu);
  g_clients.push_back(std::move(c));
  return static_cast<int>(g_clients.size()) - 1;
}

static Client* cli(int h) {
  std::lock_guard<std::mutex> g(g_mu);
  if (h < 0 || h >= static_cast<int>(g_clients.size())) return nullptr;
  return g_clients[h].get();
}

void cox_bus_close(int h) {
  Client* c = cli(h);
  if (c && c->fd >= 0) {
    ::shutdown(c->fd, SHUT_RDWR);
    ::close(c->fd);
    c->fd = -1;
  }
}

static int send_simple(int h, uint8_t type, const char* topic,
                       const void* buf, uint32_t len, uint64_t reqid) {
  Client* c = cli(h);
  if (!c || c->fd < 0) return -1;
  Frame f;
  f.type = type;
  f.reqid = reqid;
  f.topic = topic ? topic : "";
  if (buf && len) {
    f.payload.assign(static_cast<const uint8_t*>(buf),
                     static_cast<const uint8_t*>(buf) + len);
  }
  return write_frame(c->fd, c->wmu, f) ? 0 : -1;
}

int cox_bus_subscribe(int h, const char* topic) {
  return send_simple(h, 1, topic, nullptr, 0, 0);
}

int cox_bus_advertise(int h, const char* service) {
  return send_simple(h, 3, service, nullptr, 0, 0);
}

int cox_bus_publish(int h, const char* topic, const void* buf,
                    uint32_t len) {
  return send_simple(h, 2, topic, buf, len, 0);
}

int cox_bus_reply(int h, uint64_t reqid, const void* buf, uint32_t len) {
  return send_simple(h, 5, "", buf, len, reqid);
}

// next inbound PUB/REQ → internal slot. Returns type (2|4), 0 timeout,
// -1 error/closed.
int cox_bus_poll(int h, int timeout_ms) {
  Client* c = cli(h);
  if (!c || c->fd < 0) return -1;
  std::lock_guard<std::mutex> g(c->rmu);
  for (;;) {
    if (!c->inbox.empty()) {
      c->slot = std::move(c->inbox.front());
      c->inbox.pop_front();
      if (c->slot.type == 5) continue;  // stale reply from a timed-out
                                        // earlier request — drop
      return c->slot.type;
    }
    Frame f;
    int r = c->read_one(&f, timeout_ms);
    if (r <= 0) return r;
    if (f.type == 5) continue;          // stale reply — drop
    c->slot = std::move(f);
    return c->slot.type;
  }
}

// blocking request; on success the REP payload lands in the slot and its
// length is returned; other messages received meanwhile queue up.
long cox_bus_request(int h, const char* service, const void* buf,
                     uint32_t len, int timeout_ms) {
  Client* c = cli(h);
  if (!c || c->fd < 0) return -1;
  uint64_t id = c->next_id.fetch_add(1);
  if (send_simple(h, 4, service, buf, len, id) != 0) return -1;
  std::lock_guard<std::mutex> g(c->rmu);
  for (;;) {
    Frame f;
    int r = c->read_one(&f, timeout_ms);
    if (r <= 0) return -1;
    if (f.type == 5) {
      if (f.reqid == id) {
        c->slot = std::move(f);
        return static_cast<long>(c->slot.payload.size());
      }
      continue;  // stale reply from a timed-out earlier request — drop
    }
    c->inbox.push_back(std::move(f));
  }
}

uint32_t cox_bus_msg_len(int h) {
  Client* c = cli(h);
  return c ? static_cast<uint32_t>(c->slot.payload.size()) : 0;
}

uint64_t cox_bus_msg_reqid(int h) {
  Client* c = cli(h);
  return c ? c->slot.reqid : 0;
}

int cox_bus_msg_topic(int h, char* buf, uint32_t cap) {
  Client* c = cli(h);
  if (!c) return -1;
  uint32_t n = static_cast<uint32_t>(c->slot.topic.size());
  if (n + 1 > cap) return -1;
  std::memcpy(buf, c->slot.topic.data(), n);
  buf[n] = 0;
  return static_cast<int>(n);
}

int cox_bus_msg_data(int h, void* buf, uint32_t cap) {
  Client* c = cli(h);
  if (!c) return -1;
  uint32_t n = static_cast<uint32_t>(c->slot.payload.size());
  if (n > cap) return -1;
  std::memcpy(buf, c->slot.payload.data(), n);
  return static_cast<int>(n);
}

}  // extern "C"
