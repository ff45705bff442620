// ssad_tpu_torch native serving front end: epoll HTTP/1.1 transport.
//
// A copy of ssad_tpu/native/http_frontend.cpp for the PyTorch/CUDA port
// (the port builds and loads its own; only this header differs).  The
// serving hot path is dominated by per-request host work, not by the
// scoring program on the card: the stdlib front end (serving/server.py)
// pays a Python thread per connection, readline-based header parsing,
// and response assembly under the GIL for every request.  This file
// moves the entire transport off the GIL — accept, non-blocking reads,
// HTTP parsing, admission control, keep-alive/pipeline sequencing,
// response serialization and writes all run on one C++ epoll thread —
// while Python (serving/native_frontend.py) only sees fully-parsed
// requests in batches and answers with small JSON bodies.
//
// Division of labor:
//   C++  : sockets, epoll, HTTP/1.1 parsing (Content-Length framing,
//          keep-alive, 100-continue), protocol errors (400/411/413/431),
//          transport-level load shedding (503 when the handoff queue is
//          full), response writing, byte/request counters.
//   Python: request semantics — routing, npy/PIL decode, dynamic
//          batching onto the scorer, drift tracking, JSON
//          payloads.  One blocking poll call drains MANY requests at
//          once (natural batching under load).
//
// Exposed C ABI (ctypes-bound in ssad_tpu_torch/serving/native_frontend.py):
//   nhf_create(host, port, max_queue, max_body)      -> handle
//   nhf_start(handle)                                -> bound port | -1
//   nhf_poll(handle, out_reqs, max_n, timeout_ms)    -> n | -1 (stopped)
//   nhf_respond(handle, id, status, body, len)       -> 0 | -1
//   nhf_stats(handle, long[8])
//   nhf_stop(handle) / nhf_destroy(handle) / nhf_probe() -> 1
//
// Memory contract: the (method, path, body) pointers a poll result
// carries stay valid until nhf_respond() is called for that id (the
// Python side copies the body into a numpy array before scoring).
// Responses may arrive from any thread, in any order across
// connections; per connection, only one request is outstanding at a
// time (reads pause until the response is written), so HTTP/1.1
// ordering holds by construction.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 http_frontend.cpp -pthread

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cctype>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// --------------------------------------------------------------------
// Small helpers
// --------------------------------------------------------------------

std::string lower(std::string s) {
  for (char& c : s) c = static_cast<char>(std::tolower(static_cast<unsigned char>(c)));
  return s;
}

const char* status_text(int code) {
  switch (code) {
    case 100: return "Continue";
    case 200: return "OK";
    case 400: return "Bad Request";
    case 404: return "Not Found";
    case 411: return "Length Required";
    case 413: return "Payload Too Large";
    case 431: return "Request Header Fields Too Large";
    case 500: return "Internal Server Error";
    case 503: return "Service Unavailable";
    case 504: return "Gateway Timeout";
    default:  return "OK";
  }
}

std::string make_response(int code, const std::string& body, bool close_conn,
                          const char* ctype = "application/json") {
  std::string r;
  r.reserve(body.size() + 128);
  r += "HTTP/1.1 ";
  r += std::to_string(code);
  r += " ";
  r += status_text(code);
  r += "\r\nContent-Type: ";
  r += ctype;
  r += "\r\nContent-Length: ";
  r += std::to_string(body.size());
  if (close_conn) r += "\r\nConnection: close";
  r += "\r\n\r\n";
  r += body;
  return r;
}

// --------------------------------------------------------------------
// Connection state machine
// --------------------------------------------------------------------

constexpr size_t kMaxHeaderBytes = 16 * 1024;

struct Request {
  int64_t id = 0;
  std::string method;
  std::string path;
  std::string body;
  bool close_after = false;  // client sent Connection: close
};

struct Conn {
  int fd = -1;
  std::string rbuf;          // unparsed input
  std::string wbuf;          // pending output
  size_t woff = 0;
  bool want_write = false;
  bool waiting_response = false;  // a request is out with Python
  int64_t pending_id = 0;         // its id (for cleanup on disconnect)
  bool close_after_write = false;
  bool peer_closed = false;       // client sent FIN (half-close): finish
                                  // answering what's buffered, then close
  // header parse scratch
  bool headers_done = false;
  Request cur;
  long content_length = -1;
  bool expect_continue = false;
};

struct Server {
  std::string host;
  int port = 0;
  int bound_port = -1;
  int max_queue = 256;
  long max_body = 64L * 1024 * 1024;

  int listen_fd = -1;
  int epoll_fd = -1;
  int wake_fd = -1;  // eventfd: responses ready / stop
  std::thread io_thread;
  std::atomic<bool> stopping{false};

  // epoll-thread-owned
  std::unordered_map<int, Conn*> conns;

  // handoff to Python (guarded by mu)
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Request*> ready;                      // parsed, not yet polled
  std::unordered_map<int64_t, Request*> out;       // polled, awaiting respond
  std::unordered_map<int64_t, int> req_conn;       // id -> conn fd
  struct Response { int64_t id; int status; std::string body; };
  std::deque<Response> responses;                  // respond() -> epoll thread
  int64_t next_id = 1;

  // stats (atomic: read from any thread)
  std::atomic<long> n_accepted{0}, n_requests{0}, n_responses{0};
  std::atomic<long> n_shed{0}, n_protocol_errors{0};
  std::atomic<long> bytes_in{0}, bytes_out{0};
};

// A half-closed peer can send nothing more: once no response is owed
// (none in flight with Python, nothing left to flush) the connection
// is finished.
bool half_closed_done(const Conn* c) {
  return c->peer_closed && !c->waiting_response &&
         c->woff == c->wbuf.size();
}

void conn_send(Server* s, Conn* c, std::string bytes) {
  c->wbuf += bytes;
  c->want_write = true;
  epoll_event ev{};
  // after a FIN the socket stays EOF-readable forever — keeping EPOLLIN
  // armed would spin the loop hot until the response is written
  ev.events = c->peer_closed ? EPOLLOUT : (EPOLLIN | EPOLLOUT);
  ev.data.fd = c->fd;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, c->fd, &ev);
}

void conn_error_response(Server* s, Conn* c, int code, const std::string& msg) {
  s->n_protocol_errors.fetch_add(1);
  std::string body = "{\"error\": \"" + msg + "\"}";
  conn_send(s, c, make_response(code, body, /*close=*/true));
  c->close_after_write = true;
  c->rbuf.clear();
  c->headers_done = false;
}

void close_conn(Server* s, Conn* c) {
  // orphan any request Python still holds: respond() becomes a no-op
  if (c->waiting_response) {
    std::lock_guard<std::mutex> lk(s->mu);
    s->req_conn.erase(c->pending_id);
  }
  epoll_ctl(s->epoll_fd, EPOLL_CTL_DEL, c->fd, nullptr);
  ::close(c->fd);
  s->conns.erase(c->fd);
  delete c;
}

// Parse as many complete requests out of c->rbuf as possible.
// Protocol violations answer via conn_error_response (which closes
// after the write) — there is no return-value close contract.
void parse_requests(Server* s, Conn* c) {
  for (;;) {
    if (c->waiting_response) return;  // one request in flight max
    if (!c->headers_done) {
      size_t end = c->rbuf.find("\r\n\r\n");
      if (end == std::string::npos) {
        if (c->rbuf.size() > kMaxHeaderBytes) {
          conn_error_response(s, c, 431, "headers too large");
        }
        return;
      }
      // request line
      size_t line_end = c->rbuf.find("\r\n");
      std::string line = c->rbuf.substr(0, line_end);
      size_t sp1 = line.find(' ');
      size_t sp2 = (sp1 == std::string::npos) ? std::string::npos
                                              : line.find(' ', sp1 + 1);
      if (sp1 == std::string::npos || sp2 == std::string::npos ||
          line.compare(sp2 + 1, 5, "HTTP/") != 0) {
        conn_error_response(s, c, 400, "malformed request line");
        return;
      }
      c->cur = Request{};
      c->cur.method = line.substr(0, sp1);
      c->cur.path = line.substr(sp1 + 1, sp2 - sp1 - 1);
      c->content_length = -1;
      c->expect_continue = false;
      bool chunked = false;
      bool bad_length = false;
      // headers
      size_t pos = line_end + 2;
      while (pos < end) {
        size_t eol = c->rbuf.find("\r\n", pos);
        std::string h = c->rbuf.substr(pos, eol - pos);
        pos = eol + 2;
        size_t colon = h.find(':');
        if (colon == std::string::npos) continue;
        std::string key = lower(h.substr(0, colon));
        size_t v = colon + 1;
        while (v < h.size() && h[v] == ' ') ++v;
        std::string val = h.substr(v);
        if (key == "content-length") {
          // strict digits-only parse: atol would coerce "-5"/garbage to
          // a value whose body bytes then desync the keep-alive stream,
          // and overflows are UB.  Any invalid length is a hard 400.
          errno = 0;
          char* endp = nullptr;
          long long cl = strtoll(val.c_str(), &endp, 10);
          if (val.empty() || endp != val.c_str() + val.size() ||
              errno == ERANGE || cl < 0) {
            bad_length = true;
          } else {
            c->content_length = static_cast<long>(
                cl > (1LL << 60) ? (1LL << 60) : cl);
          }
        } else if (key == "transfer-encoding") {
          if (lower(val).find("chunked") != std::string::npos) chunked = true;
        } else if (key == "connection") {
          if (lower(val).find("close") != std::string::npos)
            c->cur.close_after = true;
        } else if (key == "expect") {
          if (lower(val).find("100-continue") != std::string::npos)
            c->expect_continue = true;
        }
      }
      if (bad_length) {
        conn_error_response(s, c, 400, "invalid Content-Length");
        return;
      }
      if (chunked) {
        // cannot be framed below; reject AND close (unread chunked
        // bytes would desync the keep-alive stream) — mirrors the
        // stdlib front end's 411 policy
        conn_error_response(s, c, 411,
                            "chunked bodies are not supported; send "
                            "Content-Length");
        return;
      }
      if (c->content_length > s->max_body) {
        conn_error_response(s, c, 413, "body too large");
        return;
      }
      if (c->content_length < 0) c->content_length = 0;
      c->rbuf.erase(0, end + 4);
      c->headers_done = true;
      if (c->expect_continue && c->content_length > 0) {
        conn_send(s, c, "HTTP/1.1 100 Continue\r\n\r\n");
      }
    }
    // body
    if (c->rbuf.size() < static_cast<size_t>(c->content_length)) return;
    c->cur.body = c->rbuf.substr(0, c->content_length);
    c->rbuf.erase(0, c->content_length);
    c->headers_done = false;
    s->n_requests.fetch_add(1);

    // admission: shed at the transport when Python is backed up
    {
      std::lock_guard<std::mutex> lk(s->mu);
      if (static_cast<int>(s->ready.size()) >= s->max_queue) {
        s->n_shed.fetch_add(1);
        conn_send(s, c, make_response(
            503, "{\"error\": \"admission queue full (transport)\"}",
            c->cur.close_after));
        c->close_after_write = c->cur.close_after;
        continue;
      }
      Request* r = new Request(std::move(c->cur));
      r->id = s->next_id++;
      c->waiting_response = true;
      c->pending_id = r->id;
      s->req_conn[r->id] = c->fd;
      s->ready.push_back(r);
    }
    s->cv.notify_one();
  }
}

void apply_responses(Server* s) {
  std::deque<Server::Response> batch;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    batch.swap(s->responses);
  }
  for (auto& resp : batch) {
    int fd = -1;
    {
      std::lock_guard<std::mutex> lk(s->mu);
      auto it = s->req_conn.find(resp.id);
      if (it == s->req_conn.end()) {
        // connection died meanwhile — still free the orphaned request
        auto oit = s->out.find(resp.id);
        if (oit != s->out.end()) {
          delete oit->second;
          s->out.erase(oit);
        }
        continue;
      }
      fd = it->second;
      s->req_conn.erase(it);
    }
    auto cit = s->conns.find(fd);
    if (cit == s->conns.end()) continue;
    Conn* c = cit->second;
    bool close_after = false;
    {
      std::lock_guard<std::mutex> lk(s->mu);
      auto oit = s->out.find(resp.id);
      if (oit != s->out.end()) {
        close_after = oit->second->close_after;
        delete oit->second;
        s->out.erase(oit);
      }
    }
    c->waiting_response = false;
    c->close_after_write = c->close_after_write || close_after;
    conn_send(s, c, make_response(resp.status, resp.body,
                                  c->close_after_write));
    s->n_responses.fetch_add(1);
    // a pipelined next request may already sit in rbuf
    if (!c->close_after_write) parse_requests(s, c);
  }
}

void io_loop(Server* s) {
  epoll_event events[64];
  while (!s->stopping.load()) {
    int n = epoll_wait(s->epoll_fd, events, 64, 100);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    for (int i = 0; i < n; ++i) {
      int fd = events[i].data.fd;
      if (fd == s->wake_fd) {
        uint64_t tok;
        while (read(s->wake_fd, &tok, sizeof tok) > 0) {
        }
        apply_responses(s);
        continue;
      }
      if (fd == s->listen_fd) {
        for (;;) {
          int cfd = accept4(s->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          Conn* c = new Conn();
          c->fd = cfd;
          s->conns[cfd] = c;
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.fd = cfd;
          epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, cfd, &ev);
          s->n_accepted.fetch_add(1);
        }
        continue;
      }
      auto it = s->conns.find(fd);
      if (it == s->conns.end()) continue;
      Conn* c = it->second;
      bool dead = false;
      if (events[i].events & (EPOLLHUP | EPOLLERR)) dead = true;
      if (!dead && (events[i].events & EPOLLIN)) {
        char buf[64 * 1024];
        for (;;) {
          ssize_t got = recv(fd, buf, sizeof buf, 0);
          if (got > 0) {
            c->rbuf.append(buf, static_cast<size_t>(got));
            s->bytes_in.fetch_add(got);
            if (c->rbuf.size() > static_cast<size_t>(s->max_body) +
                                     kMaxHeaderBytes) {
              // rbuf is a TRANSPORT buffer bound, not a request limit:
              // several pipelined in-limit requests can legitimately
              // exceed it, and an immediate 413 here would (a) reject
              // requests the parser's own Content-Length check allows,
              // and (b) when a response is still owed, be attributed
              // to the in-flight request, breaking HTTP/1.1 ordering.
              // Stop READING instead; per-request limits are enforced
              // in order by parse_requests (413 on Content-Length >
              // max_body, 431 on oversized headers).
              if (c->waiting_response) {
                // de-arm EPOLLIN (conn_send re-arms when the pending
                // response is written) so an unread socket cannot spin
                // the loop hot while we wait
                epoll_event ev{};
                ev.events = c->want_write ? EPOLLOUT : 0;
                ev.data.fd = fd;
                epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, fd, &ev);
              }
              // waiting_response == false: parse_requests below drains
              // a complete buffered request (→ one in flight, next
              // overflow pauses) or error-closes on a violating one
              break;
            }
          } else if (got == 0) {
            // FIN: the client may have sent request+shutdown(WR) in one
            // burst (one-shot clients do) — parse and answer what is
            // buffered before closing, don't drop it on the floor
            c->peer_closed = true;
            break;
          } else {
            break;  // EAGAIN
          }
        }
        if (!dead && !c->close_after_write) {
          parse_requests(s, c);
        }
        if (!dead && c->peer_closed) {
          if (half_closed_done(c)) {
            // nothing in flight, nothing to flush: any rbuf remainder
            // is an incomplete request that can never complete
            dead = true;
          } else {
            // de-arm EPOLLIN: an EOF socket stays readable forever and
            // would spin the loop until the pending response lands
            epoll_event ev{};
            ev.events = c->want_write ? EPOLLOUT : 0;
            ev.data.fd = fd;
            epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, fd, &ev);
          }
        }
      }
      if (!dead && (events[i].events & EPOLLOUT || c->want_write)) {
        while (c->woff < c->wbuf.size()) {
          ssize_t sent = send(fd, c->wbuf.data() + c->woff,
                              c->wbuf.size() - c->woff, MSG_NOSIGNAL);
          if (sent > 0) {
            c->woff += static_cast<size_t>(sent);
            s->bytes_out.fetch_add(sent);
          } else {
            break;
          }
        }
        if (c->woff == c->wbuf.size()) {
          c->wbuf.clear();
          c->woff = 0;
          c->want_write = false;
          if (c->close_after_write || half_closed_done(c)) {
            dead = true;
          } else {
            epoll_event ev{};
            // never re-arm EPOLLIN after a FIN (EOF-readable forever);
            // a pipelined follow-up response re-arms EPOLLOUT via
            // conn_send when it arrives
            ev.events = c->peer_closed ? 0 : EPOLLIN;
            ev.data.fd = fd;
            epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, fd, &ev);
          }
        }
      }
      if (dead) close_conn(s, c);
    }
  }
  // drain: close everything, unblock pollers
  std::vector<Conn*> remaining;
  for (auto& kv : s->conns) remaining.push_back(kv.second);
  for (Conn* c : remaining) close_conn(s, c);
  if (s->listen_fd >= 0) ::close(s->listen_fd);
  s->cv.notify_all();
}

}  // namespace

// --------------------------------------------------------------------
// C ABI
// --------------------------------------------------------------------

extern "C" {

struct NhfReq {
  int64_t id;
  const char* method;
  const char* path;
  const char* body;
  int64_t body_len;
};

void* nhf_create(const char* host, int port, int max_queue, long max_body) {
  Server* s = new Server();
  s->host = host ? host : "127.0.0.1";
  s->port = port;
  if (max_queue > 0) s->max_queue = max_queue;
  if (max_body > 0) s->max_body = max_body;
  return s;
}

int nhf_start(void* h) {
  Server* s = static_cast<Server*>(h);
  s->listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (s->listen_fd < 0) return -1;
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(s->port));
  if (inet_pton(AF_INET, s->host.c_str(), &addr.sin_addr) != 1) return -1;
  if (bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) < 0)
    return -1;
  if (listen(s->listen_fd, 512) < 0) return -1;
  socklen_t alen = sizeof addr;
  getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  s->bound_port = ntohs(addr.sin_port);

  s->epoll_fd = epoll_create1(0);
  s->wake_fd = eventfd(0, EFD_NONBLOCK);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = s->listen_fd;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->listen_fd, &ev);
  ev.data.fd = s->wake_fd;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->wake_fd, &ev);
  s->io_thread = std::thread(io_loop, s);
  return s->bound_port;
}

// Blocks up to timeout_ms for ≥1 parsed request, then drains up to
// max_n without further waiting (batching under load is free).
// Returns the count, 0 on timeout, -1 once stopped.
int nhf_poll(void* h, NhfReq* out, int max_n, int timeout_ms) {
  Server* s = static_cast<Server*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  if (s->ready.empty()) {
    s->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
      return !s->ready.empty() || s->stopping.load();
    });
  }
  if (s->ready.empty()) return s->stopping.load() ? -1 : 0;
  int n = 0;
  while (n < max_n && !s->ready.empty()) {
    Request* r = s->ready.front();
    s->ready.pop_front();
    s->out[r->id] = r;
    out[n].id = r->id;
    out[n].method = r->method.c_str();
    out[n].path = r->path.c_str();
    out[n].body = r->body.data();
    out[n].body_len = static_cast<int64_t>(r->body.size());
    ++n;
  }
  return n;
}

int nhf_respond(void* h, int64_t id, int status, const char* body,
                int64_t len) {
  Server* s = static_cast<Server*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    if (s->out.find(id) == s->out.end()) return -1;
    s->responses.push_back(
        Server::Response{id, status, std::string(body, static_cast<size_t>(len))});
  }
  uint64_t tok = 1;
  ssize_t ignored = write(s->wake_fd, &tok, sizeof tok);
  (void)ignored;
  return 0;
}

void nhf_stats(void* h, long out[8]) {
  Server* s = static_cast<Server*>(h);
  out[0] = s->n_accepted.load();
  out[1] = s->n_requests.load();
  out[2] = s->n_responses.load();
  out[3] = s->n_shed.load();
  out[4] = s->n_protocol_errors.load();
  out[5] = s->bytes_in.load();
  out[6] = s->bytes_out.load();
  {
    std::lock_guard<std::mutex> lk(s->mu);
    out[7] = static_cast<long>(s->ready.size());
  }
}

void nhf_stop(void* h) {
  Server* s = static_cast<Server*>(h);
  if (s->stopping.exchange(true)) return;
  uint64_t tok = 1;
  ssize_t ignored = write(s->wake_fd, &tok, sizeof tok);
  (void)ignored;
  s->cv.notify_all();
  if (s->io_thread.joinable()) s->io_thread.join();
}

void nhf_destroy(void* h) {
  Server* s = static_cast<Server*>(h);
  nhf_stop(s);
  if (s->epoll_fd >= 0) ::close(s->epoll_fd);
  if (s->wake_fd >= 0) ::close(s->wake_fd);
  std::lock_guard<std::mutex> lk(s->mu);
  for (Request* r : s->ready) delete r;
  for (auto& kv : s->out) delete kv.second;
  delete s;
}

int nhf_probe() { return 1; }

}  // extern "C"
