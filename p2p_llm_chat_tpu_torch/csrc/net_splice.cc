// Bidirectional socket splice for the relay's circuit data plane
// (p2p_llm_chat_tpu_torch/relay.py). One blocking C call pumps both directions
// of a circuit with poll() + nonblocking IO until both sides close or the
// circuit idles out — replacing two Python threads per circuit whose
// recv/sendall loops serialise on the GIL. Consumed via ctypes
// (utils/native.py); the Python pump stays as the fallback.
//
// C ABI:
//   int64_t splice_pair(int fd_a, int fd_b, int idle_timeout_ms)
// Returns total bytes relayed (>= 0), or -1 on setup error. The caller
// closes both fds afterwards.

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

constexpr size_t kBuf = 64 * 1024;

// One direction of the circuit: src -> dst with a single ring-free buffer
// (read only when empty, write until drained — no wraparound needed).
struct Dir {
  int src = -1, dst = -1;
  char buf[kBuf];
  size_t len = 0, off = 0;
  bool open = true;        // src still readable (no EOF seen)
  bool draining = false;   // EOF seen, flushing remaining buf

  bool want_read() const { return open && len == 0; }
  bool want_write() const { return len > 0; }
  bool done() const { return !open && len == 0; }

  // Returns false on fatal error (connection reset etc.).
  bool on_readable() {
    ssize_t n = ::recv(src, buf, kBuf, 0);
    if (n > 0) {
      len = static_cast<size_t>(n);
      off = 0;
      return true;
    }
    if (n == 0 || (errno != EAGAIN && errno != EWOULDBLOCK &&
                   errno != EINTR)) {
      open = false;  // EOF (or treat errors as close of this direction)
      if (len == 0) ::shutdown(dst, SHUT_WR);
      else draining = true;
    }
    return true;
  }

  bool on_writable(int64_t* total) {
    while (len > 0) {
      ssize_t n = ::send(dst, buf + off, len, MSG_NOSIGNAL);
      if (n > 0) {
        off += static_cast<size_t>(n);
        len -= static_cast<size_t>(n);
        *total += n;
        continue;
      }
      if (errno == EAGAIN || errno == EWOULDBLOCK) return true;
      if (errno == EINTR) continue;
      // Peer gone: this direction can never make progress again.
      open = false;
      len = 0;
      return true;
    }
    if (!open || draining) ::shutdown(dst, SHUT_WR);
    return true;
  }
};

bool set_nonblocking(int fd) {
  int flags = ::fcntl(fd, F_GETFL, 0);
  return flags >= 0 && ::fcntl(fd, F_SETFL, flags | O_NONBLOCK) >= 0;
}

}  // namespace

extern "C" int64_t splice_pair(int fd_a, int fd_b, int idle_timeout_ms) {
  if (!set_nonblocking(fd_a) || !set_nonblocking(fd_b)) return -1;
  Dir ab;
  ab.src = fd_a;
  ab.dst = fd_b;
  Dir ba;
  ba.src = fd_b;
  ba.dst = fd_a;
  int64_t total = 0;

  while (!(ab.done() && ba.done())) {
    struct pollfd pfds[2];
    pfds[0] = {fd_a, 0, 0};
    pfds[1] = {fd_b, 0, 0};
    if (ab.want_read()) pfds[0].events |= POLLIN;
    if (ba.want_write()) pfds[0].events |= POLLOUT;
    if (ba.want_read()) pfds[1].events |= POLLIN;
    if (ab.want_write()) pfds[1].events |= POLLOUT;
    if (pfds[0].events == 0 && pfds[1].events == 0) break;  // stalled out

    int rc = ::poll(pfds, 2, idle_timeout_ms);
    if (rc == 0) break;                      // idle circuit: kill it
    if (rc < 0) {
      if (errno == EINTR) continue;
      break;
    }
    // Hangup/error flags count as readable/writable attempts so the
    // recv/send sees the condition and closes the direction cleanly.
    // The want_read() guard is load-bearing: poll() reports POLLHUP
    // regardless of requested events, and an unguarded on_readable()
    // while the buffer is still unflushed would overwrite it (observed
    // as mid-stream corruption under bidirectional load).
    if ((pfds[0].revents & (POLLIN | POLLHUP | POLLERR)) && ab.want_read())
      ab.on_readable();
    if (pfds[1].revents & (POLLOUT | POLLHUP | POLLERR)) ab.on_writable(&total);
    if ((pfds[1].revents & (POLLIN | POLLHUP | POLLERR)) && ba.want_read())
      ba.on_readable();
    if (pfds[0].revents & (POLLOUT | POLLHUP | POLLERR)) ba.on_writable(&total);
  }
  return total;
}
