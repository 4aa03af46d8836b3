// Ring: the batched-syscall submission/completion event lane — the
// fork's io_uring networking layer (src/bthread/ring_listener.*,
// PAPER.md §layer 3) re-expressed for this stack's dispatcher seam.
//
// The Python RingDispatcher (transport/ring_lane.py) registers its
// interest set once; each tick is ONE GIL-released native call:
//
//   wait(timeout_ms) -> [completion, ...]
//       poll the registered set, then execute the whole ready-set's
//       I/O — recv bursts into ring-owned buffers, accept loops on
//       listeners, one-shot POLLOUT rearms — and return a completion
//       ring of (fd, op, res, payload) records Python drains in bulk.
//   flush_writes([(fd, (bytes, ...)), ...]) -> [(fd, res, errno), ...]
//       the submission ring's write half: every socket's queued
//       response run leaves as one gather writev, the whole batch in
//       one GIL round trip (the selector lane pays a Python->libc hop
//       plus a GIL release/reacquire per frame).
//
// Two backends behind this one ABI:
//   batch  portable nonblocking-syscall loop (poll + recv/accept/
//          writev executed inline) — works on every kernel, carries
//          the perf gate on hosts without io_uring.
//   uring  real io_uring via raw syscalls (no liburing dependency),
//          runtime-probed at Ring() construction: needs io_uring_setup
//          to succeed, IORING_FEAT_FAST_POLL (5.7+, makes direct
//          RECV/ACCEPT submission on nonblocking fds complete on
//          readiness instead of -EAGAIN) and the RECV opcode
//          (REGISTER_PROBE). Any miss — ENOSYS on old kernels, EPERM
//          under seccomp sandboxes — falls back to batch.
//
// Completion ops (fd, op, res, payload):
//   OP_RECV(0)     res>0: payload bytes (one combined burst per fd per
//                  tick); res==0: EOF; res<0: -errno
//   OP_ACCEPT(1)   res>=0: the accepted fd (nonblocking, cloexec);
//                  res<0: -errno (EMFILE backoff is the listener's)
//   OP_WRITEV(2)   uring only: deferred gather-write settled; res =
//                  bytes written or -errno (batch settles in
//                  flush_writes' return instead)
//   OP_WRITABLE(3) one-shot write-readiness (the blocked-writer rearm)
//   OP_READABLE(4) poll-only fds (wakeup pipe, ssl): readiness without
//                  consumption — Python's classic callback drains
//
// Syscall accounting floor: every recv/send/accept/poll this module —
// and the fastcore fd loops (pluck_scan / serve_drain) — executes is
// counted in process-wide atomics at the native boundary, exposed via
// syscall_counts(); transport/syscall_stats.py merges them with the
// Python-side conn counters into the /vars syscalls_per_rpc key. Both
// lanes stamp at the same boundary, so the bench ratio is honest.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <errno.h>
#include <fcntl.h>
#include <poll.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/syscall.h>
#include <sys/uio.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstdlib>

// ------------------------------------------------- syscall accounting --
// Process-wide, lock-free: bumped with the GIL released, read (via
// syscall_counts) with it held. fastcore.cc's fd loops extern these.
std::atomic<unsigned long long> fc_sys_recv{0};
std::atomic<unsigned long long> fc_sys_send{0};
std::atomic<unsigned long long> fc_sys_accept{0};
std::atomic<unsigned long long> fc_sys_poll{0};

namespace {

constexpr int OP_RECV = 0;
constexpr int OP_ACCEPT = 1;
constexpr int OP_WRITEV = 2;
constexpr int OP_WRITABLE = 3;
constexpr int OP_READABLE = 4;

constexpr int KIND_DATA = 0;
constexpr int KIND_ACCEPT = 1;
constexpr int KIND_POLL = 2;

// recv burst cap per fd per tick: one completion carries at most this
// much (matches serve_drain's thread-local buffer scale; a level-
// triggered poll re-fires for the rest, so a bulk peer cannot starve
// the other ready fds of the tick)
constexpr size_t kRecvCap = 262144;
// stop the per-fd recv loop on a short read (kernel almost drained) —
// the serve_drain discipline, saving the guaranteed-EAGAIN round trip
constexpr size_t kShortRead = 65536;
constexpr int kAcceptBurst = 64;

// ------------------------------------------------------------ io_uring --
// Raw ABI (kernel 4.4 ships no <linux/io_uring.h>; declaring it here
// keeps the build portable and the probe honest).
#ifndef __NR_io_uring_setup
#define __NR_io_uring_setup 425
#define __NR_io_uring_enter 426
#define __NR_io_uring_register 427
#endif

struct io_sqring_offsets {
  uint32_t head, tail, ring_mask, ring_entries, flags, dropped, array, resv1;
  uint64_t resv2;
};
struct io_cqring_offsets {
  uint32_t head, tail, ring_mask, ring_entries, overflow, cqes;
  uint64_t resv[2];
};
struct io_uring_params {
  uint32_t sq_entries, cq_entries, flags, sq_thread_cpu, sq_thread_idle;
  uint32_t features, wq_fd, resv[3];
  struct io_sqring_offsets sq_off;
  struct io_cqring_offsets cq_off;
};
struct io_uring_sqe {
  uint8_t opcode;
  uint8_t flags;
  uint16_t ioprio;
  int32_t fd;
  uint64_t off;        // addr2
  uint64_t addr;
  uint32_t len;
  uint32_t op_flags;   // msg_flags / accept_flags / poll_events / ...
  uint64_t user_data;
  uint64_t pad[3];
};
struct io_uring_cqe {
  uint64_t user_data;
  int32_t res;
  uint32_t flags;
};
struct io_uring_probe_op {
  uint8_t op, resv;
  uint16_t flags;  // IO_URING_OP_SUPPORTED = 1<<0
  uint32_t resv2;
};
struct io_uring_probe_head {
  uint8_t last_op, ops_len;
  uint16_t resv;
  uint32_t resv2[3];
  struct io_uring_probe_op ops[256];
};
struct kts {
  int64_t tv_sec;
  long long tv_nsec;
};

constexpr uint64_t IORING_OFF_SQ_RING = 0;
constexpr uint64_t IORING_OFF_CQ_RING = 0x8000000ULL;
constexpr uint64_t IORING_OFF_SQES = 0x10000000ULL;
constexpr uint32_t IORING_ENTER_GETEVENTS = 1u << 0;
constexpr uint32_t IORING_FEAT_SINGLE_MMAP = 1u << 0;
constexpr uint32_t IORING_FEAT_FAST_POLL = 1u << 5;
constexpr unsigned IORING_REGISTER_PROBE = 8;
constexpr uint8_t IORING_OP_WRITEV = 2;
constexpr uint8_t IORING_OP_POLL_ADD = 6;
constexpr uint8_t IORING_OP_TIMEOUT = 11;
constexpr uint8_t IORING_OP_ACCEPT = 13;
constexpr uint8_t IORING_OP_ASYNC_CANCEL = 14;
constexpr uint8_t IORING_OP_RECV = 27;
constexpr uint16_t IO_URING_OP_SUPPORTED = 1u << 0;

// user_data tags: op class in the top byte; for slot ops the
// registration generation rides bits 32..55 and the fd the low 32
// (slot_tag below) — TAG_WRITE carries a unique sequence instead
constexpr uint64_t TAG_RECV = 1ULL << 56;
constexpr uint64_t TAG_ACCEPT = 2ULL << 56;
constexpr uint64_t TAG_POLLIN = 3ULL << 56;
constexpr uint64_t TAG_POLLOUT = 4ULL << 56;
constexpr uint64_t TAG_WRITE = 5ULL << 56;
constexpr uint64_t TAG_TIMEOUT = 6ULL << 56;
constexpr uint64_t TAG_CANCEL = 7ULL << 56;
constexpr uint64_t TAG_MASK = 0xFFULL << 56;

struct Uring {
  int ring_fd = -1;
  unsigned sq_entries = 0, cq_entries = 0;
  unsigned *sq_head = nullptr, *sq_tail = nullptr, *sq_mask = nullptr;
  unsigned* sq_array = nullptr;
  struct io_uring_sqe* sqes = nullptr;
  unsigned *cq_head = nullptr, *cq_tail = nullptr, *cq_mask = nullptr;
  struct io_uring_cqe* cqes = nullptr;
  void* sq_ptr = nullptr;
  size_t sq_sz = 0;
  void* cq_ptr = nullptr;
  size_t cq_sz = 0;
  size_t sqes_sz = 0;
};

// one in-flight uring gather write: pins the Python buffers until the
// CQE retires them (the submission ring owns its payloads, exactly as
// the kernel requires — SQE buffers must stay live until completion)
struct InflightWrite {
  uint64_t tag;               // TAG_WRITE | seq
  int fd;
  uint32_t gen;               // slot generation at submission: a CQE
                              // arriving after the fd was recycled
                              // must not report into the NEW consumer
  struct iovec* iov;
  Py_buffer* bufs;
  int nbufs;
  size_t total;
  InflightWrite* next;
};

struct Slot {
  bool used = false;
  uint8_t kind = KIND_DATA;
  bool armed = false;          // read interest
  bool want_writable = false;  // one-shot POLLOUT interest
  // uring: in-flight markers (one op of each class per fd at a time)
  bool recv_inflight = false;
  bool accept_inflight = false;
  bool pollin_inflight = false;
  bool pollout_inflight = false;
  unsigned char* rbuf = nullptr;  // uring recv buffer (owned)
  // registration generation, carried in every uring user_data tag
  // (bits 32..55): a stale CQE from before an unregister — cancel is
  // best-effort, the op may already be executing — mismatches and is
  // dropped instead of misdelivering into a recycled fd number
  uint32_t gen = 0;
};

// a recv buffer whose fd was unregistered while its uring RECV was
// still in flight: the kernel may yet write into it, so ownership
// parks here until the (data or -ECANCELED) CQE retires it — the
// recv-side mirror of InflightWrite's pin
struct OrphanRecv {
  int fd;
  uint32_t gen;
  unsigned char* buf;
  OrphanRecv* next;
};

// uring user_data layout: op class byte | gen (24 bits) | fd (32 bits)
inline uint64_t slot_tag(uint64_t cls, int fd, uint32_t gen) {
  return cls | (static_cast<uint64_t>(gen & 0xFFFFFFu) << 32) |
         static_cast<uint32_t>(fd);
}

// one tick's per-fd result (batch backend scratch)
struct TickRes {
  int fd;
  uint8_t kind;
  size_t off = 0, len = 0;  // recv bytes in the arena
  bool eof = false;
  int err = 0;               // recv errno (not EAGAIN)
  int newfds[kAcceptBurst];
  int nnew = 0;
  int accept_err = 0;
  bool writable = false;
  bool readable = false;     // poll-only readiness
};

struct RingObject {
  PyObject_HEAD
  int backend;  // 0 = batch, 1 = uring
  Slot* slots;
  int cap;                 // slots indexed by fd
  int* fds;                // registered fd list (dense)
  int nfds;
  int fds_cap;
  unsigned char* arena;    // batch recv arena (grown per tick)
  size_t arena_cap;
  Uring u;
  InflightWrite* inflight_writes;
  OrphanRecv* orphan_recvs;
  uint64_t write_seq;
  bool closed;
};

void orphan_park(RingObject* self, int fd, uint32_t gen,
                 unsigned char* buf) {
  OrphanRecv* o = static_cast<OrphanRecv*>(malloc(sizeof(OrphanRecv)));
  if (o == nullptr) {
    // cannot park: leaking beats handing the kernel freed heap (the
    // in-flight RECV may still write here)
    return;
  }
  o->fd = fd;
  o->gen = gen;
  o->buf = buf;
  o->next = self->orphan_recvs;
  self->orphan_recvs = o;
}

void orphan_retire(RingObject* self, int fd, uint32_t gen) {
  OrphanRecv** p = &self->orphan_recvs;
  while (*p != nullptr) {
    if ((*p)->fd == fd && (*p)->gen == gen) {
      OrphanRecv* o = *p;
      *p = o->next;
      free(o->buf);
      free(o);
      return;
    }
    p = &(*p)->next;
  }
}

// ------------------------------------------------------ slot registry --
bool ensure_fd(RingObject* self, int fd) {
  if (fd < 0) return false;
  if (fd >= self->cap) {
    int ncap = self->cap ? self->cap : 64;
    while (ncap <= fd) ncap *= 2;
    Slot* ns = static_cast<Slot*>(realloc(self->slots, ncap * sizeof(Slot)));
    if (ns == nullptr) return false;
    for (int i = self->cap; i < ncap; ++i) ns[i] = Slot();
    self->slots = ns;
    self->cap = ncap;
  }
  return true;
}

bool fds_append(RingObject* self, int fd) {
  if (self->nfds == self->fds_cap) {
    int ncap = self->fds_cap ? self->fds_cap * 2 : 64;
    int* nf = static_cast<int*>(realloc(self->fds, ncap * sizeof(int)));
    if (nf == nullptr) return false;
    self->fds = nf;
    self->fds_cap = ncap;
  }
  self->fds[self->nfds++] = fd;
  return true;
}

void fds_remove(RingObject* self, int fd) {
  for (int i = 0; i < self->nfds; ++i) {
    if (self->fds[i] == fd) {
      self->fds[i] = self->fds[--self->nfds];
      return;
    }
  }
}

// ---------------------------------------------------------- uring setup --
int uring_mmap(Uring* u, struct io_uring_params* p) {
  u->sq_sz = p->sq_off.array + p->sq_entries * sizeof(unsigned);
  u->cq_sz = p->cq_off.cqes + p->cq_entries * sizeof(struct io_uring_cqe);
  if (p->features & IORING_FEAT_SINGLE_MMAP) {
    if (u->cq_sz > u->sq_sz) u->sq_sz = u->cq_sz;
    u->cq_sz = u->sq_sz;
  }
  u->sq_ptr = mmap(nullptr, u->sq_sz, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_POPULATE, u->ring_fd, IORING_OFF_SQ_RING);
  if (u->sq_ptr == MAP_FAILED) return -1;
  if (p->features & IORING_FEAT_SINGLE_MMAP) {
    u->cq_ptr = u->sq_ptr;
  } else {
    u->cq_ptr = mmap(nullptr, u->cq_sz, PROT_READ | PROT_WRITE,
                     MAP_SHARED | MAP_POPULATE, u->ring_fd,
                     IORING_OFF_CQ_RING);
    if (u->cq_ptr == MAP_FAILED) return -1;
  }
  char* sq = static_cast<char*>(u->sq_ptr);
  u->sq_head = reinterpret_cast<unsigned*>(sq + p->sq_off.head);
  u->sq_tail = reinterpret_cast<unsigned*>(sq + p->sq_off.tail);
  u->sq_mask = reinterpret_cast<unsigned*>(sq + p->sq_off.ring_mask);
  u->sq_array = reinterpret_cast<unsigned*>(sq + p->sq_off.array);
  u->sq_entries = p->sq_entries;
  u->sqes_sz = p->sq_entries * sizeof(struct io_uring_sqe);
  void* sqes = mmap(nullptr, u->sqes_sz, PROT_READ | PROT_WRITE,
                    MAP_SHARED | MAP_POPULATE, u->ring_fd, IORING_OFF_SQES);
  if (sqes == MAP_FAILED) return -1;
  u->sqes = static_cast<struct io_uring_sqe*>(sqes);
  char* cq = static_cast<char*>(u->cq_ptr);
  u->cq_head = reinterpret_cast<unsigned*>(cq + p->cq_off.head);
  u->cq_tail = reinterpret_cast<unsigned*>(cq + p->cq_off.tail);
  u->cq_mask = reinterpret_cast<unsigned*>(cq + p->cq_off.ring_mask);
  u->cqes = reinterpret_cast<struct io_uring_cqe*>(cq + p->cq_off.cqes);
  u->cq_entries = p->cq_entries;
  return 0;
}

void uring_teardown(Uring* u) {
  if (u->sqes != nullptr) munmap(u->sqes, u->sqes_sz);
  if (u->cq_ptr != nullptr && u->cq_ptr != u->sq_ptr)
    munmap(u->cq_ptr, u->cq_sz);
  if (u->sq_ptr != nullptr) munmap(u->sq_ptr, u->sq_sz);
  if (u->ring_fd >= 0) close(u->ring_fd);
  *u = Uring();
  u->ring_fd = -1;
}

// Probe + bring-up: 0 on success, -errno on the decisive failure.
// ENOSYS (pre-5.1 kernels, this sandbox's 4.4) and EPERM (seccomp)
// are the expected fallback verdicts; missing FAST_POLL / RECV
// support reports as ENOSYS too — "no usable io_uring here".
int uring_init(Uring* u) {
  struct io_uring_params p;
  memset(&p, 0, sizeof(p));
  long fd = syscall(__NR_io_uring_setup, 256, &p);
  if (fd < 0) return -errno;
  u->ring_fd = static_cast<int>(fd);
  if (!(p.features & IORING_FEAT_FAST_POLL)) {
    uring_teardown(u);
    return -ENOSYS;  // direct RECV/ACCEPT would -EAGAIN: not usable
  }
  struct io_uring_probe_head probe;
  memset(&probe, 0, sizeof(probe));
  if (syscall(__NR_io_uring_register, u->ring_fd, IORING_REGISTER_PROBE,
              &probe, 256) < 0 ||
      probe.ops_len <= IORING_OP_RECV ||
      !(probe.ops[IORING_OP_RECV].flags & IO_URING_OP_SUPPORTED) ||
      !(probe.ops[IORING_OP_ACCEPT].flags & IO_URING_OP_SUPPORTED)) {
    uring_teardown(u);
    return -ENOSYS;
  }
  if (uring_mmap(u, &p) != 0) {
    int e = errno;
    uring_teardown(u);
    return -(e ? e : ENOMEM);
  }
  return 0;
}

struct io_uring_sqe* uring_get_sqe(Uring* u) {
  unsigned head = __atomic_load_n(u->sq_head, __ATOMIC_ACQUIRE);
  unsigned tail = *u->sq_tail;
  if (tail - head >= u->sq_entries) return nullptr;  // SQ full
  struct io_uring_sqe* sqe = &u->sqes[tail & *u->sq_mask];
  memset(sqe, 0, sizeof(*sqe));
  u->sq_array[tail & *u->sq_mask] = tail & *u->sq_mask;
  __atomic_store_n(u->sq_tail, tail + 1, __ATOMIC_RELEASE);
  return sqe;
}

unsigned uring_pending(Uring* u) {
  return *u->sq_tail - __atomic_load_n(u->sq_head, __ATOMIC_ACQUIRE);
}

// --------------------------------------------------------- Ring object --
PyObject* ring_new(PyTypeObject* type, PyObject* args, PyObject*) {
  int backend = 0;  // 0 auto, 1 batch forced, 2 uring forced
  if (!PyArg_ParseTuple(args, "|i", &backend)) return nullptr;
  RingObject* self = reinterpret_cast<RingObject*>(type->tp_alloc(type, 0));
  if (self == nullptr) return nullptr;
  self->slots = nullptr;
  self->cap = 0;
  self->fds = nullptr;
  self->nfds = 0;
  self->fds_cap = 0;
  self->arena = nullptr;
  self->arena_cap = 0;
  self->u = Uring();
  self->u.ring_fd = -1;
  self->inflight_writes = nullptr;
  self->orphan_recvs = nullptr;
  self->write_seq = 0;
  self->closed = false;
  self->backend = 0;
  if (backend == 1) {
    return reinterpret_cast<PyObject*>(self);
  }
  int rc = uring_init(&self->u);
  if (rc == 0) {
    self->backend = 1;
    return reinterpret_cast<PyObject*>(self);
  }
  if (backend == 2) {
    // forced uring: surface the probe verdict instead of silently
    // serving the batch loop while the caller believes it measured
    // io_uring (the ENOSYS/EPERM fallback is for backend=auto)
    Py_DECREF(self);
    errno = -rc;
    PyErr_SetFromErrno(PyExc_OSError);
    return nullptr;
  }
  return reinterpret_cast<PyObject*>(self);  // auto: batch fallback
}

void ring_clear_native(RingObject* self) {
  // drop uring in-flight write pins (CQEs can never be reaped again)
  InflightWrite* w = self->inflight_writes;
  while (w != nullptr) {
    InflightWrite* n = w->next;
    for (int i = 0; i < w->nbufs; ++i) PyBuffer_Release(&w->bufs[i]);
    free(w->iov);
    free(w->bufs);
    free(w);
    w = n;
  }
  self->inflight_writes = nullptr;
  if (self->backend == 1) uring_teardown(&self->u);
  // with the ring fd closed every in-flight op is dead: the orphaned
  // recv buffers can finally go
  OrphanRecv* orp = self->orphan_recvs;
  while (orp != nullptr) {
    OrphanRecv* nx = orp->next;
    free(orp->buf);
    free(orp);
    orp = nx;
  }
  self->orphan_recvs = nullptr;
  for (int i = 0; i < self->cap; ++i) free(self->slots[i].rbuf);
  free(self->slots);
  self->slots = nullptr;
  self->cap = 0;
  free(self->fds);
  self->fds = nullptr;
  self->nfds = self->fds_cap = 0;
  free(self->arena);
  self->arena = nullptr;
  self->arena_cap = 0;
  self->closed = true;
}

void ring_dealloc(PyObject* o) {
  RingObject* self = reinterpret_cast<RingObject*>(o);
  if (!self->closed) ring_clear_native(self);
  Py_TYPE(o)->tp_free(o);
}

PyObject* ring_close(PyObject* o, PyObject*) {
  RingObject* self = reinterpret_cast<RingObject*>(o);
  if (!self->closed) ring_clear_native(self);
  Py_RETURN_NONE;
}

PyObject* ring_backend_name(PyObject* o, PyObject*) {
  RingObject* self = reinterpret_cast<RingObject*>(o);
  return PyUnicode_FromString(self->backend == 1 ? "uring" : "batch");
}

void uring_cancel(RingObject* self, uint64_t target);

PyObject* ring_register_fd(PyObject* o, PyObject* args) {
  RingObject* self = reinterpret_cast<RingObject*>(o);
  int fd, kind;
  if (!PyArg_ParseTuple(args, "ii", &fd, &kind)) return nullptr;
  if (self->closed || !ensure_fd(self, fd)) {
    PyErr_SetString(PyExc_ValueError, "ring closed or bad fd");
    return nullptr;
  }
  Slot* s = &self->slots[fd];
  if (!s->used && !fds_append(self, fd)) return PyErr_NoMemory();
  unsigned char* recycled = s->rbuf;  // keep a prior uring recv buffer
  if (self->backend == 1 && s->recv_inflight && recycled != nullptr) {
    // re-registered over a live RECV (caller skipped unregister): the
    // kernel still owns that buffer — park it and start fresh
    uring_cancel(self, slot_tag(TAG_RECV, fd, s->gen));
    orphan_park(self, fd, s->gen, recycled);
    recycled = nullptr;
  }
  uint32_t gen = s->gen + 1;  // new registration, new tag generation
  *s = Slot();
  s->rbuf = recycled;
  s->gen = gen;
  s->used = true;
  s->kind = static_cast<uint8_t>(kind);
  s->armed = true;
  Py_RETURN_NONE;
}

// uring: fire-and-forget cancel of a class of in-flight ops for fd
void uring_cancel(RingObject* self, uint64_t target) {
  struct io_uring_sqe* sqe = uring_get_sqe(&self->u);
  if (sqe == nullptr) return;  // SQ full: the op will be dropped at reap
  sqe->opcode = IORING_OP_ASYNC_CANCEL;
  sqe->fd = -1;
  sqe->addr = target;
  sqe->user_data = TAG_CANCEL;
  syscall(__NR_io_uring_enter, self->u.ring_fd, uring_pending(&self->u), 0,
          0, nullptr, 0);
}

PyObject* ring_unregister_fd(PyObject* o, PyObject* arg) {
  RingObject* self = reinterpret_cast<RingObject*>(o);
  long fd = PyLong_AsLong(arg);
  if (fd == -1 && PyErr_Occurred()) return nullptr;
  if (!self->closed && fd >= 0 && fd < self->cap && self->slots[fd].used) {
    Slot* s = &self->slots[fd];
    int ifd = static_cast<int>(fd);
    if (self->backend == 1) {
      if (s->recv_inflight)
        uring_cancel(self, slot_tag(TAG_RECV, ifd, s->gen));
      if (s->accept_inflight)
        uring_cancel(self, slot_tag(TAG_ACCEPT, ifd, s->gen));
      if (s->pollin_inflight)
        uring_cancel(self, slot_tag(TAG_POLLIN, ifd, s->gen));
      if (s->pollout_inflight)
        uring_cancel(self, slot_tag(TAG_POLLOUT, ifd, s->gen));
    }
    if (self->backend == 1 && s->recv_inflight) {
      // cancel is best-effort (SQ may be full, the op may already be
      // executing): the kernel can still write into rbuf — park it on
      // the orphan list until the CQE retires it, NEVER free it here
      orphan_park(self, ifd, s->gen, s->rbuf);
    } else {
      free(s->rbuf);
    }
    uint32_t gen = s->gen;  // preserved: a recycled fd's next
    *s = Slot();            // registration mints gen+1, so stale CQEs
    s->gen = gen;           // tagged with THIS gen can never match it
    fds_remove(self, ifd);
  }
  Py_RETURN_NONE;
}

PyObject* ring_set_read(PyObject* o, PyObject* args) {
  RingObject* self = reinterpret_cast<RingObject*>(o);
  int fd, on;
  if (!PyArg_ParseTuple(args, "ip", &fd, &on)) return nullptr;
  if (!self->closed && fd >= 0 && fd < self->cap && self->slots[fd].used) {
    Slot* s = &self->slots[fd];
    if (s->armed && !on && self->backend == 1) {
      // a parked RECV would consume bytes the new owner (the pluck
      // lane) expects to read itself: cancel it. The CQE (data or
      // -ECANCELED) is still delivered/reaped on the next wait — the
      // Python side routes any stolen bytes through the socket's
      // ring-chunk queue, never dropping them.
      if (s->recv_inflight)
        uring_cancel(self, slot_tag(TAG_RECV, fd, s->gen));
      if (s->pollin_inflight)
        uring_cancel(self, slot_tag(TAG_POLLIN, fd, s->gen));
    }
    s->armed = on != 0;
  }
  Py_RETURN_NONE;
}

PyObject* ring_request_writable(PyObject* o, PyObject* arg) {
  RingObject* self = reinterpret_cast<RingObject*>(o);
  long fd = PyLong_AsLong(arg);
  if (fd == -1 && PyErr_Occurred()) return nullptr;
  if (!self->closed && fd >= 0 && fd < self->cap && self->slots[fd].used)
    self->slots[fd].want_writable = true;
  Py_RETURN_NONE;
}

// ------------------------------------------------------- batch wait() --
PyObject* batch_wait(RingObject* self, long timeout_ms) {
  // snapshot the interest set under the GIL; the syscalls run without
  // it. Registry mutations during the native pass land in the NEXT
  // tick (the Python dispatcher's tick barrier serializes consumers
  // that must not overlap an in-flight pass).
  int n = self->nfds;
  struct pollfd* pfds =
      static_cast<struct pollfd*>(malloc((n ? n : 1) * sizeof(pollfd)));
  TickRes* res = static_cast<TickRes*>(malloc((n ? n : 1) * sizeof(TickRes)));
  if (pfds == nullptr || res == nullptr) {
    free(pfds);
    free(res);
    return PyErr_NoMemory();
  }
  int np = 0;
  for (int i = 0; i < n; ++i) {
    int fd = self->fds[i];
    Slot* s = &self->slots[fd];
    short ev = 0;
    if (s->armed) ev |= POLLIN;
    if (s->want_writable) ev |= POLLOUT;
    if (ev == 0) continue;
    pfds[np].fd = fd;
    pfds[np].events = ev;
    pfds[np].revents = 0;
    res[np] = TickRes();
    res[np].fd = fd;
    res[np].kind = s->kind;
    ++np;
  }
  unsigned char* arena = self->arena;
  size_t arena_cap = self->arena_cap;
  size_t arena_used = 0;
  int nready = 0;
  Py_BEGIN_ALLOW_THREADS
  fc_sys_poll.fetch_add(1, std::memory_order_relaxed);
  nready = poll(pfds, np, static_cast<int>(timeout_ms));
  if (nready > 0) {
    for (int i = 0; i < np; ++i) {
      short rev = pfds[i].revents;
      if (rev == 0) continue;
      TickRes* r = &res[i];
      if ((rev & POLLOUT) != 0) r->writable = true;
      bool rin = (rev & (POLLIN | POLLERR | POLLHUP)) != 0;
      if (!rin) continue;
      if (r->kind == KIND_POLL) {
        r->readable = true;
        continue;
      }
      if (r->kind == KIND_ACCEPT) {
        while (r->nnew < kAcceptBurst) {
          fc_sys_accept.fetch_add(1, std::memory_order_relaxed);
          int nfd = accept4(r->fd, nullptr, nullptr,
                            SOCK_NONBLOCK | SOCK_CLOEXEC);
          if (nfd >= 0) {
            r->newfds[r->nnew++] = nfd;
            continue;
          }
          if (errno == EINTR) continue;
          if (errno != EAGAIN && errno != EWOULDBLOCK &&
              errno != ECONNABORTED)
            r->accept_err = errno;
          break;
        }
        continue;
      }
      // KIND_DATA: recv burst into the arena
      if (arena_used + kRecvCap > arena_cap) {
        size_t ncap = arena_cap ? arena_cap * 2 : kRecvCap * 4;
        while (ncap < arena_used + kRecvCap) ncap *= 2;
        unsigned char* na = static_cast<unsigned char*>(realloc(arena, ncap));
        if (na == nullptr) {
          r->err = ENOMEM;
          continue;
        }
        arena = na;
        arena_cap = ncap;
      }
      r->off = arena_used;
      size_t got = 0;
      while (got < kRecvCap) {
        fc_sys_recv.fetch_add(1, std::memory_order_relaxed);
        ssize_t rc = recv(r->fd, arena + r->off + got, kRecvCap - got, 0);
        if (rc > 0) {
          got += static_cast<size_t>(rc);
          if (static_cast<size_t>(rc) < kShortRead) break;
          continue;
        }
        if (rc == 0) {
          r->eof = true;
          break;
        }
        if (errno == EINTR) continue;
        if (errno != EAGAIN && errno != EWOULDBLOCK) r->err = errno;
        break;
      }
      r->len = got;
      arena_used += got;
    }
  }
  Py_END_ALLOW_THREADS
  self->arena = arena;
  self->arena_cap = arena_cap;
  PyObject* out = PyList_New(0);
  if (out == nullptr) {
    free(pfds);
    free(res);
    return nullptr;
  }
  bool fail = false;
  for (int i = 0; i < np && !fail; ++i) {
    TickRes* r = &res[i];
    Slot* s = (r->fd < self->cap) ? &self->slots[r->fd] : nullptr;
    PyObject* rec = nullptr;
    if (r->writable) {
      if (s != nullptr) s->want_writable = false;  // one-shot consumed
      rec = Py_BuildValue("iiiO", r->fd, OP_WRITABLE, 0, Py_None);
      if (rec == nullptr || PyList_Append(out, rec) < 0) fail = true;
      Py_XDECREF(rec);
      if (fail) break;
    }
    if (r->readable) {
      rec = Py_BuildValue("iiiO", r->fd, OP_READABLE, 0, Py_None);
      if (rec == nullptr || PyList_Append(out, rec) < 0) fail = true;
      Py_XDECREF(rec);
      if (fail) break;
    }
    if (r->len > 0) {
      PyObject* data = PyBytes_FromStringAndSize(
          reinterpret_cast<char*>(self->arena) + r->off,
          static_cast<Py_ssize_t>(r->len));
      rec = data == nullptr
                ? nullptr
                : Py_BuildValue("iinN", r->fd, OP_RECV,
                                static_cast<Py_ssize_t>(r->len), data);
      if (rec == nullptr || PyList_Append(out, rec) < 0) fail = true;
      Py_XDECREF(rec);
      if (fail) break;
    }
    if (r->eof || r->err) {
      rec = Py_BuildValue("iiiO", r->fd, OP_RECV, r->eof ? 0 : -r->err,
                          Py_None);
      if (rec == nullptr || PyList_Append(out, rec) < 0) fail = true;
      Py_XDECREF(rec);
      if (fail) break;
    }
    for (int j = 0; j < r->nnew; ++j) {
      rec = Py_BuildValue("iiiO", r->fd, OP_ACCEPT, r->newfds[j], Py_None);
      if (rec == nullptr || PyList_Append(out, rec) < 0) fail = true;
      Py_XDECREF(rec);
      if (fail) break;
    }
    if (fail) break;
    if (r->accept_err) {
      rec = Py_BuildValue("iiiO", r->fd, OP_ACCEPT, -r->accept_err, Py_None);
      if (rec == nullptr || PyList_Append(out, rec) < 0) fail = true;
      Py_XDECREF(rec);
    }
  }
  free(pfds);
  if (fail) {
    // the whole completion list is being discarded (records appended
    // so far included): every accepted fd this tick — delivered,
    // half-built, or not yet reached — would leak with it. Python
    // never sees this tick, so close them all.
    for (int i = 0; i < np; ++i)
      for (int j = 0; j < res[i].nnew; ++j) close(res[i].newfds[j]);
    free(res);
    Py_DECREF(out);
    return nullptr;
  }
  free(res);
  return out;
}

// ------------------------------------------------------- uring wait() --
void uring_arm(RingObject* self) {
  Uring* u = &self->u;
  for (int i = 0; i < self->nfds; ++i) {
    int fd = self->fds[i];
    Slot* s = &self->slots[fd];
    if (!s->armed) {
      // fallthrough: only POLLOUT interest may remain below
    } else if (s->kind == KIND_DATA && !s->recv_inflight) {
      if (s->rbuf == nullptr) {
        s->rbuf = static_cast<unsigned char*>(malloc(kRecvCap));
        if (s->rbuf == nullptr) continue;
      }
      struct io_uring_sqe* sqe = uring_get_sqe(u);
      if (sqe == nullptr) return;  // SQ full: arm the rest next tick
      sqe->opcode = IORING_OP_RECV;
      sqe->fd = fd;
      sqe->addr = reinterpret_cast<uint64_t>(s->rbuf);
      sqe->len = kRecvCap;
      sqe->user_data = slot_tag(TAG_RECV, fd, s->gen);
      s->recv_inflight = true;
    } else if (s->kind == KIND_ACCEPT && !s->accept_inflight) {
      struct io_uring_sqe* sqe = uring_get_sqe(u);
      if (sqe == nullptr) return;
      sqe->opcode = IORING_OP_ACCEPT;
      sqe->fd = fd;
      sqe->op_flags = SOCK_NONBLOCK | SOCK_CLOEXEC;
      sqe->user_data = slot_tag(TAG_ACCEPT, fd, s->gen);
      s->accept_inflight = true;
    } else if (s->kind == KIND_POLL && !s->pollin_inflight) {
      struct io_uring_sqe* sqe = uring_get_sqe(u);
      if (sqe == nullptr) return;
      sqe->opcode = IORING_OP_POLL_ADD;
      sqe->fd = fd;
      sqe->op_flags = POLLIN;
      sqe->user_data = slot_tag(TAG_POLLIN, fd, s->gen);
      s->pollin_inflight = true;
    }
    if (s->want_writable && !s->pollout_inflight) {
      struct io_uring_sqe* sqe = uring_get_sqe(u);
      if (sqe == nullptr) return;
      sqe->opcode = IORING_OP_POLL_ADD;
      sqe->fd = fd;
      sqe->op_flags = POLLOUT;
      sqe->user_data = slot_tag(TAG_POLLOUT, fd, s->gen);
      s->pollout_inflight = true;
    }
  }
}

InflightWrite* take_inflight_write(RingObject* self, uint64_t tag) {
  InflightWrite** p = &self->inflight_writes;
  while (*p != nullptr) {
    if ((*p)->tag == tag) {
      InflightWrite* w = *p;
      *p = w->next;
      return w;
    }
    p = &(*p)->next;
  }
  return nullptr;
}

PyObject* uring_wait(RingObject* self, long timeout_ms) {
  Uring* u = &self->u;
  uring_arm(self);
  struct kts ts;
  ts.tv_sec = timeout_ms / 1000;
  ts.tv_nsec = (timeout_ms % 1000) * 1000000LL;
  struct io_uring_sqe* tsqe = uring_get_sqe(u);
  if (tsqe != nullptr) {
    tsqe->opcode = IORING_OP_TIMEOUT;
    tsqe->fd = -1;
    tsqe->addr = reinterpret_cast<uint64_t>(&ts);
    tsqe->len = 1;
    tsqe->user_data = TAG_TIMEOUT;
  }
  unsigned to_submit = uring_pending(u);
  long rc = 0;
  Py_BEGIN_ALLOW_THREADS
  fc_sys_poll.fetch_add(1, std::memory_order_relaxed);
  rc = syscall(__NR_io_uring_enter, u->ring_fd, to_submit, 1,
               IORING_ENTER_GETEVENTS, nullptr, 0);
  Py_END_ALLOW_THREADS
  if (rc < 0 && errno != EINTR && errno != ETIME && errno != EBUSY) {
    PyErr_SetFromErrno(PyExc_OSError);
    return nullptr;
  }
  PyObject* out = PyList_New(0);
  if (out == nullptr) return nullptr;
  bool fail = false;
  unsigned head = __atomic_load_n(u->cq_head, __ATOMIC_ACQUIRE);
  unsigned tail = __atomic_load_n(u->cq_tail, __ATOMIC_ACQUIRE);
  while (head != tail && !fail) {
    struct io_uring_cqe* cqe = &u->cqes[head & *u->cq_mask];
    uint64_t tag = cqe->user_data & TAG_MASK;
    int fd = static_cast<int>(cqe->user_data & 0xFFFFFFFFULL);
    uint32_t cgen =
        static_cast<uint32_t>((cqe->user_data >> 32) & 0xFFFFFFu);
    int cres = cqe->res;
    // a slot only matches its CQE when the registration GENERATION
    // matches too: a stale completion from before an unregister (the
    // cancel is best-effort) must never deliver into a recycled fd
    Slot* s = (fd >= 0 && fd < self->cap && self->slots[fd].used &&
               self->slots[fd].gen == cgen)
                  ? &self->slots[fd]
                  : nullptr;
    PyObject* rec = nullptr;
    if (tag == TAG_RECV) {
      if (s != nullptr) {
        s->recv_inflight = false;
      } else {
        // the unregistered fd's parked buffer: this CQE (data, error
        // or -ECANCELED) is the kernel's last touch — free it now
        orphan_retire(self, fd, cgen);
      }
      if (s != nullptr && cres > 0) {
        PyObject* data = PyBytes_FromStringAndSize(
            reinterpret_cast<char*>(s->rbuf), cres);
        rec = data == nullptr
                  ? nullptr
                  : Py_BuildValue("iiiN", fd, OP_RECV, cres, data);
        if (rec == nullptr) fail = true;
      } else if (s != nullptr && cres != -ECANCELED && cres != -EAGAIN) {
        rec = Py_BuildValue("iiiO", fd, OP_RECV, cres, Py_None);
        if (rec == nullptr) fail = true;
      }
    } else if (tag == TAG_ACCEPT) {
      if (s != nullptr) s->accept_inflight = false;
      if (cres >= 0 && s == nullptr) {
        close(cres);  // listener gone: don't leak the accepted fd
      } else if (s != nullptr && cres != -ECANCELED && cres != -EAGAIN) {
        rec = Py_BuildValue("iiiO", fd, OP_ACCEPT, cres, Py_None);
        if (rec == nullptr) fail = true;
      }
    } else if (tag == TAG_POLLIN) {
      if (s != nullptr) {
        s->pollin_inflight = false;
        if (cres > 0) {
          rec = Py_BuildValue("iiiO", fd, OP_READABLE, 0, Py_None);
          if (rec == nullptr) fail = true;
        }
      }
    } else if (tag == TAG_POLLOUT) {
      if (s != nullptr) {
        s->pollout_inflight = false;
        if (cres > 0) {
          s->want_writable = false;
          rec = Py_BuildValue("iiiO", fd, OP_WRITABLE, 0, Py_None);
          if (rec == nullptr) fail = true;
        }
      }
    }
    if (tag == TAG_WRITE) {
      InflightWrite* w = take_inflight_write(self, cqe->user_data);
      if (w != nullptr) {
        if (self->slots != nullptr && w->fd < self->cap &&
            self->slots[w->fd].used && self->slots[w->fd].gen == w->gen) {
          // generation match only: a recycled fd's NEW consumer must
          // not receive the OLD socket's write settle (the Python
          // side keys pending writes by fd)
          rec = Py_BuildValue("iiiO", w->fd, OP_WRITEV, cres, Py_None);
          if (rec == nullptr) fail = true;
        }
        for (int i = 0; i < w->nbufs; ++i) PyBuffer_Release(&w->bufs[i]);
        free(w->iov);
        free(w->bufs);
        free(w);
      }
    }
    if (rec != nullptr) {
      if (PyList_Append(out, rec) < 0) fail = true;
      Py_DECREF(rec);
    }
    ++head;
  }
  __atomic_store_n(u->cq_head, head, __ATOMIC_RELEASE);
  if (fail) {
    Py_DECREF(out);
    return nullptr;
  }
  return out;
}

PyObject* ring_wait(PyObject* o, PyObject* args) {
  RingObject* self = reinterpret_cast<RingObject*>(o);
  long timeout_ms = 500;
  if (!PyArg_ParseTuple(args, "|l", &timeout_ms)) return nullptr;
  if (self->closed) {
    PyErr_SetString(PyExc_ValueError, "ring closed");
    return nullptr;
  }
  return self->backend == 1 ? uring_wait(self, timeout_ms)
                            : batch_wait(self, timeout_ms);
}

// ------------------------------------------------------ flush_writes --
// flush_writes([(fd, (buf, buf, ...)), ...]) -> [(fd, res, errno), ...]
//
// batch: every socket's gather batch leaves via writev loops in ONE
// GIL-released section; res = bytes written (caller compares with its
// total: res < total means EAGAIN parked the rest), errno != 0 only
// for real socket errors.
// uring: submits WRITEV SQEs (buffers pinned until their CQEs) and
// returns (fd, -1, 0) markers; the results arrive as OP_WRITEV
// completions from wait().
PyObject* ring_flush_writes(PyObject* o, PyObject* arg) {
  RingObject* self = reinterpret_cast<RingObject*>(o);
  if (self->closed) {
    PyErr_SetString(PyExc_ValueError, "ring closed");
    return nullptr;
  }
  PyObject* seq = PySequence_Fast(arg, "flush_writes expects a sequence");
  if (seq == nullptr) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  struct Entry {
    int fd;
    struct iovec* iov;
    Py_buffer* bufs;
    int nbufs;
    size_t total;
    ssize_t written;
    int err;
  };
  Entry* ents = static_cast<Entry*>(malloc((n ? n : 1) * sizeof(Entry)));
  if (ents == nullptr) {
    Py_DECREF(seq);
    return PyErr_NoMemory();
  }
  Py_ssize_t ne = 0;
  bool fail = false;
  for (Py_ssize_t i = 0; i < n && !fail; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
    int fd;
    PyObject* views;
    if (!PyArg_ParseTuple(item, "iO", &fd, &views)) {
      fail = true;
      break;
    }
    PyObject* vseq = PySequence_Fast(views, "buffer list expected");
    if (vseq == nullptr) {
      fail = true;
      break;
    }
    Py_ssize_t nv = PySequence_Fast_GET_SIZE(vseq);
    Entry* e = &ents[ne];
    e->fd = fd;
    e->nbufs = 0;
    e->total = 0;
    e->written = 0;
    e->err = 0;
    e->iov = static_cast<struct iovec*>(malloc((nv ? nv : 1) *
                                               sizeof(struct iovec)));
    e->bufs = static_cast<Py_buffer*>(malloc((nv ? nv : 1) *
                                             sizeof(Py_buffer)));
    if (e->iov == nullptr || e->bufs == nullptr) {
      free(e->iov);
      free(e->bufs);
      Py_DECREF(vseq);
      fail = true;
      break;
    }
    ++ne;
    for (Py_ssize_t j = 0; j < nv; ++j) {
      if (PyObject_GetBuffer(PySequence_Fast_GET_ITEM(vseq, j),
                             &e->bufs[e->nbufs], PyBUF_SIMPLE) < 0) {
        fail = true;
        break;
      }
      e->iov[e->nbufs].iov_base = e->bufs[e->nbufs].buf;
      e->iov[e->nbufs].iov_len = static_cast<size_t>(e->bufs[e->nbufs].len);
      e->total += static_cast<size_t>(e->bufs[e->nbufs].len);
      ++e->nbufs;
    }
    Py_DECREF(vseq);
  }
  if (fail) {
    for (Py_ssize_t i = 0; i < ne; ++i) {
      for (int j = 0; j < ents[i].nbufs; ++j)
        PyBuffer_Release(&ents[i].bufs[j]);
      free(ents[i].iov);
      free(ents[i].bufs);
    }
    free(ents);
    Py_DECREF(seq);
    return nullptr;
  }
  PyObject* out = PyList_New(0);
  if (out == nullptr) {
    free(ents);
    Py_DECREF(seq);
    return nullptr;
  }
  if (self->backend == 1) {
    // uring: pin buffers, submit, settle via wait() completions
    for (Py_ssize_t i = 0; i < ne; ++i) {
      Entry* e = &ents[i];
      struct io_uring_sqe* sqe = uring_get_sqe(&self->u);
      InflightWrite* w = static_cast<InflightWrite*>(
          sqe == nullptr ? nullptr : malloc(sizeof(InflightWrite)));
      if (w == nullptr) {
        // SQ full / OOM: report a would-block (0 bytes) so the caller
        // parks through the classic writable-event path
        for (int j = 0; j < e->nbufs; ++j) PyBuffer_Release(&e->bufs[j]);
        free(e->iov);
        free(e->bufs);
        PyObject* rec = Py_BuildValue("iii", e->fd, 0, 0);
        if (rec == nullptr || PyList_Append(out, rec) < 0) fail = true;
        Py_XDECREF(rec);
        continue;
      }
      uint64_t tag = TAG_WRITE | (++self->write_seq & 0xFFFFFFFFFFFFFFULL);
      sqe->opcode = IORING_OP_WRITEV;
      sqe->fd = e->fd;
      sqe->addr = reinterpret_cast<uint64_t>(e->iov);
      sqe->len = static_cast<uint32_t>(e->nbufs);
      sqe->user_data = tag;
      w->tag = tag;
      w->fd = e->fd;
      w->gen = (e->fd >= 0 && e->fd < self->cap && self->slots[e->fd].used)
                   ? self->slots[e->fd].gen
                   : 0;
      w->iov = e->iov;
      w->bufs = e->bufs;
      w->nbufs = e->nbufs;
      w->total = e->total;
      w->next = self->inflight_writes;
      self->inflight_writes = w;
      PyObject* rec = Py_BuildValue("iii", e->fd, -1, 0);  // pending
      if (rec == nullptr || PyList_Append(out, rec) < 0) fail = true;
      Py_XDECREF(rec);
    }
    if (uring_pending(&self->u))
      syscall(__NR_io_uring_enter, self->u.ring_fd, uring_pending(&self->u),
              0, 0, nullptr, 0);
    free(ents);
    Py_DECREF(seq);
    if (fail) {
      Py_DECREF(out);
      return nullptr;
    }
    return out;
  }
  Py_BEGIN_ALLOW_THREADS
  for (Py_ssize_t i = 0; i < ne; ++i) {
    Entry* e = &ents[i];
    struct iovec* iov = e->iov;
    int cnt = e->nbufs;
    while (cnt > 0) {
      fc_sys_send.fetch_add(1, std::memory_order_relaxed);
      ssize_t rc = writev(e->fd, iov, cnt > IOV_MAX ? IOV_MAX : cnt);
      if (rc < 0) {
        if (errno == EINTR) continue;
        if (errno != EAGAIN && errno != EWOULDBLOCK) e->err = errno;
        break;
      }
      e->written += rc;
      size_t left = static_cast<size_t>(rc);
      while (cnt > 0 && left >= iov->iov_len) {
        left -= iov->iov_len;
        ++iov;
        --cnt;
      }
      if (left > 0) {
        iov->iov_base = static_cast<char*>(iov->iov_base) + left;
        iov->iov_len -= left;
        // partial into a block: the kernel buffer is full — a retry
        // is a guaranteed EAGAIN; park the rest with the caller
        break;
      }
    }
  }
  Py_END_ALLOW_THREADS
  for (Py_ssize_t i = 0; i < ne && !fail; ++i) {
    Entry* e = &ents[i];
    PyObject* rec = Py_BuildValue("ini", e->fd,
                                  static_cast<Py_ssize_t>(e->written),
                                  e->err);
    if (rec == nullptr || PyList_Append(out, rec) < 0) fail = true;
    Py_XDECREF(rec);
  }
  for (Py_ssize_t i = 0; i < ne; ++i) {
    for (int j = 0; j < ents[i].nbufs; ++j) PyBuffer_Release(&ents[i].bufs[j]);
    free(ents[i].iov);
    free(ents[i].bufs);
  }
  free(ents);
  Py_DECREF(seq);
  if (fail) {
    Py_DECREF(out);
    return nullptr;
  }
  return out;
}

PyMethodDef ring_methods[] = {
    {"register_fd", ring_register_fd, METH_VARARGS,
     "register_fd(fd, kind): kind 0=data (native recv), 1=accept, "
     "2=poll-only (readiness callback, no consumption)"},
    {"unregister_fd", ring_unregister_fd, METH_O,
     "unregister_fd(fd): drop the fd from the interest set (uring: "
     "cancels its in-flight ops; late CQEs are reaped and dropped)"},
    {"set_read", ring_set_read, METH_VARARGS,
     "set_read(fd, on): arm/disarm read interest (pause/resume)"},
    {"request_writable", ring_request_writable, METH_O,
     "request_writable(fd): one-shot POLLOUT interest -> OP_WRITABLE"},
    {"wait", ring_wait, METH_VARARGS,
     "wait(timeout_ms=500) -> [(fd, op, res, payload), ...]: ONE "
     "GIL-released pass — poll + the whole ready-set's recv/accept "
     "bursts (batch) or submit+reap (uring)"},
    {"flush_writes", ring_flush_writes, METH_O,
     "flush_writes([(fd, (buf, ...)), ...]) -> [(fd, res, errno), ...]: "
     "the submission ring's write half — every batch entry leaves as "
     "one gather writev in one GIL-released section (uring: SQEs; "
     "results arrive as OP_WRITEV completions)"},
    {"backend_name", ring_backend_name, METH_NOARGS,
     "backend_name() -> 'batch' | 'uring'"},
    {"close", ring_close, METH_NOARGS,
     "close(): release the native ring (fork hygiene)"},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject RingType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "_brpc_fastcore.Ring",          // tp_name
    sizeof(RingObject),             // tp_basicsize
};

PyObject* fc_syscall_counts(PyObject*, PyObject*) {
  return Py_BuildValue(
      "KKKK", fc_sys_recv.load(std::memory_order_relaxed),
      fc_sys_send.load(std::memory_order_relaxed),
      fc_sys_accept.load(std::memory_order_relaxed),
      fc_sys_poll.load(std::memory_order_relaxed));
}

PyMethodDef ring_module_methods[] = {
    {"syscall_counts", fc_syscall_counts, METH_NOARGS,
     "syscall_counts() -> (recv, send, accept, poll): process-wide "
     "native-boundary syscall counters (ring lane + fastcore fd "
     "loops) — transport/syscall_stats.py merges them with the "
     "Python-side conn counters into syscalls_per_rpc"},
    {nullptr, nullptr, 0, nullptr},
};

}  // namespace

// Called from fastcore.cc's PyInit: adds the Ring type + the syscall
// counter accessor to the module.
extern "C" int fc_ring_add_to_module(PyObject* m) {
  RingType.tp_flags = Py_TPFLAGS_DEFAULT;
  RingType.tp_doc =
      "batched-syscall submission/completion event lane (io_uring-style); "
      "Ring(backend=0) with backend 0=auto, 1=force batch, 2=force uring "
      "(raises OSError when the kernel probe fails)";
  RingType.tp_new = ring_new;
  RingType.tp_dealloc = ring_dealloc;
  RingType.tp_methods = ring_methods;
  if (PyType_Ready(&RingType) < 0) return -1;
  if (PyModule_AddObjectRef(m, "Ring",
                            reinterpret_cast<PyObject*>(&RingType)) < 0)
    return -1;
  for (PyMethodDef* def = ring_module_methods; def->ml_name != nullptr;
       ++def) {
    PyObject* fn = PyCFunction_New(def, nullptr);
    if (fn == nullptr || PyModule_AddObject(m, def->ml_name, fn) < 0) {
      Py_XDECREF(fn);
      return -1;
    }
  }
  return 0;
}
