// _brpc_fastcore: CPython extension over the native cores.
//
// The ctypes ABI (native/__init__.py) is fine for bulk ops (crc32c over
// megabytes) but costs ~1us per call — useless for per-RPC hops. This
// extension exposes the same native cores through the CPython C API
// (~50ns per call) so they can sit on the per-call hot path:
//
//   pack_frame   one-allocation tpu_std frame assembly (header + cached
//                meta prefix + hand-encoded varint fields + payload +
//                attachment) — the native form of PackRpcRequest /
//                SendRpcResponse framing (baidu_rpc_protocol.cpp:646,139)
//   parse_head   header probe + contiguous meta extraction (the per-frame
//                core of ParseRpcMessage, baidu_rpc_protocol.cpp:95)
//   Pool         respool.cc versioned-id pool holding PyObject* — the
//                correlation-id (bthread/id.h:46) and Socket versioned-
//                ref (socket.cpp:776-800) id space
//   Mpsc         queues.cc wait-free MPSC with the writer-retire
//                protocol — the Socket write-queue arbitration
//                (socket.cpp StartWrite:1924 / IsWriteComplete)
//
// Built into its own module (_brpc_fastcore.so) next to the ctypes
// library; loaded by brpc_tpu_torch.native.fastcore with pure-Python fallback.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <errno.h>
#include <poll.h>
#include <sys/socket.h>
#include <time.h>

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>

// ---- C cores (compiled into this module; see respool.cc / queues.cc)
struct bt_respool;
struct bt_mpsc;
extern "C" {
bt_respool* bt_respool_create(size_t max_items);
void bt_respool_destroy(bt_respool*);
uint64_t bt_respool_acquire(bt_respool*, uint64_t value);
bool bt_respool_get(bt_respool*, uint64_t id, uint64_t* value);
bool bt_respool_release(bt_respool*, uint64_t id);
uint64_t bt_respool_live(bt_respool*);

bt_mpsc* bt_mpsc_create();
void bt_mpsc_destroy(bt_mpsc*);
bool bt_mpsc_push(bt_mpsc*, uint64_t v);
size_t bt_mpsc_drain_w(bt_mpsc*, uint64_t* out, size_t max);
bool bt_mpsc_try_retire(bt_mpsc*);
uint64_t bt_mpsc_pushed(bt_mpsc*);
uint64_t bt_mpsc_drained(bt_mpsc*);
}

// httpparse.cc — native HTTP/1.x head parsing (request + response)
PyObject* fc_http_parse_request(PyObject*, PyObject*);
PyObject* fc_http_parse_resp_head(PyObject*, PyObject*);

// ring.cc — the batched-syscall event lane (Ring type + the
// process-wide native-boundary syscall counters the fd loops below
// stamp; syscall_stats.py derives syscalls_per_rpc from them)
extern "C" int fc_ring_add_to_module(PyObject* m);
extern std::atomic<unsigned long long> fc_sys_recv;
extern std::atomic<unsigned long long> fc_sys_send;
extern std::atomic<unsigned long long> fc_sys_accept;
extern std::atomic<unsigned long long> fc_sys_poll;

namespace {

// ------------------------------------------------------------- varint --
inline size_t varint_len(uint64_t v) {
  size_t n = 1;
  while (v >= 0x80) { v >>= 7; ++n; }
  return n;
}

inline char* varint_write(char* p, uint64_t v) {
  while (v >= 0x80) {
    *p++ = static_cast<char>(v | 0x80);
    v >>= 7;
  }
  *p++ = static_cast<char>(v);
  return p;
}

constexpr char kTagCorrelationId = 0x20;   // RpcMeta field 4, varint
constexpr char kTagAttachmentSize = 0x28;  // RpcMeta field 5, varint

inline void store_be32(char* p, uint32_t v) {
  p[0] = static_cast<char>(v >> 24);
  p[1] = static_cast<char>(v >> 16);
  p[2] = static_cast<char>(v >> 8);
  p[3] = static_cast<char>(v);
}

inline uint32_t load_be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// --------------------------------------------------------- pack_frame --
// pack_frame(magic: 4 bytes, meta_prefix, cid: int, payload, attachment)
//   -> bytes    (one allocation, one pass)
PyObject* fc_pack_frame(PyObject*, PyObject* args) {
  Py_buffer magic, prefix, payload, att;
  unsigned long long cid;
  if (!PyArg_ParseTuple(args, "y*y*Ky*y*", &magic, &prefix, &cid, &payload,
                        &att))
    return nullptr;
  if (magic.len != 4) {
    PyBuffer_Release(&magic); PyBuffer_Release(&prefix);
    PyBuffer_Release(&payload); PyBuffer_Release(&att);
    PyErr_SetString(PyExc_ValueError, "magic must be 4 bytes");
    return nullptr;
  }
  size_t cid_field = 1 + varint_len(cid);
  size_t att_field = att.len ? 1 + varint_len(att.len) : 0;
  size_t meta_size = prefix.len + cid_field + att_field;
  size_t body = meta_size + payload.len + att.len;
  size_t total = 12 + body;
  if (body > 0xFFFFFFFFull) {
    // the wire header carries u32 sizes: refuse loudly instead of
    // truncating and desyncing the connection (the Python fallback
    // raises struct.error for the same reason)
    PyBuffer_Release(&magic); PyBuffer_Release(&prefix);
    PyBuffer_Release(&payload); PyBuffer_Release(&att);
    PyErr_SetString(PyExc_OverflowError,
                    "frame body exceeds u32 wire header");
    return nullptr;
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr, total);
  if (out != nullptr) {
    char* p = PyBytes_AS_STRING(out);
    memcpy(p, magic.buf, 4);
    store_be32(p + 4, static_cast<uint32_t>(body));
    store_be32(p + 8, static_cast<uint32_t>(meta_size));
    p += 12;
    memcpy(p, prefix.buf, prefix.len);
    p += prefix.len;
    *p++ = kTagCorrelationId;
    p = varint_write(p, cid);
    if (att_field) {
      *p++ = kTagAttachmentSize;
      p = varint_write(p, att.len);
    }
    memcpy(p, payload.buf, payload.len);
    p += payload.len;
    memcpy(p, att.buf, att.len);
  }
  PyBuffer_Release(&magic); PyBuffer_Release(&prefix);
  PyBuffer_Release(&payload); PyBuffer_Release(&att);
  return out;
}

// ----------------------------------------------------- pack_frame_head --
// pack_frame_head(magic, meta_prefix, cid, att_size, tail_len) -> bytes
// Header + meta for a frame whose payload/attachment stay OUT of the
// allocation (they ride as zero-copy IOBuf refs behind this head):
// body_size = meta_size + tail_len + att_size. One allocation, no
// Python-side byte joins — the big-frame twin of pack_frame (the
// small-frame path flattens payload+attachment into the same buffer;
// a 1MB attachment must not).
PyObject* fc_pack_frame_head(PyObject*, PyObject* args) {
  Py_buffer magic, prefix;
  unsigned long long cid, att, tail;
  if (!PyArg_ParseTuple(args, "y*y*KKK", &magic, &prefix, &cid, &att, &tail))
    return nullptr;
  if (magic.len != 4) {
    PyBuffer_Release(&magic); PyBuffer_Release(&prefix);
    PyErr_SetString(PyExc_ValueError, "magic must be 4 bytes");
    return nullptr;
  }
  size_t cid_field = 1 + varint_len(cid);
  size_t att_field = att ? 1 + varint_len(att) : 0;
  size_t meta_size = prefix.len + cid_field + att_field;
  size_t body = meta_size + tail + att;
  if (body > 0xFFFFFFFFull) {
    PyBuffer_Release(&magic); PyBuffer_Release(&prefix);
    PyErr_SetString(PyExc_OverflowError,
                    "frame body exceeds u32 wire header");
    return nullptr;
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr, 12 + meta_size);
  if (out != nullptr) {
    char* p = PyBytes_AS_STRING(out);
    memcpy(p, magic.buf, 4);
    store_be32(p + 4, static_cast<uint32_t>(body));
    store_be32(p + 8, static_cast<uint32_t>(meta_size));
    p += 12;
    memcpy(p, prefix.buf, prefix.len);
    p += prefix.len;
    *p++ = kTagCorrelationId;
    p = varint_write(p, cid);
    if (att_field) {
      *p++ = kTagAttachmentSize;
      varint_write(p, att);
    }
  }
  PyBuffer_Release(&magic); PyBuffer_Release(&prefix);
  return out;
}

// --------------------------------------------------------- parse_head --
// parse_head(view, magic) ->
//   None                                  view shorter than a header
//   -1                                    not this protocol's bytes
//   (body_size, meta_size, meta|None)     header parsed; meta bytes when
//                                         fully inside the view
PyObject* fc_parse_head(PyObject*, PyObject* args) {
  Py_buffer view, magic;
  if (!PyArg_ParseTuple(args, "y*y*", &view, &magic)) return nullptr;
  PyObject* r;
  const unsigned char* d = static_cast<const unsigned char*>(view.buf);
  if (view.len < 12) {
    // short window: a prefix that already mismatches the magic is a
    // definitive disclaim, otherwise wait for more bytes
    Py_ssize_t n = view.len < magic.len ? view.len : magic.len;
    if (memcmp(d, magic.buf, n) != 0)
      r = PyLong_FromLong(-1);
    else
      r = Py_NewRef(Py_None);
  } else if (memcmp(d, magic.buf, 4) != 0) {
    r = PyLong_FromLong(-1);
  } else {
    uint32_t body = load_be32(d + 4);
    uint32_t meta = load_be32(d + 8);
    if (meta > body) {
      r = PyLong_FromLong(-1);
    } else {
      PyObject* mb;
      // 64-bit compare: `12 + meta` in u32 arithmetic wraps for meta
      // near UINT32_MAX and would defeat this bounds check (a remote
      // peer controls meta — this guard is load-bearing)
      if (view.len - 12 >= static_cast<Py_ssize_t>(meta))
        mb = PyBytes_FromStringAndSize(
            reinterpret_cast<const char*>(d) + 12, meta);
      else
        mb = Py_NewRef(Py_None);
      r = mb ? Py_BuildValue("IIN", body, meta, mb) : nullptr;
    }
  }
  PyBuffer_Release(&view); PyBuffer_Release(&magic);
  return r;
}

// -------------------------------------------------------- scan_frames --
// The per-call loop's native core: one call over the drained input
// window scans every complete tpu_std frame AND decodes the RpcMeta
// subset the dispatch path needs — the moral equivalent of the
// reference's in-place last-message processing, where frame cut, meta
// decode and dispatch routing are C++ end to end
// (input_messenger.cpp:219-331 + baidu_rpc_protocol.cpp:95,314).
//
// scan_frames(view, magic, max_body, max_frames)
//   -> (consumed_bytes, [frame, ...])
// frame (fast request):  (0, cid, service, method, log_id,
//                         payload_off, payload_len, att_off, att_len)
// frame (fast response): (1, cid, error_code, error_text|None,
//                         payload_off, payload_len, att_off, att_len)
// The scan STOPS (without consuming) at the first frame that is
// incomplete, oversized, non-matching, or carries slow-path features
// (compression, streams, device payloads, auth, rpcz propagation,
// unknown fields) — the Python classic path handles those from the
// stop offset with full protobuf semantics.

struct MetaScan {
  uint64_t cid = 0;
  uint64_t att = 0;
  uint64_t log_id = 0;
  uint64_t timeout_ms = 0;  // RpcRequestMeta.timeout_ms (0 = absent)
  // judge-or-defer posture for timeout-bearing requests: true (the
  // scan/dispatch lanes) defers them to the classic lane, which is the
  // single deadline authority (stamp arrival, shed expired —
  // rpc/server_dispatch.py); false (the pure-C echo loops) ENFORCES
  // instead — they serve at the instant of arrival, so the remaining
  // budget equals the whole budget and a shed can never be due.
  bool defer_timeout = true;
  int kind = -1;  // 0 request, 1 response, 2 stream frame
  const char* svc = nullptr; size_t svc_len = 0;
  const char* mth = nullptr; size_t mth_len = 0;
  int32_t err_code = 0;
  const char* err = nullptr; size_t err_len = 0;
  uint64_t stream_id = 0;   // kind 2 (StreamSettings)
  uint64_t frame_seq = 0;
  uint64_t s_credits = 0;
  bool s_close = false;
  uint32_t meta_size = 0;  // filled by cut_fast_frame
  uint32_t body = 0;
};

inline bool read_varint(const unsigned char*& p, const unsigned char* end,
                        uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    unsigned char b = *p++;
    v |= uint64_t(b & 0x7F) << shift;
    if (!(b & 0x80)) { *out = v; return true; }
    shift += 7;
  }
  return false;
}

// returns false => slow path (unknown/truncated/feature-bearing)
inline bool walk_request_meta(const unsigned char* p,
                              const unsigned char* end, MetaScan* m) {
  while (p < end) {
    uint64_t key, len;
    if (!read_varint(p, end, &key)) return false;
    switch (key) {
      case (1u << 3) | 2:  // service_name
        if (!read_varint(p, end, &len) || uint64_t(end - p) < len)
          return false;
        m->svc = reinterpret_cast<const char*>(p); m->svc_len = len;
        p += len;
        break;
      case (2u << 3) | 2:  // method_name
        if (!read_varint(p, end, &len) || uint64_t(end - p) < len)
          return false;
        m->mth = reinterpret_cast<const char*>(p); m->mth_len = len;
        p += len;
        break;
      case (3u << 3) | 0:  // log_id
        if (!read_varint(p, end, &m->log_id)) return false;
        break;
      case (4u << 3) | 0:  // timeout_ms: the client's deadline budget —
        // deadline propagation makes this field load-bearing:
        // the classic lane stamps arrival and sheds expired requests,
        // so a fast lane may not silently drop it. Scan/dispatch lanes
        // defer (the record does not carry a budget); the echo loops
        // enforce by construction (see MetaScan.defer_timeout).
        if (!read_varint(p, end, &m->timeout_ms)) return false;
        if (m->defer_timeout && m->timeout_ms != 0) return false;
        break;
      default:
        return false;  // auth_token or unknown: slow path
    }
  }
  return true;
}

inline bool walk_response_meta(const unsigned char* p,
                               const unsigned char* end, MetaScan* m) {
  while (p < end) {
    uint64_t key, len;
    if (!read_varint(p, end, &key)) return false;
    switch (key) {
      case (1u << 3) | 0: {  // error_code (int32 as varint)
        uint64_t v;
        if (!read_varint(p, end, &v)) return false;
        m->err_code = static_cast<int32_t>(v);
        break;
      }
      case (2u << 3) | 2:  // error_text
        if (!read_varint(p, end, &len) || uint64_t(end - p) < len)
          return false;
        m->err = reinterpret_cast<const char*>(p); m->err_len = len;
        p += len;
        break;
      default:
        return false;
    }
  }
  return true;
}

// StreamSettings submessage (tpu_rpc_meta.proto): stream_id=1,
// need_feedback=2 (defers — the scan record does not carry it, so the
// classic lane must render any frame where it is set), frame_seq=3,
// credits=4 (int32 on the wire: out-of-range varints defer so the
// classic parser's int32 semantics stay the single verdict), close=5
// — the whole vocabulary of a live stream frame
inline bool walk_stream_meta(const unsigned char* p,
                             const unsigned char* end, MetaScan* m) {
  while (p < end) {
    uint64_t key, v;
    if (!read_varint(p, end, &key)) return false;
    switch (key) {
      case (1u << 3) | 0:
        if (!read_varint(p, end, &m->stream_id)) return false;
        break;
      case (2u << 3) | 0:  // need_feedback: not in the scan record —
        // a fast-lane frame materializing meta would show False where
        // the classic lane shows True. Defer set bits (judge-or-defer)
        if (!read_varint(p, end, &v)) return false;
        if (v != 0) return false;
        break;
      case (3u << 3) | 0:
        if (!read_varint(p, end, &m->frame_seq)) return false;
        break;
      case (4u << 3) | 0:  // credits: declared int32 — a negative
        // (10-byte varint) or > INT32_MAX value must not ride the fast
        // lane as a huge credit grant while the classic lane sees a
        // negative int32; defer and let the classic parser judge
        if (!read_varint(p, end, &m->s_credits)) return false;
        if (m->s_credits > 0x7FFFFFFFull) return false;
        break;
      case (5u << 3) | 0:
        if (!read_varint(p, end, &v)) return false;
        m->s_close = v != 0;
        break;
      default:
        return false;
    }
  }
  return m->stream_id != 0;  // frames to stream 0 are garbage: slow path
}

inline bool walk_meta(const unsigned char* p, const unsigned char* end,
                      MetaScan* m) {
  while (p < end) {
    uint64_t key, len;
    if (!read_varint(p, end, &key)) return false;
    switch (key) {
      case (1u << 3) | 2:  // request submessage
        if (m->kind != -1) return false;
        if (!read_varint(p, end, &len) || uint64_t(end - p) < len)
          return false;
        if (!walk_request_meta(p, p + len, m)) return false;
        m->kind = 0;
        p += len;
        break;
      case (2u << 3) | 2:  // response submessage
        if (m->kind != -1) return false;
        if (!read_varint(p, end, &len) || uint64_t(end - p) < len)
          return false;
        if (!walk_response_meta(p, p + len, m)) return false;
        m->kind = 1;
        p += len;
        break;
      case (3u << 3) | 0: {  // compress_type: nonzero = slow
        uint64_t v;
        if (!read_varint(p, end, &v)) return false;
        if (v != 0) return false;
        break;
      }
      case (4u << 3) | 0:
        if (!read_varint(p, end, &m->cid)) return false;
        break;
      case (5u << 3) | 0:
        // attachment_size is int32: values past INT32_MAX (including
        // negatives, which arrive as 10-byte varints) fail the classic
        // parse — defer so it renders that verdict (the downstream
        // att > body bound would also catch these, but the invariant
        // belongs where the field is admitted)
        if (!read_varint(p, end, &m->att)) return false;
        if (m->att > 0x7FFFFFFFull) return false;
        break;
      case (6u << 3) | 2:  // stream_settings: a live stream frame —
        // but establishment (request + stream_settings) and anything
        // response/cid-bearing keeps full classic semantics
        if (m->kind != -1) return false;
        if (!read_varint(p, end, &len) || uint64_t(end - p) < len)
          return false;
        if (!walk_stream_meta(p, p + len, m)) return false;
        m->kind = 2;
        p += len;
        break;
      default:
        // device_payloads / trace ids / unknown
        return false;
    }
  }
  if (m->kind == -1) {
    // bare meta (cid + attachment only): the server's small-response
    // framing — a success response. A cid-less bare meta is a stream
    // frame or garbage: slow path decides.
    if (m->cid == 0) return false;
    m->kind = 1;
  }
  if (m->kind == 2 && m->cid != 0)
    return false;  // non-canonical field order hid a correlation id
  return true;
}

// cut + validate ONE fast frame at `off`: header sane, body within
// max_body, meta walk clean, attachment bounds honest. Returns the
// frame's total size, or -1 (stop: incomplete / oversized / slow /
// not this magic). Shared by scan_frames and serve_scan so their
// eligibility ladders can never diverge.
//
// max_stream_body (0 = off): a relaxed bound for LIVE STREAM frames
// only — a data frame's payload is opaque bytes heading for one
// delivery callback, so size does not change its dispatch eligibility
// the way it does for requests (whose oversized bodies belong to
// cut-through/classic assembly). The frame must be COMPLETE in the
// window; request/response frames over max_body still stop the scan.
inline Py_ssize_t cut_fast_frame(const unsigned char* d, Py_ssize_t off,
                                 Py_ssize_t len, const void* magic,
                                 Py_ssize_t max_body, MetaScan* m,
                                 Py_ssize_t max_stream_body = 0) {
  if (off + 12 > len) return -1;
  const unsigned char* h = d + off;
  if (memcmp(h, magic, 4) != 0) return -1;
  uint32_t body = load_be32(h + 4);
  uint32_t meta_size = load_be32(h + 8);
  if (meta_size > body) return -1;
  const bool oversized = Py_ssize_t(body) > max_body;
  if (oversized &&
      (max_stream_body <= 0 || Py_ssize_t(body) > max_stream_body))
    return -1;
  Py_ssize_t total = 12 + Py_ssize_t(body);
  if (off + total > len) return -1;
  if (!walk_meta(h + 12, h + 12 + meta_size, m)) return -1;
  if (oversized && m->kind != 2)
    return -1;  // big request/response: cut-through/classic territory
  if (m->att > body - meta_size) return -1;  // lying size: classic fails it
  m->meta_size = meta_size;
  m->body = body;
  return total;
}

PyObject* fc_scan_frames(PyObject*, PyObject* args) {
  Py_buffer view, magic;
  Py_ssize_t max_body = 32768;
  Py_ssize_t max_frames = 128;
  Py_ssize_t max_stream_body = 0;
  // materialize=1: records carry payload/attachment as BYTES instead
  // of (offset, length) pairs — the whole batch of per-frame slices
  // happens inside this one call, so a pipelined burst pays zero
  // Python-side slicing (turbo_scan hands the list straight to
  // turbo_dispatch). Offsets mode stays for callers that subscript
  // the window themselves.
  Py_ssize_t materialize = 0;
  if (!PyArg_ParseTuple(args, "y*y*|nnnn", &view, &magic, &max_body,
                        &max_frames, &max_stream_body, &materialize))
    return nullptr;
  const unsigned char* d = static_cast<const unsigned char*>(view.buf);
  Py_ssize_t off = 0;
  PyObject* frames = PyList_New(0);
  if (frames == nullptr || magic.len != 4) {
    PyBuffer_Release(&view); PyBuffer_Release(&magic);
    if (frames != nullptr) {
      Py_DECREF(frames);
      PyErr_SetString(PyExc_ValueError, "magic must be 4 bytes");
    }
    return nullptr;
  }
  bool fail = false;
  while (PyList_GET_SIZE(frames) < max_frames) {
    MetaScan m;
    Py_ssize_t total = cut_fast_frame(d, off, view.len, magic.buf,
                                      max_body, &m, max_stream_body);
    if (total < 0) break;
    Py_ssize_t p_off = off + 12 + m.meta_size;
    Py_ssize_t p_len = Py_ssize_t(m.body - m.meta_size - m.att);
    Py_ssize_t a_off = p_off + p_len;
    Py_ssize_t a_len = Py_ssize_t(m.att);
    PyObject* pay = nullptr;
    PyObject* att = nullptr;
    if (materialize) {
      pay = PyBytes_FromStringAndSize(
          reinterpret_cast<const char*>(d) + p_off, p_len);
      att = pay == nullptr ? nullptr : PyBytes_FromStringAndSize(
          reinterpret_cast<const char*>(d) + a_off, a_len);
      if (att == nullptr) {
        Py_XDECREF(pay);
        fail = true;
        break;
      }
    }
    PyObject* rec;
    if (m.kind == 2) {
      // live stream frame: (2, stream_id, frame_seq, credits, close,
      // payload_off, payload_len, att_off, att_len) — or with
      // materialize, payload/attachment bytes in the offsets' place
      rec = materialize ? Py_BuildValue(
          "iKKKiNN", 2, (unsigned long long)m.stream_id,
          (unsigned long long)m.frame_seq,
          (unsigned long long)m.s_credits, (int)(m.s_close ? 1 : 0),
          pay, att) : Py_BuildValue(
          "iKKKinnnn", 2, (unsigned long long)m.stream_id,
          (unsigned long long)m.frame_seq,
          (unsigned long long)m.s_credits, (int)(m.s_close ? 1 : 0),
          p_off, p_len, a_off, a_len);
    } else if (m.kind == 0) {
      // service/method are proto3 strings: decode STRICTLY, but a
      // peer sending invalid UTF-8 must stop the scan (slow path —
      // the classic protobuf parser renders the verdict), not raise
      // out of the scanner mid-drain
      PyObject* svc_s = PyUnicode_DecodeUTF8(
          m.svc ? m.svc : "", (Py_ssize_t)m.svc_len, nullptr);
      PyObject* mth_s = svc_s == nullptr ? nullptr : PyUnicode_DecodeUTF8(
          m.mth ? m.mth : "", (Py_ssize_t)m.mth_len, nullptr);
      if (mth_s == nullptr) {
        Py_XDECREF(svc_s);
        Py_XDECREF(pay); Py_XDECREF(att);
        PyErr_Clear();
        break;
      }
      // log_id is int64 on the wire: negatives arrive as 10-byte
      // varints and must round-trip signed ("L"), not as 2^64-x
      rec = materialize ? Py_BuildValue(
          "iKNNLNN", 0, (unsigned long long)m.cid, svc_s, mth_s,
          (long long)(int64_t)m.log_id, pay, att) : Py_BuildValue(
          "iKNNLnnnn", 0, (unsigned long long)m.cid, svc_s, mth_s,
          (long long)(int64_t)m.log_id, p_off, p_len, a_off, a_len);
    } else {
      PyObject* err_text;
      if (m.err != nullptr) {
        err_text = PyUnicode_DecodeUTF8(m.err, m.err_len, "replace");
        if (err_text == nullptr) {
          Py_XDECREF(pay); Py_XDECREF(att);
          fail = true;
          break;
        }
      } else {
        err_text = Py_NewRef(Py_None);
      }
      rec = materialize ? Py_BuildValue(
          "iKiNNN", 1, (unsigned long long)m.cid, (int)m.err_code,
          err_text, pay, att) : Py_BuildValue(
          "iKiNnnnn", 1, (unsigned long long)m.cid, (int)m.err_code,
          err_text, p_off, p_len, a_off, a_len);
    }
    if (rec == nullptr || PyList_Append(frames, rec) < 0) {
      Py_XDECREF(rec);
      fail = true;
      break;
    }
    Py_DECREF(rec);
    off += total;
  }
  PyBuffer_Release(&view); PyBuffer_Release(&magic);
  if (fail) {
    Py_DECREF(frames);
    return nullptr;
  }
  return Py_BuildValue("nN", off, frames);
}

// --------------------------------------------------------- serve_scan --
// The echo-class serving loop, end to end in C: for every complete
// small fast request frame addressed to (service, method), build the
// response frame (bare meta: correlation id + attachment size, payload
// and attachment reflected) directly into one output buffer. The
// Python side writes that buffer with a single socket call and
// accounts the batch — request parse, dispatch and response pack never
// cross the interpreter, the analog of the reference serving its
// benchmark echo with a compiled handler inside in-place message
// processing (baidu_rpc_protocol.cpp:314 + input_messenger.cpp:219).
//
// serve_scan(view, magic, service, method, max_body)
//   -> (consumed, out_bytes, n_served)
// Stops (without consuming) at the first frame that is incomplete,
// oversized, slow-featured, or addressed elsewhere — those take the
// normal dispatch paths.

// Shared echo-serve core (serve_scan over a portal view, serve_drain
// over the thread-local recv buffer): scan the front run of eligible
// request frames in [d, d+len) and prebuild their response frames —
// two passes (measure, then write into one exact-size bytes object).
// Returns the response bytes (possibly empty) or nullptr on allocation
// failure; *off_out = consumed bytes, *n_out = frames served. ONE copy
// of the eligibility ladder and the response meta layout, so the two
// entry points cannot diverge.
PyObject* serve_core(const unsigned char* d, Py_ssize_t len,
                     const void* magic, const Py_buffer& svc,
                     const Py_buffer& mth, Py_ssize_t max_body,
                     Py_ssize_t* off_out, Py_ssize_t* n_out) {
  Py_ssize_t off = 0;
  Py_ssize_t n_served = 0;
  Py_ssize_t out_size = 0;
  struct Item { Py_ssize_t off; MetaScan m; };
  Item items[128];
  while (n_served < 128) {
    MetaScan m;
    // echo loop: serve-at-arrival enforces the deadline trivially
    // (remaining == whole budget), so timeout-bearing frames stay
    // eligible here — see MetaScan.defer_timeout
    m.defer_timeout = false;
    Py_ssize_t total = cut_fast_frame(d, off, len, magic, max_body, &m);
    if (total < 0) break;
    if (m.kind != 0) break;
    if (m.svc_len != size_t(svc.len) || m.mth_len != size_t(mth.len) ||
        memcmp(m.svc, svc.buf, svc.len) != 0 ||
        memcmp(m.mth, mth.buf, mth.len) != 0)
      break;
    Py_ssize_t p_len = Py_ssize_t(m.body - m.meta_size - m.att);
    size_t resp_meta = 1 + varint_len(m.cid) +
                       (m.att ? 1 + varint_len(m.att) : 0);
    out_size += 12 + Py_ssize_t(resp_meta) + p_len + Py_ssize_t(m.att);
    items[n_served].off = off;
    items[n_served].m = m;
    ++n_served;
    off += total;
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr, out_size);
  if (out == nullptr) return nullptr;
  char* w = PyBytes_AS_STRING(out);
  for (Py_ssize_t i = 0; i < n_served; ++i) {
    const MetaScan& m = items[i].m;
    const unsigned char* h = d + items[i].off;
    uint32_t meta_size = m.meta_size;
    Py_ssize_t pa_len = Py_ssize_t(m.body - meta_size);  // payload + att
    size_t resp_meta = 1 + varint_len(m.cid) +
                       (m.att ? 1 + varint_len(m.att) : 0);
    memcpy(w, magic, 4);
    store_be32(w + 4, static_cast<uint32_t>(resp_meta + pa_len));
    store_be32(w + 8, static_cast<uint32_t>(resp_meta));
    w += 12;
    *w++ = kTagCorrelationId;
    w = varint_write(w, m.cid);
    if (m.att) {
      *w++ = kTagAttachmentSize;
      w = varint_write(w, m.att);
    }
    memcpy(w, h + 12 + meta_size, pa_len);  // payload + attachment echo
    w += pa_len;
  }
  *off_out = off;
  *n_out = n_served;
  return out;
}

PyObject* fc_serve_scan(PyObject*, PyObject* args) {
  Py_buffer view, magic, svc, mth;
  Py_ssize_t max_body = 32768;
  if (!PyArg_ParseTuple(args, "y*y*y*y*|n", &view, &magic, &svc, &mth,
                        &max_body))
    return nullptr;
  PyObject* r = nullptr;
  if (magic.len != 4) {
    PyErr_SetString(PyExc_ValueError, "magic must be 4 bytes");
  } else {
    Py_ssize_t off = 0, n_served = 0;
    PyObject* out = serve_core(
        static_cast<const unsigned char*>(view.buf), view.len, magic.buf,
        svc, mth, max_body, &off, &n_served);
    if (out != nullptr)
      r = Py_BuildValue("nNn", off, out, n_served);
  }
  PyBuffer_Release(&view); PyBuffer_Release(&magic);
  PyBuffer_Release(&svc); PyBuffer_Release(&mth);
  return r;
}

// ---------------------------------------------------------- fd loops --
// Thread-local scratch for the native socket loops. Safe: only the
// owning OS thread touches its buffer, and the GIL is released solely
// around syscalls (the buffer is not shared across threads).
struct TlBuf {
  unsigned char* p = nullptr;
  size_t cap = 0;
  // reclaimed at thread exit — short-lived threads doing one sync RPC
  // each must not leak a buffer per thread
  ~TlBuf() { free(p); }
};

inline unsigned char* tl_reserve(TlBuf& b, size_t need) {
  if (b.cap < need) {
    size_t ncap = b.cap ? b.cap : 65536;
    while (ncap < need) ncap <<= 1;
    unsigned char* np = static_cast<unsigned char*>(realloc(b.p, ncap));
    if (np == nullptr) return nullptr;
    b.p = np;
    b.cap = ncap;
  }
  return b.p;
}

thread_local TlBuf tl_pluck;
thread_local TlBuf tl_serve;

inline int64_t mono_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

// --------------------------------------------------------- pluck_scan --
// The client sync-pluck lane's native core: ONE call runs the whole
// poll -> recv -> frame-scan receive loop for a sole-in-flight sync RPC
// — the interpreter is crossed once per RPC instead of once per
// poll/drain/parse/dispatch step (the reference's client runs this loop
// compiled inside ProcessEvent/ProcessNewMessage,
// input_messenger.cpp:219-331 + baidu_rpc_protocol.cpp:565).
//
// pluck_scan(fd, magic, cid, slice_ms, max_body, carry)
//   -> (0, err_code, err_text|None, payload, attach, leftover, nread)
//          the fast response frame for `cid` (leftover = bytes after it)
//   -> (1, buffered, nread)   DEFER: anything only the classic path can
//          judge (foreign cid, request frame, slow meta, oversized, bad
//          magic) — buffered is every unconsumed byte, to re-inject
//   -> (2, buffered, nread)   slice elapsed; pass buffered back as `carry`
//   -> (3, errmsg, buffered, nread)   EOF or socket error
// nread = bytes received from the fd by THIS call (excludes the carry)
// — the caller feeds it to the read-traffic bvar the classic drain
// maintains (nreads, socket.py)
//
// The caller owns eligibility (dispatcher paused, portal empty, sole
// in-flight call) — this function only reads the fd and judges frames
// with exactly the scan_frames meta walk (shared cut rules).
PyObject* fc_pluck_scan(PyObject*, PyObject* args) {
  int fd;
  Py_buffer magic, carry;
  unsigned long long cid;
  long slice_ms;
  Py_ssize_t max_body;
  if (!PyArg_ParseTuple(args, "iy*Klny*", &fd, &magic, &cid, &slice_ms,
                        &max_body, &carry))
    return nullptr;
  if (magic.len != 4) {
    PyBuffer_Release(&magic); PyBuffer_Release(&carry);
    PyErr_SetString(PyExc_ValueError, "magic must be 4 bytes");
    return nullptr;
  }
  size_t need = size_t(12 + max_body) + 65536;
  if (size_t(carry.len) + 65536 > need) need = size_t(carry.len) + 65536;
  unsigned char* buf = tl_reserve(tl_pluck, need);
  if (buf == nullptr) {
    PyBuffer_Release(&magic); PyBuffer_Release(&carry);
    return PyErr_NoMemory();
  }
  size_t cap = tl_pluck.cap;
  size_t n = size_t(carry.len);
  if (n) memcpy(buf, carry.buf, n);
  const size_t base = n;  // nread = n - base (carry excluded)
  const unsigned char mg[4] = {
      static_cast<const unsigned char*>(magic.buf)[0],
      static_cast<const unsigned char*>(magic.buf)[1],
      static_cast<const unsigned char*>(magic.buf)[2],
      static_cast<const unsigned char*>(magic.buf)[3]};
  PyBuffer_Release(&magic); PyBuffer_Release(&carry);

  int64_t deadline = mono_ms() + slice_ms;
  for (;;) {
    // ---- judge what we have
    if (n >= 12) {
      if (memcmp(buf, mg, 4) != 0)
        return Py_BuildValue("iy#n", 1, (const char*)buf, (Py_ssize_t)n, (Py_ssize_t)(n - base));
      uint32_t body = load_be32(buf + 4);
      uint32_t meta_size = load_be32(buf + 8);
      if (meta_size > body || Py_ssize_t(body) > max_body)
        return Py_BuildValue("iy#n", 1, (const char*)buf, (Py_ssize_t)n, (Py_ssize_t)(n - base));
      size_t total = 12 + size_t(body);
      if (n >= total) {
        MetaScan m;
        if (!walk_meta(buf + 12, buf + 12 + meta_size, &m) ||
            m.kind != 1 || m.cid != cid || m.att > body - meta_size)
          return Py_BuildValue("iy#n", 1, (const char*)buf, (Py_ssize_t)n, (Py_ssize_t)(n - base));
        size_t p_off = 12 + meta_size;
        size_t p_len = size_t(body - meta_size - m.att);
        PyObject* err_text;
        if (m.err != nullptr) {
          err_text = PyUnicode_DecodeUTF8(m.err, m.err_len, "replace");
          if (err_text == nullptr) return nullptr;
        } else {
          err_text = Py_NewRef(Py_None);
        }
        return Py_BuildValue(
            "iiNy#y#y#n", 0, (int)m.err_code, err_text,
            (const char*)(buf + p_off), (Py_ssize_t)p_len,
            (const char*)(buf + p_off + p_len), (Py_ssize_t)m.att,
            (const char*)(buf + total), (Py_ssize_t)(n - total),
            (Py_ssize_t)(n - base));
      }
    } else if (n > 0 &&
               memcmp(buf, mg, n < 4 ? n : 4) != 0) {
      // a prefix that already mismatches the magic is definitive
      return Py_BuildValue("iy#n", 1, (const char*)buf, (Py_ssize_t)n, (Py_ssize_t)(n - base));
    }
    // ---- wait + read (GIL released around the syscalls)
    int64_t remaining = deadline - mono_ms();
    if (remaining <= 0)
      return Py_BuildValue("iy#n", 2, (const char*)buf, (Py_ssize_t)n, (Py_ssize_t)(n - base));
    int pr = 0;
    ssize_t r = -2;  // -2 = recv not attempted
    int err = 0;
    Py_BEGIN_ALLOW_THREADS
    struct pollfd pfd;
    pfd.fd = fd;
    pfd.events = POLLIN;
    pfd.revents = 0;
    fc_sys_poll.fetch_add(1, std::memory_order_relaxed);
    pr = poll(&pfd, 1, int(remaining > 0x7FFFFFFF ? 0x7FFFFFFF : remaining));
    if (pr > 0) {
      fc_sys_recv.fetch_add(1, std::memory_order_relaxed);
      r = recv(fd, buf + n, cap - n, 0);
      if (r < 0) err = errno;
    } else if (pr < 0) {
      err = errno;
    }
    Py_END_ALLOW_THREADS
    if (pr == 0)
      return Py_BuildValue("iy#n", 2, (const char*)buf, (Py_ssize_t)n, (Py_ssize_t)(n - base));
    if (pr < 0) {
      if (err == EINTR) continue;
      return Py_BuildValue("isy#n", 3, strerror(err), (const char*)buf,
                           (Py_ssize_t)n, (Py_ssize_t)(n - base));
    }
    if (r == 0)
      return Py_BuildValue("isy#n", 3, "connection closed by peer",
                           (const char*)buf, (Py_ssize_t)n,
                           (Py_ssize_t)(n - base));
    if (r < 0) {
      if (err == EINTR || err == EAGAIN || err == EWOULDBLOCK) continue;
      return Py_BuildValue("isy#n", 3, strerror(err), (const char*)buf,
                           (Py_ssize_t)n, (Py_ssize_t)(n - base));
    }
    n += size_t(r);
    if (n == cap)  // no complete fast frame fits: classic path judges
      return Py_BuildValue("iy#n", 1, (const char*)buf, (Py_ssize_t)n, (Py_ssize_t)(n - base));
  }
}

// -------------------------------------------------------- serve_drain --
// The server's native per-event loop: ONE call reads the readable fd
// and echo-serves the front run of eligible frames — recv, frame cut,
// meta walk, dispatch match and response build never cross the
// interpreter (serve_scan already did everything after the portal; this
// removes the recv -> IOBuf -> view -> pop round trip in front of it).
// The caller still sends the returned response bytes through the
// socket's write path, keeping MPSC write arbitration intact.
//
// serve_drain(fd, magic, service, method, max_body)
//   -> (0, out_bytes, n_served, leftover, nread)  served n frames;
//          leftover = unconsumed tail for the classic path (b"" clean)
//   -> (1, leftover, nread)   nothing served (not eligible / partial /
//          spurious event with no data)
//   -> (2, errmsg, raw, nread)  EOF or socket error observed; raw =
//          every byte read this pass (classic path re-judges, then the next
//          classic drain re-observes the EOF/error state)
PyObject* fc_serve_drain(PyObject*, PyObject* args) {
  int fd;
  Py_buffer magic, svc, mth;
  Py_ssize_t max_body = 32768;
  if (!PyArg_ParseTuple(args, "iy*y*y*|n", &fd, &magic, &svc, &mth,
                        &max_body))
    return nullptr;
  if (magic.len != 4) {
    PyBuffer_Release(&magic); PyBuffer_Release(&svc); PyBuffer_Release(&mth);
    PyErr_SetString(PyExc_ValueError, "magic must be 4 bytes");
    return nullptr;
  }
  size_t cap_want = 262144;
  if (size_t(12 + max_body) + 4096 > cap_want)
    cap_want = size_t(12 + max_body) + 4096;
  unsigned char* buf = tl_reserve(tl_serve, cap_want);
  if (buf == nullptr) {
    PyBuffer_Release(&magic); PyBuffer_Release(&svc); PyBuffer_Release(&mth);
    return PyErr_NoMemory();
  }
  size_t cap = tl_serve.cap;
  size_t n = 0;
  bool eof = false;
  int err = 0;
  Py_BEGIN_ALLOW_THREADS
  for (;;) {
    fc_sys_recv.fetch_add(1, std::memory_order_relaxed);
    ssize_t r = recv(fd, buf + n, cap - n, 0);
    if (r < 0) {
      if (errno == EINTR) continue;
      if (errno != EAGAIN && errno != EWOULDBLOCK) err = errno;
      break;
    }
    if (r == 0) {
      eof = true;
      break;
    }
    n += size_t(r);
    if (n == cap) break;          // full batch: serve it, event re-fires
    if (size_t(r) < 65536) break; // short read: kernel (almost) drained
  }
  Py_END_ALLOW_THREADS
  PyObject* result = nullptr;
  if (eof || err) {
    result = Py_BuildValue("isy#n", 2, eof ? "peer closed" : strerror(err),
                           (const char*)buf, (Py_ssize_t)n, (Py_ssize_t)n);
  } else if (n == 0) {
    result = Py_BuildValue("iy#n", 1, "", (Py_ssize_t)0, (Py_ssize_t)0);
  } else {
    // scan + serve the front run (shared serve_core two-pass)
    Py_ssize_t off = 0, n_served = 0;
    PyObject* out = serve_core(buf, Py_ssize_t(n), magic.buf, svc, mth,
                               max_body, &off, &n_served);
    if (out != nullptr) {
      if (n_served == 0) {
        Py_DECREF(out);   // empty: nothing was eligible
        result = Py_BuildValue("iy#n", 1, (const char*)buf, (Py_ssize_t)n,
                               (Py_ssize_t)n);
      } else {
        result = Py_BuildValue("iNny#n", 0, out, n_served,
                               (const char*)(buf + off),
                               (Py_ssize_t)(Py_ssize_t(n) - off),
                               (Py_ssize_t)n);
      }
    }
  }
  PyBuffer_Release(&magic); PyBuffer_Release(&svc); PyBuffer_Release(&mth);
  return result;
}

// --------------------------------------------------------------- Pool --
struct PoolObject {
  PyObject_HEAD
  bt_respool* pool;
};

PyObject* pool_new(PyTypeObject* type, PyObject* args, PyObject*) {
  unsigned long long cap = 1 << 16;
  if (!PyArg_ParseTuple(args, "|K", &cap)) return nullptr;
  PoolObject* self = reinterpret_cast<PoolObject*>(type->tp_alloc(type, 0));
  if (self == nullptr) return nullptr;
  self->pool = bt_respool_create(cap);
  return reinterpret_cast<PyObject*>(self);
}

void pool_dealloc(PyObject* o) {
  PoolObject* self = reinterpret_cast<PoolObject*>(o);
  // pools are process-lifetime singletons; any objects still live at
  // interpreter teardown keep their reference (freed with the heap)
  bt_respool_destroy(self->pool);
  Py_TYPE(o)->tp_free(o);
}

PyObject* pool_insert(PyObject* o, PyObject* obj) {
  PoolObject* self = reinterpret_cast<PoolObject*>(o);
  uint64_t id = bt_respool_acquire(
      self->pool, reinterpret_cast<uint64_t>(obj));
  if (id == 0) {
    PyErr_SetString(PyExc_RuntimeError, "fastcore Pool exhausted");
    return nullptr;
  }
  Py_INCREF(obj);  // the pool holds one reference until take/remove
  return PyLong_FromUnsignedLongLong(id);
}

PyObject* pool_address(PyObject* o, PyObject* arg) {
  PoolObject* self = reinterpret_cast<PoolObject*>(o);
  uint64_t id = PyLong_AsUnsignedLongLong(arg);
  if (id == static_cast<uint64_t>(-1) && PyErr_Occurred()) return nullptr;
  uint64_t v;
  if (!bt_respool_get(self->pool, id, &v)) Py_RETURN_NONE;
  PyObject* obj = reinterpret_cast<PyObject*>(v);
  return Py_NewRef(obj);
}

PyObject* pool_remove(PyObject* o, PyObject* arg) {
  PoolObject* self = reinterpret_cast<PoolObject*>(o);
  uint64_t id = PyLong_AsUnsignedLongLong(arg);
  if (id == static_cast<uint64_t>(-1) && PyErr_Occurred()) return nullptr;
  // GIL makes get+release atomic w.r.t. other Python threads
  uint64_t v;
  if (!bt_respool_get(self->pool, id, &v)) Py_RETURN_NONE;
  if (!bt_respool_release(self->pool, id)) Py_RETURN_NONE;
  // transfer the pool's reference to the caller
  return reinterpret_cast<PyObject*>(v);
}

Py_ssize_t pool_len(PyObject* o) {
  PoolObject* self = reinterpret_cast<PoolObject*>(o);
  return static_cast<Py_ssize_t>(bt_respool_live(self->pool));
}

PyMethodDef pool_methods[] = {
    {"insert", pool_insert, METH_O,
     "insert(obj) -> versioned id (never 0)"},
    {"address", pool_address, METH_O,
     "address(id) -> obj | None (stale id)"},
    {"remove", pool_remove, METH_O,
     "remove(id) -> obj | None; invalidates the id"},
    {nullptr, nullptr, 0, nullptr},
};

PySequenceMethods pool_as_sequence = {
    pool_len,  // sq_length
};

PyTypeObject PoolType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "_brpc_fastcore.Pool",          // tp_name
    sizeof(PoolObject),             // tp_basicsize
};

// --------------------------------------------------------------- Mpsc --
struct MpscObject {
  PyObject_HEAD
  bt_mpsc* q;
};

PyObject* mpsc_new(PyTypeObject* type, PyObject*, PyObject*) {
  MpscObject* self = reinterpret_cast<MpscObject*>(type->tp_alloc(type, 0));
  if (self == nullptr) return nullptr;
  self->q = bt_mpsc_create();
  return reinterpret_cast<PyObject*>(self);
}

void mpsc_dealloc(PyObject* o) {
  MpscObject* self = reinterpret_cast<MpscObject*>(o);
  // drain leftover references before destroying the nodes
  uint64_t v;
  while (bt_mpsc_drain_w(self->q, &v, 1) == 1)
    Py_DECREF(reinterpret_cast<PyObject*>(v));
  bt_mpsc_destroy(self->q);
  Py_TYPE(o)->tp_free(o);
}

PyObject* mpsc_push(PyObject* o, PyObject* obj) {
  MpscObject* self = reinterpret_cast<MpscObject*>(o);
  Py_INCREF(obj);  // queue holds one reference until drained
  if (bt_mpsc_push(self->q, reinterpret_cast<uint64_t>(obj)))
    Py_RETURN_TRUE;   // caller became the writer
  Py_RETURN_FALSE;
}

PyObject* mpsc_drain_one(PyObject* o, PyObject*) {
  MpscObject* self = reinterpret_cast<MpscObject*>(o);
  uint64_t v;
  if (bt_mpsc_drain_w(self->q, &v, 1) == 0) Py_RETURN_NONE;
  return reinterpret_cast<PyObject*>(v);  // transfer queue's reference
}

PyObject* mpsc_try_retire(PyObject* o, PyObject*) {
  MpscObject* self = reinterpret_cast<MpscObject*>(o);
  if (bt_mpsc_try_retire(self->q)) Py_RETURN_TRUE;
  Py_RETURN_FALSE;
}

PyObject* mpsc_depth(PyObject* o, PyObject*) {
  MpscObject* self = reinterpret_cast<MpscObject*>(o);
  uint64_t p = bt_mpsc_pushed(self->q), d = bt_mpsc_drained(self->q);
  return PyLong_FromUnsignedLongLong(p > d ? p - d : 0);
}

PyMethodDef mpsc_methods[] = {
    {"push", mpsc_push, METH_O,
     "push(obj) -> bool: True when the caller became the writer"},
    {"drain_one", mpsc_drain_one, METH_NOARGS,
     "drain_one() -> obj | None (writer only; keeps writership)"},
    {"try_retire", mpsc_try_retire, METH_NOARGS,
     "try_retire() -> bool: True = writership released (queue empty)"},
    {"depth", mpsc_depth, METH_NOARGS,
     "depth() -> approximate queued item count (pushed - drained)"},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject MpscType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "_brpc_fastcore.Mpsc",          // tp_name
    sizeof(MpscObject),             // tp_basicsize
};

// ------------------------------------------------------------- module --
PyMethodDef module_methods[] = {
    {"pack_frame", fc_pack_frame, METH_VARARGS,
     "pack_frame(magic, meta_prefix, cid, payload, attachment) -> bytes"},
    {"parse_head", fc_parse_head, METH_VARARGS,
     "parse_head(view, magic) -> None | -1 | (body, meta_size, meta|None)"},
    {"pack_frame_head", fc_pack_frame_head, METH_VARARGS,
     "pack_frame_head(magic, meta_prefix, cid, att_size, tail_len) -> "
     "bytes: header + meta for a frame whose payload/attachment ride "
     "as zero-copy refs behind it (big-frame twin of pack_frame)"},
    {"scan_frames", fc_scan_frames, METH_VARARGS,
     "scan_frames(view, magic, max_body=32768, max_frames=128, "
     "max_stream_body=0, materialize=0) -> (consumed, frames): cut + "
     "meta-decode every complete small fast frame in one native pass; "
     "max_stream_body>0 additionally admits complete LIVE STREAM data "
     "frames up to that size; materialize=1 returns payload/attachment "
     "bytes in place of the (offset, length) pairs"},
    {"serve_scan", fc_serve_scan, METH_VARARGS,
     "serve_scan(view, magic, service, method, max_body=32768) -> "
     "(consumed, out_bytes, n): echo-serve matching request frames "
     "entirely in C (responses prebuilt into out_bytes)"},
    {"pluck_scan", fc_pluck_scan, METH_VARARGS,
     "pluck_scan(fd, magic, cid, slice_ms, max_body, carry) -> "
     "(0, ec, et, payload, attach, leftover, nread) | (1, buffered, "
     "nread) | (2, buffered, nread) | (3, errmsg, buffered, nread): "
     "the sync-pluck receive loop (poll+recv+frame scan) in one "
     "native call"},
    {"serve_drain", fc_serve_drain, METH_VARARGS,
     "serve_drain(fd, magic, service, method, max_body=32768) -> "
     "(0, out, n, leftover, nread) | (1, leftover, nread) | "
     "(2, errmsg, raw, nread): recv + echo-serve the readable fd's "
     "front run in one native call"},
    {"http_parse_request", fc_http_parse_request, METH_VARARGS,
     "http_parse_request(view, max_header, max_body) -> None | -1 | -2 "
     "| (header_len, method, target, content_length, keep_alive, "
     "headers): native HTTP/1.x request head parse (httpparse.cc)"},
    {"http_parse_resp_head", fc_http_parse_resp_head, METH_VARARGS,
     "http_parse_resp_head(view, max_header) -> None | -1 | -2 | "
     "(header_len, status, headers): native HTTP/1.x response head "
     "parse (httpparse.cc)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef fastcore_module = {
    PyModuleDef_HEAD_INIT,
    "_brpc_fastcore",
    "CPython bindings over the brpc_tpu native cores",
    -1,
    module_methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__brpc_fastcore() {
  PoolType.tp_flags = Py_TPFLAGS_DEFAULT;
  PoolType.tp_doc = "respool.cc versioned-id pool holding Python objects";
  PoolType.tp_new = pool_new;
  PoolType.tp_dealloc = pool_dealloc;
  PoolType.tp_methods = pool_methods;
  PoolType.tp_as_sequence = &pool_as_sequence;
  MpscType.tp_flags = Py_TPFLAGS_DEFAULT;
  MpscType.tp_doc =
      "queues.cc wait-free MPSC with the writer-retire protocol";
  MpscType.tp_new = mpsc_new;
  MpscType.tp_dealloc = mpsc_dealloc;
  MpscType.tp_methods = mpsc_methods;
  if (PyType_Ready(&PoolType) < 0 || PyType_Ready(&MpscType) < 0)
    return nullptr;
  PyObject* m = PyModule_Create(&fastcore_module);
  if (m == nullptr) return nullptr;
  if (PyModule_AddObjectRef(m, "Pool",
                            reinterpret_cast<PyObject*>(&PoolType)) < 0 ||
      PyModule_AddObjectRef(m, "Mpsc",
                            reinterpret_cast<PyObject*>(&MpscType)) < 0 ||
      fc_ring_add_to_module(m) < 0) {
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
