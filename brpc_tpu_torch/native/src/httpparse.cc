// Native HTTP/1.x head parsing for the fastcore extension.
//
// The reference carries a vendored C parser on its HTTP hot path
// (src/brpc/details/http_parser.cpp, joyent/nginx lineage) — the head
// parse (start line + header block) is the per-message cost. This is
// the tpu-native equivalent: one C pass over the drained bytes finds
// the header terminator, splits the start line, and builds the
// lowercased header dict that protocol/http.py (requests) and
// protocol/http_client.py (responses) consume.
//
// Parity contract (tested differentially against the Python lanes in
// tests/test_torch_native.py): for every input, the native lane returns
// either EXACTLY what the Python parser would, or DEFER — "this needs
// CPython semantics" (non-ASCII header keys whose str.lower() is not
// the ASCII map, content-length values that only int() can judge,
// status codes with signs/underscores). The callers fall back to the
// classic path on DEFER, so behavior never diverges; the fuzzers
// drive both lanes and compare end results.
//
// Return protocol (ints chosen to be cheap to branch on in Python):
//   None  -> not enough data yet
//   -1    -> definitely not ours / malformed (PARSE_TRY_OTHERS)
//   -2    -> DEFER: run the classic Python parser on the same bytes
//   tuple -> parsed head (shape differs per entry point, see below)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

namespace {

// str.strip() whitespace for chars < 256 (Py_UNICODE_ISSPACE):
// 0x09-0x0D, 0x1C-0x1F, 0x20, 0x85 (NEL), 0xA0 (NBSP)
inline bool py_isspace(unsigned char c) {
  return (c >= 0x09 && c <= 0x0D) || (c >= 0x1C && c <= 0x1F) ||
         c == 0x20 || c == 0x85 || c == 0xA0;
}

inline void strip_span(const char*& s, const char*& e) {
  while (s < e && py_isspace(static_cast<unsigned char>(*s))) ++s;
  while (e > s && py_isspace(static_cast<unsigned char>(e[-1]))) --e;
}

// find "\r\n\r\n" in [p, p+n)
inline Py_ssize_t find_sep(const char* p, Py_ssize_t n) {
  if (n < 4) return -1;
  const char* cur = p;
  const char* end = p + n;
  while ((cur = static_cast<const char*>(
              memchr(cur, '\r', end - cur - 3))) != nullptr) {
    if (cur[1] == '\n' && cur[2] == '\r' && cur[3] == '\n')
      return cur - p;
    ++cur;
    if (end - cur < 4) break;
  }
  return -1;
}

enum ScanStatus { SCAN_OK = 0, SCAN_DEFER = 1, SCAN_ERR = 2 };

// Parse the header lines in [p+first_line_len, p+sep) into a dict with
// stripped lowercased keys and stripped values (latin1), last
// occurrence winning — the Python loop's exact dict semantics
// (protocol/http.py parse / http_client.py head phase). Non-ASCII
// bytes in a KEY defer (str.lower() beyond ASCII is CPython's job);
// values may hold any byte (latin1 decode never fails).
ScanStatus build_headers(const char* p, Py_ssize_t line_start,
                         Py_ssize_t sep, PyObject** out) {
  PyObject* dict = PyDict_New();
  if (dict == nullptr) return SCAN_ERR;
  Py_ssize_t ls = line_start;
  char keybuf[256];
  while (ls < sep) {
    const char* l = p + ls;
    Py_ssize_t remain = sep - ls;
    const char* nl = static_cast<const char*>(memchr(l, '\r', remain));
    Py_ssize_t le = remain;           // line length
    // header block came from split(b"\r\n"): a lone '\r' not followed
    // by '\n' stays inside the line
    while (nl != nullptr) {
      if (nl + 1 < l + remain && nl[1] == '\n') { le = nl - l; break; }
      Py_ssize_t off = nl - l + 1;
      nl = static_cast<const char*>(memchr(l + off, '\r', remain - off));
      if (nl == nullptr) le = remain;
    }
    const char* colon = static_cast<const char*>(memchr(l, ':', le));
    const char* ks = l;
    const char* ke = (colon != nullptr) ? colon : l + le;
    const char* vs = (colon != nullptr) ? colon + 1 : l + le;
    const char* ve = l + le;
    strip_span(ks, ke);
    strip_span(vs, ve);
    Py_ssize_t klen = ke - ks;
    if (klen > static_cast<Py_ssize_t>(sizeof(keybuf))) {
      Py_DECREF(dict);
      return SCAN_DEFER;              // absurd key: let CPython decide
    }
    for (Py_ssize_t i = 0; i < klen; ++i) {
      unsigned char c = static_cast<unsigned char>(ks[i]);
      if (c >= 0x80) { Py_DECREF(dict); return SCAN_DEFER; }
      keybuf[i] = (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32)
                                         : static_cast<char>(c);
    }
    PyObject* key = PyUnicode_DecodeLatin1(keybuf, klen, nullptr);
    PyObject* val = PyUnicode_DecodeLatin1(vs, ve - vs, nullptr);
    if (key == nullptr || val == nullptr ||
        PyDict_SetItem(dict, key, val) < 0) {
      Py_XDECREF(key);
      Py_XDECREF(val);
      Py_DECREF(dict);
      return SCAN_ERR;
    }
    Py_DECREF(key);
    Py_DECREF(val);
    ls += le + 2;                     // skip the "\r\n"
  }
  *out = dict;
  return SCAN_OK;
}

// ASCII-digit span -> value; returns false unless [s, e) is 1..18 pure
// ASCII digits (anything else is int()'s business -> caller defers)
inline bool parse_digits(const char* s, const char* e, int64_t* out) {
  if (s >= e || e - s > 18) return false;
  int64_t v = 0;
  for (const char* c = s; c < e; ++c) {
    if (*c < '0' || *c > '9') return false;
    v = v * 10 + (*c - '0');
  }
  *out = v;
  return true;
}

inline PyObject* small_int(long v) { return PyLong_FromLong(v); }

const char* const kMethods[] = {"GET ",  "POST ",    "PUT ",  "DELETE ",
                                "HEAD ", "OPTIONS ", "PATCH "};

// case-insensitive ASCII equality with a lowercase literal; any
// non-ASCII byte can never compare equal to an ASCII literal under
// str.lower(), so ASCII folding is exact here
inline bool ascii_iequal(const char* s, Py_ssize_t n, const char* lit) {
  for (Py_ssize_t i = 0; i < n; ++i, ++lit) {
    unsigned char c = static_cast<unsigned char>(s[i]);
    if (c >= 'A' && c <= 'Z') c += 32;
    if (*lit == '\0' || c != static_cast<unsigned char>(*lit)) return false;
  }
  return *lit == '\0';
}

}  // namespace

// http_parse_request(view, max_header, max_body)
//   -> None | -1 | -2 |
//      (header_len, method, target, content_length, keep_alive, headers)
// Mirrors protocol/http.py HttpProtocol.parse up to (but not
// including) the portal cut: header_len = sep + 4; the caller checks
// portal.size >= header_len + content_length and does the cut +
// urlsplit itself.
PyObject* fc_http_parse_request(PyObject*, PyObject* args) {
  Py_buffer view;
  Py_ssize_t max_header, max_body;
  if (!PyArg_ParseTuple(args, "y*nn", &view, &max_header, &max_body))
    return nullptr;
  const char* p = static_cast<const char*>(view.buf);
  Py_ssize_t n = view.len;

  // method probe over the first min(8, n) bytes (prefix-compatible
  // shorter heads fall through to the not-enough-data path)
  Py_ssize_t probe = n < 8 ? n : 8;
  bool maybe = false;
  for (const char* m : kMethods) {
    Py_ssize_t ml = static_cast<Py_ssize_t>(strlen(m));
    Py_ssize_t cmp = probe < ml ? probe : ml;
    if (memcmp(p, m, cmp) == 0) { maybe = true; break; }
  }
  if (!maybe) {
    PyBuffer_Release(&view);
    return small_int(-1);
  }
  Py_ssize_t window = n < max_header ? n : max_header;
  Py_ssize_t sep = find_sep(p, window);
  if (sep < 0) {
    PyBuffer_Release(&view);
    if (n >= max_header) return small_int(-1);   // header flood
    Py_RETURN_NONE;
  }

  // start line: need two single-space splits (split(" ", 2) must yield
  // exactly 3 parts for the Python unpack); target may be empty
  const char* line = p;
  const char* line_end = p + sep;
  const char* nl = static_cast<const char*>(memchr(line, '\r', sep));
  while (nl != nullptr && !(nl + 1 < line_end && nl[1] == '\n')) {
    // lone '\r' (incl. one as the last header-block byte): stays in
    // the line, exactly like split(b"\r\n")
    Py_ssize_t off = nl - line + 1;
    nl = static_cast<const char*>(memchr(line + off, '\r', sep - off));
  }
  Py_ssize_t fll = (nl != nullptr) ? nl - line : sep;  // first line len
  const char* sp1 =
      static_cast<const char*>(memchr(line, ' ', fll));
  if (sp1 == nullptr) {
    PyBuffer_Release(&view);
    return small_int(-1);
  }
  const char* sp2 = static_cast<const char*>(
      memchr(sp1 + 1, ' ', line + fll - sp1 - 1));
  if (sp2 == nullptr) {
    PyBuffer_Release(&view);
    return small_int(-1);             // ValueError in the Python unpack
  }
  // the probe guaranteed "<METHOD> " so [line, sp1) is the known token
  PyObject* method = PyUnicode_DecodeLatin1(line, sp1 - line, nullptr);
  PyObject* target = PyUnicode_DecodeLatin1(sp1 + 1, sp2 - sp1 - 1, nullptr);
  if (method == nullptr || target == nullptr) {
    Py_XDECREF(method);
    Py_XDECREF(target);
    PyBuffer_Release(&view);
    return nullptr;
  }

  Py_ssize_t line_start = fll + 2;
  if (line_start > sep) line_start = sep;        // startline IS the block
  PyObject* headers = nullptr;
  ScanStatus st = build_headers(p, line_start, sep, &headers);
  if (st != SCAN_OK) {
    Py_DECREF(method);
    Py_DECREF(target);
    PyBuffer_Release(&view);
    if (st == SCAN_DEFER) return small_int(-2);
    return nullptr;
  }

  // content-length: absent/empty -> 0; pure digits -> value; anything
  // else only int() can judge -> DEFER
  int64_t body_len = 0;
  PyObject* cl = PyDict_GetItemString(headers, "content-length");
  if (cl != nullptr) {
    Py_ssize_t cln;
    const char* cls = PyUnicode_AsUTF8AndSize(cl, &cln);
    if (cls == nullptr) {
      PyErr_Clear();
      cln = -1;
    }
    if (cln > 0) {
      if (!parse_digits(cls, cls + cln, &body_len)) {
        Py_DECREF(method);
        Py_DECREF(target);
        Py_DECREF(headers);
        PyBuffer_Release(&view);
        return small_int(-2);
      }
    } else if (cln < 0) {             // non-UTF8-representable value
      Py_DECREF(method);
      Py_DECREF(target);
      Py_DECREF(headers);
      PyBuffer_Release(&view);
      return small_int(-2);
    }
  }
  if (body_len > max_body) {
    Py_DECREF(method);
    Py_DECREF(target);
    Py_DECREF(headers);
    PyBuffer_Release(&view);
    return small_int(-1);
  }

  // keep_alive: headers.get("connection", "keep-alive").lower() != "close"
  int keep_alive = 1;
  PyObject* conn = PyDict_GetItemString(headers, "connection");
  if (conn != nullptr) {
    Py_ssize_t cn;
    const char* cs = PyUnicode_AsUTF8AndSize(conn, &cn);
    if (cs == nullptr) {
      PyErr_Clear();                  // lone surrogates impossible
    } else if (ascii_iequal(cs, cn, "close")) {
      keep_alive = 0;
    }
  }

  PyObject* result =
      Py_BuildValue("(nNNLiN)", sep + 4, method, target,
                    static_cast<long long>(body_len), keep_alive, headers);
  PyBuffer_Release(&view);
  return result;
}

// http_parse_resp_head(view, max_header)
//   -> None | -1 | -2 | (header_len, status, headers)
// Mirrors http_client.py's head phase up to the pop_front: start-line
// probe ("HTTP/1." prefix rule), status int, lowercased header dict.
// Body-mode selection (chunked / length / close / bodiless) stays in
// Python — it is connection-state logic, not byte parsing.
PyObject* fc_http_parse_resp_head(PyObject*, PyObject* args) {
  Py_buffer view;
  Py_ssize_t max_header;
  if (!PyArg_ParseTuple(args, "y*n", &view, &max_header))
    return nullptr;
  const char* p = static_cast<const char*>(view.buf);
  Py_ssize_t n = view.len;

  static const char kProbe[] = "HTTP/1.";
  Py_ssize_t probe = n < 7 ? n : 7;
  if (memcmp(p, kProbe, probe) != 0) {
    PyBuffer_Release(&view);
    return small_int(-1);
  }
  Py_ssize_t window = n < max_header ? n : max_header;
  Py_ssize_t sep = find_sep(p, window);
  if (sep < 0) {
    PyBuffer_Release(&view);
    if (n >= max_header) return small_int(-1);
    Py_RETURN_NONE;
  }

  const char* line = p;
  const char* line_end = p + sep;
  const char* nl = static_cast<const char*>(memchr(line, '\r', sep));
  while (nl != nullptr && !(nl + 1 < line_end && nl[1] == '\n')) {
    Py_ssize_t off = nl - line + 1;
    nl = static_cast<const char*>(memchr(line + off, '\r', sep - off));
  }
  Py_ssize_t fll = (nl != nullptr) ? nl - line : sep;
  // split(" ", 2) then `_version, code, *_ = parts`: needs >= 1 space;
  // code is the second token (to the next space or end of line)
  const char* sp1 = static_cast<const char*>(memchr(line, ' ', fll));
  if (sp1 == nullptr) {
    PyBuffer_Release(&view);
    return small_int(-1);
  }
  const char* code_s = sp1 + 1;
  const char* sp2 = static_cast<const char*>(
      memchr(code_s, ' ', line + fll - code_s));
  const char* code_e = (sp2 != nullptr) ? sp2 : line + fll;
  int64_t status;
  if (code_s == code_e) {             // int("") -> ValueError
    PyBuffer_Release(&view);
    return small_int(-1);
  }
  if (!parse_digits(code_s, code_e, &status)) {
    PyBuffer_Release(&view);
    return small_int(-2);             // signs/underscores: int()'s call
  }

  Py_ssize_t line_start = fll + 2;
  if (line_start > sep) line_start = sep;
  PyObject* headers = nullptr;
  ScanStatus st = build_headers(p, line_start, sep, &headers);
  if (st != SCAN_OK) {
    PyBuffer_Release(&view);
    if (st == SCAN_DEFER) return small_int(-2);
    return nullptr;
  }
  PyObject* result = Py_BuildValue("(nLN)", sep + 4,
                                   static_cast<long long>(status), headers);
  PyBuffer_Release(&view);
  return result;
}
