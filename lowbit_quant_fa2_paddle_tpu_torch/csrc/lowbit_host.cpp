// Native host-side runtime of the PyTorch/CUDA port: its serving engine's
// control plane (lowbit_quant_fa2_paddle_tpu_torch/serving.py).
//
// The port's own copy of the JAX package's csrc/lowbit_host.cpp (the port
// imports nothing of that package): the same scheduler, allocator and bit
// packing, so that both engines make the same admission and paging
// decisions.
//
//   * bit pack/unpack + per-token int8 quantization over numpy buffers;
//   * a paged-KV page allocator (free-list block manager);
//   * the continuous-batching request scheduler: FIFO admission over decode
//     slots and the page pool, with worst-case reservation accounting
//     ("reserve") or lazy admission with preemption, refcounted shared
//     prefix pages, rollback (speculative rejection) and trim (rolling
//     window reclamation).
//
// Exposed through the raw CPython C API. lowbit_quant_fa2_paddle_tpu_torch/
// host/__init__.py builds it with the host C++ compiler at first use (into
// csrc/build/host/, keyed by this file's hash) and keeps the pure-Python
// versions as the plain ones the tests hold it against.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Buffer helpers
// ---------------------------------------------------------------------------

struct BufView {
  Py_buffer view;
  bool ok = false;
  ~BufView() {
    if (ok) PyBuffer_Release(&view);
  }
};

static bool get_contig(PyObject* obj, BufView* b, const char* fmt_expect,
                       int flags = PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) {
  if (PyObject_GetBuffer(obj, &b->view, flags) != 0) return false;
  b->ok = true;
  if (fmt_expect && b->view.format && strcmp(b->view.format, fmt_expect) != 0) {
    PyErr_Format(PyExc_TypeError, "expected buffer of format '%s', got '%s'",
                 fmt_expect, b->view.format);
    return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// Packing: halves-of-D int4 / quarters-of-D int2 (matches ops/quant.py)
// ---------------------------------------------------------------------------

// codes int8 [rows, d] -> packed int8 [rows, d/2]
static PyObject* pack_int4(PyObject*, PyObject* args) {
  PyObject* src;
  if (!PyArg_ParseTuple(args, "O", &src)) return nullptr;
  BufView b;
  if (!get_contig(src, &b, "b")) return nullptr;
  if (b.view.ndim != 2) {
    PyErr_SetString(PyExc_ValueError, "expected 2-D codes");
    return nullptr;
  }
  Py_ssize_t rows = b.view.shape[0], d = b.view.shape[1];
  if (d % 2) {
    PyErr_SetString(PyExc_ValueError, "d must be even");
    return nullptr;
  }
  Py_ssize_t dp = d / 2;
  PyObject* out = PyBytes_FromStringAndSize(nullptr, rows * dp);
  if (!out) return nullptr;
  auto* dst = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(out));
  auto* s = reinterpret_cast<const int8_t*>(b.view.buf);
  for (Py_ssize_t r = 0; r < rows; ++r) {
    const int8_t* row = s + r * d;
    uint8_t* orow = dst + r * dp;
    for (Py_ssize_t i = 0; i < dp; ++i) {
      orow[i] = static_cast<uint8_t>((row[i] & 0xF) | ((row[i + dp] & 0xF) << 4));
    }
  }
  return out;
}

// packed int8 [rows, d/2] -> codes int8 [rows, d] (bytes)
static PyObject* unpack_int4(PyObject*, PyObject* args) {
  PyObject* src;
  if (!PyArg_ParseTuple(args, "O", &src)) return nullptr;
  BufView b;
  if (!get_contig(src, &b, nullptr)) return nullptr;
  if (b.view.ndim != 2) {
    PyErr_SetString(PyExc_ValueError, "expected 2-D packed");
    return nullptr;
  }
  Py_ssize_t rows = b.view.shape[0], dp = b.view.shape[1];
  Py_ssize_t d = dp * 2;
  PyObject* out = PyBytes_FromStringAndSize(nullptr, rows * d);
  if (!out) return nullptr;
  auto* dst = reinterpret_cast<int8_t*>(PyBytes_AS_STRING(out));
  auto* s = reinterpret_cast<const uint8_t*>(b.view.buf);
  for (Py_ssize_t r = 0; r < rows; ++r) {
    const uint8_t* row = s + r * dp;
    int8_t* orow = dst + r * d;
    for (Py_ssize_t i = 0; i < dp; ++i) {
      orow[i] = static_cast<int8_t>(static_cast<int8_t>(row[i] << 4) >> 4);
      orow[i + dp] = static_cast<int8_t>(row[i]) >> 4;
    }
  }
  return out;
}

// float32 [rows, d] -> (codes int8 bytes [rows, d], scales float32 bytes [rows])
static PyObject* quant_int8_per_token(PyObject*, PyObject* args) {
  PyObject* src;
  if (!PyArg_ParseTuple(args, "O", &src)) return nullptr;
  BufView b;
  if (!get_contig(src, &b, "f")) return nullptr;
  if (b.view.ndim != 2) {
    PyErr_SetString(PyExc_ValueError, "expected 2-D float32");
    return nullptr;
  }
  Py_ssize_t rows = b.view.shape[0], d = b.view.shape[1];
  PyObject* codes = PyBytes_FromStringAndSize(nullptr, rows * d);
  PyObject* scales = PyBytes_FromStringAndSize(nullptr, rows * sizeof(float));
  if (!codes || !scales) {
    Py_XDECREF(codes);
    Py_XDECREF(scales);
    return nullptr;
  }
  auto* c = reinterpret_cast<int8_t*>(PyBytes_AS_STRING(codes));
  auto* sc = reinterpret_cast<float*>(PyBytes_AS_STRING(scales));
  auto* x = reinterpret_cast<const float*>(b.view.buf);
  for (Py_ssize_t r = 0; r < rows; ++r) {
    const float* row = x + r * d;
    float amax = 0.f;
    for (Py_ssize_t i = 0; i < d; ++i) amax = std::max(amax, std::fabs(row[i]));
    float scale = amax / 127.0f + 1e-7f;
    sc[r] = scale;
    float inv = 1.0f / scale;
    int8_t* crow = c + r * d;
    for (Py_ssize_t i = 0; i < d; ++i) {
      float v = row[i] * inv;
      // round half away from zero, matching ops/reference.py round_away
      float rv = v >= 0.f ? std::floor(v + 0.5f) : std::ceil(v - 0.5f);
      rv = std::max(-127.f, std::min(127.f, rv));
      crow[i] = static_cast<int8_t>(rv);
    }
  }
  return Py_BuildValue("(NN)", codes, scales);
}

// ---------------------------------------------------------------------------
// Paged-KV page allocator (free-list block manager)
// ---------------------------------------------------------------------------

struct PageAllocator {
  int64_t num_pages;
  std::vector<int32_t> free_list;                 // stack of free page ids
  std::vector<std::vector<int32_t>> seq_pages;    // per-seq page lists
  std::vector<int32_t> free_seq_slots;
};

static void allocator_destroy(PyObject* capsule) {
  delete reinterpret_cast<PageAllocator*>(
      PyCapsule_GetPointer(capsule, "lowbit.PageAllocator"));
}

static PageAllocator* get_alloc(PyObject* capsule) {
  return reinterpret_cast<PageAllocator*>(
      PyCapsule_GetPointer(capsule, "lowbit.PageAllocator"));
}

static PyObject* allocator_new(PyObject*, PyObject* args) {
  long long num_pages;
  if (!PyArg_ParseTuple(args, "L", &num_pages)) return nullptr;
  auto* a = new PageAllocator();
  a->num_pages = num_pages;
  a->free_list.reserve(num_pages);
  for (int64_t i = num_pages - 1; i >= 0; --i)
    a->free_list.push_back(static_cast<int32_t>(i));
  return PyCapsule_New(a, "lowbit.PageAllocator", allocator_destroy);
}

static PyObject* allocator_new_seq(PyObject*, PyObject* args) {
  PyObject* cap;
  if (!PyArg_ParseTuple(args, "O", &cap)) return nullptr;
  auto* a = get_alloc(cap);
  if (!a) return nullptr;
  int32_t sid;
  if (!a->free_seq_slots.empty()) {
    sid = a->free_seq_slots.back();
    a->free_seq_slots.pop_back();
    a->seq_pages[sid].clear();
  } else {
    sid = static_cast<int32_t>(a->seq_pages.size());
    a->seq_pages.emplace_back();
  }
  return PyLong_FromLong(sid);
}

static PyObject* allocator_append_page(PyObject*, PyObject* args) {
  PyObject* cap;
  int sid;
  if (!PyArg_ParseTuple(args, "Oi", &cap, &sid)) return nullptr;
  auto* a = get_alloc(cap);
  if (!a) return nullptr;
  if (sid < 0 || static_cast<size_t>(sid) >= a->seq_pages.size()) {
    PyErr_SetString(PyExc_ValueError, "bad sequence id");
    return nullptr;
  }
  if (a->free_list.empty()) {
    PyErr_SetString(PyExc_MemoryError, "out of KV pages");
    return nullptr;
  }
  int32_t page = a->free_list.back();
  a->free_list.pop_back();
  a->seq_pages[sid].push_back(page);
  return PyLong_FromLong(page);
}

static PyObject* allocator_free_seq(PyObject*, PyObject* args) {
  PyObject* cap;
  int sid;
  if (!PyArg_ParseTuple(args, "Oi", &cap, &sid)) return nullptr;
  auto* a = get_alloc(cap);
  if (!a) return nullptr;
  if (sid < 0 || static_cast<size_t>(sid) >= a->seq_pages.size()) {
    PyErr_SetString(PyExc_ValueError, "bad sequence id");
    return nullptr;
  }
  for (int32_t p : a->seq_pages[sid]) a->free_list.push_back(p);
  a->seq_pages[sid].clear();
  a->free_seq_slots.push_back(sid);
  Py_RETURN_NONE;
}

static PyObject* allocator_seq_pages(PyObject*, PyObject* args) {
  PyObject* cap;
  int sid;
  if (!PyArg_ParseTuple(args, "Oi", &cap, &sid)) return nullptr;
  auto* a = get_alloc(cap);
  if (!a) return nullptr;
  if (sid < 0 || static_cast<size_t>(sid) >= a->seq_pages.size()) {
    PyErr_SetString(PyExc_ValueError, "bad sequence id");
    return nullptr;
  }
  const auto& pages = a->seq_pages[sid];
  PyObject* lst = PyList_New(pages.size());
  for (size_t i = 0; i < pages.size(); ++i)
    PyList_SET_ITEM(lst, i, PyLong_FromLong(pages[i]));
  return lst;
}

static PyObject* allocator_stats(PyObject*, PyObject* args) {
  PyObject* cap;
  if (!PyArg_ParseTuple(args, "O", &cap)) return nullptr;
  auto* a = get_alloc(cap);
  if (!a) return nullptr;
  return Py_BuildValue(
      "{s:L,s:n,s:n}", "num_pages", static_cast<long long>(a->num_pages),
      "free_pages", static_cast<Py_ssize_t>(a->free_list.size()),
      "num_seqs",
      static_cast<Py_ssize_t>(a->seq_pages.size() - a->free_seq_slots.size()));
}

// ---------------------------------------------------------------------------
// Continuous-batching scheduler (serving control plane)
// ---------------------------------------------------------------------------
//
// Admission, "reserve" policy (default): strict FIFO over a fixed set of
// decode slots. A request is admitted only when (a) a slot is free and (b)
// the page pool can cover its WORST-CASE page need (prompt + max_new - 1
// stored tokens) on top of every running request's outstanding
// (reserved-but-unallocated) pages. Pages are then allocated lazily as the
// sequence grows, so admission is the only point that can fail —
// decode-time growth never OOMs and no preemption machinery is needed.
//
// Admission, "lazy" policy: a request is admitted as soon as a slot is free
// and its CURRENT content (prompt pages, or stored length for a preempted
// request) fits the free pool — no worst-case reservation, so admitted
// concurrency is far higher on bursty mixed-length workloads. The price:
// append_token can hit an empty pool (returns -1 instead of raising) and
// the caller must preempt a running request (scheduler_preempt swaps it
// back to the FRONT of the waiting queue, keeping its stored length and its
// shared-prefix pins; the engine saves/restores the KV page payload
// bit-exactly, so outputs are invariant to preemption).

struct SchedRequest {
  int64_t prompt_len = 0;
  int64_t max_new = 0;
  int64_t length = 0;     // tokens whose KV is (being) stored
  int64_t reserved = 0;   // worst-case PRIVATE page need (excludes shared)
  int32_t slot = -1;      // -1 while waiting
  int32_t sid = -1;       // allocator sequence id
  bool preempted = false; // waiting again with length > 0 (KV swapped out)
  bool canceled = false;  // removed from the waiting queue before admission
  int64_t trimmed_priv = 0;  // private pages freed by scheduler_trim (holes)
  std::vector<int32_t> shared;  // prefix-cache pages (pinned by the caller)
};

struct Scheduler {
  int64_t page_size = 0;
  int32_t max_running = 0;
  bool lazy = false;              // admission policy (see above)
  PageAllocator alloc;
  std::vector<int32_t> ref;       // per-page refcount (0 == in free list)
  std::vector<int32_t> slots;     // slot -> rid (-1 free)
  std::vector<int32_t> waiting;   // FIFO (front = index 0)
  std::vector<SchedRequest> reqs; // rid-indexed (rids are never reused)
  int64_t outstanding = 0;        // sum over running of (reserved - allocated private)
};

static void scheduler_destroy(PyObject* capsule) {
  delete reinterpret_cast<Scheduler*>(
      PyCapsule_GetPointer(capsule, "lowbit.Scheduler"));
}

static Scheduler* get_sched(PyObject* capsule) {
  return reinterpret_cast<Scheduler*>(
      PyCapsule_GetPointer(capsule, "lowbit.Scheduler"));
}

static int64_t pages_for(const Scheduler* s, int64_t tokens) {
  return (tokens + s->page_size - 1) / s->page_size;
}

static PyObject* scheduler_new(PyObject*, PyObject* args) {
  long long num_pages, page_size;
  int max_running;
  int lazy = 0;
  if (!PyArg_ParseTuple(args, "LLi|p", &num_pages, &page_size, &max_running,
                        &lazy))
    return nullptr;
  if (page_size <= 0 || max_running <= 0 || num_pages <= 0) {
    PyErr_SetString(PyExc_ValueError, "num_pages/page_size/max_running must be > 0");
    return nullptr;
  }
  auto* s = new Scheduler();
  s->page_size = page_size;
  s->max_running = max_running;
  s->lazy = lazy != 0;
  s->alloc.num_pages = num_pages;
  s->alloc.free_list.reserve(num_pages);
  for (int64_t i = num_pages - 1; i >= 0; --i)
    s->alloc.free_list.push_back(static_cast<int32_t>(i));
  s->slots.assign(max_running, -1);
  s->ref.assign(num_pages, 0);
  return PyCapsule_New(s, "lowbit.Scheduler", scheduler_destroy);
}

// scheduler_add(h, prompt_len, max_new[, shared_pages]) — shared_pages is a
// sequence of prefix-cache page ids (each already pinned by the caller, i.e.
// ref > 0) covering whole leading prompt pages.
static PyObject* scheduler_add(PyObject*, PyObject* args) {
  PyObject* cap;
  long long prompt_len, max_new;
  PyObject* shared_obj = nullptr;
  if (!PyArg_ParseTuple(args, "OLL|O", &cap, &prompt_len, &max_new, &shared_obj))
    return nullptr;
  auto* s = get_sched(cap);
  if (!s) return nullptr;
  if (prompt_len <= 0 || max_new <= 0) {
    PyErr_SetString(PyExc_ValueError, "prompt_len and max_new must be > 0");
    return nullptr;
  }
  std::vector<int32_t> shared;
  if (shared_obj && shared_obj != Py_None) {
    PyObject* seq = PySequence_Fast(shared_obj, "shared_pages must be a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; ++i) {
      long pid = PyLong_AsLong(PySequence_Fast_GET_ITEM(seq, i));
      if (pid < 0 || pid >= s->alloc.num_pages || s->ref[pid] <= 0) {
        Py_DECREF(seq);
        PyErr_SetString(PyExc_ValueError,
                        "shared page id out of range or not pinned");
        return nullptr;
      }
      shared.push_back(static_cast<int32_t>(pid));
    }
    Py_DECREF(seq);
  }
  int64_t n_shared = static_cast<int64_t>(shared.size());
  if (n_shared * s->page_size >= prompt_len) {
    PyErr_SetString(PyExc_ValueError,
                    "shared pages must cover strictly less than the prompt");
    return nullptr;
  }
  int64_t need = pages_for(s, prompt_len + max_new - 1) - n_shared;
  if (need > s->alloc.num_pages) {
    PyErr_SetString(PyExc_MemoryError,
                    "request can never fit: worst-case pages exceed the pool");
    return nullptr;
  }
  int32_t rid = static_cast<int32_t>(s->reqs.size());
  // pin the shared pages for this request's lifetime (released once each by
  // scheduler_release), so cache eviction between add and admission is safe
  for (int32_t p : shared) s->ref[p] += 1;
  SchedRequest r;
  r.prompt_len = prompt_len;
  r.max_new = max_new;
  r.reserved = need;
  r.shared = std::move(shared);
  s->reqs.push_back(std::move(r));
  s->waiting.push_back(rid);
  return PyLong_FromLong(rid);
}

// Re-resolve a WAITING request's shared prefix pages (the engine calls this
// right before each admission pass, so requests queued behind the prompt
// that will seed the cache still share it).
static PyObject* scheduler_update_shared(PyObject*, PyObject* args) {
  PyObject* cap;
  int rid;
  PyObject* shared_obj;
  if (!PyArg_ParseTuple(args, "OiO", &cap, &rid, &shared_obj)) return nullptr;
  auto* s = get_sched(cap);
  if (!s) return nullptr;
  if (rid < 0 || static_cast<size_t>(rid) >= s->reqs.size() ||
      s->reqs[rid].slot >= 0 ||
      std::find(s->waiting.begin(), s->waiting.end(), rid) == s->waiting.end()) {
    PyErr_SetString(PyExc_ValueError, "rid is not waiting");
    return nullptr;
  }
  SchedRequest& r = s->reqs[rid];
  std::vector<int32_t> shared;
  if (shared_obj != Py_None) {
    PyObject* seq = PySequence_Fast(shared_obj, "shared_pages must be a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; ++i) {
      long pid = PyLong_AsLong(PySequence_Fast_GET_ITEM(seq, i));
      if (pid < 0 || pid >= s->alloc.num_pages || s->ref[pid] <= 0) {
        Py_DECREF(seq);
        PyErr_SetString(PyExc_ValueError,
                        "shared page id out of range or not pinned");
        return nullptr;
      }
      shared.push_back(static_cast<int32_t>(pid));
    }
    Py_DECREF(seq);
  }
  if (static_cast<int64_t>(shared.size()) * s->page_size >= r.prompt_len) {
    PyErr_SetString(PyExc_ValueError,
                    "shared pages must cover strictly less than the prompt");
    return nullptr;
  }
  for (int32_t p : shared) s->ref[p] += 1;  // pin new before unpinning old
  for (int32_t p : r.shared) {
    if (--s->ref[p] == 0) s->alloc.free_list.push_back(p);
  }
  r.shared = std::move(shared);
  r.reserved = pages_for(s, r.prompt_len + r.max_new - 1) -
               static_cast<int64_t>(r.shared.size());
  Py_RETURN_NONE;
}

// Generic page pin/unpin (the prefix cache's ownership handle). unref of a
// page whose count hits 0 returns it to the free list.
static PyObject* scheduler_ref_page(PyObject*, PyObject* args) {
  PyObject* cap;
  int pid;
  if (!PyArg_ParseTuple(args, "Oi", &cap, &pid)) return nullptr;
  auto* s = get_sched(cap);
  if (!s) return nullptr;
  if (pid < 0 || pid >= s->alloc.num_pages || s->ref[pid] <= 0) {
    PyErr_SetString(PyExc_ValueError, "page is not allocated");
    return nullptr;
  }
  s->ref[pid] += 1;
  return PyLong_FromLong(s->ref[pid]);
}

static PyObject* scheduler_unref_page(PyObject*, PyObject* args) {
  PyObject* cap;
  int pid;
  if (!PyArg_ParseTuple(args, "Oi", &cap, &pid)) return nullptr;
  auto* s = get_sched(cap);
  if (!s) return nullptr;
  if (pid < 0 || pid >= s->alloc.num_pages || s->ref[pid] <= 0) {
    PyErr_SetString(PyExc_ValueError, "page is not allocated");
    return nullptr;
  }
  if (--s->ref[pid] == 0) s->alloc.free_list.push_back(pid);
  return PyLong_FromLong(s->ref[pid]);
}

static PyObject* scheduler_step(PyObject*, PyObject* args) {
  PyObject* cap;
  if (!PyArg_ParseTuple(args, "O", &cap)) return nullptr;
  auto* s = get_sched(cap);
  if (!s) return nullptr;
  PyObject* admitted = PyList_New(0);
  // strict FIFO: stop at the first request that does not fit
  while (!s->waiting.empty()) {
    int32_t rid = s->waiting.front();
    SchedRequest& r = s->reqs[rid];
    int32_t slot = -1;
    for (int32_t i = 0; i < s->max_running; ++i)
      if (s->slots[i] < 0) { slot = i; break; }
    if (slot < 0) break;
    // content tokens already stored (preempted resume) or about to be
    // (fresh prompt) — their pages are allocated at admission
    int64_t content = r.preempted ? r.length : r.prompt_len;
    int64_t private_now =
        pages_for(s, content) - static_cast<int64_t>(r.shared.size());
    int64_t free_pages = static_cast<int64_t>(s->alloc.free_list.size());
    if (s->lazy ? (free_pages < private_now)
                : (free_pages - s->outstanding < r.reserved))
      break;
    // admit: take the slot, allocate the content's pages now
    s->waiting.erase(s->waiting.begin());
    r.slot = slot;
    s->slots[slot] = rid;
    if (!s->alloc.free_seq_slots.empty()) {
      r.sid = s->alloc.free_seq_slots.back();
      s->alloc.free_seq_slots.pop_back();
      s->alloc.seq_pages[r.sid].clear();
    } else {
      r.sid = static_cast<int32_t>(s->alloc.seq_pages.size());
      s->alloc.seq_pages.emplace_back();
    }
    // sequence = shared prefix pages (caller-pinned) + private pages
    for (int32_t p : r.shared) s->alloc.seq_pages[r.sid].push_back(p);
    for (int64_t i = 0; i < private_now; ++i) {
      int32_t p = s->alloc.free_list.back();
      s->alloc.free_list.pop_back();
      s->ref[p] = 1;
      s->alloc.seq_pages[r.sid].push_back(p);
    }
    r.length = content;
    r.preempted = false;
    s->outstanding += r.reserved - private_now;
    PyObject* o = PyLong_FromLong(rid);
    PyList_Append(admitted, o);
    Py_DECREF(o);
  }
  PyObject* running = PyList_New(0);
  for (int32_t i = 0; i < s->max_running; ++i) {
    if (s->slots[i] >= 0) {
      PyObject* o = PyLong_FromLong(s->slots[i]);
      PyList_Append(running, o);
      Py_DECREF(o);
    }
  }
  return Py_BuildValue("{s:N,s:N,s:n}", "admitted", admitted, "running",
                       running, "waiting",
                       static_cast<Py_ssize_t>(s->waiting.size()));
}

// Grow a running sequence by one stored token; allocates a page on boundary
// crossing (guaranteed to succeed by admission accounting). Returns the new
// stored length.
static PyObject* scheduler_append_token(PyObject*, PyObject* args) {
  PyObject* cap;
  int rid;
  if (!PyArg_ParseTuple(args, "Oi", &cap, &rid)) return nullptr;
  auto* s = get_sched(cap);
  if (!s) return nullptr;
  if (rid < 0 || static_cast<size_t>(rid) >= s->reqs.size() ||
      s->reqs[rid].slot < 0) {
    PyErr_SetString(PyExc_ValueError, "rid is not running");
    return nullptr;
  }
  SchedRequest& r = s->reqs[rid];
  int64_t have = static_cast<int64_t>(s->alloc.seq_pages[r.sid].size());
  if (pages_for(s, r.length + 1) > have) {
    if (s->alloc.free_list.empty()) {
      if (s->lazy)  // caller must free pages (evict/preempt) and retry
        return PyLong_FromLong(-1);
      PyErr_SetString(PyExc_MemoryError,
                      "page pool exhausted (reservation accounting bug)");
      return nullptr;
    }
    int32_t p = s->alloc.free_list.back();
    s->alloc.free_list.pop_back();
    s->ref[p] = 1;
    s->alloc.seq_pages[r.sid].push_back(p);
    s->outstanding -= 1;
  }
  r.length += 1;
  return PyLong_FromLongLong(r.length);
}

static PyObject* scheduler_release(PyObject*, PyObject* args) {
  PyObject* cap;
  int rid;
  if (!PyArg_ParseTuple(args, "Oi", &cap, &rid)) return nullptr;
  auto* s = get_sched(cap);
  if (!s) return nullptr;
  if (rid < 0 || static_cast<size_t>(rid) >= s->reqs.size() ||
      s->reqs[rid].slot < 0) {
    PyErr_SetString(PyExc_ValueError, "rid is not running");
    return nullptr;
  }
  SchedRequest& r = s->reqs[rid];
  // LIVE private pages: trimmed holes already rejoined the "unallocated"
  // side of the reservation ledger in scheduler_trim.
  int64_t allocated_private =
      static_cast<int64_t>(s->alloc.seq_pages[r.sid].size()) -
      static_cast<int64_t>(r.shared.size()) - r.trimmed_priv;
  for (int32_t p : s->alloc.seq_pages[r.sid]) {
    if (p < 0) continue;  // hole left by scheduler_trim (rolling window)
    if (--s->ref[p] == 0) s->alloc.free_list.push_back(p);
  }
  s->alloc.seq_pages[r.sid].clear();
  s->alloc.free_seq_slots.push_back(r.sid);
  s->outstanding -= r.reserved - allocated_private;
  s->slots[r.slot] = -1;
  r.slot = -1;
  r.sid = -1;
  Py_RETURN_NONE;
}

// Cancel a WAITING request: remove it from the queue and drop its add-time
// shared-page pins (an abandoned queued request must not block strict-FIFO
// admission behind it, nor leak pinned prefix pages).
static PyObject* scheduler_cancel(PyObject*, PyObject* args) {
  PyObject* cap;
  int rid;
  if (!PyArg_ParseTuple(args, "Oi", &cap, &rid)) return nullptr;
  auto* s = get_sched(cap);
  if (!s) return nullptr;
  auto it = (rid < 0 || static_cast<size_t>(rid) >= s->reqs.size())
                ? s->waiting.end()
                : std::find(s->waiting.begin(), s->waiting.end(), rid);
  if (it == s->waiting.end()) {
    PyErr_SetString(PyExc_ValueError, "rid is not waiting");
    return nullptr;
  }
  s->waiting.erase(it);
  SchedRequest& r = s->reqs[rid];
  for (int32_t p : r.shared) {
    if (--s->ref[p] == 0) s->alloc.free_list.push_back(p);
  }
  r.shared.clear();
  r.canceled = true;
  Py_RETURN_NONE;
}

// Preempt a RUNNING request (lazy policy's page-pressure relief valve):
// frees its slot and PRIVATE pages, keeps its stored length and add-time
// shared-prefix pins, and re-queues it at the FRONT of the waiting queue so
// it resumes before any younger request. The caller owns saving/restoring
// the KV payload of the freed pages.
static PyObject* scheduler_preempt(PyObject*, PyObject* args) {
  PyObject* cap;
  int rid;
  if (!PyArg_ParseTuple(args, "Oi", &cap, &rid)) return nullptr;
  auto* s = get_sched(cap);
  if (!s) return nullptr;
  if (rid < 0 || static_cast<size_t>(rid) >= s->reqs.size() ||
      s->reqs[rid].slot < 0) {
    PyErr_SetString(PyExc_ValueError, "rid is not running");
    return nullptr;
  }
  SchedRequest& r = s->reqs[rid];
  auto& pages = s->alloc.seq_pages[r.sid];
  int64_t allocated_private = static_cast<int64_t>(pages.size()) -
                              static_cast<int64_t>(r.shared.size()) -
                              r.trimmed_priv;
  // only private pages are released — the shared prefix keeps its add-time
  // pin (the prefix payload survives in place for the resume)
  for (size_t i = r.shared.size(); i < pages.size(); ++i) {
    int32_t p = pages[i];
    if (p < 0) continue;  // hole left by scheduler_trim (rolling window)
    if (--s->ref[p] == 0) s->alloc.free_list.push_back(p);
  }
  pages.clear();
  s->alloc.free_seq_slots.push_back(r.sid);
  s->outstanding -= r.reserved - allocated_private;
  s->slots[r.slot] = -1;
  r.slot = -1;
  r.sid = -1;
  r.trimmed_priv = 0;  // re-admission allocates a fresh hole-free table
  r.preempted = true;
  s->waiting.insert(s->waiting.begin(), rid);
  Py_RETURN_NONE;
}

// scheduler_rollback(h, rid, n) — shrink a RUNNING request's stored length
// by n tokens (speculative decode rejection: over-appended draft rows are
// dead — every kernel masks pos < length — and the pages they may have
// grown stay allocated for the immediate re-append). Length never drops
// below 1.
static PyObject* scheduler_rollback(PyObject*, PyObject* args) {
  PyObject* cap;
  int rid;
  long long n;
  if (!PyArg_ParseTuple(args, "OiL", &cap, &rid, &n)) return nullptr;
  auto* s = get_sched(cap);
  if (!s) return nullptr;
  if (rid < 0 || static_cast<size_t>(rid) >= s->reqs.size() ||
      s->reqs[rid].slot < 0) {
    PyErr_SetString(PyExc_ValueError, "rid is not running");
    return nullptr;
  }
  SchedRequest& r = s->reqs[rid];
  if (n < 0 || n >= r.length) {
    PyErr_SetString(PyExc_ValueError, "rollback out of range");
    return nullptr;
  }
  r.length -= n;
  return PyLong_FromLongLong(r.length);
}

// scheduler_trim(h, rid, upto) -> pages actually freed. Release the leading
// `upto` LOGICAL pages of a RUNNING request (StreamingLLM rolling window):
// shared prefix pages are unpinned, private pages freed, and each trimmed
// entry becomes a -1 hole so the page table keeps logical indexing (the
// decode kernel's clamped walk never touches below-window logicals). The
// request's length is unchanged; already-trimmed entries are skipped.
static PyObject* scheduler_trim(PyObject*, PyObject* args) {
  PyObject* cap;
  int rid;
  long long upto;
  long long start = 0;  // first trimmable logical page (sink anchors survive)
  if (!PyArg_ParseTuple(args, "OiL|L", &cap, &rid, &upto, &start))
    return nullptr;
  auto* s = get_sched(cap);
  if (!s) return nullptr;
  if (rid < 0 || static_cast<size_t>(rid) >= s->reqs.size() ||
      s->reqs[rid].slot < 0) {
    PyErr_SetString(PyExc_ValueError, "rid is not running");
    return nullptr;
  }
  SchedRequest& r = s->reqs[rid];
  auto& pages = s->alloc.seq_pages[r.sid];
  if (start < 0) start = 0;
  if (upto < 0) upto = 0;
  if (upto > static_cast<long long>(pages.size()))
    upto = static_cast<long long>(pages.size());
  long long freed = 0;
  for (long long i = start; i < upto; ++i) {
    int32_t p = pages[i];
    if (p < 0) continue;
    if (--s->ref[p] == 0) {
      s->alloc.free_list.push_back(p);
      ++freed;
    }
    if (i >= static_cast<long long>(r.shared.size())) {
      // A trimmed PRIVATE page rejoins the unallocated side of the
      // reservation ledger: the sequence will allocate again as it grows,
      // and admission must keep covering that future draw.
      r.trimmed_priv += 1;
      s->outstanding += 1;
    }
    pages[i] = -1;
  }
  return PyLong_FromLongLong(freed);
}

// Current refcount of a page (0 == free). Lets the eviction loop predict
// whether unpinning would actually return the page to the pool.
static PyObject* scheduler_page_ref(PyObject*, PyObject* args) {
  PyObject* cap;
  int pid;
  if (!PyArg_ParseTuple(args, "Oi", &cap, &pid)) return nullptr;
  auto* s = get_sched(cap);
  if (!s) return nullptr;
  if (pid < 0 || pid >= s->alloc.num_pages) {
    PyErr_SetString(PyExc_ValueError, "page id out of range");
    return nullptr;
  }
  return PyLong_FromLong(s->ref[pid]);
}

static PyObject* scheduler_page_table(PyObject*, PyObject* args) {
  PyObject* cap;
  int rid;
  if (!PyArg_ParseTuple(args, "Oi", &cap, &rid)) return nullptr;
  auto* s = get_sched(cap);
  if (!s) return nullptr;
  if (rid < 0 || static_cast<size_t>(rid) >= s->reqs.size() ||
      s->reqs[rid].slot < 0) {
    PyErr_SetString(PyExc_ValueError, "rid is not running");
    return nullptr;
  }
  const auto& pages = s->alloc.seq_pages[s->reqs[rid].sid];
  PyObject* lst = PyList_New(pages.size());
  for (size_t i = 0; i < pages.size(); ++i)
    PyList_SET_ITEM(lst, i, PyLong_FromLong(pages[i]));
  return lst;
}

static PyObject* scheduler_info(PyObject*, PyObject* args) {
  PyObject* cap;
  int rid;
  if (!PyArg_ParseTuple(args, "Oi", &cap, &rid)) return nullptr;
  auto* s = get_sched(cap);
  if (!s) return nullptr;
  if (rid < 0 || static_cast<size_t>(rid) >= s->reqs.size()) {
    PyErr_SetString(PyExc_ValueError, "bad rid");
    return nullptr;
  }
  const SchedRequest& r = s->reqs[rid];
  return Py_BuildValue("{s:L,s:L,s:L,s:i,s:n,s:O,s:O}", "prompt_len",
                       (long long)r.prompt_len, "max_new", (long long)r.max_new,
                       "length", (long long)r.length, "slot", (int)r.slot,
                       "shared", static_cast<Py_ssize_t>(r.shared.size()),
                       "preempted", r.preempted ? Py_True : Py_False,
                       "canceled", r.canceled ? Py_True : Py_False);
}

static PyObject* scheduler_stats(PyObject*, PyObject* args) {
  PyObject* cap;
  if (!PyArg_ParseTuple(args, "O", &cap)) return nullptr;
  auto* s = get_sched(cap);
  if (!s) return nullptr;
  int32_t used_slots = 0;
  for (int32_t i = 0; i < s->max_running; ++i)
    if (s->slots[i] >= 0) ++used_slots;
  return Py_BuildValue(
      "{s:L,s:n,s:L,s:i,s:i,s:n}", "num_pages",
      static_cast<long long>(s->alloc.num_pages), "free_pages",
      static_cast<Py_ssize_t>(s->alloc.free_list.size()), "outstanding",
      static_cast<long long>(s->outstanding), "max_running",
      static_cast<int>(s->max_running), "used_slots", static_cast<int>(used_slots),
      "waiting", static_cast<Py_ssize_t>(s->waiting.size()));
}

// ---------------------------------------------------------------------------

static PyMethodDef Methods[] = {
    {"pack_int4", pack_int4, METH_VARARGS,
     "pack int8 codes [rows,d] into halves-of-D nibbles -> bytes [rows,d/2]"},
    {"unpack_int4", unpack_int4, METH_VARARGS,
     "unpack halves-of-D nibbles -> int8 codes bytes [rows,d]"},
    {"quant_int8_per_token", quant_int8_per_token, METH_VARARGS,
     "per-token symmetric int8 quant of float32 [rows,d] -> (codes, scales)"},
    {"allocator_new", allocator_new, METH_VARARGS, "create page allocator"},
    {"allocator_new_seq", allocator_new_seq, METH_VARARGS, "register sequence"},
    {"allocator_append_page", allocator_append_page, METH_VARARGS,
     "allocate one page to a sequence"},
    {"allocator_free_seq", allocator_free_seq, METH_VARARGS,
     "release a sequence's pages"},
    {"allocator_seq_pages", allocator_seq_pages, METH_VARARGS,
     "page table of a sequence"},
    {"allocator_stats", allocator_stats, METH_VARARGS, "allocator stats"},
    {"scheduler_new", scheduler_new, METH_VARARGS,
     "create continuous-batching scheduler(num_pages, page_size, max_running"
     "[, lazy])"},
    {"scheduler_cancel", scheduler_cancel, METH_VARARGS,
     "remove a waiting request from the queue; unpins its shared pages"},
    {"scheduler_rollback", scheduler_rollback, METH_VARARGS,
     "shrink a running request's stored length (speculative rejection)"},
    {"scheduler_trim", scheduler_trim, METH_VARARGS,
     "release leading logical pages of a running request (rolling window)"},
    {"scheduler_preempt", scheduler_preempt, METH_VARARGS,
     "swap a running request back to the front of the waiting queue"},
    {"scheduler_page_ref", scheduler_page_ref, METH_VARARGS,
     "current refcount of a page (0 == free)"},
    {"scheduler_add", scheduler_add, METH_VARARGS,
     "queue request(prompt_len, max_new) -> rid"},
    {"scheduler_step", scheduler_step, METH_VARARGS,
     "FIFO admission pass -> {admitted, running, waiting}"},
    {"scheduler_append_token", scheduler_append_token, METH_VARARGS,
     "grow a running sequence by one stored token -> new length"},
    {"scheduler_release", scheduler_release, METH_VARARGS,
     "finish a request: free its pages and slot"},
    {"scheduler_page_table", scheduler_page_table, METH_VARARGS,
     "physical page ids of a running request"},
    {"scheduler_info", scheduler_info, METH_VARARGS, "per-request info"},
    {"scheduler_update_shared", scheduler_update_shared, METH_VARARGS,
     "re-resolve a waiting request's shared prefix pages"},
    {"scheduler_ref_page", scheduler_ref_page, METH_VARARGS,
     "pin an allocated page (+1 ref) -> new refcount"},
    {"scheduler_unref_page", scheduler_unref_page, METH_VARARGS,
     "unpin a page (-1 ref; freed at 0) -> new refcount"},
    {"scheduler_stats", scheduler_stats, METH_VARARGS, "pool/slot stats"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_lowbit_host",
    "native host runtime: bit packing, quantization, KV page allocator",
    -1, Methods};

}  // namespace

PyMODINIT_FUNC PyInit__lowbit_host(void) { return PyModule_Create(&moduledef); }
