"""Host-side runtime of the port's serving engine: bit packing,
quantization, the KV page allocator and the continuous-batching scheduler.

The port's own copy of the JAX package's ``host`` module (the port imports
nothing of that package). The native side is the C++ extension
``_lowbit_host``, built from the port's copy of its source
(``csrc/lowbit_host.cpp``) with the host C++ compiler at first use, into
``csrc/build/host/`` keyed by the source's hash and the flags, and loaded as
``lowbit_quant_fa2_paddle_tpu_torch.host._lowbit_host``. Every function and
class takes ``native`` (default True); ``native=False`` runs the pure-Python
plain version, which the tests hold the native one against. A failed build
raises: nothing falls back.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from typing import List, Sequence, Tuple

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCE = os.path.join(_CSRC, "lowbit_host.cpp")
BUILD_DIR = os.path.join(_CSRC, "build", "host")
MODULE = "lowbit_quant_fa2_paddle_tpu_torch.host._lowbit_host"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lock = threading.Lock()
_ext = None


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler found (g++): the host extension cannot be built")


def extension_path() -> str:
    """Where the extension for the current source, flags and Python lives."""
    include = sysconfig.get_paths()["include"]
    h = hashlib.sha256(" ".join(CXX_FLAGS + [include, sys.version]).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"_lowbit_host_{h.hexdigest()[:16]}{sysconfig.get_config_var('EXT_SUFFIX')}")


def build_command(out_path: str, cxx: str = "g++") -> List[str]:
    """The host compiler's command that builds the extension at ``out_path``."""
    return [cxx, *CXX_FLAGS, f"-I{sysconfig.get_paths()['include']}", SOURCE, "-o", out_path]


def extension():
    """The loaded extension, built first if this source hash has none."""
    global _ext
    with _lock:
        if _ext is not None:
            return _ext
        path = extension_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.run(build_command(tmp, _cxx()), capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building the host extension failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
            os.replace(tmp, path)
        loader = importlib.machinery.ExtensionFileLoader(MODULE, path)
        spec = importlib.util.spec_from_file_location(MODULE, path, loader=loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        sys.modules[MODULE] = mod
        _ext = mod
        return mod


def pack_int4(codes: np.ndarray, *, native: bool = True) -> np.ndarray:
    """int8 codes [rows, d] -> packed [rows, d/2] (halves-of-D nibbles, the
    layout of ops/quant.py's 4-bit codes)."""
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    rows, d = codes.shape
    if native:
        raw = extension().pack_int4(codes)
        return np.frombuffer(raw, dtype=np.int8).reshape(rows, d // 2).copy()
    lo = codes[:, : d // 2].astype(np.int32) & 0xF
    hi = codes[:, d // 2 :].astype(np.int32) & 0xF
    return (lo | (hi << 4)).astype(np.int8)


def unpack_int4(packed: np.ndarray, *, native: bool = True) -> np.ndarray:
    packed = np.ascontiguousarray(packed, dtype=np.int8)
    rows, dp = packed.shape
    if native:
        raw = extension().unpack_int4(packed)
        return np.frombuffer(raw, dtype=np.int8).reshape(rows, dp * 2).copy()
    p = packed.astype(np.int32)
    lo = ((p << 28) >> 28).astype(np.int8)
    hi = (p >> 4).astype(np.int8)
    return np.concatenate([lo, hi], axis=1)


def quant_int8_per_token(x: np.ndarray, *, native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """float32 [rows, d] -> (int8 codes, f32 scales[rows]): abs-max/127 +
    1e-7 (divided, then added), codes rounded half away from zero."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    rows, d = x.shape
    if native:
        codes_raw, scales_raw = extension().quant_int8_per_token(x)
        codes = np.frombuffer(codes_raw, dtype=np.int8).reshape(rows, d).copy()
        scales = np.frombuffer(scales_raw, dtype=np.float32).copy()
        return codes, scales
    amax = np.abs(x).max(axis=1)
    scales = amax / 127.0 + 1e-7
    v = x / scales[:, None]
    codes = np.clip(np.sign(v) * np.floor(np.abs(v) + 0.5), -127, 127).astype(np.int8)
    return codes, scales.astype(np.float32)


class PageAllocator:
    """Free-list page allocator for paged KV caches (vLLM-style block
    manager). ``native=False`` runs the pure-Python plain version."""

    def __init__(self, num_pages: int, *, native: bool = True):
        self.num_pages = num_pages
        if native:
            self._n = extension()
            self._h = self._n.allocator_new(num_pages)
        else:
            self._h = None
            self._free: List[int] = list(range(num_pages - 1, -1, -1))
            self._seqs: List[List[int]] = []
            self._free_slots: List[int] = []

    def new_seq(self) -> int:
        if self._h is not None:
            return self._n.allocator_new_seq(self._h)
        if self._free_slots:
            sid = self._free_slots.pop()
            self._seqs[sid] = []
            return sid
        self._seqs.append([])
        return len(self._seqs) - 1

    def append_page(self, sid: int) -> int:
        if self._h is not None:
            return self._n.allocator_append_page(self._h, sid)
        if not self._free:
            raise MemoryError("out of KV pages")
        page = self._free.pop()
        self._seqs[sid].append(page)
        return page

    def free_seq(self, sid: int) -> None:
        if self._h is not None:
            self._n.allocator_free_seq(self._h, sid)
            return
        self._free.extend(self._seqs[sid])
        self._seqs[sid] = []
        self._free_slots.append(sid)

    def seq_pages(self, sid: int) -> List[int]:
        if self._h is not None:
            return self._n.allocator_seq_pages(self._h, sid)
        return list(self._seqs[sid])

    def stats(self) -> dict:
        if self._h is not None:
            return self._n.allocator_stats(self._h)
        return {
            "num_pages": self.num_pages,
            "free_pages": len(self._free),
            "num_seqs": len(self._seqs) - len(self._free_slots),
        }


class Scheduler:
    """Continuous-batching request scheduler (serving control plane).

    FIFO admission over ``max_running`` decode slots and a page pool of
    ``num_pages`` pages of ``page_size`` tokens. Two admission policies:

    * ``lazy=False`` (reserve, default): a request is admitted only when a
      slot is free AND the pool can cover its worst-case page need
      (``prompt_len + max_new - 1`` stored tokens) on top of every running
      request's outstanding reservation — pages are then allocated lazily
      as the sequence grows, so decode-time growth (:meth:`append_token`)
      can never fail and no preemption machinery is needed.
    * ``lazy=True``: admission only requires the request's CURRENT content
      pages to fit the free pool, so admitted concurrency is much higher on
      bursty mixed-length workloads; in exchange :meth:`append_token` may
      return ``-1`` on pool exhaustion and the caller must free pages
      (cache eviction / :meth:`preempt`) and retry.

    The native C++ implementation (csrc/lowbit_host.cpp) by default;
    ``native=False`` runs the pure-Python plain version below, which makes
    the same decisions.
    """

    def __init__(self, num_pages: int, page_size: int, max_running: int,
                 lazy: bool = False, *, native: bool = True):
        self.page_size = page_size
        self.max_running = max_running
        self.num_pages = num_pages
        self.lazy = bool(lazy)
        if native:
            self._n = extension()
            self._h = self._n.scheduler_new(num_pages, page_size, max_running,
                                            bool(lazy))
            return
        self._h = None
        if min(num_pages, page_size, max_running) <= 0:
            raise ValueError("num_pages/page_size/max_running must be > 0")
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref: List[int] = [0] * num_pages
        self._slots: List[int] = [-1] * max_running
        self._waiting: List[int] = []
        self._reqs: List[dict] = []
        self._outstanding = 0

    def _pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def _alloc_page(self) -> int:
        p = self._free.pop()
        self._ref[p] = 1
        return p

    def add(self, prompt_len: int, max_new: int, shared_pages: Sequence[int] = ()) -> int:
        """Queue a request; returns its rid (rids are never reused).
        ``shared_pages``: prefix-cache page ids (each currently allocated)
        covering whole leading prompt pages; pinned for the request's
        lifetime at add time."""
        if self._h is not None:
            return self._n.scheduler_add(self._h, prompt_len, max_new, list(shared_pages))
        if prompt_len <= 0 or max_new <= 0:
            raise ValueError("prompt_len and max_new must be > 0")
        shared = list(shared_pages)
        for p in shared:
            if p < 0 or p >= self.num_pages or self._ref[p] <= 0:
                raise ValueError("shared page id out of range or not pinned")
        if len(shared) * self.page_size >= prompt_len:
            raise ValueError("shared pages must cover strictly less than the prompt")
        need = self._pages_for(prompt_len + max_new - 1) - len(shared)
        if need > self.num_pages:
            raise MemoryError("request can never fit: worst-case pages exceed the pool")
        for p in shared:
            self._ref[p] += 1
        rid = len(self._reqs)
        self._reqs.append(
            {"prompt_len": prompt_len, "max_new": max_new, "length": 0,
             "reserved": need, "slot": -1, "pages": None, "shared": shared,
             "preempted": False, "canceled": False, "trimmed_priv": 0}
        )
        self._waiting.append(rid)
        return rid

    def update_shared(self, rid: int, shared_pages: Sequence[int]) -> None:
        """Re-resolve a WAITING request's shared prefix pages (pins the new
        set, unpins the old, recomputes the private reservation)."""
        if self._h is not None:
            self._n.scheduler_update_shared(self._h, rid, list(shared_pages))
            return
        if rid < 0 or rid >= len(self._reqs) or self._reqs[rid]["slot"] >= 0 \
                or rid not in self._waiting:
            raise ValueError("rid is not waiting")
        r = self._reqs[rid]
        shared = list(shared_pages)
        for p in shared:
            if p < 0 or p >= self.num_pages or self._ref[p] <= 0:
                raise ValueError("shared page id out of range or not pinned")
        if len(shared) * self.page_size >= r["prompt_len"]:
            raise ValueError("shared pages must cover strictly less than the prompt")
        for p in shared:
            self._ref[p] += 1
        for p in r["shared"]:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
        r["shared"] = shared
        r["reserved"] = self._pages_for(r["prompt_len"] + r["max_new"] - 1) - len(shared)

    def ref_page(self, pid: int) -> int:
        """Pin an allocated page (+1 ref); returns the new refcount."""
        if self._h is not None:
            return self._n.scheduler_ref_page(self._h, pid)
        if pid < 0 or pid >= self.num_pages or self._ref[pid] <= 0:
            raise ValueError("page is not allocated")
        self._ref[pid] += 1
        return self._ref[pid]

    def unref_page(self, pid: int) -> int:
        """Unpin a page (-1 ref; returned to the free list at 0)."""
        if self._h is not None:
            return self._n.scheduler_unref_page(self._h, pid)
        if pid < 0 or pid >= self.num_pages or self._ref[pid] <= 0:
            raise ValueError("page is not allocated")
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)
        return self._ref[pid]

    def step(self) -> dict:
        """One FIFO admission pass -> {admitted: [rid], running: [rid],
        waiting: n}. Admitted requests have their prompt pages allocated and
        ``length == prompt_len``."""
        if self._h is not None:
            return self._n.scheduler_step(self._h)
        admitted = []
        while self._waiting:
            rid = self._waiting[0]
            r = self._reqs[rid]
            free_slots = [i for i, v in enumerate(self._slots) if v < 0]
            if not free_slots:
                break
            content = r["length"] if r["preempted"] else r["prompt_len"]
            private_now = self._pages_for(content) - len(r["shared"])
            if self.lazy:
                if len(self._free) < private_now:
                    break
            elif len(self._free) - self._outstanding < r["reserved"]:
                break
            self._waiting.pop(0)
            r["slot"] = free_slots[0]
            self._slots[free_slots[0]] = rid
            r["pages"] = list(r["shared"]) + [
                self._alloc_page() for _ in range(private_now)
            ]
            r["length"] = content
            r["preempted"] = False
            self._outstanding += r["reserved"] - private_now
            admitted.append(rid)
        return {
            "admitted": admitted,
            "running": [v for v in self._slots if v >= 0],
            "waiting": len(self._waiting),
        }

    def append_token(self, rid: int) -> int:
        """Grow a running sequence by one stored token (allocates a page on
        boundary crossing; guaranteed by admission accounting under the
        reserve policy). Under ``lazy`` returns ``-1`` when the pool is
        exhausted — the caller must free pages and retry."""
        if self._h is not None:
            return self._n.scheduler_append_token(self._h, rid)
        r = self._require_running(rid)
        if self._pages_for(r["length"] + 1) > len(r["pages"]):
            if not self._free:
                if self.lazy:
                    return -1
                raise MemoryError("page pool exhausted (reservation accounting bug)")
            r["pages"].append(self._alloc_page())
            self._outstanding -= 1
        r["length"] += 1
        return r["length"]

    def release(self, rid: int) -> None:
        """Finish a request: free its pages and slot."""
        if self._h is not None:
            self._n.scheduler_release(self._h, rid)
            return
        r = self._require_running(rid)
        # LIVE private pages: trimmed holes already rejoined the ledger.
        allocated_private = len(r["pages"]) - len(r["shared"]) - r["trimmed_priv"]
        for p in r["pages"]:
            if p < 0:  # hole left by trim (rolling window)
                continue
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
        self._outstanding -= r["reserved"] - allocated_private
        self._slots[r["slot"]] = -1
        r["slot"], r["pages"] = -1, None

    def cancel(self, rid: int) -> None:
        """Remove a WAITING request from the queue and drop its add-time
        shared-page pins (an abandoned queued request must not block
        strict-FIFO admission, nor leak pinned prefix pages)."""
        if self._h is not None:
            self._n.scheduler_cancel(self._h, rid)
            return
        if rid < 0 or rid >= len(self._reqs) or rid not in self._waiting:
            raise ValueError("rid is not waiting")
        self._waiting.remove(rid)
        r = self._reqs[rid]
        for p in r["shared"]:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
        r["shared"] = []
        r["canceled"] = True

    def preempt(self, rid: int) -> None:
        """Swap a RUNNING request back to the FRONT of the waiting queue:
        frees its slot and private pages, keeps its stored length and its
        shared-prefix pins. The caller owns saving/restoring the freed
        pages' KV payload (the engine swaps it to host memory bit-exactly,
        so generated tokens are invariant to preemption)."""
        if self._h is not None:
            self._n.scheduler_preempt(self._h, rid)
            return
        r = self._require_running(rid)
        allocated_private = len(r["pages"]) - len(r["shared"]) - r["trimmed_priv"]
        for p in r["pages"][len(r["shared"]):]:
            if p < 0:  # hole left by trim (rolling window)
                continue
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
        r["trimmed_priv"] = 0  # re-admission allocates a fresh table
        self._outstanding -= r["reserved"] - allocated_private
        self._slots[r["slot"]] = -1
        r["slot"], r["pages"] = -1, None
        r["preempted"] = True
        self._waiting.insert(0, rid)

    def rollback(self, rid: int, n: int) -> int:
        """Shrink a RUNNING request's stored length by ``n`` tokens
        (speculative-decode rejection): the over-appended rows are dead —
        every kernel masks ``pos < length`` — and any pages they grew stay
        allocated for the immediate re-append. Returns the new length."""
        if self._h is not None:
            return self._n.scheduler_rollback(self._h, rid, int(n))
        r = self._require_running(rid)
        if n < 0 or n >= r["length"]:
            raise ValueError("rollback out of range")
        r["length"] -= int(n)
        return r["length"]

    def trim(self, rid: int, upto: int, start: int = 0) -> int:
        """Release LOGICAL pages ``[start, upto)`` of a RUNNING request
        (StreamingLLM rolling window; ``start`` protects the sink anchors):
        shared prefix pages are unpinned, private pages freed, and each
        trimmed entry becomes a ``-1`` hole so :meth:`page_table` keeps
        logical indexing (the decode kernel's clamped walk never touches
        below-window logicals). Length is unchanged; already-trimmed
        entries are skipped. Returns the number of pages actually returned
        to the pool."""
        if self._h is not None:
            return self._n.scheduler_trim(self._h, rid, int(upto), int(start))
        r = self._require_running(rid)
        upto = max(0, min(int(upto), len(r["pages"])))
        freed = 0
        for i in range(max(0, int(start)), upto):
            p = r["pages"][i]
            if p < 0:
                continue
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                freed += 1
            if i >= len(r["shared"]):
                # A trimmed PRIVATE page rejoins the unallocated side of
                # the reservation ledger (the sequence allocates again as
                # it grows; admission must keep covering that draw).
                r["trimmed_priv"] += 1
                self._outstanding += 1
            r["pages"][i] = -1
        return freed

    def page_ref(self, pid: int) -> int:
        """Current refcount of a page (0 == free)."""
        if self._h is not None:
            return self._n.scheduler_page_ref(self._h, pid)
        if pid < 0 or pid >= self.num_pages:
            raise ValueError("page id out of range")
        return self._ref[pid]

    def page_table(self, rid: int) -> List[int]:
        if self._h is not None:
            return self._n.scheduler_page_table(self._h, rid)
        return list(self._require_running(rid)["pages"])

    def info(self, rid: int) -> dict:
        if self._h is not None:
            return self._n.scheduler_info(self._h, rid)
        r = self._reqs[rid]
        out = {k: r[k] for k in
               ("prompt_len", "max_new", "length", "slot", "preempted", "canceled")}
        out["shared"] = len(r["shared"])
        return out

    def stats(self) -> dict:
        if self._h is not None:
            return self._n.scheduler_stats(self._h)
        return {
            "num_pages": self.num_pages,
            "free_pages": len(self._free),
            "outstanding": self._outstanding,
            "max_running": self.max_running,
            "used_slots": sum(1 for v in self._slots if v >= 0),
            "waiting": len(self._waiting),
        }

    def _require_running(self, rid: int) -> dict:
        if rid < 0 or rid >= len(self._reqs) or self._reqs[rid]["slot"] < 0:
            raise ValueError("rid is not running")
        return self._reqs[rid]
