"""Durable tuning cache for the launch plans of kernels D, F1 and F2.

PyTorch counterpart of ``lowbit_quant_fa2_paddle_tpu/utils/tuning.py``,
with its API whole: :func:`cache_path`, :func:`lookup`,
:func:`lookup_entry`, :func:`pow2_bucket`, :func:`record`,
:func:`clear_memory_cache`. Entries are keyed
``"{device}|{kernel}|d{d}|s{s}|c{causal}"``; the device kind is
``torch.cuda.get_device_name()`` with spaces replaced by ``_`` (e.g.
``NVIDIA_H100_80GB_HBM3``), or ``"cpu"``.

Cache file: ``$LOWBIT_FA_TORCH_TUNING_CACHE`` or
``~/.cache/lowbit_fa_torch/tuning.json``, a file of its own, so the two
packages never share one. A bundled layer (``tuning_defaults.json`` beside
this module, overridden entry by entry by the user file) ships with the
package and starts empty: the JAX package's bundled winners are TPU ones.
A missing or corrupt file reads as empty; nothing here raises on a read.

What the launchers read (``tools/autotune.py --save`` writes them):

* ``decode_k{kb}v{vb}`` (the cache's actual bits a side, 16 for bf16), head
  dim, ``pow2_bucket(S_max)``: ``{"waves": w}``, how many waves of resident
  CTAs kernel D's split-KV plan fills (``ops/decode.py`` ``num_splits``; a
  positive number, 0.5 fills half a wave). Contiguous, unwindowed calls
  only, as in JAX.
* ``gemv_w{bits}``, K, ``pow2_bucket(N)``: ``{"max_splits": n}``, a cap on
  the K splits of F1's ring plan (``ops/gemv.py`` ``w8_plan``) or F2's
  tensor-core plan (``tc_plan``) under ``wq_matmul_per_channel``.

A plan is made on the host from shapes and this cache only, never from
data on the device. A CUDA graph keeps the plan it was captured with: a
:func:`record` after ``models.llm.decode_tokens`` or the serving engine
captured their step does not change the captured graph, only calls made
after it (and graphs captured after it).
"""

from __future__ import annotations

import functools
import json
import os
import threading
from typing import Optional, Tuple

import torch

_LOCK = threading.RLock()  # record() -> _load() re-enters
_CACHE: Optional[dict] = None


def cache_path() -> str:
    return os.environ.get(
        "LOWBIT_FA_TORCH_TUNING_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "lowbit_fa_torch", "tuning.json"),
    )


@functools.lru_cache(maxsize=None)
def _cuda_name(index: int) -> str:
    return torch.cuda.get_device_name(index).replace(" ", "_")


def device_kind(device=None) -> str:
    """The key's device part for ``device`` (a ``torch.device`` or its
    string): the CUDA card's name with ``_`` for spaces, or ``"cpu"``;
    ``None`` reads the current CUDA device, or ``"cpu"`` without one."""
    if device is None:
        return _cuda_name(torch.cuda.current_device()) if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return _cuda_name(device.index if device.index is not None else torch.cuda.current_device())


def _key(kernel: str, d: int, s: int, causal: bool, device: Optional[str]) -> str:
    dev = device if device is not None else device_kind()
    return f"{dev}|{kernel}|d{d}|s{s}|c{int(bool(causal))}"


def _bundled_path() -> str:
    return os.path.join(os.path.dirname(__file__), "tuning_defaults.json")


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def _load() -> dict:
    """Merged lookup view: the bundled layer overridden entry by entry by
    the user cache. The user cache FILE never absorbs bundled entries:
    :func:`record` rewrites only user-recorded ones."""
    global _CACHE
    with _LOCK:
        if _CACHE is None:
            merged = _read_json(_bundled_path())
            merged.update(_read_json(cache_path()))
            _CACHE = merged
        return _CACHE


def lookup(kernel: str, d: int, s: int, causal: bool, device: Optional[str] = None) -> Optional[Tuple[int, int]]:
    """A tuned ``(block_q, block_kv)`` or None. Never raises."""
    ent = _load().get(_key(kernel, d, s, causal, device))
    if not isinstance(ent, dict) or "block_q" not in ent or "block_kv" not in ent:
        return None
    return int(ent["block_q"]), int(ent["block_kv"])


def lookup_entry(kernel: str, d: int, s: int, causal: bool, device: Optional[str] = None) -> Optional[dict]:
    """The full tuning entry (``waves`` for the decode space,
    ``max_splits`` for the gemv space, its ``us`` and spread) or None.
    Never raises."""
    ent = _load().get(_key(kernel, d, s, causal, device))
    return dict(ent) if isinstance(ent, dict) and ent else None


def pow2_bucket(s: int) -> int:
    """The NEAREST power of two (geometric) for context-length and width
    keys: an entry recorded at 128K serves a 130K cache (128K + generation
    slack) rather than falling in the empty 256K bucket."""
    if s <= 1:
        return 1
    hi = 1
    while hi < s:
        hi <<= 1
    lo = hi >> 1
    # geometric midpoint: s belongs to lo when s^2 < lo*hi
    return lo if s * s < lo * hi else hi


def record(
    kernel: str,
    d: int,
    s: int,
    causal: bool,
    block_q: int,
    block_kv: int,
    tflops: float = 0.0,
    device: Optional[str] = None,
    extra: Optional[dict] = None,
) -> str:
    """Persist a tuning entry; returns the cache path."""
    path = cache_path()
    entry = {"block_q": int(block_q), "block_kv": int(block_kv), "tflops": float(tflops)}
    if extra:
        entry.update(extra)
    key = _key(kernel, d, s, causal, device)
    with _LOCK:
        user = _read_json(path)
        user[key] = entry
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(user, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        _load()[key] = entry
    return path


def clear_memory_cache() -> None:
    """Drop the in-process copy (tests; pick up external edits)."""
    global _CACHE
    with _LOCK:
        _CACHE = None
