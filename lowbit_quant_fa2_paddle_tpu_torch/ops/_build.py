"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Every ``csrc/*.cu`` of this package is compiled for Hopper (``sm_90a``), one
nvcc process per source, all started together (``-I csrc/`` for the shared
headers such as ``sm90.cuh``), and linked into one shared library with a
plain C interface, at first use, into ``csrc/build/`` keyed by a hash of
every source and header (``*.cu``, ``*.cuh``, ``*.h``) and the flags. Nothing here runs at import: the CPU
tests import every module on a machine with no nvcc.

No ``--use_fast_math``: the quantized codes depend on IEEE division and on exact
round-half-away-from-zero.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points and their argument types (see the extern "C" blocks in csrc/).
_SIGNATURES = {
    "lowbit_quant": [_P, _I, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "lowbit_quant_vec": [_P, _I, _LL, _LL, _LL, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "lowbit_attn_fwd_wgmma": [_P] * 12 + [_I] * 16 + [_F, _F, _P],
    "lowbit_decode_attn": [_P] * 11 + [_I] * 15 + [_F, _F, _P],
    "lowbit_decode_attn_d256": [_P] * 11 + [_I] * 15 + [_F, _F, _P],
    "lowbit_decode_ctas_per_sm": [_I, _I, _I, _I, _I, _P],
    "lowbit_decode_ctas_per_sm_d256": [_I, _I, _I, _I, _I, _P],
    "lowbit_decode_attn_multi": [_P] * 11 + [_I] * 17 + [_F, _F, _P],
    "lowbit_decode_multi_ctas_per_sm": [_I, _I, _I, _I, _I, _P],
    "lowbit_decode_attn_multi_d256": [_P] * 11 + [_I] * 17 + [_F, _F, _P],
    "lowbit_decode_multi_ctas_per_sm_d256": [_I, _I, _I, _I, _I, _P],
    "lowbit_decode_attn_paged": [_P] * 11 + [_I] * 17 + [_P] + [_I] * 3 + [_F, _F, _P],
    "lowbit_decode_paged_ctas_per_sm": [_I, _I, _I, _I, _I, _P],
    "lowbit_decode_attn_paged_d256": [_P] * 11 + [_I] * 17 + [_P] + [_I] * 3 + [_F, _F, _P],
    "lowbit_decode_paged_ctas_per_sm_d256": [_I, _I, _I, _I, _I, _P],
    "lowbit_decode_attn_d80_96": [_P] * 11 + [_I] * 15 + [_F, _F, _P],
    "lowbit_decode_ctas_per_sm_d80_96": [_I, _I, _I, _I, _I, _P],
    "lowbit_decode_attn_multi_d80_96": [_P] * 11 + [_I] * 17 + [_F, _F, _P],
    "lowbit_decode_multi_ctas_per_sm_d80_96": [_I, _I, _I, _I, _I, _P],
    "lowbit_decode_attn_paged_d80_96": [_P] * 11 + [_I] * 17 + [_P] + [_I] * 3 + [_F, _F, _P],
    "lowbit_decode_paged_ctas_per_sm_d80_96": [_I, _I, _I, _I, _I, _P],
    "lowbit_decode_attn_dyn": [_P] * 11 + [_I] * 15 + [_F, _F, _P],
    "lowbit_decode_ctas_per_sm_dyn": [_I, _I, _I, _I, _I, _P],
    "lowbit_decode_attn_multi_dyn": [_P] * 11 + [_I] * 17 + [_F, _F, _P],
    "lowbit_decode_multi_ctas_per_sm_dyn": [_I, _I, _I, _I, _I, _P],
    "lowbit_decode_attn_paged_dyn": [_P] * 11 + [_I] * 17 + [_P] + [_I] * 3 + [_F, _F, _P],
    "lowbit_decode_paged_ctas_per_sm_dyn": [_I, _I, _I, _I, _I, _P],
    "lowbit_gemv": [_P] * 5 + [_I] * 9 + [_P],
    "lowbit_gemv_w8": [_P] * 7 + [_I] * 10 + [_P],
    "lowbit_gemv_tc": [_P] * 7 + [_I] * 13 + [_P],
    "lowbit_fused_kv_attn_wgmma": [_P] * 8 + [_I] * 13 + [_F, _P],
    "lowbit_attn_bwd_wgmma": [_P] * 13 + [_I] * 12 + [_F, _F, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[str]:
    """The kernel sources: every ``.cu`` under ``csrc/``, sorted."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def hashed_files() -> List[str]:
    """What the build reads: the sources and every header under ``csrc/``."""
    return sorted(f for ext in ("*.cu", "*.cuh", "*.h") for f in glob.glob(os.path.join(CSRC_DIR, ext)))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in hashed_files():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"liblowbit_kernels_{h.hexdigest()[:16]}.so")


def nvcc_commands(out_path: str, nvcc: str = "nvcc") -> Tuple[List[List[str]], List[str]]:
    """One compile command per source (objects beside ``out_path``) and the
    link command that makes the shared library ``out_path``."""
    objs = [f"{out_path}.{os.path.splitext(os.path.basename(src))[0]}.o" for src in sources()]
    compiles = [[nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-c", src, "-o", obj] for src, obj in zip(sources(), objs)]
    return compiles, [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", out_path, *objs]


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    compiles, link = nvcc_commands(tmp, _nvcc())
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in compiles]
    outs = [p.communicate()[0] for p in procs]
    with open(path + ".log", "w") as f:
        f.write("".join(outs))
    for src, p, out in zip(sources(), procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}) on {src}:\n{out[-8000:]}")
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
    for cmd in compiles:
        os.remove(cmd[-1])
    os.replace(tmp, path)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has none."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a ``cudaError_t``)."""
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError {err}")
