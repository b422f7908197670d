"""Port parity: the port's host runtime (``lowbit_quant_fa2_paddle_tpu_torch.host``)
against the JAX package's ``host``.

* The scheduler: the port's native extension (built from its own copy of the
  C++ source), its pure-Python plain version and JAX's ``host.Scheduler``
  run the same seeded random operation sequences (add with and without
  shared prefix pages, step, append_token, release, cancel, preempt,
  rollback, trim, update_shared, ref/unref) under reserve and lazy
  admission, and give the same results, errors, admitted lists, page
  tables, per-request info and stats after every operation.
* ``pack_int4``/``unpack_int4``/``quant_int8_per_token``: bit-equal with
  JAX's, native and plain.
* The page allocator, native and plain, on one sequence of operations.
"""

import os

import numpy as np
import pytest
import torch

from lowbit_quant_fa2_paddle_tpu import host as jhost
from lowbit_quant_fa2_paddle_tpu_torch import host as thost

# One intra-op thread: the suite runs a worker per core, and torch's thread
# pool, spinning under that load, slowed small CPU ops up to 50-fold.
torch.set_num_threads(1)


def _call(obj, name, *args):
    try:
        return ("ok", getattr(obj, name)(*args))
    except (ValueError, MemoryError) as e:
        return ("error", type(e).__name__)


def _snapshot(s, rids):
    out = {"stats": s.stats()}
    for rid in rids:
        info = s.info(rid)
        out[rid] = (info, s.page_table(rid) if info["slot"] >= 0 else None)
    return out


def _random_ops(rng, sched, n_ops, num_pages, page_size):
    """One operation at a time: (name, args) drawn against sched's state."""
    rids = []
    for _ in range(n_ops):
        running = [r for r in rids if sched.info(r)["slot"] >= 0]
        waiting = [r for r in rids if sched.info(r)["slot"] < 0 and not sched.info(r)["canceled"]]
        op = rng.choice(["add", "add_shared", "step", "step", "append", "append", "append", "release", "cancel",
                         "preempt", "rollback", "trim", "update_shared", "ref", "unref", "bad"])
        pinned = [p for p in range(num_pages) if sched.page_ref(p) > 0]
        if op == "add":
            yield "add", (int(rng.integers(1, 4 * page_size)), int(rng.integers(1, 3 * page_size)))
            rids.append(len(rids))
        elif op == "add_shared" and pinned:
            n = int(rng.integers(1, min(3, len(pinned)) + 1))
            shared = [int(p) for p in rng.choice(pinned, n, replace=False)]
            yield "add", (n * page_size + int(rng.integers(1, 2 * page_size)), int(rng.integers(1, 2 * page_size)),
                          shared)
            rids.append(len(rids))
        elif op == "step":
            yield "step", ()
        elif op == "append" and running:
            yield "append_token", (int(rng.choice(running)),)
        elif op == "release" and running:
            yield "release", (int(rng.choice(running)),)
        elif op == "cancel" and waiting:
            yield "cancel", (int(rng.choice(waiting)),)
        elif op == "preempt" and running:
            yield "preempt", (int(rng.choice(running)),)
        elif op == "rollback" and running:
            yield "rollback", (int(rng.choice(running)), int(rng.integers(0, 4)))
        elif op == "trim" and running:
            yield "trim", (int(rng.choice(running)), int(rng.integers(0, 4)), int(rng.integers(0, 2)))
        elif op == "update_shared" and waiting and pinned:
            yield "update_shared", (int(rng.choice(waiting)), [int(rng.choice(pinned))])
        elif op == "ref" and pinned:
            yield "ref_page", (int(rng.choice(pinned)),)
        elif op == "unref" and pinned:
            yield "unref_page", (int(rng.choice(pinned)),)
        elif op == "bad":  # out-of-range ids: every side raises the same error
            yield str(rng.choice(["append_token", "release", "cancel", "page_ref"])), (10_000,)


@pytest.mark.parametrize("lazy", [False, True], ids=["reserve", "lazy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_decisions_match_jax(lazy, seed):
    num_pages, page_size, slots = 24, 4, 3
    sides = [thost.Scheduler(num_pages, page_size, slots, lazy=lazy),
             thost.Scheduler(num_pages, page_size, slots, lazy=lazy, native=False),
             jhost.Scheduler(num_pages, page_size, slots, lazy=lazy)]
    rng = np.random.default_rng(seed)
    n_rids, errors, admitted = 0, 0, 0
    for name, args in _random_ops(rng, sides[2], 400, num_pages, page_size):
        results = [_call(s, name, *args) for s in sides]
        assert results[0] == results[1] == results[2], (name, args, results)
        if name == "add" and results[0][0] == "ok":
            n_rids += 1
        errors += results[0][0] == "error"
        if name == "step":
            admitted += len(results[0][1]["admitted"])
        snaps = [_snapshot(s, range(n_rids)) for s in sides]
        assert snaps[0] == snaps[1] == snaps[2], (name, args)
    assert n_rids > 20 and admitted > 10 and errors > 5


def test_scheduler_preempt_resume_and_trim_match_jax():
    """A scripted lazy sequence: exhaustion (-1), preemption to the queue's
    front, re-admission at the stored length; trim's holes and release."""
    sides = [thost.Scheduler(6, 2, 2, lazy=True), thost.Scheduler(6, 2, 2, lazy=True, native=False),
             jhost.Scheduler(6, 2, 2, lazy=True)]
    script = [("add", (4, 8)), ("add", (4, 8)), ("step", ()), ("append_token", (0,)), ("append_token", (1,)),
              ("append_token", (0,)), ("append_token", (1,)), ("append_token", (0,)), ("append_token", (0,)),
              ("preempt", (1,)), ("append_token", (0,)), ("step", ()), ("trim", (0, 2, 0)), ("step", ()),
              ("info", (1,)), ("release", (0,)), ("step", ()), ("page_table", (1,)), ("stats", ())]
    for name, args in script:
        results = [_call(s, name, *args) for s in sides]
        assert results[0] == results[1] == results[2], (name, results)


@pytest.mark.parametrize("native", [True, False], ids=["native", "plain"])
def test_pack_and_quant_match_jax(native):
    rng = np.random.default_rng(3)
    codes = rng.integers(-7, 8, (33, 64)).astype(np.int8)
    packed = thost.pack_int4(codes, native=native)
    np.testing.assert_array_equal(packed, jhost.pack_int4(codes))
    np.testing.assert_array_equal(thost.unpack_int4(packed, native=native), codes)
    np.testing.assert_array_equal(thost.unpack_int4(packed, native=native), jhost.unpack_int4(packed))
    x = (rng.standard_normal((40, 128)) * 3).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 0.0]  # ties once scaled: rows of small values
    c, s = thost.quant_int8_per_token(x, native=native)
    jc, js = jhost.quant_int8_per_token(x)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(s.view(np.int32), js.view(np.int32))


def test_page_allocator_native_equals_plain():
    sides = [thost.PageAllocator(8), thost.PageAllocator(8, native=False)]
    script = [("new_seq", ()), ("new_seq", ()), ("append_page", (0,)), ("append_page", (1,)), ("append_page", (0,)),
              ("seq_pages", (0,)), ("free_seq", (0,)), ("stats", ()), ("new_seq", ()), ("append_page", (0,))]
    for name, args in script:
        assert _call(sides[0], name, *args) == _call(sides[1], name, *args), name
    for _ in range(7):  # 6 pages left: the 7th append finds none
        results = [_call(s, "append_page", 1) for s in sides]
        assert results[0] == results[1]
    assert results[0] == ("error", "MemoryError")


def test_extension_builds_from_the_port_source():
    """The extension is the port's own build (its source under the port's
    csrc/, its output in the gitignored build directory), loaded under the
    port's module name; the command is the host compiler's, no CUDA."""
    ext = thost.extension()
    assert ext.__name__ == thost.MODULE and ext.__name__.endswith("._lowbit_host")
    assert os.path.dirname(ext.__file__) == thost.BUILD_DIR
    assert thost.SOURCE.endswith(os.path.join("lowbit_quant_fa2_paddle_tpu_torch", "csrc", "lowbit_host.cpp"))
    cmd = thost.build_command("out.so")
    assert cmd[:5] == ["g++", "-O3", "-std=c++17", "-fPIC", "-shared"] and cmd[-3:] == [thost.SOURCE, "-o", "out.so"]
    assert jhost._native is None or ext is not jhost._native
