"""The kernel library's build, source by source, on the machine with the card.

    python3 script/torch_build_times.py

Builds the library as ops/_build does (one nvcc a source, all started
together, then one link, into csrc/build/ where _build.library() finds it)
and prints, for each source, when its nvcc finished and the CPU seconds it
took (user + system of the child), then the sum over sources and the total.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from lowbit_quant_fa2_paddle_tpu_torch.ops import _build  # noqa: E402


def main():
    path = _build.library_path()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    compiles, link = _build.nvcc_commands(tmp, _build._nvcc())
    t0 = time.time()
    procs = {}
    for cmd in compiles:
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[p.pid] = (p, os.path.basename(cmd[cmd.index("-c") + 1]))
    outs, stats = {}, {}
    readers = [threading.Thread(target=lambda p=p, n=n: outs.__setitem__(n, p.stdout.read()))
               for p, n in procs.values()]
    for t in readers:
        t.start()
    left = set(procs)
    while left:
        pid, status, usage = os.wait4(-1, 0)
        if pid in left:
            left.discard(pid)
            stats[procs[pid][1]] = (time.time() - t0, usage.ru_utime + usage.ru_stime, status)
    for t in readers:
        t.join()
    for name, (wall, cpu, status) in sorted(stats.items(), key=lambda x: -x[1][1]):
        print(f"[build] {name}: done at {wall:.1f} s, {cpu:.1f} CPU s, status {status}")
    print(f"[build] all compiles {time.time() - t0:.1f} s; CPU sum {sum(s[1] for s in stats.values()):.1f} s")
    with open(path + ".log", "w") as f:
        f.write("".join(outs.values()))
    failed = [name for name, s in stats.items() if s[2] != 0]
    if failed:
        for name in failed:
            print(f"nvcc failed on {name}:\n{outs[name][-6000:]}")
        raise SystemExit(1)
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"link failed:\n{proc.stderr[-4000:]}")
    for cmd in compiles:
        os.remove(cmd[-1])
    os.replace(tmp, path)
    print(f"[build] total with the link {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
