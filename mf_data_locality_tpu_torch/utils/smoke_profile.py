"""Where ``chip_smoke.py``'s time goes, on the card.

    python -m mf_data_locality_tpu_torch.utils.smoke_profile [--out DIR]
    python -m mf_data_locality_tpu_torch.utils.smoke_profile --nvcc \\
        SOURCE [-DNAME=VALUE ...]
    python -m mf_data_locality_tpu_torch.utils.smoke_profile \\
        --build-log LOG [--cores 8]

The first runs ``chip_smoke.main()`` (from the repository's root) under a
stack sampler: every 20 ms it reads the main thread's stack and counts
the sample against the smoke's own frames (one to three deep), against
the innermost frame of this package, and against the pair of the smoke's
outermost line and that frame.  The seconds of each, down to 0.8 s, go
to ``DIR/smoke_profile.txt`` (DIR by default the working directory).  The
kernels are built first unless ``_kernel_build/`` holds them, and the
build then counts under the smoke's build line.

The second compiles one ``csrc`` source (with the given ``-D`` flags) at
the build's flags (``ops/_build.NVCC_FLAGS``) and again with the host
level ``-O3`` in their place, both at once, under ``nvcc --time``: each
phase's milliseconds and each compile's CPU seconds.

The third reads a build's log (``_kernel_build/libbp4_*.log``: each
compile's ``nvcc: SOURCE FLAGS T s`` end time, all started together, and
ptxas's per-kernel lines) and, taking the ``--cores`` as shared evenly
among the compiles still running, gives each compile's CPU seconds, the
share of ptxas's (the end of each compile's life), each source's sum, and
the kernels compiled in more than one object.  No card is needed.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import csv
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DT = 0.02  # the sampler's period, seconds


def profile_smoke(out_dir: Path) -> int:
    """``chip_smoke.main()`` under the sampler; its exit code."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    smoke, inner, pair = (collections.Counter() for _ in range(3))
    main_id = threading.main_thread().ident
    stop = threading.Event()

    def sample():
        while not stop.wait(DT):
            frame = sys._current_frames().get(main_id)
            stack, pkg = [], None
            while frame is not None:
                code = frame.f_code
                if code.co_filename.endswith("chip_smoke.py"):
                    stack.append(f"{code.co_name}:{frame.f_lineno}")
                elif pkg is None and "mf_data_locality_tpu_torch" in \
                        code.co_filename:
                    name = code.co_filename.split(
                        "mf_data_locality_tpu_torch/")[-1]
                    pkg = f"{name}:{code.co_name}"
                frame = frame.f_back
            stack.reverse()
            for k in range(1, min(len(stack), 3) + 1):
                smoke[" > ".join(stack[:k])] += 1
            if stack and pkg:
                inner[pkg] += 1
                pair[f"{stack[0]} | {pkg}"] += 1

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    t0, rc = time.perf_counter(), 1
    try:
        rc = chip_smoke.main()
    finally:
        stop.set()
        thread.join()
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "smoke_profile.txt", "w") as f:
            print(f"chip_smoke.main(): {time.perf_counter() - t0:.1f} s, "
                  f"rc {rc}", file=f)
            for title, counts in (("the smoke's frames", smoke),
                                  ("the innermost package frame", inner),
                                  ("the smoke's line | package frame",
                                   pair)):
                print(f"== {title}", file=f)
                for key, n in counts.most_common():
                    if n * DT < 0.8:
                        break
                    print(f"{n * DT:8.1f} s  {key}", file=f)
    return rc


def compile_times(source: str, defines: list[str]) -> None:
    """``source`` at the build's host level and at -O3, at once."""
    from mf_data_locality_tpu_torch.ops import _build

    nvcc, src = _build.nvcc_path(), _build.CSRC / source
    flags = [f for f in _build.NVCC_FLAGS if not f.startswith("-O")]
    level = next(f for f in _build.NVCC_FLAGS if f.startswith("-O"))
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        procs = {}
        for opt in dict.fromkeys((level, "-O3")):
            obj = Path(tmp) / f"{opt}.o"
            p = subprocess.Popen(
                [nvcc, *flags, opt, *defines, "--time", f"{obj}.csv", "-c",
                 str(src), "-o", str(obj)], stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
            procs[p.pid] = opt
        t0 = time.perf_counter()
        while procs:
            pid, status, usage = os.wait4(-1, 0)
            if pid not in procs:
                continue
            opt = procs.pop(pid)
            print(f"{source} {' '.join(defines)} host {opt}: exit {status}, "
                  f"{time.perf_counter() - t0:.1f} s, "
                  f"{usage.ru_utime + usage.ru_stime:.1f} CPU s")
            with open(Path(tmp) / f"{opt}.o.csv") as f:
                for row in list(csv.reader(f))[1:]:
                    print(f"  {row[1].strip():24s} {float(row[6]):10.1f} ms")


def build_log_costs(log: Path, cores: int = 8) -> None:
    """Print the CPU accounting of a build log (module docstring)."""
    compiles, kernels, name = [], [], None
    for line in log.read_text().splitlines():
        if m := re.match(r"ptxas info\s+: Compiling entry function '(\S+)'",
                         line):
            name = m.group(1)
        elif m := re.match(r"ptxas info\s+: Compile time = ([\d.]+) ms",
                           line):
            kernels.append((name, float(m.group(1)) / 1e3))
        elif m := re.match(r"nvcc: (.*) ([\d.]+) s$", line):
            compiles.append((m.group(1), float(m.group(2)), kernels))
            kernels = []
    ends = sorted(end for _, end, _ in compiles)

    def cpu(t0: float, t1: float, dt: float = 0.05) -> float:
        # seconds of one core a compile had over [t0, t1]
        total, t = 0.0, t0
        while t < t1:
            running = len(ends) - bisect.bisect_right(ends, t)
            total += min(1.0, cores / max(running, 1)) * min(dt, t1 - t)
            t += dt
        return total

    by_source = collections.defaultdict(lambda: [0.0, 0.0, 0])
    seen = collections.defaultdict(list)
    for label, end, ks in compiles:
        ptxas = sum(t for _, t in ks)
        row = by_source[label.split()[0]]
        row[0] += cpu(0.0, end)
        row[1] += cpu(max(0.0, end - ptxas), end)
        row[2] += 1
        for k, t in ks:
            seen[k].append((label, t))
    total = sum(r[0] for r in by_source.values())
    ptxas = sum(r[1] for r in by_source.values())
    print(f"{len(compiles)} compiles, the last ending at {ends[-1]:.1f} s: "
          f"{total:.0f} CPU s on {cores} cores ({total / cores:.1f} s), "
          f"ptxas {ptxas:.0f} CPU s")
    for src, (c, p, n) in sorted(by_source.items(), key=lambda x: -x[1][0]):
        print(f"  {src:24s} {c:8.1f} CPU s, ptxas {p:7.1f}, {n} objects")
    again = {k: v for k, v in seen.items() if len(v) > 1}
    extra = sum(t for v in again.values() for _, t in v[1:])
    whole = sum(t for v in seen.values() for _, t in v)
    print(f"{len(seen)} kernels, {len(again)} compiled in more than one "
          f"object ({sum(len(v) - 1 for v in again.values())} compiles "
          f"again, {extra / whole:.1%} of ptxas's seconds)")
    pairs = collections.Counter()
    for v in again.values():
        pairs[tuple(sorted({re.sub(r"=\d+", "=n", o) for o, _ in v}))] += (
            len(v) - 1)
    for objs, n in pairs.most_common(6):
        print(f"  {n:4d}  {' / '.join(objs)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=Path("."))
    ap.add_argument("--nvcc", metavar="SOURCE")
    ap.add_argument("--build-log", type=Path, metavar="LOG")
    ap.add_argument("--cores", type=int, default=8)
    args, defines = ap.parse_known_args(argv)
    if args.build_log:
        build_log_costs(args.build_log, args.cores)
        return 0
    if args.nvcc:
        compile_times(args.nvcc, defines)
        return 0
    return profile_smoke(args.out)


if __name__ == "__main__":
    sys.exit(main())
