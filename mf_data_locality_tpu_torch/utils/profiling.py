"""Where a solve's time goes on the card: device time per kernel and the
device's idle share, from ``torch.profiler``.

    python -m mf_data_locality_tpu_torch.utils.profiling [degree] [s] \
        [--dtype f32|f64] [--precision split2m|highest]

profiles one fused merged-CG solve (after a warm-up solve) and prints one
line per kernel name (calls, total device time, time per call) and the
wall time, the summed kernel time and the idle share 1 - kernels / wall.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile

from mf_data_locality_tpu_torch.utils.timing import require_cuda


def kernel_breakdown(fn: Callable[[], object], device: torch.device | str):
    """Run ``fn`` once under the profiler.

    Returns (rows, wall_s): rows of (kernel name, calls, device seconds),
    largest first, and the host wall time of the call, synchronised.
    """
    device = require_cuda(device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, ev.count, dev_us / 1e6))
    rows.sort(key=lambda r: -r[2])
    return rows, wall


def main(argv: list[str] | None = None) -> None:
    from mf_data_locality_tpu_torch.models import bp4
    from mf_data_locality_tpu_torch.solvers import cg_fused

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("degree", type=int, nargs="?", default=4)
    ap.add_argument("s", type=int, nargs="?", default=13)
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--precision", choices=["split2m", "highest"],
                    default="split2m")
    args = ap.parse_args(argv)
    device = require_cuda("cuda")
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    pb = bp4.build(args.s, args.degree, dtype, args.precision, device=device)
    lat = pb.layout.n_nodes_axis

    def solve():
        return cg_fused.fused_merged_cg_solve(
            pb.op, lat, pb.b.reshape((3,) + lat),
            pb.inv_diag.reshape((1,) + lat))

    n_it = solve().n_iterations  # warm-up
    rows, wall = kernel_breakdown(solve, device)
    busy = sum(r[2] for r in rows)
    print(f"p={args.degree} s={args.s} {args.dtype} {args.precision}: "
          f"{n_it} iterations")
    for name, calls, sec in rows:
        print(f"  {sec * 1e3:10.3f} ms  {calls:5d} calls  "
              f"{sec / calls * 1e6:9.2f} us/call  {name[:90]}")
    print(f"wall {wall * 1e3:.3f} ms, kernels {busy * 1e3:.3f} ms, "
          f"idle share {1 - busy / wall:.4f}, wall/it {wall / n_it * 1e6:.2f} "
          f"us")


if __name__ == "__main__":
    main()
