"""Where a solve's time goes on the card: device time per kernel and the
device's idle share, from ``torch.profiler``.

    python -m mf_data_locality_tpu_torch.utils.profiling [degree] [s] \
        [--solver merged|baseline|fused] [--windowing reshape|pieces|zslab] \
        [--geometry auto|qpoint|onthefly] [--dtype f32|f64] \
        [--precision highest|split2m]

profiles one solve (after a warm-up solve) of the configuration the
benchmark CLI resolves for the same flags (defaults: merged CG, reshape,
highest) and prints one line per kernel name (calls, total device time,
time per call) and the wall time, the summed kernel time and the idle
share 1 - kernels / wall.
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
    from mf_data_locality_tpu_torch import benchmark
    from mf_data_locality_tpu_torch.models import bp4

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("degree", type=int, nargs="?", default=4)
    ap.add_argument("s", type=int, nargs="?", default=13)
    ap.add_argument("--solver", choices=["merged", "baseline", "fused"],
                    default="merged")
    ap.add_argument("--windowing", choices=["reshape", "pieces", "zslab"],
                    default="reshape")
    ap.add_argument("--geometry", choices=["auto", "qpoint", "onthefly"],
                    default="auto")
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--precision", choices=["highest", "split2m"],
                    default="highest")
    args = ap.parse_args(argv)
    device = require_cuda("cuda")
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    factor, metric, cofactor = benchmark.resolve_config(
        args.degree, args.solver, args.windowing, args.precision, dtype,
        metric={"auto": "auto", "qpoint": "precomputed",
                "onthefly": "onthefly"}[args.geometry])
    pb = bp4.build(args.s, args.degree, dtype, args.precision, factor=factor,
                   metric=metric, cofactor=cofactor, device=device,
                   windowing=args.windowing)
    solve = benchmark.solver_call(pb, args.solver)

    n_it = solve().n_iterations  # warm-up
    rows, wall = kernel_breakdown(solve, device)
    busy = sum(r[2] for r in rows)
    print(f"p={args.degree} s={args.s} {args.solver} {args.windowing} "
          f"{factor}/{metric} {args.dtype} {args.precision}: "
          f"{n_it} iterations")
    for name, calls, sec in rows:
        print(f"  {sec * 1e3:10.3f} ms  {calls:5d} calls  "
              f"{sec / calls * 1e6:9.2f} us/call  {name[:90]}")
    print(f"wall {wall * 1e3:.3f} ms, kernels {busy * 1e3:.3f} ms, "
          f"idle share {1 - busy / wall:.4f}, wall/it {wall / n_it * 1e6:.2f} "
          f"us")


if __name__ == "__main__":
    main()
