"""Device timing on a CUDA card: CUDA events, minimum over repeats.

A number from here is a measurement of the card it ran on; every helper
raises when the device is not a CUDA device, so no CPU time can be
reported under a device metric's name.
"""

from __future__ import annotations

from typing import Callable

import torch


def require_cuda(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"device timing needs a CUDA device, got {device}")
    return device


def time_per_call(fn: Callable[[], object], device: torch.device | str,
                  inner: int = 1, repeats: int = 3, warmup: int = 1) -> float:
    """Seconds per call of ``fn``: the minimum over ``repeats`` of the CUDA
    event time of ``inner`` back-to-back calls, divided by ``inner``."""
    device = require_cuda(device)
    with torch.cuda.device(device):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize(device)
        best = float("inf")
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / 1e3 / inner)
    return best


def measure_hbm_bandwidth(device: torch.device | str = "cuda",
                          nbytes: int = 1 << 28) -> float:
    """Triad bandwidth (bytes/s) of device memory: c = a + 0.5 b over three
    f32 arrays of ``nbytes`` each (256 MiB, far beyond the 50 MB L2)."""
    device = require_cuda(device)
    n = nbytes // 4
    a = torch.ones(n, dtype=torch.float32, device=device)
    b = torch.full((n,), 2.0, dtype=torch.float32, device=device)
    c = torch.empty_like(a)
    t = time_per_call(lambda: torch.add(a, b, alpha=0.5, out=c), device,
                      inner=20, repeats=3)
    return 3 * n * 4 / t
