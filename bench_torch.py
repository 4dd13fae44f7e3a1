#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: BP4 merged-CG throughput on
one NVIDIA GPU (the port's counterpart of ``bench.py``).

    python3 bench_torch.py

Prints ONE JSON line ``{"metric", "value", "unit", "vs_baseline"}`` with
``bench.py``'s metric name.  Metric: DoFs/s per CG iteration of the fused
merged-CG solver (the CEED throughput metric, ``benchmark.h:222``) at p=4,
2^13 cells (1,635,075 DoFs), f32 ``split2m``, the geometry and
factorization as the auto-dispatch resolves them.  ``vs_baseline``: the
fraction of the 9-word roofline, DoF/s/it / (triad bandwidth / 36 B): the
reference merged solver's ideal traffic of ~9 f32 words per DoF per
iteration against the bandwidth measured on the same card.

On stderr: the card's name and power limit (``nvidia-smi``), n_dofs, itCG,
time/it, time/matvec, the bandwidth and whether the solve converged.
``bench.py``'s split3 and bf16 variant lines are not ported yet (ROADMAP.md
queue B item 6d); its TPU-only lines (the latency recheck, the one-chain
protocol, the piece layout's streamed-bytes model) have no counterpart.
Without a CUDA device it prints nothing on stdout and exits 1.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

DEGREE, S = 4, 13
IDEAL_BYTES_PER_DOF_PER_IT = 9 * 4  # x, g, d, h sweeps + diag + geometry


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device available", file=sys.stderr)
        return 1
    from mf_data_locality_tpu_torch import benchmark
    from mf_data_locality_tpu_torch.utils import timing

    dev = torch.device("cuda")
    print(f"# {card()}", file=sys.stderr)
    bw = timing.measure_hbm_bandwidth(dev)
    r = benchmark.run_one(DEGREE, S, solver="fused", dtype=torch.float32,
                          precision="split2m", windowing="pieces",
                          metric="auto", solve_repeats=2, matvec_repeats=2,
                          matvec_inner=20, device=dev)
    roofline = bw / IDEAL_BYTES_PER_DOF_PER_IT
    print(json.dumps({
        "metric": f"bp4_merged_cg_dofs_per_s_per_it_p{DEGREE}",
        "value": r.dofs_per_s_per_it,
        "unit": "DoF/s/iter",
        "vs_baseline": r.dofs_per_s_per_it / roofline,
    }))
    print(f"# n_dofs={r.n_dofs} itCG={r.n_iterations} "
          f"time/it={r.time_per_it:.6e}s time/matvec={r.time_per_matvec:.6e}s "
          f"measured_bw={bw / 1e9:.1f}GB/s roofline={roofline / 1e9:.3f}"
          f"GDoF/s/it converged={r.converged}", file=sys.stderr)
    for variant in ("split3", "bf16"):
        print(f"# {variant} variant: not ported (ROADMAP queue B item 6d)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
