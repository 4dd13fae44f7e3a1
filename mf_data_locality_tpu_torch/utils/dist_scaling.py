"""Where a distributed iteration's time goes, on a card.

    python -m mf_data_locality_tpu_torch.utils.dist_scaling [p s] [N ...]

Runs the distributed fused solver (split2m, dense, the metric streamed:
the production command with ``--devices N``) at (p, s) (default p=4
s=15) on each rank count N (default 1 2 4), every rank a process on this
card joined by gloo (``parallel/comm.py``), and prints for each: time/it
(the slowest rank's CUDA-event time), and of the first solve the host
milliseconds an iteration that the slowest rank spends in the
collectives (``Comm.seconds``: the planes' copies to the host, which wait
for the device's work before them; the messages, which wait for the
neighbours; the copies back; the all-reduce, which waits for every
rank), beside the single-device fused solve on the same operator.  One
rank has no neighbour, so its iteration is the kernel's and the all-reduce
with itself: the difference to N ranks is what the N processes' turns on
the one card and their exchanges cost.  Exits 1 without a card.
"""

from __future__ import annotations

import sys

import torch

from mf_data_locality_tpu_torch import benchmark
from mf_data_locality_tpu_torch.parallel import comm, distributed


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("dist_scaling: no CUDA device", file=sys.stderr)
        return 1
    nums = [int(a) for a in argv]
    p, s = nums[:2] if len(nums) >= 2 else (4, 15)
    ranks = nums[2:] or [1, 2, 4]
    print(comm.describe(max(ranks), "cuda"), f"p={p} s={s}")
    r1 = benchmark.run_one(p, s, solver="fused", windowing="pieces",
                           precision="split2m", factor="dense",
                           metric="precomputed", solve_repeats=2)
    print(f"one device: {r1.row()}")
    job = distributed.Job("fused", s, p, torch.float32, "pallas", "split2m",
                          timed=True, solve_repeats=2)
    for n in ranks:
        r = distributed.launch([job], n, "cuda")[0]
        it = r["it"]
        ms = {k: max(x["comm_s"][k] for x in r["ranks"]) / it * 1e3
              for k in r["comm_s"]}
        wall = max(x["wall_s"] for x in r["ranks"]) / it * 1e3
        print(f"{n} rank(s): {benchmark.dist_row(job, r).row()}")
        print(f"  host ms an iteration (the slowest rank, first solve): "
              f"wall {wall:.3f}; " + ", ".join(f"{k} {v:.3f}"
                                               for k, v in ms.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
