"""The distributed dry run on N ranks: ``dryrun_multichip``'s legs 1-3.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``
(``__graft_entry__.py:39-140``) for the port's z-slab paths: each leg
builds the BP4 problem of the rank count's ladder point (p=2, s = 3
max(ceil(log2 N), 1), f32), runs 5 iterations to a relative tolerance of
1e-3 on N rank processes (:mod:`.comm`) and checks that the solve did
iterate and its residual is finite.  Run as::

    python -m mf_data_locality_tpu_torch.parallel.dryrun N [--device cpu]

Legs (the JAX function's order):

1. the merged CG over z-slabs on the structured backend;
2. the fused CG over z-slabs (B2's slab form), the metric streamed;
3. the same with the metric rebuilt in the kernel (``onthefly``);
4. to 8. the general backend's rank-set halos, the 2D mesh (merged and
   fused), the 2-level mesh and the 3D mesh: not ported yet, they raise
   NotImplementedError (ROADMAP.md queue A item 9b).
"""

from __future__ import annotations

import argparse
import math

import torch

from mf_data_locality_tpu_torch.parallel import comm, distributed

LEGS = {1: "merged z-slab (structured)", 2: "fused z-slab",
        3: "fused z-slab (onthefly geometry)", 4: "general backend",
        5: "2D mesh", 6: "fused 2D mesh", 7: "fused 2-level mesh",
        8: "fused 3D mesh"}
PORTED = (1, 2, 3)


def jobs(n_ranks: int, legs=PORTED) -> list[distributed.Job]:
    """The legs' jobs at the ladder point of ``n_ranks``."""
    for leg in legs:
        if leg not in PORTED:
            raise NotImplementedError(
                f"dryrun leg {leg} ({LEGS[leg]}) is not ported yet: see "
                f"ROADMAP.md, queue A item 9b")
    s = 3 * max(math.ceil(math.log2(n_ranks)), 1)
    job = {1: distributed.Job("merged", s, 2, torch.float32,
                              backend="structured", max_iter=5,
                              rel_tol=1e-3),
           2: distributed.Job("fused", s, 2, torch.float32, max_iter=5,
                              rel_tol=1e-3),
           3: distributed.Job("fused", s, 2, torch.float32,
                              metric="onthefly", max_iter=5, rel_tol=1e-3)}
    return [job[leg] for leg in legs]


def dryrun_multichip(n_ranks: int, device: str = "cuda",
                     legs=PORTED) -> list[dict]:
    """Run ``legs`` on ``n_ranks`` ranks (one spawn for all of them); each
    prints its line and raises unless it iterated to a finite residual.
    Returns the legs' results (``distributed.launch``)."""
    out = distributed.launch(jobs(n_ranks, legs), n_ranks, device)
    print(f"dryrun_multichip({n_ranks}): "
          f"{comm.describe(n_ranks, device)}")
    for leg, r in zip(legs, out):
        if not (r["it"] >= 1 and math.isfinite(r["res"])):
            raise AssertionError(f"dryrun leg {leg} ({LEGS[leg]}): itCG "
                                 f"{r['it']}, residual {r['res']}")
        print(f"dryrun_multichip {LEGS[leg]}: {r['ranks'][0]['n_dofs']} "
              f"DoFs, {r['it']} iterations, residual {r['res']:.3e} — OK")
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_ranks", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_ranks, args.device)


if __name__ == "__main__":
    main()
