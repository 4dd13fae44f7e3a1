"""The distributed dry run on N ranks: ``dryrun_multichip``'s legs 1-3
and 5-8.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``
(``__graft_entry__.py:39-219``): each leg builds the BP4 problem of the
rank count's ladder point (p=2, s = 3 max(ceil(log2 N), 1), f32), runs 5
iterations to a relative tolerance of 1e-3 on N rank processes
(:mod:`.comm`) and checks that the solve did iterate and its residual is
finite.  Run as::

    python -m mf_data_locality_tpu_torch.parallel.dryrun N [--device cpu]

Legs (the JAX function's order and gates):

1. the merged CG over z-slabs on the structured backend;
2. the fused CG over z-slabs (B2's block form on blocks of an (N,)
   mesh), the metric streamed;
3. the same with the metric rebuilt in the kernel (``onthefly``);
4. the general backend's rank-set halos: not ported yet, it raises
   NotImplementedError (ROADMAP.md queue A item 9b, with item 7);
5. the merged CG on an (N/2, 2) (z, y) mesh, structured backend (N even,
   N >= 4);
6. the fused CG on the same mesh (B2's block form; N even, N >= 4);
7. the fused CG over z-slabs of a 2-level (2, N/2) grid, slab k on slice
   k // (N/2) (N even, N >= 4);
8. the fused CG on an (N/4, 2, 2) (z, y, x) mesh at s = max(s, 6) (N a
   multiple of 8).
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
PORTED = (1, 2, 3, 5, 6, 7, 8)


def runs(n_ranks: int, leg: int) -> bool:
    """Whether ``leg`` runs on ``n_ranks`` ranks (``__graft_entry__.py:
    162, 186, 205``)."""
    if leg in (5, 6, 7):
        return n_ranks % 2 == 0 and n_ranks >= 4
    return leg != 8 or n_ranks % 8 == 0


def legs_for(n_ranks: int) -> tuple[int, ...]:
    """The ported legs that run on ``n_ranks`` ranks."""
    return tuple(leg for leg in PORTED if runs(n_ranks, leg))


def jobs(n_ranks: int, legs=None) -> list[distributed.Job]:
    """The legs' jobs at the ladder point of ``n_ranks`` (default: every
    ported leg that runs there, :func:`legs_for`)."""
    legs = legs_for(n_ranks) if legs is None else legs
    for leg in legs:
        if leg not in PORTED:
            raise NotImplementedError(
                f"dryrun leg {leg} ({LEGS[leg]}) is not ported yet: see "
                f"ROADMAP.md, queue A item 9b (dist_general, with item 7)")
        if not runs(n_ranks, leg):
            raise ValueError(f"dryrun leg {leg} ({LEGS[leg]}) does not run "
                             f"on {n_ranks} ranks")
    s = 3 * max(math.ceil(math.log2(n_ranks)), 1)
    short = dict(max_iter=5, rel_tol=1e-3)
    f32 = torch.float32
    Job = distributed.Job
    job = {1: Job("merged", s, 2, f32, backend="structured", **short),
           2: Job("fused", s, 2, f32, **short),
           3: Job("fused", s, 2, f32, metric="onthefly", **short),
           5: Job("merged", s, 2, f32, backend="structured",
                  mesh_shape=(n_ranks // 2, 2), **short),
           6: Job("fused", s, 2, f32, mesh_shape=(n_ranks // 2, 2), **short),
           7: Job("fused", s, 2, f32, mesh_shape=(2, n_ranks // 2),
                  two_level=True, **short),
           8: Job("fused", max(s, 6), 2, f32,
                  mesh_shape=(n_ranks // 4, 2, 2), **short)}
    return [job[leg] for leg in legs]


def dryrun_multichip(n_ranks: int, device: str = "cuda",
                     legs=None) -> list[dict]:
    """Run ``legs`` (default: every ported leg that runs on ``n_ranks``)
    on ``n_ranks`` ranks (one spawn for all of them); each prints its line
    and raises unless it iterated to a finite residual.  Returns the legs'
    results (``distributed.launch``)."""
    legs = legs_for(n_ranks) if legs is None else tuple(legs)
    out = distributed.launch(jobs(n_ranks, legs), n_ranks, device)
    print(f"dryrun_multichip({n_ranks}): "
          f"{comm.describe(n_ranks, device)}")
    report(n_ranks, legs, out)
    return out


def report(n_ranks: int, legs, out: list[dict]) -> None:
    """Print each leg's line of :func:`dryrun_multichip` from its result
    (``out``, ``distributed.launch``'s of :func:`jobs`, in the order of
    ``legs``) and raise unless it iterated to a finite residual."""
    for leg, job, r in zip(legs, jobs(n_ranks, legs), out):
        if not (r["it"] >= 1 and math.isfinite(r["res"])):
            raise AssertionError(f"dryrun leg {leg} ({LEGS[leg]}): itCG "
                                 f"{r['it']}, residual {r['res']}")
        mesh = "x".join(map(str, job.mesh(n_ranks)))
        print(f"dryrun_multichip {LEGS[leg]} ({mesh}): "
              f"{r['ranks'][0]['n_dofs']} DoFs, {r['it']} iterations, "
              f"residual {r['res']:.3e} — OK")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_ranks", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_ranks, args.device)


if __name__ == "__main__":
    main()
