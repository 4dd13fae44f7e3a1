"""Where f32 split2m solves on the tolerance's edge leave their plain
iteration, on a card (ROADMAP queue C, item C8).

    python -m mf_data_locality_tpu_torch.utils.edge_reading

Two points, each solved twice on the card from the same right-hand side
and zero start: once through the kernels and once through their plain
versions (the same arithmetic in torch, another summation order):

* the fused solver's auto path under split2m at p=3 s=9 (dense + the
  streamed metric, B2 on ``csrc/apply_mma.cuh``);
* the merged solver under split2m at p=5 s=6 (reshape, B3 on
  ``csrc/apply_mma_hd.cuh``).

For each it prints both itCG, the first iteration where the two residual
histories differ by more than 1e-6 relative, and a stepped reading: from
each iteration of the kernel's solve, one kernel step and one plain step on
the same state, and the largest relative difference of their new
residual estimates up to that point.  Then, for the fused point, the plain
iteration with its assemble summed in the reverse cell order (the kernel's
assemble pass sums a node's <= 8 contributions in one fixed order, the
plain version in another) and its itCG.  The Jacobian's arithmetic (ROADMAP
C3) does not enter: both points stream the host's f64 metric.
"""

from __future__ import annotations

import torch

from mf_data_locality_tpu_torch import benchmark
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.solvers import cg_fused, cg_merged
from mf_data_locality_tpu_torch.utils import timing

TOL = 1e-6


def first_split(ha, hb) -> int | None:
    """The first iteration where two residual histories differ by more
    than TOL relative (None: never, over the common iterations)."""
    for i, (a, b) in enumerate(zip(ha, hb)):
        if abs(a - b) > TOL * abs(b):
            return i
    return None


def _assemble_reversed(op, v):
    """``cg_fused_kernel._assemble`` with the cell contributions summed in
    the reverse local-node order."""
    p = op.degree
    p1 = p + 1
    ncz, ncy, ncx = op.n_cells_axis
    v = v.reshape(v.shape[0], ncz, ncy, ncx, p1, p1, p1)
    out = torch.zeros((v.shape[0],) + op.n_nodes_axis, dtype=v.dtype,
                      device=v.device)
    for kz in reversed(range(p1)):
        for ky in reversed(range(p1)):
            for kx in reversed(range(p1)):
                out[:, kz:kz + p * ncz:p, ky:ky + p * ncy:p,
                    kx:kx + p * ncx:p] += v[..., kz, ky, kx]
    return out


def _plain_iteration_reversed(op, x, g, d, h, scal, prec):
    orig = fk._assemble
    fk._assemble = _assemble_reversed
    try:
        return fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
    finally:
        fk._assemble = orig


def fused_point(dev, p: int = 3, s: int = 9) -> None:
    config = benchmark.resolve_config(p, "fused", "pieces", "split2m",
                                      torch.float32)
    pb = bp4.build(s, p, torch.float32, "split2m", windowing="pieces",
                   device=dev, **dict(zip(("factor", "metric", "cofactor"),
                                          config)))
    op, lat = pb.op, pb.layout.n_nodes_axis
    b, prec = pb.b.reshape((3,) + lat), pb.inv_diag.reshape((1,) + lat)
    runs = {name: cg_fused.fused_merged_cg_solve(op, lat, b, prec,
                                                 iteration=it)
            for name, it in (("kernel", None),
                             ("plain", fk._fused_iteration_plain),
                             ("plain, assemble reversed",
                              _plain_iteration_reversed))}
    hist = {k: r.res_history.cpu().double().numpy()[:r.n_iterations + 1]
            for k, r in runs.items()}
    for k, r in runs.items():
        print(f"fused split2m p={p} s={s} {config}, {k}: itCG "
              f"{r.n_iterations}, converged {r.converged}, final "
              f"{hist[k][-1] / hist[k][0]:.4e} res0")
    print(f"  first iteration the kernel's and the plain history differ by "
          f"> {TOL:.0e}: {first_split(hist['kernel'], hist['plain'])}; "
          f"plain vs plain with the assemble reversed: "
          f"{first_split(hist['plain'], hist['plain, assemble reversed'])}")
    # stepped: one kernel and one plain step from each kernel state
    P = prec[:1].contiguous()
    g0 = (-(b * op.mask)).contiguous()
    scal = torch.zeros((8,), dtype=op.dtype, device=dev)
    scal[4] = 1.0
    state = (torch.zeros_like(g0), g0, torch.zeros_like(g0),
             torch.zeros_like(g0), scal)
    worst, first, res0 = 0.0, None, g0.norm().item()
    for i in range(runs["kernel"].n_iterations):
        nk = fk.fused_cg_iteration(op, *state, P)
        npl = fk._fused_iteration_plain(op, *state, P)
        rk, rp = nk[4][5].item(), npl[4][5].item()
        d = abs(rk - rp) / abs(rp)
        worst = max(worst, d)
        if first is None and d > TOL:
            first = i + 1
        if i % 10 == 9 or i + 1 == runs["kernel"].n_iterations:
            print(f"  stepped to iteration {i + 1}: residual "
                  f"{max(rk, 0.0) ** 0.5 / res0:.4e} res0, one step's res2 "
                  f"kernel vs plain max rel diff {worst:.3e}")
        state = nk
    print(f"  stepped: first step whose res2 differs by > {TOL:.0e}: {first}")


def merged_point(dev, p: int = 5, s: int = 6) -> None:
    pb = bp4.build(s, p, torch.float32, "split2m", device=dev)
    op = pb.op
    lat = (3,) + op.n_nodes_axis

    def plain_apply(u):  # vmult without the constrained identity, plain
        u_loc = la.to_cell_batches(u.reshape(lat) * op.mask, p).contiguous()
        v = la._batched_plain(op, u_loc, la._metric(op), True)
        return (la.from_cell_batches(v, p, op.n_cells_axis)
                * op.mask).reshape(u.shape)

    runs = {"kernel": bp4.solve_merged(pb),
            "plain": cg_merged.merged_cg_solve(plain_apply, pb.b,
                                               pb.inv_diag)}
    hist = {k: r.res_history.cpu().double().numpy()[:r.n_iterations + 1]
            for k, r in runs.items()}
    for k, r in runs.items():
        print(f"merged split2m p={p} s={s} (reshape, {op.factor}, "
              f"{op.metric}), {k}: itCG {r.n_iterations}, converged "
              f"{r.converged}, final {hist[k][-1] / hist[k][0]:.4e} res0")
    print(f"  first iteration the kernel's and the plain history differ by "
          f"> {TOL:.0e}: {first_split(hist['kernel'], hist['plain'])}")
    # stepped: the operator on the kernel solve's search directions is what
    # one merged step depends on; B3 vs its plain version on random input
    (u,) = [torch.randn(lat, generator=torch.Generator(device=dev)
                        .manual_seed(3), device=dev) * op.mask]
    ka = pb.a_apply(u.reshape(3, -1)).reshape(lat)
    pa = plain_apply(u.reshape(3, -1)).reshape(lat)
    print(f"  one apply, kernel vs plain: max rel diff "
          f"{((ka - pa).abs().max() / pa.abs().max()).item():.3e}")


def main() -> None:
    dev = timing.require_cuda("cuda")
    fused_point(dev)
    merged_point(dev)


if __name__ == "__main__":
    main()
