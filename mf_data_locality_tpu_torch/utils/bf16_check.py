"""Readings of the bf16 rung's checks on a card.

    python -m mf_data_locality_tpu_torch.utils.bf16_check

On the 3 x 5 x 7 box and with the inputs of ``tests/test_torch_kernels.py``
(B1 and B2 under bf16 with an f32 state, and with the bf16 state and the
bf16 metric, in every configuration of ``laplace_cuda.fused_configs`` at
p=1..11; B3, B5 and B6 at p=1..4 with the metric in f32 or bf16), prints
each kernel's relative L2 and max error and B2's scalars' error against
its plain version, beside two controls that a check must refuse: the plain
version with split2m's product set in place of bf16's (:func:`control_op`),
and, with the bf16 state, the scalars from sums over the unrounded d' on
:func:`rounding_point`'s inputs.  The bf16 limits of ``chip_smoke.py`` and
of the card tests lie between the two kinds of readings.
"""

from __future__ import annotations

import dataclasses

import torch

from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.ops import laplace_cuda

BF = torch.bfloat16
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]


def control_op(op):
    """``op`` with split2m's product set in place of bf16's: what a kernel
    of the wrong rung computes (for the plain versions)."""
    return dataclasses.replace(op, precision="split2m")


def state(op, n: int, seed: int, n_comp: int = 3) -> list[torch.Tensor]:
    """``n`` random lattice vectors of ``op`` of ``n_comp`` components, zero
    on the boundary."""
    gen = torch.Generator(device=op.device).manual_seed(seed)
    return [(torch.randn((n_comp,) + op.n_nodes_axis, generator=gen,
                         device=op.device, dtype=op.dtype) * op.mask)
            .contiguous() for _ in range(n)]


def l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max()).item()


def scal_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max relative difference of two sets of B2's 8 scalars."""
    return ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()


def unrounded_scalars(op, x, g, d, h, scal, prec) -> torch.Tensor:
    """B2's scalars with a bf16 state from sums over the f32 d' before its
    store rounds it, against the TPU kernel's rounding point
    (``cg_fused_kernel.py:856``).  h' is the plain version's: the bf16 rung
    rounds the operator's input anyway.  On a block operator the block
    form's raw sums over its owned nodes."""
    _, g2, _, h2, _ = fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
    d2, h2 = scal[1] * d.float() - prec * g2, h2.float()
    if op.slab is not None:
        d2, h2, g2, prec = (t[fk.OWNED] for t in (d2, h2, g2, prec))
    ph, pg = prec * h2, prec * g2
    s = torch.stack([torch.sum(d2 * h2), torch.sum(h2 * h2),
                     torch.sum(g2 * h2), torch.sum(g2 * g2),
                     torch.sum(g2 * ph), torch.sum(h2 * ph),
                     torch.sum(g2 * pg), torch.zeros_like(scal[0])])
    if op.slab is not None:
        return s
    return fk.scalar_recurrence(s, scal[0], scal[1], scal[4])


def rounding_point(op, seed: int, n_comp: int = 3) -> tuple[float, float]:
    """B2 with a bf16 state on inputs that make the rounding point of d'
    (``cg_fused_kernel.py:856``) move the scalars at any size: alpha = beta
    = 0, so d' = -P g, and g = -(1 + 0.45 2^-9) r / P for bf16 values r, so
    that d' lies 0.11-0.23 ulp from r and its store rounds it back to r;
    sums over the unrounded d' make d.h, and so alpha', 8.8e-4 larger (and
    beta' and res2 more).  Returns the max rel err of the kernel's scalars
    (on a CPU ``op``, the plain version's) against the plain version's and
    against the unrounded-d' variant's (:func:`unrounded_scalars`), on
    vectors of ``n_comp`` components."""
    x, r, d, h = state(op, 4, seed, n_comp)
    prec = ((state(op, 1, 5)[0][:1].abs() + 0.5) * op.mask).contiguous()
    r = r.to(BF).float()
    g = (-(1 + 0.45 * 2.0 ** -9) * r / (prec + (prec == 0))).contiguous()
    d, h = d.to(BF), h.to(BF)
    scal = torch.tensor([0.0, 0.0, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6],
                        device=op.device)
    got = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)[4]
    return (scal_err(got, fk._fused_iteration_plain(op, x, g, d, h, scal,
                                                    prec)[4]),
            scal_err(got, unrounded_scalars(op, x, g, d, h, scal, prec)))


def fused_readings(op, p: int, store) -> str:
    """B1 and B2 on ``op`` with the card tests' inputs."""
    prec = ((state(op, 1, 6)[0][:1].abs() + 0.5) * op.mask).contiguous()
    (u,) = (v.to(store) for v in state(op, 1, 130 + p))
    got = fk.matvec(op, u)
    line = (f"B1 L2 {l2(got, fk._matvec_plain(op, u)):.2e} max "
            f"{rel(got, fk._matvec_plain(op, u)):.2e} control "
            f"{l2(got, fk._matvec_plain(control_op(op), u)):.2e}")
    x, g, d, h = state(op, 4, 140 + p)
    d, h = d.to(store), h.to(store)
    scal = torch.tensor(SCAL, device=op.device)
    k = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
    w = fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
    c = fk._fused_iteration_plain(control_op(op), x, g, d, h, scal, prec)
    line += (f" | B2 L2 {max(l2(a, b) for a, b in zip(k[:4], w[:4])):.2e}"
             f" max {max(rel(a, b) for a, b in zip(k[:4], w[:4])):.2e}"
             f" scal {scal_err(k[4], w[4]):.2e} control {l2(k[3], c[3]):.2e}")
    if store == BF:
        err, unrounded = rounding_point(op, 160 + p)
        line += (f" | rounding point: scal {err:.2e}, unrounded d' "
                 f"{unrounded:.2e}")
    return line


def apply_readings(op, p: int, kernel: str) -> str:
    """B3 (``batched_g``), B5 (``pieces``) or B6 (``zslab``) on ``op``
    with the card tests' input."""
    (u,) = state(op, 1, 150 + p)
    if kernel == "batched_g":
        x = la.to_cell_batches(u, p).contiguous()
        got = la.apply_local_batched_g(op, x)
        want, ctl = (la._batched_plain(o, x, la._metric(op), True)
                     for o in (op, control_op(op)))
    else:
        mask = la._index_mask(op) if kernel == "pieces" else op.mask
        got = (la.apply_lattice_pieces if kernel == "pieces"
               else la.apply_lattice_zslab)(op, u)
        want, ctl = (la._lattice_plain(o, u, mask)
                     for o in (op, control_op(op)))
    return (f"L2 {l2(got, want):.2e} max {rel(got, want):.2e} control "
            f"{l2(got, ctl):.2e}")


def main() -> None:
    dev = torch.device("cuda")
    for store, mdt in ((torch.float32, None), (BF, BF)):
        for p in range(1, 12):
            layout = DofLayout(BoxMesh((3, 5, 7), 0.25), p)
            for factor, metric in laplace_cuda.fused_configs("bf16", p):
                for cofactor in (("adjj", "jtj") if metric == "onthefly"
                                 else ("adjj",)):
                    op = laplace_cuda.make_operator(
                        layout, store, "bf16", factor=factor, metric=metric,
                        cofactor=cofactor, windowing="pieces", device=dev,
                        metric_dtype=mdt if metric == "precomputed" else None)
                    print(f"{str(store)[6:]} state p={p} {factor} {metric} "
                          f"{cofactor}: {fused_readings(op, p, store)}",
                          flush=True)
    for p in range(1, 5):
        layout = DofLayout(BoxMesh((3, 5, 7), 0.25), p)
        for mdt in (None, BF):
            for kernel in ("batched_g", "pieces", "zslab"):
                op = laplace_cuda.make_operator(
                    layout, torch.float32, "bf16", factor="dense",
                    metric="precomputed", device=dev, metric_dtype=mdt,
                    windowing="reshape" if kernel == "batched_g" else kernel)
                print(f"p={p} {kernel} metric {str(op.metric_dtype)[6:]}: "
                      f"{apply_readings(op, p, kernel)}", flush=True)


if __name__ == "__main__":
    main()
