"""Quick check of the split2m two-stage tensor-core pass of B1/B2 on a card.

    python -m mf_data_locality_tpu_torch.utils.split2m_check

Builds the kernels, prints the ptxas register and spill lines of
``cells_mma_hd_kernel`` and ``cells_mma_kernel`` (``csrc/cell_mma_hd.cuh``,
``csrc/cell_mma.cuh``), compares B1 and B2 under f32 split2m with their
plain versions at p=4..11 on a 3 x 5 x 7 box in twostage + onthefly (jtj,
adjj) and + the streamed metric, each B1 twice for a bitwise repeat, and
times B1 at p=6 s=12 and p=8 s=11.  A short first call after a change to
those sources; ``chip_smoke.py`` is the full check.
"""

from __future__ import annotations

import time

import torch

from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import _build, laplace_cuda
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.utils import timing

CONFIGS = (("onthefly", "jtj"), ("onthefly", "adjj"), ("precomputed", "adjj"))
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]


def _op(layout, dev, metric, cofactor):
    return laplace_cuda.make_operator(layout, torch.float32, "split2m",
                                      factor="twostage", metric=metric,
                                      cofactor=cofactor, device=dev,
                                      windowing="pieces")


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def main() -> None:
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _, log = _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    entry = ""
    for line in log.splitlines():
        if "Function properties for" in line:
            entry = line.split("for ")[-1].strip()
        elif "cells_mma" in entry and ("registers" in line or "spill" in line):
            print(entry[:90], "|", line.strip())
    worst = 0.0
    for p in range(4, 12):
        layout = DofLayout(BoxMesh((3, 5, 7), 0.25), p)
        for metric, cofactor in CONFIGS:
            op = _op(layout, dev, metric, cofactor)
            gen = torch.Generator(device=dev).manual_seed(1)
            shape = (3,) + op.n_nodes_axis
            x, g, d, h = [(torch.randn(shape, generator=gen, device=dev)
                           * op.mask).contiguous() for _ in range(4)]
            prec = ((torch.randn((1,) + op.n_nodes_axis, generator=gen,
                                 device=dev).abs() + 0.5)
                    * op.mask).contiguous()
            scal = torch.tensor(SCAL, device=dev)
            a, again = fk.matvec(op, d), fk.matvec(op, d)
            e1 = _rel(a, fk._matvec_plain(op, d))
            res = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
            want = fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
            e2 = max(_rel(r, w) for r, w in zip(res[:4], want[:4]))
            es = ((res[4] - want[4]).abs()
                  / want[4].abs().clamp_min(1e-30)).max().item()
            print(f"p={p} {metric} {cofactor}: B1 {e1:.3e} repeat-equal "
                  f"{bool(torch.equal(a, again))}, B2 {e2:.3e} scal {es:.3e}")
            worst = max(worst, e1, e2)
    print("worst", worst)
    for p, s in ((6, 12), (8, 11)):
        layout = DofLayout(BoxMesh.from_s(s), p)
        for metric, cofactor in (("onthefly", "jtj"), ("precomputed", "adjj")):
            op = _op(layout, dev, metric, cofactor)
            d = (torch.randn((3,) + op.n_nodes_axis, device=dev)
                 * op.mask).contiguous()
            out, work = torch.empty_like(d), fk.Workspace(op)
            t = timing.time_per_call(
                lambda: fk.matvec(op, d, out=out, work=work), dev, inner=10,
                repeats=3)
            print(f"p={p} s={s} {metric} {cofactor}: B1 {t * 1e3:.4f} ms")


if __name__ == "__main__":
    main()
