"""Quick check of the dense tensor-core pass at p=5..11 on a card.

    python -m mf_data_locality_tpu_torch.utils.dense_check [--time]

Builds the kernels, prints the ptxas register and spill lines of the
``dense_hd_*`` kernels (``csrc/apply_mma_hd.cuh``) and the build's
slowest compiles, then compares, under split2m, split3 and bf16 at every
degree 5..11 on a 3 x 5 x 7 box, B3, B5 and B6 (the merged solver's
windowings) and B1 and B2 in the dense factorization (the metric streamed
and rebuilt) with their plain versions, each kernel twice for a bitwise
repeat: split2m and split3 to 1e-5 of the largest value (B2's scalars
1e-4), bf16 to a relative L2 of 3e-4 (``chip_smoke.TOL_BF16``).  With
``--time``: B3 and B1 dense under split2m timed at p=6 s=12 and p=8 s=11,
with ``torch.matmul`` of the forward's bf16 product at the padded
shapes, (3 Q3P x P13P) x (P13P x 3 n_cells), beside them as a yardstick.
A short first call after a change to that source; ``chip_smoke.py`` is
the full check.
"""

from __future__ import annotations

import re
import sys
import time

import torch

from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import _build, laplace_cuda
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.utils import timing

RUNGS = ("split2m", "split3", "bf16")
BOX = (3, 5, 7)
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]


def _state(op, n: int, seed: int) -> list[torch.Tensor]:
    gen = torch.Generator(device=op.device).manual_seed(seed)
    return [(torch.randn((3,) + op.n_nodes_axis, generator=gen,
                         device=op.device) * op.mask).contiguous()
            for _ in range(n)]


def _err(got, want, rung: str) -> float:
    """max |diff| / max |want| (split2m, split3) or the relative L2
    (bf16), the larger over B2's four vectors."""
    pairs = zip(got[:4], want[:4]) if isinstance(got, tuple) else [(got,
                                                                   want)]
    if rung == "bf16":
        return max(((a.double() - b.double()).norm() / b.double().norm())
                   .item() for a, b in pairs)
    return max(((a - b).abs().max() / b.abs().max()).item() for a, b in pairs)


def cases(op, seed: int) -> dict:
    """(kernel call, plain call) of the kernels that run ``op``: B3/B5/B6 on
    a dense streamed operator, B1/B2 on any dense one."""
    u, d, x, g, dd, h = _state(op, 6, seed)
    prec = ((_state(op, 1, seed + 1)[0][:1].abs() + 0.5) * op.mask
            ).contiguous()
    scal = torch.tensor(SCAL, device=op.device)
    work = fk.Workspace(op)
    out = {"matvec": (lambda: fk.matvec(op, d, work=work),
                      lambda: fk._matvec_plain(op, d)),
           "fused_cg_iteration": (
               lambda: fk.fused_cg_iteration(op, x, g, dd, h, scal, prec,
                                             work=work),
               lambda: fk._fused_iteration_plain(op, x, g, dd, h, scal,
                                                 prec))}
    if op.gmetric is not None:
        u_loc = la.to_cell_batches(u, op.degree).contiguous()
        out.update({
            "apply_local_batched_g": (
                lambda: la.apply_local_batched_g(op, u_loc),
                lambda: la._batched_plain(op, u_loc, la._metric(op), True)),
            "apply_lattice_pieces": (
                lambda: la.apply_lattice_pieces(op, u),
                lambda: la._lattice_plain(op, u, la._index_mask(op))),
            "apply_lattice_zslab": (
                lambda: la.apply_lattice_zslab(op, u),
                lambda: la._lattice_plain(op, u, op.mask))})
    return out


def compare(dev) -> None:
    """Every dense configuration at p=5..11 on the box; raises on the first
    disagreement or a repeat that is not bitwise equal."""
    for p in range(5, 12):
        layout = DofLayout(BoxMesh(BOX, 0.25), p)
        worst = {}
        for rung in RUNGS:
            tol = 3e-4 if rung == "bf16" else 1e-5
            for i, metric in enumerate(("precomputed", "onthefly")):
                op = laplace_cuda.make_operator(
                    layout, torch.float32, rung, factor="dense",
                    metric=metric, windowing="zslab" if i == 0 else "pieces",
                    device=dev)
                for name, (kern, plain) in cases(op, 10 * p + i).items():
                    got, again, want = kern(), kern(), plain()
                    torch.cuda.synchronize()
                    same = (all(torch.equal(a, b) for a, b in zip(got, again))
                            if isinstance(got, tuple)
                            else torch.equal(got, again))
                    err = _err(got, want, rung)
                    if name == "fused_cg_iteration":
                        s = ((got[4] - want[4]).abs()
                             / want[4].abs().clamp_min(1e-30)).max().item()
                        worst[f"{rung} scal"] = max(
                            worst.get(f"{rung} scal", 0.0), s)
                        if not s <= 1e-4:
                            raise AssertionError(f"p={p} {rung} {metric} "
                                                 f"{name} scal {s:.3e}")
                    key = f"{rung} {name}[{metric[0]}]"
                    worst[key] = max(worst.get(key, 0.0), err)
                    if not (same and err <= tol):
                        raise AssertionError(
                            f"p={p} {rung} {metric} {name}: err {err:.3e} "
                            f"(tol {tol:.0e}), repeat equal {same}")
                del op
        print(f"p={p} box {BOX}: " + ", ".join(f"{k} {v:.1e}"
                                                for k, v in worst.items()),
              flush=True)
        torch.cuda.empty_cache()


def time_points(dev) -> None:
    """B3 and B1 dense under split2m at p=6 s=12 and p=8 s=11, each against
    ``torch.matmul`` of the forward's bf16 product at the padded shapes."""
    for p, s in ((6, 12), (8, 11)):
        layout = DofLayout(BoxMesh.from_s(s), p)
        op = laplace_cuda.make_operator(layout, torch.float32, "split2m",
                                        factor="dense", metric="precomputed",
                                        windowing="reshape", device=dev)
        (u,) = _state(op, 1, 7)
        u_loc = la.to_cell_batches(u, p).contiguous()
        d = u
        work = fk.Workspace(op)
        b3 = timing.time_per_call(lambda: la.apply_local_batched_g(op, u_loc),
                                  dev, inner=10, repeats=3)
        b1 = timing.time_per_call(lambda: fk.matvec(op, d, work=work), dev,
                                  inner=10, repeats=3)
        q3p, p13p = laplace_cuda.mma_dims(p)
        m = torch.randn((3 * q3p, p13p), device=dev).to(torch.bfloat16)
        x = torch.randn((p13p, 3 * op.n_cells), device=dev).to(
            torch.bfloat16)
        mm = timing.time_per_call(lambda: torch.matmul(m, x), dev, inner=10,
                                  repeats=3)
        print(f"p={p} s={s} split2m dense: B3 {b3 * 1e3:.4f} ms, B1 "
              f"{b1 * 1e3:.4f} ms; torch.matmul of the forward's bf16 "
              f"product {tuple(m.shape)} x {tuple(x.shape)} {mm * 1e3:.4f} "
              f"ms", flush=True)
        del op, u, u_loc, d, work, m, x
        torch.cuda.empty_cache()


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dev = timing.require_cuda("cuda")
    t0 = time.perf_counter()
    _, log = _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    entry = ""
    for line in log.splitlines():
        if "Function properties for" in line:
            entry = line.split("for ")[-1].strip()
        elif "dense_hd" in entry and ("registers" in line
                                      or re.search(r"[1-9]\d* bytes spill",
                                                   line)):
            print(f"  ptxas {entry[:60]}: {line.strip()}")
    slowest = sorted(re.findall(r"^nvcc: (.*) ([\d.]+) s$", log, re.M),
                     key=lambda x: -float(x[1]))[:4]
    print("slowest compiles: " + ", ".join(f"{n} {t} s" for n, t in slowest))
    compare(dev)
    if "--time" in argv:
        time_points(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
