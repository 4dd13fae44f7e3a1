"""Check of B2 with the preconditioner or x stored in bf16, on a card.

    python -m mf_data_locality_tpu_torch.utils.storage_check [--parent DIR]
        [--time] [--build-only]

Builds the kernels and prints the build wall, each source's compile time
and the ptxas registers and spills of B2's PX instantiations (P or x in
bf16: ``csrc/cg_fused_px.cu`` and the passes' ``kLatticeUpdatePx`` / ``PX``
forms).  ``--parent DIR``: first builds the kernels of another checkout
(the parent commit's ``git archive`` unpacked in DIR) in a process of its
own, then compares every instantiation the two builds share, registers
and spills, and prints how many are equal; B2's block form
(``kLatticeUpdateBlock``, the assemble and backward passes' BLOCK) is
counted apart, since its names are those of the z-slab form it replaced
(form 4, the last template argument true) and its code is not.  The
instantiations at the shapes beyond BP4's (``csrc/shapes.cu``: one
component, q = p + 1) are listed with their registers and spills, and
compared where the parent has them; in both builds the assemble pass's
names are read without its component count (NC = 3), a template argument
since those shapes.  ``--build-only``: this report alone.

Then, on a 3 x 5 x 7 box at every degree 1..11 and in every configuration
of ``laplace_cuda.fused_configs`` under ``highest`` (f32, f64), split2m,
split3 and bf16 (with the bf16 state), B2 with x in bf16 must give g', d',
h' and the scalars bitwise equal to the f32-x kernel run beside it, and x'
within the rung's tolerance of its plain version; B2 with P in bf16 (and
with both) is held against its plain version, and a control, the plain
version with P unrounded, must miss that tolerance.  ``--time``: B2 at
p=4 s=13 in the production configuration (split2m twostage + onthefly)
and under ``highest`` (twostage + precomputed at p=6 s=12), f32 P and x,
bf16 P, bf16 x, in turns.  Exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import _build, laplace_cuda
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.utils import profiling, timing

SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]
BF = torch.bfloat16
# kernel vs plain: relative L2 of the vectors and max relative scalar
# difference (the rungs' limits of the card tests; bf16 with its state)
TOL = {"highest": (1e-5, 1e-5), "highest64": (1e-12, 1e-11),
       "split2m": (1e-5, 1e-5), "split3": (1e-5, 1e-5),
       "bf16": (3e-4, 1e-4)}


def ptxas_table(log: str) -> dict[str, tuple[int, int, int]]:
    """{kernel: (registers, spill store bytes, spill load bytes)} of an
    ``nvcc -Xptxas -v`` log."""
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m[1], (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m[1]), int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m[1]), *spill)
    return out


def _unpx(name: str) -> str:
    # an instantiation whose trailing template argument is a new default —
    # `false` (PX, PBF) or the sum-factorized pass's SB = 0 — had no such
    # argument before
    return re.sub(r"L[bi]0E(E+v)", r"\1", name, count=1)


def _unshape(name: str) -> str:
    """The name an assemble pass had before its trailing component count
    (NC = 3, BP4's) was a template argument."""
    return re.sub(r"^(_ZN3bp415assemble_kernelI.*)Li3E(E+v)", r"\1\2",
                  name)


def _is_shape(name: str) -> bool:
    """An instantiation at a shape beyond BP4's (csrc/shapes.cuh): a flag
    argument with kShC1 (32) or kShQ1 (64), or the assemble pass over one
    component (NC = 1, its last template argument)."""
    flags = (int(v) for v in re.findall(r"Li(\d+)E", name))
    return (any(v >= 32 for v in flags)
            or bool(re.search(r"^_ZN3bp415assemble_kernelI.*Li1EE+v",
                              name)))


def _is_px(name: str) -> bool:
    """An instantiation for P or x in bf16: the kLatticeUpdatePx form (3)
    of the FORM passes, PX true as the last template argument, or the
    assemble pass's PBF true (before its SLAB)."""
    if re.search(r"(apply_sumfac_kernelI[fd]|apply_mma_kernelI|"
                 r"dense_hd_gather_kernelI)Li\d+ELi3E", name):
        return True
    return bool(re.search(r"(cells_mma_kernel|cells_mma_hd_kernel)I.*"
                          r"Lb1EEEv", name)
                or re.search(r"assemble_kernelI.*Lb1ELb0EEEv", name))


def _is_block(name: str) -> bool:
    """An instantiation of B2's block form: the kLatticeUpdateBlock form
    (4) of the FORM passes, or the assemble or the dense forward or
    backward pass with BLOCK (the last template argument) true."""
    return bool(re.search(r"(apply_sumfac_kernelI[fd]|apply_mma_kernelI|"
                          r"dense_hd_gather_kernelI)Li\d+ELi4E", name)
                or re.search(r"(assemble_kernelI|dense_hd_backward_kernelI|"
                             r"dense_hd_forward_kernelI).*Lb1EEEv", name))


def build_report(parent: str | None) -> bool:
    ok = True
    base = None
    if parent:
        t0 = time.perf_counter()
        code = ("from mf_data_locality_tpu_torch.ops import _build; "
                "p, log = _build.build(); print(p.with_suffix('.log'))")
        r = subprocess.run([sys.executable, "-c", code], cwd=parent,
                           capture_output=True, text=True)
        if r.returncode:
            print(r.stdout[-2000:], r.stderr[-4000:])
            raise SystemExit("the parent's build failed")
        base = {_unshape(k): v for k, v in ptxas_table(
            Path(r.stdout.split()[-1]).read_text()).items()}
        print(f"parent build {time.perf_counter() - t0:.1f} s, "
              f"{len(base)} instantiations")
    t0 = time.perf_counter()
    lib, log = _build.build()
    wall = time.perf_counter() - t0
    log = log or lib.with_suffix(".log").read_text()  # built before
    table = {_unshape(k): v for k, v in ptxas_table(log).items()}
    ends = re.findall(r"nvcc: (\S+)((?: -DBP4_\w+=\d+)*) ([\d.]+) s", log)
    print(f"build {wall:.1f} s, {len(table)} instantiations, "
          f"{len(ends)} compiles")
    for src, rung, t in sorted(ends, key=lambda e: float(e[2]))[-8:]:
        print(f"  nvcc {src}{rung} {t} s")
    px = {k: v for k, v in table.items() if _is_px(k)}
    print(f"PX instantiations: {len(px)}")
    for k, v in sorted(px.items()):
        print(f"  ptxas {k[:96]} regs {v[0]} spill {v[1]}/{v[2]}")
    blocks = {k: v for k, v in table.items() if _is_block(k)}
    print(f"block-form instantiations: {len(blocks)}, spilling "
          f"{sum(1 for v in blocks.values() if v[1] or v[2])}")
    shapes = {k: v for k, v in table.items() if _is_shape(k)}
    print(f"shape instantiations (csrc/shapes.cu): {len(shapes)}, "
          f"registers {min([v[0] for v in shapes.values()] + [0])}-"
          f"{max([v[0] for v in shapes.values()] + [0])}, spilling "
          f"{sum(1 for v in shapes.values() if v[1] or v[2])}")
    for k, v in sorted(shapes.items()):
        print(f"  ptxas {k[:110]} regs {v[0]} spill {v[1]}/{v[2]}")
    if base is not None:
        same = diff = 0
        for k, v in table.items():
            b = base.get(k, base.get(_unpx(k)))
            if b is None or k in blocks:  # shapes: where the parent has them
                continue
            if b == v:
                same += 1
            else:
                diff += 1
                print(f"  CHANGED {k[:96]}: {b} -> {v}")
        print(f"instantiations shared with the parent (the block form "
              f"apart): {same + diff}, equal {same}, changed {diff}; "
              f"parent's not found "
              f"{len(set(base) - {_unpx(k) for k in table} - set(table))}; "
              f"the parent's of the block form's names "
              f"{sum(1 for k in blocks if k in base)}")
        pairs = [(base[k], v) for k, v in blocks.items() if k in base]
        print(f"  the block form against the parent's instantiation of its "
              f"name: registers equal "
              f"{sum(1 for b, v in pairs if v[0] == b[0])}, more "
              f"{sum(1 for b, v in pairs if v[0] > b[0])} (at most +"
              f"{max([v[0] - b[0] for b, v in pairs] + [0])}), fewer "
              f"{sum(1 for b, v in pairs if v[0] < b[0])}; spilling "
              f"{sum(1 for b, v in pairs if v[1] or v[2])} against "
              f"{sum(1 for b, v in pairs if b[1] or b[2])}, spill bytes "
              f"{sum(v[1] + v[2] for b, v in pairs)} against "
              f"{sum(b[1] + b[2] for b, v in pairs)}")
        ok = diff == 0
    return ok


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp_min(
        1e-300)).item()


def _scal_err(a, b) -> float:
    a, b = a.double()[:6], b.double()[:6]
    return ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()


def _inputs(op, dev, store, seed=1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (3,) + op.n_nodes_axis
    x, g, d, h = [(torch.randn(shape, generator=gen, device=dev,
                               dtype=op.dtype) * op.mask).contiguous()
                  for _ in range(4)]
    d, h = d.to(store).contiguous(), h.to(store).contiguous()
    prec = ((torch.rand((1,) + op.n_nodes_axis, generator=gen, device=dev,
                        dtype=op.dtype) + 0.5) * op.mask).contiguous()
    return x, g, d, h, prec


def _x_ok(a, b) -> bool:
    """x' in bf16 against its plain version: within one bf16 step (2^-8
    of the largest value; the two round sums that differ in the last f32
    bits)."""
    a, b = a.double(), b.double()
    return bool((a - b).abs().max() <= 2.0 ** -8 * b.abs().max())


def compare(op, dev, store, tol) -> tuple[bool, str]:
    """The three checks at one configuration; (passed, report)."""
    vtol, stol = tol
    scal = torch.tensor(SCAL, device=dev, dtype=op.dtype)
    x, g, d, h, prec = _inputs(op, dev, store)
    xb, pb = x.to(BF).contiguous(), prec.to(BF).contiguous()
    ref = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
    rx = fk.fused_cg_iteration(op, xb, g, d, h, scal, prec)
    bit = all(torch.equal(a, b) for a, b in zip(ref[1:], rx[1:]))
    xok = _x_ok(rx[0], fk._fused_iteration_plain(op, xb, g, d, h, scal,
                                                 prec)[0])
    ok = bit and xok
    rep = [f"x bf16: bitwise {bit}, x' {xok}"]
    for name, xx in (("P", x), ("P+x", xb)):
        res = fk.fused_cg_iteration(op, xx, g, d, h, scal, pb)
        want = fk._fused_iteration_plain(op, xx, g, d, h, scal, pb)
        ctrl = fk._fused_iteration_plain(op, xx, g, d, h, scal, prec)
        ev = max(_rel_l2(r, w) for r, w in zip(res[1:4], want[1:4]))
        es = _scal_err(res[4], want[4])
        cv = max(_rel_l2(r, c) for r, c in zip(res[1:4], ctrl[1:4]))
        xok = (_x_ok(res[0], want[0]) if xx is xb
               else _rel_l2(res[0], want[0]) <= vtol)
        ok &= ev <= vtol and es <= stol and cv > vtol and xok
        rep.append(f"{name} bf16 {ev:.2e} scal {es:.2e} control {cv:.2e} "
                   f"x' {xok}")
    return ok, ", ".join(rep) + f" (limit {vtol:g})"


def sweep(dev) -> bool:
    ok = True
    rungs = (("highest", torch.float32, "highest"),
             ("highest", torch.float64, "highest64"),
             ("split2m", torch.float32, "split2m"),
             ("split3", torch.float32, "split3"),
             ("bf16", torch.float32, "bf16"))
    for p in range(1, 12):
        layout = DofLayout(BoxMesh((3, 5, 7), 0.25), p)
        for precision, dtype, key in rungs:
            for factor, metric in laplace_cuda.fused_configs(precision, p):
                cofs = ("adjj", "jtj") if metric == "onthefly" else (
                    "adjj",)
                for cof in cofs:
                    op = laplace_cuda.make_operator(
                        layout, dtype, precision, factor=factor,
                        metric=metric, cofactor=cof, device=dev,
                        windowing="pieces")
                    store = BF if precision == "bf16" else dtype
                    good, rep = compare(op, dev, store, TOL[key])
                    ok &= good
                    print(f"p={p} {key} {factor} {metric} {cof}: "
                          f"{'ok' if good else 'FAIL'} {rep}")
    return ok


def time_b2(dev) -> None:
    for p, s, precision, factor, metric, cof in (
            (4, 13, "split2m", "twostage", "onthefly", "adjj"),
            (6, 12, "highest", "twostage", "precomputed", "adjj")):
        op = laplace_cuda.make_operator(
            DofLayout(BoxMesh.from_s(s), p), torch.float32, precision,
            factor=factor, metric=metric, cofactor=cof, device=dev,
            windowing="pieces")
        x, g, d, h, prec = _inputs(op, dev, torch.float32)
        scal = torch.tensor(SCAL, device=dev)
        work = fk.Workspace(op)
        variants = {"f32": (x, prec), "P bf16": (x, prec.to(BF)),
                    "x bf16": (x.to(BF), prec)}
        times = {k: [] for k in variants}
        for name in list(variants) + list(reversed(variants)):
            xx, pp = variants[name]
            out = tuple(torch.empty_like(t) for t in (xx, g, d, h, scal))
            times[name].append(timing.time_per_call(
                lambda: fk.fused_cg_iteration(op, xx, g, d, h, scal, pp,
                                              out=out, work=work),
                dev, inner=20, repeats=3))
        print(f"B2 p={p} s={s} {precision} {factor} {metric}: " + ", ".join(
            f"{k} {min(v) * 1e3:.4f} ms" for k, v in times.items()))
        for name, (xx, pp) in variants.items():  # device time per kernel
            out = tuple(torch.empty_like(t) for t in (xx, g, d, h, scal))
            rows, _ = profiling.kernel_breakdown(
                lambda: [fk.fused_cg_iteration(op, xx, g, d, h, scal, pp,
                                               out=out, work=work)
                         for _ in range(20)], dev)
            print(f"  {name}: " + ", ".join(
                f"{k.split('<')[0].split('(')[0][-24:]} "
                f"{sec / calls * 1e6:.2f} us" for k, calls, sec in rows))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parent")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--build-only", action="store_true",
                    help="the build report alone")
    args = ap.parse_args()
    dev = timing.require_cuda("cuda")
    ok = build_report(args.parent)
    if not args.build_only:
        ok &= sweep(dev)
    if args.time:
        time_b2(dev)
    print("storage_check", "ok" if ok else "FAILED")
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
