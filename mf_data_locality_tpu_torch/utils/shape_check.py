"""Checks of the kernels at the shapes beyond BP4's — CEED BP3 (one
component) and the Gauss rule q = p + 1 — on a card.

    python -m mf_data_locality_tpu_torch.utils.shape_check [--time]
        [--degrees 1,2,...]

Builds the kernels and prints the registers and spills of the shape
instantiations (``csrc/shapes.cu``: the sum-factorized pass, the dense
tensor-core pass of ``apply_mma_hd.cuh``, the twostage one of
``cell_mma_hd.cuh``, the assemble pass over one component).  Then on the
3 x 5 x 7 box (105 cells, not a multiple of any pass's cells), at every
degree 1..11 (or ``--degrees``), every shape of :data:`SHAPES` and every
rung of :data:`RUNGS`, holds each kernel against its plain version:

* B3 (the cell batch, the metric streamed), B4 (the metric rebuilt), B5
  and B6 (the lattice) on the merged solver's dense operator (B4 runs the
  sum-factorized pass on every rung, so under highest only);
* B1 and B2 in each fused configuration of :data:`FUSED` (under highest
  the dense and twostage operators are one function and one pass: the
  dense ones only).

f32: max relative 1e-5 (B2's scalars 1e-4); f64 1e-12 (scalars 1e-11).
``--time``: every kernel at the full-width points of :data:`TIMED`
against its plain version and bound (``chip_smoke.py``'s).  Exits 1 when a
check fails.  ``chip_smoke.py`` runs :func:`compare_all` and
:func:`time_all` in its section 11.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace

import torch

from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.ops import laplace_cuda
from mf_data_locality_tpu_torch.utils import bf16_check, storage_check

RAGGED = (3, 5, 7)
DEGREES = tuple(range(1, 12))
# (components, q - p, key): CEED BP3, BP4 with q = p + 1, both
SHAPES = ((1, 2, "bp3"), (3, 1, "q1"), (1, 1, "bp3_q1"))
RUNGS = (("highest", torch.float32), ("highest", torch.float64),
         ("split2m", torch.float32))
# (factor, metric, cofactor) of B1/B2 by rung
FUSED = {"highest": (("dense", "precomputed", "adjj"),
                     ("dense", "onthefly", "adjj"),
                     ("dense", "onthefly", "jtj")),
         "split2m": (("dense", "precomputed", "adjj"),
                     ("dense", "onthefly", "adjj"),
                     ("dense", "onthefly", "jtj"),
                     ("twostage", "precomputed", "adjj"),
                     ("twostage", "onthefly", "adjj"),
                     ("twostage", "onthefly", "jtj"))}
TOL = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-12, 1e-11)}
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]
APPLY = ("apply_local_batched_g", "apply_local_batched_onthefly",
         "apply_lattice_pieces", "apply_lattice_zslab")
B12 = ("matvec", "fused_cg_iteration")


class CheckFailed(AssertionError):
    pass


def random_state(op, n_comp: int, n: int, seed: int) -> list[torch.Tensor]:
    """``n`` random lattice vectors of ``n_comp`` components, zero on the
    boundary."""
    gen = torch.Generator(device=op.device).manual_seed(seed)
    return [(torch.randn((n_comp,) + op.n_nodes_axis, generator=gen,
                         device=op.device, dtype=op.dtype) * op.mask)
            .contiguous() for _ in range(n)]


def apply_cases(op, op_otf, n_comp: int, seed: int) -> dict:
    """{name: (kernel call, plain call)} of B3-B6 on ``op`` (B4 on the
    rebuilt-metric operator ``op_otf``; None: not on this rung)."""
    u = random_state(op, n_comp, 1, seed)[0]
    u_loc = la.to_cell_batches(u, op.degree).contiguous()
    out = {
        "apply_local_batched_g": (
            lambda: la.apply_local_batched_g(op, u_loc),
            lambda: la._batched_plain(op, u_loc, la._metric(op), True)),
        "apply_lattice_pieces": (
            lambda: la.apply_lattice_pieces(op, u),
            lambda: la._lattice_plain(op, u, la._index_mask(op), True)),
        "apply_lattice_zslab": (
            lambda: la.apply_lattice_zslab(op, u),
            lambda: la._lattice_plain(op, u, op.mask, False))}
    if op_otf is not None:
        out["apply_local_batched_onthefly"] = (
            lambda: la.apply_local_batched_onthefly(op_otf, u_loc),
            lambda: la._batched_plain(op_otf, u_loc, la._metric(op_otf),
                                      False))
    return out


def fused_cases(op, n_comp: int, seed: int) -> dict:
    """{name: (kernel call, plain call)} of B1 and B2 on ``op``."""
    d, x, g, dd, h = random_state(op, n_comp, 5, seed)
    prec = ((random_state(op, 1, 1, seed + 1)[0].abs() + 0.5)
            * op.mask).contiguous()
    scal = torch.tensor(SCAL, device=op.device, dtype=op.dtype)
    work, out = fk.Workspace(op, n_comp), torch.empty_like(d)
    bufs = tuple(torch.empty_like(t) for t in (x, g, dd, h, scal))
    return {
        "matvec": (lambda: fk.matvec(op, d, out=out, work=work),
                   lambda: fk._matvec_plain(op, d)),
        "fused_cg_iteration": (
            lambda: fk.fused_cg_iteration(op, x, g, dd, h, scal, prec,
                                          out=bufs, work=work),
            lambda: fk._fused_iteration_plain(op, x, g, dd, h, scal,
                                              prec))}


def reading(name: str, got, want, dtype, tag: str,
            quiet: bool = True) -> tuple[float, float]:
    """Hold a kernel's result to its plain version's: (max relative error
    of the vectors, of B2's scalars or 0)."""
    tol, stol = TOL[dtype]
    if name == "fused_cg_iteration":
        err = max(bf16_check.rel(a, b) for a, b in zip(got[:4], want[:4]))
        serr = bf16_check.scal_err(got[4][:6].double(), want[4][:6].double())
    else:
        err, serr = bf16_check.rel(got, want), 0.0
    line = f"  {name} {tag}: {err:.3e} (limit {tol:.0e})" + (
        f", scalars {serr:.3e} (limit {stol:.0e})" if serr else "")
    if not quiet:
        print(line)
    if not (err <= tol and serr <= stol):
        raise CheckFailed(line)
    return err, serr


def shape_layout(p: int, s: int | None = None) -> DofLayout:
    """The box of the checks (``s`` None) or the ladder's mesh of 2^s
    cells."""
    return DofLayout(BoxMesh(RAGGED, 0.25) if s is None
                     else BoxMesh.from_s(s), p)


def make_op(layout, rung: str, dtype, q: int, factor="dense",
            metric="precomputed", cofactor="adjj", windowing="reshape",
            dev="cuda"):
    return laplace_cuda.make_operator(
        layout, dtype, rung, factor=factor, metric=metric,
        cofactor=cofactor, device=dev, windowing=windowing, n_q=q)


def compare_degree(p: int, dev, quiet: bool = True) -> dict:
    """Every check of the module docstring at degree ``p``; returns {(key,
    rung tag, kernel): (largest error, largest scalar error)}."""
    worst: dict = {}
    layout = shape_layout(p)
    for n_comp, dq, key in SHAPES:
        q = p + dq
        for rung, dtype in RUNGS:
            rtag = f"{rung}{'64' if dtype == torch.float64 else ''}"
            built: dict = {}  # (factor, metric) -> the operator, by adjj

            def op_for(factor, metric, cof="adjj"):
                # one build a (factor, metric); the jtj chain the same data
                if (factor, metric) not in built:
                    built[factor, metric] = make_op(
                        layout, rung, dtype, q, factor, metric, "adjj",
                        "pieces", dev)
                return replace(built[factor, metric], cofactor=cof)

            op = op_for("dense", "precomputed")
            op_otf = (op_for("dense", "onthefly") if rung == "highest"
                      else None)
            cases = [(op, name, kp) for name, kp in
                     apply_cases(op, op_otf, n_comp, 10 + p).items()]
            for factor, metric, cof in FUSED[rung]:
                fop = op_for(factor, metric, cof)
                cases += [(fop, name, kp) for name, kp in
                          fused_cases(fop, n_comp, 20 + p).items()]
            for o, name, (kern, plain) in cases:
                tag = (f"p={p} {key} {rtag} {o.factor} {o.metric} "
                       f"{o.cofactor}")
                r = reading(name, kern(), plain(), dtype, tag, quiet)
                k = (key, rtag, name)
                old = worst.get(k, (0.0, 0.0))
                worst[k] = (max(old[0], r[0]), max(old[1], r[1]))
    return worst


def compare_all(dev, degrees=DEGREES, quiet: bool = True) -> dict:
    """:func:`compare_degree` at every degree; raises :class:`CheckFailed`
    on the first failure."""
    worst: dict = {}
    for p in degrees:
        for k, v in compare_degree(p, dev, quiet).items():
            old = worst.get(k, (0.0, 0.0))
            worst[k] = (max(old[0], v[0]), max(old[1], v[1]))
    return worst


def report(worst: dict) -> None:
    for (key, rtag, name), (err, serr) in sorted(worst.items()):
        print(f"  {key} {rtag} {name}: largest {err:.3e}"
              + (f", scalars {serr:.3e}" if serr else ""))


# the full-width points ((p+1)^3 2^s C < 6e6, benchmark.ladder_sizes):
# (key suffix of the kernels line, components, q - p, p, s, kernels timed
# there); B1/B2 in the production command's configuration (the fused
# solver's auto dispatch under split2m), B3-B6 under f32 highest (the JAX
# CLI's default rung)
TIMED = (("_bp3_p4", 1, 2, 4, 15, APPLY + B12),
         ("_bp3_p6", 1, 2, 6, 14, B12),
         ("_q1_p4", 3, 1, 4, 13, APPLY + B12))


def production_config(p: int) -> tuple[str, str, str]:
    """(factor, metric, cofactor) of the production command (--solver
    fused --precision split2m --windowing pieces) at degree ``p``."""
    from mf_data_locality_tpu_torch import benchmark

    return benchmark.resolve_config(p, "fused", "pieces", "split2m",
                                    torch.float32)


def time_all(dev, time_pair, bound) -> dict:
    """Every kernel of each :data:`TIMED` row against its plain version
    (compared first) and beside its bound (``time_pair(kern, plain)`` ->
    (kernel ms, plain ms) and ``bound``: ``chip_smoke.py``'s): {(name,
    suffix): ((kernel ms, plain ms), (bound ms, bound by), max |diff|,
    configuration)}."""
    out = {}
    for sfx, n_comp, dq, p, s, names in TIMED:
        layout = shape_layout(p, s)
        q = p + dq
        ops = {}
        if set(names) & set(APPLY):
            ops["apply"] = make_op(layout, "highest", torch.float32, q,
                                   dev=dev)
            ops["otf"] = make_op(layout, "highest", torch.float32, q,
                                 metric="onthefly", dev=dev)
        config = production_config(p)
        ops["fused"] = make_op(layout, "split2m", torch.float32, q, *config,
                               "pieces", dev)
        cases = {}
        if "apply" in ops:
            cases.update(apply_cases(ops["apply"], ops["otf"], n_comp, 40))
        cases.update(fused_cases(ops["fused"], n_comp, 41))
        for name in names:
            kern, plain = cases[name]
            op = (ops["fused"] if name in B12 else ops["otf"]
                  if name == "apply_local_batched_onthefly" else ops["apply"])
            tag = (f"p={p} s={s} C={n_comp} q={q} {op.precision} "
                   f"{op.factor} {op.metric} {op.cofactor}")
            got, want = kern(), plain()
            reading(name, got, want, torch.float32, tag)
            if name == "fused_cg_iteration":
                got, want = got[:4], want[:4]
            else:
                got, want = [got], [want]
            diff = max((a - b).abs().max().item() for a, b in zip(got, want))
            t = time_pair(kern, plain)
            b = bound(name, op, op.precision != "highest", n_comp=n_comp)
            print(f"  {name} {tag}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} "
                  f"ms, bound {b[0]:.4f} ms ({b[1]}), share "
                  f"{b[0] / t[0]:.3f}")
            out[(name, sfx)] = (t, b, diff, [op.precision, op.factor,
                                             op.metric, op.cofactor])
        del ops, cases
        torch.cuda.empty_cache()
    return out


def shape_table(log: str) -> dict[str, tuple[int, int, int]]:
    """{kernel: (registers, spill store, spill load bytes)} of the shape
    instantiations in a ``-Xptxas -v`` build log."""
    return {k: v for k, v in storage_check.ptxas_table(log).items()
            if storage_check._is_shape(k)}


def print_table(log: str) -> dict:
    table = shape_table(log)
    spill = {k: v for k, v in table.items() if v[1] or v[2]}
    print(f"shape instantiations: {len(table)}, registers "
          f"{min(v[0] for v in table.values())}-"
          f"{max(v[0] for v in table.values())}, spilling {len(spill)}")
    for name, (regs, st, ld) in sorted(spill.items()):
        print(f"  ptxas {name[:100]} regs {regs} spill {st}/{ld}")
    return table


def main(argv: list[str] | None = None) -> int:
    from mf_data_locality_tpu_torch.ops import _build
    from mf_data_locality_tpu_torch.utils import timing

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--degrees", default=",".join(map(str, DEGREES)))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("shape_check: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib, log = _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    print_table(log or lib.with_suffix(".log").read_text())
    t0 = time.perf_counter()
    try:
        worst = compare_all(dev, tuple(int(p) for p in
                                       args.degrees.split(",")), quiet=False)
    except CheckFailed as e:
        print(f"FAILED: {e}")
        return 1
    report(worst)
    print(f"compare {time.perf_counter() - t0:.1f} s")
    if args.time:
        sys.path.insert(0, ".")
        import chip_smoke

        time_all(dev, lambda k, p: chip_smoke.time_pair(k, p, dev, timing),
                 chip_smoke.bound)
    return 0


if __name__ == "__main__":
    sys.exit(main())
