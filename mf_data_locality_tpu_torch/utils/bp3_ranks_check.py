"""Checks of the bf16 state at one component (CEED BP3) on a card: in the
ranks' kernel forms and on one device.

    python -m mf_data_locality_tpu_torch.utils.bp3_ranks_check [--time]
        [--degrees 1,2,...]

Builds the kernels and prints the registers and spills of BP3's new
instantiations (``csrc/shapes_block.cu``: B2's block form at one
component; ``csrc/shapes.cu`` built with the bf16 state's flags,
``-DBP4_SHAPE=36``).  Then at every degree 1..11 (or ``--degrees``), each
kernel with d and h (B3-B6: u and v) stored in bf16 at one component
against its plain version, under highest and split2m:

* B2's block form on rank 1 of two z-slabs and on block (0, 0) of a (2, 2)
  mesh of the s=6 mesh (4^3 cells), the metric streamed and rebuilt: the
  vectors within relative L2 ``LIMIT_L2``, the sums within
  ``LIMIT_SCAL``, and the rounding point's control (sums over the
  unrounded d') outside it; its layer-range form, the cell pass over [0,
  c) and [c, n) then the node passes, bitwise the one launch;
* C10's f32 carry (the lower of two z-slabs of 2^5 cells, both metrics):
  max relative 1e-5, the face as stored (bf16) outside it;
* B3 (reshape), B5 (pieces) and B6 (zslab) on the slab: within
  ``LIMIT_L2``, the control (the plain version without the bf16 store)
  outside it;
* on one device, on the 3 x 5 x 7 box: B3, B4, B5, B6, and B1/B2 in every
  fused configuration (both chains) (``utils/bf16_state_check``'s
  readings and controls).

The f32 and f64 forms at one component (B2's block and layer-range forms,
B3/B5/B6 on a rank's part) are checked and timed by ``chip_smoke.py``'s
functions for those forms at three components, called with ``n_comp=1``.

``--time``: at BP3's 4-rank full width (p=4, s=17:
``benchmark.ladder_sizes(4, n_components=1, n_devices=4)``'s top) on rank
1's slab B2's block form with the bf16 state (split2m, the metric rebuilt
by adjj), and on one device at BP3's full width (p=4, s=15) the bf16
state's B3 and B2 (the production configuration): each held against its
plain version as above at that size, then timed beside it and its bound
(``chip_smoke.py``'s).  Exits 1 when a check fails.  ``chip_smoke.py``
runs :func:`compare_all` and :func:`time_all` in its section 8.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.ops import laplace_cuda
from mf_data_locality_tpu_torch.utils import bf16_check
from mf_data_locality_tpu_torch.utils import bf16_state_check as bsc
from mf_data_locality_tpu_torch.utils import storage_check

BF = torch.bfloat16
C = 1  # the vectors' components: CEED BP3
DEGREES = tuple(range(1, 12))
S_PART = 6  # 4 x 4 x 4 cells
# a rank's part: rank 1 of two z-slabs, block (0, 0) of a (2, 2) mesh
PARTS = (("slab 1/2", (1,), (2,)), ("block (0, 0) of (2, 2)", (0, 0),
                                    (2, 2)))
RUNGS = ("highest", "split2m")  # the operator's f32, the state's bf16
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]
APPLY = {"reshape": "apply_local_batched_g",
         "pieces": "apply_lattice_pieces", "zslab": "apply_lattice_zslab"}
# the full width of the timed rows: (p, s, ranks), and one device's
FULL = (4, 17, 4)
FULL_ONE = (4, 15)


CheckFailed = bsc.CheckFailed


def part_op(s: int, p: int, coords, mesh, dtype, rung: str,
            metric: str = "precomputed", windowing: str = "pieces",
            dev="cuda"):
    """The operator of the rank at ``coords`` of ``mesh`` (a (N,) mesh:
    z-slabs) at one component."""
    from mf_data_locality_tpu_torch.parallel import distributed

    if len(mesh) == 1:
        return distributed.build_slab(s, p, coords[0], mesh[0], dtype,
                                      "pallas", rung, windowing, metric, dev,
                                      n_components=C).op
    return distributed.build_block(s, p, coords, mesh, dtype, "pallas", rung,
                                   windowing, metric, dev,
                                   n_components=C).op


def iteration_args(op, seed: int) -> tuple:
    """(x, g, d, h, scal, prec) of one component, d and h stored in
    bf16."""
    x, g, d, h = bf16_check.state(op, 4, seed, C)
    d, h = (v.to(BF).contiguous() for v in (d, h))
    prec = ((bf16_check.state(op, 1, seed + 1, C)[0].abs() + 0.5)
            * op.mask).contiguous()
    scal = torch.tensor(SCAL, dtype=op.dtype, device=op.device)
    return x, g, d, h, scal, prec


def range_iteration(op, args: tuple, cut: int, out=None, work=None):
    """B2's layer-range form: the cell passes over [0, cut) and [cut,
    ncz), then the node passes."""
    out = out or tuple(torch.empty_like(t) for t in args[:5])
    work = work or fk.Workspace(op, C)
    for cells in ((0, cut), (cut, op.n_cells_axis[0])):
        fk.fused_cg_iteration(op, *args, out=out, work=work, cells=cells)
    return fk.fused_cg_assemble(op, out, args[5], args[4], work)


def block_case(op, seed: int, tag: str, quiet: bool) -> tuple:
    """B2's block form with the bf16 state on ``op`` against its plain
    version (the rounding point's control outside the sums' limit), and
    its layer-range form against the one launch; returns (vectors'
    reading, the sums')."""
    args = iteration_args(op, seed)
    one = fk.fused_cg_iteration(op, *args)
    want = fk._fused_iteration_plain(op, *args)
    ncz = op.n_cells_axis[0]
    for cut in sorted({1, ncz - 1} - {0, ncz}):
        got = range_iteration(op, args, cut)
        if not all(torch.equal(a, b) for a, b in zip(got, one)):
            raise CheckFailed(f"{tag}, cut {cut}: the layer-range form is "
                              f"not the one launch bitwise")
    serr = bf16_check.scal_err(one[4][:7].double(), want[4][:7].double())
    err = max(bf16_check.l2(a.float(), b.float())
              for a, b in zip(one[:4], want[:4]))
    bsc._hold(tag, err, bsc.LIMIT_L2, quiet=quiet)
    bsc._hold(f"{tag} sums", serr, bsc.LIMIT_SCAL, quiet=quiet)
    rerr, unrounded = bf16_check.rounding_point(op, seed + 2, C)
    bsc._hold(f"{tag} rounding point", rerr, bsc.LIMIT_SCAL, unrounded,
              quiet)
    return err, serr


def _plain_apply(op, u: torch.Tensor, windowing: str,
                 store: bool = True) -> torch.Tensor:
    """B3 (between the windowings), B5 or B6 on a rank's operator, plain,
    on a bf16 u; ``store`` False: without the bf16 store (the control)."""
    p = op.degree
    if windowing == "reshape":
        return la.from_cell_batches(la._batched_plain(
            op, la.to_cell_batches(u, p), la._metric(op), True,
            store=store), p, op.n_cells_axis)
    if not store:
        u = u.to(op.dtype)
    return la._lattice_plain(op, u, op.mask, windowing == "pieces")


def apply_case(op, windowing: str, seed: int, tag: str,
               quiet: bool) -> float:
    """B3/B5/B6 with the bf16 state on a rank's part against the plain
    version, the control outside the limit."""
    (u,) = bf16_check.state(op, 1, seed, C)
    u = u.to(BF).contiguous()
    got = la.apply_lattice(op, u)
    if got.dtype != BF:
        raise CheckFailed(f"{tag}: a {got.dtype} result, not bf16")
    want = _plain_apply(op, u, windowing)
    err = bf16_check.l2(got.float(), want.float())
    ctl = bf16_check.l2(_plain_apply(op, u, windowing, False).float(),
                        want.float())
    bsc._hold(tag, err, bsc.LIMIT_L2, ctl, quiet)
    return err


def compare_ranks(p: int, dev, quiet: bool = True) -> dict:
    """The rank forms with the bf16 state at degree ``p``: {(kind, rung):
    reading}."""
    worst: dict = {}

    def note(key, err):
        worst[key] = max(worst.get(key, 0.0), err)

    f32 = torch.float32
    for rung in RUNGS:
        for label, coords, mesh in PARTS:
            for metric in ("precomputed", "onthefly"):
                op = part_op(S_PART, p, coords, mesh, f32, rung, metric,
                             dev=dev)
                err, serr = block_case(op, 60 + p, f"B2 block p={p} {rung} "
                                       f"{metric} {label} state bf16", quiet)
                note(("B2 block form", rung), err)
                note(("B2 block form sums", rung), serr)
        for windowing, name in APPLY.items():
            op = part_op(S_PART, p, (1,), (2,), f32, rung, "precomputed",
                         windowing, dev)
            note((name + " slab", rung),
                 apply_case(op, windowing, 70 + p,
                            f"{name} p={p} {rung} slab 1/2 state bf16",
                            quiet))
        for metric in ("precomputed", "onthefly"):
            err, ctl = bsc.carry_case(p, rung, metric, dev, 80 + p,
                                      n_comp=C)
            bsc._hold(f"C10 carry p={p} {rung} {metric}", err, bsc.TOL_F32,
                      ctl, quiet)
            note(("C10 carry", rung), err)
    return worst


def compare_one_device(p: int, dev, quiet: bool = True) -> dict:
    """The bf16 state at one component on one device, the box: the apply
    family and B1/B2 in every fused configuration under highest and
    split2m; {(kind, rung): reading}."""
    worst: dict = {}
    layout = DofLayout(BoxMesh(bsc.RAGGED, 0.25), p)
    for rung in RUNGS:
        for kernel, windowing, metric in (
                ("batched_g", "reshape", "precomputed"),
                ("batched_onthefly", "reshape", "onthefly"),
                ("pieces", "pieces", "precomputed"),
                ("zslab", "zslab", "precomputed")):
            if metric == "onthefly" and rung != "highest":
                continue  # B4: one instantiation serves every rung
            op = laplace_cuda.make_operator(layout, BF, rung, factor="dense",
                                            metric=metric,
                                            windowing=windowing, device=dev)
            err, ctl = bsc.apply_case(op, kernel, 10 + p, BF, n_comp=C)
            bsc._hold(f"{kernel} p={p} {rung} state bf16", err,
                      bsc.LIMIT_L2, ctl, quiet)
            worst[kernel, rung] = max(worst.get((kernel, rung), 0.0), err)
        for factor, metric in laplace_cuda.fused_configs(rung, p):
            for cofactor in (("adjj", "jtj") if metric == "onthefly"
                             else ("adjj",)):
                op = laplace_cuda.make_operator(
                    layout, BF, rung, factor=factor, metric=metric,
                    cofactor=cofactor, windowing="pieces", device=dev)
                r = bsc.fused_case(op, 30 + p, BF, n_comp=C)
                bsc._hold_fused(f"p={p} {rung} {factor} {metric} {cofactor} "
                                f"state bf16", r, BF, quiet)
                for kind, err in (("B1", r["B1"][0]), ("B2", r["B2"]),
                                  ("B2 sums", r["B2 scal"])):
                    worst[kind, rung] = max(worst.get((kind, rung), 0.0),
                                            err)
    return worst


def compare_all(dev, degrees=DEGREES, quiet: bool = True) -> dict:
    """:func:`compare_ranks` and :func:`compare_one_device` at every degree
    of ``degrees``; raises :class:`CheckFailed` on the first failure."""
    worst: dict = {}
    for p in degrees:
        for part in (compare_ranks(p, dev, quiet),
                     compare_one_device(p, dev, quiet)):
            for k, v in part.items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


def report(worst: dict) -> None:
    for (kind, rung), err in sorted(worst.items()):
        print(f"  {kind} {rung} state bf16: largest {err:.3e}")


def time_all(dev, time_pair, bound) -> dict:
    """The timed rows of the module docstring, each held against its plain
    version first: {(kernel, key suffix): ((kernel ms, plain ms), (bound
    ms, bound by), max |diff|, configuration)} (``time_pair(kern, plain)``
    -> (kernel ms, plain ms) and ``bound``: ``chip_smoke.py``'s)."""
    from mf_data_locality_tpu_torch import benchmark

    out = {}

    def row(key, kern, plain, name, op, tag, vectors):
        got, want = kern(), plain()
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(*vectors(got, want)))
        t = time_pair(kern, plain)
        b = bound(name, op, op.precision != "highest", state=BF, n_comp=C)
        print(f"  {name} {tag}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, "
              f"bound {b[0]:.4f} ms ({b[1]}), share {b[0] / t[0]:.3f}")
        out[name, key] = (t, b, diff, [op.precision, op.factor, op.metric,
                                       op.cofactor])

    def b2(got, want):
        return got[:4], want[:4]

    # rank 1's slab at BP3's 4-rank full width, the fused production
    # configuration with the bf16 state
    p, s, n = FULL
    op = part_op(s, p, (1,), (n,), torch.float32, "split2m", "onthefly",
                 dev=dev)
    tag = f"block form p={p} s={s} rank 1/{n} C=1 split2m onthefly state bf16"
    block_case(op, 11, tag, quiet=False)
    args = iteration_args(op, 11)
    work, bufs = fk.Workspace(op, C), tuple(
        torch.empty_like(t) for t in args[:5])
    row("_bp3_slab_bf16", lambda: fk.fused_cg_iteration(
        op, *args, out=bufs, work=work),
        lambda: fk._fused_iteration_plain(op, *args), "fused_cg_iteration",
        op, tag, b2)
    del op, args, work, bufs
    torch.cuda.empty_cache()
    # one device, BP3's full width: B3 (the JAX CLI's default with --dtype
    # bf16) and B2 (the production command with it)
    p1, s1 = FULL_ONE
    layout = DofLayout(BoxMesh.from_s(s1), p1)
    op = laplace_cuda.make_operator(layout, BF, "highest", device=dev)
    tag = f"p={p1} s={s1} C=1 highest state bf16"
    err, ctl = bsc.apply_case(op, "batched_g", 13, BF, n_comp=C)
    bsc._hold(f"apply_local_batched_g {tag}", err, bsc.LIMIT_L2, ctl,
              quiet=False)
    (u,) = bf16_check.state(op, 1, 13, C)
    u_loc = la.to_cell_batches(u.to(BF), p1).contiguous()
    row("_bp3_bf16state", lambda: la.apply_local_batched_g(op, u_loc),
        lambda: la._batched_plain(op, u_loc, la._metric(op), True),
        "apply_local_batched_g", op, tag, lambda a, b: ([a], [b]))
    del op, u, u_loc
    config = benchmark.resolve_config(p1, "fused", "pieces", "split2m", BF)
    op = laplace_cuda.make_operator(layout, BF, "split2m", *config,
                                    windowing="pieces", device=dev)
    tag = f"p={p1} s={s1} C=1 split2m {' '.join(config)} state bf16"
    bsc._hold_fused(tag, bsc.fused_case(op, 14, BF, n_comp=C), BF,
                    quiet=False)
    args = iteration_args(op, 14)
    work, bufs = fk.Workspace(op, C), tuple(torch.empty_like(t)
                                            for t in args[:5])
    row("_bp3_bf16state", lambda: fk.fused_cg_iteration(
        op, *args, out=bufs, work=work),
        lambda: fk._fused_iteration_plain(op, *args), "fused_cg_iteration",
        op, tag, b2)
    del op, args, work, bufs
    torch.cuda.empty_cache()
    return out


def new_instantiations(log: str) -> dict[str, tuple[int, int, int]]:
    """{kernel: (registers, spill store, spill load bytes)} of the block
    form at one component and the bf16 state at one component."""
    out = {}
    for name, v in storage_check.ptxas_table(log).items():
        if not storage_check._is_shape(name):
            continue
        if (storage_check._is_block(name) or "block_carry" in name
                or "assemble_bf16" in name or "Li36E" in name
                or "Li38E" in name or "Li54E" in name
                or "Li52E" in name):
            out[name] = v
    return out


def print_table(log: str) -> dict:
    table = new_instantiations(log)
    spill = {k: v for k, v in table.items() if v[1] or v[2]}
    regs = [v[0] for v in table.values()] or [0]
    print(f"BP3 block-form and bf16-state instantiations: {len(table)}, "
          f"registers {min(regs)}-{max(regs)}, spilling {len(spill)}")
    for name, (r, st, ld) in sorted(spill.items()):
        print(f"  ptxas {name[:100]} regs {r} spill {st}/{ld}")
    return table


def main(argv: list[str] | None = None) -> int:
    from mf_data_locality_tpu_torch.ops import _build
    from mf_data_locality_tpu_torch.utils import timing

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--degrees", default=",".join(map(str, DEGREES)))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bp3_ranks_check: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib, log = _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    print_table(log or lib.with_suffix(".log").read_text())
    t0 = time.perf_counter()
    try:
        report(compare_all(dev, tuple(int(p) for p in
                                      args.degrees.split(",")), quiet=False))
        print(f"compare {time.perf_counter() - t0:.1f} s")
        if args.time:
            sys.path.insert(0, ".")
            import chip_smoke

            time_all(dev, lambda k, p: chip_smoke.time_pair(k, p, dev,
                                                            timing),
                     chip_smoke.bound)
    except CheckFailed as e:
        print(f"FAILED: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
