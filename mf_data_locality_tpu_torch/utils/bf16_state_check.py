"""Checks of bf16 storage on a card: the bf16 state on every rung, the bf16
metric under highest and split2m, and the f32 carry of B2's block form.

    python -m mf_data_locality_tpu_torch.utils.bf16_state_check [--time]

Builds the kernels, prints the registers and spills of the storage
instantiations (the passes' ``kSbState``/``kSbMetric`` forms, which
``csrc/sumfac_sb.cu``, ``mma_sb.cu``, ``apply_mma_sb.cu`` and
``cell_mma_sb.cu`` build), then on the 3 x 5 x 7 box at every degree of
:data:`DEGREES` holds each against its plain version:

* the apply family with a bf16 state (B3, B4 on reshape, B5 on pieces, B6
  on zslab) on every rung, the metric streamed in f32 or bf16: relative L2
  within :data:`LIMIT_L2`, and the control — the plain version without
  the bf16 store, its f32 result — outside it;
* B1 and B2 with a bf16 state under highest, split2m and split3 in every
  configuration of ``laplace_cuda.fused_configs`` (the metric rebuilt by
  either chain): the vectors within
  :data:`LIMIT_L2` and B2's scalars within :data:`LIMIT_SCAL`; controls,
  B1 without the store of h and B2's scalars from sums over the unrounded
  d' (``bf16_check.rounding_point``);
* a bf16 metric with an f32 state under highest and split2m (B1/B2
  streamed, B3/B5/B6): within :data:`TOL_F32` (max relative), and the
  plain version with the f32 metric outside it;
* C10: B2's block form with a bf16 state on the lower of two z-slabs (the
  top z face owed upward) under each rung: its f32 carry (``work.carry``)
  within :data:`TOL_F32` of the plain version's, and the face as stored
  in h' (rounded to bf16, the carry before the repair) outside it.

``--time``: at p=4 s=13 each storage instantiation of the slice's paths
timed beside its plain version and the bound of its work (2-byte state
words; ``chip_smoke.bound``'s arithmetic), in turns plain, kernel, kernel,
plain.  Exits 1 when a check fails.  ``chip_smoke.py`` runs
:func:`compare_all` and :func:`time_all` in its section 9.
"""

from __future__ import annotations

import argparse
import re
import sys
import time

import torch

from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.ops import laplace_cuda
from mf_data_locality_tpu_torch.utils import bf16_check

BF = torch.bfloat16
# kernel vs plain: bf16 vectors relative L2, B2's scalars max relative
# (bf16_check's limits); f32 values max relative
LIMIT_L2, LIMIT_SCAL, TOL_F32 = 3e-4, 1e-4, 1e-5
RAGGED = (3, 5, 7)
DEGREES = (1, 2, 3, 4, 5, 8, 11)
RUNGS = ("highest", "split2m", "split3", "bf16")
# the bf16 metric comes with its own instantiations under these two (the
# other rungs read it by their runtime flag, as before)
METRIC_RUNGS = ("highest", "split2m")
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]


class CheckFailed(AssertionError):
    pass


def _l2(got, want) -> float:
    return bf16_check.l2(got.float(), want.float())


def _rel(got, want) -> float:
    return bf16_check.rel(got.float(), want.float())


def _hold(tag: str, err: float, limit: float, ctl: float | None = None,
          quiet: bool = True) -> None:
    """Raise unless ``err`` <= ``limit`` < ``ctl`` (the control misses)."""
    line = f"  {tag}: {err:.3e} (limit {limit:.0e})" + (
        "" if ctl is None else f", control {ctl:.3e}")
    if not quiet:
        print(line)
    if not err <= limit or (ctl is not None and not ctl > limit):
        raise CheckFailed(f"{line}: outside the limit, or the control "
                          f"within it")


def _layout(p: int) -> DofLayout:
    return DofLayout(BoxMesh(RAGGED, 0.25), p)


def _vec(op, seed: int, store=torch.float32, n_comp: int = 3
         ) -> torch.Tensor:
    (v,) = bf16_check.state(op, 1, seed, n_comp)
    return v.to(store).contiguous()


def apply_case(op, kernel: str, seed: int, state=BF,
               ctl_op=None, n_comp: int = 3) -> tuple[float, float]:
    """(kernel vs plain, control vs plain) of one apply-family kernel on a
    random u stored at ``state``: relative L2 for a bf16 state (the
    control the plain version's f32 result, without the store), max
    relative otherwise (the control the plain version on ``ctl_op``, the
    operator with the f32 metric); vectors of ``n_comp`` components."""
    p = op.degree
    u = _vec(op, seed, state, n_comp)
    ctl_op = op if ctl_op is None else ctl_op
    if kernel in ("batched_g", "batched_onthefly"):
        u_loc = la.to_cell_batches(u, p).contiguous()
        rung = kernel == "batched_g"
        wrap = (la.apply_local_batched_g if rung
                else la.apply_local_batched_onthefly)
        got = wrap(op, u_loc)
        want = la._batched_plain(op, u_loc, la._metric(op), rung)
        ctl = la._batched_plain(ctl_op, u_loc, la._metric(ctl_op), rung,
                                store=False)
    else:
        mask = la._index_mask(op) if kernel == "pieces" else op.mask
        wrap = (la.apply_lattice_pieces if kernel == "pieces"
                else la.apply_lattice_zslab)
        got = wrap(op, u)
        want = la._lattice_plain(op, u, mask, kernel == "pieces")
        ctl = la._lattice_plain(ctl_op, u.to(op.dtype) if state == BF
                                else u, mask, kernel == "pieces")
    if state == BF:
        assert got.dtype == BF and want.dtype == BF
        return _l2(got, want), _l2(ctl, want)
    return _rel(got, want), _rel(ctl, want)


def fused_case(op, seed: int, state=BF, ctl_op=None,
               n_comp: int = 3) -> dict:
    """B1 and B2 on ``op`` with d and h stored at ``state``: their readings
    against the plain versions and the controls' (module docstring;
    ``ctl_op``, with an f32 state, the operator with the f32 metric), on
    vectors of ``n_comp`` components."""
    prec = ((_vec(op, seed)[:1].abs() + 0.5) * op.mask).contiguous()
    d = _vec(op, seed + 1, state, n_comp)
    got = fk.matvec(op, d)
    want = fk._matvec_plain(op, d)
    out = {}
    if state == BF:
        out["B1"] = (_l2(got, want), _l2(fk._matvec_plain(op, d.float()),
                                         want))
    else:
        out["B1"] = (_rel(got, want), _rel(fk._matvec_plain(ctl_op, d),
                                           want))
    x, g = (_vec(op, seed + k, n_comp=n_comp) for k in (2, 3))
    dd, h = (_vec(op, seed + k, state, n_comp) for k in (4, 5))
    scal = torch.tensor(SCAL, device=op.device)
    k = fk.fused_cg_iteration(op, x, g, dd, h, scal, prec)
    w = fk._fused_iteration_plain(op, x, g, dd, h, scal, prec)
    err = (_l2 if state == BF else _rel)
    out["B2"] = max(err(a, b) for a, b in zip(k[:4], w[:4]))
    out["B2 scal"] = bf16_check.scal_err(k[4].double(), w[4].double())
    if state == BF:
        out["rounding point"] = bf16_check.rounding_point(op, seed + 6,
                                                          n_comp)
    else:
        c = fk._fused_iteration_plain(ctl_op, x, g, dd, h, scal, prec)
        out["B2 control"] = max(_rel(a, b) for a, b in zip(c[:4], w[:4]))
    return out


def _hold_fused(tag: str, r: dict, state, quiet: bool) -> None:
    if state == BF:
        _hold(f"B1 {tag}", r["B1"][0], LIMIT_L2, r["B1"][1], quiet)
        _hold(f"B2 {tag}", r["B2"], LIMIT_L2, quiet=quiet)
        _hold(f"B2 scal {tag}", r["B2 scal"], LIMIT_SCAL, quiet=quiet)
        err, unrounded = r["rounding point"]
        _hold(f"B2 rounding point {tag}", err, LIMIT_SCAL, unrounded, quiet)
    else:
        _hold(f"B1 {tag}", r["B1"][0], TOL_F32, r["B1"][1], quiet)
        _hold(f"B2 {tag}", r["B2"], TOL_F32, r["B2 control"], quiet)
        _hold(f"B2 scal {tag}", r["B2 scal"], LIMIT_SCAL, quiet=quiet)


def carry_case(p: int, rung: str, metric: str, dev, seed: int,
               s: int = 5, n_comp: int = 3) -> tuple[float, float]:
    """C10 on the lower of two z-slabs of 2^s cells, vectors of ``n_comp``
    components: (the kernel's f32 carry vs the plain version's, the face
    as stored in h' vs the plain carry), max relative."""
    from mf_data_locality_tpu_torch.parallel import distributed

    op = distributed.build_slab(s, p, 0, 2, BF, "pallas", rung, "pieces",
                                metric, dev, n_components=n_comp).op
    prec = ((_vec(op, seed)[:1].abs() + 0.5) * op.mask).contiguous()
    x, g = (_vec(op, seed + k, n_comp=n_comp) for k in (1, 2))
    d, h = (_vec(op, seed + k, BF, n_comp) for k in (3, 4))
    scal = torch.tensor(SCAL, device=dev)
    work = fk.Workspace(op, n_comp)
    out = fk.fused_cg_iteration(op, x, g, d, h, scal, prec, work=work)
    plain = torch.empty_like(work.carry)
    fk._fused_iteration_plain(op, x, g, d, h, scal, prec, carry=plain)
    return _rel(work.carry, plain), _rel(out[3][:, -1], plain)


# the template argument that holds the storage flags, per pass: SB of the
# sum-factorized pass, NP (the rung's products and the flags) of the others
_FLAGS = (r"apply_sumfac_kernelI[fd]Li\d+ELi\d+ELb[01]ELi(\d+)E",
          r"apply_mma_kernelILi\d+ELi\d+ELb[01]ELi(\d+)E",
          r"dense_hd_gather_kernelILi\d+ELi\d+ELi(\d+)E",
          r"dense_hd_(?:forward|backward)_kernelILi\d+ELb[01]ELi(\d+)E",
          r"cells_mma_kernelILi\d+ELb[01]ELi\d+ELi(\d+)E",
          r"cells_mma_hd_kernelILi\d+ELb[01]ELb[01]ELi\d+ELi(\d+)E")


def storage_table(log: str) -> dict[str, tuple[int, int, int]]:
    """{kernel: (registers, spill store bytes, spill load bytes)} of the
    storage instantiations in a build log (``-Xptxas -v``): the passes
    whose flags argument holds kSbState or kSbMetric, the bf16 assemble
    and the carry passes."""
    from mf_data_locality_tpu_torch.utils.storage_check import ptxas_table

    out = {}
    for name, regs in ptxas_table(log).items():
        m = next((m for m in (re.search(f, name) for f in _FLAGS) if m),
                 None)
        if ("assemble_bf16" in name or "block_carry" in name
                or (m and int(m[1]) >= 4)):
            out[name] = regs
    return out


def compare_all(dev, quiet: bool = True, degrees=DEGREES,
                carry_degrees=(4,)) -> dict:
    """Every check of the module docstring on the box at ``degrees`` (C10
    at ``carry_degrees``); returns the largest reading and the smallest
    control of each kind, and raises :class:`CheckFailed` on the first
    failure."""
    worst: dict = {}

    def note(key, err, ctl=None):
        e, c = worst.get(key, (0.0, float("inf")))
        worst[key] = (max(e, err), min(c, ctl if ctl is not None else c))

    for p in degrees:
        layout = _layout(p)
        for rung in RUNGS:
            for mdt in ((None, BF) if rung in METRIC_RUNGS else (None,)):
                for kernel, windowing, metric in (
                        ("batched_g", "reshape", "precomputed"),
                        ("batched_onthefly", "reshape", "onthefly"),
                        ("pieces", "pieces", "precomputed"),
                        ("zslab", "zslab", "precomputed")):
                    # B4 ignores the rung: one instantiation serves all
                    if metric == "onthefly" and (mdt is not None
                                                 or rung != "highest"):
                        continue
                    for state in (BF,) + ((torch.float32,) if mdt else ()):
                        op, ctl_op = (laplace_cuda.make_operator(
                            layout, state, rung, factor="dense",
                            metric=metric, windowing=windowing, device=dev,
                            metric_dtype=m) for m in (mdt, None))
                        err, ctl = apply_case(op, kernel, 10 + p, state,
                                              ctl_op)
                        tag = (f"{kernel} p={p} {rung} state "
                               f"{str(state)[6:]} metric "
                               f"{str(op.metric_dtype)[6:]}")
                        _hold(tag, err, LIMIT_L2 if state == BF else TOL_F32,
                              ctl, quiet)
                        note((kernel, rung, str(state)[6:]), err, ctl)
            for factor, metric in laplace_cuda.fused_configs(rung, p):
                cofactors = (("adjj", "jtj") if metric == "onthefly"
                             else ("adjj",))
                for cofactor in cofactors:
                    combos = [(BF, None)]
                    if rung in METRIC_RUNGS and metric == "precomputed":
                        combos += [(BF, BF), (torch.float32, BF)]
                    elif rung == "bf16":
                        continue  # the bf16 rung's state: not new here
                    for state, mdt in combos:
                        op, ctl_op = (laplace_cuda.make_operator(
                            layout, state, rung, factor=factor,
                            metric=metric, cofactor=cofactor,
                            windowing="pieces", device=dev,
                            metric_dtype=m) for m in (mdt, None))
                        tag = (f"p={p} {rung} {factor} {metric} {cofactor} "
                               f"state {str(state)[6:]} metric "
                               f"{str(op.metric_dtype)[6:]}")
                        r = fused_case(op, 30 + p, state, ctl_op)
                        _hold_fused(tag, r, state, quiet)
                        note(("B1", rung, str(state)[6:]), *r["B1"])
                        note(("B2", rung, str(state)[6:]), r["B2"])
                        note(("B2 scal", rung, str(state)[6:]),
                             r["B2 scal"])
    for p in carry_degrees:
        for rung in RUNGS:
            for metric in ("precomputed", "onthefly"):
                err, ctl = carry_case(p, rung, metric, dev, 50 + p)
                _hold(f"C10 carry p={p} {rung} {metric}", err, TOL_F32, ctl,
                      quiet)
                note(("C10 carry", rung, "bfloat16"), err, ctl)
    return worst


def report(worst: dict) -> None:
    for (kind, rung, state), (err, ctl) in sorted(worst.items()):
        print(f"  {kind} {rung} state {state}: largest {err:.3e}"
              + ("" if ctl == float("inf") else f", control >= {ctl:.3e}"))


# the timed storage instantiations at p=4 s=13: (key suffix of the kernels
# line, kernel, rung, state dtype, metric dtype, fused configuration or
# windowing)
TIMED = (
    ("_bf16state", "apply_local_batched_g", "highest", BF, None, "reshape"),
    ("_bf16state", "apply_lattice_pieces", "highest", BF, None, "pieces"),
    ("_bf16state", "apply_lattice_zslab", "highest", BF, None, "zslab"),
    ("_bf16metric", "apply_local_batched_g", "highest", torch.float32, BF,
     "reshape"),
    ("_bf16metric_split2m", "apply_local_batched_g", "split2m",
     torch.float32, BF, "reshape"),
    ("_bf16state", "fused_cg_iteration", "highest", BF, None, "auto"),
    ("_bf16state_split2m", "fused_cg_iteration", "split2m", BF, None,
     "auto"),
    ("_bf16metric", "fused_cg_iteration", "highest", torch.float32, BF,
     "dense"),
    ("_bf16metric_split2m", "fused_cg_iteration", "split2m", torch.float32,
     BF, "dense"),
)


def timed_op(name, rung, state, mdt, where, s: int, dev):
    """The operator of a :data:`TIMED` row at p=4 and 2^s cells: the
    fused solver's as ``benchmark.resolve_config`` gives it (``auto``), or
    dense with the metric streamed; the apply family's on its
    windowing."""
    from mf_data_locality_tpu_torch import benchmark

    p = 4
    layout = DofLayout(BoxMesh.from_s(s), p)
    if name == "fused_cg_iteration":
        if where == "auto":
            factor, metric, cofactor = benchmark.resolve_config(
                p, "fused", "pieces", rung, state, metric_dtype=mdt)
        else:
            factor, metric, cofactor = "dense", "precomputed", "adjj"
        return laplace_cuda.make_operator(
            layout, state, rung, factor=factor, metric=metric,
            cofactor=cofactor, windowing="pieces", device=dev,
            metric_dtype=mdt)
    return laplace_cuda.make_operator(
        layout, state, rung, factor="dense", metric="precomputed",
        windowing=where, device=dev, metric_dtype=mdt)


def time_all(dev, time_pair, bound, s: int = 13) -> dict:
    """Each :data:`TIMED` row's kernel at p=4 and 2^s cells against its
    plain version (compared first) and beside its bound (``time_pair(kern,
    plain)`` -> (kernel ms, plain ms) and ``bound``: ``chip_smoke.py``'s):
    {(name, suffix): ((kernel ms, plain ms), (bound ms, bound by), max
    |diff|, tag)}."""
    out = {}
    for sfx, name, rung, state, mdt, where in TIMED:
        op = timed_op(name, rung, state, mdt, where, s, dev)
        split = rung in laplace_cuda.TENSOR_RUNGS
        tag = (f"p=4 s={s} {rung} {op.factor} {op.metric} state "
               f"{str(state)[6:]} metric {str(op.metric_dtype)[6:]}")
        if name == "fused_cg_iteration":
            prec = ((_vec(op, 5)[:1].abs() + 0.5) * op.mask).contiguous()
            x, g = (_vec(op, k) for k in (1, 2))
            d, h = (_vec(op, k, state) for k in (3, 4))
            scal = torch.tensor(SCAL, device=dev)
            bufs = tuple(torch.empty_like(t) for t in (x, g, d, h, scal))
            work = fk.Workspace(op)
            k = fk.fused_cg_iteration(op, x, g, d, h, scal, prec)
            w = fk._fused_iteration_plain(op, x, g, d, h, scal, prec)
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(k[:4], w[:4]))
            err = max((_l2 if state == BF else _rel)(a, b)
                      for a, b in zip(k[:4], w[:4]))
            t = time_pair(
                lambda: fk.fused_cg_iteration(op, x, g, d, h, scal, prec,
                                              out=bufs, work=work),
                lambda: fk._fused_iteration_plain(op, x, g, d, h, scal,
                                                  prec))
            b = bound(name, op, split, state=state)
        else:
            p = op.degree
            u = _vec(op, 7, state)
            if name == "apply_local_batched_g":
                u_loc = la.to_cell_batches(u, p).contiguous()
                kern = lambda: la.apply_local_batched_g(op, u_loc)  # noqa
                plain = lambda: la._batched_plain(  # noqa: E731
                    op, u_loc, la._metric(op), True)
            else:
                mask = (la._index_mask(op) if name == "apply_lattice_pieces"
                        else op.mask)
                fn = getattr(la, name)
                kern = lambda: fn(op, u)  # noqa: E731
                plain = lambda: la._lattice_plain(op, u, mask)  # noqa: E731
            got, want = kern(), plain()
            diff = (got.float() - want.float()).abs().max().item()
            err = (_l2 if state == BF else _rel)(got, want)
            t = time_pair(kern, plain)
            b = bound(name, op, split, state=state)
        _hold(f"{name} {tag}", err, LIMIT_L2 if state == BF else TOL_F32,
              quiet=True)
        print(f"  {name} {tag}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, "
              f"bound {b[0]:.4f} ms ({b[1]}); "
              f"{'rel L2' if state == BF else 'max rel'} {err:.3e}")
        out[(name, sfx)] = t, b, diff, tag
        del op
        torch.cuda.empty_cache()
    return out


def main(argv: list[str] | None = None) -> int:
    from mf_data_locality_tpu_torch.ops import _build
    from mf_data_locality_tpu_torch.utils import timing

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bf16_state_check: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib, log = _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    log = log or lib.with_suffix(".log").read_text()  # built before
    table = storage_table(log)
    spill = {k: v for k, v in table.items() if v[1] or v[2]}
    print(f"storage instantiations: {len(table)}, registers "
          f"{min(v[0] for v in table.values())}-"
          f"{max(v[0] for v in table.values())}, spilling {len(spill)}")
    for name, (regs, st, ld) in sorted(spill.items()):
        print(f"  ptxas {name[:96]} regs {regs} spill {st}/{ld}")
    t0 = time.perf_counter()
    try:
        worst = compare_all(dev, quiet=False)
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
