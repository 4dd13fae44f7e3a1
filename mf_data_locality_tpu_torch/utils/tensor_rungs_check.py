"""Checks of the tensor-core rungs' twostage pass at p=1..3 and of their
dense pass with the metric rebuilt by the jtj chain, on a card.

    python -m mf_data_locality_tpu_torch.utils.tensor_rungs_check [--time]

Builds the kernels, prints the registers and spills of the new
instantiations (``csrc/cell_mma_p01.cu`` .. ``p03.cu``, ``cell_mma_sb.cu``
at p=1..3; the dense passes' ``kJtjChain`` forms, ``csrc/mma_jtj.cu`` and
``apply_mma_pNN.cu``), then on the 3 x 5 x 7 box (105 cells, not
a multiple of any pass's cells) holds each against its plain version under
split2m, split3 and bf16 (the bf16 rung with the bf16 state and the bf16
metric, as ``bench.py``'s bf16 line runs it):

* B1 and B2 in twostage at p=1..3 with the metric streamed, rebuilt by
  adjj and rebuilt by jtj (``cell_mma_hd.cuh``);
* B1 and B2 dense with the metric rebuilt by jtj at :data:`JTJ_DEGREES`
  (``apply_mma.cuh`` to p=4, ``apply_mma_hd.cuh`` from p=5);
* in each of those configurations B2 with P or x in bf16
  (``storage_check.compare``: x' bitwise the f32-x kernel's, P against
  its plain version with the unrounded-P control missing); their storage
  instantiations (a bf16 state under split2m and split3, the bf16 metric
  under split2m) are ``bf16_state_check.compare_all``'s, which takes
  every configuration of ``laplace_cuda.fused_configs`` with either chain;
* B5 on the twostage operator of the merged solver's ``--factor twostage
  --windowing pieces`` at :data:`B5_DEGREES` (the dense tables).

f32 rungs: max relative 1e-5 (B2's scalars 1e-4); bf16: relative L2 3e-4
and max 1e-2, the scalars 1e-4, and the plain version with split2m's
product set in place of bf16's (``bf16_check.control_op``) must miss the
L2 limit, and so must the scalars from sums over the unrounded d'
(``bf16_check.rounding_point``).  ``--time``: B1/B2 twostage split2m at p=3
s=14 beside the auto path's dense configuration there, and B1/B2 dense +
onthefly + jtj split2m at p=4 s=13 beside adjj, each with its plain
version and bound (``chip_smoke.py``'s).  Exits 1 when a check fails.
``chip_smoke.py`` runs :func:`compare_all` and :func:`time_all` in its
section 10.
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
from mf_data_locality_tpu_torch.utils import storage_check

BF = torch.bfloat16
RAGGED = (3, 5, 7)
RUNGS = laplace_cuda.TENSOR_RUNGS
TWOSTAGE_DEGREES = (1, 2, 3)
# (metric, cofactor) of the twostage checks
TWOSTAGE_CONFIGS = (("precomputed", "adjj"), ("onthefly", "adjj"),
                    ("onthefly", "jtj"))
JTJ_DEGREES = (1, 2, 3, 4, 5, 8, 11)
B5_DEGREES = (2, 4)
# kernel vs plain: f32 max relative, B2's scalars; bf16 relative L2, max
TOL_F32, TOL_SCAL, TOL_BF16 = 1e-5, 1e-4, (3e-4, 1e-2)
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]


class CheckFailed(AssertionError):
    pass


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


def rung_storage(rung: str) -> tuple[torch.dtype, torch.dtype | None]:
    """(state dtype, metric dtype) a rung is checked with: the bf16 rung
    with the bf16 state and metric, the others at f32."""
    return (BF, BF) if rung == "bf16" else (torch.float32, None)


def make_op(p: int, rung: str, factor: str, metric: str, cofactor: str,
            dev, layout=None):
    """The fused solver's operator of one configuration on ``layout``
    (default: the box), at the rung's storage."""
    state, mdt = rung_storage(rung)
    return laplace_cuda.make_operator(
        layout or DofLayout(BoxMesh(RAGGED, 0.25), p), state, rung,
        factor=factor, metric=metric, cofactor=cofactor,
        windowing="pieces", device=dev,
        metric_dtype=mdt if metric == "precomputed" else None)


def fused_cases(op, seed: int):
    """{name: (kernel call, plain call)} of B1 and B2 on ``op`` with random
    state, d and h stored at the rung's storage; "control": the plain
    versions with split2m's product set in place of the rung's."""
    store = rung_storage(op.precision)[0]
    d, x, g, dd, h = bf16_check.state(op, 5, seed)
    d, dd, h = (t.to(store).contiguous() for t in (d, dd, h))
    prec = ((bf16_check.state(op, 1, 5)[0][:1].abs() + 0.5)
            * op.mask).contiguous()
    scal = torch.tensor(SCAL, device=op.device)
    work, out = fk.Workspace(op), torch.empty_like(d)
    bufs = tuple(torch.empty_like(t) for t in (x, g, dd, h, scal))
    return {
        "matvec": (lambda: fk.matvec(op, d, out=out, work=work),
                   lambda: fk._matvec_plain(op, d)),
        "fused_cg_iteration": (
            lambda: fk.fused_cg_iteration(op, x, g, dd, h, scal, prec,
                                          out=bufs, work=work),
            lambda: fk._fused_iteration_plain(op, x, g, dd, h, scal, prec)),
        "control": (
            lambda: fk._matvec_plain(bf16_check.control_op(op), d),
            lambda: fk._fused_iteration_plain(bf16_check.control_op(op), x,
                                              g, dd, h, scal, prec))}


def fused_readings(op, seed: int, tag: str, quiet: bool = True) -> dict:
    """B1 and B2 on ``op`` against their plain versions, held to the
    rung's limits (module docstring); returns {kind: reading}."""
    cases = fused_cases(op, seed)
    out = {}
    for i, name in enumerate(("matvec", "fused_cg_iteration")):
        kern, plain = cases[name]
        got, want = kern(), plain()
        vec = list(zip(got[:4], want[:4])) if i else [(got, want)]
        if op.precision != "bf16":
            out[name] = max(bf16_check.rel(a, b) for a, b in vec)
            _hold(f"{name} {tag}", out[name], TOL_F32, quiet=quiet)
        else:
            ctl = cases["control"][i]()
            ctl = list(ctl[:4]) if i else [ctl]
            out[name] = max(bf16_check.l2(a, b) for a, b in vec)
            out[name + " control"] = max(
                bf16_check.l2(a, c) for (a, _), c in zip(vec, ctl))
            _hold(f"{name} {tag} rel L2", out[name], TOL_BF16[0],
                  out[name + " control"], quiet)
            _hold(f"{name} {tag} max", max(bf16_check.rel(a, b)
                                           for a, b in vec), TOL_BF16[1],
                  quiet=quiet)
        if i:
            out["scal"] = bf16_check.scal_err(got[4].double(),
                                              want[4].double())
            _hold(f"{name} {tag} scal", out["scal"], TOL_SCAL, quiet=quiet)
    if op.precision == "bf16":
        err, unrounded = bf16_check.rounding_point(op, seed + 7)
        _hold(f"fused_cg_iteration {tag} rounding point", err, TOL_SCAL,
              unrounded, quiet)
    return out


def px_readings(op, tag: str, quiet: bool = True) -> None:
    """B2 with P or x in bf16 on ``op`` (``storage_check.compare``)."""
    store = rung_storage(op.precision)[0]
    tol = (TOL_BF16[0], TOL_SCAL) if op.precision == "bf16" else (TOL_F32,
                                                                  TOL_F32)
    ok, rep = storage_check.compare(op, op.device, store, tol)
    if not quiet:
        print(f"  B2 P/x bf16 {tag}: {rep}")
    if not ok:
        raise CheckFailed(f"B2 P/x bf16 {tag}: {rep}")


def b5_readings(p: int, rung: str, dev, quiet: bool = True) -> float:
    """B5 on the merged solver's twostage operator (``--factor twostage
    --windowing pieces``) against its plain version."""
    op = make_op(p, rung, "twostage", "precomputed", "adjj", dev)
    u = bf16_check.state(op, 1, 60 + p)[0].to(rung_storage(rung)[0])
    got = la.apply_lattice_pieces(op, u)
    want = la._lattice_plain(op, u, la._index_mask(op))
    tag = f"apply_lattice_pieces p={p} {rung} twostage"
    if rung != "bf16":
        err = bf16_check.rel(got, want)
        _hold(tag, err, TOL_F32, quiet=quiet)
        return err
    ctl = la._lattice_plain(bf16_check.control_op(op), u, la._index_mask(op))
    err = bf16_check.l2(got, want)
    _hold(f"{tag} rel L2", err, TOL_BF16[0], bf16_check.l2(got, ctl), quiet)
    return err


def compare_all(dev, quiet: bool = True) -> dict:
    """Every check of the module docstring; returns the largest reading of
    each (family, rung, kernel), and raises :class:`CheckFailed` on the
    first failure."""
    worst: dict = {}

    def note(key, r):
        for k, v in r.items():
            if not k.endswith("control"):
                worst[key + (k,)] = max(worst.get(key + (k,), 0.0), v)
            else:
                k2 = key + (k,)
                worst[k2] = min(worst.get(k2, float("inf")), v)

    cases = [("twostage", p, m, c) for p in TWOSTAGE_DEGREES
             for m, c in TWOSTAGE_CONFIGS]
    cases += [("dense", p, "onthefly", "jtj") for p in JTJ_DEGREES]
    for factor, p, metric, cofactor in cases:
        for rung in RUNGS:
            tag = f"p={p} {rung} {factor} {metric} {cofactor}"
            op = make_op(p, rung, factor, metric, cofactor, dev)
            note((factor, rung), fused_readings(op, 10 + p, tag, quiet))
            px_readings(op, tag, quiet)
    for p in B5_DEGREES:
        for rung in RUNGS:
            note(("B5 twostage", rung),
                 {"apply_lattice_pieces": b5_readings(p, rung, dev, quiet)})
    return worst


def report(worst: dict) -> None:
    for key, v in sorted(worst.items()):
        print(f"  {' '.join(key)}: " + (f"smallest {v:.3e}"
                                        if key[-1].endswith("control")
                                        else f"largest {v:.3e}"))


# the timed configurations: (key suffix of the kernels line, p, s, factor,
# metric, cofactor); None: the fused auto path's at (p, s)
TIMED = (("_twostage_split2m_p3", 3, 14, "twostage", None, None),
         ("_auto_split2m_p3", 3, 14, None, None, None),
         ("_dense_jtj_split2m", 4, 13, "dense", "onthefly", "jtj"),
         ("_dense_adjj_split2m", 4, 13, "dense", "onthefly", "adjj"))


def timed_config(p: int, factor, metric, cofactor) -> tuple[str, str, str]:
    """(factor, metric, cofactor) of a :data:`TIMED` row as
    ``benchmark.resolve_config`` gives it under split2m."""
    from mf_data_locality_tpu_torch import benchmark

    kw = {k: v for k, v in (("factor", factor), ("metric", metric),
                            ("cofactor", cofactor)) if v is not None}
    return benchmark.resolve_config(p, "fused", "pieces", "split2m",
                                    torch.float32, **kw)


def time_all(dev, time_pair, bound) -> dict:
    """B1 and B2 of each :data:`TIMED` row against their plain versions
    (compared first) and beside their bounds (``time_pair(kern, plain)`` ->
    (kernel ms, plain ms) and ``bound``: ``chip_smoke.py``'s): {(name,
    suffix): ((kernel ms, plain ms), (bound ms, bound by), max |diff|,
    (factor, metric, cofactor))}."""
    out = {}
    for sfx, p, s, *config in TIMED:
        config = timed_config(p, *config)
        op = make_op(p, "split2m", *config, dev,
                     layout=DofLayout(BoxMesh.from_s(s), p))
        tag = f"p={p} s={s} split2m {' '.join(config)}"
        cases = fused_cases(op, 40)
        for name in ("matvec", "fused_cg_iteration"):
            kern, plain = cases[name]
            got, want = kern(), plain()
            if name == "fused_cg_iteration":
                got, want = list(got[:4]), list(want[:4])
            else:
                got, want = [got], [want]
            err = max(bf16_check.rel(a, b) for a, b in zip(got, want))
            _hold(f"{name} {tag}", err, TOL_F32)
            diff = max((a - b).abs().max().item() for a, b in zip(got, want))
            t = time_pair(kern, plain)
            b = bound(name, op, split=True)
            print(f"  {name} {tag}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} "
                  f"ms, bound {b[0]:.4f} ms ({b[1]}), share "
                  f"{b[0] / t[0]:.3f}")
            out[(name, sfx)] = t, b, diff, config
        del op, cases
        torch.cuda.empty_cache()
    return out


# the new instantiations' names in a build log: the twostage pass at
# p=1..3, the dense passes with the jtj chain (kJtjChain in NP)
_NEW = (r"cells_mma_hd_kernelILi[123]E",
        r"apply_mma_kernelILi\d+ELi\d+ELb1ELi(?:1[6-9]|2[0-9])E",
        r"dense_hd_forward_kernelILi\d+ELb1ELi(?:1[6-9]|2[0-9])E")


def new_table(log: str) -> dict[str, tuple[int, int, int]]:
    """{kernel: (registers, spill store, spill load bytes)} of this
    module's instantiations in a ``-Xptxas -v`` build log."""
    return {k: v for k, v in storage_check.ptxas_table(log).items()
            if any(re.search(f, k) for f in _NEW)}


def main(argv: list[str] | None = None) -> int:
    from mf_data_locality_tpu_torch.ops import _build
    from mf_data_locality_tpu_torch.utils import timing

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tensor_rungs_check: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib, log = _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    log = log or lib.with_suffix(".log").read_text()  # built before
    table = new_table(log)
    spill = {k: v for k, v in table.items() if v[1] or v[2]}
    print(f"new instantiations: {len(table)}, registers "
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
