"""Checks of split2m's f64 form (the JAX CLI's ``--dtype f64 --precision
split2m``) on a card.

    python -m mf_data_locality_tpu_torch.utils.f64_split2m_check [--time]

Builds the kernels, prints the registers and spills of the f64 form's
instantiations (``csrc/mma_f64.cu``: ``kF64`` in NP, bp4_operator.cuh),
then at every degree 1..11 on the 3 x 5 x 7 box (105 cells, not a
multiple of any pass's cells) holds each against its plain version at
f64 split2m:

* B3 (``reshape``), B5 (``pieces``) and B6 (``zslab``) on the merged
  solver's operator, the dense pass of ``apply_mma_hd.cuh`` with the
  products' chains summed in f64 (``laplace_pallas._mm``);
* B1 and B2 in every fused configuration (``laplace_cuda.
  fused_configs``: dense and twostage, the metric streamed, rebuilt by
  adjj and rebuilt by jtj), the dense pass of ``apply_mma_hd.cuh`` and the
  twostage pass of ``cell_mma_hd.cuh``, the chains summed in f32
  (``cg_fused_kernel._mm_pre``).

Limits: relative L2 :data:`TOL` against the plain version (B2: x', g',
d', h' and the 8 scalars), and the plain version of the f64 ``highest``
operator of the same configuration, the control, differs from the
kernel's output (B3-B6's v, B1's h, B2's h') by at least :data:`CONTROL`.
``--time``: B3, B5 and B6 (the merged solver's ``--windowing reshape``,
``pieces`` and ``zslab``) and B1/B2 (the fused solver's auto path,
twostage + onthefly + adjj) at p=4 s=13, each held against its plain
version (:data:`TOL`) and timed beside it, its bound (``chip_smoke.py``'s)
and the kernel of its f64 ``highest`` twin (the same configuration under
highest: the sum-factorized pass).  Exits 1 when a check fails.
``chip_smoke.py`` runs :func:`compare_all` and :func:`time_all` in its
section 13.
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
from mf_data_locality_tpu_torch.utils import bf16_check, storage_check

F64 = torch.float64
RAGGED = (3, 5, 7)
DEGREES = tuple(range(1, 12))
TOL, CONTROL = 1e-6, 1e-4
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]
# the apply family's kernels by windowing (the merged solver's operator)
APPLY = (("reshape", "apply_local_batched_g"),
         ("pieces", "apply_lattice_pieces"),
         ("zslab", "apply_lattice_zslab"))


class CheckFailed(AssertionError):
    pass


def _hold(tag: str, err: float, ctl: float | None = None,
          quiet: bool = True, failed: list | None = None) -> None:
    """Unless ``err`` <= TOL and, where given, ``ctl`` >= CONTROL: raise,
    or with ``failed`` append the line to it."""
    line = f"  {tag}: rel L2 {err:.3e} (limit {TOL:.0e})" + (
        "" if ctl is None else f", f64 highest control {ctl:.3e} (at "
                               f"least {CONTROL:.0e})")
    if not quiet:
        print(line)
    if not err <= TOL or (ctl is not None and not ctl >= CONTROL):
        line += ": outside the limit, or the control within it"
        if failed is None:
            raise CheckFailed(line)
        failed.append(line)


def make_op(p: int, factor: str, metric: str, cofactor: str,
            windowing: str, dev, precision: str = "split2m", layout=None):
    """The f64 operator of one configuration on ``layout`` (default: the
    box)."""
    return laplace_cuda.make_operator(
        layout or DofLayout(BoxMesh(RAGGED, 0.25), p), F64, precision,
        factor=factor, metric=metric, cofactor=cofactor,
        windowing=windowing, device=dev)


def apply_cases(op, name: str, seed: int):
    """(kernel call, plain call of ``op``'s kind) of one of B3/B5/B6 on a
    random lattice vector; the plain call takes the operator."""
    (u,) = bf16_check.state(op, 1, seed)
    if name == "apply_local_batched_g":
        x = la.to_cell_batches(u, op.degree).contiguous()
        return (lambda: la.apply_local_batched_g(op, x),
                lambda o: la._batched_plain(o, x, la._metric(o), True))
    if name == "apply_lattice_pieces":
        return (lambda: la.apply_lattice_pieces(op, u),
                lambda o: la._lattice_plain(o, u, la._index_mask(o), True))
    return (lambda: la.apply_lattice_zslab(op, u),
            lambda o: la._lattice_plain(o, u, o.mask, False))


def fused_cases(op, seed: int):
    """{name: (kernel call, plain call of an operator)} of B1 and B2 on
    ``op`` with random state."""
    d, x, g, dd, h = bf16_check.state(op, 5, seed)
    prec = ((bf16_check.state(op, 1, 5)[0][:1].abs() + 0.5)
            * op.mask).contiguous()
    scal = torch.tensor(SCAL, device=op.device, dtype=F64)
    work, out = fk.Workspace(op), torch.empty_like(d)
    bufs = tuple(torch.empty_like(t) for t in (x, g, dd, h, scal))
    return {
        "matvec": (lambda: fk.matvec(op, d, out=out, work=work),
                   lambda o: fk._matvec_plain(o, d)),
        "fused_cg_iteration": (
            lambda: fk.fused_cg_iteration(op, x, g, dd, h, scal, prec,
                                          out=bufs, work=work),
            lambda o: fk._fused_iteration_plain(o, x, g, dd, h, scal,
                                                prec))}


def readings(name: str, kern, plain, op, control_op, tag: str,
             quiet: bool = True,
             failed: list | None = None) -> tuple[float, float]:
    """``name``'s kernel against its plain version on ``op`` and against
    the control's (``control_op``, f64 highest) plain version, held
    (module docstring): (relative L2, the control's)."""
    got, want, ctl = kern(), plain(op), plain(control_op)
    if name == "fused_cg_iteration":
        err = max(bf16_check.l2(a, b) for a, b in zip(got, want))
        c = bf16_check.l2(got[3], ctl[3])  # h', the operator's output
    else:
        err, c = bf16_check.l2(got, want), bf16_check.l2(got, ctl)
    _hold(f"{name} {tag}", err, c, quiet, failed)
    return err, c


def compare_all(dev, quiet: bool = True, degrees=DEGREES,
                keep_going: bool = False) -> dict:
    """Every check of the module docstring at ``degrees``; returns the
    largest relative L2 and the smallest control of each (kernel,
    configuration), and raises :class:`CheckFailed` on the first
    failure, or with ``keep_going`` once all have run."""
    worst: dict = {}
    failed: list | None = [] if keep_going else None

    def note(key, err, ctl):
        worst[key] = (max(worst.get(key, (0.0,))[0], err),
                      min(worst.get(key, (0.0, float("inf")))[1], ctl))

    for p in degrees:
        for windowing, name in APPLY:
            op = make_op(p, "dense", "precomputed", "adjj", windowing, dev)
            ctl = make_op(p, "dense", "precomputed", "adjj", windowing, dev,
                          "highest")
            kern, plain = apply_cases(op, name, 20 + p)
            note((name, "dense precomputed"),
                 *readings(name, kern, plain, op, ctl,
                           f"p={p} {windowing}", quiet, failed))
        for factor, metric in laplace_cuda.fused_configs("split2m", p):
            for cofactor in (("adjj", "jtj") if metric == "onthefly"
                             else ("adjj",)):
                config = (factor, metric, cofactor)
                op = make_op(p, *config, "pieces", dev)
                ctl = make_op(p, *config, "pieces", dev, "highest")
                for name, (kern, plain) in fused_cases(op, 10 + p).items():
                    note((name, " ".join(config)),
                         *readings(name, kern, plain, op, ctl,
                                   f"p={p} {' '.join(config)}", quiet,
                                   failed))
        torch.cuda.empty_cache()
    if failed:
        raise CheckFailed("\n".join(failed))
    return worst


def report(worst: dict) -> None:
    for (name, config), (err, ctl) in sorted(worst.items()):
        print(f"  {name} {config}: largest rel L2 {err:.3e}, smallest "
              f"control {ctl:.3e}")


# the timed rows: (kernel, key suffix of the kernels line, p, s, solver,
# windowing)
TIMED = (("apply_local_batched_g", "_f64_split2m", 4, 13, "merged",
          "reshape"),
         ("apply_lattice_pieces", "_f64_split2m", 4, 13, "merged",
          "pieces"),
         ("apply_lattice_zslab", "_f64_split2m", 4, 13, "merged", "zslab"),
         ("matvec", "_f64_split2m", 4, 13, "fused", "pieces"),
         ("fused_cg_iteration", "_f64_split2m", 4, 13, "fused", "pieces"))


def time_all(dev, time_pair, bound) -> dict:
    """Each :data:`TIMED` row against its plain version (held first) and
    beside its bound and its f64 highest twin's kernel (``time_pair(kern,
    plain)`` -> (kernel ms, plain ms) and ``bound``: ``chip_smoke.py``'s):
    {(name, suffix): ((kernel ms, plain ms), (bound ms, bound by), max
    |diff|, (factor, metric, cofactor), twin kernel ms)}."""
    from mf_data_locality_tpu_torch import benchmark
    from mf_data_locality_tpu_torch.utils import timing

    out = {}
    for name, sfx, p, s, solver, windowing in TIMED:
        config = benchmark.resolve_config(p, solver, windowing, "split2m",
                                          F64)
        layout = DofLayout(BoxMesh.from_s(s), p)
        op = make_op(p, *config, windowing, dev, layout=layout)
        twin = make_op(p, *config, windowing, dev, "highest", layout)
        if solver == "merged":
            kern, plain = apply_cases(op, name, 40)
            twin_kern = apply_cases(twin, name, 40)[0]
        else:
            kern, plain = fused_cases(op, 40)[name]
            twin_kern = fused_cases(twin, 40)[name][0]
        got, want = kern(), plain(op)
        got, want = ((list(got), list(want)) if name == "fused_cg_iteration"
                     else ([got], [want]))
        err = max(bf16_check.l2(a, b) for a, b in zip(got, want))
        tag = f"p={p} s={s} f64 split2m {' '.join(config)}"
        _hold(f"{name} {tag}", err)
        diff = max((a - b).abs().max().item() for a, b in zip(got, want))
        t = time_pair(kern, lambda: plain(op))
        t_twin = timing.time_per_call(twin_kern, dev, inner=20) * 1e3
        b = bound(name, op, split=True)
        print(f"  {name} {tag}: rel L2 {err:.3e} (limit {TOL:.0e}); kernel "
              f"{t[0]:.4f} ms, plain {t[1]:.4f} ms, bound {b[0]:.4f} ms "
              f"({b[1]}), share {b[0] / t[0]:.3f}; f64 highest twin "
              f"{t_twin:.4f} ms")
        out[(name, sfx)] = t, b, diff, config, t_twin
        del op, twin
        torch.cuda.empty_cache()
    return out


# the f64 form's instantiations in a build log: kF64 (128) among the
# flags of the dense passes' NP and the twostage pass's
_F64 = re.compile(r"(dense_hd_\w+_kernel|cells_mma_hd_kernel)I.*"
                  r"Li(?:130|146|386)E")


def f64_table(log: str) -> dict[str, tuple[int, int, int]]:
    """{kernel: (registers, spill store, spill load bytes)} of the f64
    form's instantiations in a ``-Xptxas -v`` build log."""
    return {k: v for k, v in storage_check.ptxas_table(log).items()
            if _F64.search(k)}


def print_table(log: str) -> None:
    table = f64_table(log)
    spill = {k: v for k, v in table.items() if v[1] or v[2]}
    print(f"the f64 form's instantiations (csrc/mma_f64.cu): {len(table)}, "
          f"registers {min(v[0] for v in table.values())}-"
          f"{max(v[0] for v in table.values())}, spilling {len(spill)}")
    for name, (regs, st, ld) in sorted(spill.items()):
        print(f"  ptxas {name[:96]} regs {regs} spill {st}/{ld}")


def main(argv: list[str] | None = None) -> int:
    from mf_data_locality_tpu_torch.ops import _build
    from mf_data_locality_tpu_torch.utils import timing

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("f64_split2m_check: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib, log = _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    print_table(log or lib.with_suffix(".log").read_text())
    t0 = time.perf_counter()
    rc = 0
    try:
        report(compare_all(dev, quiet=False, keep_going=True))
    except CheckFailed as e:
        print(f"FAILED:\n{e}")
        rc = 1
    print(f"compare {time.perf_counter() - t0:.1f} s")
    if args.time:
        sys.path.insert(0, ".")
        import chip_smoke

        time_all(dev, lambda k, p: chip_smoke.time_pair(k, p, dev, timing),
                 chip_smoke.bound)
    return rc


if __name__ == "__main__":
    sys.exit(main())
