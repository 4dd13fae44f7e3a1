"""The order of the f64 split2m form's sums, emulated on the CPU.

    python -m mf_data_locality_tpu_torch.utils.f64_sum_order [P ...]

The dense tensor-core pass at f64 split2m (``csrc/apply_mma_hd.cuh``'s
``kF64`` forms) sums bf16 x bf16 products, exact in f32, in chains of k16
steps (16 products a step and part).  This emulates three orders of those
sums in plain PyTorch on B3's cell-batch apply of the 3 x 5 x 7 box
(``f64_split2m_check``'s), each chain an f32 ``einsum`` (rounded to
nearest, where the tensor cores are not), and prints the relative L2 of
each against the plain version it would be held to:

* ``ch8_f64``: chains of 8 steps added at f64, against f64 sums
  (``laplace_pallas._mm`` at f64; B3's form before ``hd_chain``);
* ``ch1_f64_r32``: one step a chain added at f64 and rounded to f32 where
  it leaves the GEMM (B1/B2's form, ``gemm_out``), against the f64 sums
  rounded to f32 (``cg_fused_kernel._f32_sums``);
* ``ch8_f32``: chains of 8 steps added at f32 (the f32 split2m pass's
  order), against sums at f32 (XLA's ``preferred_element_type=f32``, in
  another order).

Default degrees 4, 9 and 11.  The card's tensor cores read larger errors
than this emulation (PERF.md's f64 split2m findings).
"""

from __future__ import annotations

import sys

import torch

from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.ops import laplace_cuda
from mf_data_locality_tpu_torch.ops.cg_fused_kernel import _terms
from mf_data_locality_tpu_torch.utils import bf16_check

F64, F32 = torch.float64, torch.float32
STEP = 16  # products of a k16 step and part


def _sum(terms, eq: str, order: str) -> torch.Tensor:
    """The products of ``terms`` ((matrix part, stream part) pairs) by
    ``eq`` summed in ``order``; the contraction is the matrix's column
    axis (the forward) or its row axis (the backward)."""
    if order == "f64":
        return sum(torch.einsum(eq, a, b) for a, b in terms)
    if order == "f32":
        return sum(torch.einsum(eq, a.to(F32), b.to(F32))
                   for a, b in terms).to(F64)
    steps, acc = {"ch8_f64": (8, F64), "ch1_f64": (1, F64),
                  "ch8_f32": (8, F32)}[order]
    fwd = eq.startswith("rk,ckn")
    out = None
    for a, b in terms:
        k = a.shape[1] if fwd else a.shape[0]
        for k0 in range(0, k, steps * STEP):
            ks = slice(k0, k0 + steps * STEP)
            part = torch.einsum(eq, (a[:, ks] if fwd else a[ks]).to(F32),
                                b[:, ks].to(F32)).to(acc)
            out = part if out is None else out + part
    return out.to(F64)


def apply(op, u: torch.Tensor, G: torch.Tensor, order: str,
          round32: bool = False) -> torch.Tensor:
    """B3's dense split2m apply of the cell batch ``u`` with its sums in
    ``order`` (``round32``: each GEMM's sum rounded to f32)."""
    p13, q3, nc = (op.degree + 1) ** 3, op.n_q ** 3, u.shape[1]

    def sums(terms, eq):
        s = _sum(terms, eq, order)
        return s.to(F32).to(F64) if round32 else s

    g = sums(_terms(op.mats, u.reshape(-1, p13, nc), "split2m"),
             "rk,ckn->crn")
    gx, gy, gz = g.reshape(-1, 3, q3, nc).unbind(1)
    t = torch.stack([G[0] * gx + G[1] * gy + G[2] * gz,
                     G[1] * gx + G[3] * gy + G[4] * gz,
                     G[2] * gx + G[4] * gy + G[5] * gz], 1)
    v = sums(_terms(op.mats, t.reshape(-1, 3 * q3, nc), "split2m"),
             "rk,crn->ckn")
    return v.reshape(-1, nc)


def readings(p: int) -> dict[str, float]:
    """{order: relative L2 against its plain version} at degree ``p``."""
    op = laplace_cuda.make_operator(
        DofLayout(BoxMesh((3, 5, 7), 0.25), p), F64, "split2m",
        factor="dense", metric="precomputed", windowing="reshape",
        device="cpu")
    (u,) = bf16_check.state(op, 1, 20 + p)
    x, G = la.to_cell_batches(u, p).contiguous(), la._metric(op)
    pairs = {"ch8_f64": (("ch8_f64", False), ("f64", False)),
             "ch1_f64_r32": (("ch1_f64", True), ("f64", True)),
             "ch8_f32": (("ch8_f32", False), ("f32", False))}
    return {k: bf16_check.l2(apply(op, x, G, *a), apply(op, x, G, *b))
            for k, (a, b) in pairs.items()}


def main(argv: list[str] | None = None) -> int:
    for p in [int(a) for a in (argv or sys.argv[1:])] or [4, 9, 11]:
        r = readings(p)
        print(f"p={p}: " + ", ".join(f"{k} {v:.3e}" for k, v in r.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
