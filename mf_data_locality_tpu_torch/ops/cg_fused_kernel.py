"""The BP4 operator apply and the fused merged-CG iteration, on lattice vectors.

Counterparts of ``mf_data_locality_tpu.ops.cg_fused_kernel``:

* :func:`matvec` — ``piece_vmult`` (TPU kernel ``_matvec_kernel``):
  ``h = M A M d`` with ``M`` the Dirichlet mask.
* :func:`fused_cg_iteration` — ``fused_cg_iteration`` (TPU kernel
  ``_fused_cg_kernel``): one merged-CG iteration — update4b, the operator
  on d', the seven update3b sums and the scalar recurrence; on a block
  operator with ``cells`` the cell pass over a range of cell layers, and
  :func:`fused_cg_assemble` the node passes after such passes (the
  kernel's ``step_range``/``carry0``).

Vectors are lattices ``(C, Nz, Ny, Nx)`` that vanish on the boundary (the
solver's invariant); the preconditioner is ``(1, Nz, Ny, Nx)``; ``scal`` is
the 8-vector (alpha, beta, c1, aob, parity, res2, alpha_old, beta_old).

The operator is the one ``op`` was built with (``op.factor``, ``op.metric``,
``op.cofactor``; ``laplace_cuda.fused_configs``): the dense factorization
or twostage, the metric streamed (``op.gmetric``) or rebuilt per q-point
from the coefficients by the adjj or the jtj chain, at degrees 1..11 on
every rung (``highest`` and the tensor-core rungs split2m, split3,
bf16).  On every rung d and h (in and out) may be stored in bf16 —
the bf16 state —, x, g, the preconditioner and the scalars at f32; the
metric may be streamed in bf16.
In every configuration the preconditioner, and x (in and out), may be
stored in bf16 (the fused solver's ``prec_dtype`` and ``x_dtype``): the
kernel upcasts them at the load and rounds x' where it stores it (one
more instantiation of each B2 cell pass, ``csrc/cg_fused_px.cu``).  Each
wrapper runs the hand-written CUDA kernel (``csrc/cg_fused.cu``) for
tensors on a CUDA device and the plain
PyTorch version (:func:`_matvec_plain`, :func:`_fused_iteration_plain`,
:func:`_cells_plain`, :func:`_assemble_plain`) for tensors on the CPU;
other devices raise.  The kernel's cell pass:

* ``highest`` (f32, f64), every configuration: the sum-factorized pass of
  ``csrc/apply_sumfac.cuh`` on ``op.sz``/``op.dz`` (degrees 5..11 built in
  ``csrc/sumfac_p05.cu`` .. ``sumfac_p11.cu``), the metric streamed or
  rebuilt from ``op.coeffs`` — the dense and twostage operators are one
  function, which it sums in another order than the plain versions;
* f32 ``split2m``, ``split3``, ``bf16`` (the rung a template parameter
  of each tensor-core pass, its products a tile), dense: the tensor-core
  pass of ``csrc/apply_mma.cuh`` (p=1..4) or ``csrc/apply_mma_hd.cuh``
  (p=5..11, built one source a degree and rung, ``csrc/apply_mma_p05.cu``
  .. ``apply_mma_p11.cu``, its operands' fragments in
  :func:`dense_scratch`) on the bf16 tables ``op.mma_mats`` of the dense
  M, the metric streamed or rebuilt (by jtj in the passes' ``kJtjChain``
  instantiations, ``csrc/mma_jtj.cu``);
* the same rungs, twostage + onthefly at p=4: the tensor-core pass of
  ``csrc/cell_mma.cuh`` on the 2D stage's tables;
* the same rungs, twostage at p=1..3 and 5..11 (either metric, either
  chain) and at p=4 with the streamed metric: the tensor-core pass of
  ``csrc/cell_mma_hd.cuh`` on the same tables, two q-planes of 8 cells the
  rows of its tiles (built one source a degree and rung,
  ``csrc/cell_mma_p01.cu`` .. ``cell_mma_p11.cu``);
* f64 ``split2m`` (the JAX CLI's ``--dtype f64 --precision split2m``),
  every fused configuration at p=1..11 with P and x at f64, on one
  device: the f64 form of ``csrc/apply_mma_hd.cuh``'s dense pass and of
  ``csrc/cell_mma_hd.cuh``'s twostage pass at every degree
  (``csrc/mma_f64.cu``), the bf16 parts rounded from f64 through f32, the
  products' sums rounded to f32 (``_mm_pre``'s f32 result) and met by the
  f64 metric, as the plain versions round them (:func:`_f32_sums`).

The vectors' components C (BP4 3, CEED BP3 1) come from their shape and
q from ``op.n_q``: at the shapes beyond BP4's (C = 1, q = p + 1, both;
``laplace_cuda.check_shape``) the kernels run ``csrc/shapes.cu``'s cell
passes under ``highest`` and ``split2m`` (the sum-factorized pass, the
dense pass of ``csrc/apply_mma_hd.cuh`` and the twostage one of
``csrc/cell_mma_hd.cuh`` at every degree), with P and x and the metric
at the working dtype; at one component and q = p + 2 (CEED BP3) also
with d and h in bf16 (the bf16 state) and in B2's block form
(``csrc/shapes_block.cu``: the sum-factorized pass, and the dense pass of
``apply_mma_hd.cuh`` under split2m), on one device and on the ranks.

The plain versions do the same arithmetic — the same bf16 rounding points
for the tensor-core rungs (:func:`_terms`) and the bf16 state, the same
masking — with einsum over cells, in another summation order.  ``matvec.launches``,
``fused_cg_iteration.launches`` and ``fused_cg_assemble.launches`` count
kernel launches (not plain calls).
"""

from __future__ import annotations

import itertools

import torch

from mf_data_locality_tpu_torch.ops import _build, laplace_cuda
from mf_data_locality_tpu_torch.ops.laplace_cuda import OperatorData

N_COMPONENTS = 3  # BP4's; the vectors' own count is read from their shape


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, held at its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _terms(m: torch.Tensor, x: torch.Tensor,
           precision: str) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The (matrix part, stream part) pairs whose products, summed, are one
    product of ``m`` with the stream ``x`` at ``precision``
    (``laplace_pallas._mm``; ``cg_fused_kernel._prestack`` /
    ``_stream_parts``): highest m x; bf16 Mh xh; split2m Mh xh + Mh xl;
    split3 Mh xh + Ml xh + Mh xl, with Mh = bf16(m), Ml = bf16(m - Mh),
    xh = bf16(x), xl = bf16(x - xh)."""
    if precision == "highest":
        return [(m, x)]
    mh, xh = _bf16(m), _bf16(x)
    if precision == "bf16":
        return [(mh, xh)]
    xl = _bf16(x - xh)
    if precision == "split2m":
        return [(mh, xh), (mh, xl)]
    return [(mh, xh), (_bf16(m - mh), xh), (mh, xl)]


def _mma_terms(tables, x: torch.Tensor, precision: str,
               back: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """A tensor-core pass's product at ``precision`` K-stacked, as its
    kernels issue the mma tiles: (the stream parts concatenated along the
    last axis, the matrix parts stacked to match).  ``tables``: the
    (forward's, backward's) padded bf16 matrices of each matrix part
    (``laplace_cuda.unpack_mma_tables``), Mh first; ``back``: the
    backward's (stacked along rows) rather than the forward's (along
    columns).  The products: xh Mh, then xl Mh (split2m, split3), then xh
    Ml (split3)."""
    xh = _bf16(x)
    parts = [(xh, 0)]
    if precision != "bf16":
        parts.append((_bf16(x - xh), 0))
    if precision == "split3":
        parts.append((xh, 1))
    mats = [tables[k][1 if back else 0].to(x.dtype) for _, k in parts]
    return (torch.cat([p for p, _ in parts], -1),
            torch.cat(mats, 0) if back else torch.cat(mats, 1))


def metric_onthefly(op: OperatorData,
                    cofactor: str | None = None) -> torch.Tensor:
    """(6, n_cells, q^3) metric entries (00, 01, 02, 11, 12, 22) rebuilt from
    the trilinear coefficients (``_metric_onthefly``; J = pds . c in exact
    arithmetic) by the chain ``cofactor`` (default ``op.cofactor``): adjj,
    G = w adj(J) adj(J)^T / det J; jtj, C = J^T J and G = w adj(C) /
    sqrt(det C), det C <= 0 guarded to 1 (a zero Jacobian gives G = 0)."""
    q3 = op.n_q ** 3
    pds = op.pds.reshape(3, q3, 8)
    J = torch.einsum("eqk,dkn->denq", pds, op.coeffs)  # (3, 3, nc, q3)
    w = op.w3.reshape(1, q3)
    if (cofactor or op.cofactor) == "jtj":
        C = {(e_, f_): J[0][e_] * J[0][f_] + J[1][e_] * J[1][f_]
             + J[2][e_] * J[2][f_] for e_ in range(3) for f_ in range(e_, 3)}
        c00, c01, c02 = C[0, 0], C[0, 1], C[0, 2]
        c11, c12, c22 = C[1, 1], C[1, 2], C[2, 2]
        adj_c = [c11 * c22 - c12 * c12, c02 * c12 - c01 * c22,
                 c01 * c12 - c02 * c11, c00 * c22 - c02 * c02,
                 c01 * c02 - c00 * c12, c00 * c11 - c01 * c01]
        det_c = c00 * adj_c[0] + c01 * adj_c[1] + c02 * adj_c[2]
        scale = w * torch.rsqrt(torch.where(det_c <= 0,
                                            torch.ones_like(det_c), det_c))
        return torch.stack([r * scale for r in adj_c])
    (a, b, c), (d, e, f), (g, h, i) = J
    adj = [[e * i - f * h, c * h - b * i, b * f - c * e],
           [f * g - d * i, a * i - c * g, c * d - a * f],
           [d * h - e * g, b * g - a * h, a * e - b * d]]
    det = a * adj[0][0] + b * adj[1][0] + c * adj[2][0]
    scale = w / torch.where(det == 0, torch.ones_like(det), det)
    return torch.stack([(adj[r][0] * adj[s][0] + adj[r][1] * adj[s][1]
                         + adj[r][2] * adj[s][2]) * scale
                        for r in range(3) for s in range(r, 3)])


def cell_metric(op: OperatorData) -> torch.Tensor:
    """(6, n_cells, q^3) metric entries of ``op``: the streamed
    ``op.gmetric`` (upcast from its storage dtype), or rebuilt from the
    coefficients."""
    if op.gmetric is None:
        return metric_onthefly(op)
    return op.gmetric.to(op.dtype).reshape(6, op.n_q ** 3,
                                           op.n_cells).transpose(1, 2)


def _cells(op: OperatorData, u: torch.Tensor) -> torch.Tensor:
    """(C, Nz, Ny, Nx) -> the cells' node values (C, n_cells, p1, p1^2)."""
    p, p1 = op.degree, op.degree + 1
    return (u.unfold(1, p1, p).unfold(2, p1, p).unfold(3, p1, p)
            .reshape(u.shape[0], op.n_cells, p1, p1 * p1))


def _on_batch(op: OperatorData, u: torch.Tensor, apply) -> torch.Tensor:
    """A cell-batch apply ``apply(u_loc (C p1^3, n_cells), G (6, q^3,
    n_cells))`` (``laplace_apply``'s) on the cells of a lattice vector, with
    the metric of :func:`cell_metric`: (C, Nz, Ny, Nx) -> (C, n_cells, p1,
    p1^2)."""
    p1 = op.degree + 1
    n_comp, nc = u.shape[0], op.n_cells
    batch = _cells(op, u).reshape(n_comp, nc, p1 ** 3).transpose(1, 2)
    v = apply(batch.reshape(n_comp * p1 ** 3, nc),
              cell_metric(op).transpose(1, 2))
    return v.reshape(n_comp, p1 ** 3, nc).transpose(1, 2).reshape(
        n_comp, nc, p1, p1 * p1)


def _f32_sums(op: OperatorData, t: torch.Tensor) -> torch.Tensor:
    """``t``, a sum of a tensor-core rung's products, rounded to f32 and
    held at the working dtype: B1/B2 sum them in f32 whatever the state's
    dtype (``_mm_pre``'s ``preferred_element_type=jnp.float32``), which at
    f64 (split2m) rounds; under ``highest`` ``t`` as it is."""
    if op.precision not in laplace_cuda.TENSOR_RUNGS:
        return t
    return t.to(torch.float32).to(t.dtype)


def _cell_apply(op: OperatorData, u: torch.Tensor) -> torch.Tensor:
    """Cell-local operator in ``op.factor``'s form: (C, Nz, Ny, Nx) -> (C,
    n_cells, p1, p1^2).  Dense: ``laplace_apply._batched_plain`` on the
    cells; twostage: the z stage by S and D, then the 2D matrices, each
    product at ``op.precision`` (:func:`_terms`).  Under a tensor-core rung
    each product's sum is f32 (:func:`_f32_sums`) and twostage's z stage
    back runs at f32, as the JAX kernels' (their factors Python floats,
    rounded to f32 against the f32 products); at f32 that is the working
    dtype, at f64 (split2m) the JAX package's rounding points."""
    # laplace_apply imports this module, so it is imported here
    from mf_data_locality_tpu_torch.ops import laplace_apply

    rung = op.precision
    if op.factor == "dense":
        return _on_batch(op, u, lambda b, G: laplace_apply._batched_plain(
            op, b, G, True, f32_sums=True))
    q = op.n_q
    q2 = q * q
    cells = _cells(op, u)                                   # (C, n, kz, k2)
    uS = torch.einsum("qk,cnkr->cnqr", op.sz, cells)
    uD = torch.einsum("qk,cnkr->cnqr", op.dz, cells)
    mxy, mz = op.mats2d[:2 * q2], op.mats2d[2 * q2:]
    gxy = _f32_sums(op, sum(torch.einsum("sr,cnqr->cnqs", a, b)
                            for a, b in _terms(mxy, uS, rung)))
    gz = _f32_sums(op, sum(torch.einsum("sr,cnqr->cnqs", a, b)
                           for a, b in _terms(mz, uD, rung)))
    gx, gy = gxy[..., :q2], gxy[..., q2:]
    G = cell_metric(op).reshape(6, 1, op.n_cells, q, q2)
    t0 = G[0] * gx + G[1] * gy + G[2] * gz
    t1 = G[1] * gx + G[3] * gy + G[4] * gz
    t2 = G[2] * gx + G[4] * gy + G[5] * gz
    t01 = torch.cat([t0, t1], dim=-1)
    w1 = sum(torch.einsum("sr,cnqs->cnqr", a, b)
             for a, b in _terms(mxy, t01, rung))
    w2 = sum(torch.einsum("sr,cnqs->cnqr", a, b)
             for a, b in _terms(mz, t2, rung))
    back = torch.float32 if rung in laplace_cuda.TENSOR_RUNGS else op.dtype
    return (torch.einsum("qk,cnqr->cnkr", op.sz.to(back), w1.to(back))
            + torch.einsum("qk,cnqr->cnkr", op.dz.to(back), w2.to(back))
            ).to(op.dtype)


def _cell_apply_mma_emulated(op: OperatorData,
                             u: torch.Tensor) -> torch.Tensor:
    """The tensor-core cell passes' arithmetic in plain PyTorch, for the
    tests.  Dense (``csrc/apply_mma.cuh``, ``csrc/apply_mma_hd.cuh`` in
    their lattice forms):
    ``laplace_apply._batched_mma_emulated`` on the cells with the streamed
    or rebuilt metric.  Twostage (``csrc/cell_mma.cuh`` at p=4,
    ``csrc/cell_mma_hd.cuh``): the 2D matrices from their packed bf16
    tables, (ky, kx) columns and q^2 rows zero-padded, the q-planes padded
    to pairs (the rows of ``cell_mma_hd.cuh``'s tiles: the padded plane has
    zero z factors and G = 0), the f32 z stage unrounded, the K-stacked
    products of the rung (:func:`_mma_terms`; split2m [uh | ul] [Mh; Mh])
    and, after the metric apply, those of t in f32, then the z stage back,
    plane after plane.  Same result shape as :func:`_cell_apply`."""
    if op.factor == "dense":
        from mf_data_locality_tpu_torch.ops import laplace_apply

        return _on_batch(op, u, lambda b, G: laplace_apply
                         ._batched_mma_emulated(op, b, G))
    p, q = op.degree, op.n_q
    p1, q2, qe = p + 1, q * q, q + q % 2
    q2p, p12p = laplace_cuda.mma_dims(p, "twostage", q)
    tables = mma_parts(op, op.mma_mats, op.factor)
    cells = torch.nn.functional.pad(_cells(op, u), (0, p12p - p1 * p1))
    sz, dz = (torch.nn.functional.pad(m, (0, 0, 0, qe - q))
              for m in (op.sz, op.dz))
    uS = torch.einsum("qk,cnkr->cnqr", sz, cells)
    uD = torch.einsum("qk,cnkr->cnqr", dz, cells)

    def fwd(rows, b):  # (rows, p12p) x (..., p12p), K-stacked parts
        x, m = _mma_terms([(f[rows], bk) for f, bk in tables], b,
                          op.precision, back=False)
        return x @ m.t()

    gxy = fwd(slice(0, 2 * q2p), uS)
    gx, gy = gxy[..., :q2p], gxy[..., q2p:]
    gz = fwd(slice(2 * q2p, None), uD)
    G = torch.nn.functional.pad(
        cell_metric(op).reshape(6, 1, op.n_cells, q, q2),
        (0, q2p - q2, 0, qe - q))
    t0 = G[0] * gx + G[1] * gy + G[2] * gz
    t1 = G[1] * gx + G[3] * gy + G[4] * gz
    t2 = G[2] * gx + G[4] * gy + G[5] * gz

    def bwd(rows, b):  # (rows, p12p)^T x (..., rows), K-stacked parts
        x, m = _mma_terms([(f, bk[rows]) for f, bk in tables], b,
                          op.precision, back=True)
        return x @ m

    w1 = bwd(slice(0, 2 * q2p), torch.cat([t0, t1], -1))[..., :p1 * p1]
    w2 = bwd(slice(2 * q2p, None), t2)[..., :p1 * p1]
    v = w1.new_zeros(w1.shape[:2] + (p1, p1 * p1))
    for qz in range(q):  # the planes in order, as the kernels add them
        v = v + (sz[qz, :, None] * w1[:, :, qz, None]
                 + dz[qz, :, None] * w2[:, :, qz, None])
    return v


def mma_parts(op: OperatorData, tables: torch.Tensor,
              factor: str) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The (forward's, backward's) padded bf16 matrices of each matrix part
    that ``tables`` (of ``factor``'s matrix, :func:`laplace_cuda.mma_tables`)
    packs (Mh; under split3 also Ml)."""
    return [laplace_cuda.unpack_mma_tables(tables, op.degree, factor, part,
                                           op.n_q)
            for part in range(tables.shape[0] // 2)]


def _cell_apply_sumfac_emulated(op: OperatorData,
                                u: torch.Tensor) -> torch.Tensor:
    """The ``highest`` cell pass's arithmetic (``csrc/apply_sumfac.cuh`` in
    its lattice forms, the metric streamed or rebuilt) in plain PyTorch, for
    the tests: the x, y, z passes with S and D in the kernel's order, in
    place of the dense M or twostage's z stage and 2D matrices.  Same
    result shape as :func:`_cell_apply`."""
    from mf_data_locality_tpu_torch.ops import laplace_apply

    return _on_batch(op, u, lambda b, G: laplace_apply
                     ._batched_sumfac_emulated(op, b, G))


def _assemble(op: OperatorData, v: torch.Tensor) -> torch.Tensor:
    """Sum cell-local values (C, n_cells, p1, p1^2) into the lattice.

    A node takes its cells' values in the order of their local index (kz,
    ky, kx).  On each axis a local index is the cell's first plane (0), an
    inner one (1..p-1) or its last (p), and a node takes at most one value
    from each of the 27 classes these make, so one strided add a class, in
    that order, sums every node as a loop over (kz, ky, kx) would, to the
    bit."""
    p = op.degree
    p1 = p + 1
    nc = op.n_cells_axis
    v = v.reshape((v.shape[0],) + tuple(nc) + (p1,) * 3).permute(
        0, 1, 4, 2, 5, 3, 6)                       # (C, ncz, kz, ncy, ...)
    out = torch.zeros((v.shape[0],) + op.n_nodes_axis, dtype=v.dtype,
                      device=v.device)
    st = out.stride()

    def classes(a):  # (sizes, strides, offset) of out's view, v's index
        s = st[a + 1]
        return (((nc[a],), (p * s,), 0, 0),
                ((nc[a], p - 1), (p * s, s), s, slice(1, p)),
                ((nc[a],), (p * s,), p * s, p))

    for (zn, zs, zo, kz), (yn, ys, yo, ky), (xn, xs, xo, kx) in \
            itertools.product(classes(0), classes(1), classes(2)):
        out.as_strided(out.shape[:1] + zn + yn + xn, st[:1] + zs + ys + xs,
                       zo + yo + xo).add_(v[:, :, kz, :, ky, :, kx])
    return out


def _matvec_plain(op: OperatorData, d: torch.Tensor,
                  cell_apply=_cell_apply, carry=None) -> torch.Tensor:
    """h = M A M d; ``cell_apply`` the cell pass (the tests pass the
    kernels' emulations).  A bf16 d (the bf16 state) is applied at the
    working dtype and h rounded to bf16; ``carry`` (a block operator's)
    then receives h's top z face before the rounding."""
    h = _assemble(op, cell_apply(op, d.to(op.dtype) * op.mask)) * op.mask
    _carry_out(h, d.dtype, carry)
    return h.to(d.dtype)


def _carry_out(h: torch.Tensor, store: torch.dtype, carry) -> None:
    """C10: a block's top z face of h at the working dtype into ``carry``,
    under a bf16 state (the JAX kernel's ``carry_out_ref``, sent at f32)."""
    if carry is not None and store == torch.bfloat16:
        carry.copy_(h[:, -1])


def scalar_recurrence(s: torch.Tensor, alpha: torch.Tensor,
                      beta: torch.Tensor, parity: torch.Tensor) -> torch.Tensor:
    """The merged-CG scalar update from the 7 fused sums.

    ``s``: (8,) sums (d.h, h.h, g.h, g.g, g.Ph, h.Ph, g.Pg, 0).  Returns the
    next scal (alpha, beta, c1, aob, parity, res2, alpha_old, beta_old) —
    ``solver_cg_optimized.h:249-295``.  Breakdown (d.h = 0) propagates NaN
    through alpha and res2, which ends the solve with ``res = NaN``.
    """
    alpha_n = s[6] / s[0]
    beta_n = alpha_n * (s[4] + alpha_n * s[5]) / s[6]
    res2 = s[3] + 2.0 * alpha_n * s[2] + alpha_n * alpha_n * s[1]
    parity_next = 1.0 - parity
    is_pay = (parity_next > 0.5) & (alpha != 0)
    zero = torch.zeros_like(alpha)
    safe_b = torch.where(beta == 0, torch.ones_like(beta), beta)
    aob_n = torch.where(is_pay, alpha / safe_b, zero)
    c1_n = torch.where(is_pay, alpha_n + aob_n, zero)
    return torch.stack([alpha_n, beta_n, c1_n, aob_n, parity_next, res2,
                        alpha, beta])


def _fused_iteration_plain(op, x, g, d, h, scal, prec,
                           cell_apply=_cell_apply, carry=None):
    """One merged-CG iteration.  With d and h in bf16 (the bf16 state;
    g and scal at the working dtype) every value is computed at the
    working dtype and rounded where it is stored, as the TPU kernel does
    (``cg_fused_kernel.py:856, 877``): the operator takes the stored d',
    and the sums read the stored d' and h'.  ``prec`` and ``x`` may be
    bf16 too (``prec_dtype``, ``x_dtype``): upcast where they are read, x'
    rounded where it is stored.  On a block operator (``op.slab``) the
    block form of :func:`fused_cg_iteration`: the sums over the owned
    nodes (:data:`OWNED`), raw, in place of scal', and with a bf16 state
    h''s top z face unrounded into ``carry`` where one is given."""
    x2, g2, d2 = _update4b(scal, x, g, d, h, prec)
    h2 = _matvec_plain(op, d2, cell_apply, carry)
    s = _sums(op, g2, d2, h2, prec)
    if op.slab is not None:
        return x2, g2, d2, h2, s
    return x2, g2, d2, h2, scalar_recurrence(s, scal[0], scal[1], scal[4])


def _update4b(scal, x, g, d, h, prec):
    """update4b (``cg_fused_kernel.py:836-858``): x', g', d' from the
    stored vectors, at g's dtype, x' and d' rounded where they are
    stored."""
    alpha, beta, c1, aob = scal[0], scal[1], scal[2], scal[3]
    store = d.dtype
    d, h, prec = d.to(g.dtype), h.to(g.dtype), prec.to(g.dtype)
    g2 = g + alpha * h
    d2 = (beta * d - prec * g2).to(store)
    x2 = (x.to(g.dtype) + c1 * d + aob * (prec * g)).to(x.dtype)
    return x2, g2, d2


def _cells_plain(op, x, g, d, h, scal, prec, out, work, c0: int, c1: int,
                 cell_apply=_cell_apply) -> None:
    """The layer-range form's cell pass (:func:`fused_cg_iteration` with
    ``cells``): update4b on the planes [c0 p, c1 p] the layers touch, x',
    g', d' written on the planes they own ([c0 p, c1 p), and the top
    plane with the last layer), the operator on d' of the sub-lattice
    (``laplace_cuda.sub_operator``) into those cells' rows of
    ``work.cells``."""
    p, ncz = op.degree, op.n_cells_axis[0]
    z = slice(c0 * p, c1 * p + 1)
    new = _update4b(scal, *(t[:, z] for t in (x, g, d, h, prec)))
    own = slice(0, (c1 - c0) * p + (c1 == ncz))
    for o, v in zip(out, new):
        o[:, z][:, own] = v[:, own]
    sub = laplace_cuda.sub_operator(op, c0, c1)
    layer = op.n_cells // ncz
    work.cells[:, c0 * layer:c1 * layer] = cell_apply(
        sub, new[2].to(op.dtype) * sub.mask).reshape(
        d.shape[0], sub.n_cells, -1)


def _sums(op, g2, d2, h2, prec) -> torch.Tensor:
    """The 7 update3b sums and a 0 (``scalar_recurrence``'s ``s``): over
    the owned nodes (:data:`OWNED`) on a block operator."""
    d2a, h2a, g2o, po = d2.to(g2.dtype), h2.to(g2.dtype), g2, prec.to(
        g2.dtype)
    if op.slab is not None:
        d2a, h2a, g2o, po = (t[OWNED] for t in (d2a, h2a, g2o, po))
    ph, pg = po * h2a, po * g2o
    return torch.stack([torch.sum(d2a * h2a), torch.sum(h2a * h2a),
                        torch.sum(g2o * h2a), torch.sum(g2o * g2o),
                        torch.sum(g2o * ph), torch.sum(h2a * ph),
                        torch.sum(g2o * pg),
                        torch.zeros((), dtype=g2.dtype, device=g2.device)])


def _assemble_plain(op, out, prec, work) -> None:
    """The layer-range form's node passes (:func:`fused_cg_assemble`): h'
    from every cell's row of ``work.cells``, masked and rounded where it
    is stored, and the 7 raw sums."""
    p1 = op.degree + 1
    h2 = (_assemble(op, work.cells.reshape(-1, op.n_cells, p1, p1 * p1))
          * op.mask)
    _carry_out(h2, out[3].dtype, work.carry)
    out[3].copy_(h2.to(out[3].dtype))
    out[4].copy_(_sums(op, out[1], out[2], out[3], prec))


def delayed_x_fixup(x, g, d, prec, scal, it: int):
    """Delayed-x exit fixup (``solver_cg_optimized.h:254-289``): the merged
    recurrence updates x every second iteration; on exit the pending
    contribution is applied with the parity-dependent coefficient.  At
    g's dtype, whatever x's and prec's storage."""
    x, prec = x.to(g.dtype), prec.to(g.dtype)
    if it == 0:
        return x
    alpha, alpha_old, beta_old = scal[0], scal[6], scal[7]
    if it % 2 == 1:
        return x + alpha * d
    ab = alpha_old / torch.where(beta_old == 0, torch.ones_like(beta_old),
                                 beta_old)
    return x + (alpha + ab) * d + ab * (prec * g)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def check_kernel_shape(op: OperatorData, n_components: int,
                       store: torch.dtype | None = None,
                       px: bool = False) -> int:
    """The kernels' shape argument for ``op``'s q and a vector of
    ``n_components`` (``laplace_cuda.check_shape``): 0 for BP4's (q = p + 2,
    3 components); one component and q = p + 1 under highest and split2m,
    at one component and q = p + 2 (CEED BP3) also with a bf16 state
    (``store``) and on a block operator; NotImplementedError (queue B item
    6g) for the rest — any other shape, and at those a bf16 metric, P or
    x in bf16 (``px``), and at q = p + 1 a bf16 state or a block operator.
    The plain versions take any."""
    return laplace_cuda.check_shape(
        op.degree, op.n_q, n_components, op.precision, store or op.dtype,
        op.metric_dtype, block=op.slab is not None, px=px)


def check_tensors(op: OperatorData, degrees, pairs) -> None:
    """Raise unless ``op.degree`` has a kernel (``degrees``) and every
    (tensor, shape) or (tensor, shape, dtype) entry is a contiguous tensor
    of that dtype (default: the operator's), on its device, of that
    shape."""
    if op.degree not in degrees:
        raise NotImplementedError(
            f"degree {op.degree} has no CUDA kernel instantiated "
            f"(have {degrees}); see ROADMAP.md queue B")
    for t, shape, *dtype in pairs:
        want = dtype[0] if dtype else op.dtype
        if (t.device != op.device or t.dtype != want
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"expected a contiguous {want} tensor of shape {shape} "
                f"on {op.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def _bf16_or_working(op: OperatorData, t: torch.Tensor) -> torch.dtype:
    """The storage dtype a kernel takes ``t`` in: bf16 where it is bf16,
    else the working dtype (which the checks then hold it to)."""
    return torch.bfloat16 if t.dtype == torch.bfloat16 else op.dtype


def _check_cuda(op: OperatorData, vectors, state=(), prec=None,
                scals=(), xs=()) -> int:
    """Check the operator's tables and the vectors for the kernels:
    ``vectors`` at the working dtype, ``state`` (d and h, in and out) at
    the state's storage dtype, the working dtype or, f32 on every rung,
    bf16; ``prec`` and ``xs`` (x in and out) at the working dtype or in
    bf16 (``prec_dtype``, ``x_dtype``: every configuration at BP4's shape
    on one device, beside a bf16 state or a bf16 metric too — B2's
    storage instantiations are its P/x form —; NotImplementedError on a
    block operator, queue A item 10, and at the shapes beyond BP4's,
    :func:`check_kernel_shape`).  Returns the kernels' shape argument
    (:func:`check_kernel_shape` of the vectors' components)."""
    n_comp = (list(vectors) + list(state))[0].shape[0]
    lat = (n_comp,) + op.n_nodes_axis
    store = (torch.bfloat16 if state and state[0].dtype == torch.bfloat16
             and op.dtype == torch.float32 else op.dtype)
    px = ((prec is not None and prec.dtype == torch.bfloat16)
          or (bool(xs) and xs[0].dtype == torch.bfloat16))
    shape = check_kernel_shape(op, n_comp, store, px)
    if (px and op.dtype == torch.float64
            and op.precision in laplace_cuda.TENSOR_RUNGS):
        raise NotImplementedError(
            f"B2 with P or x in bf16 under {op.precision!r} at f64 is not "
            f"instantiated: see ROADMAP.md, queue B item 6h")
    if px and op.slab is not None:
        raise NotImplementedError(
            "B2's block form with P or x in bf16 is not instantiated: no "
            "distributed JAX solver takes prec_dtype or x_dtype (see "
            "ROADMAP.md, queue A item 10)")
    want = [(v, lat) for v in vectors] + [(v, lat, store) for v in state]
    if xs:
        want += [(v, lat, _bf16_or_working(op, xs[0])) for v in xs]
    if prec is not None:
        want.append((prec, (1,) + op.n_nodes_axis,
                     _bf16_or_working(op, prec)))
    want += [(s, (8,)) for s in scals]
    q, p1, q3 = op.n_q, op.degree + 1, op.n_q ** 3
    want += [(op.sz, (q, p1)), (op.dz, (q, p1)), (op.kpds, (q3, 24)),
             (op.w3, (q3, 1))]
    if op.gmetric is not None:
        want.append((op.gmetric, (6 * q3, op.n_cells), op.metric_dtype))
    tensor_rung = op.precision in laplace_cuda.TENSOR_RUNGS
    twostage_split = tensor_rung and op.factor == "twostage"
    if tensor_rung:
        rp, cp = laplace_cuda.mma_dims(op.degree, op.factor, op.n_q)
        want.append((op.mma_mats, (4 if op.precision == "split3" else 2,
                                   3 * rp * cp), torch.bfloat16))
    if twostage_split:
        want.append((op.kcoeffs, (op.n_cells, 24)))
    else:
        want.append((op.coeffs, (3, 8, op.n_cells)))
    # csrc/cg_fused.cu instantiates the fused configurations, no other
    if (op.factor, op.metric) not in laplace_cuda.fused_configs(op.precision,
                                                                op.degree):
        raise NotImplementedError(
            f"factor={op.factor!r}, metric={op.metric!r} at degree "
            f"{op.degree} under {op.precision!r} has no CUDA kernel of the "
            f"fused solver; see ROADMAP.md queue B")
    check_tensors(op, laplace_cuda.FUSED_DEGREES, want)
    return shape


def _route(t: torch.Tensor) -> str:
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "kernel"
    raise ValueError(f"no kernel for device {t.device}")


def dtype_code(op: OperatorData) -> int:
    """The kernels' dtype argument: 0 = float32, 1 = float64."""
    return {torch.float32: 0, torch.float64: 1}[op.dtype]


def rung_args(op: OperatorData) -> tuple[int, int]:
    """The kernels' rung arguments: the products a tile (0: highest, the
    sum-factorized pass; 1 bf16, 2 split2m, 3 split3), and 1 for a metric
    streamed in bf16."""
    return (laplace_cuda.RUNG_PRODUCTS[op.precision],
            int(op.metric_dtype == torch.bfloat16))


def _common_args(op: OperatorData, state: torch.Tensor, shape: int = 0):
    # the tensor-core rungs: the bf16 fragment tables of the
    # factorization's tensor-core pass (dense: apply_mma.cuh, the
    # coefficients (3, 8, n_cells); twostage: cell_mma.cuh, the
    # coefficients a row per cell); highest: no matrix (the sum-factorized
    # pass applies S and D), the coefficients (3, 8, n_cells), the cell
    # fastest.  The metric: streamed, or null (rebuilt from the
    # coefficients by the chain: 0 adjj, 1 jtj).  ``state``: d, whose dtype
    # is that of d and h (1: bf16).  ``shape``: the kernels' shape argument
    # (:func:`check_kernel_shape`), after the degree.
    split = op.precision in laplace_cuda.TENSOR_RUNGS
    dense = op.factor == "dense"
    rung, metric_bf16 = rung_args(op)
    return (dtype_code(op), rung, op.degree, shape, int(dense),
            laplace_cuda.COFACTORS.index(op.cofactor),
            int(state.dtype == torch.bfloat16), metric_bf16,
            op.mma_mats.data_ptr() if split else None,
            op.sz.data_ptr(), op.dz.data_ptr(), op.kpds.data_ptr(),
            op.w3.data_ptr(),
            (op.kcoeffs if split and not dense else op.coeffs).data_ptr(),
            None if op.gmetric is None else op.gmetric.data_ptr())


class Workspace:
    """Scratch of the kernels: cell-local results (C, n_cells, (p+1)^3) and
    the per-block dot partials, for vectors of ``n_components`` (C; BP4's
    3 by default).  Allocate once per solve and pass it to every call to
    keep allocation out of the iteration loop.  On the CPU the cell-local
    results alone (the plain layer-range form's, :func:`fused_cg_iteration`
    with ``cells``).  On a block operator also ``carry`` (C, Ny, Nx) at the
    working dtype: B2's block form under a bf16 state writes there its top
    z face of h' unrounded (C10, the JAX kernel's ``carry_out``)."""

    def __init__(self, op: OperatorData, n_components: int = N_COMPONENTS):
        p1 = op.degree + 1
        self.cells = torch.empty((n_components, op.n_cells, p1 ** 3),
                                 dtype=op.dtype, device=op.device)
        self.carry = (None if op.slab is None else torch.empty(
            (n_components,) + op.n_nodes_axis[1:], dtype=op.dtype,
            device=op.device))
        self.partials = None
        if op.device.type == "cuda":
            ncz, ncy, ncx = op.n_cells_axis
            n = _build.load().bp4_partials_len(op.degree, ncz, ncy, ncx)
            self.partials = torch.empty((n,), dtype=op.dtype,
                                        device=op.device)


def dense_scratch(op: OperatorData, shape: int = 0) -> int | None:
    """The pointer to the scratch of the dense tensor-core pass at p >= 5,
    and at every degree at a shape beyond BP4's (``shape``, the kernels'
    shape argument) and at f64 (split2m's f64 form) (``csrc/
    apply_mma_hd.cuh``: its operands' fragments, the
    ``bp4_dense_scratch_len`` 16-byte words of ``op``'s rung, degree,
    shape and cells), allocated once an operator and shape and kept in
    ``op.cache``; None where the pass needs none."""
    rung = rung_args(op)[0]
    if rung and op.dtype == torch.float64:
        rung |= _build.F64_FORM
    n = _build.load().bp4_dense_scratch_len(rung, op.degree, shape,
                                            op.n_cells)
    if not n:
        return None
    key = ("dense_scratch", shape)
    if key not in op.cache:
        op.cache[key] = torch.empty((n, 4), dtype=torch.int32,
                                    device=op.device)
    return op.cache[key].data_ptr()


def _b12_scratch(op: OperatorData, shape: int = 0) -> int | None:
    # B1/B2 run the dense pass only in the dense factorization
    return dense_scratch(op, shape) if op.factor == "dense" else None


def _check_work(work: Workspace, n_components: int) -> None:
    if work.cells.shape[0] != n_components:
        raise ValueError(f"the workspace holds {work.cells.shape[0]} "
                         f"components, the vectors {n_components}: "
                         f"Workspace(op, {n_components})")


# The index of a block's own nodes in its (C, Z, Y, X) lattice vectors,
# [0, Pz) x [0, Py) x [0, Px): on each axis its top face is the upper
# neighbour's face 0, or the global Dirichlet face (zero in every vector).
OWNED = (slice(None),) + (slice(0, -1),) * 3


def block_faces(op: OperatorData) -> tuple[int, ...]:
    """(zlo, zhi, zown, ylo, yhi, yown, xlo, xhi, xown) of a block
    operator's lattice (``csrc/bp4_operator.cuh``'s Grid): on each axis its
    nodes below lo and from hi on are Dirichlet or dummy — face 0 on the
    first block only, the top face at the global top only —, and the sums
    cover [0, own), the block's own nodes."""
    out = ()
    for c0, nc, n in zip(*op.slab, op.n_nodes_axis):
        out += (1 if c0 == 0 else 0, min(n, (nc - c0) * op.degree), n - 1)
    return out


def matvec(op: OperatorData, d: torch.Tensor, out: torch.Tensor | None = None,
           work: Workspace | None = None) -> torch.Tensor:
    """h = M A M d on a (C, Nz, Ny, Nx) lattice vector (``piece_vmult``)."""
    if _route(d) == "plain":
        h = _matvec_plain(op, d)
        return h if out is None else out.copy_(h)
    if op.slab is not None:
        raise NotImplementedError(
            "B1 on a block operator is not instantiated: the "
            "distributed matvec runs B5")
    shape = _check_cuda(op, [], [d] + ([out] if out is not None else []))
    lib = _build.load()
    out = torch.empty_like(d) if out is None else out
    work = Workspace(op, d.shape[0]) if work is None else work
    _check_work(work, d.shape[0])
    ncz, ncy, ncx = op.n_cells_axis
    rc = lib.bp4_matvec(*_common_args(op, d, shape), d.data_ptr(),
                        work.cells.data_ptr(), out.data_ptr(),
                        _b12_scratch(op, shape), ncz, ncy, ncx,
                        torch.cuda.current_stream(d.device).cuda_stream)
    _build.check(lib, rc, "bp4_matvec")
    matvec.launches += 1
    return out


matvec.launches = 0


def fused_cg_iteration(op: OperatorData, x, g, d, h, scal, prec,
                       out=None, work: Workspace | None = None,
                       cells: tuple[int, int] | None = None):
    """One merged-CG iteration; returns (x', g', d', h', scal').

    ``out``: optional (x', g', d', h', scal') buffers, distinct from the
    inputs (the kernel reads every node's old values after other cells
    have written theirs, so it cannot update in place).  d and h (and d',
    h') may be bf16 on every rung: the bf16 state.  ``prec``,
    and x with x', may be bf16 in every configuration (the solver's
    ``prec_dtype``, ``x_dtype``), beside the bf16 state too, but in the
    block form.

    On a block operator (``op.slab``; a z-slab is a block of a (N,) rank
    mesh) the block form (the TPU kernel with ``halo``, ``z0``,
    ``ncz_global``, ``recurrence=False`` and ``want_carry=True``, and with
    ``y_split``/``x_split`` on a (z, y) or (z, y, x) mesh;
    ``parallel/dist_fused.py``): the vectors are the block's (C, Pz+1,
    Py+1, Px+1), whose ghost faces the caller has filled with the upper
    neighbours' pre-update face 0 of g, d and h (and P's), edges and
    corners included; the Dirichlet faces lie by global position on all
    three axes (:func:`block_faces`); scal' is the 7 sums over the owned
    nodes [0, Pz) x [0, Py) x [0, Px), raw, and a 0 (the caller corrects,
    reduces and runs :func:`scalar_recurrence` on them); and h''s ghost
    faces hold the block's partial sums owed upward (the carries); under
    a bf16 state ``work.carry`` receives the top z face of those sums at
    the working dtype, before the store rounded them (C10: the JAX
    kernel's ``carry_out``, which the caller sends up), on the CPU where
    ``work`` is given.

    ``cells=(c0, c1)``, on a block operator: the layer-range form (the TPU
    kernel's ``step_range``/``carry0``, ``cg_fused_kernel.py:1211-1212,
    1296-1303``), the cell pass alone over the cell layers [c0, c1) —
    x', g', d' on the nodes those cells own (the planes [c0 p, c1 p), and
    the top face with the last layer) and their cell-local results in
    ``work`` —, then :func:`fused_cg_assemble` once for h' and the sums.
    Each cell's result is independent of the range it is launched in and
    the assemble order is fixed, so cell passes over ranges that tile
    [0, ncz) and one assemble are bitwise the one call, with no carry
    between them; only the top layer reads the ghost face (the kernel
    reads d' of a cell's own nodes), so the ranges below it may run
    before the ghost faces are filled.  ``out`` and ``work`` are then
    required; h' and scal' of ``out`` are left to the assemble.
    """
    if cells is not None:
        return _fused_cells(op, x, g, d, h, scal, prec, out, work, cells)
    if _route(x) == "plain":
        res = _fused_iteration_plain(
            op, x, g, d, h, scal, prec,
            carry=None if work is None else work.carry)
        return res if out is None else tuple(o.copy_(r)
                                             for o, r in zip(out, res))
    out = out if out is not None else tuple(
        torch.empty_like(t) for t in (x, g, d, h, scal))
    shape = _check_iteration(op, x, g, d, h, scal, prec, out)
    work = Workspace(op, d.shape[0]) if work is None else work
    _check_work(work, d.shape[0])
    if op.slab is not None:
        _block_entry(op, x, g, d, h, scal, prec, out, work,
                     (0, op.n_cells_axis[0]), _CELL_PASS | _NODE_PASSES,
                     shape)
        fused_cg_iteration.launches += 1
        return out
    lib = _build.load()
    ncz, ncy, ncx = op.n_cells_axis
    common = _common_args(op, d, shape)
    rc = lib.bp4_fused_iteration(
        *common[:8], int(prec.dtype == torch.bfloat16),
        int(x.dtype == torch.bfloat16), *common[8:],
        *(t.data_ptr() for t in (x, g, d, h, prec, scal)),
        *(t.data_ptr() for t in out), work.cells.data_ptr(),
        work.partials.data_ptr(), _b12_scratch(op, shape), ncz, ncy, ncx,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "bp4_fused_iteration")
    fused_cg_iteration.launches += 1
    return out


fused_cg_iteration.launches = 0


def _check_iteration(op: OperatorData, x, g, d, h, scal, prec, out) -> int:
    """Check a B2 launch's tensors (:func:`_check_cuda`), its buffers
    distinct from its inputs and, on a block operator, its pass; returns
    the kernels' shape argument."""
    shape = _check_cuda(op, [g, out[1]], [d, h, out[2], out[3]], prec,
                        (scal, out[4]), (x, out[0]))
    if {t.data_ptr() for t in out} & {t.data_ptr() for t in (x, g, d, h,
                                                             scal)}:
        raise ValueError("fused_cg_iteration cannot update in place: pass "
                         "output buffers distinct from the inputs")
    if (op.slab is not None and op.metric_dtype == torch.bfloat16
            and op.precision in ("highest", "split2m")):
        raise NotImplementedError(
            f"B2's block form with a bf16 metric under {op.precision!r} is "
            f"not instantiated (no distributed path streams a bf16 "
            f"metric)")
    if (op.slab is not None and op.factor == "twostage"
            and op.precision in laplace_cuda.TENSOR_RUNGS):
        raise NotImplementedError(
            f"B2's block form on the {op.precision} rung's twostage pass "
            f"is not instantiated (the distributed solvers' operator is "
            f"dense)")
    if (op.slab is not None and op.metric == "onthefly"
            and op.cofactor == "jtj"
            and op.precision in laplace_cuda.TENSOR_RUNGS):
        raise NotImplementedError(
            f"B2's block form with the metric rebuilt by jtj on the "
            f"{op.precision} rung's dense pass is not instantiated (the "
            f"distributed solvers rebuild it by adjj)")
    return shape


# passes of bp4_fused_iteration_block (csrc/cg_fused.cu)
_CELL_PASS, _NODE_PASSES = 1, 2


def _block_entry(op: OperatorData, x, g, d, h, scal, prec, out,
                 work: Workspace, cells: tuple[int, int], passes: int,
                 shape: int):
    """Launch B2's block form (``bp4_fused_iteration_block``): ``passes``
    of it, the cell pass over the cells of the layers ``cells``, at the
    kernels' ``shape`` (0, or one component: CEED BP3)."""
    lib = _build.load()
    ncz, ncy, ncx = op.n_cells_axis
    layer = ncy * ncx
    common = _common_args(op, d, shape)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.bp4_fused_iteration_block(
        *common[:8], int(prec.dtype == torch.bfloat16),
        int(x.dtype == torch.bfloat16), *common[8:],
        *(t.data_ptr() for t in (x, g, d, h, prec, scal)),
        *(t.data_ptr() for t in out), work.cells.data_ptr(),
        work.partials.data_ptr(), _b12_scratch(op, shape), ncz, ncy, ncx,
        *block_faces(op), cells[0] * layer, cells[1] * layer, passes,
        stream)
    _build.check(lib, rc, "bp4_fused_iteration_block")
    if passes & _NODE_PASSES and d.dtype == torch.bfloat16:
        # C10: the top z face of h' at f32, before the store rounded it
        rc = lib.bp4_block_carry(op.degree, d.shape[0], ncz, ncy, ncx,
                                 *block_faces(op), work.cells.data_ptr(),
                                 work.carry.data_ptr(), stream)
        _build.check(lib, rc, "bp4_block_carry")


def _check_range_form(op: OperatorData, out, work,
                      cells: tuple[int, int] | None = None) -> None:
    if op.slab is None:
        raise ValueError("the layer-range form of B2 runs on a block "
                         "operator (op.slab)")
    if out is None or work is None:
        raise ValueError("the layer-range form of B2 needs its out and "
                         "work buffers")
    if cells is not None and not 0 <= cells[0] < cells[1] <= \
            op.n_cells_axis[0]:
        raise ValueError(f"cell layers {cells} are not a range of the "
                         f"block's {op.n_cells_axis[0]}")


def _fused_cells(op: OperatorData, x, g, d, h, scal, prec, out, work,
                 cells: tuple[int, int]):
    """:func:`fused_cg_iteration`'s layer-range form: the cell pass over
    the cell layers ``cells``."""
    _check_range_form(op, out, work, cells)
    if _route(x) == "plain":
        _cells_plain(op, x, g, d, h, scal, prec, out, work, *cells)
        return out
    shape = _check_iteration(op, x, g, d, h, scal, prec, out)
    _check_work(work, d.shape[0])
    _block_entry(op, x, g, d, h, scal, prec, out, work, cells, _CELL_PASS,
                 shape)
    fused_cg_iteration.launches += 1
    return out


def fused_cg_assemble(op: OperatorData, out, prec, scal,
                      work: Workspace):
    """The node passes of B2's layer-range form (after the cell passes of
    :func:`fused_cg_iteration` with ``cells`` over ranges that tile the
    block's layers): h' from ``work``'s cell-local results, masked, into
    ``out[3]``, and the 7 raw sums over the owned nodes and a 0 into
    ``out[4]``, read from x', g', d' in ``out`` and ``prec``; ``scal``
    the iteration's scalars.  Returns ``out``."""
    _check_range_form(op, out, work)
    if _route(out[1]) == "plain":
        _assemble_plain(op, out, prec, work)
        return out
    shape = _check_cuda(op, [out[1]], [out[2], out[3]], prec,
                        (scal, out[4]), (out[0],))
    if work.partials is None:
        raise ValueError("the work buffers are not a CUDA workspace")
    _check_work(work, out[2].shape[0])
    # the node passes read g', d', P and (not in the block form) scal
    _block_entry(op, out[0], out[1], out[2], out[3], scal, prec, out, work,
                 (0, 0), _NODE_PASSES, shape)
    fused_cg_assemble.launches += 1
    return out


fused_cg_assemble.launches = 0
