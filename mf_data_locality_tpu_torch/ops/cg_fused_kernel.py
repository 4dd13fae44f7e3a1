"""The BP4 operator apply and the fused merged-CG iteration, on lattice vectors.

Counterparts of ``mf_data_locality_tpu.ops.cg_fused_kernel``:

* :func:`matvec` — ``piece_vmult`` (TPU kernel ``_matvec_kernel``):
  ``h = M A M d`` with ``M`` the Dirichlet mask.
* :func:`fused_cg_iteration` — ``fused_cg_iteration`` (TPU kernel
  ``_fused_cg_kernel``): one merged-CG iteration — update4b, the operator
  on d', the seven update3b sums and the scalar recurrence.

Vectors are lattices ``(C, Nz, Ny, Nx)`` that vanish on the boundary (the
solver's invariant); the preconditioner is ``(1, Nz, Ny, Nx)``; ``scal`` is
the 8-vector (alpha, beta, c1, aob, parity, res2, alpha_old, beta_old).

The operator is the one ``op`` was built with (``op.factor``, ``op.metric``;
``laplace_cuda.fused_configs``): the dense factorization or twostage, the
metric streamed (``op.gmetric``) or rebuilt per q-point from the
coefficients, at degrees 1..4.  Each wrapper runs the hand-written CUDA
kernel (``csrc/cg_fused.cu``) for tensors on a CUDA device and the plain
PyTorch version (:func:`_matvec_plain`, :func:`_fused_iteration_plain`)
for tensors on the CPU; other devices raise.  The kernel's cell pass:

* ``highest`` (f32, f64), every configuration: the sum-factorized pass of
  ``csrc/apply_sumfac.cuh`` on ``op.sz``/``op.dz``, the metric streamed or
  rebuilt from ``op.coeffs`` — the dense and twostage operators are one
  function, which it sums in another order than the plain versions;
* f32 ``split2m``, dense: the tensor-core pass of ``csrc/apply_mma.cuh`` on
  the bf16 tables ``op.mma_mats`` of the dense M, the metric streamed or
  rebuilt;
* f32 ``split2m``, twostage + onthefly (p=4): the tensor-core pass of
  ``csrc/cell_mma.cuh`` on the 2D stage's tables.

The plain versions do the same arithmetic — the same bf16 rounding points
for ``split2m``, the same masking — with einsum over cells, in another
summation order.  ``matvec.launches`` and ``fused_cg_iteration.launches``
count kernel launches (not plain calls).
"""

from __future__ import annotations

import torch

from mf_data_locality_tpu_torch.ops import _build, laplace_cuda
from mf_data_locality_tpu_torch.ops.laplace_cuda import OperatorData

N_COMPONENTS = 3


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _parts(t: torch.Tensor, split: bool) -> tuple[torch.Tensor, ...]:
    """Stream parts: (t,) or its bf16 hi/lo pair (``_stream_parts``)."""
    if not split:
        return (t,)
    hi = t.to(torch.bfloat16).to(t.dtype)
    return hi, (t - hi).to(torch.bfloat16).to(t.dtype)


def metric_onthefly(op: OperatorData) -> torch.Tensor:
    """(6, n_cells, q^3) metric entries (00, 01, 02, 11, 12, 22) rebuilt from
    the trilinear coefficients: J = pds . c, adjugate chain, G = w adj
    adj^T / det (``_metric_onthefly``, adjj form; J in exact arithmetic)."""
    q3 = op.n_q ** 3
    pds = op.pds.reshape(3, q3, 8)
    J = torch.einsum("eqk,dkn->denq", pds, op.coeffs)  # (3, 3, nc, q3)
    (a, b, c), (d, e, f), (g, h, i) = J
    adj = [[e * i - f * h, c * h - b * i, b * f - c * e],
           [f * g - d * i, a * i - c * g, c * d - a * f],
           [d * h - e * g, b * g - a * h, a * e - b * d]]
    det = a * adj[0][0] + b * adj[1][0] + c * adj[2][0]
    scale = op.w3.reshape(1, q3) / torch.where(det == 0, torch.ones_like(det),
                                               det)
    return torch.stack([(adj[r][0] * adj[s][0] + adj[r][1] * adj[s][1]
                         + adj[r][2] * adj[s][2]) * scale
                        for r in range(3) for s in range(r, 3)])


def cell_metric(op: OperatorData) -> torch.Tensor:
    """(6, n_cells, q^3) metric entries of ``op``: the streamed
    ``op.gmetric``, or rebuilt from the coefficients."""
    if op.gmetric is None:
        return metric_onthefly(op)
    return op.gmetric.reshape(6, op.n_q ** 3, op.n_cells).transpose(1, 2)


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


def _cell_apply(op: OperatorData, u: torch.Tensor) -> torch.Tensor:
    """Cell-local operator in ``op.factor``'s form: (C, Nz, Ny, Nx) -> (C,
    n_cells, p1, p1^2).  Dense: ``laplace_apply._batched_plain`` on the
    cells; twostage: the z stage by S and D, then the 2D matrices."""
    # laplace_apply imports this module, so it is imported here
    from mf_data_locality_tpu_torch.ops import laplace_apply

    split = op.precision == "split2m"
    if op.factor == "dense":
        return _on_batch(op, u, lambda b, G: laplace_apply._batched_plain(
            op, b, G, split))
    q = op.n_q
    q2 = q * q
    cells = _cells(op, u)                                   # (C, n, kz, k2)
    uS = torch.einsum("qk,cnkr->cnqr", op.sz, cells)
    uD = torch.einsum("qk,cnkr->cnqr", op.dz, cells)
    mxy, mz = op.mats2d[:2 * q2], op.mats2d[2 * q2:]
    gxy = sum(torch.einsum("sr,cnqr->cnqs", mxy, b) for b in _parts(uS, split))
    gz = sum(torch.einsum("sr,cnqr->cnqs", mz, b) for b in _parts(uD, split))
    gx, gy = gxy[..., :q2], gxy[..., q2:]
    G = cell_metric(op).reshape(6, 1, op.n_cells, q, q2)
    t0 = G[0] * gx + G[1] * gy + G[2] * gz
    t1 = G[1] * gx + G[3] * gy + G[4] * gz
    t2 = G[2] * gx + G[4] * gy + G[5] * gz
    t01 = torch.cat([t0, t1], dim=-1)
    w1 = sum(torch.einsum("sr,cnqs->cnqr", mxy, b) for b in _parts(t01, split))
    w2 = sum(torch.einsum("sr,cnqs->cnqr", mz, b) for b in _parts(t2, split))
    return (torch.einsum("qk,cnqr->cnkr", op.sz, w1)
            + torch.einsum("qk,cnqr->cnkr", op.dz, w2))


def _cell_apply_mma_emulated(op: OperatorData,
                             u: torch.Tensor) -> torch.Tensor:
    """The split2m tensor-core cell passes' arithmetic in plain PyTorch, for
    the tests.  Dense (``csrc/apply_mma.cuh`` in its lattice forms):
    ``laplace_apply._batched_mma_emulated`` on the cells with the streamed
    or rebuilt metric.  Twostage (``csrc/cell_mma.cuh``): the 2D matrices
    from their packed bf16 tables, (ky, kx) columns and q^2 rows
    zero-padded, the f32 z stage unrounded, the K-stacked products [Mh | Mh]
    [uh; ul] and, after the metric apply, [Mh | Mh]^T [th; tl] in f32.
    Same result shape as :func:`_cell_apply`."""
    if op.factor == "dense":
        from mf_data_locality_tpu_torch.ops import laplace_apply

        return _on_batch(op, u, lambda b, G: laplace_apply
                         ._batched_mma_emulated(op, b, G))
    p, q = op.degree, op.n_q
    p1, q2 = p + 1, q * q
    q2p, p12p = laplace_cuda.mma_dims(p, "twostage")
    mf, mb = (m.to(op.dtype) for m in laplace_cuda.unpack_mma_tables(
        op.mma_mats, p, "twostage"))
    cells = torch.nn.functional.pad(_cells(op, u), (0, p12p - p1 * p1))
    uS = torch.einsum("qk,cnkr->cnqr", op.sz, cells)
    uD = torch.einsum("qk,cnkr->cnqr", op.dz, cells)

    def fwd(m, b):  # (rows, p12p) x (..., p12p), K-stacked hi/lo
        return torch.cat(_parts(b, True), -1) @ torch.cat([m, m], 1).t()

    gxy = fwd(mf[:2 * q2p], uS)
    gx, gy, gz = gxy[..., :q2p], gxy[..., q2p:], fwd(mf[2 * q2p:], uD)
    G = torch.nn.functional.pad(
        cell_metric(op).reshape(6, 1, op.n_cells, q, q2), (0, q2p - q2))
    t0 = G[0] * gx + G[1] * gy + G[2] * gz
    t1 = G[1] * gx + G[3] * gy + G[4] * gz
    t2 = G[2] * gx + G[4] * gy + G[5] * gz

    def bwd(m, b):  # (rows, p12p)^T x (..., rows), K-stacked hi/lo
        return torch.cat(_parts(b, True), -1) @ torch.cat([m, m], 0)

    w1 = bwd(mb[:2 * q2p], torch.cat([t0, t1], -1))[..., :p1 * p1]
    w2 = bwd(mb[2 * q2p:], t2)[..., :p1 * p1]
    return (torch.einsum("qk,cnqr->cnkr", op.sz, w1)
            + torch.einsum("qk,cnqr->cnkr", op.dz, w2))


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
    """Sum cell-local values (C, n_cells, p1, p1^2) into the lattice."""
    p = op.degree
    p1 = p + 1
    ncz, ncy, ncx = op.n_cells_axis
    v = v.reshape(v.shape[0], ncz, ncy, ncx, p1, p1, p1)
    out = torch.zeros((v.shape[0],) + op.n_nodes_axis, dtype=v.dtype,
                      device=v.device)
    for kz in range(p1):
        for ky in range(p1):
            for kx in range(p1):
                out[:, kz:kz + p * ncz:p, ky:ky + p * ncy:p,
                    kx:kx + p * ncx:p] += v[..., kz, ky, kx]
    return out


def _matvec_plain(op: OperatorData, d: torch.Tensor,
                  cell_apply=_cell_apply) -> torch.Tensor:
    """h = M A M d; ``cell_apply`` the cell pass (the tests pass the
    kernels' emulations)."""
    return _assemble(op, cell_apply(op, d * op.mask)) * op.mask


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
                           cell_apply=_cell_apply):
    alpha, beta, c1, aob = scal[0], scal[1], scal[2], scal[3]
    g2 = g + alpha * h
    d2 = beta * d - prec * g2
    x2 = x + c1 * d + aob * (prec * g)
    h2 = _matvec_plain(op, d2, cell_apply)
    ph, pg = prec * h2, prec * g2
    s = torch.stack([torch.sum(d2 * h2), torch.sum(h2 * h2),
                     torch.sum(g2 * h2), torch.sum(g2 * g2),
                     torch.sum(g2 * ph), torch.sum(h2 * ph),
                     torch.sum(g2 * pg), torch.zeros((), dtype=g.dtype,
                                                     device=g.device)])
    return x2, g2, d2, h2, scalar_recurrence(s, alpha, beta, scal[4])


def delayed_x_fixup(x, g, d, prec, scal, it: int):
    """Delayed-x exit fixup (``solver_cg_optimized.h:254-289``): the merged
    recurrence updates x every second iteration; on exit the pending
    contribution is applied with the parity-dependent coefficient."""
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


def _check_cuda(op: OperatorData, vectors, prec=None, scals=()) -> None:
    want = [(v, (N_COMPONENTS,) + op.n_nodes_axis) for v in vectors]
    if prec is not None:
        want.append((prec, (1,) + op.n_nodes_axis))
    want += [(s, (8,)) for s in scals]
    q, p1, q3 = op.n_q, op.degree + 1, op.n_q ** 3
    want += [(op.sz, (q, p1)), (op.dz, (q, p1)), (op.kpds, (q3, 24)),
             (op.w3, (q3, 1))]
    if op.gmetric is not None:
        want.append((op.gmetric, (6 * q3, op.n_cells)))
    twostage_split = op.precision == "split2m" and op.factor == "twostage"
    if op.precision == "split2m":
        rp, cp = laplace_cuda.mma_dims(op.degree, op.factor)
        want.append((op.mma_mats, (2, 3 * rp * cp), torch.bfloat16))
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


def _route(t: torch.Tensor) -> str:
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "kernel"
    raise ValueError(f"no kernel for device {t.device}")


def dtype_code(op: OperatorData) -> int:
    """The kernels' dtype argument: 0 = float32, 1 = float64."""
    return {torch.float32: 0, torch.float64: 1}[op.dtype]


def _common_args(op: OperatorData):
    # split2m: the bf16 fragment tables of the factorization's tensor-core
    # pass (dense: apply_mma.cuh, the coefficients (3, 8, n_cells);
    # twostage: cell_mma.cuh, the coefficients a row per cell); highest: no
    # matrix (the sum-factorized pass applies S and D), the coefficients
    # (3, 8, n_cells), the cell fastest.  The metric: streamed, or null
    # (rebuilt from the coefficients).
    split = op.precision == "split2m"
    dense = op.factor == "dense"
    return (dtype_code(op), int(split), op.degree, int(dense),
            op.mma_mats.data_ptr() if split else None,
            op.sz.data_ptr(), op.dz.data_ptr(), op.kpds.data_ptr(),
            op.w3.data_ptr(),
            (op.kcoeffs if split and not dense else op.coeffs).data_ptr(),
            None if op.gmetric is None else op.gmetric.data_ptr())


class Workspace:
    """Scratch of the kernels: cell-local results (C, n_cells, (p+1)^3) and
    the per-block dot partials.  Allocate once per solve and pass it to
    every call to keep allocation out of the iteration loop."""

    def __init__(self, op: OperatorData):
        p1 = op.degree + 1
        self.cells = torch.empty((N_COMPONENTS, op.n_cells, p1 ** 3),
                                 dtype=op.dtype, device=op.device)
        ncz, ncy, ncx = op.n_cells_axis
        n = _build.load().bp4_partials_len(op.degree, ncz, ncy, ncx)
        self.partials = torch.empty((n,), dtype=op.dtype, device=op.device)


def matvec(op: OperatorData, d: torch.Tensor, out: torch.Tensor | None = None,
           work: Workspace | None = None) -> torch.Tensor:
    """h = M A M d on a (C, Nz, Ny, Nx) lattice vector (``piece_vmult``)."""
    if _route(d) == "plain":
        h = _matvec_plain(op, d)
        return h if out is None else out.copy_(h)
    _check_cuda(op, [d] + ([out] if out is not None else []))
    lib = _build.load()
    out = torch.empty_like(d) if out is None else out
    work = Workspace(op) if work is None else work
    ncz, ncy, ncx = op.n_cells_axis
    rc = lib.bp4_matvec(*_common_args(op), d.data_ptr(),
                        work.cells.data_ptr(), out.data_ptr(), ncz, ncy, ncx,
                        torch.cuda.current_stream(d.device).cuda_stream)
    _build.check(lib, rc, "bp4_matvec")
    matvec.launches += 1
    return out


matvec.launches = 0


def fused_cg_iteration(op: OperatorData, x, g, d, h, scal, prec,
                       out=None, work: Workspace | None = None):
    """One merged-CG iteration; returns (x', g', d', h', scal').

    ``out``: optional (x', g', d', h', scal') buffers, distinct from the
    inputs (the kernel reads every node's old values after other cells
    have written theirs, so it cannot update in place).
    """
    if _route(x) == "plain":
        res = _fused_iteration_plain(op, x, g, d, h, scal, prec)
        return res if out is None else tuple(o.copy_(r)
                                             for o, r in zip(out, res))
    out = out if out is not None else tuple(
        torch.empty_like(t) for t in (x, g, d, h, scal))
    _check_cuda(op, [x, g, d, h, *out[:4]], prec, (scal, out[4]))
    if {t.data_ptr() for t in out} & {t.data_ptr() for t in (x, g, d, h,
                                                             scal)}:
        raise ValueError("fused_cg_iteration cannot update in place: pass "
                         "output buffers distinct from the inputs")
    lib = _build.load()
    work = Workspace(op) if work is None else work
    ncz, ncy, ncx = op.n_cells_axis
    rc = lib.bp4_fused_iteration(
        *_common_args(op), *(t.data_ptr() for t in (x, g, d, h, prec, scal)),
        *(t.data_ptr() for t in out), work.cells.data_ptr(),
        work.partials.data_ptr(), ncz, ncy, ncx,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "bp4_fused_iteration")
    fused_cg_iteration.launches += 1
    return out


fused_cg_iteration.launches = 0
