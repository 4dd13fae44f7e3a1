"""PyTorch port: the halo/compute overlap of the z-slab ranks against the
JAX package's.

* B2's layer-range form (``cg_fused_kernel.fused_cg_iteration`` with
  ``cells``, then ``fused_cg_assemble``; its plain version here) against
  the one call, bitwise, and against the JAX kernel's ``step_range`` /
  ``carry0`` pair in interpret mode (f64, 1e-12);
* the overlapped solves on gloo CPU ranks (``parallel/comm.py``, the plain
  versions): ``solve_fused(overlap=True)`` bitwise the solve without it;
  the merged and baseline solvers' boundary-first apply
  (``dist_vmult(overlap=True)``, each layer range through the same
  operator on its own sub-lattice) within 1e-9 max(1, |x|) of the solve
  without it and of the JAX package's ``solve(overlap=True)`` (its
  structured backend: plain XLA, the same operator) with itCG equal — the
  sums at the layer seams are taken in another order, so not bitwise;
* the fallbacks (the fused solver below 2 cell layers a slab, the merged
  one below 3) and the refusal on a rank mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.ops import cg_fused_kernel as jfk
from mf_data_locality_tpu.parallel import dist_fused as jdist_fused
from mf_data_locality_tpu.parallel import distributed as jdist
from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import DofLayout
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_cuda
from mf_data_locality_tpu_torch.parallel import dist_fused
from mf_data_locality_tpu_torch.parallel import distributed as dist

TOL_X = 1e-9
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]


def _state(op, store, seed):
    rng = np.random.default_rng(seed)
    mask = op.mask.numpy()
    lat = (3,) + op.n_nodes_axis
    x, g, d, h = (torch.as_tensor(rng.standard_normal(lat) * mask).to(
        op.dtype) for _ in range(4))
    prec = torch.as_tensor((np.abs(rng.standard_normal((1,) + lat[1:]))
                            + 0.5) * mask).to(op.dtype)
    scal = torch.tensor(SCAL, dtype=op.dtype)
    return x, g, d.to(store), h.to(store), scal, prec


def _split(op, state, cuts):
    """The layer-range form over the ranges between ``cuts``, then the
    assemble."""
    out = tuple(torch.full_like(t, float("nan")) for t in state[:5])
    work = fk.Workspace(op)
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        fk.fused_cg_iteration(op, *state, out=out, work=work,
                              cells=(c0, c1))
    return fk.fused_cg_assemble(op, out, state[5], state[4], work)


# (s, p, ranks, rank, precision, metric): z-slabs with a halo plane, rank
# 0's Dirichlet face, a dummy layer ((9, 2, 3, 2)), the tensor-core rungs'
# plain versions (split2m, bf16 with its state)
SPLIT = [(7, 4, 2, 0, "highest", "precomputed"),
         (9, 2, 3, 2, "highest", "onthefly"),
         (9, 3, 2, 1, "split2m", "precomputed"),
         (9, 2, 2, 1, "bf16", "onthefly")]


@pytest.mark.parametrize("case", SPLIT, ids=lambda c: "-".join(map(str, c)))
def test_layer_range_form_is_the_one_call(case):
    """Cell passes over the layers [0, n-1) and [n-1, n) (and over three
    ranges), then one assemble: x', g', d', h' and the sums bitwise those
    of the one call."""
    s, p, n, rank, precision, metric = case
    dtype = {"highest": torch.float64, "split2m": torch.float32,
             "bf16": torch.bfloat16}[precision]
    slab = dist.build_slab(s, p, rank, n, dtype, "pallas", precision,
                           "pieces", metric, "cpu")
    op = slab.op
    state = _state(op, slab.b.dtype if dtype == torch.bfloat16 else op.dtype,
                   seed=s + p + rank)
    want = fk.fused_cg_iteration(op, *state)
    ncz = op.n_cells_axis[0]
    for cuts in ((0, ncz - 1, ncz), (0, 1, ncz - 1, ncz)):
        got = _split(op, state, sorted(set(cuts)))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_layer_range_form_checks():
    slab = dist.build_slab(7, 2, 0, 2, torch.float64, "pallas", "highest",
                           "pieces", "precomputed", "cpu")
    state = _state(slab.op, torch.float64, 1)
    with pytest.raises(ValueError, match="out and work"):
        fk.fused_cg_iteration(slab.op, *state, cells=(0, 1))
    out = tuple(torch.empty_like(t) for t in state[:5])
    with pytest.raises(ValueError, match="not a range"):
        fk.fused_cg_iteration(slab.op, *state, out=out,
                              work=fk.Workspace(slab.op), cells=(1, 5))
    box = laplace_cuda.make_operator(DofLayout(BoxMesh.from_s(3), 2),
                                     torch.float64, windowing="pieces",
                                     device="cpu")
    with pytest.raises(ValueError, match="block operator"):
        fk.fused_cg_iteration(box, *_state(box, torch.float64, 2),
                              out=out, work=fk.Workspace(box), cells=(0, 1))


def _piece(u, p):
    return jfk.to_piece_state(jnp.asarray(u), p)[:, :, :p * p]


def _top_piece(v, p):
    one = np.zeros(v.shape[:1] + (p + 1,) + v.shape[2:])
    one[:, 0] = v[:, -1]
    return _piece(one, p)[:, :1]


def _lattice(v, p, lat):
    ncx = (lat[2] - 1) // p
    return np.asarray(jfk.from_piece_state(jfk._expand_mm(v, p, ncx), p,
                                           lat))


@pytest.mark.parametrize("s,p,D,rank,metric", [
    (7, 2, 2, 1, "precomputed"), (9, 2, 3, 2, "onthefly")])
def test_layer_range_form_matches_jax_step_range(s, p, D, rank, metric):
    """The port's layer-range form against the JAX kernel's split
    (``step_range=(0, n-1)`` without the halo, then ``(n-1, n)`` with it
    and ``carry0``, the sums added, ``dist_fused._solve_local``'s
    overlap), f64 interpret mode: x', g', d', h' on the owned planes, the
    carry and the 7 raw sums to 1e-12."""
    dp, _ = jdist_fused.build_dist_fused(s, p, n_devices=D,
                                         dtype=jnp.float64, metric=metric)
    jop = jax.tree.map(lambda a: a[rank], dp.op_stack)
    slab = dist.build_slab(s, p, rank, D, torch.float64, "pallas",
                           "highest", "pieces", metric, "cpu")
    op = slab.op
    lat = op.n_nodes_axis
    x, g, d, h, scal, prec = (t.numpy() for t in _state(op, torch.float64,
                                                        seed=s * D + rank))
    n = op.n_cells_axis[0]
    pieces = [_piece(v, p) for v in (x, g, d, h)]
    zp = [jfk.zplanes_init(v, p) for v in pieces[1:]]
    halo = tuple(_top_piece(v, p) for v in (g, d, h, prec))
    common = dict(z0=rank * dist.cells_per_slab(dp.ncz_global, D),
                  ncz_global=dp.ncz_global, recurrence=False,
                  want_carry=True, compact=True)
    ppieces = _piece(prec, p)
    *st, s_i, carry_i = jfk.fused_cg_iteration(
        jop, lat, *pieces, *zp, jnp.asarray(scal), ppieces, halo=None,
        step_range=(0, n - 1), **common)
    *st, s_b, carry = jfk.fused_cg_iteration(
        jop, lat, *st, jnp.asarray(scal), ppieces, halo=halo,
        step_range=(n - 1, n), carry0=carry_i, **common)
    got = _split(op, tuple(torch.as_tensor(v) for v in
                           (x, g, d, h, scal, prec)), (0, n - 1, n))
    Pp = lat[0] - 1
    for a, want in zip(got[:4], st[:4]):
        want = _lattice(want, p, lat)[:, :Pp]
        np.testing.assert_allclose(a.numpy()[:, :Pp], want, rtol=0,
                                   atol=1e-12 * max(np.abs(want).max(), 1))
    cw = np.concatenate([np.asarray(carry),
                         np.zeros((3, p - 1) + carry.shape[2:])], 1)
    cw = _lattice(jnp.asarray(cw), p, (p + 1,) + lat[1:])[:, 0]
    np.testing.assert_allclose(got[3].numpy()[:, -1], cw, rtol=0,
                               atol=1e-12 * max(np.abs(cw).max(), 1.0))
    np.testing.assert_allclose(got[4].numpy()[:7],
                               np.asarray(s_i + s_b)[:7], rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("windowing", ["reshape", "pieces", "zslab"])
def test_sub_operator_applies(windowing):
    """B3/B5/B6 on each layer range's sub-operator, summed at the seams,
    give the whole slab's apply (f64, 1e-12): the counterpart of
    ``_sub_op``."""
    from mf_data_locality_tpu_torch.ops import laplace_apply as la

    slab = dist.build_slab(9, 2, 1, 2, torch.float64, "pallas", "highest",
                           windowing, "precomputed", "cpu")
    op, p = slab.op, slab.op.degree
    u = _state(op, torch.float64, 4)[0] * op.mask
    want = la.apply_lattice(op, u)
    got = torch.zeros_like(u)
    for c0, c1 in ((0, 1), (1, 3), (3, 4)):
        sub = laplace_cuda.sub_operator(op, c0, c1)
        assert sub.n_cells_axis == (c1 - c0,) + op.n_cells_axis[1:]
        assert laplace_cuda.sub_operator(op, c0, c1) is sub
        got[:, c0 * p:c1 * p + 1] += la.apply_lattice(
            sub, u[:, c0 * p:c1 * p + 1].contiguous())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * want.abs().max().item())


# the rank runs: (label, ranks, Job)
def _jobs():
    f64 = torch.float64
    out = []
    for n in (2, 3):
        for ov in (False, True):
            out += [(("fused", 4, 7, ov), n,
                     dist.Job("fused", 7, 4, f64, overlap=ov)),
                    (("merged", 4, 7, ov), n,
                     dist.Job("merged", 7, 4, f64, overlap=ov)),
                    (("baseline", 4, 7, ov), n,
                     dist.Job("baseline", 7, 4, f64, overlap=ov))]
        # 4 cell layers a slab on 2 ranks, 3 on 3: the overlap runs
        for w in ("reshape", "pieces", "zslab"):
            for ov in (False, True):
                out.append(((w, 2, 9, ov), n,
                            dist.Job("merged", 9, 2, f64, windowing=w,
                                     overlap=ov)))
    for ov in (False, True):
        # s=12 p=1 on 4 ranks: JAX's own overlap test (4 layers a slab)
        out.append((("structured", 1, 12, ov), 4,
                    dist.Job("merged", 12, 1, f64, backend="structured",
                             max_iter=30, overlap=ov)))
        # the fallbacks: 1 cell layer a slab (fused, merged)
        out.append((("fused", 2, 6, ov), 4,
                    dist.Job("fused", 6, 2, f64, overlap=ov)))
        out.append((("merged", 2, 6, ov), 4,
                    dist.Job("merged", 6, 2, f64, overlap=ov)))
    out.append((("matvec", 2, 9, True), 2,
                dist.Job("matvec", 9, 2, f64, overlap=True)))
    out.append((("matvec", 2, 9, False), 2, dist.Job("matvec", 9, 2, f64)))
    return out


@pytest.fixture(scope="module")
def runs():
    jobs = _jobs()
    out = {}
    for n in sorted({r for _, r, _ in jobs}):
        mine = [(k, j) for k, r, j in jobs if r == n]
        res = dist.launch([j for _, j in mine], n, "cpu")
        out.update({(n,) + k: v for (k, _), v in zip(mine, res)})
    return out


@pytest.mark.parametrize("n", [2, 3])
def test_fused_overlap_is_bitwise(runs, n):
    """``solve_fused(overlap=True)`` at p=4 s=7 (2 cell layers a slab on
    2 and on 3 ranks): itCG 91, x and the history bitwise the solve
    without it, the same collectives."""
    a, b = runs[n, "fused", 4, 7, False], runs[n, "fused", 4, 7, True]
    assert a["it"] == b["it"] == 91
    assert torch.equal(a["x"], b["x"])
    assert np.array_equal(a["history"], b["history"], equal_nan=True)
    assert (a["shifts"], a["allreduces"]) == (b["shifts"], b["allreduces"])


@pytest.mark.parametrize("solver", ["merged", "baseline"])
@pytest.mark.parametrize("n", [2, 3])
def test_merged_overlap_p4s7(runs, n, solver):
    """The merged and baseline solvers with ``overlap`` at p=4 s=7: itCG
    91, x within 1e-9 max(1, |x|) of the solve without it and of the JAX
    package's ``solve(overlap=True)`` (2 cell layers a slab: both fall
    back to the plain apply)."""
    a, b = runs[n, solver, 4, 7, False], runs[n, solver, 4, 7, True]
    assert a["it"] == b["it"] == 91
    dp, mesh = jdist.build_distributed(7, 4, n_devices=n, dtype=jnp.float64,
                                       backend="structured")
    want = jdist.solve(dp, mesh, solver=solver, overlap=True)
    xw = jdist.gather_global(want.x, nz=dp.ncz_global * 4 + 1)
    assert int(want.n_iterations) == 91
    for x in (a["x"].numpy(), xw):
        np.testing.assert_allclose(b["x"].numpy(), x, rtol=0,
                                   atol=TOL_X * max(1.0, np.abs(x).max()))


@pytest.mark.parametrize("w", ["reshape", "pieces", "zslab"])
@pytest.mark.parametrize("n", [2, 3])
def test_merged_overlap_runs_boundary_first(runs, n, w):
    """p=2 s=9 (4 and 3 cell layers a slab): the boundary-first apply on
    B3/B5/B6's plain versions, each layer range on its own sub-lattice —
    itCG equal, x within 1e-9 max(1, |x|) of the plain apply's solve, the
    same shift count; not bitwise (the seams' sums in another order)."""
    a, b = runs[n, w, 2, 9, False], runs[n, w, 2, 9, True]
    assert a["it"] == b["it"]
    assert a["shifts"] == b["shifts"] == 2 * a["it"]
    x = a["x"].numpy()
    np.testing.assert_allclose(b["x"].numpy(), x, rtol=0,
                               atol=TOL_X * max(1.0, np.abs(x).max()))


def test_structured_overlap_matches_jax(runs):
    """JAX's own overlap point (s=12, p=1, 4 ranks, 30 iterations, the
    structured backend): the port's boundary-first solve against
    ``solve(overlap=True)`` and against its own plain solve, 1e-12 as the
    JAX test."""
    a, b = runs[4, "structured", 1, 12, False], runs[4, "structured", 1, 12,
                                                      True]
    dp, mesh = jdist.build_distributed(12, 1, n_devices=4,
                                       dtype=jnp.float64,
                                       backend="structured")
    want = jdist.solve(dp, mesh, solver="merged", max_iter=30, overlap=True)
    xw = jdist.gather_global(want.x, nz=dp.ncz_global + 1)
    assert b["it"] == a["it"] == int(want.n_iterations)
    for x in (xw, a["x"].numpy()):
        np.testing.assert_allclose(b["x"].numpy(), x, rtol=0,
                                   atol=1e-12 * max(1.0, np.abs(x).max()))


@pytest.mark.parametrize("solver", ["fused", "merged"])
def test_overlap_fallback_one_layer(runs, solver):
    """One cell layer a slab (s=6 on 4 ranks): both solvers fall back to
    the solve without overlap, bitwise (the JAX package's fallbacks,
    ``tests/test_dist_fused.py:169``)."""
    a, b = runs[4, solver, 2, 6, False], runs[4, solver, 2, 6, True]
    assert a["it"] == b["it"]
    assert torch.equal(a["x"], b["x"])


def test_overlap_matvec_matches_jax(runs):
    """The overlapped matvec (``dist_vmult(overlap=True)``, the CLI's
    matvec column) against JAX's ``dist_matvec_jit(overlap=True)`` on its
    structured backend and against the plain one, 1e-12."""
    got = runs[2, "matvec", 2, 9, True]["x"].numpy()
    plain = runs[2, "matvec", 2, 9, False]["x"].numpy()
    dp, mesh = jdist.build_distributed(9, 2, n_devices=2, dtype=jnp.float64,
                                       backend="structured")
    mv = jdist.dist_matvec_jit(dp, mesh, overlap=True)
    want = jdist.gather_global(mv(dp.op_stack, dp.b), nz=dp.ncz_global * 2
                               + 1)
    for x in (want, plain):
        np.testing.assert_allclose(got, x, rtol=0,
                                   atol=1e-12 * np.abs(x).max())


def test_overlap_refused_on_meshes():
    """The (z, y) mesh and the general backend have no overlapped apply
    (the JAX package's ``dist_vmult_2d``, ``solve_2d``, ``solve_fused_2d``
    take none): ValueError."""
    with pytest.raises(ValueError, match="z-slab"):
        dist.check_distributed("merged", "general", "reshape",
                               "precomputed", overlap=True)
    for solver, windowing in (("merged", "reshape"), ("fused", "pieces")):
        blk = dist.build_block(6, 2, (0, 0), (2, 2), torch.float64,
                               "pallas", "highest", windowing,
                               "precomputed", "cpu")
        with pytest.raises(ValueError, match="z-slabs only"):
            if solver == "fused":
                dist_fused.solve_fused(blk, None, overlap=True)
            else:
                dist.dist_vmult(blk, None, blk.b, overlap=True)
