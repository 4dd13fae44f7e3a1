"""PyTorch port: one rank's z-slab against the JAX package's, in-process.

The JAX side builds its ``DistributedBP4`` on the 8 virtual CPU devices of
``tests/conftest.py`` and runs B2's slab form (``fused_cg_iteration`` with
``halo``, ``z0``, ``ncz_global``, ``recurrence=False``,
``want_carry=True``) in interpret mode; the port runs its plain versions
on the CPU.  Inputs are made with numpy from a seed and handed to both.
No rank processes here (``test_torch_dist_*.py`` spawn them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.ops import cg_fused_kernel as jfk
from mf_data_locality_tpu.parallel import dist_fused as jdist_fused
from mf_data_locality_tpu.parallel import distributed as jdist
from mf_data_locality_tpu_torch import benchmark
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.parallel import distributed as dist
from mf_data_locality_tpu_torch.parallel import dryrun
from mf_data_locality_tpu_torch.solvers import cg, cg_merged


def jax_rank_arrays(dp, rank: int, backend: str = "pallas") -> dict:
    """Device ``rank``'s arrays of a JAX ``DistributedBP4`` as numpy, the
    keywords of ``bp4.slab_from_jax_arrays``."""
    def leaf(a):
        return None if a is None else np.array(a[rank])

    out = dict(rank=rank, ncz_global=dp.ncz_global,
               n_dofs=dp.n_dofs, n_cells=dp.n_cells, b=leaf(dp.b),
               inv_diag=leaf(dp.inv_diag), weight=leaf(dp.weight),
               backend=backend)
    op = dp.op_stack
    if backend == "structured":
        out.update({k: leaf(getattr(op, k)) for k in
                    ("values", "d_col", "q_pts", "w3", "coeffs", "mask")})
        out["degree"] = out["values"].shape[1] - 1
        return out
    out.update(pds=leaf(op.pds), w3=leaf(op.w3), coeffs=leaf(op.coeffs),
               mask=leaf(op.mask), mats=leaf(op.mats),
               mats2d=leaf(op.mats2d), precision=op.precision,
               windowing=op.windowing, gmetric=leaf(op.gmetric))
    out["degree"] = round(out["mats"].shape[1] ** (1 / 3)) - 1
    return out


@pytest.mark.parametrize("s,p,D", [(6, 2, 4), (7, 2, 3), (6, 3, 2),
                                   (6, 1, 8), (9, 2, 5)])
def test_slab_arrays_match_jax(s, p, D):
    """Each rank's own build (slab_arrays / build_slab) equals the JAX
    slabs cut from the global arrays: mask, b and weight exactly; the
    coefficients, the preconditioner and the streamed metric to 1e-14 (the
    two packages map the mesh's vertices in their own vectorized sines,
    which round a few apart by an ulp)."""
    dp, _ = jdist.build_distributed(s, p, n_devices=D, dtype=jnp.float64,
                                    backend="pallas", windowing="pieces")
    for r in range(D):
        want = jax_rank_arrays(dp, r)
        slab = dist.build_slab(s, p, r, D, torch.float64, "pallas",
                               "highest", "pieces", "precomputed", "cpu")
        op = slab.op
        np.testing.assert_array_equal(op.mask.numpy(), want["mask"])
        np.testing.assert_array_equal(slab.b.numpy(), want["b"])
        np.testing.assert_array_equal(slab.weight.numpy(), want["weight"])
        nc = op.n_cells
        np.testing.assert_allclose(op.coeffs.numpy(),
                                   want["coeffs"][:, :, :nc], rtol=0,
                                   atol=1e-14 * np.abs(want["coeffs"]).max())
        np.testing.assert_allclose(slab.inv_diag.numpy(), want["inv_diag"],
                                   rtol=1e-14, atol=0)
        np.testing.assert_allclose(op.gmetric.numpy(),
                                   want["gmetric"][:, :nc], rtol=0,
                                   atol=1e-14 * np.abs(want["gmetric"]).max())
        ny, nx = want["mask"].shape[2:]
        assert op.slab == ((r * dist.cells_per_slab(dp.ncz_global, D), 0, 0),
                           (dp.ncz_global, (ny - 1) // p, (nx - 1) // p))


@pytest.mark.parametrize("windowing", ["reshape", "pieces", "zslab"])
def test_slab_from_jax_arrays_is_the_ranks_build(windowing):
    """slab_from_jax_arrays on the JAX package's device arrays gives the
    operator, b, preconditioner and weights of the port's own build."""
    s, p, D = 7, 2, 3
    dp, _ = jdist.build_distributed(s, p, n_devices=D, dtype=jnp.float64,
                                    backend="pallas", windowing=windowing)
    for r in range(D):
        got = bp4.slab_from_jax_arrays(**jax_rank_arrays(dp, r),
                                       device="cpu")
        own = dist.build_slab(s, p, r, D, torch.float64, "pallas",
                              "highest", windowing, "precomputed", "cpu")
        assert got.op.slab == own.op.slab
        assert got.op.n_cells_axis == own.op.n_cells_axis
        for name in ("mats", "coeffs", "mask", "pds", "w3", "sz", "dz"):
            np.testing.assert_allclose(getattr(got.op, name).numpy(),
                                       getattr(own.op, name).numpy(),
                                       rtol=0, atol=1e-14)
        np.testing.assert_allclose(got.op.gmetric.numpy(),
                                   own.op.gmetric.numpy(), rtol=1e-13,
                                   atol=1e-15)
        for name in ("b", "inv_diag", "weight"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       getattr(own, name).numpy(),
                                       rtol=1e-14, atol=0)


def test_slab_from_jax_arrays_structured():
    s, p, D = 6, 3, 2
    dp, _ = jdist.build_distributed(s, p, n_devices=D, dtype=jnp.float64,
                                    backend="structured")
    for r in range(D):
        got = bp4.slab_from_jax_arrays(**jax_rank_arrays(dp, r,
                                                         "structured"),
                                       device="cpu")
        own = dist.build_slab(s, p, r, D, torch.float64, "structured",
                              device="cpu")
        for name in ("values", "d_col", "q_pts", "w3", "coeffs", "mask"):
            np.testing.assert_allclose(getattr(got.op, name).numpy(),
                                       getattr(own.op, name).numpy(),
                                       rtol=0, atol=1e-14)


def _piece(u, p):
    return jfk.to_piece_state(jnp.asarray(u), p)[:, :, :p * p]


def _top_piece(v, p):
    """The top plane of lattice ``v`` in compact piece form (C, 1, p^2,
    B), as the plane 0 of a one-layer lattice."""
    one = np.zeros(v.shape[:1] + (p + 1,) + v.shape[2:])
    one[:, 0] = v[:, -1]
    return _piece(one, p)[:, :1]


def _lattice(v, p, lat):
    ncx = (lat[2] - 1) // p
    return np.asarray(jfk.from_piece_state(jfk._expand_mm(v, p, ncx), p,
                                           lat))


@pytest.mark.parametrize("metric", ["precomputed", "onthefly"])
@pytest.mark.parametrize("s,p,D,rank", [(6, 2, 4, 1), (6, 2, 4, 0),
                                        (6, 2, 4, 3), (7, 2, 3, 1),
                                        (9, 2, 3, 2), (6, 3, 2, 1),
                                        (6, 1, 8, 5)])
def test_slab_iteration_matches_jax(s, p, D, rank, metric):
    """One block-form iteration on a z-slab (the JAX kernel's slab form)
    from a random state whose top plane is the upper rank's plane 0 (the
    halo): x', g', d', h' on the owned planes,
    the carry (h''s top plane) and the 7 raw sums agree with the JAX
    kernel's to 1e-12 — the Dirichlet faces by global position (rank 0's
    plane 0, the global top, dummy layers at (9, 2, 3, 2) and every plane
    of (7, 2, 3, 2)'s kind), the sums over planes [0, Pp)."""
    dp, _ = jdist_fused.build_dist_fused(s, p, n_devices=D,
                                         dtype=jnp.float64, metric=metric)
    jop = jax.tree.map(lambda a: a[rank], dp.op_stack)
    slab = dist.build_slab(s, p, rank, D, torch.float64, "pallas",
                           "highest", "pieces", metric, "cpu")
    op = slab.op
    lat = op.n_nodes_axis
    mask = op.mask.numpy()
    rng = np.random.default_rng(100 * s + 10 * D + rank)
    x, g, d, h = (rng.standard_normal((3,) + lat) * mask for _ in range(4))
    prec = (np.abs(rng.standard_normal((1,) + lat)) + 0.5) * mask
    scal = np.array([0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6])

    Pp = lat[0] - 1
    pieces = [_piece(v, p) for v in (x, g, d, h)]
    # the halo: the top plane as the upper rank's piece-state plane 0
    halo = tuple(_top_piece(v, p) for v in (g, d, h, prec))
    ppieces = _piece(prec, p)
    L = dist.cells_per_slab(dp.ncz_global, D)
    out = jfk.fused_cg_iteration(
        jop, lat, *pieces, *(jfk.zplanes_init(v, p) for v in pieces[1:]),
        jnp.asarray(scal), ppieces, halo=halo, z0=rank * L,
        ncz_global=dp.ncz_global, recurrence=False, want_carry=True,
        compact=True)
    res = fk._fused_iteration_plain(
        op, *(torch.as_tensor(v) for v in (x, g, d, h, scal, prec)))
    for got, want in zip(res[:4], out[:4]):
        want = _lattice(want, p, lat)[:, :Pp]
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got.numpy()[:, :Pp], want, rtol=0,
                                   atol=1e-12 * scale)
    carry = np.concatenate([np.asarray(out[8]),
                            np.zeros((3, p - 1) + out[8].shape[2:])], 1)
    want = _lattice(jnp.asarray(carry), p, (p + 1,) + lat[1:])[:, 0]
    np.testing.assert_allclose(res[3].numpy()[:, -1], want, rtol=0,
                               atol=1e-12 * max(np.abs(want).max(), 1.0))
    np.testing.assert_allclose(res[4].numpy()[:7], np.asarray(out[7])[:7],
                               rtol=1e-12, atol=1e-12)


def test_gather_global_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 3, 5, 4, 4))
    want = jdist.gather_global(x, nz=11)
    got = dist.gather_global([torch.as_tensor(v) for v in x], nz=11)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ncz,n,want", [(4, 3, 2), (8, 3, 3), (4, 4, 1),
                                        (4, 8, 1), (32, 4, 8)])
def test_cells_per_slab(ncz, n, want):
    assert dist.cells_per_slab(ncz, n) == want


def test_solver_hooks_are_identity_by_default():
    """reduce_sums / dot_weight (merged) and reduce_scalar / dot_weight
    (baseline): with the identity and unit weights the solves are the
    ones without hooks, bit for bit."""
    pb = bp4.build(4, 2, torch.float64, device="cpu")
    w = torch.ones((1, 1), dtype=torch.float64)
    for solve, hook in ((cg_merged.merged_cg_solve, "reduce_sums"),
                        (cg.cg_solve, "reduce_scalar")):
        a = (pb.a_apply if solve is cg_merged.merged_cg_solve
             else pb.a_apply_full)
        ref = solve(a, pb.b, pb.inv_diag)
        got = solve(a, pb.b, pb.inv_diag, dot_weight=w,
                    **{hook: lambda t: t.clone()})
        assert got.n_iterations == ref.n_iterations
        assert torch.equal(got.x, ref.x)


def test_refusals():
    """The distributed forms not ported yet name queue A item 9b; what the
    JAX CLI refuses raises ValueError."""
    with pytest.raises(NotImplementedError, match="9b"):
        dist.check_distributed("merged", "pallas", "reshape", "precomputed",
                               overlap=True)
    with pytest.raises(NotImplementedError, match="9b"):
        dist.check_distributed("merged", "general", "reshape", "precomputed")
    with pytest.raises(ValueError, match="pieces"):
        dist.check_distributed("fused", "pallas", "reshape", "precomputed")
    with pytest.raises(ValueError, match="geometry"):
        dist.check_distributed("merged", "pallas", "reshape", "onthefly")
    with pytest.raises(NotImplementedError, match="9b"):
        benchmark.run_one_distributed(4, 7, 2, overlap=True, device="cpu")
    with pytest.raises(NotImplementedError, match="9b"):
        benchmark.run_one_distributed(4, 7, 2, backend="general",
                                      device="cpu")
    with pytest.raises(NotImplementedError, match="9b"):
        dryrun.jobs(8, legs=(4,))
    with pytest.raises(SystemExit):
        benchmark.main(["4", "7", "--devices", "2", "--factor", "twostage",
                        "--device", "cpu"])


def test_bf16_state_refused_in_merged_slabs():
    slab = dist.build_slab(6, 2, 0, 2, torch.bfloat16, "pallas", "bf16",
                           "pieces", "precomputed", "cpu")
    with pytest.raises(NotImplementedError, match="6d"):
        dist.solve(slab, None, "merged")
