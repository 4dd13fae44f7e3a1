"""PyTorch port: CEED BP3 (one component) on the ranks against the JAX
package's distributed solvers built with ``n_components=1``.

Each gloo CPU rank builds its part from the JAX ``DistributedBP4``'s (or
``_2D``'s, ``DistributedGeneral``'s) arrays of the same device
(``models/bp4.slab_from_jax_arrays``, ``block_from_jax_arrays``,
``dist_general.general_from_jax_arrays``), or, where marked, from its own
build with ``n_components=1`` (``distributed.build_slab`` /
``build_block`` / ``Job(n_components=1)``); the port runs its plain
versions, the JAX package its kernels in interpret mode.  f64, at p=2:
on 3 z-slab ranks the merged solver on each windowing (reshape: B3,
pieces: B5, zslab: B6), the baseline one, the structured backend, the
fused solver with the metric streamed and rebuilt, and ``--overlap``
(the merged solver at s=9: 3 cell layers a slab; the fused one, bitwise
its solve without overlap, at s=8); on 4
ranks the (2, 2) mesh (merged, and fused through ``solve_fused_2d``) and
the general backend.  Each: itCG identical to the JAX solve's and x within
1e-11 max(1, |x|), as ``test_torch_dist_jax_slabs.py`` holds BP4.  Then
the shape checks: what ``laplace_cuda.check_shape`` now takes at one
component and q = p + 2, and what it still refuses, by its label.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.parallel import dist_fused as jdist_fused
from mf_data_locality_tpu.parallel import dist_general as jdg
from mf_data_locality_tpu.parallel import distributed as jdist
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_cuda
from mf_data_locality_tpu_torch.parallel import distributed as dist
from test_torch_dist_general import _jax_rank_arrays as jax_general_arrays
from test_torch_dist_mesh_merged import jax_block_arrays
from test_torch_dist_slab import jax_rank_arrays

TOL_X = 1e-11
BF = torch.bfloat16
F64 = jnp.float64


def _slabs(s, windowing="reshape", backend="pallas", metric="precomputed"):
    return jdist.build_distributed(s, 2, n_devices=3, dtype=F64,
                                   backend=backend, windowing=windowing,
                                   metric=metric, n_components=1)


# label -> (port job, JAX build, JAX solve or the label whose solve it
# is held to, the port's own build too).  s=6 puts 2, 2 and 0 real cell
# layers on the 3 slabs (the last all dummy cells), s=8 2 on each, s=9 3
SLABS = {
    "merged-reshape": (dist.Job("merged", 6, 2), lambda: _slabs(6),
                       lambda dp, m: jdist.solve(dp, m, "merged"), True),
    "merged-pieces": (dist.Job("merged", 6, 2, windowing="pieces"),
                      lambda: _slabs(6, "pieces"),
                      lambda dp, m: jdist.solve(dp, m, "merged"), False),
    "merged-zslab": (dist.Job("merged", 6, 2, windowing="zslab"),
                     lambda: _slabs(6, "zslab"),
                     lambda dp, m: jdist.solve(dp, m, "merged"), False),
    "baseline-pieces": (dist.Job("baseline", 6, 2, windowing="pieces"),
                        lambda: _slabs(6, "pieces"),
                        lambda dp, m: jdist.solve(dp, m, "baseline"), False),
    "merged-structured": (dist.Job("merged", 6, 2, backend="structured"),
                          lambda: _slabs(6, backend="structured"),
                          lambda dp, m: jdist.solve(dp, m, "merged"), False),
    "fused": (dist.Job("fused", 8, 2), lambda: _slabs(8, "pieces"),
              jdist_fused.solve_fused, True),
    "fused-onthefly": (dist.Job("fused", 8, 2, metric="onthefly"),
                       lambda: _slabs(8, "pieces", metric="onthefly"),
                       jdist_fused.solve_fused, False),
    "merged-overlap": (dist.Job("merged", 9, 2, windowing="pieces",
                                overlap=True),
                       lambda: _slabs(9, "pieces"),
                       lambda dp, m: jdist.solve(dp, m, "merged",
                                                 overlap=True), False),
    # bitwise the solve without overlap (test_bp3_fused_overlap_is_bitwise),
    # so held to the JAX solve without it
    "fused-overlap": (dist.Job("fused", 8, 2, overlap=True),
                      lambda: _slabs(8, "pieces"), "fused", False),
}
MESH = (2, 2)
MESHES = {
    "mesh-merged": (dist.Job("merged", 6, 2, windowing="pieces",
                             mesh_shape=MESH),
                    lambda: jdist.build_distributed_2d(
                        6, 2, MESH, dtype=F64, backend="pallas",
                        windowing="pieces", n_components=1),
                    lambda dp, m: jdist.solve_2d(dp, m, "merged")),
    "mesh-fused": (dist.Job("fused", 6, 2, mesh_shape=MESH),
                   lambda: jdist.build_distributed_2d(
                       6, 2, MESH, dtype=F64, backend="pallas",
                       windowing="pieces", n_components=1),
                   jdist_fused.solve_fused_2d),
}


@pytest.fixture(scope="module")
def jax_side():
    """{label: (JAX problem, JAX solve)}, one build a distinct problem."""
    built, out = {}, {}
    for label, (job, build, solve, *_) in {**SLABS, **MESHES}.items():
        key = (job.s, job.windowing if job.solver != "fused" else "pieces",
               job.backend, job.metric, job.mesh_shape)
        if key not in built:
            built[key] = build()
        dp, mesh = built[key]
        out[label] = dp, (out[solve][1] if isinstance(solve, str)
                          else solve(dp, mesh))
    dp, mesh = jdg.build_dist_general(6, 2, n_devices=4, dtype=F64,
                                      n_components=1)
    out["general"] = dp, jdg.solve_general(dp, mesh, solver="merged")
    return out


@pytest.fixture(scope="module")
def runs(jax_side):
    """The port's solves: on 3 ranks every SLABS case on the JAX slabs and
    the marked ones on its own; on 4 ranks the mesh cases on the JAX
    blocks and on its own, and the general backend on the JAX arrays and
    on its own."""
    jobs, keys = [], []
    for label, (job, _, _, own) in SLABS.items():
        dp = jax_side[label][0]
        arrays = tuple(jax_rank_arrays(dp, r, job.backend) for r in range(3))
        jobs.append(dist.Job(job.solver, job.s, 2, backend=job.backend,
                             metric=job.metric, overlap=job.overlap,
                             arrays=arrays))
        keys.append((label, "jax"))
        if own:
            jobs.append(dist.Job(**{**_fields(job), "n_components": 1}))
            keys.append((label, "own"))
    out = dict(zip(keys, dist.launch(jobs, 3, "cpu")))
    jobs, keys = [], []
    for label, (job, _, _) in MESHES.items():
        dp = jax_side[label][0]
        arrays = tuple(jax_block_arrays(dp, np.unravel_index(r, MESH),
                                        "pallas") for r in range(4))
        jobs += [dist.Job(**{**_fields(job), "arrays": arrays}),
                 dist.Job(**{**_fields(job), "n_components": 1})]
        keys += [(label, "jax"), (label, "own")]
    dp = jax_side["general"][0]
    jobs += [dist.Job("merged", 6, 2, backend="general",
                      arrays=tuple(jax_general_arrays(dp, r)
                                   for r in range(4))),
             dist.Job("merged", 6, 2, backend="general", n_components=1)]
    keys += [("general", "jax"), ("general", "own")]
    out.update(zip(keys, dist.launch(jobs, 4, "cpu")))
    return out


def _fields(job):
    return {k: getattr(job, k) for k in (
        "solver", "s", "degree", "backend", "windowing", "metric",
        "overlap", "mesh_shape")}


def _jax_x(label, dp, want):
    if label == "general":
        return jdg.gather_global_general(dp, want.x, 6, 2, n_components=1)
    if label.startswith("mesh"):
        nz, ny, nx = (n * 2 + 1 for n in dp.nc_global)
        return jdist.gather_global_2d(want.x)[:, :nz, :ny, :nx]
    return jdist.gather_global(want.x, nz=dp.ncz_global * 2 + 1)


def _same(got, want_it, xw, tol=TOL_X):
    assert got["it"] == want_it
    assert got["x"].shape[0] == 1 and got["x"].dtype == torch.float64
    x = got["x"].numpy().reshape(xw.shape)
    np.testing.assert_allclose(x, xw, rtol=0,
                               atol=tol * max(1.0, np.abs(xw).max()))


def _tol(label):
    # the general backend's gather and scatter sum in another order: the
    # BP4 tests' 1e-10 (test_torch_dist_general.py)
    return 1e-10 if label == "general" else TOL_X


@pytest.mark.parametrize("label", list(SLABS) + list(MESHES) + ["general"])
def test_bp3_ranks_on_jax_parts_match_jax(runs, jax_side, label):
    """The port's ranks on the JAX package's own parts at one component:
    itCG identical, x within 1e-11 max(1, |x|)."""
    dp, want = jax_side[label]
    _same(runs[label, "jax"], int(want.n_iterations),
          _jax_x(label, dp, want), _tol(label))


@pytest.mark.parametrize("label", [k for k, v in SLABS.items() if v[3]]
                         + list(MESHES) + ["general"])
def test_bp3_ranks_own_build_match_jax(runs, jax_side, label):
    """The port's own rank builds with ``n_components=1`` (``build_slab``,
    ``build_block``, ``build_general``): the JAX solve's itCG and x."""
    dp, want = jax_side[label]
    _same(runs[label, "own"], int(want.n_iterations),
          _jax_x(label, dp, want), _tol(label))


def test_bp3_fused_overlap_is_bitwise(runs):
    """``solve_fused(overlap=True)`` at one component: bitwise the solve
    without it (the layer-range form and one assemble)."""
    a, b = runs["fused", "jax"], runs["fused-overlap", "jax"]
    assert a["it"] == b["it"] and torch.equal(a["x"], b["x"])
    assert np.array_equal(a["history"], b["history"], equal_nan=True)


def test_bp3_slab_arrays_match_jax(jax_side):
    """``slab_arrays`` / ``build_slab`` at one component equal the JAX
    slabs (s=6: the last slab all dummy cells): b (one component,
    ``dof_index % 8`` with one DoF a node) and the weights exactly, the
    preconditioner to 1e-14."""
    dp = jax_side["merged-pieces"][0]
    for r in range(3):
        want = jax_rank_arrays(dp, r)
        slab = dist.build_slab(6, 2, r, 3, torch.float64, "pallas",
                               "highest", "pieces", "precomputed", "cpu",
                               n_components=1)
        assert slab.b.shape[0] == 1
        np.testing.assert_array_equal(slab.b.numpy(), want["b"])
        np.testing.assert_array_equal(slab.weight.numpy(), want["weight"])
        np.testing.assert_allclose(slab.inv_diag.numpy(), want["inv_diag"],
                                   rtol=1e-14, atol=0)


def test_bp3_gather_global_is_one_component(runs):
    """``gather_global_2d`` / ``_3d`` and the slabs' gather return (1, Nz,
    Ny, Nx) at one component."""
    for label, n in (("fused", (9, 17, 17)), ("mesh-merged", (9, 9, 9))):
        assert tuple(runs[label, "jax"]["x"].shape) == (1, *n)


def test_bp3_workspace_and_carry_face(runs):
    """The fused ranks' workspace holds the vectors' one component, its
    C10 carry face (1, Ny, Nx)."""
    slab = dist.build_slab(6, 2, 0, 2, BF, "pallas", "highest", "pieces",
                           "precomputed", "cpu", n_components=1)
    work = fk.Workspace(slab.op, slab.b.shape[0])
    assert work.cells.shape[0] == 1
    assert tuple(work.carry.shape) == (1,) + slab.op.n_nodes_axis[1:]


SC1, SQ1 = laplace_cuda.SHAPE_C1, laplace_cuda.SHAPE_Q1


@pytest.mark.parametrize("precision,dtype,block", [
    ("highest", torch.float64, True), ("highest", torch.float32, True),
    ("split2m", torch.float32, True), ("highest", BF, False),
    ("split2m", BF, False), ("highest", BF, True), ("split2m", BF, True)])
def test_check_shape_takes_bp3_blocks_and_bf16_state(precision, dtype,
                                                     block):
    """At one component and q = p + 2 the kernels take the block form
    (the ranks) and the bf16 state, on one device and on a block, under
    highest and split2m, at every degree."""
    for p in (1, 4, 11):
        assert laplace_cuda.check_shape(p, p + 2, 1, precision, dtype,
                                        block=block) == SC1


# the ROADMAP item a refusal names: 6g, but q = p + 1 on a block (queue A
# item 10: no distributed JAX solver runs it)
ITEM_10 = "queue A item 10"


@pytest.mark.parametrize("kw,label", [
    (dict(n_q=3, n_components=1, block=True),
     r"the block form \(distributed\) at q = p \+ 1"),
    (dict(n_q=3, n_components=3, block=True),
     r"the block form \(distributed\) at q = p \+ 1"),
    (dict(n_q=3, n_components=1, dtype=BF), r"a bf16 state at q = p \+ 1"),
    (dict(n_q=3, n_components=3, dtype=BF), r"a bf16 state at q = p \+ 1"),
    (dict(n_q=4, n_components=1, metric_dtype=BF), "a bf16 metric"),
    (dict(n_q=4, n_components=1, block=True, metric_dtype=BF),
     "a bf16 metric"),
    (dict(n_q=4, n_components=1, px=True), "P or x in bf16"),
    (dict(n_q=4, n_components=1, dtype=BF, precision="split3"),
     "precision='split3'"),
    (dict(n_q=4, n_components=1, block=True, precision="bf16"),
     "precision='bf16'"),
    (dict(n_q=5, n_components=1, block=True), "item 6g"),
    (dict(n_q=4, n_components=2, dtype=BF), "item 6g")])
def test_check_shape_refusals_stay(kw, label):
    """What stays refused (queue B item 6g): q = p + 1 with a bf16 state,
    a bf16 metric, P or x in bf16, the other rungs, any other q or C; and
    q = p + 1 on a block (queue A item 10); each names itself and the
    ROADMAP item."""
    item = (ITEM_10 if kw.get("block") and kw["n_q"] == 3
            and "dtype" not in kw else "item 6g")
    kw = {"precision": "highest", "dtype": torch.float32, **kw}
    with pytest.raises(NotImplementedError, match=label):
        laplace_cuda.check_shape(2, **kw)
    with pytest.raises(NotImplementedError, match=item):
        laplace_cuda.check_shape(2, **kw)


def test_rank_builders_refuse_what_the_kernels_lack():
    """The rank builders check the shape at build time: a rung the
    kernels lack at one component raises there, naming 6g; the plain
    backends take it."""
    with pytest.raises(NotImplementedError, match="precision='split3'"):
        dist.build_slab(5, 2, 0, 2, torch.float32, "pallas", "split3",
                        device="cpu", n_components=1)
    slab = dist.build_slab(5, 2, 0, 2, torch.float64, "structured",
                           device="cpu", n_components=1)
    assert slab.b.shape[0] == 1
    assert fk.check_kernel_shape(dist.build_block(
        5, 2, (0, 0), MESH, torch.float32, "pallas", "split2m", "pieces",
        device="cpu", n_components=1).op, 1, BF) == SC1
