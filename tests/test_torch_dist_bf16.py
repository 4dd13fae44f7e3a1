"""PyTorch port: the bf16 state on the ranks — C10's f32 carry of the
distributed fused solver, and the merged and baseline solvers with
``--dtype bf16`` — against the JAX package.

C10: one block-form iteration on each of two z-slabs (the JAX kernel's
slab form, ``fused_cg_iteration(halo=, z0=, ncz_global=,
recurrence=False, want_carry=True)``, in interpret mode; the port's plain
version), then the add-back of the lower slab's carry onto the upper
slab's face 0 of h': the JAX package's lines (``dist_fused.py:251-253``:
h0 + carry at f32, rounded once) against the port's ``dist_fused._carry``
with the f32 carry (``Workspace.carry``).  The two slabs' iterations run in
this process and the carry reaches ``_carry`` through a loopback of the
one shift it makes (the gloo ranks run the same function in the solves
below).  The faces agree within one bf16 ulp at every node and bit for
bit at more than 99% of them (sums of the same values in another order
round the same way but for a few); the old twice-rounded face (the carry
rounded to bf16 before the add-back) differs from the JAX face at more
than 5% of the nodes.

The solves run on gloo CPU ranks (``distributed.launch``, one spawn a rank
count), the plain versions, at the JAX tests' size (p=2, s=6, 4 ranks):
the merged bf16 solve takes the port's single-device bf16 count (the JAX
package's ``test_distributed_bf16_storage_matches_single``) and the JAX
distributed solve's; the baseline, the (2, 2) mesh, the fused solver under
split2m and ``--overlap`` (s=9 on 2 ranks, 4 layers a slab) within 2 of
their single-device or unoverlapped counts.
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
from mf_data_locality_tpu_torch.parallel import dist_fused
from mf_data_locality_tpu_torch.parallel import distributed as dist
from mf_data_locality_tpu_torch.solvers import cg_fused

BF = torch.bfloat16
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]
C10_S, C10_P = 6, 2


def _piece(u, p, dtype):
    return jfk.to_piece_state(jnp.asarray(u, dtype), p)[:, :, :p * p]


def _top_piece(v, p, dtype):
    one = np.zeros(v.shape[:1] + (p + 1,) + v.shape[2:], np.float32)
    one[:, 0] = v[:, -1]
    return _piece(one, p, dtype)[:, :1]


def _lattice(v, p, lat):
    ncx = (lat[2] - 1) // p
    return np.asarray(jfk.from_piece_state(jfk._expand_mm(v, p, ncx), p,
                                           lat)).astype(np.float32)


def _jax_slab(jop, lat, state, rank, L, ncz_g):
    """The JAX kernel's slab iteration on a slab's lattice state: h' and
    the carry as lattices (float32), the carry on the one plane it
    covers."""
    p = C10_P
    x, g, d, h, prec = state
    pieces = [_piece(x, p, jnp.float32), _piece(g, p, jnp.float32),
              _piece(d, p, jnp.bfloat16), _piece(h, p, jnp.bfloat16)]
    halo = (_top_piece(g, p, jnp.float32), _top_piece(d, p, jnp.bfloat16),
            _top_piece(h, p, jnp.bfloat16), _top_piece(prec, p, jnp.float32))
    out = jfk.fused_cg_iteration(
        jop, lat, *pieces, *(jfk.zplanes_init(v, p) for v in pieces[1:]),
        jnp.asarray(SCAL, jnp.float32), _piece(prec, p, jnp.float32),
        halo=halo, z0=rank * L, ncz_global=ncz_g, recurrence=False,
        want_carry=True, compact=True)
    carry = np.concatenate([np.asarray(out[8], np.float32), np.zeros(
        (3, p - 1) + out[8].shape[2:], np.float32)], 1)
    return (_lattice(out[3], p, lat),
            _lattice(jnp.asarray(carry), p, (p + 1,) + lat[1:])[:, 0])


class _Loopback:
    """The one shift ``dist_fused._carry`` makes on a z-slab: the upper
    slab receives the lower slab's carry."""

    def __init__(self, plane):
        self.plane = plane

    def shift(self, planes, up, axis=0):
        return [self.plane]


def _bf16(a) -> np.ndarray:
    return torch.as_tensor(a).to(BF).float().numpy()


@pytest.mark.parametrize("rung,metric", [("highest", "precomputed"),
                                         ("highest", "onthefly"),
                                         ("split2m", "precomputed"),
                                         ("bf16", "precomputed")])
def test_c10_carry_face_matches_jax(rung, metric):
    """The upper slab's face 0 of h' after the add-back: the port's with
    the f32 carry against the JAX package's, within one bf16 ulp at every
    node and bit for bit at > 99% of them; the twice-rounded face, the
    control, differs at > 5%."""
    s, p, D = C10_S, C10_P, 2
    # the operator of an f32 build: the JAX build_distributed rounds a
    # slab's trilinear coefficients to the state's dtype (distributed.py,
    # replace_coeffs_pallas), which moves the rebuilt metric by ~5e-3; the
    # port keeps them f32, as every single-device build does.  The JAX
    # kernel's state is bf16 by its d and h.
    dp, _ = jdist_fused.build_dist_fused(s, p, n_devices=D,
                                         dtype=jnp.float32,
                                         precision=rung, metric=metric)
    L = dist.cells_per_slab(dp.ncz_global, D)
    slabs = [dist.build_slab(s, p, r, D, BF, "pallas", rung, "pieces",
                             metric, "cpu") for r in range(D)]
    nz = dp.ncz_global * p + 1
    ny, nx = slabs[0].op.n_nodes_axis[1:]
    rng = np.random.default_rng(7)
    glob = np.zeros((1, nz, ny, nx), np.float32)
    glob[:, 1:-1, 1:-1, 1:-1] = 1.0  # the global Dirichlet mask
    x, g, d, h = (rng.standard_normal((3, nz, ny, nx)).astype(np.float32)
                  * glob for _ in range(4))
    d, h = _bf16(d), _bf16(h)
    prec = (np.abs(rng.standard_normal((1, nz, ny, nx))) + 0.5).astype(
        np.float32) * glob
    jax_h, jax_carry, port = [], [], []
    for r, slab in enumerate(slabs):
        op = slab.op
        z = slice(r * L * p, r * L * p + op.n_nodes_axis[0])
        state = [v[:, z] for v in (x, g, d, h, prec)]
        jop = jax.tree.map(lambda a: a[r], dp.op_stack)
        hj, cj = _jax_slab(jop, op.n_nodes_axis, state, r, L, dp.ncz_global)
        jax_h.append(hj)
        jax_carry.append(cj)
        xt, gt, dt, ht, pt = (torch.as_tensor(v) for v in state)
        work = fk.Workspace(op)
        out = fk.fused_cg_iteration(op, xt, gt, dt.to(BF), ht.to(BF),
                                    torch.tensor(SCAL), pt, work=work)
        port.append((out, work, pt))
    # the JAX add-back (dist_fused.py:251-253) on the upper slab's face 0
    want = _bf16(jax_h[1][:, 0] + jax_carry[0])
    (out1, work1, p1), (_, work0, _) = port[1], port[0]
    old = out1[3][:, 0].float().clone()
    dist_fused._carry(_Loopback(work0.carry.clone()), ((1, 0),), out1[4],
                      out1[3], out1[2], out1[1], p1, torch.float32,
                      carry_z=work1.carry)
    got = out1[3][:, 0].float().numpy()
    ulp = np.ldexp(1.0, np.frexp(np.abs(want))[1] - 8)  # bf16's at want
    assert np.all(np.abs(got - want) <= ulp)
    live = glob[0, L * p] > 0  # the face's free nodes
    assert np.mean(got[:, live] == want[:, live]) > 0.99
    twice = _bf16(old.numpy() + _bf16(work0.carry.numpy()))
    assert np.mean(twice[:, live] != want[:, live]) > 0.05


@pytest.fixture(scope="module")
def runs():
    """The port's bf16 solves on gloo CPU ranks: 4 ranks at p=2 s=6
    (merged on z-slabs, as the JAX test, baseline, merged on the (2, 2)
    mesh), 2 ranks at s=9 (merged with and without --overlap, 4 layers a
    slab; the fused solver under split2m)."""
    four = {"merged": dist.Job("merged", 6, 2, BF, rel_tol=1e-6),
            "baseline": dist.Job("baseline", 6, 2, BF),
            "mesh": dist.Job("merged", 6, 2, BF, mesh_shape=(2, 2))}
    two = {"overlap": dist.Job("merged", 9, 2, BF, overlap=True),
           "plain": dist.Job("merged", 9, 2, BF),
           "fused": dist.Job("fused", 6, 2, BF, precision="split2m")}
    out = {}
    for jobs, n in ((four, 4), (two, 2)):
        out.update(zip(jobs, dist.launch(list(jobs.values()), n, "cpu")))
    return out


def _single(s, solver="merged", precision="highest", rel_tol=1e-8, **kw):
    """The same solve on one device (the port's plain versions)."""
    pb = bp4.build(s, 2, BF, precision, device="cpu", **kw)
    if solver == "fused":
        lat = (3,) + pb.layout.n_nodes_axis
        return cg_fused.fused_merged_cg_solve(
            pb.op, lat[1:], pb.b.reshape(lat),
            pb.inv_diag.reshape((1,) + lat[1:]), rel_tol=rel_tol)
    solve = bp4.solve_merged if solver == "merged" else bp4.solve_baseline
    return solve(pb, rel_tol=rel_tol)


def test_merged_bf16_ranks_match_single_device(runs):
    """The JAX package's claim (``test_distributed_bf16_storage_matches_
    single``, rel_tol 1e-6): the distributed merged bf16 solve takes the
    single-device bf16 solve's iteration count; x within 1e-2 of its
    largest value (read 3.4e-3: two bf16-state solves stopped at 1e-6
    res0, their sums in other orders)."""
    got = runs["merged"]
    ref = _single(6, rel_tol=1e-6)
    assert got["converged"] and got["it"] == ref.n_iterations
    x = got["x"].reshape(ref.x.shape)
    assert ((x - ref.x).abs().max() / ref.x.abs().max()).item() <= 1e-2


def test_merged_bf16_ranks_match_jax_distributed(runs):
    """Against the JAX ``distributed.solve`` with a bf16 state on 4
    devices: the same iteration count within 2, and x within 2e-3."""
    dp, mesh = jdist.build_distributed(6, 2, n_devices=4,
                                       dtype=jnp.bfloat16, backend="pallas")
    want = jdist.solve(dp, mesh, solver="merged", rel_tol=1e-6)
    got = runs["merged"]
    assert bool(want.converged)
    assert abs(got["it"] - int(want.n_iterations)) <= 2
    xw = jdist.gather_global(want.x).astype(np.float64)
    x = got["x"].double().numpy().reshape(xw.shape)
    assert np.abs(x - xw).max() / np.abs(xw).max() <= 2e-3


def test_merged_bf16_collectives(runs):
    """One all-reduce an iteration (the 7 sums) and one for res0; the
    halo faces shifted in bf16 (two shifts an apply)."""
    got = runs["merged"]
    it = got["it"]
    assert {(r["allreduces"], r["shifts"]) for r in got["ranks"]} == {
        (it + 1, 2 * it)}


@pytest.mark.parametrize("key,solver,kw", [
    ("baseline", "baseline", {}), ("mesh", "merged", {}),
    ("fused", "fused", {"precision": "split2m", "factor": "dense",
                        "windowing": "pieces"})])
def test_bf16_ranks_match_single_device(runs, key, solver, kw):
    """The baseline solver on z-slabs, the merged on the (2, 2) mesh and
    the fused solver under split2m (dense, the metric streamed) with a
    bf16 state: converged, within 2 iterations of the same solve on one
    device."""
    got = runs[key]
    ref = _single(6, solver, **kw)
    assert got["converged"] and abs(got["it"] - ref.n_iterations) <= 2


def test_overlap_bf16_matches_plain_ranks(runs):
    """``--overlap`` with a bf16 state: the boundary-first apply sums its
    layer ranges' bf16 results as the JAX ``dist_vmult`` does; the solve
    takes the unoverlapped one's count within 2 and converges."""
    a, b = runs["overlap"], runs["plain"]
    assert a["converged"] and b["converged"]
    assert abs(a["it"] - b["it"]) <= 2


def test_cli_devices_bf16(capsys):
    """``--devices 2 --dtype bf16`` runs from the CLI (the merged solver on
    the ranks' plain versions): one converged result row."""
    benchmark.main(["2", "6", "--devices", "2", "--dtype", "bf16",
                    "--device", "cpu"])
    rows = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith(" 2 |")]
    assert len(rows) == 1 and "not converged" not in rows[0]
