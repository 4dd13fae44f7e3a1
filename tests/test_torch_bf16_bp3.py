"""PyTorch port: the bf16 state at one component (CEED BP3) against the JAX
package, on one device and on the ranks.

The JAX side is ``bp4.build(..., n_components=1, dtype=jnp.bfloat16)`` and
``distributed.build_distributed(..., n_components=1, dtype=jnp.bfloat16)``
with their solvers, the Pallas kernels in interpret mode on the CPU; the
port runs its plain versions (the kernels' rounding points, as at three
components: ``tests/test_torch_bf16_state.py``, ``test_torch_dist_bf16.py``).
Inputs are made with numpy from a seed and handed to both, at p=2.

* ``vmult`` on a bf16 u (B3 reshape, B5 pieces, B6 zslab under highest;
  B3 under split2m): relative L2 5e-4, and the control — the apply at
  f32, without the bf16 store — outside it;
* one B2 iteration with a bf16 state (dense; highest with the metric
  streamed, split2m with it rebuilt) against the JAX kernel's: the vectors within 5e-4 (L2), the
  scalars within 1e-4; the control, the same values stored at f32, misses
  on h';
* the merged (reshape) and fused (dense, split2m) solves at s=4: itCG
  within 2 of the JAX package's, the residual history within 5e-5 of res0
  (the f32-state solve, the control, misses);
* on 2 gloo CPU ranks at s=6: the merged bf16 solve takes the port's
  single-device bf16 count (the JAX package's claim at three components)
  and the JAX distributed solve's within 2, its history within 5e-5 of
  res0 of the JAX one's while the f32-state ranks' misses; the fused
  solver under split2m against the JAX distributed fused bf16 solve
  (``dist_fused.solve_fused``): itCG within 2 of it and of the port's
  single-device count, its history within 2e-4 of res0 of the JAX one's
  (``TOL_HIST_RANKS``) while the f32-state ranks' and the one-device
  solve's miss;
* C10 at one component: the upper of two z-slabs' face 0 of h' after the
  add-back of the lower one's f32 carry (``Workspace.carry``, (1, Ny, Nx))
  against the JAX kernel's ``carry_out`` added back: within one bf16 ulp,
  bit for bit at more than 99% of the nodes; the twice-rounded face, the
  control, differs at more than 5%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mf_data_locality_tpu.models import bp4 as jbp4
from mf_data_locality_tpu.ops import cg_fused_kernel as jfk
from mf_data_locality_tpu.ops import laplace_pallas as jlp
from mf_data_locality_tpu.parallel import dist_fused as jdist_fused
from mf_data_locality_tpu.parallel import distributed as jdist
from mf_data_locality_tpu.solvers import cg_fused as jcg_fused
from mf_data_locality_tpu_torch.models import bp4
from mf_data_locality_tpu_torch.ops import cg_fused_kernel as fk
from mf_data_locality_tpu_torch.ops import laplace_apply as la
from mf_data_locality_tpu_torch.parallel import dist_fused
from mf_data_locality_tpu_torch.parallel import distributed as dist
from mf_data_locality_tpu_torch.solvers import cg_fused
from test_torch_bf16_state import _f32, _l2, _lattice, _np, _piece
from test_torch_dist_bf16 import _Loopback, _bf16, _top_piece

BF = torch.bfloat16
S, P, C = 3, 2, 1
TOL_L2, TOL_SCAL, TOL_HIST = 5e-4, 1e-4, 5e-5
# the fused bf16 solve on the ranks: the carry's face is rounded twice
# (its partial as stored, then with the carry added: the JAX rounding
# point, C10), which moves the history by 3.2e-4 of res0 from the same
# solve on one device at s=6, in the JAX package as in the port, and makes
# it that much more sensitive to the kernels' summation order: the port's
# ranks read 8.1e-5 from the JAX ranks (one device: 8.7e-7), the f32
# control 6.9e-4
TOL_HIST_RANKS = 2e-4
SCAL = [0.3, 0.7, 0.2, 0.1, 1.0, 0.0, 0.25, 0.6]
JBF = jnp.bfloat16


@pytest.mark.parametrize("windowing,rung", [
    ("reshape", "highest"), ("pieces", "highest"), ("zslab", "highest"),
    ("reshape", "split2m")])
def test_vmult_bf16_state_bp3_matches_jax(windowing, rung):
    """``vmult`` on a bf16 u of one component against the JAX ``vmult``:
    within relative L2 5e-4; the apply at f32 (no bf16 store) outside."""
    jp = jbp4.build(S, P, dtype=JBF, backend="pallas", precision=rung,
                    windowing=windowing, n_components=C)
    lat = jp.layout.n_nodes_axis
    u = np.random.default_rng(11).standard_normal((C,) + lat) * np.asarray(
        jp.op.mask, np.float64).reshape((1,) + lat)
    u = jnp.asarray(u, JBF)
    ref = _f32(jlp.vmult(jp.op, u, constrained_identity=True))
    op = bp4.build(S, P, BF, rung, windowing=windowing, device="cpu",
                   n_components=C).op
    ut = torch.as_tensor(_f32(u))
    got = la.vmult(op, ut.to(BF))
    assert got.dtype == BF and got.shape[0] == C
    assert _l2(_np(got), ref) <= TOL_L2
    assert _l2(_np(la.vmult(op, ut)), ref) > TOL_L2


def _jax_iteration(rung, metric):
    """One JAX ``fused_cg_iteration`` (dense, pieces) at one component on
    random inputs, d and h bf16 values: the inputs, x', g', d', h' and the
    scalars as float32 numpy."""
    jp = jbp4.build(S, P, dtype=JBF, backend="pallas", precision=rung,
                    windowing="pieces", factor="dense", metric=metric,
                    n_components=C)
    lat = jp.layout.n_nodes_axis
    mask = np.asarray(jp.op.mask, np.float32).reshape((1,) + lat)
    rng = np.random.default_rng(21)

    def vec(dtype=jnp.float32):
        return _f32(jnp.asarray(rng.standard_normal((C,) + lat) * mask,
                                dtype))

    x, g, d, h = vec(), vec(), vec(JBF), vec(JBF)
    prec = _f32(np.asarray(jp.inv_diag, np.float32).reshape((1,) + lat)
                * mask)
    xs, gs = _piece(x, P), _piece(g, P)
    ds, hs = (_piece(jnp.asarray(v, JBF), P) for v in (d, h))
    out = jfk.fused_cg_iteration(
        jp.op, lat, xs, gs, ds, hs, jfk.zplanes_init(gs, P),
        jfk.zplanes_init(ds, P), jfk.zplanes_init(hs, P),
        jnp.asarray(SCAL, jnp.float32), _piece(prec, P), compact=True)
    return ((x, g, d, h, prec), [_lattice(v, P, lat) for v in out[:4]],
            _f32(out[7]))


@pytest.mark.parametrize("rung,metric", [("highest", "precomputed"),
                                         ("split2m", "onthefly")])
def test_fused_iteration_bf16_state_bp3_matches_jax(rung, metric):
    """B2 with a bf16 state at one component against the JAX kernel's: the
    vectors within 5e-4 (L2), the scalars within 1e-4; stored at f32, the
    control, h' misses."""
    args, want, scal = _jax_iteration(rung, metric)
    op = bp4.build(S, P, BF, rung, factor="dense", metric=metric,
                   windowing="pieces", device="cpu", n_components=C).op
    x, g, d, h, prec = (torch.as_tensor(v) for v in args)

    def run(store):
        return fk._fused_iteration_plain(op, x, g, d.to(store), h.to(store),
                                         torch.tensor(SCAL), prec)

    got = run(BF)
    assert got[2].dtype == got[3].dtype == BF and got[3].shape[0] == C
    for a, b in zip(got[:4], want):
        assert _l2(_np(a), b) <= TOL_L2
    np.testing.assert_allclose(got[4].numpy(), scal, rtol=TOL_SCAL,
                               atol=1e-30)
    assert _l2(_np(run(torch.float32)[3]), want[3]) > TOL_L2


def _hist_err(r, want) -> float:
    """max |history - JAX history| / res0 over the iterations both ran."""
    hist = np.asarray(want.res_history, np.float64)
    k = min(r.n_iterations, int(want.n_iterations)) + 1
    return np.abs(np.asarray(r.res_history)[:k] - hist[:k]).max() / hist[0]


@pytest.mark.parametrize("solver", ("merged", "fused"))
def test_bf16_state_bp3_solve_matches_jax(solver):
    """The merged solver (reshape, highest) and the fused one (dense, the
    metric streamed, split2m) with a bf16 state at one component at s=4:
    itCG within 2 of the JAX package's, the history within 5e-5 of res0,
    the f32-state solve's outside it."""
    s = 4
    kw = (dict(precision="highest") if solver == "merged" else
          dict(precision="split2m", windowing="pieces", factor="dense",
               metric="precomputed"))
    jp = jbp4.build(s, P, dtype=JBF, backend="pallas", n_components=C, **kw)
    lat = jp.layout.n_nodes_axis

    def port(dtype):
        pb = bp4.build(s, P, dtype, device="cpu", n_components=C, **kw)
        if solver == "merged":
            return bp4.solve_merged(pb)
        return cg_fused.fused_merged_cg_solve(
            pb.op, lat, pb.b.reshape((C,) + lat),
            pb.inv_diag.reshape((1,) + lat))

    if solver == "merged":
        want = jbp4.solve_merged(jp)
    else:
        want = jcg_fused.fused_merged_cg_solve(
            jp.op, lat, jp.b.reshape((C,) + lat),
            jp.inv_diag.reshape((1,) + lat))
    got, ctl = port(BF), port(torch.float32)
    assert got.converged and bool(want.converged)
    assert abs(got.n_iterations - int(want.n_iterations)) <= 2
    assert _hist_err(got, want) <= TOL_HIST < _hist_err(ctl, want)


@pytest.fixture(scope="module")
def ranks():
    """On 2 gloo CPU ranks at p=2 s=6, one component: the merged solve
    with a bf16 state and with an f32 one (rel_tol 1e-6, the JAX test's),
    the fused solve under split2m (dense, the metric streamed) with a bf16
    state and with an f32 one; and the JAX distributed merged and fused
    bf16 solves."""
    f32 = torch.float32
    jobs = [dist.Job("merged", 6, P, BF, rel_tol=1e-6, n_components=C),
            dist.Job("merged", 6, P, f32, rel_tol=1e-6, n_components=C),
            dist.Job("fused", 6, P, BF, precision="split2m",
                     n_components=C),
            dist.Job("fused", 6, P, f32, precision="split2m",
                     n_components=C)]
    dp, mesh = jdist.build_distributed(6, P, n_devices=2, dtype=JBF,
                                       backend="pallas", n_components=C)
    dpf, meshf = jdist.build_distributed(6, P, n_devices=2, dtype=JBF,
                                         backend="pallas",
                                         precision="split2m",
                                         windowing="pieces", n_components=C)
    return (dist.launch(jobs, 2, "cpu"),
            jdist.solve(dp, mesh, solver="merged", rel_tol=1e-6),
            jdist_fused.solve_fused(dpf, meshf))


class _History:
    def __init__(self, r):
        self.res_history, self.n_iterations = r["history"], r["it"]


def test_bf16_state_bp3_ranks_match_jax(ranks):
    """The merged bf16 solve on the ranks at one component: the port's
    single-device bf16 count, within 2 of the JAX distributed solve's, its
    history within 5e-5 of res0 of the JAX one's over the iterations both
    ran; the f32-state ranks' history outside it."""
    (got, ctl, _, _), want, _ = ranks
    one = bp4.solve_merged(bp4.build(6, P, BF, device="cpu",
                                     n_components=C), rel_tol=1e-6)
    assert got["converged"] and bool(want.converged)
    assert got["it"] == one.n_iterations
    assert abs(got["it"] - int(want.n_iterations)) <= 2
    assert got["x"].shape[0] == C
    assert (_hist_err(_History(got), want) <= TOL_HIST
            < _hist_err(_History(ctl), want))


def test_bf16_state_bp3_fused_ranks_match_jax(ranks):
    """The fused solver under split2m (dense, the metric streamed) with a
    bf16 state at one component on 2 ranks: converged, within 2 of the
    JAX distributed fused bf16 solve's count and of the same solve on one
    device, its history within 2e-4 of res0 of the JAX one's over the
    iterations both ran (``TOL_HIST_RANKS``); the f32-state ranks' history
    and the one-device bf16 solve's (the face rounded once) outside it."""
    (_, _, fused, ctl), _, want = ranks
    pb = bp4.build(6, P, BF, "split2m", factor="dense",
                   metric="precomputed", windowing="pieces", device="cpu",
                   n_components=C)
    lat = pb.layout.n_nodes_axis
    one = cg_fused.fused_merged_cg_solve(pb.op, lat, pb.b.reshape((C,) + lat),
                                         pb.inv_diag.reshape((1,) + lat))
    assert fused["converged"] and bool(want.converged)
    assert abs(fused["it"] - int(want.n_iterations)) <= 2
    assert abs(fused["it"] - one.n_iterations) <= 2
    assert _hist_err(_History(fused), want) <= TOL_HIST_RANKS
    assert TOL_HIST_RANKS < min(_hist_err(_History(ctl), want),
                                _hist_err(one, want))


def _jax_slab(jop, lat, state, rank, L, ncz_g):
    """The JAX kernel's slab iteration at one component: h' and the carry
    as lattices (float32)."""
    x, g, d, h, prec = state
    pieces = [_piece(jnp.asarray(x), P), _piece(jnp.asarray(g), P),
              _piece(jnp.asarray(d, JBF), P), _piece(jnp.asarray(h, JBF), P)]
    halo = tuple(_top_piece(v, P, t) for v, t in (
        (g, jnp.float32), (d, JBF), (h, JBF), (prec, jnp.float32)))
    out = jfk.fused_cg_iteration(
        jop, lat, *pieces, *(jfk.zplanes_init(v, P) for v in pieces[1:]),
        jnp.asarray(SCAL, jnp.float32), _piece(jnp.asarray(prec), P),
        halo=halo, z0=rank * L, ncz_global=ncz_g, recurrence=False,
        want_carry=True, compact=True)
    carry = np.concatenate([np.asarray(out[8], np.float32), np.zeros(
        (C, P - 1) + out[8].shape[2:], np.float32)], 1)
    return (_lattice(out[3], P, lat),
            _lattice(jnp.asarray(carry), P, (P + 1,) + lat[1:])[:, 0])


@pytest.mark.parametrize("rung,metric", [("highest", "precomputed"),
                                         ("split2m", "onthefly")])
def test_c10_carry_face_bp3_matches_jax(rung, metric):
    """C10 at one component (s=6: two slabs of 2 cell layers, a 9 x 9
    face): the upper slab's face 0 of h' after the add-back of the lower
    slab's f32 carry, against the JAX kernel's ``carry_out`` added back
    (``dist_fused.py:251-253``): within one bf16 ulp, bit for bit at more
    than 99% of the free nodes; the twice-rounded face misses at more than
    5%."""
    s, D = 6, 2
    dp, _ = jdist.build_distributed(s, P, n_devices=D, dtype=jnp.float32,
                                    backend="pallas", windowing="pieces",
                                    precision=rung, metric=metric,
                                    n_components=C)
    L = dist.cells_per_slab(dp.ncz_global, D)
    slabs = [dist.build_slab(s, P, r, D, BF, "pallas", rung, "pieces",
                             metric, "cpu", n_components=C)
             for r in range(D)]
    nz = dp.ncz_global * P + 1
    ny, nx = slabs[0].op.n_nodes_axis[1:]
    rng = np.random.default_rng(7)
    glob = np.zeros((1, nz, ny, nx), np.float32)
    glob[:, 1:-1, 1:-1, 1:-1] = 1.0
    x, g, d, h = (rng.standard_normal((C, nz, ny, nx)).astype(np.float32)
                  * glob for _ in range(4))
    d, h = _bf16(d), _bf16(h)
    prec = (np.abs(rng.standard_normal((1, nz, ny, nx))) + 0.5).astype(
        np.float32) * glob
    jax_h, jax_carry, port = [], [], []
    for r, slab in enumerate(slabs):
        op = slab.op
        z = slice(r * L * P, r * L * P + op.n_nodes_axis[0])
        state = [v[:, z] for v in (x, g, d, h, prec)]
        jop = jax.tree.map(lambda a: a[r], dp.op_stack)
        hj, cj = _jax_slab(jop, op.n_nodes_axis, state, r, L, dp.ncz_global)
        jax_h.append(hj)
        jax_carry.append(cj)
        xt, gt, dt, ht, pt = (torch.as_tensor(v) for v in state)
        work = fk.Workspace(op, C)
        out = fk.fused_cg_iteration(op, xt, gt, dt.to(BF), ht.to(BF),
                                    torch.tensor(SCAL), pt, work=work)
        assert tuple(work.carry.shape) == (C, ny, nx)
        port.append((out, work, pt))
    want = _bf16(jax_h[1][:, 0] + jax_carry[0])
    (out1, work1, p1), (_, work0, _) = port[1], port[0]
    old = out1[3][:, 0].float().clone()
    dist_fused._carry(_Loopback(work0.carry.clone()), ((1, 0),), out1[4],
                      out1[3], out1[2], out1[1], p1, torch.float32,
                      carry_z=work1.carry)
    got = out1[3][:, 0].float().numpy()
    ulp = np.ldexp(1.0, np.frexp(np.abs(want))[1] - 8)
    assert np.all(np.abs(got - want) <= ulp)
    live = glob[0, L * P] > 0
    assert np.mean(got[:, live] == want[:, live]) > 0.99
    twice = _bf16(old.numpy() + _bf16(work0.carry.numpy()))
    assert np.mean(twice[:, live] != want[:, live]) > 0.05
