"""PyTorch port: the native host setup (``mf_data_locality_tpu_torch.
native``, built from the repo's ``native/setup.cc``) against the port's
NumPy paths and the JAX package's.

The integer entry points and the trilinear coefficients are bitwise the
NumPy paths'; the vertex lattice (``std::sin`` against NumPy's sine) and
the metric (another evaluation order) agree to 1e-15 and 1e-14 of their
largest value.  Against the JAX package's builders: bitwise where its own
native library loads (the same source and flags), else to those
tolerances.  The build lands in a directory of its own and is atomic: two
processes that build into an empty directory at once both load it.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mf_data_locality_tpu import native as jnative
from mf_data_locality_tpu.mesh import renumber as jrn
from mf_data_locality_tpu.mesh.box import BoxMesh as JBoxMesh
from mf_data_locality_tpu.mesh.dofs import DofLayout as JDofLayout
from mf_data_locality_tpu.ops import laplace_pallas as jlp
from mf_data_locality_tpu_torch import native
from mf_data_locality_tpu_torch.mesh import renumber
from mf_data_locality_tpu_torch.mesh.box import BoxMesh
from mf_data_locality_tpu_torch.mesh.dofs import (DofLayout, boundary_node_mask,
                                                  gather_map_np)
from mf_data_locality_tpu_torch.ops import geometry, lagrange, laplace_cuda

REPO = Path(__file__).resolve().parent.parent
POINTS = [(3, 1), (4, 2), (6, 3), (7, 4)]  # (s, p)


def test_available_with_gxx():
    """With g++ on the path the library builds and loads, so no silent
    NumPy fallback makes the comparisons below vacuous; it lands in the
    port's build directory, never in ``native/``."""
    if shutil.which("g++") is None:
        assert not native.AVAILABLE
        pytest.skip("no g++: the NumPy paths run")
    assert native.AVAILABLE
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.name == "_kernel_build"


@pytest.mark.parametrize("s,p", POINTS)
def test_integer_entry_points_bitwise(s, p):
    """gather_map, boundary_mask and renumber_locality (with ghost flags)
    bitwise the port's NumPy paths and the JAX package's."""
    layout = DofLayout(BoxMesh.from_s(s), p)
    nc, nn = layout.mesh.n_cells_axis, layout.n_nodes_axis
    gm = native.gather_map(p, *nc)
    np.testing.assert_array_equal(gm, gather_map_np(p, nc))
    np.testing.assert_array_equal(gm, layout.gather_map)
    np.testing.assert_array_equal(
        gm, JDofLayout(JBoxMesh.from_s(s), p).gather_map)
    bm = native.boundary_mask(*nn)
    np.testing.assert_array_equal(bm, boundary_node_mask(nn))
    np.testing.assert_array_equal(bm, layout.boundary_node_mask)
    ghost = np.zeros(layout.n_nodes, bool)
    ghost[-layout.n_nodes // 5:] = True
    for flags in (None, ghost):
        got = native.renumber_locality(
            gm, layout.n_nodes, None if flags is None
            else flags.astype(np.uint8))
        want = renumber.locality_permutation_np(gm, layout.n_nodes, flags)
        jwant = jrn.locality_permutation_np(gm, layout.n_nodes, flags)
        assert got[1] == want[1] == jwant[1]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[0], jwant[0])
        # the dispatcher takes the native path for the default strategies
        np.testing.assert_array_equal(
            renumber.locality_permutation(gm, layout.n_nodes, flags)[0],
            got[0])


@pytest.mark.parametrize("s,p", POINTS)
def test_geometry_entry_points(s, p):
    """vertex_lattice (1e-15 of the NumPy path's; ulps of the sine),
    trilinear_coefficients (bitwise) and metric_entries (1e-14 of the
    largest entry; bitwise the JAX native library's where it loads)."""
    mesh = BoxMesh.from_s(s)
    nc = mesh.n_cells_axis
    lat = native.vertex_lattice(*nc, mesh.spacing)
    np.testing.assert_allclose(lat, mesh.vertex_lattice_np(), rtol=0,
                               atol=1e-15)
    co = native.trilinear_coefficients(*nc, lat)
    np.testing.assert_array_equal(
        co, geometry.trilinear_coefficients(mesh.cell_vertices))
    q = p + 2
    qp = lagrange.make_shape(p, q).q_points
    w3 = laplace_cuda.tensor_weights(p, q)
    g = native.metric_entries(co, qp, w3)
    g_np = laplace_cuda.metric_entries_np(co, qp, w3)
    np.testing.assert_allclose(g, g_np, rtol=0,
                               atol=1e-14 * np.abs(g_np).max())
    np.testing.assert_array_equal(laplace_cuda.metric_entries(co, qp, w3), g)
    jlat = JBoxMesh.from_s(s).vertex_lattice
    jg = jlp._metric_entries(co, qp, w3)
    if jnative.AVAILABLE and jnative.HAS_METRIC:
        np.testing.assert_array_equal(lat, jlat)
        np.testing.assert_array_equal(g, jg)
    else:
        np.testing.assert_allclose(lat, jlat, rtol=0, atol=1e-15)
        np.testing.assert_allclose(g, jg, rtol=0,
                                   atol=1e-14 * np.abs(jg).max())


_BUILD = ("import sys; from pathlib import Path; "
          "from mf_data_locality_tpu_torch import native; "
          "lib = native.load(Path(sys.argv[1])); "
          "print(lib is not None, "
          "native.library_path(Path(sys.argv[1])).exists())")


def test_concurrent_builds_both_load(tmp_path):
    """Two processes that build into one empty directory at once: both
    load the library (the lock, then ``os.replace``), and nothing but the
    library and its lock file is left there."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0].split() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs == [["True", "True"]] * 2
    lib = native.library_path(tmp_path)
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".lock").name])
