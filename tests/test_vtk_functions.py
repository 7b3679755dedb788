"""Direct tests of the vtk_functions parity module (reference
``pyfocusr/vtk_functions.py`` surface, VTK-free)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pyfocusr_tpu import vtk_functions as vf

@pytest.fixture(scope="module")
def mesh(mesh_5k_source, tmp_path_factory):
    """The fixture source mesh, written to and read back from a .vtk file."""
    path = str(tmp_path_factory.mktemp("vtk") / "source_mesh.vtk")
    vf.write_vtk_mesh(path, mesh_5k_source)
    return vf.read_vtk_mesh(path)


def test_read_vtk_mesh(mesh, mesh_5k_source):
    assert mesh.n_points == mesh_5k_source.n_points
    assert mesh.n_triangles == mesh_5k_source.n_triangles
    np.testing.assert_allclose(
        np.asarray(mesh.points), np.asarray(mesh_5k_source.points), rtol=1e-6
    )


def test_write_vtk_mesh_roundtrip(mesh, tmp_path):
    p = str(tmp_path / "rt.vtk")
    vf.write_vtk_mesh(p, mesh)
    back = vf.read_vtk_mesh(p)
    np.testing.assert_allclose(
        np.asarray(back.points), np.asarray(mesh.points), rtol=1e-6
    )


def test_vtk_deep_copy_is_independent(mesh):
    copy = vf.vtk_deep_copy(mesh)
    assert copy is not mesh
    np.testing.assert_array_equal(np.asarray(copy.points), np.asarray(mesh.points))
    moved = copy.with_points(jnp.asarray(copy.points) + 1.0)
    # original untouched (array semantics; the reference needed DeepCopy for this)
    assert not np.allclose(np.asarray(moved.points), np.asarray(mesh.points))


def test_icp_transform_and_apply(mesh):
    # Translate the mesh, fit ICP back onto the original, apply.
    moved = mesh.with_points(jnp.asarray(mesh.points) + jnp.asarray([5.0, -2.0, 1.0]))
    transform = vf.icp_transform(target=mesh, source=moved, numberOfIterations=30)
    s, R, t = transform
    back = vf.apply_transform(moved, transform)
    d = np.linalg.norm(
        np.asarray(back.points) - np.asarray(mesh.points), axis=1
    )
    assert d.mean() < 2.0  # crude realignment, per the reference's ICP role


def test_icp_transform_invalid_mode(mesh):
    with pytest.raises(ValueError, match="transform mode"):
        vf.icp_transform(mesh, mesh, transform_mode="banana")


def test_curvature_getters(mesh):
    kmin, kmax = vf.get_min_max_curvature_values(mesh)
    assert kmin.shape == (mesh.n_points,)
    assert np.all(kmin <= kmax + 1e-6)
    (only_max,) = vf.get_max_curvature(mesh)
    (only_min,) = vf.get_min_curvature(mesh)
    np.testing.assert_allclose(only_max, kmax)
    np.testing.assert_allclose(only_min, kmin)
    out = vf.get_node_curvatures(mesh, curvature_type="min")
    assert "min_curvature" in out.point_data
