"""Point-data transfer across correspondences (pyfocusr_tpu.transfer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyfocusr_tpu.pipeline import PipelineConfig, mesh_to_graph_arrays, register_pair
from pyfocusr_tpu.transfer import (
    cohort_point_data_matrix,
    mesh_with_transferred_data,
    transfer_point_data,
)

FAST = PipelineConfig(
    icp_iterations=30,
    non_rigid_max_iterations=40,
    graph_smoothing_iterations=50,
    projection_smooth_iterations=1,
    n_coords_spectral_registration=500,
    eig_cg_iters=150,
)


@pytest.fixture(scope="module")
def registered_5k(mesh_5k_target, mesh_5k_source):
    target, source = mesh_5k_target, mesh_5k_source
    res = register_pair(
        mesh_to_graph_arrays(target),
        mesh_to_graph_arrays(source),
        FAST,
        jax.random.PRNGKey(0),
    )
    return target, source, jax.tree.map(np.asarray, res)


def test_idw_transfer_of_coordinates_reproduces_weighted_points(registered_5k):
    """Transferring the coordinate function with 'idw' uses the exact
    neighbors/weights of the pipeline's weighted final locations, so it must
    reproduce weighted_points (f32-exactly, same kernel)."""
    target, source, res = registered_5k
    t2 = target.with_point_data("xyz", np.asarray(target.points, np.float32))
    out = transfer_point_data(t2, res, names=["xyz"])
    # Same kernel, different jit fusion: agreement up to f32 rounding at
    # the ~75 mm coordinate scale.
    np.testing.assert_allclose(
        out["xyz"], res["weighted_points"], atol=1e-3
    )


def test_nearest_transfer_gathers_by_correspondence(registered_5k):
    target, source, res = registered_5k
    vals = np.arange(np.asarray(target.points).shape[0], dtype=np.float32)
    t2 = target.with_point_data("vid", vals)
    out = transfer_point_data(t2, res, names=["vid"], method="nearest")
    np.testing.assert_array_equal(out["vid"], vals[res["correspondences"]])


def test_thickness_transfer_quality(registered_5k):
    """The bundled thickness scalar transfers with bounded, consistent
    values: IDW is a convex combination (stays in the field's range) and
    must closely track the nearest-vertex transfer (the two methods sample
    the same local neighborhood).  (The two subjects' thickness-CHANGE
    fields themselves are uncorrelated anatomy — no cross-subject
    correlation is asserted.)"""
    target, source, res = registered_5k
    name = "thickness_change_(mm)"
    out = transfer_point_data(target, res, names=[name])
    got = out[name]
    th_t = np.asarray(target.point_data[name], np.float64)
    assert got.shape == (np.asarray(source.points).shape[0],)
    assert np.all(np.isfinite(got))
    assert got.min() >= th_t.min() - 1e-5 and got.max() <= th_t.max() + 1e-5
    nearest = transfer_point_data(target, res, names=[name], method="nearest")[
        name
    ]
    r = np.corrcoef(got, nearest)[0, 1]
    assert r > 0.9, r


def test_unknown_name_raises(registered_5k):
    target, source, res = registered_5k
    with pytest.raises(KeyError, match="nope"):
        transfer_point_data(target, res, names=["nope"])
    with pytest.raises(ValueError, match="method"):
        transfer_point_data(target, res, method="bilinear")


def test_mesh_with_transferred_data(registered_5k):
    target, source, res = registered_5k
    mesh = mesh_with_transferred_data(
        source, target, res, names=["thickness_change_(mm)"], suffix="_t"
    )
    assert "thickness_change_(mm)_t" in mesh.point_data
    assert (
        np.asarray(mesh.point_data["thickness_change_(mm)_t"]).shape[0]
        == np.asarray(source.points).shape[0]
    )


def test_cohort_point_data_matrix():
    """[B, N_template] assembly in template vertex order via per-subject
    correspondences."""
    from pyfocusr_tpu.mesh import TriMesh

    pts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    tris = np.asarray([[0, 1, 2], [0, 1, 3]], np.int32)
    subjects = []
    for b in range(2):
        m = TriMesh(jnp.asarray(pts + b), jnp.asarray(tris))
        subjects.append(
            m.with_point_data("f", np.asarray([10, 11, 12, 13], np.float32) + b)
        )
    results = {
        "correspondences": np.asarray([[3, 2, 1, 0], [0, 1, 2, 3]], np.int32)
    }
    mat = cohort_point_data_matrix(subjects, results, "f")
    np.testing.assert_array_equal(
        mat, [[13, 12, 11, 10], [11, 12, 13, 14]]
    )
    with pytest.raises(KeyError):
        cohort_point_data_matrix(subjects, results, "missing")


def test_focusr_transfer_method():
    """Focusr.transfer_point_data after align_maps (small synthetic pair)."""
    import sys

    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_curvature_icp import make_sphere

    from pyfocusr_tpu import Focusr
    from pyfocusr_tpu.mesh import TriMesh

    pts, tris = make_sphere(n_theta=10, n_phi=20)
    target = TriMesh(jnp.asarray(pts, jnp.float32), jnp.asarray(tris))
    target = target.with_point_data("height", pts[:, 2].astype(np.float32))
    warped = pts * (1.0 + 0.05 * np.sin(3.0 * pts[:, [1]]))
    source = TriMesh(jnp.asarray(warped, jnp.float32), jnp.asarray(tris))
    reg = Focusr(
        vtk_mesh_target=target,
        vtk_mesh_source=source,
        n_spectral_features=3,
        n_extra_spectral=2,
        list_features_to_calc=[],
        non_rigid_max_iterations=10,
        graph_smoothing_iterations=10,
        projection_smooth_iterations=2,
        n_coords_spectral_registration=100,
        n_coords_spectral_ordering=150,
        seed=0,
    )
    with pytest.raises(RuntimeError, match="align_maps"):
        reg.transfer_point_data()
    reg.align_maps()
    out = reg.transfer_point_data(names=["height"])
    got = np.asarray(out["height"])
    assert got.shape == (pts.shape[0],)
    # The sphere pair is nearly isometric: transferred height must track
    # the source's own z closely.
    assert np.corrcoef(got, warped[:, 2])[0, 1] > 0.9


def test_names_accepts_any_iterable(registered_5k):
    """A generator for ``names`` must behave like a list (it is consumed
    once by validation, so it has to be materialized up front)."""
    target, source, res = registered_5k
    name = "thickness_change_(mm)"
    from_list = transfer_point_data(target, res, names=[name])
    from_gen = transfer_point_data(target, res, names=(n for n in [name]))
    assert set(from_gen) == {name}
    np.testing.assert_array_equal(from_list[name], from_gen[name])
    from_gen_n = transfer_point_data(
        target, res, names=iter([name]), method="nearest"
    )
    assert set(from_gen_n) == {name}


def test_padded_result_n_source_slices(registered_5k):
    """A result from PADDED graphs: n_source= slices both correspondence
    gather ('nearest') and the IDW queries to the real source rows, and the
    sliced output matches the unpadded transfer exactly."""
    target, source, res = registered_5k
    ns = np.asarray(res["correspondences"]).shape[0]
    pad = 37
    padded = dict(res)
    padded["correspondences"] = np.concatenate(
        [res["correspondences"], np.zeros(pad, res["correspondences"].dtype)]
    )
    padded["source_projected_on_target"] = np.concatenate(
        [res["source_projected_on_target"],
         np.zeros((pad, 3), np.float32)]
    )
    vals = np.arange(np.asarray(target.points).shape[0], dtype=np.float32)
    t2 = target.with_point_data("vid", vals)
    for method in ("nearest", "idw"):
        want = transfer_point_data(t2, res, names=["vid"], method=method)
        got = transfer_point_data(
            t2, padded, names=["vid"], method=method, n_source=ns
        )
        assert got["vid"].shape == (ns,)
        np.testing.assert_array_equal(got["vid"], want["vid"])


def test_cohort_matrix_rejects_out_of_range_indices():
    from pyfocusr_tpu.mesh import TriMesh

    pts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tris = np.asarray([[0, 1, 2]], np.int32)
    subj = TriMesh(jnp.asarray(pts), jnp.asarray(tris)).with_point_data(
        "f", np.asarray([1.0, 2.0, 3.0], np.float32)
    )
    results = {"correspondences": np.asarray([[0, 5, 1]], np.int32)}
    with pytest.raises(ValueError, match="reach 5"):
        cohort_point_data_matrix([subj], results, "f")


def test_cohort_matrix_n_template_slices():
    """Padded cohorts: rows beyond the template's real vertex count are
    padding and must be sliced off with n_template."""
    from pyfocusr_tpu.mesh import TriMesh

    pts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    tris = np.asarray([[0, 1, 2], [0, 1, 3]], np.int32)
    m = TriMesh(jnp.asarray(pts), jnp.asarray(tris)).with_point_data(
        "f", np.asarray([10, 11, 12, 13], np.float32)
    )
    # 6 result rows for a 4-vertex template: last 2 are padding (masked to 0)
    results = {"correspondences": np.asarray([[3, 2, 1, 0, 0, 0]], np.int32)}
    mat = cohort_point_data_matrix([m], results, "f", n_template=4)
    np.testing.assert_array_equal(mat, [[13, 12, 11, 10]])
    full = cohort_point_data_matrix([m], results, "f")
    assert full.shape == (1, 6)
    with pytest.raises(ValueError, match="n_template"):
        cohort_point_data_matrix([m], results, "f", n_template=7)


def test_mesh_with_transferred_data_rejects_short_rows(registered_5k):
    """A result from a smaller registration than source_mesh must raise,
    not silently attach truncated data."""
    from pyfocusr_tpu.mesh import TriMesh
    from pyfocusr_tpu.transfer import mesh_with_transferred_data

    target, source, res = registered_5k
    big_pts = np.zeros((source.n_points * 2, 3), np.float32)
    big_tris = np.asarray(source.triangles)
    big_source = TriMesh(big_pts, big_tris)
    with pytest.raises(ValueError, match="different registrations"):
        mesh_with_transferred_data(
            big_source, target, res, names=["thickness_change_(mm)"]
        )
