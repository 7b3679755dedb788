"""End-to-end Focusr pipeline on the bundled 5k bone-mesh pair
(notebook-equivalent settings with reduced
iteration budgets for test speed)."""

import numpy as np
import pytest

from pyfocusr_tpu import Focusr


@pytest.fixture(scope="module")
def reg_5k(mesh_5k_target, mesh_5k_source):
    reg = Focusr(
        vtk_mesh_target=mesh_5k_target,
        vtk_mesh_source=mesh_5k_source,
        icp_register_first=True,
        n_spectral_features=3,
        n_extra_spectral=3,
        get_weighted_spectral_coords=False,
        list_features_to_calc=[],
        non_rigid_alpha=0.01,
        non_rigid_beta=50,
        non_rigid_n_eigens=100,
        non_rigid_max_iterations=150,
        rigid_before_non_rigid_reg=False,
        projection_smooth_iterations=1,
        graph_smoothing_iterations=100,
        feature_smoothing_iterations=10,
        norm_physical_and_spectral=True,
        n_coords_spectral_ordering=10000,
        n_coords_spectral_registration=1000,
        initial_correspondence_type="kd",
        final_correspondence_type="kd",
        seed=0,
    )
    reg.align_maps()
    return reg


@pytest.mark.slow
class TestEndToEnd:
    def test_correspondences_dense(self, reg_5k):
        corr = reg_5k.corresponding_target_idx_for_each_source_pt
        assert corr.shape == (5000,)
        # A good spectral registration maps many source points to distinct
        # target points.  The exact fraction is a noisy function of the CPD
        # warp (observed 0.60-0.86 across equivalent configs/seeds; the
        # smoothing+NN step amplifies small warp differences), so the gate is
        # deliberately loose — geometric quality is asserted by the
        # displacement/surface tests below.
        assert len(np.unique(corr)) > 0.55 * 5000

    def test_transformed_points_on_target_surface(self, reg_5k):
        nn = np.asarray(reg_5k.nearest_neighbor_transformed_points)
        tgt = np.asarray(reg_5k.graph_target.points)
        # Every transformed point IS a target vertex.
        from scipy.spatial import KDTree

        d, _ = KDTree(tgt).query(nn)
        assert d.max() < 1e-5

    def test_displacement_magnitude_sane(self, reg_5k):
        nn = np.asarray(reg_5k.nearest_neighbor_transformed_points)
        src = np.asarray(reg_5k.graph_source.points)
        d = np.linalg.norm(nn - src, axis=1)
        extent = np.linalg.norm(np.ptp(src, axis=0))
        assert d.mean() < 0.15 * extent  # bone pair: small deformation

    def test_weighted_final_points(self, reg_5k):
        w = np.asarray(reg_5k.weighted_avg_transformed_points)
        assert w.shape == (5000, 3)
        assert np.all(np.isfinite(w))
        # weighted average stays within the target bounding box (+margin)
        tgt = np.asarray(reg_5k.graph_target.points)
        lo, hi = tgt.min(0) - 1.0, tgt.max(0) + 1.0
        assert np.all(w >= lo) and np.all(w <= hi)

    def test_average_shape(self, reg_5k):
        avg = reg_5k.get_average_shape(align_type="weighted")
        assert avg.n_points == 5000
        mid = np.asarray(avg.points)
        src = np.asarray(reg_5k.graph_source.points)
        w = np.asarray(reg_5k.weighted_avg_transformed_points)
        np.testing.assert_allclose(mid, (src + w) / 2, atol=1e-5)

    def test_spectral_coords_shapes(self, reg_5k):
        assert reg_5k.source_spectral_coords.shape == (5000, 3)
        assert reg_5k.target_spectral_coords.shape == (5000, 3)
        assert reg_5k.source_spectral_coords_b4_reg.shape == (5000, 3)

    def test_transformed_meshes_built(self, reg_5k):
        assert reg_5k.weighted_avg_transformed_mesh is not None
        assert reg_5k.nearest_neighbour_transformed_mesh is not None
        assert reg_5k.weighted_avg_transformed_mesh.n_points == 5000

    def test_scalar_setters(self, reg_5k):
        reg_5k.set_all_mesh_scalars_to_corresp_target_idx()
        assert "corresp_idx" in reg_5k.graph_source.mesh.point_data
        assert "corresp_idx" in reg_5k.weighted_avg_transformed_mesh.point_data


def test_hungarian_guard_raises():
    """Unequal vertex counts + hungarian must raise (reference
    ``focusr.py:377-385``)."""
    # Drop one vertex from the target copy to force a mismatch cheaply: use
    # the guard check directly via a tiny stub object.
    from pyfocusr_tpu.focusr import Focusr as F

    reg = object.__new__(F)
    reg.initial_correspondence_type = "hungarian"
    reg.graph_source = type("G", (), {"n_points": 10})()

    class GT:
        points = np.zeros((12, 3), np.float32)

        def mean_filter_graph(self, v, iterations):
            return v

    reg.graph_target = GT()
    reg.graph_smoothing_iterations = 1
    import jax.numpy as jnp

    reg.graph_target.points = jnp.zeros((12, 3))
    with pytest.raises(Exception, match="kd"):
        reg.get_smoothed_correspondences()
