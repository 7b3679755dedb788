"""Hub-vertex (high-degree) handling: the degree-capped ELL + scatter-add
overflow path must be mathematically identical to uncapped ELL, and makes
pathological meshes (UV-sphere poles with degree 300+) tractable."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyfocusr_tpu.mesh import TriMesh, build_topology
from pyfocusr_tpu.ops import graph_ops as G
from pyfocusr_tpu.pipeline import PipelineConfig, mesh_to_graph_arrays, register_pair


def _fan_mesh(n_spokes=40):
    """Hub vertex 0 connected to a ring of n_spokes vertices (degree n_spokes)."""
    ang = np.linspace(0, 2 * np.pi, n_spokes, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang), np.zeros(n_spokes)], axis=1)
    pts = np.concatenate([[[0, 0, 0.2]], ring]).astype(np.float32)
    tris = np.array(
        [[0, 1 + i, 1 + (i + 1) % n_spokes] for i in range(n_spokes)], np.int32
    )
    return pts, tris


def test_capped_spmv_matches_uncapped():
    pts, tris = _fan_mesh(40)
    n = len(pts)
    topo_cap = build_topology(tris, n, degree_cap=8)
    topo_full = build_topology(tris, n, degree_cap=None)
    assert topo_cap.overflow_edges.shape[0] > 0
    assert topo_full.overflow_edges.shape[0] == 0

    x = jnp.asarray(np.random.default_rng(0).normal(size=(n, 3)), jnp.float32)
    pj = jnp.asarray(pts)

    def apply(topo):
        nbrs = jnp.asarray(topo.neighbors)
        mask = jnp.asarray(topo.nbr_mask)
        ov = jnp.asarray(topo.overflow_edges)
        w = G.edge_weights(pj, nbrs, mask)
        ov_w = G.overflow_weights(pj, ov)
        d = G.degree_vector(w, ov, ov_w)
        y = G.spmv(nbrs, w, x, ov, ov_w)
        return d, y

    d1, y1 = apply(topo_cap)
    d2, y2 = apply(topo_full)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-5, atol=1e-6)


def test_capped_spectrum_matches_uncapped(mesh_5k_source):
    """Bone mesh with an artificially tiny cap: identical spectrum."""
    from pyfocusr_tpu.pipeline import _spectrum

    cfg = PipelineConfig()
    ga_cap = mesh_to_graph_arrays(mesh_5k_source, degree_cap=4)
    ga_full = mesh_to_graph_arrays(mesh_5k_source, degree_cap=None)
    assert ga_cap.overflow.shape[0] > 0
    l1, v1, _ = _spectrum(ga_cap, 4, jax.random.PRNGKey(0), cfg)
    l2, v2, _ = _spectrum(ga_full, 4, jax.random.PRNGKey(0), cfg)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2), rtol=1e-3)
    for c in range(4):
        a, b = np.asarray(v1[:, c]), np.asarray(v2[:, c])
        cos = abs((a - a.mean()) @ (b - b.mean())) / (
            np.linalg.norm(a - a.mean()) * np.linalg.norm(b - b.mean())
        )
        assert cos > 0.999, (c, cos)


@pytest.mark.slow
def test_uv_sphere_pole_registration():
    """UV-sphere poles touch the whole first ring (degree ~48 here, 320 at
    the scale that faulted before the cap) — the capped path keeps the ELL
    narrow and registration completes."""
    import sys

    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_curvature_icp import make_sphere

    pts, tris = make_sphere(n_theta=16, n_phi=48)
    warp = pts * (1.0 + 0.05 * np.sin(2 * pts[:, [1]]))
    target = TriMesh(jnp.asarray(pts, jnp.float32), jnp.asarray(tris))
    source = TriMesh(jnp.asarray(warp.astype(np.float32)), jnp.asarray(tris))
    tg = mesh_to_graph_arrays(target)
    assert tg.neighbors.shape[1] <= 24  # cap engaged (pole degree is 48)
    assert tg.overflow.shape[0] > 0
    cfg = PipelineConfig(
        icp_iterations=10,
        n_coords_spectral_ordering=300,
        n_coords_spectral_registration=200,
        non_rigid_max_iterations=20,
        non_rigid_n_eigens=40,
        graph_smoothing_iterations=20,
        projection_smooth_iterations=2,
        eig_cg_iters=80,
    )
    res = register_pair(tg, mesh_to_graph_arrays(source), cfg, jax.random.PRNGKey(0))
    assert np.all(np.isfinite(np.asarray(res["weighted_points"])))
    assert np.all(np.isfinite(np.asarray(res["eig_vals_target"])))
