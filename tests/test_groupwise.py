"""Symmetric and all-pairs groupwise registration (parallel/groupwise.py).

The reference is strictly one-directional one-pair (``focusr.py:514-570``);
these modes are beyond-parity capabilities, so the oracles are internal
consistency properties: forward/backward agreement, three-cycle
transitivity, and synchronization not degrading (and repairing corrupted)
map sets.

Fixtures are decimated BONE meshes, not spheres: sphere Laplacians have
degenerate multiplets whose eigenmaps rotate freely between runs (the
test_cohort.py caveat), which makes cross-direction consistency assertions
meaningless.  The bone's spectrum is simple, so both directions land on the
same map branch."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from conftest import DATA, _require_data
from pyfocusr_tpu.mesh import TriMesh
from pyfocusr_tpu.parallel.groupwise import (
    cycle_consistency_error,
    register_all_pairs,
    register_pair_symmetric,
    spectral_bases,
    synchronize_correspondences,
    synchronize_spectral,
)
from pyfocusr_tpu.pipeline import PipelineConfig, mesh_to_graph_arrays


@functools.lru_cache(maxsize=1)
def _coarse_bone_pts_tris():
    _require_data()
    from pyfocusr_tpu import load_mesh
    from pyfocusr_tpu.multires import decimate

    bone = load_mesh(f"{DATA}/target_mesh.vtk")
    coarse, _, _ = decimate(bone, 700, seed=0)
    return np.asarray(coarse.points), np.asarray(coarse.triangles)


def _bone_mesh(amp=0.0, phase=0.0):
    pts, tris = _coarse_bone_pts_tris()
    if amp:
        pts = pts * (1.0 + amp * np.sin(0.05 * pts[:, [1]] + phase))
    return TriMesh(jnp.asarray(pts, jnp.float32), jnp.asarray(tris))


def _extent():
    pts, _ = _coarse_bone_pts_tris()
    return float(np.linalg.norm(np.ptp(pts, axis=0)))


@functools.lru_cache(maxsize=1)
def _spacing():
    """Mean nearest-neighbor vertex spacing of the decimated fixture
    (~6 mm at 700 vertices) — the resolution floor every vertex-level map
    metric is bounded by."""
    from pyfocusr_tpu.ops.knn import knn_query

    pts, _ = _coarse_bone_pts_tris()
    d, _ = knn_query(jnp.asarray(pts, jnp.float32), jnp.asarray(pts, jnp.float32), k=2)
    return float(np.asarray(d)[:, 1].mean())


TINY = PipelineConfig(
    icp_iterations=10,
    n_coords_spectral_ordering=150,
    n_coords_spectral_registration=100,
    non_rigid_max_iterations=10,
    non_rigid_n_eigens=30,
    graph_smoothing_iterations=10,
    projection_smooth_iterations=2,
    eig_cg_iters=60,
)


def test_symmetric_pair_diagnostics_and_fusion():
    target = mesh_to_graph_arrays(_bone_mesh(amp=0.004))
    source = mesh_to_graph_arrays(_bone_mesh(amp=0.008, phase=0.5))
    res = register_pair_symmetric(target, source, TINY, jax.random.PRNGKey(0))
    n = source.n_points
    ext = _extent()
    assert res["sym_points"].shape == (n, 3)
    assert res["sym_correspondences"].shape == (n,)
    assert np.all(np.isfinite(np.asarray(res["sym_points"])))
    # Diagnostics are physical distances: finite, nonnegative, and a small
    # fraction of the mesh extent (the two shapes differ by <1% warps).
    fb = float(res["fb_consistency"])
    cyc = float(res["cycle_error"])
    assert 0.0 <= fb < 1.5 * _spacing()
    assert 0.0 <= cyc < 1.5 * _spacing()
    # Fused correspondences stay in range and keep a healthy unique
    # fraction (no collapse onto a few target vertices).
    corr = np.asarray(res["sym_correspondences"])
    assert corr.min() >= 0 and corr.max() < target.n_points
    assert len(np.unique(corr)) > 0.5 * n
    # Mirror direction present and sized to the target.
    assert res["target_sym_points"].shape == (target.n_points, 3)
    # The symmetric map is the midpoint of the two estimates: it can move
    # at most half their disagreement away from the forward map.
    gap = np.linalg.norm(
        np.asarray(res["sym_points"])
        - np.asarray(res["forward"]["weighted_points"]),
        axis=1,
    ).mean()
    assert gap <= 0.5 * fb + 1e-5


def test_symmetric_self_registration_near_identity():
    """Registering a mesh to itself must produce a near-identity symmetric
    map with tiny diagnostics."""
    m = mesh_to_graph_arrays(_bone_mesh(amp=0.004))
    res = register_pair_symmetric(m, m, TINY, jax.random.PRNGKey(1))
    assert float(res["fb_consistency"]) < 1.0 * _spacing()
    assert float(res["cycle_error"]) < 1.0 * _spacing()
    corr = np.asarray(res["sym_correspondences"])
    pts = np.asarray(m.points)
    # Landing positions, not indices (adjacent vertices may swap).
    assert np.linalg.norm(pts[corr] - pts, axis=1).mean() < 1.0 * _spacing()


def _tiny_cohort(b=3):
    return [_bone_mesh(amp=0.004 * (i + 1), phase=0.4 * i) for i in range(b)]


def test_all_pairs_shapes_and_cycle_error():
    meshes = _tiny_cohort(3)
    corr, pair_index, results = register_all_pairs(
        meshes, TINY, jax.random.PRNGKey(2)
    )
    B = len(meshes)
    n_pad = max(m.n_points for m in meshes)
    assert corr.shape == (B, B, n_pad)
    assert len(pair_index) == B * (B - 1)
    assert results["correspondences"].shape == (B * (B - 1), n_pad)
    # Diagonal is the identity.
    for i in range(B):
        np.testing.assert_array_equal(corr[i, i], np.arange(n_pad))
    pts = [np.asarray(m.points) for m in meshes]
    n_real = [m.n_points for m in meshes]
    err = cycle_consistency_error(corr, pts, n_real)
    assert 0.0 <= err < 1.5 * _spacing()


def test_synchronization_repairs_corrupted_maps():
    meshes = _tiny_cohort(3)
    corr, _, _ = register_all_pairs(meshes, TINY, jax.random.PRNGKey(3))
    pts = [np.asarray(m.points) for m in meshes]
    n_real = [m.n_points for m in meshes]
    base = cycle_consistency_error(corr, pts, n_real)

    # Corrupt ONE directed map with heavy index noise; the consensus over
    # B two-hop compositions must pull the cycle error back down.
    rng = np.random.default_rng(0)
    bad = corr.copy()
    noise = rng.integers(0, n_real[1], size=n_real[0])
    mix = rng.random(n_real[0]) < 0.5
    bad[0, 1, : n_real[0]] = np.where(
        mix, noise, bad[0, 1, : n_real[0]]
    ).astype(np.int32)
    corrupted = cycle_consistency_error(bad, pts, n_real)
    assert corrupted > base  # the corruption is visible

    fixed = synchronize_correspondences(bad, pts, n_real)
    repaired = cycle_consistency_error(fixed, pts, n_real)
    assert repaired < corrupted
    # And on the CLEAN maps, synchronization must not make things worse
    # than a modest factor of the already-small baseline.
    synced = synchronize_correspondences(corr, pts, n_real)
    clean_after = cycle_consistency_error(synced, pts, n_real)
    assert clean_after <= max(base * 1.5, 1.0 * _spacing())


def test_spectral_synchronization_repairs_and_detects():
    """Functional-map synchronization: latent alignments are orthogonal,
    clean maps stay near the consistent branch, a corrupted map is both
    FLAGGED (largest functional-map residual) and repaired."""
    from pyfocusr_tpu.parallel.cohort import pad_cohort

    meshes = _tiny_cohort(3)
    graphs = pad_cohort(meshes)
    corr, _, _ = register_all_pairs(graphs, TINY, jax.random.PRNGKey(5))
    pts = [np.asarray(m.points) for m in meshes]
    n_real = [m.n_points for m in meshes]
    base = cycle_consistency_error(corr, pts, n_real)

    synced, info = synchronize_spectral(
        corr, graphs, TINY, jax.random.PRNGKey(6)
    )
    # Latent alignments are orthogonal matrices.
    for q in info["Q"]:
        np.testing.assert_allclose(q @ q.T, np.eye(q.shape[0]), atol=1e-8)
    # A clean map set is a fixed point: nothing flagged, maps bit-identical.
    assert not info["flagged"].any()
    np.testing.assert_array_equal(synced, corr)

    # Corrupt ONE directed map with heavy index noise.
    rng = np.random.default_rng(1)
    bad = corr.copy()
    noise = rng.integers(0, n_real[1], size=n_real[0])
    mix = rng.random(n_real[0]) < 0.5
    bad[0, 1, : n_real[0]] = np.where(
        mix, noise, bad[0, 1, : n_real[0]]
    ).astype(np.int32)
    corrupted = cycle_consistency_error(bad, pts, n_real)
    assert corrupted > base

    fixed, info_bad = synchronize_spectral(
        bad, graphs, TINY, jax.random.PRNGKey(6)
    )
    # Detection: exactly the corrupted directed map is flagged, and it has
    # the largest functional-map residual.
    res = info_bad["residuals"]
    assert info_bad["flagged"][0, 1]
    assert info_bad["flagged"].sum() == 1
    off_diag = res[~np.eye(len(meshes), dtype=bool)]
    assert res[0, 1] == off_diag.max()
    # Every other map untouched.
    untouched = fixed.copy()
    untouched[0, 1] = bad[0, 1]
    np.testing.assert_array_equal(untouched, bad)
    # Repair: cycle error pulled back down near the clean baseline, and the
    # repaired map lands near the clean pipeline map (positions on mesh 1).
    repaired = cycle_consistency_error(fixed, pts, n_real)
    assert repaired < corrupted
    assert repaired <= max(1.5 * base, 0.5 * _spacing())
    dist = np.linalg.norm(
        pts[1][fixed[0, 1, : n_real[0]]] - pts[1][corr[0, 1, : n_real[0]]],
        axis=1,
    ).mean()
    bad_dist = np.linalg.norm(
        pts[1][bad[0, 1, : n_real[0]]] - pts[1][corr[0, 1, : n_real[0]]],
        axis=1,
    ).mean()
    assert dist < 0.25 * bad_dist

    # The pure-spectral repair mode also recovers (coarser, but must beat
    # the corrupted map by a wide margin) — exercises the B==2-style path
    # where no trusted two-hop route exists.
    fixed_sp, _ = synchronize_spectral(
        bad, graphs, TINY, jax.random.PRNGKey(6), repair="spectral"
    )
    dist_sp = np.linalg.norm(
        pts[1][fixed_sp[0, 1, : n_real[0]]] - pts[1][corr[0, 1, : n_real[0]]],
        axis=1,
    ).mean()
    assert dist_sp < 0.5 * bad_dist


def test_spectral_bases_shapes_and_guard():
    meshes = _tiny_cohort(2)
    graphs = [mesh_to_graph_arrays(m) for m in meshes]
    bases = spectral_bases(graphs, TINY, jax.random.PRNGKey(7), n_basis=6)
    for b, m in zip(bases, meshes):
        assert b.shape == (m.n_points, 6)
        # Orthonormal columns under the sqrt(n) row scaling.
        np.testing.assert_allclose(
            b.T @ b / m.n_points, np.eye(6), atol=1e-8
        )
    with pytest.raises(ValueError, match="n_basis"):
        spectral_bases(graphs, TINY, jax.random.PRNGKey(7), n_basis=10**6)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_all_pairs_sharded_equals_one_device_bitwise(n_dev):
    """Pairs run one after another on each device, so the sharded fan-out
    (on 4 devices: 6 pairs padded to 8) equals the one-device run bit for
    bit."""
    from pyfocusr_tpu.synthetic import synthetic_bone

    meshes = [synthetic_bone(300 + i, 3) for i in range(3)]
    corr0, idx0, res0 = register_all_pairs(meshes, TINY, jax.random.PRNGKey(4))
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]).reshape(n_dev), ("pairs",))
    corr1, idx1, res1 = register_all_pairs(
        meshes, TINY, jax.random.PRNGKey(4), device_mesh=mesh
    )
    assert idx0 == idx1
    np.testing.assert_array_equal(corr1, corr0)
    for k in res0:
        np.testing.assert_array_equal(
            np.asarray(res1[k]), np.asarray(res0[k]), err_msg=k
        )


@pytest.mark.slow
def test_all_pairs_sharded_matches_unsharded():
    meshes = _tiny_cohort(3)
    corr0, _, _ = register_all_pairs(meshes, TINY, jax.random.PRNGKey(4))
    devs = np.array(jax.devices()[:6]).reshape(6)
    mesh = Mesh(devs, ("pairs",))
    corr1, _, _ = register_all_pairs(
        meshes, TINY, jax.random.PRNGKey(4), device_mesh=mesh
    )
    agree = (corr0 == corr1).mean()
    assert agree > 0.95  # identical program, device-order reductions only


def test_cycle_consistency_rejects_pairs():
    """B=2 has no 3-cycles; 0.0 would read as perfect transitivity."""
    corr = np.zeros((2, 2, 4), np.int32)
    pts = [np.zeros((4, 3), np.float32)] * 2
    with pytest.raises(ValueError, match=">= 3 meshes"):
        cycle_consistency_error(corr, pts, [4, 4])


def test_all_pairs_multi_axis_mesh_and_axis_validation():
    """The pairs-sharding guard checks the 'pairs' AXIS size, not the total
    device count, and rejects meshes without a 'pairs' axis (review
    finding)."""
    import jax
    import numpy as np
    import pytest
    from jax.sharding import Mesh

    from pyfocusr_tpu.parallel.groupwise import register_all_pairs
    from pyfocusr_tpu.pipeline import PipelineConfig

    meshes = _tiny_cohort(3)  # 6 ordered pairs
    cfg = TINY
    devs = np.asarray(jax.devices()[:4])
    bad = Mesh(devs.reshape(4), ("model",))
    with pytest.raises(ValueError, match="'pairs' mesh axis"):
        register_all_pairs(meshes, cfg, jax.random.PRNGKey(0), device_mesh=bad)
    # (2, 2) mesh with axes ('pairs', 'model'): 6 % 2 == 0, so valid even
    # though the TOTAL device count (4) does not divide 6.
    multi = Mesh(devs.reshape(2, 2), ("pairs", "model"))
    corr, pair_index, _ = register_all_pairs(
        meshes, cfg, jax.random.PRNGKey(0), device_mesh=multi
    )
    assert np.asarray(corr).shape[:2] == (3, 3) and len(pair_index) == 6


@pytest.mark.slow
def test_all_pairs_pad_to_device_count():
    """6 ordered pairs over an 8-device 'pairs' axis: the batch pads with
    dummy pairs so every device is active (a divisibility guard
    would leave 2 of 8 idle), and results match unsharded."""
    meshes = _tiny_cohort(3)
    corr0, idx0, _ = register_all_pairs(meshes, TINY, jax.random.PRNGKey(4))
    devs = np.array(jax.devices()[:8]).reshape(8)
    mesh = Mesh(devs, ("pairs",))
    corr1, idx1, res = register_all_pairs(
        meshes, TINY, jax.random.PRNGKey(4), device_mesh=mesh
    )
    assert idx0 == idx1 and len(idx1) == 6
    # Results keep exactly the real pairs (padding dropped).
    assert np.asarray(res["correspondences"]).shape[0] == 6
    agree = (corr0 == corr1).mean()
    assert agree > 0.95  # identical program, device-order reductions only
