"""Patch-dense filter operator (ops/patch_dense.py): the dense-block +
compacted-residual reformulation must apply EXACTLY the same operator as
the fused ELL factory — it only regroups f32 summation (the round-5
filter-step redesign)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import DATA, SYNTHETIC_FIXTURES
from pyfocusr_tpu import load_mesh
from pyfocusr_tpu.ops import graph_ops
from pyfocusr_tpu.ops.patch_dense import build_patch_plan, patch_filter_factory
from pyfocusr_tpu.pipeline import PipelineConfig, mesh_to_graph_arrays



def _bundled(name):
    """A bundled mesh, or without the reference data the synthetic bone
    (4 subdivisions for the 5k meshes, 5 for the 15k ones)."""
    if not SYNTHETIC_FIXTURES:
        return load_mesh(f"{DATA}/{name}")
    from pyfocusr_tpu.synthetic import synthetic_bone

    return synthetic_bone(2, subdivisions=5 if "15k" in name else 4)


def _operator_pieces(g):
    mask = g.valid_mask
    w = graph_ops.edge_weights(g.points, g.neighbors, g.nbr_mask)
    ov = g.overflow
    ov_w = graph_ops.overflow_weights(g.points, ov)
    d = graph_ops.degree_vector(w, ov, ov_w)
    gv = jnp.where(mask > 0, (d + graph_ops.DEGREE_EPS) ** -1, 1.0)
    s = jnp.sqrt(gv)
    sw = s[:, None] * w * s[g.neighbors]
    sd = s * s * d * mask
    ov_sw = (
        ov_w * s[ov[:, 0]] * s[ov[:, 1]]
        if ov.shape[0] > 0
        else jnp.zeros((0,), sw.dtype)
    )
    return sw, ov_sw, sd, mask, s


def _ell_factory(g, sw, ov_sw, sd, mask):
    ov = g.overflow
    has_ov = ov.shape[0] > 0

    def factory(c, e):
        alpha = 2.0 / e

        def op(T):
            y = (alpha * (sd - c * mask))[:, None] * T - jnp.einsum(
                "nd,ndc->nc", alpha * sw, T[g.neighbors]
            )
            if has_ov:
                y = y.at[ov[:, 0]].add(
                    -(alpha * ov_sw)[:, None] * T[ov[:, 1]]
                )
            return y

        return op

    return factory


def _mesh_with_plan(name):
    g = mesh_to_graph_arrays(_bundled(name))
    if g.patch_plan is None:
        pytest.skip("mesh outside the patch-dense size gate")
    return g


@pytest.mark.parametrize("mesh_name", ["target_mesh.vtk", "source_mesh_15k.vtk"])
def test_patch_op_matches_ell(mesh_name):
    """Same operator application on both bundled shape classes (the 15k
    source mesh includes disconnected vertices)."""
    g = _mesh_with_plan(mesh_name)
    sw, ov_sw, sd, mask, _ = _operator_pieces(g)
    pf = patch_filter_factory(g.patch_plan, sw, ov_sw, sd, mask)
    ef = _ell_factory(g, sw, ov_sw, sd, mask)
    c, e = 0.7, 1.3
    T = jax.random.normal(jax.random.PRNGKey(0), (g.n_points, 16), jnp.float32)
    y_p = np.asarray(jax.jit(pf(c, e))(T))
    y_e = np.asarray(jax.jit(ef(c, e))(T))
    scale = np.abs(y_e).max()
    np.testing.assert_allclose(y_p, y_e, atol=2e-6 * scale)


def test_patch_op_with_overflow_edges():
    """Hub-overflow spill edges must land in the dense blocks / residual
    exactly like the ELL scatter-add applies them."""
    # The synthetic icosphere's vertices have degree 5 or 6, so its cap
    # sits one below to spill edges as the bundled mesh's hubs do at 6.
    cap = 5 if SYNTHETIC_FIXTURES else 6
    g0 = mesh_to_graph_arrays(_bundled("target_mesh.vtk"),
                              degree_cap=cap, patch_blocks=True)
    assert g0.overflow.shape[0] > 0, f"degree_cap={cap} should spill edges"
    sw, ov_sw, sd, mask, _ = _operator_pieces(g0)
    pf = patch_filter_factory(g0.patch_plan, sw, ov_sw, sd, mask)
    ef = _ell_factory(g0, sw, ov_sw, sd, mask)
    T = jax.random.normal(jax.random.PRNGKey(1), (g0.n_points, 8), jnp.float32)
    y_p = np.asarray(jax.jit(pf(0.5, 1.0))(T))
    y_e = np.asarray(jax.jit(ef(0.5, 1.0))(T))
    scale = np.abs(y_e).max()
    np.testing.assert_allclose(y_p, y_e, atol=2e-6 * scale)


def test_plan_gating():
    """Small meshes, padded graphs and cohort-style construction carry no
    plan; the bundled pair does."""
    g = mesh_to_graph_arrays(_bundled("target_mesh.vtk"))
    assert g.patch_plan is not None
    g_pad = mesh_to_graph_arrays(
        _bundled("target_mesh.vtk"), pad_n_points=5120
    )
    assert g_pad.patch_plan is None
    assert build_patch_plan(np.zeros((100, 8), np.int32),
                            np.zeros((100, 8), np.float32)) is None


def test_spectrum_patch_vs_ell_eigpairs():
    """End contract: the eigensolve over the patch-dense filter matches
    the ELL filter's eigenpairs to solver tolerance."""
    from pyfocusr_tpu.pipeline import _spectrum

    mesh = _bundled("target_mesh.vtk")
    g_plan = mesh_to_graph_arrays(mesh)
    g_ell = mesh_to_graph_arrays(mesh, patch_blocks=False)
    assert g_ell.patch_plan is None
    cfg = PipelineConfig()
    l1, v1, _ = jax.jit(
        lambda g, k: _spectrum(g, 6, k, cfg)
    )(g_plan, jax.random.PRNGKey(0))
    l2, v2, _ = jax.jit(
        lambda g, k: _spectrum(g, 6, k, cfg)
    )(g_ell, jax.random.PRNGKey(0))
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2), rtol=5e-3)
    for c in range(6):
        a = np.asarray(v1[:, c]) - np.asarray(v1[:, c]).mean()
        b = np.asarray(v2[:, c]) - np.asarray(v2[:, c]).mean()
        cos = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos > 0.999, (c, cos)
