"""eigsort: sign-flip + reorder recovery on constructed cases
(reference ``eigsort.py:54-140``)."""

import jax.numpy as jnp
import numpy as np

from pyfocusr_tpu.spectral.eigsort import sort_eigenmaps_fn


def _make_case(seed=0, n=2000, k=5, perm=(1, 0, 2, 4, 3), flips=(0, 1, 1, 0, 1)):
    """Target eigvecs are smooth random fields; source = same fields with
    columns permuted and some flipped (plus noise).  eigsort must undo both."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    # Smooth synthetic "eigenvector" fields over the unit cube, in [-0.5, 0.5].
    freqs = np.arange(1, k + 1)
    fields = np.stack(
        [np.sin(np.pi * f * pts[:, 0]) * np.cos(np.pi * f * pts[:, 1]) for f in freqs],
        axis=1,
    )
    fields = (fields - fields.min(0)) / np.ptp(fields, axis=0) - 0.5
    eig_vals = (0.001 * freqs**2).astype(np.float32)

    perm = np.asarray(perm)
    flips = np.asarray(flips, bool)
    src = fields[:, perm].copy()
    src[:, flips[perm]] *= -1  # column j of src is field perm[j], maybe flipped
    # Renormalize flipped columns into [-0.5, 0.5] like Graph.norm_eig_vecs.
    src += rng.normal(scale=0.002, size=src.shape).astype(np.float32)
    src = (src - src.min(0)) / np.ptp(src, axis=0) - 0.5
    return pts, fields.astype(np.float32), src.astype(np.float32), eig_vals, perm, flips


def test_recovers_permutation_and_flip():
    pts, tgt, src, eig_vals, perm, flips = _make_case()
    eig_vals_src = eig_vals[np.argsort(perm)]  # source eigval for its column order
    vecs_out, Q, info = sort_eigenmaps_fn(
        jnp.asarray(eig_vals),
        jnp.asarray(eig_vals[perm]),
        jnp.asarray(tgt),
        jnp.asarray(src),
        jnp.asarray(pts),
        jnp.asarray(pts),
        jnp.asarray(src),
        target_as_reference=True,
    )
    out = np.asarray(vecs_out)
    # After sorting, column i of the output should correlate strongly and
    # positively with target field i.
    for i in range(tgt.shape[1]):
        a = tgt[:, i] - tgt[:, i].mean()
        b = out[:, i] - out[:, i].mean()
        corr = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert corr > 0.95, f"column {i}: corr={corr}"


def test_identity_case_unchanged():
    pts, tgt, _, eig_vals, _, _ = _make_case(perm=(0, 1, 2, 3, 4), flips=(0,) * 5)
    src = tgt + 0.002 * np.random.default_rng(1).normal(size=tgt.shape).astype(
        np.float32
    )
    vecs_out, Q, info = sort_eigenmaps_fn(
        jnp.asarray(eig_vals),
        jnp.asarray(eig_vals),
        jnp.asarray(tgt),
        jnp.asarray(src),
        jnp.asarray(pts),
        jnp.asarray(pts),
        jnp.asarray(src),
    )
    assert (info["target_matches"] == info["source_matches"]).all()
    assert not info["flipped"].any()
    np.testing.assert_allclose(np.asarray(vecs_out), src, atol=1e-6)


def test_jit_reverse_mode_matches_oracle():
    """sort_eigenmaps_jit(target_as_reference=False) must mutate the TARGET
    eigenmaps exactly as the transcription's reverse branch does
    (reference eigsort.py:75-78,100-122: assignment on Q.T, target columns
    flipped/permuted into the source's order)."""
    from pyfocusr_tpu.spectral.eigsort_jax import sort_eigenmaps_jit
    from tools.reference_pipeline import eigsort_ref

    pts, tgt, src, eig_vals, _, _ = _make_case()
    vals_s = eig_vals * 1.01

    out_jit, Q_jit = sort_eigenmaps_jit(
        jnp.asarray(eig_vals), jnp.asarray(vals_s),
        jnp.asarray(tgt), jnp.asarray(src),
        jnp.asarray(pts), jnp.asarray(pts),
        jnp.asarray(tgt),
        target_as_reference=False,
    )
    out_ref, Q_ref, _, _ = eigsort_ref(
        np.asarray(eig_vals, np.float64), np.asarray(vals_s, np.float64),
        np.asarray(tgt, np.float64), np.asarray(src, np.float64),
        np.asarray(pts, np.float64), np.asarray(pts, np.float64),
        np.asarray(src, np.float64),
        target_eig_vecs=np.asarray(tgt, np.float64),
        target_as_reference=False,
    )
    np.testing.assert_allclose(np.asarray(out_jit), out_ref, atol=2e-5)
    np.testing.assert_allclose(np.asarray(Q_jit), Q_ref, rtol=2e-3, atol=1e-7)


def test_quad_form_matches_matvec_quotient(mesh_5k_target):
    """sym_laplacian_quad_form == V^T A V on a small graph (f64 oracle),
    and both equal the matvec quotient to f32 accuracy."""
    import jax

    from pyfocusr_tpu.ops import graph_ops
    from pyfocusr_tpu.pipeline import mesh_to_graph_arrays

    g = mesh_to_graph_arrays(mesh_5k_target)
    w = graph_ops.edge_weights(g.points, g.neighbors, g.nbr_mask)
    ov_w = graph_ops.overflow_weights(g.points, g.overflow)
    d = graph_ops.degree_vector(w, g.overflow, ov_w)
    gv = (d + graph_ops.DEGREE_EPS) ** -1
    s = jnp.sqrt(gv)
    V = jax.random.normal(jax.random.PRNGKey(0), (g.n_points, 4))
    V = V / jnp.linalg.norm(V, axis=0, keepdims=True)
    lam_q = np.asarray(
        graph_ops.sym_laplacian_quad_form(g.neighbors, w, s, V, g.overflow, ov_w),
        np.float64,
    )
    Av = graph_ops.sym_laplacian_matvec(g.neighbors, w, gv, V, g.overflow, ov_w)
    lam_m = np.asarray(jnp.einsum("nk,nk->k", V, Av), np.float64)
    np.testing.assert_allclose(lam_q, lam_m, rtol=1e-4)
