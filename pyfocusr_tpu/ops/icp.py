"""Iterative closest point (rigid / similarity) registration.

Replaces the reference's VTK ICP boundary (``vtk_functions.py:12-29``:
``vtkIterativeClosestPointTransform`` with ``vtkLandmarkTransform`` in
RigidBody or Similarity mode, ``StartByMatchingCentroidsOn``, <=100
iterations), used by ``Focusr.__init__`` to pre-align the meshes
(``focusr.py:110-131``).

Each iteration is one brute-force NN query (see ops/knn.py) plus a
closed-form Umeyama/Kabsch update — the whole loop is a single jitted
`lax.while_loop`.  Deliberate deviation from a reference quirk: VTK caps
landmarks at its default 200 points because the reference sets
``SetMaximumNumberOfLandmarks(1000)`` *after* ``Update()``
(``vtk_functions.py:27-28`` — documented latent defect, SURVEY §5.3); we use
all points, which is strictly more accurate and cheap on an accelerator.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .knn import nn_query
from ..utils.precision import f32_matmuls

__all__ = ["umeyama", "icp", "apply_rigid"]


def umeyama(src: jnp.ndarray, dst: jnp.ndarray, with_scale: bool, weights=None):
    """Least-squares similarity/rigid transform mapping src -> dst.

    Returns (scale s, rotation R [3,3], translation t [3]) minimizing
    sum_i w_i ||dst_i - (s R src_i + t)||^2 (Umeyama 1991; the closed form
    behind vtkLandmarkTransform's RigidBody/Similarity modes).  ``weights``
    (e.g. a padding valid_mask) excludes points from the fit.
    """
    if weights is None:
        weights = jnp.ones((src.shape[0],), src.dtype)
    wsum = jnp.maximum(jnp.sum(weights), 1e-30)
    wn = (weights / wsum)[:, None]
    mu_s = jnp.sum(src * wn, axis=0)
    mu_d = jnp.sum(dst * wn, axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = (dc * wn).T @ sc
    U, S, Vt = jnp.linalg.svd(cov)
    d = jnp.sign(jnp.linalg.det(U) * jnp.linalg.det(Vt))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], cov.dtype).at[2].set(d))
    R = U @ D @ Vt
    if with_scale:
        var_s = jnp.sum(jnp.sum(sc * sc, axis=1) * wn[:, 0])
        s = jnp.sum(S * jnp.diag(D)) / jnp.maximum(var_s, 1e-30)
    else:
        s = jnp.array(1.0, cov.dtype)
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def apply_rigid(points, s, R, t):
    return s * (points @ R.T) + t


@partial(jax.jit, static_argnames=("mode", "max_iterations"))
@f32_matmuls
def icp(
    source_points,
    target_points,
    mode: str = "rigid",
    max_iterations: int = 100,
    source_mask=None,
):
    """ICP registering source onto target.

    mode: 'rigid' (rotation+translation) or 'similarity' (adds isotropic
    scale) — mirrors ``icp_transform(transform_mode=...)``
    (``vtk_functions.py:16-19``).  Starts by matching centroids
    (``StartByMatchingCentroidsOn``, ``vtk_functions.py:25``).

    Returns (s, R, t) such that transformed = s * source @ R.T + t, plus the
    transformed source points.
    """
    with_scale = mode == "similarity"
    if mode not in ("rigid", "similarity"):
        raise ValueError("Error invalid transform mode")  # cf. vtk_functions.py:21
    if source_mask is None:
        source_mask = jnp.ones((source_points.shape[0],), source_points.dtype)
    wn = source_mask / jnp.maximum(jnp.sum(source_mask), 1e-30)
    # Target centroid over finite (non-sentinel) rows only.
    finite_t = jnp.all(jnp.abs(target_points) < 1e29, axis=1).astype(
        source_points.dtype
    )
    tn = finite_t / jnp.maximum(jnp.sum(finite_t), 1e-30)

    # Centroid pre-match.
    t0 = jnp.sum(target_points * tn[:, None], axis=0) - jnp.sum(
        source_points * wn[:, None], axis=0
    )
    moved0 = source_points + t0

    # Data-scale estimate for the relative stop threshold: max |coordinate|
    # over FINITE target rows (the binary mask, not the normalized weights —
    # multiplying by tn would divide the scale by n and make the threshold
    # unit-dependent, forcing every call to run all max_iterations).
    scale = jnp.max(jnp.abs(target_points * finite_t[:, None])) + 1.0

    def cond(carry):
        _, _, _, _, it, delta = carry
        return jnp.logical_and(it < max_iterations, delta > 1e-5 * scale)

    def body(carry):
        moved, _, _, _, it, _ = carry
        _, idx = nn_query(target_points, moved)
        matched = target_points[idx]
        s, R, t = umeyama(source_points, matched, with_scale, weights=source_mask)
        new_moved = apply_rigid(source_points, s, R, t)
        # Mean vertex motion this iteration (masked): the convergence
        # criterion vtk's ICP uses (mean distance mode) in spirit.  The
        # where() keeps sentinel-scale padded rows out of the norm — their
        # inf * wn(=0) would otherwise poison delta with NaN and terminate
        # the loop after one iteration.
        delta = jnp.sum(
            jnp.where(
                source_mask > 0,
                jnp.linalg.norm(new_moved - moved, axis=1),
                0.0,
            )
            * wn
        )
        return new_moved, s, R, t, it + 1, delta

    s0 = jnp.array(1.0, source_points.dtype)
    R0 = jnp.eye(3, dtype=source_points.dtype)
    init = (moved0, s0, R0, t0, jnp.int32(0), jnp.asarray(jnp.inf, source_points.dtype))
    moved, s, R, t, _, _ = jax.lax.while_loop(cond, body, init)
    return (s, R, t), moved
