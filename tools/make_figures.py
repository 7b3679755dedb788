#!/usr/bin/env python
"""Render the documentation figures (docs/images/*.png) from the bundled
meshes — this rebuild's analogue of the reference's ``images/`` renders
(source/target, Fiedler + higher eigenvectors, transformed source, average
mesh).

Pure matplotlib (no VTK/itkwidgets): faces are shaded with a single
headlight via face normals; signed scalar fields (eigenvectors) use a
diverging two-hue map with a neutral midpoint (RdBu), magnitudes use
viridis.  Run on CPU::

    JAX_PLATFORMS=cpu python tools/make_figures.py [out_dir]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
from mpl_toolkits.mplot3d.art3d import Poly3DCollection

DATA = "/root/reference/data"


def _shade(points, triangles, base_rgb):
    """Per-face headlight shading factors and shaded colors."""
    tri_pts = points[triangles]  # [F, 3, 3]
    n = np.cross(tri_pts[:, 1] - tri_pts[:, 0], tri_pts[:, 2] - tri_pts[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    light = np.array([0.25, 0.25, 0.93])
    d = np.abs(n @ light)
    shade = (0.35 + 0.65 * d)[:, None]
    return shade * np.asarray(base_rgb)[None, :]


def render_mesh(ax, points, triangles, face_colors, elev=15, azim=-65):
    coll = Poly3DCollection(
        points[triangles], facecolors=face_colors, edgecolors="none"
    )
    ax.add_collection3d(coll)
    lo, hi = points.min(0), points.max(0)
    c, r = (lo + hi) / 2, (hi - lo).max() / 2
    for setter, k in zip(
        (ax.set_xlim, ax.set_ylim, ax.set_zlim), range(3)
    ):
        setter(c[k] - r, c[k] + r)
    ax.set_box_aspect((1, 1, 1))
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()


def fig_mesh(points, triangles, base_rgb, path, scalars=None, cmap=None,
             sym=False, title=None):
    fig = plt.figure(figsize=(4.2, 4.2), dpi=130)
    ax = fig.add_subplot(111, projection="3d")
    if scalars is None:
        colors = _shade(points, triangles, base_rgb)
    else:
        vals = np.asarray(scalars, float)
        face_vals = vals[triangles].mean(1)
        if sym:  # signed field: neutral midpoint at zero
            m = np.abs(face_vals).max() or 1.0
            t = (face_vals / m + 1) / 2
        else:
            lo, hi = face_vals.min(), face_vals.max()
            t = (face_vals - lo) / ((hi - lo) or 1.0)
        rgb = plt.get_cmap(cmap)(t)[:, :3]
        shade = _shade(points, triangles, (1.0, 1.0, 1.0))
        colors = rgb * shade
    render_mesh(ax, points, triangles, np.clip(colors, 0, 1))
    if title:
        ax.set_title(title, fontsize=10, pad=0)
    fig.tight_layout(pad=0.1)
    fig.savefig(path, transparent=False, facecolor="white",
                bbox_inches="tight")
    plt.close(fig)
    print("wrote", path)


def main(out_dir="docs/images"):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp  # noqa: F401

    from pyfocusr_tpu import Focusr, load_mesh

    os.makedirs(out_dir, exist_ok=True)
    target = load_mesh(f"{DATA}/target_mesh.vtk")
    source = load_mesh(f"{DATA}/source_mesh.vtk")
    t_pts = np.asarray(target.points, float)
    t_tri = np.asarray(target.triangles)
    s_pts = np.asarray(source.points, float)
    s_tri = np.asarray(source.triangles)

    # Solid renders (categorical identity: fixed two-color assignment).
    BLUE, ORANGE = (0.36, 0.54, 0.86), (0.93, 0.60, 0.26)
    fig_mesh(t_pts, t_tri, BLUE, f"{out_dir}/target.png", title="target")
    fig_mesh(s_pts, s_tri, ORANGE, f"{out_dir}/source.png", title="source")

    # Registration (verify-skill config; seeded).
    reg = Focusr(
        vtk_mesh_target=target, vtk_mesh_source=source,
        n_spectral_features=3, n_extra_spectral=3,
        get_weighted_spectral_coords=False, list_features_to_calc=[],
        non_rigid_alpha=0.01, non_rigid_beta=50,
        non_rigid_max_iterations=100, rigid_before_non_rigid_reg=False,
        projection_smooth_iterations=1, graph_smoothing_iterations=100,
        n_coords_spectral_registration=1000, seed=0,
    )
    reg.align_maps()

    # Eigenvector fields on the target (signed -> diverging map, neutral 0).
    vecs = np.asarray(reg.graph_target.eig_vecs)
    for i in range(min(3, vecs.shape[1])):
        name = "fiedler" if i == 0 else f"eig_vec_{i + 1}"
        fig_mesh(
            t_pts, t_tri, None, f"{out_dir}/{name}.png",
            scalars=vecs[:, i], cmap="RdBu_r", sym=True,
            title=f"eigenvector {i + 1}" + (" (Fiedler)" if i == 0 else ""),
        )

    # Source transformed onto the target, colored by correspondence index
    # (continuous map so matched regions share colors with the target).
    corr_t = np.arange(len(t_pts), dtype=float)
    corr_s = np.asarray(reg.corresponding_target_idx_for_each_source_pt, float)
    moved = np.asarray(reg.weighted_avg_transformed_points, float)
    fig_mesh(t_pts, t_tri, None, f"{out_dir}/target_corresp.png",
             scalars=corr_t, cmap="viridis", title="target (vertex index)")
    fig_mesh(moved, s_tri, None, f"{out_dir}/transformed_corresp.png",
             scalars=corr_s, cmap="viridis",
             title="source -> target (correspondence index)")

    avg = reg.get_average_shape()
    fig_mesh(np.asarray(avg.points, float), np.asarray(avg.triangles),
             (0.55, 0.75, 0.58), f"{out_dir}/average_mesh.png",
             title="average mesh")


if __name__ == "__main__":
    main(*sys.argv[1:])
