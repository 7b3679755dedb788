"""Registration-quality metrics (public API).

The reference never quantifies registration quality — its notebook checks
results visually (``examples/Example_registering_two_bone_meshes.ipynb``,
"Getting Results" cell).  These are the measures this framework's own
benchmarks and golden gates standardized on; exposing them lets users make
the same judgement programmatically:

* ``unique_fraction`` — fraction of source vertices claiming DISTINCT
  target vertices; many-to-one collapse is the classic failure mode of a
  bad spectral alignment (a scrambled eigenmap maps whole regions onto one
  point).  Healthy runs on the bundled pairs sit at ~0.85-0.88.
* ``mean_displacement_mm`` — mean distance each source vertex moved;
  sanity-scale check (inter-subject bone pairs: a few mm).
* ``symmetric_surface_dist_mm`` — mean nearest-neighbor distance from the
  transformed source to the target surface and back, averaged; measures
  how well the moved surface lies ON the target (bundled 15k pair:
  ~0.37 mm).
* ``hausdorff_mm`` — the worst-case (max) of those nearest-neighbor
  distances, both directions; catches a single badly-placed region that
  the means hide.

All distance queries run through the device KNN path (``ops.knn.nn_query``),
so the metrics stay cheap at 100k+ vertices.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .ops.knn import nn_query

__all__ = ["registration_quality", "surface_distance"]


def _points_of(obj):
    pts = getattr(obj, "points", obj)
    return np.asarray(pts, np.float64)


def surface_distance(points_a, points_b):
    """Symmetric nearest-neighbor surface distance between two point sets
    (or meshes).  Returns ``(mean_mm, hausdorff_mm)``: the symmetric mean
    and the symmetric max (Hausdorff distance) over both directions."""
    a = jnp.asarray(_points_of(points_a), jnp.float32)
    b = jnp.asarray(_points_of(points_b), jnp.float32)
    d_ab, _ = nn_query(b, a)  # for each a-point: nearest b-point
    d_ba, _ = nn_query(a, b)
    d_ab = np.asarray(d_ab, np.float64)
    d_ba = np.asarray(d_ba, np.float64)
    mean = float((d_ab.mean() + d_ba.mean()) / 2.0)
    haus = float(max(d_ab.max(), d_ba.max()))
    return mean, haus


def registration_quality(target, source, result):
    """Standard quality readout for one :func:`pipeline.register_pair`
    result (also accepts a :class:`Focusr` after ``align_maps`` — pass
    ``reg.graph_target.mesh``/``reg.graph_source.mesh`` equivalents or the
    raw point arrays).

    ``target`` / ``source``: the ORIGINAL meshes (TriMesh or [N, 3]
    arrays; ``source`` must be the post-ICP source if ICP ran outside the
    pipeline, which is where displacement is measured from).
    ``result``: dict holding ``correspondences`` (i32 [Ns]) and
    ``weighted_points`` (f32 [Ns, 3]) — ``register_pair``'s output keys.

    Returns a dict of python floats (JSON-ready):
    ``unique_fraction``, ``mean_displacement_mm``,
    ``symmetric_surface_dist_mm``, ``hausdorff_mm``, ``n_source_points``.
    """
    corr = np.asarray(result["correspondences"])
    moved = np.asarray(result["weighted_points"], np.float64)
    src = _points_of(source)
    tgt = _points_of(target)
    if moved.shape != src.shape:
        raise ValueError(
            f"weighted_points {moved.shape} does not match source points "
            f"{src.shape}; pass the same (unpadded) source the result was "
            "computed from"
        )
    mean, haus = surface_distance(moved, tgt)
    n_unique = int(len(np.unique(corr)))
    return {
        "n_source_points": int(corr.shape[0]),
        "n_unique_correspondences": n_unique,
        "unique_fraction": round(n_unique / corr.shape[0], 4),
        "mean_displacement_mm": round(
            float(np.linalg.norm(moved - src, axis=1).mean()), 4
        ),
        "symmetric_surface_dist_mm": round(mean, 4),
        "hausdorff_mm": round(haus, 4),
    }
