"""Seeded synthetic bone-like surfaces.

The one generator of test and smoke-run inputs: an icosphere, subdivided,
radially warped by seeded low-frequency bumps and stretched to femur-like
proportions at mm scale, with a smooth ``thickness_change_(mm)`` scalar.
Two seeds give a source/target pair with the same vertex count and a
shape difference of a few mm, the regime the registration is built for.

    subdivisions:  4       5        6        7
    vertices:      2,562   10,242   40,962   163,842
"""

from __future__ import annotations

import numpy as np

from .mesh import TriMesh

__all__ = ["synthetic_bone", "synthetic_pair"]

# Standard icosahedron (12 vertices, 20 faces).
_ICO_T = (1.0 + 5.0 ** 0.5) / 2.0
_ICO_VERTS = np.array(
    [
        (-1, _ICO_T, 0), (1, _ICO_T, 0), (-1, -_ICO_T, 0), (1, -_ICO_T, 0),
        (0, -1, _ICO_T), (0, 1, _ICO_T), (0, -1, -_ICO_T), (0, 1, -_ICO_T),
        (_ICO_T, 0, -1), (_ICO_T, 0, 1), (-_ICO_T, 0, -1), (-_ICO_T, 0, 1),
    ],
    np.float64,
)
_ICO_FACES = np.array(
    [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ],
    np.int32,
)


def synthetic_bone(seed: int, subdivisions: int = 4) -> TriMesh:
    """Deterministic bone-like closed surface with
    ``10 * 4**subdivisions + 2`` vertices (see the module table)."""
    from .multires import subdivide

    if subdivisions < 0:
        raise ValueError(f"subdivisions must be >= 0, got {subdivisions}")
    mesh = TriMesh(_ICO_VERTS.astype(np.float32), _ICO_FACES, {})
    for _ in range(subdivisions):
        mesh = subdivide(mesh)
    u = np.asarray(mesh.points, np.float64)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, 4)
    amp = rng.uniform(0.04, 0.10, 4)
    r = 1.0
    r = r + amp[0] * np.sin(2.0 * u[:, 0] + ph[0]) * np.cos(1.5 * u[:, 1] + ph[1])
    r = r + amp[1] * np.sin(3.0 * u[:, 2] + ph[2])
    r = r + amp[2] * np.cos(2.5 * u[:, 1] + ph[3]) * u[:, 2]
    r = r + amp[3] * u[:, 0] * u[:, 1]
    pts = u * r[:, None] * np.array([[16.0, 13.0, 38.0]])  # mm, elongated
    thickness = 1.0 + np.sin(3.0 * u[:, 2] + ph[0]) * np.cos(u[:, 0] + ph[2])
    return TriMesh(
        pts.astype(np.float32),
        np.asarray(mesh.triangles, np.int32),
        {"thickness_change_(mm)": thickness.astype(np.float32)},
    )


def synthetic_pair(subdivisions: int = 4, seed: int = 0):
    """(target, source) pair of :func:`synthetic_bone` surfaces; the
    default seed gives the test suite's fixture pair (target seed 2,
    source seed 1)."""
    return (
        synthetic_bone(seed + 2, subdivisions),
        synthetic_bone(seed + 1, subdivisions),
    )
