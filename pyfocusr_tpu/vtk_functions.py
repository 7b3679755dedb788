"""API-parity module mirroring reference ``pyfocusr/vtk_functions.py`` on top
of the JAX mesh/ops stack — same function names, VTK nowhere in the
compute path (VTK remains an optional I/O adapter only, per SURVEY §2.3).

Mapping (reference file:line -> here):
  read_vtk_mesh                 vtk_functions.py:5-9    -> pure-numpy legacy reader
  icp_transform                 vtk_functions.py:12-29  -> jitted ICP (ops/icp.py)
  apply_transform               vtk_functions.py:32-37  -> apply (s, R, t) to a TriMesh
  get_node_curvatures (+3)      vtk_functions.py:40-74  -> discrete curvature ops
  vtk_deep_copy                 vtk_functions.py:77-81  -> array copy of the TriMesh
"""

from __future__ import annotations


import jax.numpy as jnp
import numpy as np

from .mesh import TriMesh, as_trimesh, load_mesh, save_mesh, build_topology
from .ops.curvature import principal_curvatures
from .ops.icp import icp as _icp, apply_rigid

__all__ = [
    "read_vtk_mesh",
    "write_vtk_mesh",
    "icp_transform",
    "apply_transform",
    "get_node_curvatures",
    "get_min_curvature",
    "get_max_curvature",
    "get_min_max_curvature_values",
    "vtk_deep_copy",
]


def read_vtk_mesh(path_to_file: str) -> TriMesh:
    return load_mesh(path_to_file)


def write_vtk_mesh(path_to_file: str, mesh: TriMesh) -> None:
    save_mesh(path_to_file, mesh)


def icp_transform(
    target: TriMesh,
    source: TriMesh,
    numberOfIterations: int = 100,
    number_landmarks: int = 1000,
    transform_mode: str = "rigid",
):
    """Fit ICP moving ``source`` onto ``target``; returns the (s, R, t) tuple.

    ``number_landmarks`` is accepted for signature parity but unused: the
    reference sets it after Update() so it never took effect either
    (``vtk_functions.py:27-28``), and the device NN query is cheap enough to use
    every point.
    """
    target, source = as_trimesh(target), as_trimesh(source)
    (s, R, t), _moved = _icp(
        jnp.asarray(source.points, jnp.float32),
        jnp.asarray(target.points, jnp.float32),
        mode=transform_mode,
        max_iterations=numberOfIterations,
    )
    return (s, R, t)


def apply_transform(source: TriMesh, transform) -> TriMesh:
    source = as_trimesh(source)
    s, R, t = transform
    return source.with_points(apply_rigid(jnp.asarray(source.points, jnp.float32), s, R, t))


def _curvatures(mesh: TriMesh):
    mesh = as_trimesh(mesh)
    topo = build_topology(np.asarray(mesh.triangles), mesh.n_points)
    return principal_curvatures(
        jnp.asarray(mesh.points, jnp.float32),
        jnp.asarray(mesh.triangles),
        jnp.asarray(topo.edges),
        jnp.asarray(topo.edge_faces),
    )


def get_node_curvatures(vtk_mesh: TriMesh, curvature_type: str = "min") -> TriMesh:
    vtk_mesh = as_trimesh(vtk_mesh)
    kmin, kmax = _curvatures(vtk_mesh)
    vals = kmin if curvature_type == "min" else kmax
    name = f"{curvature_type}_curvature"
    return vtk_mesh.with_point_data(name, vals)


def get_max_curvature(vtk_mesh: TriMesh):
    return [np.asarray(_curvatures(vtk_mesh)[1])]


def get_min_curvature(vtk_mesh: TriMesh):
    return [np.asarray(_curvatures(vtk_mesh)[0])]


def get_min_max_curvature_values(vtk_mesh: TriMesh):
    kmin, kmax = _curvatures(vtk_mesh)
    return np.asarray(kmin), np.asarray(kmax)


def vtk_deep_copy(mesh: TriMesh) -> TriMesh:
    mesh = as_trimesh(mesh)
    return TriMesh(
        jnp.array(mesh.points),
        jnp.array(mesh.triangles),
        {k: jnp.array(v) for k, v in mesh.point_data.items()},
    )
