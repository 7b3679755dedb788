"""Mesh core: a pytree triangle-mesh container plus host-side topology
preprocessing (unique edges, padded fixed-degree neighbor tables).

Design: the reference keeps meshes as live ``vtkPolyData`` objects and walks
points/cells/edges through the Python<->C++ boundary one element at a time
(``graph.py:60-62`` per-point loop; ``graph.py:148-178`` per-cell/per-edge
adjacency loop — its dominant Python-side cost).  Here a mesh is a pytree of
static-shape arrays, and all connectivity analysis is a one-time vectorized
numpy pass at load; every per-iteration consumer (SpMV, smoothing, Laplacian)
then runs on the accelerator over the padded ELL neighbor table with no
host chatter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .io.mesh_formats import read_any, write_any

__all__ = [
    "TriMesh",
    "MeshTopology",
    "as_trimesh",
    "load_mesh",
    "save_mesh",
    "build_topology",
]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class TriMesh:
    """Triangle mesh as arrays.

    points:     f32/f64 [N, 3] vertex positions
    triangles:  i32 [F, 3] vertex indices per face
    point_data: dict of named per-vertex arrays (e.g. 'thickness_change_(mm)')

    Replaces the reference's ``vtkPolyData`` + ``Graph.points`` extraction
    (``graph.py:58-67``).
    """

    points: jnp.ndarray
    triangles: jnp.ndarray
    point_data: Dict[str, jnp.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.triangles.shape[0]

    def with_points(self, new_points) -> "TriMesh":
        """Copy of this mesh with replaced vertex positions (array analogue of
        ``vtk_deep_copy`` + per-point ``SetPoint`` loops, ``focusr.py:605-625``)."""
        return TriMesh(jnp.asarray(new_points), self.triangles, dict(self.point_data))

    def with_point_data(self, name: str, values) -> "TriMesh":
        pd = dict(self.point_data)
        pd[name] = jnp.asarray(values)
        return TriMesh(self.points, self.triangles, pd)

    def tree_flatten(self):
        keys = tuple(sorted(self.point_data.keys()))
        children = (self.points, self.triangles) + tuple(
            self.point_data[k] for k in keys
        )
        return children, keys

    @classmethod
    def tree_unflatten(cls, keys, children):
        points, triangles = children[0], children[1]
        pd = dict(zip(keys, children[2:]))
        return cls(points, triangles, pd)


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Static connectivity derived from triangles (host-side, numpy).

    edges:      i32 [E, 2]  unique undirected edges (i < j)
    neighbors:  i32 [N, D]  padded neighbor table (ELL); padding = own index
    nbr_mask:   f32 [N, D]  1.0 for real neighbor slots, 0.0 for padding
    max_degree: int         D
    """

    edges: np.ndarray
    neighbors: np.ndarray
    nbr_mask: np.ndarray
    max_degree: int
    edge_faces: np.ndarray  # i32 [E, 2] faces incident to each edge (-1 if boundary)
    component_labels: np.ndarray  # i32 [N] connected-component id per vertex
    n_components: int
    # Directed edges that did not fit a vertex's ELL row (degree > cap).
    # Empty for meshes whose max degree is within the cap; processed with
    # scatter-add so SpMV cost is bounded by TOTAL edges, not max degree
    # (hub vertices like UV-sphere poles would otherwise inflate every row).
    overflow_edges: np.ndarray = None  # i32 [E_o, 2] (src, dst)

    @property
    def n_points(self) -> int:
        return self.neighbors.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edges.shape[0]


def build_topology(
    triangles: np.ndarray,
    n_points: int,
    pad_degree: Optional[int] = None,
    degree_cap: Optional[int] = 24,
) -> MeshTopology:
    """Extract unique undirected edges and a padded ELL neighbor table.

    Semantics note: the reference writes ``adjacency[i, j] = 1/dist`` once per
    (cell, edge) visit (``graph.py:148-178``); duplicate visits overwrite with
    the same value, so the effective structure is the set of unique mesh edges,
    symmetric for interior edges of a manifold mesh.  We make the graph
    symmetric for boundary edges too (the reference leaves those one-sided —
    a lil_matrix artifact, not a design choice; bundled meshes are closed so
    behavior is identical on them).
    """
    tris = np.asarray(triangles, dtype=np.int64)
    if tris.size and (tris.min() < 0 or tris.max() >= n_points):
        # Validate up front: the packed-key edge dedup below would DECODE
        # out-of-range indices into different in-range edges (e.g. pair
        # (5, 12) with n_points=10 packs to 62 -> edge (6, 2)) — silent
        # corruption instead of an error.  The native path returns None for
        # the same inputs expecting python to raise; do so for both.
        raise ValueError(
            f"triangle indices span [{tris.min()}, {tris.max()}] but the "
            f"mesh has {n_points} points"
        )

    # Native C++ fast path (native/fast_topology.cpp): identical outputs
    # (byte-for-byte — gated by tests/test_native_topology.py), one pass
    # instead of several sort/unique/accumulate sweeps; matters on the
    # multiresolution critical path (240k mesh: ~10 s numpy -> ~0.3 s).
    if tris.size:
        from .native import topology_native

        head = topology_native(tris, n_points, None)
        if head is not None:
            edges_n, edge_faces_n, true_max_n = head[0], head[1], head[2]
            max_deg_n = true_max_n if true_max_n > 0 else 1
            if degree_cap is not None and max_deg_n > degree_cap:
                max_deg_n = degree_cap
            if pad_degree is not None:
                if pad_degree < max_deg_n:
                    raise ValueError(
                        f"pad_degree {pad_degree} < degree {max_deg_n}"
                    )
                max_deg_n = pad_degree
            from .native import topology_fill_native

            fill = topology_fill_native(edges_n, n_points, max_deg_n)
            if fill is not None:
                neighbors_n, mask_n, overflow_n, labels_n, n_comp_n = fill
                return MeshTopology(
                    edges=edges_n,
                    neighbors=neighbors_n,
                    nbr_mask=mask_n,
                    max_degree=max_deg_n,
                    edge_faces=edge_faces_n,
                    component_labels=labels_n,
                    n_components=n_comp_n if n_points else 0,
                    overflow_edges=overflow_n,
                )

    if tris.size == 0:
        edges = np.zeros((0, 2), dtype=np.int32)
        edge_faces = np.zeros((0, 2), dtype=np.int32)
    else:
        raw = np.concatenate(
            [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], axis=0
        )
        raw.sort(axis=1)
        # Scalar-key unique: identical (lexicographic) ordering to
        # np.unique(raw, axis=0) for sorted pairs, but ~6x faster at
        # 240k-vertex meshes (axis-0 unique void-views + sorts rows).
        key = raw[:, 0] * np.int64(n_points) + raw[:, 1]
        ukey, inverse = np.unique(key, return_inverse=True)
        edges64 = np.stack([ukey // n_points, ukey % n_points], axis=1)
        edges = edges64.astype(np.int32)
        # Edge -> incident faces map (each raw row f*3 block belongs to face f).
        face_of_raw = np.tile(np.arange(tris.shape[0], dtype=np.int32), 3)
        edge_faces = np.full((edges.shape[0], 2), -1, dtype=np.int32)
        order = np.argsort(inverse, kind="stable")
        eid_sorted = inverse[order]
        face_sorted = face_of_raw[order]
        first = np.concatenate([[True], eid_sorted[1:] != eid_sorted[:-1]])
        slot = np.arange(eid_sorted.shape[0]) - np.maximum.accumulate(
            np.where(first, np.arange(eid_sorted.shape[0]), 0)
        )
        keep = slot < 2  # non-manifold extra incidences are dropped
        edge_faces[eid_sorted[keep], slot[keep]] = face_sorted[keep]

    # Degree per vertex over the symmetric edge set.
    directed = np.concatenate([edges, edges[:, ::-1]], axis=0)
    counts = np.bincount(directed[:, 0], minlength=n_points)
    true_max = int(counts.max()) if counts.size and counts.max() > 0 else 1
    max_deg = true_max
    if degree_cap is not None and true_max > degree_cap:
        max_deg = degree_cap
    if pad_degree is not None:
        if pad_degree < max_deg:
            raise ValueError(f"pad_degree {pad_degree} < degree {max_deg}")
        max_deg = pad_degree

    # ELL fill: stable sort directed edges by source, place into slots.
    # Slots beyond the degree cap spill into the overflow edge list.
    order = np.argsort(directed[:, 0], kind="stable")
    src = directed[order, 0]
    dst = directed[order, 1]
    slot = np.arange(src.shape[0]) - np.concatenate(
        [[0], np.cumsum(counts)[:-1]]
    )[src]
    in_ell = slot < max_deg
    neighbors = np.tile(np.arange(n_points, dtype=np.int32)[:, None], (1, max_deg))
    mask = np.zeros((n_points, max_deg), dtype=np.float32)
    neighbors[src[in_ell], slot[in_ell]] = dst[in_ell]
    mask[src[in_ell], slot[in_ell]] = 1.0
    overflow = np.stack(
        [src[~in_ell], dst[~in_ell]], axis=1
    ).astype(np.int32) if (~in_ell).any() else np.zeros((0, 2), np.int32)

    # Connected components (union-find).  Disconnected meshes (the bundled
    # source_mesh_15k has two isolated vertices) add extra Laplacian null
    # modes; the eigensolver deflates one null vector per component, the
    # static analogue of the reference's grow-k-and-retry (graph.py:357-389).
    # Vectorized label propagation (pointer jumping): each vertex adopts the
    # min label among itself and its neighbors until fixpoint — O(E log N)
    # array passes, no Python-level per-edge loop.
    labels64 = np.arange(n_points, dtype=np.int64)
    if edges.shape[0]:
        ea, eb = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
        while True:
            nxt = labels64.copy()
            np.minimum.at(nxt, ea, labels64[eb])
            np.minimum.at(nxt, eb, labels64[ea])
            # pointer jumping: compress chains label -> label-of-label
            nxt = nxt[nxt]
            if np.array_equal(nxt, labels64):
                break
            labels64 = nxt
    _, labels = np.unique(labels64, return_inverse=True)
    return MeshTopology(
        edges=edges,
        neighbors=neighbors,
        nbr_mask=mask,
        max_degree=max_deg,
        edge_faces=edge_faces,
        component_labels=labels.astype(np.int32),
        n_components=int(labels.max()) + 1 if n_points else 0,
        overflow_edges=overflow,
    )


def _as_trimesh_vtk_bulk(obj):
    """Bulk vtkPolyData -> TriMesh via vtk.util.numpy_support when the real
    vtk module is importable (it is whenever the caller holds a live
    vtkPolyData): one array copy instead of O(N) Python-level GetPoint /
    GetComponent calls.  Returns None to fall back to the duck-typed loops
    (fake objects in tests, exotic vtk builds, polygonal cells needing the
    fan path)."""
    try:
        from vtk.util.numpy_support import vtk_to_numpy  # type: ignore

        n = int(obj.GetNumberOfPoints())
        points = np.asarray(
            vtk_to_numpy(obj.GetPoints().GetData()), np.float32
        ).reshape(n, 3)
        cells = vtk_to_numpy(obj.GetPolys().GetData()).astype(np.int64)
        # Legacy connectivity layout: [k, v0..vk-1, k, ...].  Uniform
        # triangles reshape directly; anything else falls back to the
        # generic fan-triangulating loop.
        if cells.size and cells.size % 4 == 0:
            quads = cells.reshape(-1, 4)
            if not np.all(quads[:, 0] == 3):
                return None
            triangles = quads[:, 1:].astype(np.int32)
        elif cells.size == 0:
            triangles = np.zeros((0, 3), np.int32)
        else:
            return None
        point_data = {}
        pdo = obj.GetPointData()
        for a in range(int(pdo.GetNumberOfArrays())):
            arr = pdo.GetArray(a)
            if arr is None:
                continue
            name = pdo.GetArrayName(a) or f"array_{a}"
            vals = np.asarray(vtk_to_numpy(arr), np.float32)
            point_data[name] = vals
        return TriMesh(points=points, triangles=triangles, point_data=point_data)
    except Exception:
        return None


def as_trimesh(obj) -> TriMesh:
    """Coerce a mesh-like object to :class:`TriMesh`.

    Accepted inputs:
      * ``TriMesh`` — returned unchanged;
      * a live ``vtkPolyData`` (duck-typed on the VTK C++ API, so no vtk
        import is required here): reference users hold these from their own
        VTK pipelines (``vtk_functions.py:5-9``) and pass them straight to
        ``Focusr``/``Graph`` (``focusr.py:23``, ``graph.py:19``) — migration
        must not require hand-converting them.  Polygons with more than 3
        vertices are fan-triangulated; named point-data arrays are carried
        over (consumed by ``list_features_to_get_from_mesh``,
        reference ``graph.py:88-104``).
    """
    if isinstance(obj, TriMesh):
        return obj
    if hasattr(obj, "GetNumberOfPoints") and hasattr(obj, "GetNumberOfCells"):
        converted = _as_trimesh_vtk_bulk(obj)
        if converted is not None:
            return converted
        n = int(obj.GetNumberOfPoints())
        points = np.empty((n, 3), np.float32)
        for i in range(n):
            points[i] = obj.GetPoint(i)
        tris = []
        for c in range(int(obj.GetNumberOfCells())):
            ids = obj.GetCell(c).GetPointIds()
            k = int(ids.GetNumberOfIds())
            for t in range(1, k - 1):  # fan-triangulation; k==3 -> one tri
                tris.append((ids.GetId(0), ids.GetId(t), ids.GetId(t + 1)))
        triangles = (
            np.asarray(tris, np.int32) if tris else np.zeros((0, 3), np.int32)
        )
        point_data = {}
        pdo = obj.GetPointData() if hasattr(obj, "GetPointData") else None
        if pdo is not None:
            for a in range(int(pdo.GetNumberOfArrays())):
                arr = pdo.GetArray(a)
                if arr is None:
                    continue
                name = pdo.GetArrayName(a) or f"array_{a}"
                nt = int(arr.GetNumberOfTuples())
                nc = int(arr.GetNumberOfComponents())
                vals = np.empty((nt, nc), np.float32)
                for t in range(nt):
                    for cidx in range(nc):
                        vals[t, cidx] = arr.GetComponent(t, cidx)
                point_data[name] = vals[:, 0] if nc == 1 else vals
        return TriMesh(points=points, triangles=triangles, point_data=point_data)
    raise TypeError(
        f"cannot interpret {type(obj).__name__!r} as a mesh: expected a "
        "TriMesh or a vtkPolyData-like object"
    )


def load_mesh(path: str, dtype=jnp.float32) -> TriMesh:
    """Load a mesh file into a :class:`TriMesh` (replaces
    ``vtk_functions.read_vtk_mesh``, reference ``vtk_functions.py:5-9``).
    Format by extension: legacy ``.vtk`` PolyData plus — beyond the
    reference — XML ``.vtp`` (``io.vtp_io``) and ``.ply`` / ``.obj`` /
    ``.stl`` (``io.mesh_formats``).

    Arrays are HOST-resident (numpy): all connectivity/preprocessing
    consumers are host-side, and an eager device placement here would cost
    a round-trip per mesh for nothing — ``mesh_to_graph_arrays`` makes the single device transfer when compute
    actually starts (jnp consumers accept numpy transparently)."""
    points, triangles, point_data = read_any(path)
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    return TriMesh(
        points=np.asarray(points, dtype=np_dtype),
        triangles=np.asarray(triangles, dtype=np.int32),
        point_data={k: np.asarray(v, dtype=np_dtype) for k, v in point_data.items()},
    )


def save_mesh(path: str, mesh: TriMesh) -> None:
    """Write ``mesh`` in the format implied by ``path``'s extension
    (.vtk / .vtp / .ply / .obj / .stl)."""
    write_any(
        path,
        np.asarray(mesh.points, dtype=np.float64),
        np.asarray(mesh.triangles),
        {k: np.asarray(v, dtype=np.float64) for k, v in mesh.point_data.items()},
    )
