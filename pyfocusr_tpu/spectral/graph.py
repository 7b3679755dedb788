"""Graph / spectral layer: feature-weighted mesh Laplacian and its spectrum.

JAX re-design of the reference ``Graph`` class (``graph.py:18-354``):
the adjacency matrix never exists — the graph lives as a padded ELL neighbor
table (see mesh.build_topology) with weights computed on device, the Laplacian
is matrix-free, the eigensolve is deflated shift-invert Lanczos (ops/eigen.py)
and smoothing is a `lax.scan` (ops/graph_ops.mean_filter).

Constructor keywords mirror the reference 1:1 (``graph.py:19-34``) — they are
the public API contract — plus ``seed`` to make the random subsampling
reproducible (the reference's ``np.random.choice`` at ``graph.py:290`` is
unseeded; SURVEY flags that as nondeterminism to fix, not preserve).

Fixed reference defects (documented in SURVEY §5.3, deliberately not
reproduced):
  * ``feature_weights=None`` crashed (read of ``self.n_extra_features`` before
    definition, ``graph.py:41-42``); here it defaults to the identity.
  * a missing named point-data array printed and then crashed on
    ``GetArray(nan)`` (``graph.py:94-96``); here it warns and skips.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh import TriMesh, MeshTopology, as_trimesh, build_topology
from ..ops import graph_ops
from ..ops.curvature import principal_curvatures
from ..ops.eigen import smallest_nonzero_eigpairs

__all__ = ["Graph", "features_dictionary", "MIN_EIG_VAL"]

MIN_EIG_VAL = 1e-10  # reference ``graph.py:369``


def _curvature_feature(graph: "Graph"):
    kmin, kmax = principal_curvatures(
        graph.points, graph.mesh.triangles, graph._edges_j, graph._edge_faces_j
    )
    return [kmin, kmax]


def _min_curvature_feature(graph: "Graph"):
    return [_curvature_feature(graph)[0]]


def _max_curvature_feature(graph: "Graph"):
    return [_curvature_feature(graph)[1]]


# Mirrors reference ``features_dictionary`` (``graph.py:11-15``): 'curvature'
# yields both principal curvatures; the others one each.
features_dictionary = {
    "curvature": _curvature_feature,
    "min_curvature": _min_curvature_feature,
    "max_curvature": _max_curvature_feature,
}


class Graph:
    def __init__(
        self,
        mesh: TriMesh = None,
        n_spectral_features: int = 3,
        norm_eig_vecs: bool = True,
        n_rand_samples: int = 10000,
        list_features_to_calc=(),
        list_features_to_get_from_mesh=(),
        feature_weights=None,
        include_features_in_adj_matrix: bool = False,
        include_features_in_G_matrix: bool = False,
        G_matrix_p_function: str = "exp",
        norm_node_features_std: bool = True,
        norm_node_features_cap_std: float = 3,
        norm_node_features_0_1: bool = True,
        seed: int = 0,
        eig_method: str = "chebyshev",
        eig_cg_iters: int = 300,
        eig_lanczos_iters: int = 0,
        topology: MeshTopology | None = None,
        vtk_mesh=None,
    ):
        # The reference names this parameter ``vtk_mesh`` (``graph.py:19``);
        # accept it as a keyword alias so keyword-style callers migrate
        # unchanged.  Live vtkPolyData objects are coerced to TriMesh.
        if mesh is None:
            mesh = vtk_mesh
        if mesh is None:
            raise TypeError("Graph requires a mesh (positional or vtk_mesh=)")
        mesh = as_trimesh(mesh)
        self.eig_method = eig_method
        self.mesh = mesh
        self.n_spectral_features = n_spectral_features
        self.norm_eig_vecs = norm_eig_vecs
        self.include_features_in_adj_matrix = include_features_in_adj_matrix
        self.include_features_in_G_matrix = include_features_in_G_matrix
        self.G_matrix_p_function = G_matrix_p_function
        self.norm_node_features_std = norm_node_features_std
        self.norm_node_features_cap_std = norm_node_features_cap_std
        self.norm_node_features_0_1 = norm_node_features_0_1
        self.seed = seed
        self.eig_cg_iters = eig_cg_iters
        self.eig_lanczos_iters = eig_lanczos_iters

        # --- Mesh / point characteristics (reference ``graph.py:57-67``) ---
        self.n_points = mesh.n_points
        self.points = jnp.asarray(mesh.points, jnp.float32)
        pts_np = np.asarray(self.points)
        self.pts_scale_range = np.ptp(pts_np, axis=0)
        self.max_pts_scale_range = float(np.max(self.pts_scale_range))
        self.mean_pts_scale_range = float(np.mean(self.pts_scale_range))
        self.normed_points = (
            self.points - jnp.min(self.points, axis=0)
        ) / self.mean_pts_scale_range

        # --- Static topology (host-side, one pass) ---
        self.topology = topology if topology is not None else build_topology(
            np.asarray(mesh.triangles), self.n_points
        )
        self._neighbors = jnp.asarray(self.topology.neighbors)
        self._nbr_mask = jnp.asarray(self.topology.nbr_mask)
        self._edges_j = jnp.asarray(self.topology.edges)
        self._edge_faces_j = jnp.asarray(self.topology.edge_faces)
        self._overflow = jnp.asarray(self.topology.overflow_edges)
        self._ov_w = None  # computed with the adjacency weights

        # --- Spectrum slots (reference ``graph.py:78-82``) ---
        self.eig_vals = None
        self.eig_vecs = None
        self.eig_val_gap = None
        self._rng = np.random.default_rng(seed)
        self.rand_idxs = self.get_list_rand_idxs(n_rand_samples)

        # --- Node features (reference ``graph.py:84-119``) ---
        self.node_features = []
        for feature in list_features_to_calc:
            self.node_features += list(features_dictionary[feature](self))
        for feature in list_features_to_get_from_mesh:
            if feature in mesh.point_data:
                self.node_features.append(
                    jnp.asarray(mesh.point_data[feature], jnp.float32)
                )
            else:
                # Reference prints "NO SCALARS WITH SPECIFIED NAME" then
                # crashes (``graph.py:94-96``); we warn and skip.
                warnings.warn(f"NO SCALARS WITH SPECIFIED NAME: {feature!r}")
        self.norm_node_features(
            norm_using_std=self.norm_node_features_std,
            norm_range_0_to_1=self.norm_node_features_0_1,
            cap_std=self.norm_node_features_cap_std,
        )
        self.n_extra_features = len(self.node_features)
        if feature_weights is None:
            self.feature_weights = np.eye(max(self.n_extra_features, 1))
        else:
            self.feature_weights = np.asarray(feature_weights)
        self.mean_xyz_range_scaled_features = [
            f * self.mean_pts_scale_range for f in self.node_features
        ]

        # Lazy adjacency state.
        self._adjacency_weights = None
        self._degrees = None
        self._g = None

    # ------------------------------------------------------------------
    # Feature normalization (reference ``graph.py:121-142``)
    # ------------------------------------------------------------------
    def norm_node_features(self, norm_using_std=True, norm_range_0_to_1=True, cap_std=3):
        out = []
        for f in self.node_features:
            f = jnp.asarray(f, jnp.float32)
            # A CONSTANT feature (e.g. curvature on a plane) has std 0 and
            # ptp 0; dividing would make the whole column NaN and silently
            # poison the registration — normalize it to a constant instead.
            if norm_using_std is True:
                std = jnp.std(f)
                f = (f - jnp.mean(f)) / jnp.where(std > 0, std, 1.0)
                if cap_std is not False:
                    f = jnp.clip(f, -cap_std, cap_std)
            if norm_range_0_to_1 is True:
                ptp = jnp.max(f) - jnp.min(f)
                f = (f - jnp.min(f)) / jnp.where(ptp > 0, ptp, 1.0)
            out.append(f)
        self.node_features = out

    # ------------------------------------------------------------------
    # Adjacency / degree / G / Laplacian (reference ``graph.py:148-226``)
    # ------------------------------------------------------------------
    def _adjacency_coords(self) -> jnp.ndarray:
        """xyz, optionally augmented with mean-range-scaled features
        (reference ``graph.py:166-175``)."""
        if self.n_extra_features > 0 and self.include_features_in_adj_matrix:
            cols = [self.points] + [
                f[:, None] for f in self.mean_xyz_range_scaled_features
            ]
            return jnp.concatenate(cols, axis=1)
        return self.points

    def get_weighted_adjacency_matrix(self):
        """Compute ELL edge weights w = 1/dist (reference ``graph.py:148-178``)."""
        coords = self._adjacency_coords()
        self._adjacency_weights = graph_ops.edge_weights(
            coords, self._neighbors, self._nbr_mask
        )
        self._ov_w = graph_ops.overflow_weights(coords, self._overflow)
        # Degrees and G derive from the weights — invalidate their caches so
        # a recompute (e.g. after mutating points) cannot pair new W with
        # stale D/G in laplacian_matvec.
        self._degrees = None
        self._g = None
        return self._adjacency_weights

    @property
    def adjacency_weights(self) -> jnp.ndarray:
        if self._adjacency_weights is None:
            self.get_weighted_adjacency_matrix()
        return self._adjacency_weights

    def get_degree_matrix(self):
        self._degrees = graph_ops.degree_vector(
            self.adjacency_weights, self._overflow, self._ov_w
        )
        return self._degrees

    @property
    def degrees(self) -> jnp.ndarray:
        if self._degrees is None:
            self.get_degree_matrix()
        return self._degrees

    def get_G_matrix(self, p_function: str = "exp"):
        feats = (
            jnp.stack(self.node_features)
            if self.n_extra_features > 0
            else None
        )
        self._g = graph_ops.g_vector(
            feats,
            self.degrees,
            jnp.asarray(self.feature_weights, jnp.float32),
            p_function=p_function,
            include_features=self.include_features_in_G_matrix,
        )
        return self._g

    @property
    def g(self) -> jnp.ndarray:
        if self._g is None:
            self.get_G_matrix(p_function=self.G_matrix_p_function)
        return self._g

    def laplacian_matvec(self, x):
        """Matrix-free L = G (D - W) (reference ``graph.py:221-226``)."""
        return graph_ops.laplacian_matvec(
            self._neighbors, self.adjacency_weights, self.g, x,
            self._overflow, self._ov_w, degrees=self.degrees,
        )

    def get_laplacian_matrix(self):
        """L = G (D - W) as scipy CSR, stored on ``self.laplacian_matrix``
        (reference ``graph.py:221-226``).  Host-side materialization for API
        parity and inspection only — the compute path is the matrix-free
        :meth:`laplacian_matvec`."""
        import scipy.sparse as sp

        W = self.to_scipy_sparse()
        d = np.asarray(self.degrees, np.float64)
        g = np.asarray(self.g, np.float64)
        self.laplacian_matrix = sp.diags(g) @ (sp.diags(d) - W)
        return self.laplacian_matrix

    def to_scipy_sparse(self):
        """Materialize W as scipy CSR (testing/debug only; never on the hot path)."""
        import scipy.sparse as sp

        nbrs = np.asarray(self._neighbors)
        w = np.asarray(self.adjacency_weights)
        mask = np.asarray(self._nbr_mask) > 0
        rows = np.repeat(np.arange(self.n_points), self.topology.max_degree).reshape(
            self.n_points, -1
        )
        data, ri, ci = w[mask], rows[mask], nbrs[mask]
        if self._overflow.shape[0]:
            ov = np.asarray(self._overflow)
            ovw = np.asarray(self._ov_w)
            real = ov[:, 0] != ov[:, 1]
            data = np.concatenate([data, ovw[real]])
            ri = np.concatenate([ri, ov[real, 0]])
            ci = np.concatenate([ci, ov[real, 1]])
        return sp.coo_matrix(
            (data, (ri, ci)), shape=(self.n_points,) * 2
        ).tocsr()

    # ------------------------------------------------------------------
    # Spectrum (reference ``graph.py:228-257`` + ``recursive_eig`` 357-389)
    # ------------------------------------------------------------------
    def get_graph_spectrum(self):
        self.get_weighted_adjacency_matrix()
        self.get_degree_matrix()
        self.get_G_matrix(p_function=self.G_matrix_p_function)

        neighbors, weights, g = self._neighbors, self.adjacency_weights, self.g
        g = jnp.maximum(g, 1e-30)
        s = jnp.sqrt(g)
        # Kernel basis: one indicator column per connected component
        # (disconnected meshes have that many zero modes; static analogue of
        # the reference's grow-k retry, which we keep as a fallback below).
        n_comp = max(self.topology.n_components, 1)
        ind = np.zeros((self.n_points, n_comp), np.float32)
        ind[np.arange(self.n_points), self.topology.component_labels] = 1.0
        null_vec = jnp.asarray(ind) * (1.0 / s)[:, None]

        ov, ov_w = self._overflow, self._ov_w
        d = self.degrees  # cached by get_degree_matrix above

        def matvec(x):
            return graph_ops.sym_laplacian_matvec(
                neighbors, weights, g, x, ov, ov_w, degrees=d
            )

        ws = graph_ops.spmv(neighbors, weights, s, ov, ov_w)
        lam_bound = jnp.max(s * (s * d + ws))

        # Retry-with-larger-k contract of ``recursive_eig``
        # (``graph.py:357-389``): keep eigenvalues > 1e-10; if fewer than
        # needed survive (extra null modes: disconnected components), grow k.
        n_needed = self.n_spectral_features
        k_req = n_needed
        key = jax.random.PRNGKey(self.seed)
        for _attempt in range(4):
            if self.eig_method == "chebyshev":
                from ..ops.eigen import chebyshev_eigpairs

                lams, vecs_a, _resid = chebyshev_eigpairs(
                    matvec, null_vec, key, k_req, lam_max_bound=lam_bound,
                    quad_form=lambda V: graph_ops.sym_laplacian_quad_form(
                        neighbors, weights, s, V, ov, ov_w
                    ),
                )
                vecs = vecs_a * s[:, None]
                vecs = vecs / jnp.linalg.norm(vecs, axis=0, keepdims=True)
            else:
                lams, vecs, _resid = smallest_nonzero_eigpairs(
                    matvec,
                    s,
                    null_vec,
                    k=k_req,
                    key=key,
                    cg_iters=self.eig_cg_iters,
                    lanczos_iters=self.eig_lanczos_iters,
                )
            good = np.where(np.asarray(lams) > MIN_EIG_VAL)[0]
            if len(good) >= n_needed:
                break
            k_req += 1 + n_needed  # k_buffer + n_k_needed, graph.py:378
        else:
            # Exhausted retry budget: raising here beats returning fewer
            # columns than requested, which would crash (or silently
            # lower-dimension the registration) far downstream when source
            # and target spectra disagree in width.
            raise RuntimeError(
                f"eigensolver found only {len(good)} eigenvalues > "
                f"{MIN_EIG_VAL} after 4 attempts (k grown to {k_req}); "
                f"needed {n_needed}. The mesh may have many near-zero "
                "modes (heavily disconnected?) or the spectrum failed to "
                "converge."
            )
        good = good[:n_needed]
        self.eig_vals = jnp.asarray(np.asarray(lams)[good])
        self.eig_vecs = vecs[:, jnp.asarray(good)]

        if self.norm_eig_vecs is True:
            # Column-wise min-max to [-0.5, 0.5] (reference ``graph.py:254-257``).
            mn = jnp.min(self.eig_vecs, axis=0)
            ptp = jnp.max(self.eig_vecs, axis=0) - mn
            self.eig_vecs = (self.eig_vecs - mn) / ptp - 0.5
        return self.eig_vals, self.eig_vecs

    # ------------------------------------------------------------------
    # Samplers (reference ``graph.py:263-290``)
    # ------------------------------------------------------------------
    def get_eig_val_gap(self):
        self.eig_val_gap = float(jnp.mean(jnp.diff(self.eig_vals)))
        return self.eig_val_gap

    def get_rand_eig_vecs(self):
        return self.eig_vecs[self.rand_idxs, :]

    def get_rand_normalized_points(self):
        pts = self.points[self.rand_idxs, :]
        mn = jnp.min(pts, axis=0)
        return (pts - mn) / (jnp.max(pts, axis=0) - mn)

    def get_list_rand_idxs(self, n_rand_samples, replace=False, force_randomization=False):
        if n_rand_samples > self.n_points:
            idxs = np.arange(self.n_points)
            if force_randomization is True:
                self._rng.shuffle(idxs)  # reference's np.shuffle typo fixed
            return idxs
        return self._rng.choice(self.n_points, size=n_rand_samples, replace=replace)

    # ------------------------------------------------------------------
    # Graph filtering (reference ``graph.py:320-354``)
    # ------------------------------------------------------------------
    def mean_filter_graph(self, values, iterations: int = 300):
        return graph_ops.mean_filter(
            self._neighbors,
            self.adjacency_weights,
            jnp.asarray(values, jnp.float32),
            iterations,
            self._overflow,
            self._ov_w,
        )

    # ------------------------------------------------------------------
    # Viewers (reference ``graph.py:296-314``) — optional dependency.
    # ------------------------------------------------------------------
    def view_mesh_existing_scalars(self):
        from ..utils.viz import view_mesh

        return view_mesh(self.mesh)

    def view_mesh_eig_vec(self, eig_vec: int = 0):
        from ..utils.viz import view_mesh

        return view_mesh(self.mesh.with_point_data("eig_vec", self.eig_vecs[:, eig_vec]))

    def view_mesh_features(self, feature_idx: int = 0):
        from ..utils.viz import view_mesh

        return view_mesh(
            self.mesh.with_point_data("feature", self.node_features[feature_idx])
        )

    def export_viewer_html(self, file_path, eig_vec=None, feature_idx=None):
        """Standalone HTML/WebGL export of the graph's mesh — the
        dependency-free analogue of the three ``view_mesh_*`` viewers
        (reference ``graph.py:296-314``): existing point-data scalars by
        default, plus an ``eig_vec`` column and/or a node ``feature`` as
        additional selectable colorings.  Returns the path written."""
        from ..utils.html_viewer import export_html

        mesh = self.mesh
        if eig_vec is not None:
            mesh = mesh.with_point_data(
                f"eig_vec_{eig_vec}", self.eig_vecs[:, eig_vec]
            )
        if feature_idx is not None:
            mesh = mesh.with_point_data(
                f"feature_{feature_idx}", self.node_features[feature_idx]
            )
        return export_html(file_path, meshes=[mesh], mesh_names=["mesh"],
                           title="Graph mesh")
