"""Single-program FOCUSR pipeline: the whole registration as ONE jitted
function, end to end on device.

This is the accelerator counterpart of ``Focusr.align_maps`` (reference
``focusr.py:514-570``): where the reference hops between Python, VTK, ARPACK,
scipy and Cython per stage, here the full chain

    Laplacian -> spectra (x2) -> eigsort -> spectral coords -> CPD
    -> correspondences -> smoothing -> final locations

is traced once and compiled into a single XLA program with zero host
round-trips.  The ``Focusr`` class remains the flexible stage-by-stage API;
``register_pair`` is the production fast path used by bench.py, the cohort
sharding (parallel/cohort.py), and ``__graft_entry__``.

Padded batching: ``GraphArrays`` carries a per-vertex ``valid_mask`` so
meshes of different sizes can be padded to a common static shape and mapped /
shard_mapped over a device mesh (SURVEY §2 cohort data-parallelism).  Padding is inert by construction: the eigensolver's
Krylov iteration is confined to the masked coordinate subspace, padded points
sit at a 1e30 sentinel so no KNN query selects them, the ICP fit weights them
out, and all subsampling draws only real vertices.

Restriction vs the class API: 'hungarian' correspondences (solved on-device
by the exact Sinkhorn-warmed JV, ops/assignment.sinkhorn_jv_lap) require
equal unpadded vertex counts — the reference's own guard
(``focusr.py:377-385``).  Everything else the reference's ``align_maps``
covers — feature/xyz coordinate appending, weighted spectral coords,
unequal eigsort sample counts — runs inside the single program.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .mesh import TriMesh, build_topology
from .ops import cpd as cpd_ops
from .ops import graph_ops
from .ops.eigen import (
    chebyshev_eigpairs,
    chebyshev_eigpairs_wide,
    smallest_nonzero_eigpairs,
)
# SENTINEL: single source of truth for the masked-row sentinel coordinate
# (idw_pull_k3 and the query masking must agree on the value).
from .ops.knn import SENTINEL, idw_from_knn, knn3_masked, nn_query
from .spectral.eigsort_jax import sort_eigenmaps_jit
from .utils.precision import f32_matmuls

__all__ = [
    "PipelineConfig",
    "GraphArrays",
    "mesh_to_graph_arrays",
    "register_pair",
    "landmark_pairs_from_positions",
    "prepare_target",
    "register_pair_prepared",
    "prepare_source",
    "register_pair_prepared_source",
    "source_spectrum_hoistable",
]

_PREC = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True, eq=True)
class PipelineConfig:
    """Static registration configuration (hashable: used as a jit static arg).
    Field names mirror the reference's ``Focusr.__init__`` kwargs (SURVEY §5.6).

    DEFAULTS DEVIATION (deliberate, gated by tests/test_api_parity.py):
    six fields default to the reference EXAMPLE NOTEBOOK's tuned values
    rather than ``Focusr.__init__``'s raw defaults — the notebook config is
    the reference's de-facto ``main()`` and registers the bundled meshes
    well, while the raw defaults (alpha=0.5, beta=3, 1000 CPD iterations,
    weighted spectral coords, affine pre-pass, 5000-point CPD subsample) are
    untuned for them.  ``Focusr`` keeps the reference's raw defaults for
    drop-in parity and always passes its resolved values here explicitly.
    Deviating fields: n_coords_spectral_registration (1000 vs 5000),
    get_weighted_spectral_coords (False vs True), rigid_before_non_rigid_reg
    (False vs True), non_rigid_max_iterations (300 vs 1000), non_rigid_alpha
    (0.01 vs 0.5), non_rigid_beta (50 vs 3)."""

    icp_register_first: bool = True
    icp_registration_mode: str = "rigid"
    icp_iterations: int = 100
    icp_n_landmarks: int = 2000
    # 'kd' (brute-force NN, reference default) or 'hungarian' (one-to-one
    # assignment via the exact on-device Sinkhorn-warmed JV solver,
    # ops/assignment.sinkhorn_jv_lap — the reference notebook's 5k config).
    # 'hungarian' requires equal, unpadded vertex counts (reference guard
    # focusr.py:377-385).
    initial_correspondence_type: str = "kd"
    final_correspondence_type: str = "kd"
    # Extra-feature / xyz coordinate appending (reference ``focusr.py:218-295``).
    # use_features_as_coords appends each graph's (pre-normalized)
    # ``node_features`` — graph-smoothed, min-max normalized, rescaled by the
    # spectral-coordinate ptp — as extra registration dimensions;
    # include_points_as_features appends xyz (normalized, or raw with the
    # spectral coords upscaled, per norm_physical_and_spectral).
    use_features_as_coords: bool = False
    feature_smoothing_iterations: int = 40
    include_points_as_features: bool = False
    norm_physical_and_spectral: bool = True
    # Feature-weighted GRAPH construction (reference ``graph.py:166-214``):
    # include_features_in_adj_matrix appends mean-range-scaled features to
    # the edge-weight distance (w = 1/||(xyz, f)_i - (xyz, f)_j||);
    # use_features_in_graph builds the feature G matrix (per-feature
    # transform G_matrix_p_function in {exp, log, square, shift}, scaled
    # into the degree range, weighted by feature_weights_diag, averaged,
    # times D^-1) so L = G (D - W) is feature-modulated.
    use_features_in_graph: bool = False
    include_features_in_adj_matrix: bool = False
    G_matrix_p_function: str = "exp"
    # Diagonal of the reference's feature_weights matrix (``graph.py:41-42``;
    # only the diagonal is ever read, ``graph.py:206``).  A tuple so the
    # config stays hashable; () = identity weights.
    feature_weights_diag: tuple = ()
    # ICP direction (reference ``focusr.py:110-131``): False (default) moves
    # the SOURCE onto the target; True moves the TARGET onto the source.
    icp_reg_target_to_source: bool = False
    # eigsort reference side (reference ``eigsort.py:75-78,100-122``): True
    # (default) permutes/flips the SOURCE eigenmaps into the target's order;
    # False runs the assignment on Q.T and permutes/flips the TARGET's.
    target_eigenmap_as_reference: bool = True
    # Pseudo-responsibility strength of ``landmark_pairs`` priors passed to
    # register_pair (MAP CPD with known correspondences; ops/cpd.py).
    landmark_weight: float = 100.0
    n_spectral_features: int = 3
    n_extra_spectral: int = 3
    n_coords_spectral_ordering: int = 5000
    n_coords_spectral_registration: int = 1000
    get_weighted_spectral_coords: bool = False
    rigid_before_non_rigid_reg: bool = False
    rigid_reg_max_iterations: int = 100
    rigid_tolerance: float = 1e-8
    non_rigid_max_iterations: int = 300
    non_rigid_tolerance: float = 1e-8
    non_rigid_alpha: float = 0.01
    non_rigid_beta: float = 50.0
    non_rigid_n_eigens: int = 100
    # CPD outlier/noise weight w in [0, 1) (Myronenko & Song eq. 6 uniform
    # component).  The reference pins cycpd's default w=0; exposing it enables
    # partial-overlap / outlier-robust registration without any other change.
    non_rigid_outlier_w: float = 0.0
    smooth_correspondences: bool = True
    graph_smoothing_iterations: int = 300
    projection_smooth_iterations: int = 40
    # NOTE: two alternative eigensolve schedules (disjoint-union and
    # vmap-batched pair spectra) were built, verified exact, and benched
    # neutral-or-slower on the hardware the repo first targeted, so they
    # are not config options — see
    # ``pyfocusr_tpu/experiments.py`` for the code and the measurements.
    # 'chebyshev' applies the identical smoothing operator power A^q as a
    # Chebyshev polynomial (~sqrt(q) SpMVs instead of q; rel err ~2e-6 —
    # far below the pipeline's f32 noise).  'exact' runs the literal
    # q-step iteration (reference semantics, graph.py:320-354).
    smoothing_method: str = "chebyshev"
    # Beyond-reference quality signal: also compute the reverse (target ->
    # source) nearest neighbors and flag mutually-consistent correspondences
    # (cycle-consistent matches are the reliable ones; the mask is returned,
    # nothing is filtered).
    compute_mutual_consistency: bool = False
    # 'chebyshev': wide-block Chebyshev filter (chebyshev_eigpairs_wide) for
    # meshes >= 2048 vertices, narrow-block for smaller; 'chebyshev-narrow'
    # forces the round-1 narrow solver; 'lanczos' = shift-invert Lanczos.
    eig_method: str = "chebyshev"
    eig_cg_iters: int = 300
    eig_lanczos_iters: int = 0
    eig_cheb_degree: int = 75
    eig_cheb_sweeps: int = 6
    eig_cheb_refine_cg: int = 40
    # Wide-block solver schedule (see ops/eigen.chebyshev_eigpairs_wide):
    # measured ~2x faster than the narrow solver per 15k mesh at
    # equal-or-better accuracy.  Swept round 2: 5 chunks of degree 33 match
    # 6 chunks on every parity gate (5k eigval rel 1e-6, |cos| 1.0) at ~15%
    # less time; 4x40 and 5x25 also passed — 5x33 keeps the most SVQB
    # rank-resets per filter step for robustness on irregular meshes.
    # Re-swept round 3 END-TO-END: 4 or 3 chunks leave eigVALUES unchanged
    # (the 15k floor is operator-data-bound) but drop golden exact
    # agreement 72% -> 63-65% and pick distance 0.55 -> 0.7 mm (in-cluster
    # eigVECTOR rotation the eigvalue probes cannot see — the round-2
    # adaptive-stop lesson) for only ~30 ms of the 256 ms headline; not
    # worth it.
    eig_wide_block: int = 128
    eig_wide_degree: int = 33
    eig_wide_chunks: int = 5
    # Cross-mesh spectral WARM START: when a pair's spectra are computed in
    # one program (or one side arrives precomputed via prepare_target /
    # prepare_source), the second eigensolve is seeded with the first
    # mesh's final filtered 128-block mapped through a spatial NN, and runs
    # ``eig_wide_chunks_warm`` chunks instead of ``eig_wide_chunks`` —
    # near-isometric pairs share their low-frequency subspace, so the
    # second solve starts essentially converged.  Wide-chebyshev path only
    # (both meshes >= 2048 vertices).  Exact-reproduction note: with the
    # warm start on, prepare_source paths match the fused program to solver
    # tolerance, not bit-for-bit (the fused source solve is warm-started;
    # the prepared one ran cold) — set eig_warm_start=False to recover
    # bit-identical prepared-source serving.  prepare_target serving stays
    # bit-identical either way (the prepared block IS the fused block).
    eig_warm_start: bool = True
    eig_wide_chunks_warm: int = 2
    # Per-chunk filter degree for WARM solves.  Residual headroom exists
    # (measured on the synthetic 5k pair, cross-mesh seed: 2x33 ->
    # 2.4e-5, 2x25 -> 5.8e-5 — still 5x under the 3e-4 safeguard; 2x20
    # -> 3.7e-4 trips the top-up), but an end-to-end A/B found no gain
    # from 25, so the default stays at the full degree; the knob remains
    # for slower-varying deployments.  Not yet re-measured on a GPU.
    eig_wide_degree_warm: int = 33
    # Residual SAFEGUARD for the truncated warm schedule: after the
    # eig_wide_chunks_warm chunks, if the max wanted-mode residual exceeds
    # eig_warm_resid_tol * lam_max the solver runs up to (eig_wide_chunks -
    # eig_wide_chunks_warm) extra chunks inside a while_loop (traced once).
    # Calibration (synthetic 5k bone pair): a GOOD cross-mesh warm start
    # reaches 2.4e-5 * lam_max after 2 chunks, a USELESS seed (random x0,
    # or a cold truncated run) sits at 4.5e-3, and the full 5-chunk cold
    # solve at 3.7e-7 — 3e-4 separates good from bad by an order of
    # magnitude on each side.  Near-isometric pairs therefore pay only one
    # extra [N, k] matvec for the check; a dissimilar pair self-heals
    # toward the full schedule instead of silently returning
    # under-converged eigenvectors.
    eig_warm_resid_tol: float = 3e-4

    def __post_init__(self):
        # Validated at construction (SURVEY §5.6): fail fast on the knobs
        # whose invalid values would otherwise surface as cryptic trace errors.
        if self.n_spectral_features < 1:
            raise ValueError("n_spectral_features must be >= 1")
        if self.n_extra_spectral < 0:
            raise ValueError("n_extra_spectral must be >= 0")
        if self.icp_register_first:
            if self.icp_n_landmarks < 3:
                raise ValueError(
                    "icp_n_landmarks must be >= 3 (a rigid fit needs at "
                    "least 3 points; 0 would produce a silent NaN transform)"
                )
            if self.icp_iterations < 1:
                raise ValueError("icp_iterations must be >= 1")
        if self.projection_smooth_iterations < 0:
            raise ValueError("projection_smooth_iterations must be >= 0")
        if self.icp_registration_mode not in ("rigid", "similarity"):
            raise ValueError("Error invalid transform mode")
        if self.eig_method not in ("chebyshev", "chebyshev-narrow", "lanczos"):
            raise ValueError(
                "eig_method must be 'chebyshev', 'chebyshev-narrow' or 'lanczos'"
            )
        if self.smoothing_method not in ("chebyshev", "exact"):
            raise ValueError("smoothing_method must be 'chebyshev' or 'exact'")
        if self.G_matrix_p_function not in ("exp", "log", "square", "shift"):
            raise ValueError(
                "G_matrix_p_function must be 'exp', 'log', 'square' or 'shift'"
            )
        for name in ("initial_correspondence_type", "final_correspondence_type"):
            if getattr(self, name) not in ("kd", "hungarian"):
                raise ValueError(f"{name} must be 'kd' or 'hungarian'")
        if self.non_rigid_alpha <= 0 or self.non_rigid_beta <= 0:
            raise ValueError("non_rigid_alpha/beta must be positive")
        if not 0.0 <= self.non_rigid_outlier_w < 1.0:
            raise ValueError("non_rigid_outlier_w must be in [0, 1)")
        if self.landmark_weight <= 0:
            raise ValueError("landmark_weight must be positive")
        for name in (
            "n_coords_spectral_ordering",
            "n_coords_spectral_registration",
            "non_rigid_max_iterations",
            "graph_smoothing_iterations",
            "feature_smoothing_iterations",
            "eig_wide_block",
            "eig_wide_degree",
            "eig_wide_chunks",
            "eig_wide_chunks_warm",
            "eig_wide_degree_warm",
        ):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")

    @property
    def n_total(self) -> int:
        return self.n_spectral_features + self.n_extra_spectral


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class GraphArrays:
    """Device-resident graph of one (possibly padded) mesh."""

    points: jnp.ndarray  # f32 [N, 3]
    neighbors: jnp.ndarray  # i32 [N, D]
    nbr_mask: jnp.ndarray  # f32 [N, D]
    valid_mask: jnp.ndarray  # f32 [N]  1 = real vertex, 0 = padding
    null_indicators: jnp.ndarray  # f32 [N, C] per-component indicator columns
    overflow: jnp.ndarray = None  # i32 [E_o, 2] hub-vertex spill edges
    node_features: jnp.ndarray = None  # f32 [N, K] normalized extra features
    # Optional patch-dense filter plan (ops/patch_dense.py): index-only
    # structure derived from neighbors/nbr_mask/overflow, attached by
    # mesh_to_graph_arrays for unpadded meshes in the profitable size
    # range.  Purely a performance artifact: excluded from
    # _graph_fingerprint, stripped before vertex sharding
    # (parallel/bigmesh), and None on padded/cohort graphs.
    patch_plan: dict = None

    def __post_init__(self):
        # Default node_features to an empty [N, 0] array.  Guard for tree
        # contexts (shard_map spec trees, tree_map with None leaves) where
        # tree_unflatten reconstructs the class from non-array leaves.
        if self.node_features is None and hasattr(self.points, "shape"):
            object.__setattr__(
                self,
                "node_features",
                jnp.zeros((self.points.shape[0], 0), jnp.float32),
            )
        # Default overflow to the empty edge list: every consumer calls
        # overflow.shape, so a hand-built GraphArrays without hub spill
        # edges must not carry None.
        if self.overflow is None and hasattr(self.points, "shape"):
            object.__setattr__(
                self, "overflow", jnp.zeros((0, 2), jnp.int32)
            )

    def tree_flatten(self):
        return (
            self.points,
            self.neighbors,
            self.nbr_mask,
            self.valid_mask,
            self.null_indicators,
            self.overflow,
            self.node_features,
            self.patch_plan,
        ), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n_points(self) -> int:
        return self.points.shape[0]


def mesh_to_graph_arrays(
    mesh: TriMesh,
    pad_n_points: Optional[int] = None,
    pad_degree: Optional[int] = None,
    pad_components: Optional[int] = None,
    pad_overflow: Optional[int] = None,
    degree_cap: Optional[int] = 24,
    node_features=None,
    topology=None,
    patch_blocks: Optional[bool] = None,
) -> GraphArrays:
    """Build pipeline arrays from a mesh, optionally padded to a fixed size
    for batching.  ``null_indicators`` carries one indicator column per
    connected component (the Laplacian kernel basis the eigensolver deflates;
    disconnected meshes like the bundled source_mesh_15k need all of them).

    ``topology``: reuse an already-built :class:`MeshTopology` for this mesh
    (its ELL table is widened in place to ``pad_degree`` if needed) — callers
    like ``parallel.cohort.pad_cohort`` measure pad sizes from per-mesh
    topologies first and would otherwise pay the build twice (~0.3 s native /
    ~10 s numpy per 240k-vertex pass)."""
    n = mesh.n_points
    if topology is not None:
        topo = topology
        cur_d = topo.neighbors.shape[1]
        if pad_degree is not None and pad_degree > cur_d:
            import dataclasses as _dc

            own = np.tile(
                np.arange(n, dtype=topo.neighbors.dtype)[:, None],
                (1, pad_degree - cur_d),
            )
            topo = _dc.replace(
                topo,
                neighbors=np.concatenate([topo.neighbors, own], axis=1),
                nbr_mask=np.concatenate(
                    [
                        topo.nbr_mask,
                        np.zeros((n, pad_degree - cur_d), topo.nbr_mask.dtype),
                    ],
                    axis=1,
                ),
                max_degree=pad_degree,  # build_topology's pad_degree semantics
            )
        elif pad_degree is not None and pad_degree < cur_d:
            raise ValueError(
                f"pad_degree={pad_degree} narrower than the provided "
                f"topology's ELL width {cur_d}"
            )
    else:
        topo = build_topology(
            np.asarray(mesh.triangles), n, pad_degree, degree_cap=degree_cap
        )
    overflow = topo.overflow_edges
    if pad_overflow is not None and pad_overflow > overflow.shape[0]:
        pad = np.zeros((pad_overflow - overflow.shape[0], 2), np.int32)
        overflow = np.concatenate([overflow, pad])  # src==dst rows: weight 0
    points = np.asarray(mesh.points, np.float32)
    neighbors = topo.neighbors
    nbr_mask = topo.nbr_mask
    valid = np.ones((n,), np.float32)
    n_comp = max(topo.n_components, 1)
    indicators = np.zeros((n, n_comp), np.float32)
    indicators[np.arange(n), topo.component_labels] = 1.0
    if node_features is None:
        feats = np.zeros((n, 0), np.float32)
    else:
        feats = np.asarray(node_features, np.float32)
        if feats.ndim == 1:
            feats = feats[:, None]
        if feats.shape[0] != n:  # accept [K, N] layout too
            feats = feats.T
    if pad_n_points is not None and pad_n_points > n:
        extra = pad_n_points - n
        points = np.concatenate([points, np.zeros((extra, 3), np.float32)])
        feats = np.concatenate(
            [feats, np.zeros((extra, feats.shape[1]), np.float32)]
        )
        neighbors = np.concatenate(
            [
                neighbors,
                np.tile(
                    np.arange(n, pad_n_points, dtype=np.int32)[:, None],
                    (1, topo.max_degree),
                ),
            ]
        )
        nbr_mask = np.concatenate(
            [nbr_mask, np.zeros((extra, topo.max_degree), np.float32)]
        )
        valid = np.concatenate([valid, np.zeros((extra,), np.float32)])
        indicators = np.concatenate(
            [indicators, np.zeros((extra, n_comp), np.float32)]
        )
    if pad_components is not None and pad_components > indicators.shape[1]:
        indicators = np.concatenate(
            [
                indicators,
                np.zeros(
                    (indicators.shape[0], pad_components - indicators.shape[1]),
                    np.float32,
                ),
            ],
            axis=1,
        )
    # Patch-dense filter plan (ops/patch_dense.py): built for unpadded
    # meshes in the wide-solver size range — padded/cohort graphs skip it
    # (plan shapes are topology-dependent, so stacked cohorts would be
    # ragged; padded graphs keep the ELL path).
    plan = None
    padded = any(
        x is not None
        for x in (pad_n_points, pad_degree, pad_components, pad_overflow)
    )
    if patch_blocks is None:
        patch_blocks = not padded
    if patch_blocks:
        from .ops.patch_dense import build_patch_plan

        plan_np = build_patch_plan(neighbors, nbr_mask, overflow)
        if plan_np is not None:
            plan = {k_: jnp.asarray(v_) for k_, v_ in plan_np.items()}
    return GraphArrays(
        points=jnp.asarray(points),
        neighbors=jnp.asarray(neighbors),
        nbr_mask=jnp.asarray(nbr_mask),
        valid_mask=jnp.asarray(valid),
        null_indicators=jnp.asarray(indicators),
        overflow=jnp.asarray(overflow),
        node_features=jnp.asarray(feats),
        patch_plan=plan,
    )


def _masked_minmax_norm(vecs, mask):
    """Column min-max over real vertices only -> [-0.5, 0.5]
    (reference ``graph.py:254-257``)."""
    big = jnp.where(mask[:, None] > 0, vecs, jnp.inf)
    small = jnp.where(mask[:, None] > 0, vecs, -jnp.inf)
    mn = jnp.min(big, axis=0)
    mx = jnp.max(small, axis=0)
    # Guarded range: a constant column (degenerate spectrum) must not NaN.
    out = (vecs - mn) / jnp.maximum(mx - mn, 1e-30) - 0.5
    return out * mask[:, None]


def _spectrum(graph: GraphArrays, k: int, key, cfg: PipelineConfig,
              x0=None, return_block: bool = False, chunks: int = None,
              extra_chunks: int = 0, degree: int = None):
    """Laplacian spectrum of one mesh: k smallest nonzero eigenpairs,
    eigvecs min-max normalized to [-0.5, 0.5] (reference ``graph.py:228-257``).

    Padding rows are dead coordinates: the eigensolver's iteration is
    confined to the masked subspace (ops/eigen.py ``subspace_mask``), so the
    padded spectrum is identical to the unpadded one.

    ``x0`` / ``return_block`` / ``chunks`` (wide Chebyshev path only): seed
    the filter block with a caller subspace in the SYMMETRIZED coordinates
    (A = S(D-W)S), return the final filtered block alongside the results,
    and override ``cfg.eig_wide_chunks`` — the cross-mesh warm-start hooks.
    """
    mask = graph.valid_mask
    feats = graph.node_features  # [N, K] normalized extra features
    has_feats = feats is not None and feats.shape[1] > 0
    coords = graph.points
    if cfg.include_features_in_adj_matrix and has_feats:
        # Edge weights on xyz augmented with mean-range-scaled features
        # (reference ``graph.py:114-119,166-175``).
        mn = jnp.min(jnp.where(mask[:, None] > 0, graph.points, jnp.inf), axis=0)
        mx = jnp.max(jnp.where(mask[:, None] > 0, graph.points, -jnp.inf), axis=0)
        mean_range = jnp.mean(mx - mn)
        coords = jnp.concatenate(
            [graph.points, feats * mean_range * mask[:, None]], axis=1
        )
    w = graph_ops.edge_weights(coords, graph.neighbors, graph.nbr_mask)
    ov = graph.overflow
    ov_w = graph_ops.overflow_weights(coords, ov)
    d = graph_ops.degree_vector(w, ov, ov_w)
    if cfg.use_features_in_graph and has_feats:
        # Feature G matrix (reference ``graph.py:180-214``).
        kf = feats.shape[1]
        if cfg.feature_weights_diag:
            fw = jnp.diag(jnp.asarray(cfg.feature_weights_diag, jnp.float32))
        else:
            fw = jnp.eye(kf, dtype=jnp.float32)
        g_feat = graph_ops.g_vector(
            feats.T, d, fw,
            p_function=cfg.G_matrix_p_function,
            include_features=True,
            valid_mask=mask,
        )
        g = jnp.where(mask > 0, jnp.maximum(g_feat, 1e-30), 1.0)
    else:
        g = jnp.where(mask > 0, (d + graph_ops.DEGREE_EPS) ** -1, 1.0)
    s = jnp.sqrt(g)

    def matvec(x):
        # Padding rows are dead coordinates: the Krylov iteration is confined
        # to the masked subspace (see ops/eigen.py subspace_mask).
        ax = graph_ops.sym_laplacian_matvec(
            graph.neighbors, w, g, x * mask, ov, ov_w, degrees=d
        )
        return ax * mask

    def quad_form(V):
        # Cancellation-free final Rayleigh quotients (VERDICT r2 task 7):
        # cuts the 15k f32 eigenvalue floor from ~3.6e-3 to ~1e-5 rel.
        return graph_ops.sym_laplacian_quad_form(
            graph.neighbors, w, s, V * mask[:, None], ov, ov_w
        )

    # Kernel basis: one column per connected component, scaled by 1/s
    # (A (1/s * 1_c) = s (D - W) 1_c = 0 on each component).
    null_basis = graph.null_indicators * (1.0 / s)[:, None] * mask[:, None]
    if cfg.eig_method in ("chebyshev", "chebyshev-narrow"):
        # Exact Gershgorin bound for A = S(D-W)S: max_i s_i(s_i d_i + (Ws)_i).
        ws = graph_ops.spmv(graph.neighbors, w, s, ov, ov_w)
        lam_bound = jnp.max(mask * s * (s * d + ws))
        if cfg.eig_method == "chebyshev" and graph.n_points >= 2048:
            # Wide-block solver with a FUSED scaled filter operator: the
            # symmetrized weights sw_ij = s_i w_ij s_j and diagonal s_i^2 d_i
            # are precomputed once, so each recurrence step is one
            # gather-einsum plus one fused elementwise op.
            sw = s[:, None] * w * s[graph.neighbors]
            sd = s * s * d * mask
            has_ov = ov is not None and ov.shape[0] > 0
            ov_sw = (
                ov_w * s[ov[:, 0]] * s[ov[:, 1]]
                if has_ov
                else jnp.zeros((0,), sw.dtype)
            )
            plan = graph.patch_plan
            if plan is not None:
                # Patch-dense filter (ops/patch_dense.py): intra-patch
                # edges as batched dense blocks + compacted boundary
                # residual — same operator exactly (f32 regrouping only).
                from .ops.patch_dense import patch_filter_factory

                factory = patch_filter_factory(plan, sw, ov_sw, sd, mask)
            else:
                def factory(c, e):
                    alpha = 2.0 / e
                    What = alpha * sw
                    a_diag = alpha * (sd - c * mask)

                    def op(T):
                        y = a_diag[:, None] * T - jnp.einsum(
                            "nd,ndc->nc", What, T[graph.neighbors]
                        )
                        if has_ov:
                            y = y.at[ov[:, 0]].add(
                                -(alpha * ov_sw)[:, None] * T[ov[:, 1]]
                            )
                        return y

                    return op

            out = chebyshev_eigpairs_wide(
                matvec, null_basis, key, k,
                block_width=cfg.eig_wide_block,
                chunk_degree=cfg.eig_wide_degree if degree is None else degree,
                chunks=cfg.eig_wide_chunks if chunks is None else chunks,
                subspace_mask=mask, lam_max_bound=lam_bound,
                filter_op_factory=factory,
                quad_form=quad_form,
                x0=x0, return_block=return_block,
                extra_chunks=extra_chunks,
                extra_resid_tol=cfg.eig_warm_resid_tol,
            )
            if return_block:
                lams, vecs_a, _, blk = out
            else:
                lams, vecs_a, _ = out
        else:
            if (return_block or x0 is not None or chunks is not None
                    or degree is not None):
                raise ValueError(
                    "return_block/x0/chunks/degree need the wide Chebyshev "
                    "path (eig_method='chebyshev', n_points >= 2048)"
                )
            lams, vecs_a, _ = chebyshev_eigpairs(
                matvec, null_basis, key, k,
                degree=cfg.eig_cheb_degree, sweeps=cfg.eig_cheb_sweeps,
                refine_cg_iters=cfg.eig_cheb_refine_cg,
                subspace_mask=mask, lam_max_bound=lam_bound,
                quad_form=quad_form,
            )
        vecs = vecs_a * s[:, None]
        vecs = vecs / jnp.linalg.norm(vecs, axis=0, keepdims=True)
    else:
        if (return_block or x0 is not None or chunks is not None
                or degree is not None):
            raise ValueError(
                "return_block/x0/chunks/degree need the wide Chebyshev "
                "path (eig_method='chebyshev', n_points >= 2048)"
            )
        lams, vecs, _ = smallest_nonzero_eigpairs(
            matvec, s, null_basis, k=k, key=key,
            cg_iters=cfg.eig_cg_iters, lanczos_iters=cfg.eig_lanczos_iters,
            subspace_mask=mask,
        )
    vecs = _masked_minmax_norm(vecs, mask)
    if return_block:
        return lams, vecs, (w, ov, ov_w), blk
    return lams, vecs, (w, ov, ov_w)


def _pad_graph_arrays(
    g: GraphArrays, n_pad: int, d_pad: int, c_pad: int, e_pad: int = None
) -> GraphArrays:
    """Pad a GraphArrays to (n_pad points, d_pad degree, c_pad components)
    inside a trace (static pad amounts).  Padding rows are dead: self-loop
    neighbors with zero mask, zero valid_mask, zero indicator columns."""
    n, d = g.neighbors.shape
    extra_n, extra_d = n_pad - n, d_pad - d
    points = jnp.pad(g.points, ((0, extra_n), (0, 0)))
    self_idx = jnp.broadcast_to(
        jnp.arange(n, n_pad, dtype=g.neighbors.dtype)[:, None], (extra_n, d_pad)
    )
    neighbors = jnp.concatenate(
        [jnp.pad(g.neighbors, ((0, 0), (0, extra_d))), self_idx], axis=0
    )
    nbr_mask = jnp.pad(g.nbr_mask, ((0, extra_n), (0, extra_d)))
    valid = jnp.pad(g.valid_mask, (0, extra_n))
    nulls = jnp.pad(
        g.null_indicators,
        ((0, extra_n), (0, c_pad - g.null_indicators.shape[1])),
    )
    ov = g.overflow
    if e_pad is not None and e_pad > ov.shape[0]:
        ov = jnp.pad(ov, ((0, e_pad - ov.shape[0]), (0, 0)))  # src==dst: w=0
    feats = jnp.pad(g.node_features, ((0, extra_n), (0, 0)))
    return GraphArrays(points, neighbors, nbr_mask, valid, nulls, ov, feats)


def _rand_idxs(key, mask, n_samples: int):
    """Sample n_samples indices of real vertices (uniform, no replacement).

    Caveat for padded meshes: the sample SIZE is static, so if n_samples
    meets or exceeds the padded length the arange fast path (and, when
    n_valid < n_samples, even the weighted draw) necessarily includes padding
    rows.  Keep ``n_coords_spectral_ordering`` / ``_registration`` at or
    below the smallest REAL vertex count when batching padded cohorts
    (parallel/cohort.pad_cohort enforces this with a check).
    """
    n = mask.shape[0]
    if n_samples >= n:
        return jnp.arange(n)
    p = mask / jnp.sum(mask)
    return jax.random.choice(key, n, shape=(n_samples,), replace=False, p=p)


def _normed(pts):
    mn = jnp.min(pts, axis=0)
    # Guarded: a mesh degenerate along one axis (planar patch) must not
    # NaN that coordinate column.
    return (pts - mn) / jnp.maximum(jnp.max(pts, axis=0) - mn, 1e-30)


def landmark_pairs_from_positions(
    source_mesh, target_mesh, source_positions, target_positions
):
    """Build ``register_pair``'s ``landmark_pairs`` (i32 [L, 2] vertex
    indices) from physical landmark POSITIONS by snapping each to the
    nearest mesh vertex — the form anatomical landmarks usually arrive in
    (picked coordinates, not vertex ids).

    ``source_positions`` / ``target_positions``: f32 [L, 3] paired landmark
    coordinates on the source and target surfaces.  Returns (pairs
    i32 [L, 2], snap_distances f32 [L, 2]) — inspect the distances to catch
    landmarks that do not actually lie on the surfaces.
    """
    from .ops.knn import nn_query

    sp = jnp.asarray(source_positions, jnp.float32)
    tp = jnp.asarray(target_positions, jnp.float32)
    if sp.shape != tp.shape or sp.ndim != 2 or sp.shape[1] != 3:
        raise ValueError(
            "source/target landmark positions must both be [L, 3]; got "
            f"{sp.shape} and {tp.shape}"
        )
    d_s, idx_s = nn_query(jnp.asarray(source_mesh.points, jnp.float32), sp)
    d_t, idx_t = nn_query(jnp.asarray(target_mesh.points, jnp.float32), tp)
    pairs = jnp.stack([idx_s, idx_t], axis=1).astype(jnp.int32)
    return pairs, jnp.stack([d_s, d_t], axis=1)


def _n_real_vertices(graph: GraphArrays):
    """Concrete real-vertex count, or None when the mask is a tracer
    (inside jit/vmap/shard_map, where host-side guards cannot run)."""
    mask = graph.valid_mask
    if isinstance(mask, jax.core.Tracer):
        return None
    return int(np.asarray(mask).sum())


def _check_padding_hazards(target: GraphArrays, source: GraphArrays, cfg: PipelineConfig):
    """Fail fast on configurations that would silently mix padding rows into
    the registration (only checkable when masks are concrete — the cohort
    path runs these same checks pre-jit via ``check_cohort_config``).

    1. 'hungarian' on a padded graph: the assignment is one-to-one over ALL
       rows, so padding rows (at the origin) would steal target vertices
       from real source vertices.
    2. Subsample sizes above the real vertex count: ``_rand_idxs`` has a
       static sample size, so oversized draws necessarily include padding
       rows (see its caveat).
    """
    use_hungarian = (
        cfg.initial_correspondence_type == "hungarian"
        or cfg.final_correspondence_type == "hungarian"
    )
    for graph, name in ((target, "target"), (source, "source")):
        n_real = _n_real_vertices(graph)
        if n_real is None or n_real == graph.n_points:
            continue
        if use_hungarian:
            raise ValueError(
                f"'hungarian' correspondences need unpadded graphs: {name} "
                f"graph has {n_real} real vertices padded to "
                f"{graph.n_points}; assignment is one-to-one over ALL rows, "
                "so padding would participate. Rebuild without padding or "
                "use correspondence type 'kd'."
            )
        knobs = ["n_coords_spectral_ordering", "n_coords_spectral_registration"]
        if cfg.icp_register_first:
            # The ICP landmark draw samples rows the same way (_rand_idxs
            # static sample size) — an oversized draw pulls origin-padding
            # points into the rigid pre-alignment fit.
            knobs.append("icp_n_landmarks")
        for knob in knobs:
            if getattr(cfg, knob) > n_real:
                raise ValueError(
                    f"{knob}={getattr(cfg, knob)} exceeds the {name} graph's "
                    f"real vertex count {n_real} (padded to {graph.n_points}); "
                    "the subsample would draw padding rows. Lower it to "
                    f"<= {n_real}."
                )


def _warm_supported(cfg: PipelineConfig, a: GraphArrays, b: GraphArrays) -> bool:
    """Whether the cross-mesh spectral warm start applies to this pair:
    wide-chebyshev path on both sides (see PipelineConfig.eig_warm_start)."""
    return (
        cfg.eig_warm_start
        and cfg.eig_method == "chebyshev"
        and a.n_points >= 2048
        and b.n_points >= 2048
    )


def _warm_x0(block, from_points, from_mask, to_points):
    """Map a filtered eigensolver block between meshes: each ``to`` vertex
    takes the block row of its spatially nearest ``from`` vertex.  The
    piecewise-constant sampling noise this introduces is high-frequency —
    exactly what the Chebyshev filter damps first.

    Padded ``from`` rows are masked to SENTINEL before the query (the
    NN-query convention used everywhere else, e.g. the ICP/correspondence
    sites): padding rows sit at the origin after _pad_graph_arrays, so a
    real ``to`` vertex near the origin would otherwise seed from a dead
    all-zero block row.  Padded ``to`` rows receive whatever real row is
    nearest — harmless, the solver's subspace_mask zeroes them."""
    from .ops.knn import nn_query

    _, idx = nn_query(
        jnp.where(from_mask[:, None] > 0, from_points, SENTINEL),
        to_points,
    )
    return block[idx]


# Compiling BOTH eigensolves into one program was neutral below ~62k
# vertices but 3.4x SLOWER at 122k on the hardware the repo first
# targeted — XLA's schedule for two independent large solver loops in one
# executable degraded badly at scale; not yet re-measured on a GPU.  Above
# this threshold register_pair
# runs each spectrum as its own jit program (the prepare_* machinery) and
# feeds the fused remainder.  Override for A/B timing via
# PYFOCUSR_TPU_SPLIT_SPECTRA_N (0 disables the split entirely).
_SPLIT_SPECTRA_N = int(os.environ.get("PYFOCUSR_TPU_SPLIT_SPECTRA_N", "65000"))


def _want_split(target: GraphArrays, source: GraphArrays) -> bool:
    if isinstance(target.points, jax.core.Tracer):
        return False  # inside vmap/shard_map the programs fuse anyway
    return (
        _SPLIT_SPECTRA_N > 0
        and max(target.n_points, source.n_points) >= _SPLIT_SPECTRA_N
    )


def register_pair(
    target: GraphArrays,
    source: GraphArrays,
    cfg: PipelineConfig,
    key,
    landmark_pairs=None,
    warm_block=None,
):
    """Pre-jit entry: runs the concrete-input padding guards (no-ops on
    tracers, e.g. under the cohort shard_map where ``check_cohort_config``
    already ran), then dispatches to the compiled pipeline — with the two
    eigensolves hoisted into separate programs above ``_SPLIT_SPECTRA_N``
    vertices (same math; target side bit-identical, source side identical
    to solver tolerance under rigid ICP).

    ``warm_block`` (beyond-reference, opt-in): a CLASS-TEMPLATE warm-start
    seed from :func:`warm_block_from_prepared` — a previously prepared
    mesh of the same anatomy, roughly aligned with this pair's frame.
    When set, the TARGET eigensolve also starts from the template's
    filtered block (mapped through a spatial NN) and runs the truncated
    warm schedule, so BOTH solves of a never-seen pair run
    ``eig_wide_chunks_warm`` chunks instead of one cold + one warm.  The
    residual-gated top-up (``eig_warm_resid_tol``) self-heals when the
    template turns out to be a poor match."""
    _check_padding_hazards(target, source, cfg)
    if warm_block is not None and not isinstance(
        warm_block.get("points"), jax.core.Tracer
    ):
        # Same hand-built-dict hazard as warm_block_from_prepared guards:
        # a block/points row mismatch would clamp-gather silently.  Check
        # key presence first so a hand-built dict missing one raises the
        # same guided error, not a bare KeyError (advisor finding r4).
        missing = [k for k in ("points", "block", "valid_mask")
                   if k not in warm_block]
        if missing:
            raise ValueError(
                f"warm_block is missing key(s) {missing}: build it with "
                "warm_block_from_prepared"
            )
        n_t, n_b = warm_block["points"].shape[0], warm_block["block"].shape[0]
        if n_t != n_b or warm_block["valid_mask"].shape[0] != n_t:
            raise ValueError(
                f"warm_block is inconsistent: points has {n_t} rows, "
                f"block {n_b}, valid_mask "
                f"{warm_block['valid_mask'].shape[0]} — build it with "
                "warm_block_from_prepared"
            )
    pre = pre_src = None
    if _want_split(target, source):
        keys = jax.random.split(key, 8)
        if not (cfg.icp_register_first and cfg.icp_reg_target_to_source):
            # Target never moves under this config: hoisting its spectrum
            # AND smoothed points is exact (same key split the fused
            # program would use).
            pre = _prepare_target_jit(target, cfg, keys[0],
                                      warm_block=warm_block)
        if source_spectrum_hoistable(cfg):
            x0_s = None
            if (pre is not None and pre.get("block") is not None
                    and _warm_supported(cfg, target, source)
                    and not cfg.icp_register_first):
                # Warm-start the hoisted source solve from the target block
                # (pre-ICP points only: with ICP the fused program maps
                # through moved points, so skip to stay consistent).
                x0_s = _warm_x0(pre["block"], target.points,
                                target.valid_mask, source.points)
            pre_src = _prepare_source_jit(source, cfg, keys[1], x0=x0_s)
    return _register_pair_jit(
        target, source, cfg, key, landmark_pairs, pre=pre, pre_src=pre_src,
        warm_block=warm_block,
    )


def warm_block_from_prepared(prep, template: GraphArrays = None):
    """Build the ``register_pair(warm_block=...)`` seed from a prepared
    template: the template's geometry plus its converged filtered
    eigensolver block (:func:`prepare_target` with the default
    ``eig_warm_start=True`` attaches it; persisted saves carry it too).

    Use case: a serving fleet registering many never-seen pairs of one
    anatomy class prepares ONE representative mesh, persists it with
    :func:`save_prepared_target`, and seeds every pair's BOTH eigensolves
    from it — each pair then runs 2+2 warm chunks instead of 5+2
    (measured headline impact in bench.py ``class_template_15k``).  The
    template must be roughly aligned with the pairs' coordinate frame
    (the seed maps through a spatial nearest-neighbor query).

    ``template`` may be omitted when ``prep`` was loaded from a save
    that embeds the template geometry (:func:`save_prepared_target`
    with ``target=`` — the CLI's ``--warm-from`` path)."""
    if prep.get("block") is None:
        raise ValueError(
            "prepared state carries no filtered block — re-run "
            "prepare_target with eig_warm_start=True (wide-chebyshev path)"
        )
    if template is None:
        if prep.get("warm_points") is None:
            raise ValueError(
                "prepared state does not embed the template geometry — "
                "pass the template GraphArrays, or re-save with "
                "save_prepared_target(..., target=template)"
            )
        if prep["block"].shape[0] != prep["warm_points"].shape[0]:
            raise ValueError(
                f"prepared block has {prep['block'].shape[0]} rows but the "
                f"embedded template geometry has "
                f"{prep['warm_points'].shape[0]} — corrupt or hand-edited "
                "save"
            )
        return {
            "points": prep["warm_points"],
            "valid_mask": prep["warm_valid_mask"],
            "block": prep["block"],
        }
    if prep["block"].shape[0] != template.points.shape[0]:
        # jax gather CLAMPS out-of-range rows silently, so a mismatched
        # prep/template pair would corrupt the warm seed instead of
        # erroring (review finding r4).
        raise ValueError(
            f"prepared block has {prep['block'].shape[0]} rows but the "
            f"template mesh has {template.points.shape[0]} vertices — "
            "the prepared state belongs to a different mesh"
        )
    return {
        "points": template.points,
        "valid_mask": template.valid_mask,
        "block": prep["block"],
    }


@partial(jax.jit, static_argnames=("cfg",))
@f32_matmuls
def _prepare_target_jit(target: GraphArrays, cfg: PipelineConfig, key,
                        warm_block=None):
    blk = None
    if (cfg.eig_warm_start and cfg.eig_method == "chebyshev"
            and target.n_points >= 2048):
        # Keep the filtered block: it seeds the source eigensolve of every
        # pair served from this prepared target (returning it does not
        # perturb the solve — gated by test_spectrum_warm_start_block).
        if warm_block is not None:
            # Class-template seed (see register_pair warm_block): this
            # solve itself starts warm and runs the truncated schedule.
            x0_t = _warm_x0(warm_block["block"], warm_block["points"],
                            warm_block["valid_mask"], target.points)
            lams, vecs, w, blk = _spectrum(
                target, cfg.n_total, key, cfg, return_block=True,
                x0=x0_t, chunks=cfg.eig_wide_chunks_warm,
                extra_chunks=max(
                    cfg.eig_wide_chunks - cfg.eig_wide_chunks_warm, 0
                ),
                degree=cfg.eig_wide_degree_warm,
            )
        else:
            lams, vecs, w, blk = _spectrum(
                target, cfg.n_total, key, cfg, return_block=True
            )
    else:
        lams, vecs, w = _spectrum(target, cfg.n_total, key, cfg)
    if cfg.smooth_correspondences:
        smooth_fn = (
            graph_ops.mean_filter_chebyshev
            if cfg.smoothing_method == "chebyshev"
            else graph_ops.mean_filter
        )
        smoothed = smooth_fn(
            target.neighbors, w[0], target.points,
            cfg.graph_smoothing_iterations, w[1], w[2],
        )
    else:
        smoothed = target.points
    out = {
        "lams": lams, "vecs": vecs, "w": w, "smoothed_points": smoothed,
    }
    if blk is not None:
        out["block"] = blk
    return out


def prepare_target(target: GraphArrays, cfg: PipelineConfig, key,
                   warm_block=None):
    """Precompute the target-only pipeline state for template serving.

    Registering N subjects to ONE template recomputes the template's
    spectrum and smoothed coordinates every pair; this hoists both
    (bit-identical outputs).  Returns a dict pytree to pass
    to :func:`register_pair_prepared`; persist it across processes with
    :func:`save_prepared_target` / :func:`load_prepared_target`.

    Beyond-reference capability (the reference recomputes everything per
    ``Focusr`` instance, ``focusr.py:134-170``).

    Exactness: ``register_pair_prepared(prepare_target(t, cfg, split(key,
    8)[0]), t, s, cfg, key)`` reproduces ``register_pair(t, s, cfg, key)``
    bit-for-bit — prepared state replaces the same values the fused
    program would compute.

    ``icp_reg_target_to_source=True`` moves the TARGET per pair
    (``focusr.py:110-131``) and is rejected: target state cannot be
    hoisted.

    ``warm_block`` (optional): a CLASS-TEMPLATE seed from
    :func:`warm_block_from_prepared` — this preparation's own eigensolve
    then starts warm and runs the truncated schedule (same contract as
    ``register_pair(warm_block=...)``).
    """
    if cfg.icp_register_first and cfg.icp_reg_target_to_source:
        raise ValueError(
            "prepare_target requires a fixed target; "
            "icp_reg_target_to_source=True moves the target per pair"
        )
    return _prepare_target_jit(target, cfg, key, warm_block=warm_block)


def register_pair_prepared(
    prep,
    target: GraphArrays,
    source: GraphArrays,
    cfg: PipelineConfig,
    key,
    landmark_pairs=None,
):
    """Register ``source`` onto a target prepared by :func:`prepare_target`
    (same contract as :func:`register_pair`, minus the target's eigensolve
    and smoothing)."""
    # Re-assert the prepare-time invariant: a cfg that moves the TARGET per
    # pair would mix moved target.points with prepared state computed from
    # the unmoved target — silently inconsistent correspondences.
    if cfg.icp_register_first and cfg.icp_reg_target_to_source:
        raise ValueError(
            "register_pair_prepared requires a fixed target (prepared state "
            "was computed from the unmoved target); "
            "icp_reg_target_to_source=True moves it per pair"
        )
    _check_padding_hazards(target, source, cfg)
    pre_src = None
    if _want_split(target, source) and source_spectrum_hoistable(cfg):
        # Large meshes: keep the remaining (source) eigensolve out of the
        # fused program too (see _SPLIT_SPECTRA_N).
        x0_s = None
        if (prep.get("block") is not None
                and _warm_supported(cfg, target, source)
                and not cfg.icp_register_first):
            x0_s = _warm_x0(prep["block"], target.points,
                            target.valid_mask, source.points)
        pre_src = _prepare_source_jit(
            source, cfg, jax.random.split(key, 8)[1], x0=x0_s
        )
    return _register_pair_jit(
        target, source, cfg, key, landmark_pairs, pre=prep, pre_src=pre_src
    )


@partial(jax.jit, static_argnames=("cfg",))
@f32_matmuls
def _prepare_source_jit(source: GraphArrays, cfg: PipelineConfig, key, x0=None):
    want_block = (
        cfg.eig_warm_start and cfg.eig_method == "chebyshev"
        and source.n_points >= 2048
    )
    if x0 is not None:
        # Split-spectra path: this solve is itself warm-started from the
        # already-prepared target block (register_pair above the split
        # threshold) — no consumer for this side's block.
        lams, vecs, w = _spectrum(
            source, cfg.n_total, key, cfg,
            x0=x0, chunks=cfg.eig_wide_chunks_warm,
            extra_chunks=max(
                cfg.eig_wide_chunks - cfg.eig_wide_chunks_warm, 0
            ),
            degree=cfg.eig_wide_degree_warm,
        )
        return {"lams": lams, "vecs": vecs, "w": w}
    if want_block:
        lams, vecs, w, blk = _spectrum(
            source, cfg.n_total, key, cfg, return_block=True
        )
        return {"lams": lams, "vecs": vecs, "w": w, "block": blk}
    lams, vecs, w = _spectrum(source, cfg.n_total, key, cfg)
    return {"lams": lams, "vecs": vecs, "w": w}


def source_spectrum_hoistable(cfg: PipelineConfig) -> bool:
    """Whether the source spectrum/operators are pair-independent under
    ``cfg`` (the :func:`prepare_source` validity condition).

    The spectrum and smoothing operators depend only on edge weights
    w = 1/dist (reference ``graph.py:148-178``), which rigid motion
    preserves exactly — so hoisting is valid even when ICP moves the
    source per pair, as long as the mode is 'rigid'.  'similarity' ICP
    rescales edge lengths: the normalized Laplacian L = D^-1(D - W) is
    still scale-invariant, but the mean-filter operator
    D'^-1 (W + I) (``graph.py:320-354``) mixes the scaled W with the
    unscaled I, so the smoothed projections would diverge — not hoistable.
    """
    return not (
        cfg.icp_register_first
        and not cfg.icp_reg_target_to_source
        and cfg.icp_registration_mode != "rigid"
    )


def prepare_source(source: GraphArrays, cfg: PipelineConfig, key):
    """Precompute the source-only pipeline state (spectrum + graph
    operators) for the cohort/SSM direction of template serving.

    ``parallel.cohort.register_cohort`` registers ONE template (as source,
    so ``weighted_points`` land in template vertex order — reference
    ``focusr.py:32-35``) against every cohort subject; without hoisting,
    the template's eigensolve is recomputed in every vmap lane.  This is
    the mirror image of :func:`prepare_target` (which serves the
    target-fixed direction).

    Exactness: with ``icp_register_first=False`` AND ``eig_warm_start=False``,
    passing the same key the fused program would use
    (``jax.random.split(key, 8)[1]``) reproduces ``register_pair``
    bit-for-bit.  With the warm start on (the default) the fused program
    seeds its source solve from the target block while this prepared one
    runs cold, and with rigid ICP the hoisted spectrum is computed from
    the unmoved source — in both cases the paths agree to solver
    tolerance, not bit-level (see :func:`source_spectrum_hoistable`; gated
    in tests/test_pipeline.py::test_prepared_source_matches_register_pair).
    """
    if not source_spectrum_hoistable(cfg):
        raise ValueError(
            "prepare_source requires pair-independent source operators; "
            "icp_registration_mode='similarity' with the source moving "
            "per pair rescales the smoothing operator. Use rigid ICP, "
            "icp_reg_target_to_source=True, or icp_register_first=False."
        )
    return _prepare_source_jit(source, cfg, key)


def register_pair_prepared_source(
    prep_src,
    target: GraphArrays,
    source: GraphArrays,
    cfg: PipelineConfig,
    key,
    landmark_pairs=None,
):
    """Register onto ``target`` with a source prepared by
    :func:`prepare_source` (same contract as :func:`register_pair`, minus
    the source's eigensolve)."""
    if not source_spectrum_hoistable(cfg):
        # Re-assert the prepare-time invariant ('similarity' ICP moving the
        # source rescales the smoothing operator the prepared state baked in).
        raise ValueError(
            "register_pair_prepared_source: cfg is not source-hoistable "
            "(similarity ICP moving the source per pair); see prepare_source"
        )
    _check_padding_hazards(target, source, cfg)
    pre = None
    if _want_split(target, source) and not (
        cfg.icp_register_first and cfg.icp_reg_target_to_source
    ):
        pre = _prepare_target_jit(target, cfg, jax.random.split(key, 8)[0])
    return _register_pair_jit(
        target, source, cfg, key, landmark_pairs, pre=pre, pre_src=prep_src
    )


def _graph_fingerprint(graph: GraphArrays) -> str:
    """Content hash of a graph's geometry + topology — identifies the mesh
    a prepared state was computed from.  Includes the hub-overflow edge
    list and neighbor mask: two graphs with identical ELL tables can still
    differ in overflow edges, which change the Laplacian."""
    import hashlib

    h = hashlib.sha256()
    # node_features are part of the Laplacian too (feature-augmented edge
    # weights / feature G matrix in _spectrum) and are user-supplied.
    for arr in (graph.points, graph.neighbors, graph.nbr_mask,
                graph.valid_mask, graph.overflow, graph.node_features):
        a = np.asarray(arr)
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# Knobs that never change the prepared state itself, excluded from the
# fingerprint so saves remain loadable across them:
#
# * ``landmark_weight`` — a per-run CPD prior knob that never enters
#   :func:`prepare_target`'s spectrum or smoothing (the CLI passes
#   --landmark-weight per invocation);
# * ``eig_warm_start`` / ``eig_wide_chunks_warm`` / ``eig_wide_degree_warm``
#   / ``eig_warm_resid_tol`` — they decide whether the filtered block is
#   ATTACHED to the prepared state and how a warm PAIR solve consumes it,
#   not the prepared spectrum/smoothing values (gated by
#   test_spectrum_warm_start_block).  A state saved without the block loads
#   fine under eig_warm_start=True (the pair solve just runs cold).
_FP_SKIP = frozenset((
    "landmark_weight", "eig_warm_start", "eig_wide_chunks_warm",
    "eig_wide_degree_warm", "eig_warm_resid_tol",
))


def _cfg_fingerprint(cfg: PipelineConfig) -> str:
    """Canonical config string for prepared-state fingerprints.

    Only fields that DIFFER from their defaults appear (sorted by name),
    so adding a new PipelineConfig knob — normalized to its default —
    does not change existing fingerprints and persisted templates stay
    loadable across upgrades.  Fields in ``_FP_SKIP`` are excluded
    entirely (see the comment above).  Saves written by older versions
    carry the previous format (the full dataclass ``repr``);
    :func:`load_prepared_target` accepts those via
    :func:`_fingerprint_matches`, which parses and reduces both sides to
    this canonical form before comparing."""
    fields = PipelineConfig.__dataclass_fields__
    parts = [
        f"{name}={getattr(cfg, name)!r}"
        for name in sorted(fields)
        if name not in _FP_SKIP and getattr(cfg, name) != fields[name].default
    ]
    return "PipelineConfig(" + ", ".join(parts) + ")"


def _fingerprint_matches(stored: str, cfg: PipelineConfig) -> bool:
    """True when a stored fingerprint denotes the same prepared state as
    ``cfg``.  Fast path: exact match against the canonical form.  Slow
    path (legacy saves): parse the stored string as ``name=literal``
    keywords and reduce it the same way — skip ``_FP_SKIP`` fields and
    drop fields sitting at their current defaults — so full-``repr``-era
    fingerprints (which baked in every field and thus broke whenever a
    knob was added) keep matching.  A field name the current
    PipelineConfig does not define mismatches conservatively (its
    default is unknowable)."""
    if stored == _cfg_fingerprint(cfg):
        return True
    import ast

    fields = PipelineConfig.__dataclass_fields__
    try:
        call = ast.parse(stored.strip(), mode="eval").body
        if not isinstance(call, ast.Call) or any(
            kw.arg is None for kw in call.keywords
        ):
            return False
        kept = {}
        for kw in call.keywords:
            val = ast.literal_eval(kw.value)
            if kw.arg in _FP_SKIP:
                continue
            if kw.arg in fields and val == fields[kw.arg].default:
                continue
            kept[kw.arg] = val
    except (SyntaxError, ValueError):
        return False
    current = {
        name: getattr(cfg, name)
        for name in fields
        if name not in _FP_SKIP and getattr(cfg, name) != fields[name].default
    }
    return kept == current


def save_prepared_target(
    path: str, prep, cfg: PipelineConfig = None, target: GraphArrays = None
) -> None:
    """Persist a :func:`prepare_target` state to ``.npz`` so a serving
    process can skip the template eigensolve entirely.  Pass the ``cfg``
    it was prepared under to embed a config fingerprint, and the
    ``target`` GraphArrays to embed a mesh fingerprint; loading with a
    different config or a different (even same-size) target mesh then
    fails loudly instead of silently mixing one mesh's spectrum with
    another's coordinates."""
    import numpy as _np

    from .utils.checkpoint import save_results

    tree = dict(prep)
    if cfg is not None:
        tree["cfg_fingerprint"] = _np.frombuffer(
            _cfg_fingerprint(cfg).encode(), dtype=_np.uint8
        ).copy()
    if target is not None:
        tree["target_fingerprint"] = _np.frombuffer(
            _graph_fingerprint(target).encode(), dtype=_np.uint8
        ).copy()
        # Embed the template geometry so the save is self-contained for
        # CLASS-TEMPLATE warm starts (warm_block_from_prepared with no
        # template argument; CLI --warm-from): ~N x 4 floats, negligible
        # next to the N x 128 filtered block.
        tree["warm_points"] = _np.asarray(target.points)
        tree["warm_valid_mask"] = _np.asarray(target.valid_mask)
    save_results(path, tree)


def load_prepared_target(
    path: str, cfg: PipelineConfig = None, target: GraphArrays = None
):
    """Inverse of :func:`save_prepared_target` -> the dict pytree
    :func:`register_pair_prepared` expects.  With ``cfg`` (resp.
    ``target``), verifies the stored config (resp. target-mesh)
    fingerprint, when the file carries one."""
    from .utils.checkpoint import load_results

    flat = load_results(path)
    if cfg is not None and "['cfg_fingerprint']" in flat:
        stored = bytes(flat["['cfg_fingerprint']"]).decode()
        if not _fingerprint_matches(stored, cfg):
            raise ValueError(
                "prepared-target state was saved under a different "
                "PipelineConfig; re-run prepare_target (stored: "
                f"{stored[:200]}...)"
            )
    if target is not None and "['target_fingerprint']" in flat:
        stored = bytes(flat["['target_fingerprint']"]).decode()
        if stored != _graph_fingerprint(target):
            raise ValueError(
                "prepared-target state does not match this target mesh "
                "(geometry/topology/feature hash mismatch — a different "
                "mesh, or a checkpoint saved under an older fingerprint "
                "format). Re-run prepare_target on the current mesh."
            )
    w = []
    i = 0
    while f"['w']/[{i}]" in flat:
        w.append(jnp.asarray(flat[f"['w']/[{i}]"]))
        i += 1
    out = {
        "lams": jnp.asarray(flat["['lams']"]),
        "vecs": jnp.asarray(flat["['vecs']"]),
        "w": tuple(w),
        "smoothed_points": jnp.asarray(flat["['smoothed_points']"]),
    }
    if "['block']" in flat:  # warm-start seed (absent in pre-warm-start saves)
        out["block"] = jnp.asarray(flat["['block']"])
    if "['warm_points']" in flat:  # embedded template geometry (--warm-from)
        out["warm_points"] = jnp.asarray(flat["['warm_points']"])
        out["warm_valid_mask"] = jnp.asarray(flat["['warm_valid_mask']"])
    return out


@partial(jax.jit, static_argnames=("cfg",))
@f32_matmuls
def _register_pair_jit(
    target: GraphArrays,
    source: GraphArrays,
    cfg: PipelineConfig,
    key,
    landmark_pairs=None,
    pre=None,
    pre_src=None,
    warm_block=None,
):
    """Full registration of one mesh pair.  Returns a dict pytree (all sized
    to the padded source/target shapes; rows where ``source.valid_mask == 0``
    are padding):

    correspondences  i32 [Ns]  target index per source point (final)
    initial_correspondences i32 [Ns]
    nearest_points / weighted_points / average_points  f32 [Ns, 3]
    eig_vals_{target,source} f32 [k], spectral coords, Q

    ``landmark_pairs`` (beyond-reference): optional i32 [L, 2] known
    correspondences ``(source_vertex, target_vertex)``.  The landmark
    target vertices are force-included in the CPD control subsample and
    their spectral positions are pulled toward their source partners'
    (MAP CPD prior terms, ``ops.cpd``; strength
    ``cfg.landmark_weight``) — anatomically-guided registration.
    """
    keys = jax.random.split(key, 8)
    k_total = cfg.n_total

    # --- ICP pre-alignment (reference ``focusr.py:110-131``): the default
    # moves the SOURCE onto the target; ``icp_reg_target_to_source`` moves
    # the TARGET onto the source instead. ---
    if cfg.icp_register_first:
        from .ops.icp import apply_rigid, icp as icp_fit

        moving, fixed = (
            (target, source) if cfg.icp_reg_target_to_source else (source, target)
        )
        # Fit on a landmark subsample (the VTK ICP the reference wraps caps
        # landmarks at its default 200 — vtk_functions.py:27-28; 2000 here),
        # then apply the rigid transform to the full cloud.
        n_lm = min(cfg.icp_n_landmarks, moving.n_points)
        lm_idx = _rand_idxs(keys[7], moving.valid_mask, n_lm)
        (_s, _R, _t), _ = icp_fit(
            moving.points[lm_idx],
            jnp.where(fixed.valid_mask[:, None] > 0, fixed.points, SENTINEL),
            mode=cfg.icp_registration_mode,
            max_iterations=cfg.icp_iterations,
        )
        moved = apply_rigid(moving.points, _s, _R, _t)
        moving = dataclasses.replace(
            moving, points=moved * moving.valid_mask[:, None]
        )
        if cfg.icp_reg_target_to_source:
            target = moving
        else:
            source = moving

    # --- Spectra (reference ``focusr.py:134-170``) ---
    # The two eigensolves run sequentially (the union/batched
    # alternatives live in experiments.py with their neutral-or-slower
    # measurements from the hardware the repo first targeted).  ``pre`` (from ``prepare_target``)
    # carries the target's spectrum/operators precomputed once for
    # template-serving reuse.
    warm_ok = _warm_supported(cfg, target, source)
    blk_t = None
    if pre is None:
        if warm_ok and pre_src is not None and pre_src.get("block") is not None:
            # Cohort/SSM direction: the prepared SOURCE (template) block
            # seeds the subject's eigensolve.
            x0_t = _warm_x0(pre_src["block"], source.points,
                            source.valid_mask, target.points)
            lams_t, vecs_t, w_t = _spectrum(
                target, k_total, keys[0], cfg,
                x0=x0_t, chunks=cfg.eig_wide_chunks_warm,
                extra_chunks=max(
                    cfg.eig_wide_chunks - cfg.eig_wide_chunks_warm, 0
                ),
                degree=cfg.eig_wide_degree_warm,
            )
        elif (warm_ok and warm_block is not None
              and not (cfg.icp_register_first
                       and cfg.icp_reg_target_to_source)):
            # Class-template seed (register_pair warm_block): the TARGET
            # solve also starts warm from the template's block and runs
            # the truncated schedule, keeping its own block for the
            # source's warm start below.  Gated off when ICP moves the
            # target (the template frame would no longer match).
            x0_t = _warm_x0(warm_block["block"], warm_block["points"],
                            warm_block["valid_mask"], target.points)
            lams_t, vecs_t, w_t, blk_t = _spectrum(
                target, k_total, keys[0], cfg, return_block=True,
                x0=x0_t, chunks=cfg.eig_wide_chunks_warm,
                extra_chunks=max(
                    cfg.eig_wide_chunks - cfg.eig_wide_chunks_warm, 0
                ),
                degree=cfg.eig_wide_degree_warm,
            )
        elif warm_ok and pre_src is None:
            # Both spectra inline: keep the target's filtered block to seed
            # the source solve below.
            lams_t, vecs_t, w_t, blk_t = _spectrum(
                target, k_total, keys[0], cfg, return_block=True
            )
        else:
            lams_t, vecs_t, w_t = _spectrum(target, k_total, keys[0], cfg)
    else:
        lams_t, vecs_t, w_t = pre["lams"], pre["vecs"], pre["w"]
        if warm_ok:
            blk_t = pre.get("block")
    if pre_src is None:
        if warm_ok and blk_t is not None:
            x0_s = _warm_x0(blk_t, target.points,
                            target.valid_mask, source.points)
            lams_s, vecs_s, w_s = _spectrum(
                source, k_total, keys[1], cfg,
                x0=x0_s, chunks=cfg.eig_wide_chunks_warm,
                extra_chunks=max(
                    cfg.eig_wide_chunks - cfg.eig_wide_chunks_warm, 0
                ),
                degree=cfg.eig_wide_degree_warm,
            )
        else:
            lams_s, vecs_s, w_s = _spectrum(source, k_total, keys[1], cfg)
    else:
        # ``pre_src`` (from ``prepare_source``) carries the SOURCE spectrum
        # precomputed once — the cohort/SSM direction, where one template
        # (as source, cohort.py) registers to many subjects.  Valid even
        # with rigid ICP enabled: the random-walk Laplacian and smoothing
        # operators depend only on edge lengths, which rigid motion
        # preserves (see prepare_source for the guard on 'similarity').
        lams_s, vecs_s, w_s = pre_src["lams"], pre_src["vecs"], pre_src["w"]

    # --- eigsort (reference ``focusr.py:514-521``) ---
    # Per-mesh sample sizes (reference: each graph draws its own rand_idxs,
    # ``graph.py:274-290``); unequal counts take the merged-CDF Wasserstein
    # path inside sort_eigenmaps_jit.
    n_rand_t = min(cfg.n_coords_spectral_ordering, target.n_points)
    n_rand_s = min(cfg.n_coords_spectral_ordering, source.n_points)
    idx_t = _rand_idxs(keys[2], target.valid_mask, n_rand_t)
    idx_s = _rand_idxs(keys[3], source.valid_mask, n_rand_s)
    sorted_vecs, Q = sort_eigenmaps_jit(
        lams_t,
        lams_s,
        vecs_t[idx_t],
        vecs_s[idx_s],
        _normed(target.points[idx_t]),
        _normed(source.points[idx_s]),
        vecs_s if cfg.target_eigenmap_as_reference else vecs_t,
        target_as_reference=cfg.target_eigenmap_as_reference,
    )
    if cfg.target_eigenmap_as_reference:
        vecs_s_sorted, vecs_t_used = sorted_vecs, vecs_t
    else:
        # eigsort permuted/flipped the TARGET maps into the source's order
        # (``eigsort.py:75-78,100-122``); the source maps stay as computed.
        vecs_s_sorted, vecs_t_used = vecs_s, sorted_vecs

    # --- Spectral coords (reference ``focusr.py:459-508``) ---
    k_use = cfg.n_spectral_features
    src_coords = vecs_s_sorted[:, :k_use]
    tgt_coords = vecs_t_used[:, :k_use]
    if cfg.get_weighted_spectral_coords:
        lam_max = jnp.maximum(lams_s[:k_use], lams_t[:k_use])
        wspec = Q[:k_use] * lam_max
        sigma = jnp.mean(wspec)
        wspec = jnp.exp(-(wspec**2) / (2.0 * sigma**2))
        src_coords = src_coords * wspec[None, :]
        tgt_coords = tgt_coords * wspec[None, :]

    def _masked_minmax(arr, m):
        big = jnp.where(m[:, None] > 0, arr, -jnp.inf)
        small = jnp.where(m[:, None] > 0, arr, jnp.inf)
        return jnp.min(small, axis=0), jnp.max(big, axis=0)

    smooth_fn = (
        graph_ops.mean_filter_chebyshev
        if cfg.smoothing_method == "chebyshev"
        else graph_ops.mean_filter
    )

    # --- Extra-feature appending (reference ``focusr.py:218-269``) ---
    if cfg.use_features_as_coords and target.node_features.shape[1] > 0:
        if target.node_features.shape[1] != source.node_features.shape[1]:
            raise Exception(
                "Number of extra features between target ({}) and source "
                "({}) dont match!".format(
                    target.node_features.shape[1], source.node_features.shape[1]
                )
            )

        def _feature_cols(graph, w_arr, coords):
            # Smooth each feature on its own graph, min-max to [0, 1], then
            # rescale by the (scalar) ptp of this mesh's spectral coords.
            mn_c, mx_c = _masked_minmax(coords, graph.valid_mask)
            ptp = jnp.max(mx_c) - jnp.min(mn_c)
            sm = smooth_fn(
                graph.neighbors, w_arr[0], graph.node_features,
                cfg.feature_smoothing_iterations, w_arr[1], w_arr[2],
            )
            mn, mx = _masked_minmax(sm, graph.valid_mask)
            sm = (sm - mn[None, :]) / jnp.maximum(mx - mn, 1e-30)[None, :]
            return ptp * sm * graph.valid_mask[:, None]

        src_coords = jnp.concatenate(
            [src_coords, _feature_cols(source, w_s, src_coords)], axis=1
        )
        tgt_coords = jnp.concatenate(
            [tgt_coords, _feature_cols(target, w_t, tgt_coords)], axis=1
        )

    # --- XYZ-as-feature appending (reference ``focusr.py:271-295``) ---
    if cfg.include_points_as_features:

        def _normed_points(graph):
            mn, mx = _masked_minmax(graph.points, graph.valid_mask)
            mean_range = jnp.mean(mx - mn)
            return (graph.points - mn[None, :]) / jnp.maximum(
                mean_range, 1e-30
            ) * graph.valid_mask[:, None], mean_range

        np_s, range_s = _normed_points(source)
        np_t, range_t = _normed_points(target)
        if cfg.norm_physical_and_spectral:
            src_coords = jnp.concatenate([src_coords, np_s], axis=1)
            tgt_coords = jnp.concatenate([tgt_coords, np_t], axis=1)
        else:
            src_coords = jnp.concatenate(
                [src_coords * range_s, source.points], axis=1
            )
            tgt_coords = jnp.concatenate(
                [tgt_coords * range_t, target.points], axis=1
            )

    # --- CPD: move TARGET spectral cloud onto SOURCE (``focusr.py:297-334``) ---
    n_reg = min(
        cfg.n_coords_spectral_registration, target.n_points, source.n_points
    )
    X = src_coords[_rand_idxs(keys[4], source.valid_mask, n_reg)]
    if landmark_pairs is not None:
        # Force the landmark target vertices into the control subsample
        # (first L rows), so the prior terms act on real control points.
        n_lm = landmark_pairs.shape[0]
        if n_lm >= n_reg:
            raise ValueError(
                "landmark_pairs must be fewer than "
                "n_coords_spectral_registration"
            )
        idx_y = jnp.concatenate(
            [
                landmark_pairs[:, 1].astype(jnp.int32),
                _rand_idxs(keys[5], target.valid_mask, n_reg - n_lm),
            ]
        )
        Y = tgt_coords[idx_y]
        cpd_landmarks = (
            jnp.arange(n_lm, dtype=jnp.int32),
            src_coords[landmark_pairs[:, 0]],
            jnp.full((n_lm,), cfg.landmark_weight, jnp.float32),
        )
    else:
        Y = tgt_coords[_rand_idxs(keys[5], target.valid_mask, n_reg)]
        cpd_landmarks = None

    if cfg.rigid_before_non_rigid_reg:
        _, B, t_vec, _, _ = cpd_ops._affine_cpd_run(
            X, Y, cfg.rigid_reg_max_iterations, cfg.rigid_tolerance,
            w=cfg.non_rigid_outlier_w,
        )
        Y = jnp.dot(Y, B.T, precision=_PREC) + t_vec[None, :]
        tgt_coords = jnp.dot(tgt_coords, B.T, precision=_PREC) + t_vec[None, :]

    num_eig = min(cfg.non_rigid_n_eigens, n_reg)
    Qg, lam_g = cpd_ops.low_rank_gaussian(Y, cfg.non_rigid_beta, num_eig, keys[6])
    # Full-resolution CPD (n_coords_spectral_registration >= n_points): the
    # responsibility matrix is streamed in row tiles instead of
    # materialized — see ops/tiled.cpd_estep_tiled.
    estep_impl = "tiled" if n_reg * n_reg > 3000 * 3000 else "dense"
    _, z_cpd, _, _ = cpd_ops._deformable_cpd_run(
        X, Y, Qg, lam_g,
        cfg.non_rigid_alpha, cfg.non_rigid_max_iterations, cfg.non_rigid_tolerance,
        w=cfg.non_rigid_outlier_w,
        estep_impl=estep_impl,
        landmarks=cpd_landmarks,
    )
    tgt_coords_moved = cpd_ops.lowrank_transform(
        tgt_coords, Y, Qg, lam_g, z_cpd, cfg.non_rigid_beta
    )

    # Padding target rows must never be selected as neighbors.
    tmask = target.valid_mask[:, None]
    tgt_coords_q = jnp.where(tmask > 0, tgt_coords_moved, SENTINEL)

    use_hungarian = (
        cfg.initial_correspondence_type == "hungarian"
        or cfg.final_correspondence_type == "hungarian"
    )
    if use_hungarian and target.n_points != source.n_points:
        # Reference guard (``focusr.py:377-385``).  Padded cohort batches
        # are likewise unsupported: assignment is one-to-one over ALL rows.
        raise ValueError(
            "If number vertices between source & target don't match, "
            "correspondence type must be 'kd' and not 'hungarian'."
        )

    def _hungarian(ref_pts, query_pts):
        # Euclidean (not squared) costs: the assignment objective must match
        # the reference's cdist + linear_sum_assignment (``focusr.py:340-349``).
        from .ops.assignment import sinkhorn_jv_lap
        from .ops.knn import pairwise_sq_dists

        cost = jnp.sqrt(
            jnp.maximum(pairwise_sq_dists(query_pts, ref_pts), 0.0)
        )
        return sinkhorn_jv_lap(cost)

    # --- Initial correspondences (``focusr.py:545``) ---
    if cfg.initial_correspondence_type == "hungarian":
        init_corr = _hungarian(tgt_coords_moved, src_coords)
    else:
        _, init_corr = nn_query(tgt_coords_q, src_coords)
    mutual = None
    if cfg.compute_mutual_consistency:
        src_q = jnp.where(
            source.valid_mask[:, None] > 0, src_coords, SENTINEL
        )
        _, rev_corr = nn_query(src_q, tgt_coords_moved)
        mutual = (rev_corr[init_corr] == jnp.arange(init_corr.shape[0])).astype(
            jnp.float32
        ) * source.valid_mask

    corr = init_corr
    smoothed_tgt = target.points
    projected = source.points
    if cfg.smooth_correspondences:
        # (``focusr.py:368-399``; smooth_fn chosen above)
        if pre is None:
            smoothed_tgt = smooth_fn(
                target.neighbors, w_t[0], target.points,
                cfg.graph_smoothing_iterations, w_t[1], w_t[2],
            )
        else:
            smoothed_tgt = pre["smoothed_points"]
        gathered = smoothed_tgt[init_corr]
        projected = smooth_fn(
            source.neighbors, w_s[0], gathered,
            cfg.projection_smooth_iterations, w_s[1], w_s[2],
        )
        if cfg.final_correspondence_type == "hungarian":
            corr = _hungarian(smoothed_tgt, projected)

    # --- Final locations (``focusr.py:401-431``): shared k=3 IDW with
    # exact-hit shortcut.  The same k=3 query also yields the final 'kd'
    # correspondence as its first column (ops.knn.knn3_masked), saving a
    # full [N, N] NN pass. ---
    d3, i3 = knn3_masked(smoothed_tgt, target.valid_mask, projected)
    if cfg.smooth_correspondences and cfg.final_correspondence_type == "kd":
        corr = i3[:, 0]
    weighted = idw_from_knn(d3, i3, target.points)
    nearest = target.points[corr]
    average = (source.points + weighted) / 2.0

    smask = source.valid_mask[:, None]
    return {
        "correspondences": corr * source.valid_mask.astype(corr.dtype),
        "initial_correspondences": init_corr
        * source.valid_mask.astype(init_corr.dtype),
        "nearest_points": nearest * smask,
        "weighted_points": weighted * smask,
        "average_points": average * smask,
        "eig_vals_target": lams_t,
        "eig_vals_source": lams_s,
        "eig_vecs_target": vecs_t_used * tmask,
        "eig_vecs_source_sorted": vecs_s_sorted * smask,
        "spectral_coords_target": tgt_coords_moved * tmask,
        "spectral_coords_source": src_coords * smask,
        "smoothed_target_coords": smoothed_tgt * tmask,
        "source_projected_on_target": projected * smask,
        "Q": Q,
        **({"mutual_consistency": mutual} if mutual is not None else {}),
    }
