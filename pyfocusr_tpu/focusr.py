"""Focusr orchestrator: the end-to-end FOCUSR registration pipeline.

JAX re-implementation of the reference ``Focusr`` class
(``focusr.py:22-807``).  The constructor signature mirrors the reference's
~40 keyword arguments by name (they are the public API contract — SURVEY
§5.6), plus ``seed`` for reproducible subsampling and ``timer`` options.

Pipeline (same ordering as reference ``align_maps``, ``focusr.py:514-570``):
  ctor:  optional ICP pre-alignment -> build target & source Graph + spectra
  align_maps:
    eigsort (sign-flip + reorder source eigvecs)        focusr.py:515-521
    spectral coords (optionally confidence-weighted)     focusr.py:459-508
    append smoothed extra features / xyz                 focusr.py:218-295
    affine CPD ("rigid" step, D>3)                       focusr.py:537-539
    deformable CPD + transform full target coords        focusr.py:542-543
    initial correspondences (kd | hungarian)             focusr.py:545
    smoothed correspondences (graph low-pass)            focusr.py:551-552
    weighted / nearest final node locations              focusr.py:559-562
    transformed meshes                                   focusr.py:564-568

All stage results are kept as attributes with the reference's names
(``corresponding_target_idx_for_each_source_pt``,
``nearest_neighbor_transformed_points``, ``weighted_avg_transformed_points``,
``average_mesh``, ...), so downstream code written against the reference
ports directly.
"""

from __future__ import annotations

import time

import numpy as np
import jax.numpy as jnp

from .mesh import TriMesh, as_trimesh
from .ops import cpd
from .ops.assignment import linear_sum_assignment
from .ops.icp import icp as icp_fit
from .ops.knn import nn_query, knn_query, pairwise_sq_dists
from .spectral.eigsort import eigsort
from .spectral.graph import Graph
from .utils.logging import StageTimer, print_header

__all__ = ["Focusr"]


class Focusr(object):
    def __init__(
        self,
        vtk_mesh_target: TriMesh,
        vtk_mesh_source: TriMesh,
        icp_register_first=True,
        icp_registration_mode="rigid",  # 'rigid' | 'similarity'
        icp_reg_target_to_source=False,
        n_spectral_features=3,
        n_extra_spectral=3,
        target_eigenmap_as_reference=True,
        norm_physical_and_spectral=True,
        n_coords_spectral_ordering=5000,
        n_coords_spectral_registration=5000,
        rigid_before_non_rigid_reg=True,
        rigid_reg_max_iterations=100,
        rigid_tolerance=1e-8,
        non_rigid_max_iterations=1000,
        non_rigid_tolerance=1e-8,
        non_rigid_alpha=0.5,
        non_rigid_beta=3.0,
        non_rigid_n_eigens=100,
        non_rigid_outlier_w=0.0,  # beyond-reference: CPD outlier weight in [0,1)
        include_points_as_features=False,
        get_weighted_spectral_coords=True,
        graph_smoothing_iterations=300,
        feature_smoothing_iterations=40,
        smooth_correspondences=True,
        return_average_final_points=True,
        return_nearest_final_points=True,
        return_transformed_mesh=True,
        projection_smooth_iterations=40,
        feature_weights=None,
        initial_correspondence_type="kd",  # 'kd' | 'hungarian'
        final_correspondence_type="kd",  # 'kd' | 'hungarian'
        list_features_to_calc=("curvature",),
        list_features_to_get_from_mesh=(),
        use_features_as_coords=False,
        use_features_in_graph=False,
        include_features_in_adj_matrix=False,
        G_matrix_p_function="exp",
        norm_node_features_std=True,
        norm_node_features_cap_std=3,
        norm_node_features_0_1=True,
        verbose=False,
        seed=0,
        timer: StageTimer | None = None,
    ):
        self.verbose = verbose
        self.timer = timer if timer is not None else StageTimer(verbose=verbose)
        if verbose:
            print("Starting Focusr")
        # Live vtkPolyData inputs (the reference's native type, focusr.py:23)
        # are coerced to TriMesh; TriMesh passes through unchanged.
        vtk_mesh_target = as_trimesh(vtk_mesh_target)
        vtk_mesh_source = as_trimesh(vtk_mesh_source)
        # Inputs (names mirror reference ``focusr.py:72-104``).
        self.n_spectral_features = n_spectral_features
        self.n_extra_spectral = n_extra_spectral
        self.n_total_spectral_features = n_spectral_features + n_extra_spectral
        self.target_eigenmap_as_reference = target_eigenmap_as_reference
        self.norm_physical_and_spectral = norm_physical_and_spectral
        self.include_points_as_features = include_points_as_features
        self.get_weighted_spectral_coords = get_weighted_spectral_coords
        self.feature_smoothing_iterations = feature_smoothing_iterations
        self.n_coords_spectral_registration = n_coords_spectral_registration
        self.rigid_before_non_rigid_reg = rigid_before_non_rigid_reg
        self.rigid_reg_max_iterations = rigid_reg_max_iterations
        self.rigid_tolerance = rigid_tolerance
        self.non_rigid_max_iterations = non_rigid_max_iterations
        self.non_rigid_tolerance = non_rigid_tolerance
        self.non_rigid_alpha = non_rigid_alpha
        self.non_rigid_beta = non_rigid_beta
        self.non_rigid_n_eigens = non_rigid_n_eigens
        self.non_rigid_outlier_w = non_rigid_outlier_w
        self.initial_correspondence_type = initial_correspondence_type
        self.smooth_correspondences = smooth_correspondences
        self.return_average_final_points = return_average_final_points
        self.return_nearest_final_points = return_nearest_final_points
        self.graph_smoothing_iterations = graph_smoothing_iterations
        self.projection_smooth_iterations = projection_smooth_iterations
        self.final_correspondence_type = final_correspondence_type
        self.return_transformed_mesh = return_transformed_mesh
        self.seed = seed

        # --- ICP pre-alignment (reference ``focusr.py:106-131``) ---
        self._icp_transform = None
        if icp_register_first is True:
            with self.timer.span("icp"):
                if icp_reg_target_to_source is True:
                    (s, R, t), moved = icp_fit(
                        jnp.asarray(vtk_mesh_target.points, jnp.float32),
                        jnp.asarray(vtk_mesh_source.points, jnp.float32),
                        mode=icp_registration_mode,
                    )
                    vtk_mesh_target = vtk_mesh_target.with_points(moved)
                else:
                    (s, R, t), moved = icp_fit(
                        jnp.asarray(vtk_mesh_source.points, jnp.float32),
                        jnp.asarray(vtk_mesh_target.points, jnp.float32),
                        mode=icp_registration_mode,
                    )
                    vtk_mesh_source = vtk_mesh_source.with_points(moved)
                self._icp_transform = (s, R, t)

        graph_kwargs = dict(
            n_spectral_features=self.n_total_spectral_features,
            n_rand_samples=n_coords_spectral_ordering,
            list_features_to_calc=list(list_features_to_calc),
            list_features_to_get_from_mesh=list(list_features_to_get_from_mesh),
            feature_weights=feature_weights,
            include_features_in_G_matrix=use_features_in_graph,
            include_features_in_adj_matrix=include_features_in_adj_matrix,
            G_matrix_p_function=G_matrix_p_function,
            norm_node_features_std=norm_node_features_std,
            norm_node_features_cap_std=norm_node_features_cap_std,
            norm_node_features_0_1=norm_node_features_0_1,
        )
        with self.timer.span("build_graph_target"):
            self.graph_target = Graph(vtk_mesh_target, seed=seed, **graph_kwargs)
        with self.timer.span("build_graph_source"):
            self.graph_source = Graph(vtk_mesh_source, seed=seed + 1, **graph_kwargs)
        # Fail fast on invalid correspondence configs (the reference lets a
        # typo'd type silently no-op and guards only the INITIAL type's
        # unequal-count hazard, at smoothing time — focusr.py:377-385; a
        # 'hungarian' FINAL match on unequal counts would silently return a
        # truncated, misaligned index vector).
        for _name, _val in (
            ("initial_correspondence_type", initial_correspondence_type),
            ("final_correspondence_type", final_correspondence_type),
        ):
            if _val not in ("kd", "hungarian"):
                raise ValueError(
                    f"{_name} must be 'kd' or 'hungarian', got {_val!r}"
                )
        if "hungarian" in (
            initial_correspondence_type,
            final_correspondence_type,
        ) and self.graph_source.n_points != self.graph_target.n_points:
            raise Exception(
                "If number vertices between source & target don't match, "
                "correspondence types must\nbe 'kd' and not 'hungarian'."
            )

        # The reference computes both spectra HERE (focusr.py:134-170); we
        # defer them to first use instead: align_maps() computes them via
        # _ensure_spectra(), while align_maps_pipeline() solves its spectra
        # inside the fused program and would otherwise pay both eigensolves
        # TWICE (the dominant pipeline cost) only to overwrite the ctor's
        # results unread.  Every public reader runs after one of those
        # entry points, so the attribute contract is unchanged.

        self.use_features_as_coords = use_features_as_coords

        # Result slots (names mirror reference ``focusr.py:174-212``).
        self.Q = None
        self.spectral_weights = None
        self.source_spectral_coords = None
        self.target_spectral_coords = None
        self.source_extra_features = None
        self.target_extra_features = None
        self.source_spectral_coords_after_rigid = None
        self.source_spectral_coords_b4_reg = None
        self.rigid_params = None
        self.non_rigid_params = None
        self.smoothed_target_coords = None
        self.source_projected_on_target = None
        self.weighted_avg_transformed_mesh = None
        self.nearest_neighbour_transformed_mesh = None
        self.corresponding_target_idx_for_each_source_pt = None
        self.nearest_neighbor_transformed_points = None
        self.weighted_avg_transformed_points = None
        self.average_mesh = None

    # ------------------------------------------------------------------
    # Point-set preparation (reference ``focusr.py:218-295``)
    # ------------------------------------------------------------------
    def append_features_to_spectral_coords(self):
        if self.verbose:
            print("Appending Extra Features to Spectral Coords")
        if self.graph_source.n_extra_features != self.graph_target.n_extra_features:
            raise Exception(
                "Number of extra features between"
                " target ({}) and source ({}) dont match!".format(
                    self.graph_target.n_extra_features,
                    self.graph_source.n_extra_features,
                )
            )
        src_cols, tgt_cols = [], []
        for graph, cols, coords in (
            (self.graph_source, src_cols, self.source_spectral_coords),
            (self.graph_target, tgt_cols, self.target_spectral_coords),
        ):
            ptp = jnp.max(coords) - jnp.min(coords)
            for f in graph.node_features:
                sm = graph.mean_filter_graph(
                    f, iterations=self.feature_smoothing_iterations
                )
                sm = sm - jnp.min(sm)
                sm = sm / jnp.max(sm)
                cols.append(ptp * sm)
        self.source_extra_features = jnp.stack(src_cols, axis=1)
        self.target_extra_features = jnp.stack(tgt_cols, axis=1)
        self.source_spectral_coords = jnp.concatenate(
            [self.source_spectral_coords, self.source_extra_features], axis=1
        )
        self.target_spectral_coords = jnp.concatenate(
            [self.target_spectral_coords, self.target_extra_features], axis=1
        )

    def append_pts_to_spectral_coords(self):
        if self.norm_physical_and_spectral is True:
            self.source_spectral_coords = jnp.concatenate(
                [self.source_spectral_coords, self.graph_source.normed_points], axis=1
            )
            self.target_spectral_coords = jnp.concatenate(
                [self.target_spectral_coords, self.graph_target.normed_points], axis=1
            )
        else:
            self.source_spectral_coords = jnp.concatenate(
                [
                    self.source_spectral_coords * self.graph_source.mean_pts_scale_range,
                    self.graph_source.points,
                ],
                axis=1,
            )
            self.target_spectral_coords = jnp.concatenate(
                [
                    self.target_spectral_coords * self.graph_target.mean_pts_scale_range,
                    self.graph_target.points,
                ],
                axis=1,
            )

    # ------------------------------------------------------------------
    # CPD registration (reference ``focusr.py:297-334``)
    # ------------------------------------------------------------------
    def register_target_to_source(self, reg_type="deformable"):
        src_idx = self.graph_source.get_list_rand_idxs(
            self.n_coords_spectral_registration
        )
        tgt_idx = self.graph_target.get_list_rand_idxs(
            self.n_coords_spectral_registration
        )
        X = self.source_spectral_coords[src_idx, :]
        Y = self.target_spectral_coords[tgt_idx, :]
        if reg_type == "deformable":
            reg = cpd.deformable_registration(
                X=X,
                Y=Y,
                num_eig=self.non_rigid_n_eigens,
                max_iterations=self.non_rigid_max_iterations,
                tolerance=self.non_rigid_tolerance,
                alpha=self.non_rigid_alpha,
                beta=self.non_rigid_beta,
                w=self.non_rigid_outlier_w,
                verbose=self.verbose,
                seed=self.seed,
            )
            _, self.non_rigid_params = reg.register()
        elif reg_type == "affine":
            # Affine in place of rigid: cycpd rigid rejects D > 3 dims
            # (reference comment ``focusr.py:318``).
            reg = cpd.affine_registration(
                X=X,
                Y=Y,
                max_iterations=self.rigid_reg_max_iterations,
                tolerance=self.rigid_tolerance,
            )
            _, self.rigid_params = reg.register()
        # Apply to ALL target points (reference ``focusr.py:334``).
        self.target_spectral_coords = reg.transform_point_cloud(
            self.target_spectral_coords
        )

    # ------------------------------------------------------------------
    # Correspondences (reference ``focusr.py:340-431``)
    # ------------------------------------------------------------------
    def get_hungarian_correspondence(self, target_pts, spectral_pts):
        # Euclidean (not squared) costs: the assignment objective must match
        # the reference's cdist + linear_sum_assignment (``focusr.py:340-349``)
        # — minimizing summed distances and summed squared distances give
        # different matchings.
        tic = time.time()
        dists = np.sqrt(
            np.asarray(
                pairwise_sq_dists(jnp.asarray(spectral_pts), jnp.asarray(target_pts))
            )
        )
        if self.verbose:
            print("time to get cdist: {}".format(time.time() - tic))
        tic = time.time()
        _, target_idx = linear_sum_assignment(dists)
        if self.verbose:
            print("time to linear sum assignment: {}".format(time.time() - tic))
        self.corresponding_target_idx_for_each_source_pt = np.asarray(target_idx)

    def get_kd_correspondence(self, target_pts, spectral_pts):
        _, idx = nn_query(jnp.asarray(target_pts), jnp.asarray(spectral_pts))
        self.corresponding_target_idx_for_each_source_pt = np.asarray(idx)

    def get_initial_correspondences(self):
        if self.initial_correspondence_type == "kd":
            self.get_kd_correspondence(
                self.target_spectral_coords, self.source_spectral_coords
            )
        elif self.initial_correspondence_type == "hungarian":
            self.get_hungarian_correspondence(
                self.target_spectral_coords, self.source_spectral_coords
            )

    def get_smoothed_correspondences(self):
        self.smoothed_target_coords = self.graph_target.mean_filter_graph(
            self.graph_target.points, iterations=self.graph_smoothing_iterations
        )
        if (
            self.smoothed_target_coords.shape[0] != self.graph_source.n_points
        ) and (self.initial_correspondence_type == "hungarian"):
            raise Exception(
                "If number vertices between source & target don't match, "
                "initial_correspondence_type must\nbe 'kd' and not 'hungarian'. "
                "Current type is: {}".format(self.initial_correspondence_type)
            )
        gathered = self.smoothed_target_coords[
            jnp.asarray(self.corresponding_target_idx_for_each_source_pt), :
        ]
        self.source_projected_on_target = self.graph_source.mean_filter_graph(
            gathered, iterations=self.projection_smooth_iterations
        )
        if self.final_correspondence_type == "kd":
            self.get_kd_correspondence(
                self.smoothed_target_coords, self.source_projected_on_target
            )
        elif self.final_correspondence_type == "hungarian":
            self.get_hungarian_correspondence(
                self.smoothed_target_coords, self.source_projected_on_target
            )

    def get_weighted_final_node_locations(self, n_closest_pts=3):
        """Inverse-distance-weighted average of the 3 closest smoothed-target
        points, with the exact-hit short-circuit (reference
        ``focusr.py:401-426``) — vectorized over all source points."""
        if self.smoothed_target_coords is None:
            raise ValueError(
                "weighted final locations need smoothed correspondences: run "
                "with smooth_correspondences=True (the reference crashes on "
                "a None KDTree here; we raise instead)"
            )
        dists, idxs = knn_query(
            jnp.asarray(self.smoothed_target_coords),
            jnp.asarray(self.source_projected_on_target),
            k=n_closest_pts,
        )
        tgt_xyz = self.graph_target.points[idxs]  # [N, k, 3]
        exact = dists <= 0.0  # [N, k]
        any_exact = jnp.any(exact, axis=1)
        first_exact = jnp.argmax(exact, axis=1)
        exact_xyz = jnp.take_along_axis(
            tgt_xyz, first_exact[:, None, None], axis=1
        )[:, 0, :]
        wts = 1.0 / jnp.maximum(dists, 1e-30)
        avg = jnp.sum(tgt_xyz * wts[:, :, None], axis=1) / jnp.sum(
            wts, axis=1, keepdims=True
        )
        self.weighted_avg_transformed_points = jnp.where(
            any_exact[:, None], exact_xyz, avg
        )

    def get_nearest_neighbour_final_node_locations(self):
        self.nearest_neighbor_transformed_points = self.graph_target.points[
            jnp.asarray(self.corresponding_target_idx_for_each_source_pt), :
        ]

    def get_average_shape(self, align_type="weighted"):
        """Midpoint mesh of source and its transformed positions
        (reference ``focusr.py:433-453``)."""
        if align_type == "nearest":
            new_xyz = self.graph_target.points[
                jnp.asarray(self.corresponding_target_idx_for_each_source_pt), :
            ]
            mean_xyz = (self.graph_source.points + new_xyz) / 2.0
        elif align_type == "weighted":
            mean_xyz = (
                self.weighted_avg_transformed_points + self.graph_source.points
            ) / 2.0
        else:
            raise ValueError(f"Unknown align_type {align_type!r}")
        self.average_mesh = self.graph_source.mesh.with_points(mean_xyz)
        return self.average_mesh

    def transfer_point_data(self, names=None, method="idw"):
        """Pull named target point_data onto source vertices through the
        computed correspondences (see ``pyfocusr_tpu.transfer``) — the
        measurement-comparison step the reference leaves to hand-written
        gathers of ``corresponding_target_idx_for_each_source_pt``.
        Call after :meth:`align_maps`; returns ``{name: [Ns] array}``."""
        from .transfer import transfer_point_data as _transfer

        if self.corresponding_target_idx_for_each_source_pt is None:
            raise RuntimeError("call align_maps() before transfer_point_data()")
        smoothed = (
            self.smoothed_target_coords
            if self.smoothed_target_coords is not None
            else self.graph_target.points
        )
        projected = (
            self.source_projected_on_target
            if self.source_projected_on_target is not None
            else self.graph_source.points
        )
        result = {
            "correspondences": np.asarray(
                self.corresponding_target_idx_for_each_source_pt
            ),
            "smoothed_target_coords": np.asarray(smoothed),
            "source_projected_on_target": np.asarray(projected),
        }
        return _transfer(self.graph_target.mesh, result, names, method)

    # ------------------------------------------------------------------
    # Spectral weighting (reference ``focusr.py:459-508``)
    # ------------------------------------------------------------------
    def calc_c_weighting_spectral(self):
        lam_max = jnp.maximum(
            self.graph_source.eig_vals[: self.n_spectral_features],
            self.graph_target.eig_vals[: self.n_spectral_features],
        )
        w = self.Q[: self.n_spectral_features] * lam_max
        sigma = jnp.mean(w)
        self.spectral_weights = jnp.exp(-(w**2) / (2.0 * sigma**2))

    def calc_weighted_spectral_coords(self):
        self.calc_c_weighting_spectral()
        self.source_spectral_coords = (
            self.graph_source.eig_vecs[:, : self.n_spectral_features]
            * self.spectral_weights[None, :]
        )
        self.target_spectral_coords = (
            self.graph_target.eig_vecs[:, : self.n_spectral_features]
            * self.spectral_weights[None, :]
        )

    def calc_spectral_coords(self):
        if self.get_weighted_spectral_coords is True:
            self.calc_weighted_spectral_coords()
        else:
            self.source_spectral_coords = self.graph_source.eig_vecs[
                :, : self.n_spectral_features
            ]
            self.target_spectral_coords = self.graph_target.eig_vecs[
                :, : self.n_spectral_features
            ]

    # ------------------------------------------------------------------
    # Main entry (reference ``focusr.py:514-570``)
    # ------------------------------------------------------------------
    def _pipeline_compatible(self):
        """The fused single-program pipeline covers this configuration?"""
        hungarian = (
            self.initial_correspondence_type == "hungarian"
            or self.final_correspondence_type == "hungarian"
        )
        return (
            not hungarian
            or self.graph_target.n_points == self.graph_source.n_points
        )

    def _pipeline_features_flag(self) -> bool:
        """use_features_as_coords for the fused pipeline.  Mirrors the
        reference's contract (``focusr.py:220-226``): a feature-count
        mismatch between target and source raises rather than silently
        dropping the feature-appending stage."""
        if not self.use_features_as_coords:
            return False
        if self.graph_source.n_extra_features != self.graph_target.n_extra_features:
            raise Exception(
                "Number of extra features between"
                " target ({}) and source ({}) dont match!".format(
                    self.graph_target.n_extra_features,
                    self.graph_source.n_extra_features,
                )
            )
        return self.graph_source.n_extra_features > 0

    def align_maps_pipeline(self, landmark_pairs=None):
        """Run the registration as ONE compiled XLA program
        (pipeline.register_pair) and populate the reference-named result
        attributes.  Much faster than the stage-by-stage path; only
        for configurations _pipeline_compatible() covers.

        ``landmark_pairs``: optional i32 [L, 2] known (source_vertex,
        target_vertex) correspondences guiding the registration (MAP CPD
        priors — see pipeline.register_pair)."""
        import jax

        from .pipeline import PipelineConfig, mesh_to_graph_arrays, register_pair

        if not self._pipeline_compatible():
            raise ValueError(
                "configuration not supported by the fused pipeline "
                "(hungarian needs equal vertex counts); use align_maps()"
            )
        cfg = PipelineConfig(
            icp_register_first=False,  # the constructor already pre-aligned
            initial_correspondence_type=self.initial_correspondence_type,
            final_correspondence_type=self.final_correspondence_type,
            use_features_as_coords=self._pipeline_features_flag(),
            feature_smoothing_iterations=self.feature_smoothing_iterations,
            include_points_as_features=self.include_points_as_features,
            norm_physical_and_spectral=self.norm_physical_and_spectral,
            n_spectral_features=self.n_spectral_features,
            n_extra_spectral=self.n_extra_spectral,
            n_coords_spectral_ordering=self.graph_target.rand_idxs.shape[0],
            n_coords_spectral_registration=self.n_coords_spectral_registration,
            get_weighted_spectral_coords=self.get_weighted_spectral_coords,
            rigid_before_non_rigid_reg=self.rigid_before_non_rigid_reg,
            rigid_reg_max_iterations=self.rigid_reg_max_iterations,
            rigid_tolerance=self.rigid_tolerance,
            non_rigid_max_iterations=self.non_rigid_max_iterations,
            non_rigid_tolerance=self.non_rigid_tolerance,
            non_rigid_alpha=self.non_rigid_alpha,
            non_rigid_beta=self.non_rigid_beta,
            non_rigid_n_eigens=self.non_rigid_n_eigens,
            non_rigid_outlier_w=self.non_rigid_outlier_w,
            smooth_correspondences=self.smooth_correspondences,
            graph_smoothing_iterations=self.graph_smoothing_iterations,
            projection_smooth_iterations=self.projection_smooth_iterations,
            target_eigenmap_as_reference=self.target_eigenmap_as_reference,
            use_features_in_graph=bool(
                self.graph_target.include_features_in_G_matrix
            ),
            include_features_in_adj_matrix=bool(
                self.graph_target.include_features_in_adj_matrix
            ),
            G_matrix_p_function=self.graph_target.G_matrix_p_function,
            feature_weights_diag=tuple(
                float(x)
                for x in np.diag(np.asarray(self.graph_target.feature_weights))
            )
            if self.graph_target.n_extra_features > 0
            else (),
        )
        with self.timer.span("pipeline_register_pair"):
            feats_t = (
                jnp.stack(self.graph_target.node_features, axis=1)
                if self.graph_target.n_extra_features > 0
                else None
            )
            feats_s = (
                jnp.stack(self.graph_source.node_features, axis=1)
                if self.graph_source.n_extra_features > 0
                else None
            )
            # Reuse the topologies the Graphs already built (the host-side
            # pass costs ~0.3 s native / ~10 s numpy per 240k-vertex mesh).
            tg = mesh_to_graph_arrays(
                self.graph_target.mesh,
                node_features=feats_t,
                topology=self.graph_target.topology,
            )
            sg = mesh_to_graph_arrays(
                self.graph_source.mesh,
                node_features=feats_s,
                topology=self.graph_source.topology,
            )
            if landmark_pairs is not None:
                landmark_pairs = jnp.asarray(landmark_pairs, jnp.int32)
            res = register_pair(
                tg, sg, cfg, jax.random.PRNGKey(self.seed),
                landmark_pairs=landmark_pairs,
            )
            jax.block_until_ready(res)

        # Populate the reference-named attributes (``focusr.py:174-212``).
        self.Q = res["Q"]
        self.graph_target.eig_vals = res["eig_vals_target"]
        self.graph_source.eig_vals = res["eig_vals_source"]
        self.graph_target.eig_vecs = res["eig_vecs_target"]
        self.graph_source.eig_vecs = res["eig_vecs_source_sorted"]
        self.source_spectral_coords = res["spectral_coords_source"]
        self.target_spectral_coords = res["spectral_coords_target"]
        self.source_spectral_coords_b4_reg = res["spectral_coords_source"]
        self.smoothed_target_coords = res["smoothed_target_coords"]
        self.source_projected_on_target = res["source_projected_on_target"]
        self.corresponding_target_idx_for_each_source_pt = np.asarray(
            res["correspondences"]
        )
        self.initial_correspondences = np.asarray(res["initial_correspondences"])
        self.nearest_neighbor_transformed_points = res["nearest_points"]
        self.weighted_avg_transformed_points = res["weighted_points"]
        if self.return_transformed_mesh:
            if self.return_average_final_points:
                self.get_source_mesh_transformed_weighted_avg()
            if self.return_nearest_final_points:
                self.get_source_mesh_transformed_nearest_neighbour()
        return self.corresponding_target_idx_for_each_source_pt

    def _ensure_spectra(self):
        """Compute the deferred constructor spectra on first use (see the
        constructor note; reference semantics ``focusr.py:134-170``)."""
        if self.graph_target.eig_vecs is None:
            with self.timer.span("spectrum_target"):
                self.graph_target.get_graph_spectrum()
        if self.graph_source.eig_vecs is None:
            with self.timer.span("spectrum_source"):
                self.graph_source.get_graph_spectrum()

    def align_maps(self):
        self._ensure_spectra()
        with self.timer.span("eigsort"):
            eig_map_sorter = eigsort(
                graph_target=self.graph_target,
                graph_source=self.graph_source,
                n_features=self.n_total_spectral_features,
                target_as_reference=self.target_eigenmap_as_reference,
            )
            self.Q = eig_map_sorter.sort_eigenmaps()
        self.calc_spectral_coords()

        if (self.graph_source.n_extra_features > 0) and (
            self.use_features_as_coords is True
        ):
            with self.timer.span("append_features"):
                self.append_features_to_spectral_coords()
        if self.include_points_as_features is True:
            self.append_pts_to_spectral_coords()

        self.source_spectral_coords_b4_reg = jnp.copy(self.source_spectral_coords)
        if self.verbose:
            print(
                "Number of features (including spectral) used for "
                "registartion: {}".format(self.target_spectral_coords.shape[1])
            )

        if self.rigid_before_non_rigid_reg is True:
            if self.verbose:
                print_header("Rigid Registration Beginning!")
            with self.timer.span("cpd_affine"):
                self.register_target_to_source(reg_type="affine")
            self.source_spectral_coords_after_rigid = jnp.copy(
                self.source_spectral_coords
            )
        if self.verbose:
            print_header("Non-Rigid (Deformable) Registration Beginning")
        with self.timer.span("cpd_deformable"):
            self.register_target_to_source("deformable")

        with self.timer.span("initial_correspondences"):
            self.get_initial_correspondences()
        # Kept for parity diagnostics (the reference overwrites this slot
        # during smoothing, focusr.py:368-399).
        self.initial_correspondences = np.asarray(
            self.corresponding_target_idx_for_each_source_pt
        )
        if self.verbose:
            print(
                "Number of unique correspondences: {}".format(
                    len(np.unique(self.corresponding_target_idx_for_each_source_pt))
                )
            )
        if self.smooth_correspondences is True:
            with self.timer.span("smoothed_correspondences"):
                self.get_smoothed_correspondences()
            if self.verbose:
                print(
                    "Number of unique correspondences after smoothing: {}".format(
                        len(
                            np.unique(
                                self.corresponding_target_idx_for_each_source_pt
                            )
                        )
                    )
                )
        if self.return_average_final_points is True:
            with self.timer.span("final_locations_weighted"):
                self.get_weighted_final_node_locations()
        if self.return_nearest_final_points is True:
            self.get_nearest_neighbour_final_node_locations()
        if self.return_transformed_mesh is True:
            if self.return_average_final_points is True:
                self.get_source_mesh_transformed_weighted_avg()
            if self.return_nearest_final_points is True:
                self.get_source_mesh_transformed_nearest_neighbour()

    # ------------------------------------------------------------------
    # Scalar setters for visualization (reference ``focusr.py:576-599``)
    # ------------------------------------------------------------------
    def set_transformed_source_scalars_to_corresp_target_idx(self):
        idx = jnp.asarray(
            self.corresponding_target_idx_for_each_source_pt, jnp.float32
        )
        if self.weighted_avg_transformed_mesh is not None:
            self.weighted_avg_transformed_mesh = (
                self.weighted_avg_transformed_mesh.with_point_data("corresp_idx", idx)
            )
        if self.nearest_neighbour_transformed_mesh is not None:
            self.nearest_neighbour_transformed_mesh = (
                self.nearest_neighbour_transformed_mesh.with_point_data(
                    "corresp_idx", idx
                )
            )

    def set_source_scalars_to_corresp_target_idx(self):
        self.graph_source.mesh = self.graph_source.mesh.with_point_data(
            "corresp_idx",
            jnp.asarray(self.corresponding_target_idx_for_each_source_pt, jnp.float32),
        )

    def set_target_scalars_to_corresp_target_idx(self):
        self.graph_target.mesh = self.graph_target.mesh.with_point_data(
            "corresp_idx",
            jnp.arange(self.graph_target.n_points, dtype=jnp.float32),
        )

    def set_all_mesh_scalars_to_corresp_target_idx(self):
        self.set_target_scalars_to_corresp_target_idx()
        self.set_source_scalars_to_corresp_target_idx()
        self.set_transformed_source_scalars_to_corresp_target_idx()

    # ------------------------------------------------------------------
    # Output meshes (reference ``focusr.py:605-625``)
    # ------------------------------------------------------------------
    def get_source_mesh_transformed_weighted_avg(self):
        self.weighted_avg_transformed_mesh = self.graph_source.mesh.with_points(
            self.weighted_avg_transformed_points
        )

    def get_source_mesh_transformed_nearest_neighbour(self):
        self.nearest_neighbour_transformed_mesh = self.graph_source.mesh.with_points(
            self.nearest_neighbor_transformed_points
        )

    # ------------------------------------------------------------------
    # Viewers (reference ``focusr.py:646-795``) — optional itkwidgets.
    # ------------------------------------------------------------------
    def view_aligned_spectral_coords(
        self,
        starting_spectral_coord=0,
        point_set_representations=("spheres",),
        point_set_colors=None,
        include_target_coordinates=True,
        include_non_rigid_aligned=True,
        include_rigid_aligned=False,
        include_unaligned=False,
        upscale_factor=10.0,
    ):
        from .utils.viz import view_point_sets

        sl = slice(starting_spectral_coord, starting_spectral_coord + 3)
        point_sets = []
        if include_target_coordinates:
            point_sets.append(upscale_factor * np.asarray(self.target_spectral_coords)[:, sl])
        if include_unaligned:
            point_sets.append(
                upscale_factor * np.asarray(self.source_spectral_coords_b4_reg)[:, sl]
            )
        if include_rigid_aligned:
            point_sets.append(
                upscale_factor
                * np.asarray(self.source_spectral_coords_after_rigid)[:, sl]
            )
        if include_non_rigid_aligned:
            point_sets.append(upscale_factor * np.asarray(self.source_spectral_coords)[:, sl])
        return view_point_sets(
            point_sets,
            representations=list(point_set_representations),
            colors=point_set_colors,
        )

    def view_meshes_colored_by_spectral_correspondences(
        self, x_translation=100, y_translation=0, z_translation=0, shadow=True
    ):
        from .utils.viz import view_meshes

        target = self.graph_target.mesh.with_point_data(
            "corresp_idx", jnp.arange(self.graph_target.n_points, dtype=jnp.float32)
        )
        target = target.with_points(
            target.points
            + jnp.asarray([x_translation, y_translation, z_translation], jnp.float32)
        )
        source = self.graph_source.mesh.with_point_data(
            "corresp_idx",
            jnp.asarray(self.corresponding_target_idx_for_each_source_pt, jnp.float32),
        )
        return view_meshes([source, target], shadow=shadow)

    def view_aligned_smoothed_spectral_coords(self):
        from .utils.viz import view_point_sets

        return view_point_sets(
            [self.smoothed_target_coords, self.source_projected_on_target]
        )

    def view_meshes(
        self,
        include_target=True,
        include_source=True,
        include_transformed_target=False,
        include_average=False,
        shadow=True,
    ):
        from .utils.viz import view_meshes

        geometries = []
        if include_target:
            geometries.append(self.graph_target.mesh)
        if include_source:
            geometries.append(self.graph_source.mesh)
        if include_transformed_target:
            if self.weighted_avg_transformed_mesh is not None:
                geometries.append(self.weighted_avg_transformed_mesh)
            elif self.nearest_neighbour_transformed_mesh is not None:
                geometries.append(self.nearest_neighbour_transformed_mesh)
            elif self.weighted_avg_transformed_points is not None:
                self.get_source_mesh_transformed_weighted_avg()
                geometries.append(self.weighted_avg_transformed_mesh)
            elif self.nearest_neighbor_transformed_points is not None:
                self.get_nearest_neighbour_final_node_locations()
                self.get_source_mesh_transformed_nearest_neighbour()
                geometries.append(self.nearest_neighbour_transformed_mesh)
            else:
                raise Exception(
                    "No corresponding points or meshes calculated. Try running: \n"
                    "reg.get_weighted_final_node_locations()\n"
                    "reg.get_nearest_neighbour_final_node_locations()\n"
                    "or try re-running with the flags: \n"
                    "return_average_final_points=True & return_transformed_mesh=True"
                )
        if include_average:
            if self.average_mesh is None:
                if self.weighted_avg_transformed_points is not None:
                    self.get_average_shape()
                elif self.nearest_neighbor_transformed_points is not None:
                    self.get_average_shape(align_type="nearest")
                else:
                    raise Exception(
                        "No xyz correspondences calculated can't get average! Try:\n"
                        "`reg.get_weighted_final_node_locations` or "
                        "`reg.get_nearest_neighbour_final_node_locations`"
                    )
            geometries.append(self.average_mesh)
        return view_meshes(geometries, shadow=shadow)

    def export_viewer_html(
        self,
        file_path,
        include_target=True,
        include_source=True,
        include_transformed=True,
        include_average=False,
        include_spectral_coords=False,
        color_by_correspondences=True,
        x_translation=0.0,
    ):
        """Write a standalone HTML/WebGL viewer of the registration result.

        The dependency-free analogue of the itkwidgets viewers
        (``view_meshes`` / ``view_meshes_colored_by_spectral_correspondences``,
        reference ``focusr.py:646-795``): one self-contained file renders the
        target, source, transformed-source (weighted-average when available,
        else nearest-neighbour) and optionally the average mesh and the
        aligned spectral point clouds — meshes colored by correspondence
        index so matched regions share colors across meshes.  Runs in any
        WebGL browser with no network access.  Returns the path written.
        """
        from .utils.html_viewer import export_html

        meshes, names = [], []
        shift = jnp.asarray([x_translation, 0.0, 0.0], jnp.float32)

        def _colored(mesh, idx_values):
            if not color_by_correspondences or idx_values is None:
                return mesh
            return mesh.with_point_data(
                "corresp_idx", jnp.asarray(idx_values, jnp.float32)
            )

        corr = self.corresponding_target_idx_for_each_source_pt
        if include_target:
            target = _colored(
                self.graph_target.mesh,
                jnp.arange(self.graph_target.n_points, dtype=jnp.float32),
            )
            if x_translation:
                target = target.with_points(target.points + shift)
            meshes.append(target)
            names.append("target")
        if include_source:
            meshes.append(_colored(self.graph_source.mesh, corr))
            names.append("source")
        if include_transformed:
            transformed = None
            if self.weighted_avg_transformed_mesh is not None:
                transformed = self.weighted_avg_transformed_mesh
            elif self.nearest_neighbour_transformed_mesh is not None:
                transformed = self.nearest_neighbour_transformed_mesh
            elif self.weighted_avg_transformed_points is not None:
                self.get_source_mesh_transformed_weighted_avg()
                transformed = self.weighted_avg_transformed_mesh
            elif self.nearest_neighbor_transformed_points is not None:
                self.get_source_mesh_transformed_nearest_neighbour()
                transformed = self.nearest_neighbour_transformed_mesh
            if transformed is not None:
                meshes.append(_colored(transformed, corr))
                names.append("source transformed")
        if include_average:
            # Same fallback ladder as view_meshes (reference focusr.py
            # lazy-recompute semantics): weighted points preferred, else the
            # nearest-neighbour locations build the average.
            if self.average_mesh is None:
                if self.weighted_avg_transformed_points is not None:
                    self.get_average_shape()
                elif self.nearest_neighbor_transformed_points is not None:
                    self.get_average_shape(align_type="nearest")
            if self.average_mesh is not None:
                meshes.append(self.average_mesh)
                names.append("average")

        point_sets, ps_names = [], []
        if include_spectral_coords:
            for label, coords in (
                ("target spectral", self.target_spectral_coords),
                ("source spectral (aligned)", self.source_spectral_coords),
            ):
                if coords is not None:
                    point_sets.append(10.0 * np.asarray(coords)[:, :3])
                    ps_names.append(label)

        return export_html(
            file_path,
            meshes=meshes,
            mesh_names=names,
            point_sets=point_sets,
            point_set_names=ps_names,
            title="FOCUSR registration",
        )

    @property
    def icp_transform(self):
        """The fitted ICP transform (s, R, t).  Unlike the reference
        (``focusr.py:797-807``, AttributeError when ``icp_register_first``
        was False — documented latent defect) this returns None in that case."""
        return self._icp_transform

    def registration_quality(self):
        """Quality readout for the completed registration (beyond-reference;
        see :func:`pyfocusr_tpu.metrics.registration_quality`): unique
        fraction, mean displacement (vs the post-ICP source), symmetric
        surface distance, Hausdorff.  Requires ``align_maps`` (or the
        pipeline variant) to have run."""
        if self.corresponding_target_idx_for_each_source_pt is None:
            raise ValueError("run align_maps() first")
        from .metrics import registration_quality

        return registration_quality(
            self.graph_target.points,
            self.graph_source.points,
            {
                "correspondences": (
                    self.corresponding_target_idx_for_each_source_pt
                ),
                "weighted_points": self.weighted_avg_transformed_points,
            },
        )
