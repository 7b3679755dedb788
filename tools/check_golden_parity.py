"""Measure end-to-end parity of the JAX pipeline against the reference
golden (tools/make_reference_golden.py).  Prints the numbers the parity
test (tests/test_golden_parity.py) gates on and that PARITY.md records.

Usage: python tools/check_golden_parity.py [kd|hungarian] [--class-path]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pyfocusr_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
import numpy as np

DATA = "/root/reference/data"
GOLD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tests", "goldens")


def compare(tag, ours, golden, target_pts):
    """Print every parity number for one run-vs-golden pair."""
    ev_t = np.asarray(ours["eig_vals_target"], np.float64)
    ev_t_g = golden["eig_vals_target"]
    rel = np.abs(ev_t - ev_t_g) / ev_t_g
    print(f"[{tag}] eig_vals_target rel err: {rel}")

    vecs = np.asarray(ours["eig_vecs_target"], np.float64)
    vecs_g = golden["eig_vecs_target"]
    cos = np.abs(
        (vecs * vecs_g).sum(0)
        / (np.linalg.norm(vecs, axis=0) * np.linalg.norm(vecs_g, axis=0))
    )
    print(f"[{tag}] target eigvec |cos| per column: {np.round(cos, 5)}")

    vecs_s = np.asarray(ours["eig_vecs_source_sorted"], np.float64)
    vecs_s_g = golden["eig_vecs_source_sorted"]
    cos_s = np.abs(
        (vecs_s * vecs_s_g).sum(0)
        / (np.linalg.norm(vecs_s, axis=0) * np.linalg.norm(vecs_s_g, axis=0))
    )
    print(f"[{tag}] sorted source eigvec |cos| per column: {np.round(cos_s, 5)}")

    corr = np.asarray(ours["correspondences"])
    corr_g = golden["correspondences"]
    agree = float((corr == corr_g).mean())
    # Near-agreement: distance between the two picked target points.
    d = np.linalg.norm(target_pts[corr] - target_pts[corr_g], axis=1)
    print(
        f"[{tag}] final corr: exact agreement {100*agree:.2f}%  "
        f"mean pick distance {d.mean():.4f} mm  p95 {np.percentile(d, 95):.4f} mm"
    )

    init = np.asarray(ours["initial_correspondences"])
    init_g = golden["initial_correspondences"]
    d_i = np.linalg.norm(target_pts[init] - target_pts[init_g], axis=1)
    print(
        f"[{tag}] initial corr: exact {100*float((init == init_g).mean()):.2f}%  "
        f"mean pick distance {d_i.mean():.4f} mm"
    )

    w = np.asarray(ours["weighted_points"], np.float64)
    w_g = golden["weighted_points"]
    dw = np.linalg.norm(w - w_g, axis=1)
    print(
        f"[{tag}] weighted final locations: mean |ours - golden| {dw.mean():.4f} mm"
        f"  p95 {np.percentile(dw, 95):.4f} mm  max {dw.max():.4f} mm"
    )
    uniq = len(np.unique(corr))
    uniq_g = len(np.unique(corr_g))
    print(f"[{tag}] unique final corr: ours {uniq}  golden {uniq_g}  / {len(corr)}")


def main():
    init_type = sys.argv[1] if len(sys.argv) > 1 else "kd"
    use_class = "--class-path" in sys.argv

    from pyfocusr_tpu import load_mesh

    target = load_mesh(f"{DATA}/target_mesh.vtk")
    source = load_mesh(f"{DATA}/source_mesh.vtk")
    golden = np.load(f"{GOLD}/reference_golden_5k_{init_type}.npz")
    tgt_pts = np.asarray(target.points, np.float64)

    common = dict(
        n_spectral_features=3,
        n_extra_spectral=3,
        get_weighted_spectral_coords=False,
        non_rigid_alpha=0.01,
        non_rigid_beta=50.0,
        non_rigid_n_eigens=100,
        non_rigid_max_iterations=300,
        rigid_before_non_rigid_reg=False,
        projection_smooth_iterations=1,
        graph_smoothing_iterations=600,
        n_coords_spectral_registration=1000,
    )

    if use_class:
        from pyfocusr_tpu.focusr import Focusr

        reg = Focusr(
            target, source,
            initial_correspondence_type=init_type,
            final_correspondence_type="kd",
            list_features_to_calc=[],
            n_coords_spectral_ordering=10000,
            norm_physical_and_spectral=True,
            seed=0,
            **common,
        )
        reg.align_maps()
        ours = {
            "eig_vals_target": reg.graph_target.eig_vals,
            "eig_vecs_target": reg.graph_target.eig_vecs,
            "eig_vecs_source_sorted": reg.graph_source.eig_vecs,
            "correspondences": reg.corresponding_target_idx_for_each_source_pt,
            "initial_correspondences": reg.initial_correspondences,
            "weighted_points": reg.weighted_avg_transformed_points,
        }
        compare(f"class/{init_type}", ours, golden, tgt_pts)
    else:
        from pyfocusr_tpu.pipeline import (
            PipelineConfig, mesh_to_graph_arrays, register_pair,
        )

        cfg = PipelineConfig(
            n_coords_spectral_ordering=10000,
            initial_correspondence_type=init_type,
            final_correspondence_type="kd",
            **common,
        )
        tg = mesh_to_graph_arrays(target)
        sg = mesh_to_graph_arrays(source)
        res = register_pair(tg, sg, cfg, jax.random.PRNGKey(0))
        jax.block_until_ready(res)
        compare(f"pipeline/{init_type}", res, golden, tgt_pts)


if __name__ == "__main__":
    main()
