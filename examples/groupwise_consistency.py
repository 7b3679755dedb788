#!/usr/bin/env python
"""Groupwise registration with consistency diagnostics and map
synchronization — the beyond-reference workflow for registering a COHORT
where no single pair can be trusted blindly.

Pipeline demonstrated:
  1. symmetric pair registration (forward + backward fused; per-pair
     forward/backward-consistency and cycle-error diagnostics),
  2. all ordered pairs of a small cohort in ONE program,
  3. three-cycle transitivity error as the cohort-level quality metric,
  4. consensus map synchronization (repairs weak/corrupted maps), and
  5. spectral (functional-map) synchronization, flagging outlier maps.

Run on a GPU as-is, or on CPU:

    python tools/run_cpu.py examples/groupwise_consistency.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from pyfocusr_tpu import load_mesh
from pyfocusr_tpu.mesh import TriMesh
from pyfocusr_tpu.multires import decimate
from pyfocusr_tpu.parallel.groupwise import (
    cycle_consistency_error,
    register_all_pairs,
    register_pair_symmetric,
    synchronize_correspondences,
)
from pyfocusr_tpu.pipeline import PipelineConfig, mesh_to_graph_arrays

DATA = "/root/reference/data"


def make_cohort(base: TriMesh, n: int, seed: int = 0):
    """Synthetic cohort: smooth low-frequency warps of one bone mesh."""
    rng = np.random.default_rng(seed)
    pts = np.asarray(base.points, np.float32)
    center = pts.mean(axis=0)
    scale = np.ptp(pts, axis=0).mean()
    out = []
    for _ in range(n):
        amp = rng.uniform(0.01, 0.03)
        phase = rng.uniform(0, 2 * np.pi, 3)
        warp = 1.0 + amp * np.sin(2 * np.pi * (pts - center) / scale + phase)
        out.append(TriMesh((pts * warp).astype(np.float32), base.triangles))
    return out


def main():
    # Decimated bundled bone: the full workflow in seconds rather than
    # minutes (everything below scales to full resolution unchanged).
    base = decimate(load_mesh(f"{DATA}/target_mesh.vtk"), target_n=800)[0]
    cohort = make_cohort(base, n=3)
    cfg = PipelineConfig(
        n_coords_spectral_ordering=500,
        n_coords_spectral_registration=500,
        non_rigid_max_iterations=50,
        graph_smoothing_iterations=50,
        projection_smooth_iterations=5,
    )
    key = jax.random.PRNGKey(0)

    # --- 1. one symmetric pair, with its trust diagnostics ---
    tg = mesh_to_graph_arrays(cohort[0])
    sg = mesh_to_graph_arrays(cohort[1])
    t0 = time.time()
    sym = register_pair_symmetric(tg, sg, cfg, key)
    print(
        f"symmetric pair: fb_consistency {float(sym['fb_consistency']):.3f} mm, "
        f"cycle_error {float(sym['cycle_error']):.3f} mm "
        f"({time.time() - t0:.1f} s)"
    )

    # --- 2-3. all ordered pairs + transitivity metric ---
    t0 = time.time()
    corr, pair_index, _ = register_all_pairs(cohort, cfg, key)
    n_real = [m.n_points for m in cohort]
    points = [np.asarray(m.points) for m in cohort]
    err_raw = cycle_consistency_error(corr, points, n_real)
    print(
        f"all {len(pair_index)} ordered pairs in one program "
        f"({time.time() - t0:.1f} s); three-cycle error {err_raw:.3f} mm"
    )

    # --- 4. consensus synchronization ---
    corr_sync = synchronize_correspondences(corr, points, n_real)
    err_sync = cycle_consistency_error(corr_sync, points, n_real)
    print(f"after map synchronization: three-cycle error {err_sync:.3f} mm")
    assert err_sync <= err_raw + 1e-6, "synchronization must not hurt"

    # --- 5. spectral outlier flagging (corrupt one map on purpose) ---
    from pyfocusr_tpu.parallel.groupwise import synchronize_spectral

    graphs = [mesh_to_graph_arrays(m) for m in cohort]
    bad = corr.copy()
    rng = np.random.default_rng(1)
    bad[0, 1] = rng.permutation(bad[0, 1])  # scramble one map
    _, diag = synchronize_spectral(
        bad, graphs, cfg, jax.random.PRNGKey(2), n_basis=8
    )
    print("per-map spectral residuals (scrambled map should stand out):")
    # residuals[j, i] scores the map of mesh j (source) into mesh i.
    for (j, i), r in np.ndenumerate(diag["residuals"]):
        if i != j:
            tag = "  <-- scrambled" if (j, i) == (0, 1) else ""
            print(f"  map {j}->{i}: {r:.3f}{tag}")


if __name__ == "__main__":
    main()
