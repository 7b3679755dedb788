#!/usr/bin/env python
"""Cohort-to-template registration sharded over available devices.

Builds a synthetic cohort by warping the bundled target bone mesh, registers
the source bone (template) to every subject with one pair per device, and
writes the cohort mean shape plus the all-pairs surface-error matrix.

Run on a GPU as-is (1 device -> unsharded), or simulate 8 devices on CPU:

    python tools/run_cpu.py examples/cohort_registration.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from pyfocusr_tpu import load_mesh, save_mesh
from pyfocusr_tpu.mesh import TriMesh
from pyfocusr_tpu.parallel.cohort import (
    all_pairs_surface_errors,
    build_ssm_template,
    cohort_mean_shape,
    cohort_shape_modes,
    register_cohort,
    stack_graph_arrays,
)
from pyfocusr_tpu.pipeline import PipelineConfig, mesh_to_graph_arrays

DATA = "/root/reference/data"


def main(out_dir="cohort_output", n_subjects=8):
    os.makedirs(out_dir, exist_ok=True)
    template_mesh = load_mesh(f"{DATA}/source_mesh.vtk")
    base = load_mesh(f"{DATA}/target_mesh.vtk")
    pts = np.asarray(base.points)

    # Synthetic cohort: smoothly warped copies of the target bone.
    subjects = []
    for i in range(n_subjects):
        w = pts * (1.0 + 0.004 * (i + 1) * np.sin(0.05 * pts[:, [1]] + i))
        subjects.append(TriMesh(jnp.asarray(w, jnp.float32), base.triangles))

    template = mesh_to_graph_arrays(template_mesh)
    stacked = stack_graph_arrays([mesh_to_graph_arrays(m) for m in subjects])

    cfg = PipelineConfig(
        non_rigid_max_iterations=150,
        graph_smoothing_iterations=300,
        projection_smooth_iterations=1,
        n_coords_spectral_registration=1000,
    )
    n_dev = len(jax.devices())
    dev_mesh = None
    if n_dev > 1 and n_subjects % n_dev == 0:
        dev_mesh = Mesh(np.asarray(jax.devices()).reshape(n_dev), ("cohort",))
        print(f"sharding {n_subjects} subjects over {n_dev} devices")

    t0 = time.time()
    results, mean_shape = register_cohort(
        template, stacked, cfg, jax.random.PRNGKey(0), device_mesh=dev_mesh
    )
    jax.block_until_ready(mean_shape)
    print(f"cohort registration: {time.time() - t0:.1f}s for {n_subjects} subjects")

    mean_mesh = cohort_mean_shape(template_mesh, mean_shape)
    save_mesh(os.path.join(out_dir, "mean_shape.vtk"), mean_mesh)
    np.save(
        os.path.join(out_dir, "cohort_correspondences.npy"),
        np.asarray(results["correspondences"]),
    )

    # All-pairs surface-error matrix over a small subset (the resurrected
    # capability of the reference's dead pyfocusr/test.py).
    errs = all_pairs_surface_errors([template_mesh] + subjects[:3])
    np.save(os.path.join(out_dir, "all_pairs_surface_errors.npy"), errs)
    print("all-pairs surface errors (mm):")
    print(np.round(errs, 3))

    # Groupwise SSM: iterate the template onto the cohort mean shape, then
    # extract the statistical shape model (mean + principal modes).
    t0 = time.time()
    ssm_template, ssm_results, motions = build_ssm_template(
        subjects, cfg, jax.random.PRNGKey(1),
        n_iterations=3, device_mesh=dev_mesh,
    )
    print(f"template iteration: {time.time() - t0:.1f}s, "
          f"per-round motion (mm): {[round(m, 2) for m in motions]}")
    mean, modes, variances = cohort_shape_modes(
        ssm_results["weighted_points"], n_modes=min(4, n_subjects - 1)
    )
    save_mesh(os.path.join(out_dir, "ssm_template.vtk"), ssm_template)
    np.save(os.path.join(out_dir, "ssm_modes.npy"), np.asarray(modes))
    np.save(os.path.join(out_dir, "ssm_variances.npy"), np.asarray(variances))
    tot = float(jnp.sum(variances))
    print("mode variance fractions:",
          np.round(np.asarray(variances) / max(tot, 1e-30), 3))
    print("wrote results to", out_dir)


if __name__ == "__main__":
    _args = sys.argv[1:]
    if len(_args) > 1:
        _args[1] = int(_args[1])
    main(*_args)
