#!/usr/bin/env python
"""Run the five benchmark configurations below and report results.

    python tools/run_configs.py            # on the GPU
    python tools/run_cpu.py tools/run_configs.py   # CPU, 8 virtual devices

1. Spectral coords: weighted graph Laplacian + first-6 eigenvectors of
   data/source_mesh.vtk
2. eigsort sign-flip + eigenvector reordering between source/target
3. Spectral-coordinate KNN correspondence source->target
4. Full FOCUSR loop on the 15k-vertex bone meshes (spectral + CPD)
5. Batched cohort-to-template registration + average-mesh construction,
   sharded over available devices
"""

import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from pyfocusr_tpu import load_mesh
from pyfocusr_tpu.ops.knn import nn_query
from pyfocusr_tpu.pipeline import (
    PipelineConfig,
    _spectrum,
    mesh_to_graph_arrays,
    register_pair,
)
from pyfocusr_tpu.spectral.eigsort_jax import sort_eigenmaps_jit

DATA = "/root/reference/data"


def timed(label, fn):
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    print(f"  [{label}] {time.perf_counter() - t0:.3f}s steady")
    return out


def main():
    print("device:", jax.devices()[0], f"({len(jax.devices())} devices)")
    key = jax.random.PRNGKey(0)
    cfg = PipelineConfig()

    # --- Config 1: spectrum of source_mesh.vtk (k=6) ---
    print("config 1: weighted graph Laplacian + first-6 eigenvectors")
    src5 = mesh_to_graph_arrays(load_mesh(f"{DATA}/source_mesh.vtk"))
    tgt5 = mesh_to_graph_arrays(load_mesh(f"{DATA}/target_mesh.vtk"))
    spec = jax.jit(lambda g, k: _spectrum(g, 6, k, cfg)[:2])
    lams_s, vecs_s = timed("spectrum 5k", lambda: spec(src5, key))
    print("  eigenvalues:", np.round(np.asarray(lams_s), 6))

    # --- Config 2: eigsort between source/target ---
    print("config 2: eigsort sign-flip + reordering")
    lams_t, vecs_t = spec(tgt5, jax.random.PRNGKey(1))

    def normed(p):
        return (p - jnp.min(p, 0)) / (jnp.max(p, 0) - jnp.min(p, 0))

    es = jax.jit(
        lambda: sort_eigenmaps_jit(
            lams_t, lams_s, vecs_t, vecs_s,
            normed(tgt5.points), normed(src5.points), vecs_s,
        )
    )
    sorted_vecs, Q = timed("eigsort", es)
    print("  Q:", np.round(np.asarray(Q), 6))

    # --- Config 3: spectral KNN correspondence ---
    print("config 3: spectral-coordinate KNN correspondence")
    _, corr = timed(
        "knn corr", lambda: nn_query(vecs_t[:, :3], sorted_vecs[:, :3])
    )
    print(
        "  unique correspondences:",
        len(np.unique(np.asarray(corr))), "/", corr.shape[0],
    )

    # --- Config 4: full FOCUSR loop on the 15k pair ---
    print("config 4: full FOCUSR loop, 15k pair")
    tg = mesh_to_graph_arrays(load_mesh(f"{DATA}/target_mesh_15k.vtk"))
    sg = mesh_to_graph_arrays(load_mesh(f"{DATA}/source_mesh_15k.vtk"))
    cfg4 = PipelineConfig(
        n_coords_spectral_ordering=10000,
        n_coords_spectral_registration=1000,
        non_rigid_alpha=0.01, non_rigid_beta=50.0,
        non_rigid_max_iterations=300,
        graph_smoothing_iterations=600, projection_smooth_iterations=1,
    )
    res = timed(
        "register 15k", lambda: register_pair(tg, sg, cfg4, jax.random.PRNGKey(2))
    )
    c = np.asarray(res["correspondences"])
    print("  unique correspondences:", len(np.unique(c)), "/", len(c))

    # --- Config 5: sharded cohort + average mesh ---
    print("config 5: cohort-to-template, sharded")
    from jax.sharding import Mesh

    from pyfocusr_tpu.mesh import TriMesh
    from pyfocusr_tpu.parallel.cohort import register_cohort, stack_graph_arrays

    base = load_mesh(f"{DATA}/target_mesh.vtk")
    pts = np.asarray(base.points)
    n_dev = len(jax.devices())
    n_subj = max(n_dev, 2)
    subs = [
        TriMesh(
            jnp.asarray(
                pts * (1.0 + 0.004 * (i + 1) * np.sin(0.05 * pts[:, [1]])),
                jnp.float32,
            ),
            base.triangles,
        )
        for i in range(n_subj)
    ]
    stacked = stack_graph_arrays([mesh_to_graph_arrays(m) for m in subs])
    dev_mesh = (
        Mesh(np.asarray(jax.devices()).reshape(n_dev), ("cohort",))
        if n_dev > 1 and n_subj % n_dev == 0
        else None
    )
    cfg5 = PipelineConfig(
        non_rigid_max_iterations=100,
        graph_smoothing_iterations=100,
        projection_smooth_iterations=1,
        n_coords_spectral_registration=1000,
    )
    t0 = time.perf_counter()
    results, mean_shape = register_cohort(
        src5, stacked, cfg5, jax.random.PRNGKey(3), device_mesh=dev_mesh
    )
    jax.block_until_ready(mean_shape)
    print(
        f"  [{n_subj} subjects over {n_dev} device(s)] "
        f"{time.perf_counter() - t0:.1f}s (incl. compile); "
        f"mean shape {np.asarray(mean_shape).shape}, finite="
        f"{bool(np.all(np.isfinite(np.asarray(mean_shape))))}"
    )


if __name__ == "__main__":
    main()
