#!/usr/bin/env python
"""Template serving: register many subjects against one prepared template.

The production pattern for cohort studies and registration services: the
template's eigensolve + coordinate smoothing are hoisted out of the
per-pair path (``pipeline.prepare_target``), computed once (or loaded from
a saved ``.npz``), and reused for every incoming subject, with outputs
bit-identical to ``register_pair``.

Two serving tiers, both fed by the same saved ``.npz``:

1. **Same-target serving** (this script's main loop): every subject is
   registered onto THE prepared mesh itself — bit-identical to the cold
   run, with the template's work done once.
2. **Class-template warm start** — the recommended default for serving
   *never-seen pairs* of a known anatomy class: the prepared mesh is
   only a representative of the class, and its converged eigensolver
   block seeds BOTH eigensolves of each new pair
   (``warm_block_from_prepared`` -> ``register_pair(warm_block=...)``).
   The fastest cold-pair path (bench ``class_template_15k``), with a
   residual safeguard that
   self-heals toward the full solve when the template is a poor match.
   Demonstrated here with ``--warm`` (registers subj2 onto subj1 warm-
   started from the template).

Usage:
    python examples/template_serving.py [--fast] template.vtk subj1.vtk ...
    python examples/template_serving.py --state prep.npz template.vtk s*.vtk
    python examples/template_serving.py --warm template.vtk s1.vtk s2.vtk

Equivalent CLI:
    pyfocusr-tpu register template.vtk s1.vtk s2.vtk --save-prepared prep.npz
    pyfocusr-tpu register s1.vtk s2.vtk --warm-from prep.npz   # tier 2
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from pyfocusr_tpu import load_mesh
from pyfocusr_tpu.pipeline import (
    PipelineConfig,
    load_prepared_target,
    mesh_to_graph_arrays,
    prepare_target,
    register_pair_prepared,
    save_prepared_target,
)


def main():
    args = sys.argv[1:]
    fast = "--fast" in args
    warm = "--warm" in args
    args = [a for a in args if a not in ("--fast", "--warm")]
    state_path = None
    if args and args[0] == "--state":
        state_path = args[1]
        args = args[2:]
    if len(args) < 2:
        print(__doc__)
        return 2
    template_path, subject_paths = args[0], args[1:]

    cfg = PipelineConfig(
        non_rigid_alpha=0.01,
        non_rigid_beta=50.0,
        non_rigid_max_iterations=30 if fast else 300,
        graph_smoothing_iterations=30 if fast else 600,
        projection_smooth_iterations=1,
        n_coords_spectral_ordering=2000 if fast else 10000,
        n_coords_spectral_registration=500 if fast else 1000,
    )
    key = jax.random.PRNGKey(0)
    tg = mesh_to_graph_arrays(load_mesh(template_path))

    t0 = time.perf_counter()
    if state_path and os.path.exists(state_path):
        prep = load_prepared_target(state_path, cfg)
        print(f"loaded prepared state from {state_path}")
    else:
        prep = prepare_target(tg, cfg, jax.random.split(key, 8)[0])
        jax.block_until_ready(prep["vecs"])
        if state_path:
            save_prepared_target(state_path, prep, cfg)
            print(f"saved prepared state to {state_path}")
    print(f"template preparation: {time.perf_counter() - t0:.2f}s")

    if warm:
        # Tier 2 — class-template warm start: register never-seen PAIRS
        # of the template's anatomy class, seeding both eigensolves from
        # the template's converged block (CLI: --warm-from prep.npz).
        from pyfocusr_tpu.pipeline import (
            register_pair,
            warm_block_from_prepared,
        )

        if len(subject_paths) < 2:
            print("--warm needs two subjects (a pair to register)")
            return 2
        wb = warm_block_from_prepared(prep, tg)
        pt = mesh_to_graph_arrays(load_mesh(subject_paths[0]))
        ps = mesh_to_graph_arrays(load_mesh(subject_paths[1]))
        t0 = time.perf_counter()
        res = register_pair(pt, ps, cfg, key, warm_block=wb)
        corr = np.asarray(res["correspondences"])
        print(
            f"{subject_paths[1]} -> {subject_paths[0]} (warm): "
            f"{time.perf_counter() - t0:.2f}s  unique "
            f"{len(np.unique(corr))}/{len(corr)}"
        )
        return 0

    for i, path in enumerate(subject_paths):
        sg = mesh_to_graph_arrays(load_mesh(path))
        t0 = time.perf_counter()
        res = register_pair_prepared(
            prep, tg, sg, cfg, jax.random.fold_in(key, i)
        )
        corr = np.asarray(res["correspondences"])
        dt = time.perf_counter() - t0
        print(
            f"{path}: {dt:.2f}s  unique correspondences "
            f"{len(np.unique(corr))}/{len(corr)}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
