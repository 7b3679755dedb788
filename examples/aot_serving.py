"""Production serving patterns: prepared templates, class-template warm
starts, and ahead-of-time compiled artifacts.

The reference is a research library (every ``Focusr`` instance recomputes
everything, ``focusr.py:134-170``); this example shows the three serving
tiers this rebuild adds, fastest first:

1. PREPARED TEMPLATE (same target for every pair): the target's
   eigensolve + smoothing computed once.
2. CLASS-TEMPLATE WARM START (never-seen pairs of one anatomy class):
   one prepared mesh seeds BOTH eigensolves of each new pair, at
   identical quality.
3. AOT ARTIFACTS (fleet startup): the fully-compiled executable
   serialized to disk — a fresh process runs it without compiling
   (`.jaxexec` format), or the portable StableHLO form for
   heterogeneous fleets.

Run: python examples/aot_serving.py  (CPU or GPU; sizes are small)
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from pyfocusr_tpu.pipeline import (
    PipelineConfig,
    mesh_to_graph_arrays,
    prepare_target,
    register_pair,
    register_pair_prepared,
    save_prepared_target,
    load_prepared_target,
    warm_block_from_prepared,
)


def make_meshes():
    """Three same-class synthetic bones: a template + a never-seen pair."""
    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests")
    )
    from conftest import _synthetic_bone

    return _synthetic_bone(3), _synthetic_bone(1), _synthetic_bone(2)


def main():
    template_mesh, src_mesh, tgt_mesh = make_meshes()
    cfg = PipelineConfig(
        non_rigid_max_iterations=100,
        graph_smoothing_iterations=300,
        projection_smooth_iterations=1,
        n_coords_spectral_registration=1000,
    )
    template = mesh_to_graph_arrays(template_mesh)
    sg = mesh_to_graph_arrays(src_mesh)
    tg = mesh_to_graph_arrays(tgt_mesh)
    key = jax.random.PRNGKey(0)

    # --- Tier 1: prepared template (register many subjects to ONE target).
    prep = prepare_target(tg, cfg, jax.random.split(key, 8)[0])
    with tempfile.TemporaryDirectory() as d:
        state = os.path.join(d, "template.npz")
        save_prepared_target(state, prep, cfg, target=tg)
        prep = load_prepared_target(state, cfg, target=tg)  # serving process
    res = register_pair_prepared(prep, tg, sg, cfg, key)
    print("prepared-template unique:",
          len(np.unique(np.asarray(res["correspondences"]))), "/", sg.n_points)

    # --- Tier 2: class-template warm start (BOTH meshes never seen).
    # Prepare the CLASS template once; its filtered eigensolver block
    # seeds both eigensolves of every new pair of that anatomy.
    prep_t = prepare_target(template, cfg, jax.random.PRNGKey(5))
    wb = warm_block_from_prepared(prep_t, template)
    t0 = time.perf_counter()
    warm = register_pair(tg, sg, cfg, key, warm_block=wb)
    jax.block_until_ready(warm)
    cold = register_pair(tg, sg, cfg, key)
    pick = np.linalg.norm(
        np.asarray(tg.points)[np.asarray(warm["correspondences"])]
        - np.asarray(tg.points)[np.asarray(cold["correspondences"])], axis=1)
    print(f"class-template warm: median pick distance vs cold = "
          f"{np.median(pick):.4f} mm (first warm call "
          f"{time.perf_counter()-t0:.1f}s incl. compile)")

    # --- Tier 3: AOT artifact (zero-compile fleet startup).
    from pyfocusr_tpu.utils.aot import (
        export_registration,
        load_registration,
    )

    with tempfile.TemporaryDirectory() as d:
        art = os.path.join(d, "reg.jaxexp")  # .jaxexec = compiled-executable
        export_registration(cfg, tg, sg, art)
        runner = load_registration(art, cfg=cfg, target=tg, source=sg)
        out = runner(tg, sg, key)
        same = np.array_equal(np.asarray(out["correspondences"]),
                              np.asarray(cold["correspondences"]))
        print("AOT artifact reproduces register_pair exactly:", bool(same))


if __name__ == "__main__":
    main()
