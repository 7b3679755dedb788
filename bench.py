#!/usr/bin/env python
"""Headline benchmark: full source->target FOCUSR registration of the bundled
15k-vertex bone-mesh pair on one accelerator.

Prints ONE JSON line:
  {"metric": ..., "value": seconds, "unit": "s", "vs_baseline": speedup}

Baseline: a target of 5 s end-to-end on one accelerator (the reference
publishes no numbers of its own — SURVEY §6).  vs_baseline =
baseline_seconds / measured_seconds, so > 1.0 beats the target.

Method: one warm-up run compiles the single-program jit pipeline (the
persistent compilation cache makes this cheap across invocations), then the
timed run measures steady-state device execution with a fresh PRNG key —
the production regime for registering mesh cohorts of a common size class.
The measured span covers the ENTIRE registration (ICP pre-alignment,
Laplacian spectra for both meshes, eigsort, CPD affine+deformable,
correspondence search, smoothing, final locations).

Wall-clock instrumentation: every pre-run phase is timed separately:

  backend_init_s    first contact with the device runtime (one trivial
                    device op), BEFORE any mesh work
  mesh_parse_s      host-side VTK parse + topology extraction only
  device_transfer_s host->device transfer of the graph arrays
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from pyfocusr_tpu import load_mesh
from pyfocusr_tpu.pipeline import PipelineConfig, mesh_to_graph_arrays, register_pair
from pyfocusr_tpu.utils.compile_cache import enable_compile_cache

DATA = "/root/reference/data"
BASELINE_SECONDS = 5.0  # target: <5 s on one accelerator


def main():
    enable_compile_cache()
    diag = {}

    # --- Phase 0: backend init (one trivial device op, timed) ---
    t0 = time.perf_counter()
    dev = jax.devices()[0]
    x = jax.device_put(np.ones((8, 8), np.float32))
    np.asarray(x @ x)  # round-trip through the device
    diag["device"] = str(dev)
    diag["backend_init_s"] = round(time.perf_counter() - t0, 3)

    # --- Phase 1: host-side mesh parse + topology (no device work) ---
    t0 = time.perf_counter()
    target = load_mesh(f"{DATA}/target_mesh_15k.vtk")
    source = load_mesh(f"{DATA}/source_mesh_15k.vtk")
    diag["mesh_parse_s"] = round(time.perf_counter() - t0, 3)

    # --- Phase 2: device transfer of graph arrays ---
    t0 = time.perf_counter()
    tg = mesh_to_graph_arrays(target)
    sg = mesh_to_graph_arrays(source)
    jax.block_until_ready((tg.points, sg.points))
    diag["device_transfer_s"] = round(time.perf_counter() - t0, 3)

    # Notebook-equivalent configuration (15k pair => 'kd' correspondences).
    cfg = PipelineConfig(
        n_spectral_features=3,
        n_extra_spectral=3,
        get_weighted_spectral_coords=False,
        non_rigid_alpha=0.01,
        non_rigid_beta=50.0,
        non_rigid_n_eigens=100,
        non_rigid_max_iterations=300,
        n_coords_spectral_ordering=10000,
        n_coords_spectral_registration=1000,
        graph_smoothing_iterations=600,
        projection_smooth_iterations=1,
    )

    # --- Phase 3: warm-up run (compile; persistent-cache hit when warm) ---
    t0 = time.perf_counter()
    jax.block_until_ready(register_pair(tg, sg, cfg, jax.random.PRNGKey(0)))
    diag["first_run_s"] = round(time.perf_counter() - t0, 3)

    # --- Phase 4: timed steady-state runs, each ending with a host
    # transfer of an output array. ---
    times = []
    res = None
    for i in range(5):
        t0 = time.perf_counter()
        res = register_pair(tg, sg, cfg, jax.random.PRNGKey(i + 1))
        jax.block_until_ready(res)
        _ = np.asarray(res["correspondences"])
        times.append(time.perf_counter() - t0)
    t_run = float(np.min(times))
    diag["runs_s"] = [round(t, 3) for t in times]
    diag["runs_median_s"] = round(float(np.median(times)), 3)

    # --- Quality metrics.  Guarded like the scale diagnostics below: once
    # the timed runs are in, a failure in a later phase must not kill the
    # bench. ---
    try:
        from pyfocusr_tpu.metrics import registration_quality

        q = registration_quality(target, source, res)
        diag["unique_correspondences"] = (
            f"{q['n_unique_correspondences']}/{q['n_source_points']}"
        )
        for k in (
            "unique_fraction",
            "mean_displacement_mm",
            "symmetric_surface_dist_mm",
            "hausdorff_mm",
        ):
            diag[k] = q[k]
    except Exception as e:
        print(f"quality diagnostic failed: {e}", file=sys.stderr)
        diag["quality_error"] = f"{type(e).__name__}: {e}"[:200]

    # --- Standalone k=6 eigensolve time ---
    from functools import partial

    from pyfocusr_tpu.pipeline import _spectrum

    @partial(jax.jit, static_argnames=("k", "cfg"))
    def eigensolve_both(gt, gs, k, key, cfg):
        # ONE program for both meshes — how the fused pipeline runs them.
        lt, vt, _ = _spectrum(gt, k, key, cfg)
        ls, vs, _ = _spectrum(gs, k, jax.random.fold_in(key, 1), cfg)
        return lt, vt, ls, vs

    try:
        eig_times = []
        _ = jax.block_until_ready(
            eigensolve_both(tg, sg, cfg.n_total, jax.random.PRNGKey(9), cfg)
        )  # compile
        for i in range(5):
            t0 = time.perf_counter()
            out = eigensolve_both(
                tg, sg, cfg.n_total, jax.random.PRNGKey(i), cfg
            )
            jax.block_until_ready(out)
            _ = np.asarray(out[0])
            eig_times.append(time.perf_counter() - t0)
        diag["eigensolve_k6_both_meshes_s"] = round(float(np.min(eig_times)), 4)
        diag["eigensolve_runs_s"] = [round(t, 4) for t in eig_times]
    except Exception as e:
        print(f"eigensolve diagnostic failed: {e}", file=sys.stderr)
        diag["eigensolve_k6_both_meshes_s"] = None

    # --- Eigensolve step + solve-level budget.  Times R in-program
    # repetitions with a serializing carry against an empty loop of the
    # same trip count, so per-call latency cancels exactly, and reports
    # the SOLVE-level budget (fixed overhead vs per-chunk cost) from a
    # chunks sweep. ---
    if os.environ.get("BENCH_SKIP_ROOFLINE") != "1":
        try:
            from pyfocusr_tpu.ops import graph_ops as _go
            from pyfocusr_tpu.ops.patch_dense import patch_filter_factory

            mask = tg.valid_mask
            w_e = _go.edge_weights(tg.points, tg.neighbors, tg.nbr_mask)
            ov = tg.overflow
            ov_w = _go.overflow_weights(tg.points, ov)
            d_v = _go.degree_vector(w_e, ov, ov_w)
            g_v = jnp.where(mask > 0, (d_v + _go.DEGREE_EPS) ** -1, 1.0)
            s_v = jnp.sqrt(g_v)
            sw = s_v[:, None] * w_e * s_v[tg.neighbors]
            sd = s_v * s_v * d_v * mask
            ov_sw = (ov_w * s_v[ov[:, 0]] * s_v[ov[:, 1]]
                     if ov.shape[0] > 0 else jnp.zeros((0,), sw.dtype))
            N, D = tg.neighbors.shape
            C = cfg.eig_wide_block
            lam_rep = 2.0  # representative window scalars (perf-neutral)
            T0 = jax.random.normal(jax.random.PRNGKey(0), (N, C))
            R_STEPS = 200

            def _min_reps(fn, *a, reps=7):
                jax.block_until_ready(fn(*a))  # compile/warm outside
                ts = []
                for i in range(reps):
                    # Vary the input per rep so no layer can serve a
                    # cached result.  The scale does not change the op mix.
                    ai = (a[0] * (1.0 + 1e-6 * i),) + a[1:]
                    t0 = time.perf_counter()
                    jax.block_until_ready(fn(*ai))
                    ts.append(time.perf_counter() - t0)
                return float(np.min(ts))

            def _amortized_step(op):
                def body(t):
                    y = op(t)
                    return y / jnp.maximum(jnp.max(jnp.abs(y)), 1e-30)

                f = jax.jit(lambda T: jax.lax.fori_loop(
                    0, R_STEPS, lambda i, t: body(t), T))
                e = jax.jit(lambda T: jax.lax.fori_loop(
                    0, R_STEPS, lambda i, t: t, T))
                return (_min_reps(f, T0) - _min_reps(e, T0)) / R_STEPS

            def _ell_op(T):
                y = sd[:, None] * T - jnp.einsum(
                    "nd,ndc->nc", sw, T[tg.neighbors]
                )
                if ov.shape[0] > 0:
                    y = y.at[ov[:, 0]].add(-ov_sw[:, None] * T[ov[:, 1]])
                return y

            ell_step_s = _amortized_step(_ell_op)
            entry = {
                "ell_shape": [int(N), int(D), int(C)],
                "ell_step_us": round(ell_step_s * 1e6, 1),
                "steps_per_solve": int(
                    cfg.eig_wide_chunks * cfg.eig_wide_degree
                ),
            }
            if tg.patch_plan is not None:
                pf = patch_filter_factory(tg.patch_plan, sw, ov_sw, sd, mask)
                patch_step_s = _amortized_step(pf(lam_rep / 2, lam_rep / 2))
                entry["patch_step_us"] = round(patch_step_s * 1e6, 1)
                entry["patch_speedup_vs_ell"] = round(
                    ell_step_s / patch_step_s, 2
                )
                step_s = patch_step_s
            else:
                step_s = ell_step_s
            # Bytes the ELL op moves per step (the patch op mixes dense
            # blocks and gathers, so one stream does not describe it).
            bytes_step = 4.0 * (N * D * C + 2 * N * C + N * (D + 2))
            entry["ell_issued_GB_per_s"] = round(bytes_step / ell_step_s / 1e9, 1)
            entry["filter_total_ms_per_solve"] = round(
                step_s * cfg.eig_wide_chunks * cfg.eig_wide_degree * 1e3, 2
            )
            diag["eig_filter_roofline"] = entry

            # Solve-level budget: per-chunk cost and fixed overhead from
            # a chunks sweep of the REAL jitted solve (min-of-reps each,
            # keys varied per rep).
            from pyfocusr_tpu.pipeline import _spectrum as _spec

            def _solve_chunks(c):
                f = jax.jit(lambda g, k: _spec(g, 6, k, cfg, chunks=c)[0])
                jax.block_until_ready(f(tg, jax.random.PRNGKey(99)))
                ts = []
                for i in range(5):
                    t0 = time.perf_counter()
                    jax.block_until_ready(f(tg, jax.random.PRNGKey(i)))
                    ts.append(time.perf_counter() - t0)
                return float(np.min(ts))

            t5 = _solve_chunks(cfg.eig_wide_chunks)
            t1 = _solve_chunks(1)
            per_chunk = (t5 - t1) / max(cfg.eig_wide_chunks - 1, 1)
            diag["eig_solve_budget"] = {
                "solve_ms": round(t5 * 1e3, 2),
                "per_chunk_ms": round(per_chunk * 1e3, 2),
                "fixed_ms": round((t1 - per_chunk) * 1e3, 2),
                "filter_ms_model": round(
                    step_s * cfg.eig_wide_chunks * cfg.eig_wide_degree * 1e3,
                    2,
                ),
            }
        except Exception as e:
            print(f"roofline diagnostic failed: {e}", file=sys.stderr)
            diag["eig_filter_roofline"] = {"error": f"{type(e).__name__}: {e}"[:200]}

    # --- Class-template warm start: BOTH eigensolves
    # of a never-seen pair seeded from a prepared template of the same
    # shape class (here: the 5k target mesh standing in as the class
    # template for the 15k pair — different resolution AND subject).
    # Reports the warm end-to-end time plus agreement vs the cold run. ---
    if os.environ.get("BENCH_SKIP_WARMPAIR") != "1":
        try:
            from pyfocusr_tpu.pipeline import (
                prepare_target as _prep_t,
                warm_block_from_prepared,
            )

            t5w = load_mesh(f"{DATA}/target_mesh.vtk")
            tg5w = mesh_to_graph_arrays(t5w)
            prepw = _prep_t(tg5w, cfg, jax.random.PRNGKey(11))
            wb = warm_block_from_prepared(prepw, tg5w)
            rw = register_pair(tg, sg, cfg, jax.random.PRNGKey(1),
                               warm_block=wb)
            jax.block_until_ready(rw)  # compile
            wt = []
            for i in range(3):
                t0 = time.perf_counter()
                rw = register_pair(tg, sg, cfg, jax.random.PRNGKey(i + 1),
                                   warm_block=wb)
                jax.block_until_ready(rw)
                _ = np.asarray(rw["correspondences"])[:4]
                wt.append(time.perf_counter() - t0)
            cw = np.asarray(rw["correspondences"])  # warm, key 3
            rc = register_pair(tg, sg, cfg, jax.random.PRNGKey(3))
            cc = np.asarray(rc["correspondences"])  # cold, same key
            tp = np.asarray(tg.points)
            pickd = np.linalg.norm(tp[cw] - tp[cc], axis=1)
            from pyfocusr_tpu.metrics import registration_quality as _rq

            qw = _rq(target, source, rw)
            diag["class_template_15k"] = {
                "seconds": round(float(np.min(wt)), 4),
                "runs_s": [round(t, 3) for t in wt],
                "unique_fraction": qw["unique_fraction"],
                "symmetric_surface_dist_mm": qw["symmetric_surface_dist_mm"],
                "median_pick_dist_vs_cold_mm": round(
                    float(np.median(pickd)), 4
                ),
                "mean_pick_dist_vs_cold_mm": round(float(pickd.mean()), 4),
            }
        except Exception as e:
            print(f"class-template diagnostic failed: {e}", file=sys.stderr)
            diag["class_template_15k"] = {"error": f"{type(e).__name__}: {e}"[:200]}

    # --- Template-serving path: prepare_target hoists the target eigensolve
    # + smoothing; measures the steady-state per-pair cost when sweeping
    # many subjects against one template (docs/api.md). ---
    try:
        from pyfocusr_tpu.pipeline import prepare_target, register_pair_prepared

        prep = prepare_target(tg, cfg, jax.random.split(jax.random.PRNGKey(1), 8)[0])
        jax.block_until_ready(prep["vecs"])
        r = register_pair_prepared(prep, tg, sg, cfg, jax.random.PRNGKey(1))
        _ = np.asarray(r["correspondences"])[:4]  # compile + fence
        p_times = []
        for i in range(3):
            t0 = time.perf_counter()
            r = register_pair_prepared(prep, tg, sg, cfg, jax.random.PRNGKey(i + 1))
            _ = np.asarray(r["correspondences"])[:4]
            p_times.append(time.perf_counter() - t0)
        diag["prepared_template_15k_s"] = round(float(np.min(p_times)), 4)
    except Exception as e:
        print(f"prepared-template diagnostic failed: {e}", file=sys.stderr)
        diag["prepared_template_15k_s"] = None

    # --- AOT serving: export the fused 15k program once, then measure what
    # loading the artifact costs up to the first completed registration. ---
    if os.environ.get("BENCH_SKIP_AOT") != "1":
        try:
            from pyfocusr_tpu.utils.aot import (
                export_registration,
                load_registration,
            )

            aot_dir = os.environ.get("PYFOCUSR_AOT_DIR", "/root/.pyfocusr_aot")
            os.makedirs(aot_dir, exist_ok=True)
            art = os.path.join(aot_dir, "reg_15k.jaxexp")
            t0 = time.perf_counter()
            export_registration(cfg, tg, sg, art)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            runner = load_registration(art, cfg=cfg, target=tg, source=sg)
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            r = runner(tg, sg, jax.random.PRNGKey(2))
            _ = np.asarray(r["correspondences"])[:4]
            first_call_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            r = runner(tg, sg, jax.random.PRNGKey(3))
            _ = np.asarray(r["correspondences"])[:4]
            steady_s = time.perf_counter() - t0
            diag["aot_serving_15k"] = {
                "artifact_mb": round(os.path.getsize(art) / 1e6, 1),
                "export_s": round(export_s, 3),
                "load_s": round(load_s, 3),
                "first_call_s": round(first_call_s, 3),
                "steady_s": round(steady_s, 4),
            }
            # EXECUTABLE-format artifact (zero-compile serving): load the
            # compiled XLA executable back and run it in this process (a
            # second JAX process could not open the card this one holds).
            from pyfocusr_tpu.utils.aot import (
                export_registration_exec,
                load_registration_exec,
            )

            arte = os.path.join(aot_dir, "reg_15k.jaxexec")
            t0 = time.perf_counter()
            export_registration_exec(cfg, tg, sg, arte)
            exe_export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            run_exe = load_registration_exec(arte)
            r = run_exe(tg, sg, jax.random.PRNGKey(7))
            _ = np.asarray(r["correspondences"])[:4]
            exe_first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            r = run_exe(tg, sg, jax.random.PRNGKey(8))
            _ = np.asarray(r["correspondences"])[:4]
            exe = {"artifact_mb": round(os.path.getsize(arte) / 1e6, 1),
                   "export_s": round(exe_export_s, 3),
                   "load_and_first_call_s": round(exe_first_s, 3),
                   "steady_s": round(time.perf_counter() - t0, 4)}
            diag["aot_serving_15k"]["executable_format"] = exe
        except Exception as e:
            print(f"aot diagnostic failed: {e}", file=sys.stderr)
            diag["aot_serving_15k"] = {"error": f"{type(e).__name__}: {e}"[:200]}

    # --- 5k pair with 'hungarian' (the reference notebook's actual config;
    # exact 5000x5000 assignment ON DEVICE via sinkhorn_jv_lap) ---
    cfg5 = PipelineConfig(
        n_spectral_features=3,
        n_extra_spectral=3,
        get_weighted_spectral_coords=False,
        non_rigid_alpha=0.01,
        non_rigid_beta=50.0,
        non_rigid_n_eigens=100,
        non_rigid_max_iterations=300,
        n_coords_spectral_ordering=10000,
        n_coords_spectral_registration=1000,
        graph_smoothing_iterations=600,
        projection_smooth_iterations=1,
        initial_correspondence_type="hungarian",
    )
    try:
        t5 = load_mesh(f"{DATA}/target_mesh.vtk")
        s5 = load_mesh(f"{DATA}/source_mesh.vtk")
        tg5, sg5 = mesh_to_graph_arrays(t5), mesh_to_graph_arrays(s5)
        res5 = register_pair(tg5, sg5, cfg5, jax.random.PRNGKey(0))
        jax.block_until_ready(res5)
        h_times = []
        for i in (1, 2, 3):
            t0 = time.perf_counter()
            res5 = register_pair(tg5, sg5, cfg5, jax.random.PRNGKey(i))
            jax.block_until_ready(res5)
            _ = np.asarray(res5["correspondences"])
            h_times.append(time.perf_counter() - t0)
        diag["hungarian_5k_end_to_end_s"] = round(float(np.min(h_times)), 4)
        diag["hungarian_5k_runs_s"] = [round(t, 3) for t in h_times]
    except Exception as e:  # transient device faults must not kill the bench
        print(f"hungarian diagnostic failed: {e}", file=sys.stderr)
        diag["hungarian_5k_end_to_end_s"] = None

    # --- Scale diagnostics: the numbers behind the beyond-reference
    # claims.  Each guarded: a failure records the error instead of
    # killing the headline bench. ---

    # (a) >=100k-vertex multi-resolution registration (the bundled 15k pair
    # midpoint-subdivided twice -> ~240k vertices each).
    if os.environ.get("BENCH_SKIP_MULTIRES") != "1":
        try:
            from pyfocusr_tpu.multires import register_pair_multires, subdivide

            t_big = subdivide(subdivide(target))
            s_big = subdivide(subdivide(source))
            mcfg = PipelineConfig(
                get_weighted_spectral_coords=False,
                non_rigid_alpha=0.01,
                non_rigid_beta=50.0,
                non_rigid_max_iterations=300,
                rigid_before_non_rigid_reg=False,
                projection_smooth_iterations=1,
                graph_smoothing_iterations=600,
                n_coords_spectral_ordering=10000,
                n_coords_spectral_registration=1000,
            )
            t0 = time.perf_counter()
            fine, _coarse = register_pair_multires(
                t_big, s_big, mcfg, jax.random.PRNGKey(0), coarse_n=12000
            )
            jax.block_until_ready(fine)
            t_mr_cold = time.perf_counter() - t0
            # Warm passes: same shapes, compiled programs cached — the
            # steady-state per-pair cost for a cohort of this size class.
            # TWO runs, MIN reported.
            mr_times = []
            for mi in (1, 2):
                t0 = time.perf_counter()
                fine, _coarse = register_pair_multires(
                    t_big, s_big, mcfg, jax.random.PRNGKey(mi), coarse_n=12000
                )
                jax.block_until_ready(fine)
                mcorr = np.asarray(fine["correspondences"])
                mr_times.append(time.perf_counter() - t0)
            t_mr = float(np.min(mr_times))
            from pyfocusr_tpu.metrics import surface_distance

            m_mean, _m_haus = surface_distance(fine["weighted_points"], t_big)
            diag["multires_240k"] = {
                "n_vertices": int(t_big.n_points),
                "seconds": round(t_mr, 3),
                "runs_s": [round(t, 3) for t in mr_times],
                "first_run_seconds": round(t_mr_cold, 3),
                "unique_fraction": round(
                    len(np.unique(mcorr)) / mcorr.shape[0], 4
                ),
                "symmetric_surface_dist_mm": round(m_mean, 4),
            }
        except Exception as e:
            print(f"multires diagnostic failed: {e}", file=sys.stderr)
            diag["multires_240k"] = {"error": f"{type(e).__name__}: {e}"[:200]}

    # (b) cohort throughput: 8 subjects on ONE device (the 5k source
    # jittered 8 ways, registered to the 5k target in a single program).
    if os.environ.get("BENCH_SKIP_COHORT") != "1":
        try:
            from pyfocusr_tpu.parallel.cohort import register_cohort, stack_graph_arrays

            # Load the 5k pair here too: the hungarian block above may have
            # failed before creating t5/s5/tg5.
            t5 = load_mesh(f"{DATA}/target_mesh.vtk")
            s5 = load_mesh(f"{DATA}/source_mesh.vtk")
            tg5 = mesh_to_graph_arrays(t5)
            rng = np.random.default_rng(0)
            cohort = []
            base = np.asarray(s5.points, np.float32)
            for b in range(8):
                jit_pts = base + rng.normal(scale=0.3, size=base.shape).astype(
                    np.float32
                )
                cohort.append(
                    mesh_to_graph_arrays(s5.with_points(jit_pts))
                )
            targets = stack_graph_arrays(cohort)
            ccfg = PipelineConfig(
                non_rigid_max_iterations=100,
                n_coords_spectral_ordering=5000,
                n_coords_spectral_registration=1000,
                graph_smoothing_iterations=300,
                projection_smooth_iterations=1,
            )
            cres, _ = register_cohort(tg5, targets, ccfg, jax.random.PRNGKey(0))
            jax.block_until_ready(cres)  # compile
            co_times = []
            for ci in (1, 2, 3):
                t0 = time.perf_counter()
                cres, _ = register_cohort(
                    tg5, targets, ccfg, jax.random.PRNGKey(ci)
                )
                jax.block_until_ready(cres)
                _ = np.asarray(cres["correspondences"])[:1]
                co_times.append(time.perf_counter() - t0)
            t_cohort = float(np.min(co_times))
            ccorr = np.asarray(cres["correspondences"])
            uniq_c = [
                len(np.unique(ccorr[b])) / ccorr.shape[1]
                for b in range(ccorr.shape[0])
            ]
            diag["cohort_8x5k_1chip"] = {
                "seconds": round(t_cohort, 3),
                "pairs_per_s": round(8.0 / t_cohort, 3),
                "unique_fraction_min": round(min(uniq_c), 4),
            }
        except Exception as e:
            print(f"cohort diagnostic failed: {e}", file=sys.stderr)
            diag["cohort_8x5k_1chip"] = {"error": f"{type(e).__name__}: {e}"[:200]}

    # (c) feature-weighted 15k pair: the F in FOCUSR at full scale — the
    # bundled thickness scalar appended as a registration coordinate AND
    # weighted into the graph edges (the heaviest feature config).
    if os.environ.get("BENCH_SKIP_FEATURES") != "1":
        try:
            import dataclasses as _dc

            from pyfocusr_tpu.metrics import registration_quality

            def _normf(f):
                # Graph.norm_node_features' math incl. its constant-feature
                # guards (std/ptp of 0 would NaN-poison the weights without
                # raising, since numpy only warns on 0/0).
                f = np.asarray(f, np.float64)
                std = f.std()
                f = np.clip((f - f.mean()) / (std if std > 0 else 1.0), -3, 3)
                ptp = f.max() - f.min()
                return ((f - f.min()) / (ptp if ptp > 0 else 1.0))[:, None]

            key_t = "thickness_change_(mm)"
            fcfg = _dc.replace(
                cfg,
                use_features_as_coords=True,
                include_features_in_adj_matrix=True,
                feature_smoothing_iterations=10,
            )
            tgf = mesh_to_graph_arrays(
                target, node_features=_normf(target.point_data[key_t])
            )
            sgf = mesh_to_graph_arrays(
                source, node_features=_normf(source.point_data[key_t])
            )
            rf = register_pair(tgf, sgf, fcfg, jax.random.PRNGKey(0))
            jax.block_until_ready(rf)
            ft_times = []
            for i in range(3):
                t0 = time.perf_counter()
                rf = register_pair(tgf, sgf, fcfg, jax.random.PRNGKey(i + 1))
                jax.block_until_ready(rf)
                _ = np.asarray(rf["correspondences"])[:4]
                ft_times.append(time.perf_counter() - t0)
            qf = registration_quality(target, source, rf)
            diag["features_15k"] = {
                "seconds": round(float(np.min(ft_times)), 3),
                "unique_fraction": qf["unique_fraction"],
                "symmetric_surface_dist_mm": qf["symmetric_surface_dist_mm"],
            }
        except Exception as e:
            print(f"feature diagnostic failed: {e}", file=sys.stderr)
            diag["features_15k"] = {"error": f"{type(e).__name__}: {e}"[:200]}

    # (e) sharded-vs-single fine refine at 960k on the VIRTUAL 8-device
    # CPU mesh (bigmesh must be a driven, measured path, not test-only).
    # Subprocess: this process owns the accelerator backend and cannot
    # re-init as multi-device CPU.  On a single-core
    # host the number measures coordination overhead; on multi-core, real
    # scale-out.
    if os.environ.get("BENCH_SKIP_SHARDED_REFINE") != "1":
        try:
            import subprocess

            if (os.cpu_count() or 1) < 4:
                # 8 virtual devices time-slicing <4 cores measure only
                # coordination overhead, at ~1 h wall on a 1-core host —
                # record why instead of burning the bench budget.
                raise RuntimeError(
                    f"host has {os.cpu_count()} CPU core(s); the virtual-"
                    "8-device comparison needs >= 4 to mean anything"
                )
            p = subprocess.run(
                [sys.executable, "tools/bench_sharded_refine.py"],
                capture_output=True, text=True, timeout=2400,
                cwd=os.path.dirname(os.path.abspath(__file__)),
            )
            line = next(
                (ln for ln in p.stdout.splitlines() if ln.startswith("{")),
                None,
            )
            if line:
                diag["sharded_refine_960k"] = json.loads(line)
            else:
                diag["sharded_refine_960k"] = {
                    "error": (p.stderr[-300:] if p.stderr
                              else f"rc={p.returncode}")
                }
        except Exception as e:
            print(f"sharded-refine diagnostic failed: {e}", file=sys.stderr)
            diag["sharded_refine_960k"] = {"error": f"{type(e).__name__}: {e}"[:200]}

    # (d) 122k-vertex DIRECT registration (no multires): a hub-rich
    # UV-sphere pair (poles touch a full 350-ring) — exercises the
    # degree-capped ELL overflow AND the split-spectra path
    # (pipeline._SPLIT_SPECTRA_N) in one number.
    if os.environ.get("BENCH_SKIP_DIRECT122K") != "1":
        try:
            from pyfocusr_tpu.mesh import TriMesh

            def _uv_sphere(n_theta, n_phi, warp=0.0):
                pts = [(0.0, 0.0, 1.0)]
                for ii in range(1, n_theta):
                    th = np.pi * ii / n_theta
                    for jj in range(n_phi):
                        ph = 2 * np.pi * jj / n_phi
                        pts.append((np.sin(th) * np.cos(ph),
                                    np.sin(th) * np.sin(ph), np.cos(th)))
                pts.append((0.0, 0.0, -1.0))
                pts = np.asarray(pts, np.float64)
                tris = []
                ring = lambda k: 1 + (k - 1) * n_phi
                for jj in range(n_phi):
                    tris.append((0, ring(1) + jj, ring(1) + (jj + 1) % n_phi))
                for ii in range(1, n_theta - 1):
                    for jj in range(n_phi):
                        a = ring(ii) + jj
                        b = ring(ii) + (jj + 1) % n_phi
                        c = ring(ii + 1) + jj
                        d = ring(ii + 1) + (jj + 1) % n_phi
                        tris.append((a, c, b))
                        tris.append((b, c, d))
                last = len(pts) - 1
                for jj in range(n_phi):
                    tris.append((last, ring(n_theta - 1) + (jj + 1) % n_phi,
                                 ring(n_theta - 1) + jj))
                if warp:
                    pts = pts * (1.0 + warp * np.sin(3.0 * pts[:, [1]]))
                return TriMesh(
                    jnp.asarray(pts * 40, jnp.float32),
                    jnp.asarray(np.asarray(tris, np.int32)),
                )

            th = _uv_sphere(350, 350)
            sh = _uv_sphere(350, 350, warp=0.05)
            tgh = mesh_to_graph_arrays(th)
            sgh = mesh_to_graph_arrays(sh)
            dcfg = PipelineConfig(
                get_weighted_spectral_coords=False,
                non_rigid_alpha=0.01,
                non_rigid_beta=50.0,
                non_rigid_max_iterations=300,
                n_coords_spectral_ordering=10000,
                n_coords_spectral_registration=1000,
                graph_smoothing_iterations=600,
                projection_smooth_iterations=1,
            )
            rh = register_pair(tgh, sgh, dcfg, jax.random.PRNGKey(0))
            jax.block_until_ready(rh)  # compile
            dh_times = []
            for di in (1, 2):
                t0 = time.perf_counter()
                rh = register_pair(tgh, sgh, dcfg, jax.random.PRNGKey(di))
                jax.block_until_ready(rh)
                _ = np.asarray(rh["correspondences"])[:4]
                dh_times.append(time.perf_counter() - t0)
            diag["direct_122k_hub"] = {
                "n_vertices": int(tgh.n_points),
                "seconds": round(float(np.min(dh_times)), 3),
                "runs_s": [round(t, 3) for t in dh_times],
            }
        except Exception as e:
            print(f"direct-122k diagnostic failed: {e}", file=sys.stderr)
            diag["direct_122k_hub"] = {"error": f"{type(e).__name__}: {e}"[:200]}

    print(json.dumps(diag), file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": "15k-pair end-to-end FOCUSR registration (1 chip)",
                "value": round(t_run, 4),
                "unit": "s",
                "vs_baseline": round(BASELINE_SECONDS / t_run, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
