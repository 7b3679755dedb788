#!/usr/bin/env python
"""Smoke run of the FOCUSR registration on one NVIDIA GPU.

Drives the main path once through the entry points a user calls, at the
sizes users run, on seeded synthetic bone pairs (``pyfocusr_tpu.synthetic``),
and checks each result against the repository's own references:

    python chip_smoke.py                 # default phases, one GPU
    python chip_smoke.py --four          # multi-device paths, 4 GPUs
    python chip_smoke.py --phases device,kernels

Every phase prints one JSON line (name, seconds, checks with their limits,
and the card's name and power limit from ``nvidia-smi``).  The line before
the last is the ``nvidia-smi`` name/power-limit line; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Any failed check or phase makes ``ok`` false and the exit code 1.  Without
a GPU (or without the package beside this script) nothing is printed to
stdout and the exit code is 2: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# The headline configuration (the reference notebook's 'kd' setup).
HEADLINE = dict(
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
# The class-API drive recipe (.claude/skills/verify/SKILL.md).
CLASS_RECIPE = dict(
    n_spectral_features=3, n_extra_spectral=3,
    get_weighted_spectral_coords=False, list_features_to_calc=[],
    non_rigid_alpha=0.01, non_rigid_beta=50,
    non_rigid_max_iterations=100, rigid_before_non_rigid_reg=False,
    projection_smooth_iterations=1, graph_smoothing_iterations=100,
    n_coords_spectral_registration=1000, seed=0,
)
# Multires configuration (the large-mesh path).
MULTIRES = dict(
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

# Unique-correspondence floors.  The synthetic pair's unique fraction on
# the CPU is 0.7221 at 2,562 vertices and 0.7698 at 10,242 (headline
# config, XLA:CPU); the floors sit below both.
UNIQUE_FLOOR = 0.70
UNIQUE_FLOOR_MULTIRES = 0.50

# Icosphere subdivisions of the synthetic pairs: 40,962 / 10,242 / 163,842
# vertices (pyfocusr_tpu.synthetic).
SUB_LARGE, SUB_MEDIUM, SUB_HUGE = 6, 5, 7
N_ESTEP = 15000


class NoAccelerator(RuntimeError):
    pass


class Phase:
    """Collects one phase's checks and informational numbers."""

    def __init__(self, name: str):
        self.name = name
        self.checks: list[dict] = []
        self.info: dict = {}

    def check(self, name: str, value, limit, op: str = ">=") -> bool:
        value = float(value)
        passed = {
            ">=": value >= limit, "<=": value <= limit,
            "==": value == limit, ">": value > limit, "<": value < limit,
        }[op]
        self.checks.append(
            {"name": name, "value": value, "op": op, "limit": limit,
             "pass": bool(passed)}
        )
        return bool(passed)

    def record(self, **kw):
        self.info.update(kw)


def card_info() -> str:
    """``name, power.limit`` of GPU 0 as nvidia-smi prints it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise NoAccelerator(f"nvidia-smi unavailable: {e}") from e
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise NoAccelerator("nvidia-smi lists no GPU")
    return lines[0]


def require_gpu():
    """The device phase's precondition: JAX's first device is a GPU and
    nvidia-smi names the card.  Returns (devices, card line)."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise NoAccelerator(
            f"JAX found no GPU (first device: {devices[0].platform})"
        )
    return devices, card_info()


def final_line(ok: bool, devices) -> dict:
    return {
        "ok": bool(ok),
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }


def run_phases(phases, card: str, emit=print) -> bool:
    """Run ``[(name, fn)]`` in order; ``fn(phase)`` records checks.  An
    exception fails its phase (traceback on stderr) and later phases
    still run.  Whatever a phase prints goes to stderr, so stdout holds
    only the phase lines.  Returns whether every phase passed."""
    ok = True
    for name, fn in phases:
        ph = Phase(name)
        t0 = time.perf_counter()
        error = None
        try:
            with contextlib.redirect_stdout(sys.stderr):
                fn(ph)
        except Exception as e:  # reported as a failed phase, exit code 1
            traceback.print_exc()
            error = f"{type(e).__name__}: {e}"[:500]
        passed = error is None and all(c["pass"] for c in ph.checks)
        line = {"phase": name, "ok": passed,
                "seconds": time.perf_counter() - t0, "gpu": card,
                "checks": ph.checks, **ph.info}
        if error:
            line["error"] = error
        emit(json.dumps(line, default=float))
        sys.stdout.flush()
        ok = ok and passed
    return ok


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------
def _pair(subdivisions: int):
    from pyfocusr_tpu.pipeline import mesh_to_graph_arrays
    from pyfocusr_tpu.synthetic import synthetic_pair

    t, s = synthetic_pair(subdivisions)
    return t, s, mesh_to_graph_arrays(t), mesh_to_graph_arrays(s)


def _cfg(**over):
    from pyfocusr_tpu.pipeline import PipelineConfig

    return PipelineConfig(**{**HEADLINE, **over})


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _best_time(fn, *args, reps: int = 5) -> float:
    """Seconds of the fastest of ``reps`` warm calls (one call compiles
    first)."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _all_finite(res) -> bool:
    import numpy as np

    for v in res.values():
        a = np.asarray(v)
        if a.dtype.kind == "f" and not np.all(np.isfinite(a)):
            return False
    return True


def _pick_mm(points, a, b) -> float:
    import numpy as np

    p = np.asarray(points, np.float64)
    return float(np.linalg.norm(p[np.asarray(a)] - p[np.asarray(b)], axis=1).mean())


# ----------------------------------------------------------------------
# phases (one GPU)
# ----------------------------------------------------------------------
def phase_device(ph, devices, card):
    import jax

    ph.check("platform_is_gpu", devices[0].platform == "gpu", 1, "==")
    ph.check("nvidia_smi_names_card", bool(card), 1, "==")
    ph.record(kind=devices[0].device_kind, count=len(devices),
              jax=jax.__version__)


def phase_register_40k(ph):
    import jax

    from pyfocusr_tpu.metrics import registration_quality
    from pyfocusr_tpu.pipeline import register_pair

    t, s, tg, sg = _pair(SUB_LARGE)
    cfg = _cfg()
    _, first = _timed(register_pair, tg, sg, cfg, jax.random.PRNGKey(0))
    res, steady = _timed(register_pair, tg, sg, cfg, jax.random.PRNGKey(1))
    q = registration_quality(t, s, res)
    ph.record(n_vertices=t.n_points, first_run_s=first, steady_run_s=steady,
              quality=q)
    ph.check("outputs_finite", _all_finite(res), 1, "==")
    ph.check("unique_fraction", q["unique_fraction"], UNIQUE_FLOOR)


def phase_class_api_10k(ph):
    import jax.numpy as jnp
    import numpy as np

    from pyfocusr_tpu import Focusr, load_mesh, save_mesh
    from pyfocusr_tpu.ops.knn import nn_query
    from pyfocusr_tpu.synthetic import synthetic_pair

    target, source = synthetic_pair(SUB_MEDIUM)
    n = source.n_points
    t0 = time.perf_counter()
    reg = Focusr(vtk_mesh_target=target, vtk_mesh_source=source,
                 **CLASS_RECIPE)
    reg.align_maps()
    ph.record(align_maps_s=time.perf_counter() - t0)
    corr = np.asarray(reg.corresponding_target_idx_for_each_source_pt)
    src = np.asarray(reg.graph_source.points, np.float64)
    moved = np.asarray(reg.nearest_neighbor_transformed_points, np.float64)
    disp = float(np.linalg.norm(moved - src, axis=1).mean())
    d_src, _ = nn_query(jnp.asarray(src, jnp.float32),
                        jnp.asarray(moved, jnp.float32))
    ph.check("unique_fraction", len(np.unique(corr)) / n, UNIQUE_FLOOR)
    ph.check("displacement_mean_mm", disp, 15.0, "<=")
    ph.check("moved_to_source_surface_mean_mm",
             float(np.asarray(d_src).mean()), 5.0, "<=")
    avg = reg.get_average_shape()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "average.vtk")
        save_mesh(path, avg)
        back = load_mesh(path)
    ph.check("roundtrip_points", back.n_points, avg.n_points, "==")
    ph.check("roundtrip_triangles", back.n_triangles, avg.n_triangles, "==")
    ph.check("roundtrip_point_data",
             sorted(back.point_data) == sorted(avg.point_data), 1, "==")

    t0 = time.perf_counter()
    reg2 = Focusr(vtk_mesh_target=target, vtk_mesh_source=source,
                  **CLASS_RECIPE)
    reg2.align_maps_pipeline()
    ph.record(align_maps_pipeline_s=time.perf_counter() - t0)
    corr2 = np.asarray(reg2.corresponding_target_idx_for_each_source_pt)
    pick = _pick_mm(target.points, corr, corr2)
    ph.record(exact_agreement_vs_pipeline=float((corr == corr2).mean()),
              displacement_mean_mm=disp)
    ph.check("pipeline_unique_fraction", len(np.unique(corr2)) / n,
             UNIQUE_FLOOR)
    # The two paths draw their random subsamples from different streams;
    # they agree when their picks are as close as two seeded reference
    # runs' (3.47 mm on this pair at 10,242 vertices, CPU).
    ph.check("pick_dist_vs_pipeline_mm", pick, 5.0, "<=")


def phase_reference_10k(ph):
    import jax
    import numpy as np

    sys.path.insert(0, ROOT)
    from pyfocusr_tpu.metrics import registration_quality
    from pyfocusr_tpu.pipeline import register_pair
    from tools.reference_pipeline import run_reference_pipeline

    t, s, tg, sg = _pair(SUB_MEDIUM)
    cfg = _cfg()
    res, dt = _timed(register_pair, tg, sg, cfg, jax.random.PRNGKey(0))
    kw = dict(HEADLINE, initial_correspondence_type="kd",
              final_correspondence_type="kd")
    kw.pop("get_weighted_spectral_coords")
    refs = []
    t0 = time.perf_counter()
    for seed in (0, 1):
        refs.append(run_reference_pipeline(
            np.asarray(t.points), np.asarray(t.triangles),
            np.asarray(s.points), np.asarray(s.triangles), seed=seed, **kw,
        ))
    ref_s = (time.perf_counter() - t0) / 2
    ours = np.asarray(res["correspondences"])
    r0, r1 = refs[0]["correspondences"], refs[1]["correspondences"]
    uq = registration_quality(t, s, res)["unique_fraction"]
    uq_ref = len(np.unique(r0)) / len(r0)
    pick = _pick_mm(t.points, ours, r0)
    pick_self = _pick_mm(t.points, r0, r1)
    ph.record(register_pair_first_s=dt, reference_host_s=ref_s,
              exact_agreement=float((ours == r0).mean()),
              reference_self_agreement=float((r0 == r1).mean()),
              unique_fraction=uq, reference_unique_fraction=uq_ref,
              pick_dist_mm=pick, reference_self_pick_dist_mm=pick_self)
    # On this smooth synthetic pair two seeded reference runs agree on
    # <1% of exact indices (0.47% at 10,242 vertices on the CPU), so exact
    # agreement cannot discriminate; the picks' distance is held to the
    # reference's own seed-to-seed spread instead.
    # (1 mm floor: at sizes where the subsamples cover every vertex the
    # reference is deterministic and its spread is 0.)
    ph.check("pick_dist_mm", pick, max(1.5 * pick_self, 1.0), "<=")
    ph.check("unique_fraction_gap", abs(uq - uq_ref), 0.03, "<=")
    ref = refs[0]
    for key in ("eig_vals_target", "eig_vals_source"):
        want = np.sort(ref[key])
        rel = np.abs(np.asarray(res[key], np.float64) - want) / np.abs(want)
        ph.check(f"{key}_max_rel_err", rel.max(), 1e-3, "<=")
    for key in ("eig_vecs_target", "eig_vecs_source_sorted"):
        a = np.asarray(res[key], np.float64)
        b = ref[key]
        cos = np.abs((a * b).sum(0)
                     / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0)))
        ph.check(f"{key}_min_abs_cos", cos.min(), 0.999)


def phase_hungarian_10k(ph):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    from pyfocusr_tpu.ops import assignment as asg
    from pyfocusr_tpu.ops.knn import pairwise_sq_dists
    from pyfocusr_tpu.pipeline import register_pair

    t, s, tg, sg = _pair(SUB_MEDIUM)
    cfg = _cfg(initial_correspondence_type="hungarian")
    _, first = _timed(register_pair, tg, sg, cfg, jax.random.PRNGKey(0))
    res, steady = _timed(register_pair, tg, sg, cfg, jax.random.PRNGKey(1))
    ph.record(first_run_s=first, steady_run_s=steady)
    ph.check("outputs_finite", _all_finite(res), 1, "==")

    # The spectral cost the pipeline's assignment solved.
    cost = jnp.sqrt(jnp.maximum(pairwise_sq_dists(
        res["spectral_coords_source"], res["spectral_coords_target"]), 0.0))
    n = cost.shape[0]

    def device_lap(c):
        spread = jnp.maximum(jnp.max(c) - jnp.min(c), 1e-12)
        _, g = asg._sinkhorn_duals(c, spread / 4.0, 1.0 / 3.0, 14, 30)
        return asg._jv_device(c, g, 60 * n)

    lap = jax.jit(device_lap)
    (col, steps), _ = _timed(lap, cost)
    (col, steps), lap_s = _timed(lap, cost)
    duals = jax.jit(lambda c: asg._sinkhorn_duals(
        c, jnp.maximum(jnp.max(c) - jnp.min(c), 1e-12) / 4.0, 1.0 / 3.0,
        14, 30))
    sinkhorn_s = _best_time(duals, cost, reps=2)
    cnp = np.asarray(cost, np.float64)
    col = np.asarray(col)
    t0 = time.perf_counter()
    ri, ci = linear_sum_assignment(cnp)
    scipy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, host_col = asg.lap_host(cnp)
    host_s = time.perf_counter() - t0
    opt = cnp[ri, ci].sum()
    gap = (cnp[np.arange(n), col].sum() - opt) / opt
    ph.record(n=int(n), jv_steps=int(steps), device_lap_s=lap_s,
              sinkhorn_warm_start_s=sinkhorn_s, scipy_s=scipy_s,
              host_jv_s=host_s)
    ph.check("device_lap_is_permutation",
             np.array_equal(np.sort(col), np.arange(n)), 1, "==")
    ph.check("device_lap_rel_gap", abs(gap), 1e-6, "<=")
    ph.check("host_jv_rel_gap",
             abs(cnp[np.arange(n), host_col].sum() - opt) / opt, 1e-6, "<=")


def _xla_knn(k):
    """The brute path ``nn_query`` (k=1: argmin) or ``knn_query`` (k>1:
    top-k) takes below the grid band — direct differences, query-chunked,
    jitted — as ``(ref, query) -> (dist [Nq, k], idx [Nq, k])``."""
    import jax

    from pyfocusr_tpu.ops import knn

    if k == 1:
        return lambda r, q: jax.tree.map(lambda x: x[:, None],
                                         knn._brute_nn(r, q))
    return lambda r, q: knn._brute_knn(r, q, k)


def phase_kernels(ph):
    """The pairwise stages against their plain references at real widths:
    KNN (exact f32 direct differences) against scipy's cKDTree, and the
    tiled CPD E-step against the dense one."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy.spatial import cKDTree

    from pyfocusr_tpu.ops.cpd import _estep
    from pyfocusr_tpu.ops.tiled import cpd_estep_tiled
    from pyfocusr_tpu.synthetic import synthetic_pair

    t, s = synthetic_pair(SUB_LARGE)
    rng = np.random.default_rng(0)
    cases = [
        ("d3_k1", np.asarray(t.points), np.asarray(s.points), 1),
        ("d3_k3", np.asarray(t.points), np.asarray(s.points), 3),
        ("d6_k1", rng.normal(size=(t.n_points, 6)).astype(np.float32),
         rng.normal(size=(t.n_points, 6)).astype(np.float32), 1),
    ]
    timings = {}
    for name, ref, qry, k in cases:
        r, q = jnp.asarray(ref), jnp.asarray(qry)
        fn = _xla_knn(k)
        d, i = jax.block_until_ready(fn(r, q))
        d, i = np.asarray(d, np.float64), np.asarray(i)
        sd, si = cKDTree(ref.astype(np.float64)).query(
            qry.astype(np.float64), k=k)
        sd, si = sd.reshape(d.shape), si.reshape(i.shape)
        # A different index is allowed only at an exact tie: its own f64
        # distance equals the reference's.
        diff = i != si
        own = np.linalg.norm(
            qry.astype(np.float64)[:, None, :] - ref.astype(np.float64)[i],
            axis=-1)
        ties_ok = np.all(np.abs(own[diff] - sd[diff]) <= 1e-6 * sd[diff])
        ph.check(f"knn_{name}_index_mismatch_not_tie", not ties_ok, 0, "==")
        rel = np.abs(d - sd) / np.maximum(sd, 1e-30)
        ph.check(f"knn_{name}_dist_max_rel", rel[sd > 0].max(), 1e-6, "<=")
        timings[name] = {"s": _best_time(fn, r, q),
                         "index_mismatches_at_ties": int(diff.sum())}
    ph.record(knn_n=t.n_points, knn=timings)

    # CPD E-step at 15,000 x 15,000, D=6: tiled vs the dense reference.
    X = jnp.asarray(rng.normal(size=(N_ESTEP, 6)) * 0.2, jnp.float32)
    TY = X + jnp.asarray(rng.normal(size=(N_ESTEP, 6)) * 0.01, jnp.float32)
    dense = jax.jit(lambda X, TY: _estep(X, TY, 0.01, 0.0))
    tiled = jax.jit(lambda X, TY: cpd_estep_tiled(X, TY, 0.01, 0.0))
    a = jax.block_until_ready(tiled(X, TY))
    b = jax.block_until_ready(dense(X, TY))
    rel = max(
        float(jnp.max(jnp.abs(x - y)) / (jnp.max(jnp.abs(y)) + 1e-30))
        for x, y in zip(a[:3], b[:3])
    )
    ph.check("cpd_estep_tiled_max_rel_dev", rel, 1e-4, "<=")
    ph.record(cpd_estep_n=N_ESTEP, cpd_estep={"tiled_s": _best_time(tiled, X, TY),
                                              "dense_s": _best_time(dense, X, TY)})


def phase_precision_audit(ph):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pyfocusr_tpu.ops import icp as icp_mod
    from pyfocusr_tpu.pipeline import PipelineConfig, _register_pair_jit
    from pyfocusr_tpu.utils.precision import dot_precision_census

    programs = {
        "register_40k": (SUB_LARGE, _cfg()),
        "hungarian_10k": (SUB_MEDIUM, _cfg(initial_correspondence_type="hungarian")),
        "multires_coarse_12k": (SUB_MEDIUM, PipelineConfig(**MULTIRES)),
    }
    census = {}
    for name, (sub, cfg) in programs.items():
        _, _, tg, sg = _pair(sub)
        text = jax.jit(
            lambda tg, sg, key, cfg=cfg: _register_pair_jit(tg, sg, cfg, key)
        ).lower(tg, sg, jax.random.PRNGKey(0)).as_text()
        c = dot_precision_census(text)
        census[name] = c
        ph.check(f"{name}_dots_below_highest",
                 sum(v for p, v in c.items() if p != "HIGHEST"), 0, "==")
    ph.record(census=census)

    # What each precision does to an f32 matmul on this card, against f64.
    rng = np.random.default_rng(0)
    a = rng.normal(size=(512, 512)).astype(np.float32)
    b = rng.normal(size=(512, 512)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    errs = {}
    for p in ("DEFAULT", "HIGH", "HIGHEST"):
        f = jax.jit(lambda x, y, p=p: jnp.dot(
            x, y, precision=getattr(jax.lax.Precision, p)))
        out = np.asarray(f(a, b), np.float64)
        errs[p] = float(np.abs(out - exact).max() / np.abs(exact).max())
    ph.record(matmul_max_rel_err_vs_f64=errs)
    ph.check("highest_is_f32", errs["HIGHEST"], 1e-5, "<=")

    # ICP's NN search runs on direct differences (no matmul).  Against
    # the same ICP with the NN search as a HIGHEST-precision matmul
    # identity, rotation and translation agree to the unit-test
    # tolerances.
    t, s = _pair(SUB_MEDIUM)[:2]
    src = jnp.asarray(s.points)
    tgt = jnp.asarray(t.points)

    def nn_matmul_highest(r, q):
        qn = jnp.sum(q * q, axis=1, keepdims=True)
        rn = jnp.sum(r * r, axis=1, keepdims=True)
        d2 = jnp.maximum(qn + rn.T - 2.0 * jnp.dot(
            q, r.T, precision=jax.lax.Precision.HIGHEST), 0.0)
        i = jnp.argmin(d2, axis=1)
        return jnp.sqrt(jnp.take_along_axis(d2, i[:, None], 1)[:, 0]), i

    orig_nn = icp_mod.nn_query
    out = {}
    try:
        for form, nn in (("direct", orig_nn), ("matmul_highest", nn_matmul_highest)):
            icp_mod.nn_query = nn
            (_, R, tr), _ = jax.jit(
                lambda a, b: icp_mod.icp(a, b, "rigid", 100))(src, tgt)
            out[form] = (np.asarray(R), np.asarray(tr))
    finally:
        icp_mod.nn_query = orig_nn
        jax.clear_caches()
    ph.check("icp_direct_vs_matmul_highest_R_max_abs",
             np.abs(out["direct"][0] - out["matmul_highest"][0]).max(), 1e-4, "<=")
    ph.check("icp_direct_vs_matmul_highest_t_max_abs",
             np.abs(out["direct"][1] - out["matmul_highest"][1]).max(), 1e-3, "<=")


def phase_multires_160k(ph):
    import jax
    import numpy as np

    from pyfocusr_tpu.metrics import surface_distance
    from pyfocusr_tpu.multires import register_pair_multires
    from pyfocusr_tpu.pipeline import PipelineConfig
    from pyfocusr_tpu.synthetic import synthetic_pair

    t, s = synthetic_pair(SUB_HUGE)
    cfg = PipelineConfig(**MULTIRES)
    t0 = time.perf_counter()
    fine, _ = register_pair_multires(t, s, cfg, jax.random.PRNGKey(0),
                                     coarse_n=12000)
    jax.block_until_ready(fine)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    fine, _ = register_pair_multires(t, s, cfg, jax.random.PRNGKey(1),
                                     coarse_n=12000)
    jax.block_until_ready(fine)
    steady = time.perf_counter() - t0
    corr = np.asarray(fine["correspondences"])
    mean_mm, _ = surface_distance(fine["weighted_points"], t)
    ph.record(n_vertices=t.n_points, first_run_s=first, steady_run_s=steady,
              symmetric_surface_dist_mm=mean_mm)
    ph.check("outputs_finite", _all_finite(fine), 1, "==")
    ph.check("unique_fraction", len(np.unique(corr)) / corr.shape[0],
             UNIQUE_FLOOR_MULTIRES)


def phase_grid_probe(ph):
    """Brute-kernel pair rate and voxel-grid cost on this card: the
    numbers behind ops/knn.py's routing band."""
    import jax.numpy as jnp
    import numpy as np

    from pyfocusr_tpu.ops.grid_knn import knn_grid
    from pyfocusr_tpu.ops.knn import _brute_knn, _brute_nn
    from pyfocusr_tpu.synthetic import synthetic_pair

    rows = []
    for sub in (SUB_MEDIUM, SUB_LARGE, SUB_HUGE):
        t, s = synthetic_pair(sub)
        r, q = jnp.asarray(t.points), jnp.asarray(s.points)
        # nn_query's two arms.
        brute = _best_time(_brute_nn, r, q, reps=3)
        grid = _best_time(
            lambda r, q: knn_grid(r, q, 1, brute=_brute_knn), r, q, reps=3)
        rows.append({"n": t.n_points, "pairs": float(t.n_points) ** 2,
                     "brute_s": brute, "grid_s": grid,
                     "brute_pairs_per_s": float(t.n_points) ** 2 / brute})
    ph.record(rows=rows)
    ph.check("probe_rows", len(rows), 3, "==")
    ph.record(brute_pairs_per_s=float(np.median(
        [r["brute_pairs_per_s"] for r in rows])))


def phase_aot(ph):
    import jax
    import numpy as np

    from pyfocusr_tpu.pipeline import register_pair
    from pyfocusr_tpu.utils.aot import (
        _export_program,
        export_registration,
        export_registration_exec,
        load_registration,
        load_registration_exec,
    )

    _, _, tg, sg = _pair(SUB_MEDIUM)
    cfg = _cfg()
    key = jax.random.PRNGKey(3)
    direct = np.asarray(register_pair(tg, sg, cfg, key)["correspondences"])
    # XLA:GPU scatter-adds use atomics, whose order varies between runs:
    # a served program may differ from the direct run in the last bits,
    # which can move a rare near-tie correspondence.
    floor = 0.999
    # StableHLO export on CUDA: jax.export must accept every custom call
    # of the program (cuSOLVER/cuBLAS).  Run the exported program
    # in-process.
    exp = _export_program(cfg, tg, sg)
    served, _ = _timed(exp.call, tg, sg, key)
    agree = float((np.asarray(served["correspondences"]) == direct).mean())
    ph.record(stablehlo_in_process_agreement=agree)
    ph.check("stablehlo_in_process_agreement_vs_direct", agree, floor)
    formats = [("executable", export_registration_exec, load_registration_exec)]
    try:  # jax.export's file format needs the flatbuffers package
        import flatbuffers  # noqa: F401

        formats.insert(0, ("stablehlo", export_registration, load_registration))
    except ImportError:
        ph.record(stablehlo_file="not written: flatbuffers is not installed")
    with tempfile.TemporaryDirectory() as d:
        for fmt, export, load in formats:
            path = os.path.join(d, f"reg.{fmt}")
            t0 = time.perf_counter()
            export(cfg, tg, sg, path)
            export_s = time.perf_counter() - t0
            runner = load(path, cfg=cfg, target=tg, source=sg)
            served, first = _timed(runner, tg, sg, key)
            agree = float(
                (np.asarray(served["correspondences"]) == direct).mean())
            ph.record(**{f"{fmt}_export_s": export_s,
                         f"{fmt}_first_call_s": first,
                         f"{fmt}_artifact_mb": os.path.getsize(path) / 1e6,
                         f"{fmt}_agreement": agree})
            ph.check(f"{fmt}_agreement_vs_direct", agree, floor)


# ----------------------------------------------------------------------
# phases (four GPUs)
# ----------------------------------------------------------------------
def _mean_shape_rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _mesh(devices, axis):
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.asarray(devices).reshape(len(devices)), (axis,))


def _stage_diffs(a, b) -> dict:
    """Per output of two registration result pytrees: the max abs
    difference (float outputs) or the agreement (index outputs) — where
    two runs split, stage by stage."""
    import numpy as np

    out = {}
    for k in sorted(a):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        out[k] = (float(np.abs(x.astype(np.float64) - y).max())
                  if x.dtype.kind == "f" else float((x == y).mean()))
    return out


# Subjects run one after another on each device (cohort._batched_register),
# so the sharded run and the whole cohort on one card execute the same
# per-subject program.
_COHORT_CFG = dict(non_rigid_max_iterations=100,
                   n_coords_spectral_registration=1000,
                   graph_smoothing_iterations=300,
                   projection_smooth_iterations=1)


def phase_cohort_4(ph, devices):
    import jax
    import numpy as np

    from pyfocusr_tpu.parallel.cohort import register_cohort, stack_graph_arrays
    from pyfocusr_tpu.pipeline import PipelineConfig, mesh_to_graph_arrays
    from pyfocusr_tpu.synthetic import synthetic_bone

    template = mesh_to_graph_arrays(synthetic_bone(100, SUB_MEDIUM))
    batch = 8
    subjects = stack_graph_arrays(
        [mesh_to_graph_arrays(synthetic_bone(101 + b, SUB_MEDIUM))
         for b in range(batch)])
    cfg = PipelineConfig(
        n_coords_spectral_ordering=min(5000, template.n_points), **_COHORT_CFG)
    key = jax.random.PRNGKey(0)
    (four, m4), s4 = _timed(lambda: register_cohort(
        template, subjects, cfg, key, device_mesh=_mesh(devices, "cohort")))
    (one, m1), s1 = _timed(lambda: register_cohort(
        template, subjects, cfg, key, device_mesh=_mesh(devices[:1], "cohort")))
    placed = {d.id for d in four["correspondences"].sharding.device_set}
    ph.record(n_subjects=batch, n_vertices=template.n_points,
              one_gpu_s=s1, four_gpu_s=s4, result_devices=sorted(placed),
              stage_diffs=_stage_diffs(four, one))
    ph.check("result_spans_all_devices", len(placed), len(devices), "==")
    ph.check("correspondence_agreement",
             (np.asarray(one["correspondences"])
              == np.asarray(four["correspondences"])).mean(), 0.999)
    ph.check("mean_shape_max_rel", _mean_shape_rel(m4, m1), 1e-4, "<=")


def phase_bigmesh_4(ph, devices):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pyfocusr_tpu.multires import _refine_fine_level
    from pyfocusr_tpu.ops.knn import SENTINEL, nn_query
    from pyfocusr_tpu.parallel.bigmesh import refine_fine_level_sharded
    from pyfocusr_tpu.pipeline import PipelineConfig

    t, s, tg, sg = _pair(SUB_HUGE)
    cfg = PipelineConfig(**MULTIRES)
    tq = jnp.where(tg.valid_mask[:, None] > 0, tg.points, SENTINEL)
    _, init = nn_query(tq, sg.points)
    one, s1 = _timed(jax.jit(
        lambda tg, sg, i: _refine_fine_level(tg, sg, i, cfg)), tg, sg, init)
    four, s4 = _timed(lambda: refine_fine_level_sharded(
        tg, sg, init, cfg, _mesh(devices, "verts")))
    c1 = np.asarray(one["correspondences"])
    c4 = np.asarray(four["correspondences"])
    placed = {d.id for d in four["weighted_points"].sharding.device_set}
    ph.record(n_vertices=t.n_points, one_gpu_s=s1, four_gpu_s=s4,
              result_devices=sorted(placed))
    ph.check("result_spans_all_devices", len(placed), len(devices), "==")
    ph.check("correspondence_agreement", (c1 == c4).mean(), 0.999)
    ph.check("weighted_points_max_rel",
             _mean_shape_rel(four["weighted_points"], one["weighted_points"]),
             1e-4, "<=")


def phase_all_pairs_4(ph, devices):
    import jax
    import numpy as np

    from pyfocusr_tpu.parallel.groupwise import register_all_pairs
    from pyfocusr_tpu.pipeline import PipelineConfig
    from pyfocusr_tpu.synthetic import synthetic_bone

    meshes = [synthetic_bone(200 + b, SUB_MEDIUM) for b in range(4)]
    cfg = PipelineConfig(
        n_coords_spectral_ordering=min(5000, meshes[0].n_points),
        **_COHORT_CFG)
    key = jax.random.PRNGKey(1)
    (_, pair_index, four), s4 = _timed(lambda: register_all_pairs(
        meshes, cfg, key, device_mesh=_mesh(devices, "pairs")))
    (_, _, one), s1 = _timed(lambda: register_all_pairs(
        meshes, cfg, key, device_mesh=_mesh(devices[:1], "pairs")))
    placed = {d.id for d in four["correspondences"].sharding.device_set}
    ph.record(n_pairs=len(pair_index), n_vertices=meshes[0].n_points,
              one_gpu_s=s1, four_gpu_s=s4, result_devices=sorted(placed),
              stage_diffs=_stage_diffs(four, one))
    ph.check("result_spans_all_devices", len(placed), len(devices), "==")
    ph.check("correspondence_agreement",
             (np.asarray(one["correspondences"])
              == np.asarray(four["correspondences"])).mean(), 0.999)


# ----------------------------------------------------------------------
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the multi-device paths on 4 GPUs")
    parser.add_argument("--phases", default="",
                        help="comma-separated subset of phases to run")
    args = parser.parse_args(argv)

    try:
        import pyfocusr_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the pyfocusr_tpu package is missing: {e}",
              file=sys.stderr)
        return 2
    from pyfocusr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    try:
        devices, card = require_gpu()
    except NoAccelerator as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2

    if args.four:
        if len(devices) < 4:
            print(f"chip_smoke: --four needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 2
        devices = devices[:4]
        table = {
            "device": lambda ph: phase_device(ph, devices, card),
            "cohort_4": lambda ph: phase_cohort_4(ph, devices),
            "bigmesh_4": lambda ph: phase_bigmesh_4(ph, devices),
            "all_pairs_4": lambda ph: phase_all_pairs_4(ph, devices),
        }
        default = list(table)
    else:
        devices = devices[:1]
        table = {
            "device": lambda ph: phase_device(ph, devices, card),
            "register_40k": phase_register_40k,
            "class_api_10k": phase_class_api_10k,
            "reference_10k": phase_reference_10k,
            "hungarian_10k": phase_hungarian_10k,
            "kernels": phase_kernels,
            "precision_audit": phase_precision_audit,
            "multires_160k": phase_multires_160k,
            "aot": phase_aot,
            "grid_probe": phase_grid_probe,
        }
        default = [n for n in table if n != "grid_probe"]
    names = [n for n in args.phases.split(",") if n] or default
    unknown = [n for n in names if n not in table]
    if unknown:
        parser.error(f"unknown phases {unknown}; choose from {list(table)}")
    ok = run_phases([(n, table[n]) for n in names], card)
    print(card)
    print(json.dumps(final_line(ok, devices)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
