"""Sharded-vs-single fine-refine benchmark on the virtual 8-device mesh.

VERDICT r3 task #6: `parallel/bigmesh.py` was test-only; this records a
real measurement of the vertex-sharded refine against the single-device
refine at >= 960k vertices (the bundled 15k pair subdivided x3), on N
virtual CPU devices (`--xla_force_host_platform_device_count`) — the
same mechanism the test suite and the driver's multichip dryrun use.
Run standalone or through bench.py's `sharded_refine_960k` block (which
launches this in a subprocess: the bench process owns the accelerator
backend and cannot re-init as multi-device CPU).

Prints ONE JSON line with both times, the speedup, and the index
agreement.  On a single-core host the virtual devices time-slice one
core, so the sharded path measures the COORDINATION overhead (expect
<= 1x); on a multi-core host it measures real scale-out.
"""

import json
import math
import os
import sys
import time

# --model runs on the CURRENT backend (the real chip): it measures the
# single-device anchors of the scaling model instead of the virtual-8
# comparison, so it must NOT force the CPU platform.
MODEL_MODE = "--model" in sys.argv

if not MODEL_MODE:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if not MODEL_MODE:
    jax.config.update("jax_platforms", "cpu")
from pyfocusr_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from pyfocusr_tpu import load_mesh
from pyfocusr_tpu.multires import _refine_fine_level, subdivide
from pyfocusr_tpu.ops.knn import SENTINEL, nn_query
from pyfocusr_tpu.parallel.bigmesh import refine_fine_level_sharded
from pyfocusr_tpu.pipeline import PipelineConfig, mesh_to_graph_arrays

DATA = "/root/reference/data"


def model() -> int:
    """Measured-anchored scaling model of the vertex-sharded refine
    (VERDICT r4 #8 — this 1-core host cannot measure the virtual-8
    comparison, so the model predicts the sharded/single ratio from
    quantities measurable on ONE device plus stated interconnect
    assumptions).

    Anchors (measured here, on the current backend, min-of-reps with
    in-program loop repetition and varied inputs):
      T_step(N)   one smoothing SpMV step on [N, 3] (the refine is
                  S ~ deg(600) + deg(40) ~ 163 such steps)
      T_knn(N)    the k=3 correspondence query

    Model:  T_single = S * T_step + T_knn
            T_shard(P) = S * (T_step / P + AG(N)) + T_knn / P + C_fix
            AG(N) = N*3*4 * (P-1)/P / BW_ici + LAT   (one [N,3]
                    all_gather per smoothing step — bigmesh.py)

    Assumptions (overridable by env): BW_ici = 1.6e11 B/s effective
    all-gather bandwidth per device (an assumed interconnect rate, not a
    measured one), LAT = 5e-6 s per
    collective, C_fix = 1 ms per-invocation overhead.  CAVEATS: ignores
    per-step dispatch floors inside shard_map, assumes the KNN shards
    linearly (it all_gathers the reference side once), and says nothing
    about DCN-attached hosts — treat the output as the crossover SHAPE,
    not a guarantee; validate on real multi-chip before relying on it.
    """
    t = load_mesh(f"{DATA}/target_mesh_15k.vtk")
    s = load_mesh(f"{DATA}/source_mesh_15k.vtk")
    for _ in range(3):
        t = subdivide(t)
        s = subdivide(s)
    tg = mesh_to_graph_arrays(t, patch_blocks=False)
    sg = mesh_to_graph_arrays(s, patch_blocks=False)
    n = int(tg.n_points)
    from pyfocusr_tpu.ops import graph_ops

    w = graph_ops.edge_weights(tg.points, tg.neighbors, tg.nbr_mask)
    ov_w = graph_ops.overflow_weights(tg.points, tg.overflow)
    X0 = tg.points

    def step(x):
        y = graph_ops.spmv(tg.neighbors, w, x, tg.overflow, ov_w) + x
        return y / jnp.maximum(jnp.max(jnp.abs(y)), 1e-30)

    R = 50

    def timed(fn, *a, reps=5):
        jax.block_until_ready(fn(*a))
        ts = []
        for i in range(reps):
            ai = (a[0] * (1.0 + 1e-6 * i),) + a[1:]
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*ai))
            ts.append(time.perf_counter() - t0)
        return float(np.min(ts))

    f = jax.jit(lambda x: jax.lax.fori_loop(0, R, lambda i, v: step(v), x))
    e = jax.jit(lambda x: jax.lax.fori_loop(0, R, lambda i, v: v, x))
    t_step = (timed(f, X0) - timed(e, X0)) / R

    from pyfocusr_tpu.ops.knn import knn3_masked

    tq = jnp.where(tg.valid_mask[:, None] > 0, tg.points, SENTINEL)
    fk = jax.jit(lambda q: knn3_masked(tq, tg.valid_mask, q)[1])
    t_knn = timed(fk, sg.points)

    def _deg(q):
        return min(q, int(math.sqrt(2.0 * q * math.log(1e5))) + 8)

    S = _deg(600) + _deg(40)
    bw = float(os.environ.get("MODEL_ICI_BW", 1.6e11))
    lat = float(os.environ.get("MODEL_ICI_LAT", 5e-6))
    c_fix = 1e-3
    t_single = S * t_step + t_knn
    out = {
        "mode": "model",
        "backend": jax.default_backend(),
        "n_vertices": n,
        "t_step_ms": round(t_step * 1e3, 3),
        "t_knn_s": round(t_knn, 3),
        "smoothing_steps": S,
        "single_refine_model_s": round(t_single, 3),
        "assumptions": {"ici_bw_B_per_s": bw, "ici_lat_s": lat,
                        "c_fix_s": c_fix},
        "sharded_model": {},
    }
    for P in (2, 4, 8, 16):
        ag = n * 3 * 4 * (P - 1) / P / bw + lat
        t_sh = S * (t_step / P + ag) + t_knn / P + c_fix
        out["sharded_model"][f"P{P}"] = {
            "seconds": round(t_sh, 3),
            "speedup": round(t_single / t_sh, 2),
        }
    print(json.dumps(out))
    return 0


def main() -> int:
    if MODEL_MODE:
        return model()
    t = load_mesh(f"{DATA}/target_mesh_15k.vtk")
    s = load_mesh(f"{DATA}/source_mesh_15k.vtk")
    for _ in range(3):
        t = subdivide(t)
        s = subdivide(s)
    tg = mesh_to_graph_arrays(t)
    sg = mesh_to_graph_arrays(s)
    cfg = PipelineConfig(
        graph_smoothing_iterations=600, projection_smooth_iterations=1
    )
    tq = jnp.where(tg.valid_mask[:, None] > 0, tg.points, SENTINEL)
    _, init = nn_query(tq, sg.points)
    init = jax.block_until_ready(init)

    mesh = Mesh(np.asarray(jax.devices()).reshape(8), ("verts",))
    out = {"n_vertices": int(tg.n_points), "n_devices": 8,
           "host_cores": os.cpu_count()}

    o_sh = refine_fine_level_sharded(tg, sg, init, cfg, mesh)
    jax.block_until_ready(o_sh)  # compile
    t0 = time.perf_counter()
    o_sh = refine_fine_level_sharded(tg, sg, init, cfg, mesh)
    jax.block_until_ready(o_sh)
    out["sharded_s"] = round(time.perf_counter() - t0, 2)

    o_si = _refine_fine_level(tg, sg, init, cfg)
    jax.block_until_ready(o_si)  # compile
    t0 = time.perf_counter()
    o_si = _refine_fine_level(tg, sg, init, cfg)
    jax.block_until_ready(o_si)
    out["single_s"] = round(time.perf_counter() - t0, 2)

    out["speedup"] = round(out["single_s"] / out["sharded_s"], 3)
    out["index_agreement"] = round(float(
        (np.asarray(o_sh["correspondences"])
         == np.asarray(o_si["correspondences"])).mean()
    ), 6)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
