#!/usr/bin/env python
"""Per-stage timing of the 15k registration on the current JAX backend.

Each stage is timed steady-state (jitted, after warm-up) so the output maps
directly onto the end-to-end pipeline cost.  Run on the GPU: `python
tools/profile_stages.py`; on CPU: `JAX_PLATFORMS=cpu python
tools/profile_stages.py`.
"""

import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from pyfocusr_tpu import load_mesh
from pyfocusr_tpu.ops import graph_ops
from pyfocusr_tpu.ops import cpd as cpd_ops
from pyfocusr_tpu.ops.icp import icp as icp_fit
from pyfocusr_tpu.ops.knn import knn_query, nn_query
from pyfocusr_tpu.pipeline import PipelineConfig, _spectrum, mesh_to_graph_arrays
from pyfocusr_tpu.spectral.eigsort_jax import sort_eigenmaps_jit

DATA = "/root/reference/data"


_BASELINE_S = [0.0]


def _fence(out):
    """Wait for ``out`` with a small host transfer, which also covers
    runtimes where block_until_ready returns early."""
    leaf = jax.tree_util.tree_leaves(out)[0]
    np.asarray(leaf).ravel()[:1]
    return out


def measure_baseline():
    """Per-call round-trip floor (dispatch + fence transfer), subtracted
    from every stage time below, so it cannot swamp short ops."""
    x = jnp.ones((8, 8), jnp.float32)
    f = jax.jit(lambda a: a + 1.0)
    _fence(f(x))
    ts = []
    for _ in range(9):
        t0 = time.perf_counter()
        _fence(f(x))
        ts.append(time.perf_counter() - t0)
    _BASELINE_S[0] = float(np.median(ts))
    print(f"{'round-trip baseline (subtracted)':42s} {_BASELINE_S[0]*1000:10.1f} ms")


def timeit(name, fn, *args, n=5, **kw):
    out = _fence(fn(*args, **kw))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = _fence(fn(*args, **kw))
        ts.append(time.perf_counter() - t0)
    dt = max(float(np.median(ts)) - _BASELINE_S[0], 0.0)
    print(f"{name:42s} {dt*1000:10.1f} ms")
    return out


def main():
    print("device:", jax.devices()[0])
    measure_baseline()
    target = load_mesh(f"{DATA}/target_mesh_15k.vtk")
    source = load_mesh(f"{DATA}/source_mesh_15k.vtk")
    tg = mesh_to_graph_arrays(target)
    sg = mesh_to_graph_arrays(source)
    cfg = PipelineConfig(
        n_coords_spectral_ordering=10000,
        n_coords_spectral_registration=1000,
        non_rigid_alpha=0.01,
        non_rigid_beta=50.0,
        non_rigid_max_iterations=300,
        graph_smoothing_iterations=600,
        projection_smooth_iterations=1,
    )
    key = jax.random.PRNGKey(0)

    # ICP variants
    lm = sg.points[:: max(1, sg.n_points // 2000)][:2000]
    timeit("icp 100it landmarks=2000", lambda: icp_fit(lm, tg.points, max_iterations=100)[1])
    # spectrum
    spec = jax.jit(lambda g, k: _spectrum(g, 6, k, cfg)[:2])
    lams_t, vecs_t = timeit("spectrum target (chebyshev)", spec, tg, key)
    lams_s, vecs_s = timeit("spectrum source", spec, sg, key)

    # eigsort
    n_rand = 10000
    idx_t = jnp.arange(n_rand)
    idx_s = jnp.arange(n_rand)
    es = jax.jit(
        lambda: sort_eigenmaps_jit(
            lams_t, lams_s, vecs_t[idx_t], vecs_s[idx_s],
            tg.points[idx_t], sg.points[idx_s], vecs_s,
        )
    )
    vecs_sorted, Q = timeit("eigsort (10k samples)", es)

    # CPD
    X = vecs_sorted[:1000, :3]
    Y = vecs_t[:1000, :3]
    lr = timeit(
        "cpd low-rank eig (1000, k=100)",
        cpd_ops.low_rank_gaussian, Y, 50.0, 100, key,
    )
    Qg, lam_g = lr
    timeit(
        "cpd deformable 300 it",
        lambda: cpd_ops._deformable_cpd_run(X, Y, Qg, lam_g, 0.01, 300, 1e-8)[0],
    )
    z_cpd = jnp.zeros((100, 3))
    timeit(
        "cpd transform 15k pts",
        lambda: cpd_ops.lowrank_transform(vecs_t[:, :3], Y, Qg, lam_g, z_cpd, 50.0),
    )

    # correspondence + smoothing
    timeit("nn_query 15k->15k (HIGHEST)", lambda: nn_query(vecs_t[:, :3], vecs_sorted[:, :3]))
    w_t = graph_ops.edge_weights(tg.points, tg.neighbors, tg.nbr_mask)
    timeit(
        "mean_filter 600 it [15k,3]",
        lambda: graph_ops.mean_filter(tg.neighbors, w_t, tg.points, 600),
    )
    timeit("knn3 15k->15k", lambda: knn_query(tg.points, sg.points, k=3))


if __name__ == "__main__":
    main()
