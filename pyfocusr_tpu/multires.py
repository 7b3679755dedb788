"""Multi-resolution registration: scale FOCUSR past 100k-vertex meshes.

The reference's scalability story stops at subsampling within a single
resolution (SURVEY §5.7); its bundled workloads top out at 15k vertices.
This module adds the standard multigrid decomposition:

    decimate (host, graph aggregation)  ->  register the coarse pair
    (the full spectral pipeline, ``pipeline.register_pair``)  ->  prolong
    correspondences through the cluster maps  ->  fine-level refinement
    (the reference's own correspondence-smoothing + final-location stages,
    reference ``focusr.py:368-431``, jit-compiled at full resolution).

Why this split: every pipeline stage is near-linear in N except the
spectral eigensolve's *sequential depth* and the CPD fit, and neither
gains information from resolution beyond the spectral scale — the k=6
eigenmaps of a 240k mesh are fully resolved on a 15k decimation.  The
coarse solve therefore runs at a fixed budget regardless of input size,
and the fine level pays only for gather-SpMV smoothing + KNN, both
tiled/streaming ops.  Memory and time stay bounded: O(N) fine work.

Decimation is greedy maximal-independent-set aggregation (the algebraic-
multigrid coarsening pattern): seeds form an independent set of the mesh
graph, every vertex joins an adjacent seed's cluster, coarse vertices are
cluster centroids, and coarse triangles are the label-distinct images of
fine triangles (deduplicated).  Repeated until the target count is met.
``subdivide`` (midpoint 1->4) provides the inverse for building large test
meshes from the bundled ones.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .mesh import TriMesh, build_topology
from .ops import graph_ops
from .ops.knn import idw_from_knn, knn3_masked
from .pipeline import (
    GraphArrays,
    PipelineConfig,
    mesh_to_graph_arrays,
    register_pair,
)
from .utils.precision import f32_matmuls

__all__ = [
    "subdivide",
    "decimate",
    "register_pair_multires",
]

# Largest coarse vertex count for which the packed triangle-dedup key
# (i*nc + j)*nc + k fits int64 (nc^3 < 2^63 needs nc <= ~2.09e6); above it
# decimate() switches to exact lexicographic row-unique.
_PACKED_KEY_MAX_NC = 2_000_000


def subdivide(mesh: TriMesh) -> TriMesh:
    """Midpoint (1-to-4) subdivision: each edge gains its midpoint vertex.
    N' = N + E, F' = 4F.  Point data is averaged onto midpoints."""
    pts = np.asarray(mesh.points, np.float64)
    tris = np.asarray(mesh.triangles, np.int64)
    n = pts.shape[0]
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    e = np.sort(e, axis=1)
    uniq, inv = np.unique(e[:, 0] * n + e[:, 1], return_inverse=True)
    eu = np.stack([uniq // n, uniq % n], axis=1)
    mids = 0.5 * (pts[eu[:, 0]] + pts[eu[:, 1]])
    new_pts = np.concatenate([pts, mids])
    m = inv.reshape(3, -1).T + n  # midpoint index per (tri, edge)
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    mab, mbc, mca = m[:, 0], m[:, 1], m[:, 2]
    new_tris = np.concatenate(
        [
            np.stack([a, mab, mca], 1),
            np.stack([mab, b, mbc], 1),
            np.stack([mca, mbc, c], 1),
            np.stack([mab, mbc, mca], 1),
        ]
    )
    pd = {}
    for k, v in mesh.point_data.items():
        va = np.asarray(v, np.float64)
        pd[k] = np.concatenate([va, 0.5 * (va[eu[:, 0]] + va[eu[:, 1]])])
    # HOST arrays on purpose: subdivision is host preprocessing, and a
    # jnp.asarray here would round-trip megabytes per level for nothing
    # (mesh_to_graph_arrays does the one transfer).
    return TriMesh(
        np.asarray(new_pts, np.float32),
        np.asarray(new_tris, np.int32),
        {k: np.asarray(v, np.float32) for k, v in pd.items()},
    )


def _luby_mis_numpy(u, v, n, prio):
    """Numpy fallback MIS — Luby-style rounds with static priorities: a
    vertex joins when its priority beats every unresolved neighbor's;
    neighbors of new seeds drop out.  Produces the lexicographically-first
    MIS, identical to the native greedy pass (gated byte-for-byte by
    tests/test_native_topology.py).  Directed incidence arrays are sorted
    by source ONCE so each round's neighbor-min is a segment min via
    np.minimum.reduceat — unbuffered np.minimum.at was the decimation
    hotspot at 240k."""
    d_src = np.concatenate([u, v])
    d_dst = np.concatenate([v, u])
    order = np.argsort(d_src, kind="stable")
    d_src, d_dst = d_src[order], d_dst[order]
    seg_starts = np.searchsorted(d_src, np.arange(n))
    has_edges = seg_starts < np.append(seg_starts[1:], len(d_src))
    # reduceat ONLY over vertices that have edges: their starts are strictly
    # increasing, so every segment is non-empty and correctly bounded.
    # (Feeding all n starts with empty segments zeroed corrupts the
    # PRECEDING vertex's min — reduceat treats idx[i] >= idx[i+1] as a
    # single-element segment; caught by review with an isolated-vertex
    # repro that produced two ADJACENT seeds.)
    red_idx = seg_starts[has_edges]
    state = np.zeros(n, np.int8)  # 0 unresolved, 1 seed, -1 blocked
    # Loop to CONVERGENCE (expected O(log n) rounds, <= n worst case): the
    # unresolved vertex with globally minimal priority always joins, so
    # every round makes progress.  A fixed round cap would have to promote
    # leftovers blindly — adjacent seeds, a silent MIS-invariant break on
    # long monotone priority chains.
    while True:
        un = state == 0
        if not un.any():
            break
        # neighbor priority with resolved neighbors masked to +inf-like
        nbr_prio = np.where(un[d_dst] & un[d_src], prio[d_dst], n + 1)
        best_nbr = np.full(n, n + 1, np.int64)
        if len(red_idx):
            best_nbr[has_edges] = np.minimum.reduceat(nbr_prio, red_idx)
        new_seed = un & (prio < best_nbr)
        if not new_seed.any():  # defensive: provably unreachable
            raise RuntimeError("MIS round made no progress")
        state[new_seed] = 1
        blocked = np.zeros(n, bool)
        seed_edge = state[u] == 1
        blocked[v[seed_edge]] = True
        seed_edge = state[v] == 1
        blocked[u[seed_edge]] = True
        state[blocked & (state == 0)] = -1
    return state


def _aggregate_once(pts: np.ndarray, tris: np.ndarray, rng, edges=None):
    """One MIS-aggregation round, fully vectorized.  The MIS itself runs as
    a single native C++ greedy pass in priority order (same result as the
    Luby rounds — both yield the lexicographically-first MIS; numpy
    fallback kept); cluster assignment and coarse-mesh construction stay
    vectorized numpy.  Returns (coarse_pts, coarse_tris, label)."""
    n = pts.shape[0]
    if edges is not None:
        # Caller-provided unique undirected edges (i < j) — lets
        # register_pair_multires reuse the fine topology it builds anyway
        # instead of paying the extraction twice per mesh.  The MIS and
        # cluster assignment are edge-ORDER independent, so any consistent
        # unique edge set is equivalent.
        u = np.asarray(edges[:, 0], np.int64)
        v = np.asarray(edges[:, 1], np.int64)
        head = None
    else:
        from .native import topology_native

        head = topology_native(tris, n, None)
    if head is not None:  # C++ edge extraction (same sorted unique edges)
        u = head[0][:, 0].astype(np.int64)
        v = head[0][:, 1].astype(np.int64)
    elif edges is None:
        e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
        e = np.sort(e, axis=1)
        ukey = np.unique(e[:, 0] * np.int64(n) + e[:, 1])  # scalar-key unique
        u, v = ukey // n, ukey % n

    prio = rng.permutation(n).astype(np.int64)
    from .native import mis_greedy_native

    state = mis_greedy_native(u, v, n, prio)
    if state is None:
        state = _luby_mis_numpy(u, v, n, prio)

    is_seed = state == 1
    seeds = np.where(is_seed)[0]
    seed_rank = np.full(n, -1, np.int64)
    seed_rank[seeds] = np.arange(len(seeds))

    # --- Assign every non-seed to its nearest adjacent seed (vectorized
    # argmin via lexsort over (vertex, distance) of seed-incident edges). ---
    d2 = np.sum((pts[u] - pts[v]) ** 2, axis=1)
    cand_v = np.concatenate([u[is_seed[v]], v[is_seed[u]]])
    cand_s = np.concatenate([v[is_seed[v]], u[is_seed[u]]])
    cand_d = np.concatenate([d2[is_seed[v]], d2[is_seed[u]]])
    keep = ~is_seed[cand_v]
    cand_v, cand_s, cand_d = cand_v[keep], cand_s[keep], cand_d[keep]
    order = np.lexsort((cand_d, cand_v))
    first = np.ones(len(order), bool)
    first[1:] = cand_v[order[1:]] != cand_v[order[:-1]]
    label = np.full(n, -1, np.int64)
    label[is_seed] = seed_rank[is_seed]
    label[cand_v[order[first]]] = seed_rank[cand_s[order[first]]]
    # Safety: anything still unassigned (no seed neighbor — cannot happen
    # for MIS seeds, but cheap to guard) becomes its own cluster.
    orphan = label < 0
    label[orphan] = len(seeds) + np.arange(int(orphan.sum()))
    uniq, label = np.unique(label, return_inverse=True)
    nc = len(uniq)
    coarse_pts = np.zeros((nc, 3))
    counts = np.bincount(label, minlength=nc).astype(np.float64)
    for d in range(3):
        coarse_pts[:, d] = np.bincount(label, weights=pts[:, d], minlength=nc)
    coarse_pts /= counts[:, None]
    ct = label[tris]
    keep = (
        (ct[:, 0] != ct[:, 1]) & (ct[:, 1] != ct[:, 2]) & (ct[:, 0] != ct[:, 2])
    )
    cts = np.sort(ct[keep], axis=1)
    if nc <= _PACKED_KEY_MAX_NC:  # nc^3 < 2^63: packed-key dedup is safe
        tkey = np.unique(
            (cts[:, 0] * np.int64(nc) + cts[:, 1]) * nc + cts[:, 2]
        )
        ct = np.stack(
            [tkey // (nc * nc), (tkey // nc) % nc, tkey % nc], axis=1
        )
    else:
        # Beyond ~2.09M coarse vertices the packed key wraps int64 and
        # silently corrupts the dedup; lexicographic row-unique is exact
        # at any size (same O(F log F), larger constant).
        ct = np.unique(cts, axis=0)
    return coarse_pts, ct, label


def decimate(mesh: TriMesh, target_n: int, seed: int = 0, edges=None):
    """Aggregation decimation to approximately ``target_n`` vertices (each
    round contracts ~3.5-4x; rounds stop once within 1.5x of the target, so
    the result lands in roughly [0.4, 1.5] * target_n).

    Returns (coarse TriMesh, fine_to_coarse i64 [N], coarse_rep i64 [Nc])
    where ``coarse_rep[j]`` is the fine vertex nearest the coarse centroid
    of cluster j (the prolongation representative)."""
    pts = np.asarray(mesh.points, np.float64)
    tris = np.asarray(mesh.triangles, np.int64)
    rng = np.random.default_rng(seed)
    fine_to_coarse = np.arange(pts.shape[0])
    cur_pts, cur_tris = pts, tris
    first_edges = edges  # fine-mesh edges apply to round 1 only
    while cur_pts.shape[0] > 1.5 * target_n:
        before = cur_pts.shape[0]
        cur_pts, cur_tris, label = _aggregate_once(
            cur_pts, cur_tris, rng, edges=first_edges
        )
        first_edges = None
        fine_to_coarse = label[fine_to_coarse]
        if cur_pts.shape[0] >= before:  # no progress (degenerate mesh)
            break
    # Representative fine vertex per coarse cluster: nearest to centroid.
    d2 = np.sum((pts - cur_pts[fine_to_coarse]) ** 2, axis=1)
    order = np.lexsort((d2, fine_to_coarse))
    first = np.ones(len(order), bool)
    first[1:] = fine_to_coarse[order[1:]] != fine_to_coarse[order[:-1]]
    rep = np.zeros(cur_pts.shape[0], np.int64)
    rep[fine_to_coarse[order[first]]] = order[first]
    coarse = TriMesh(
        np.asarray(cur_pts, np.float32), np.asarray(cur_tris, np.int32)
    )
    return coarse, fine_to_coarse, rep


def _weight_coords(graph: GraphArrays, cfg: PipelineConfig):
    """Coordinates the smoothing weights derive from: xyz, or xyz augmented
    with mean-range-scaled node_features when
    ``cfg.include_features_in_adj_matrix`` — the same augmentation
    ``pipeline._graph_weights`` applies (reference ``graph.py:166-175``:
    the smoothing operator's W carries the feature distances too)."""
    feats = graph.node_features
    if not (
        cfg.include_features_in_adj_matrix
        and feats is not None
        and feats.shape[1] > 0
    ):
        return graph.points
    mask = graph.valid_mask
    mn = jnp.min(jnp.where(mask[:, None] > 0, graph.points, jnp.inf), axis=0)
    mx = jnp.max(jnp.where(mask[:, None] > 0, graph.points, -jnp.inf), axis=0)
    mean_range = jnp.mean(mx - mn)
    return jnp.concatenate(
        [graph.points, feats * mean_range * mask[:, None]], axis=1
    )


@partial(jax.jit, static_argnames=("cfg",))
@f32_matmuls
def _refine_fine_level(
    target: GraphArrays, source: GraphArrays, init_corr, cfg: PipelineConfig
):
    """Fine-resolution correspondence refinement: the reference's smoothing
    + final-location stages (``focusr.py:368-431``) from a given initial
    correspondence — the tail of ``register_pair`` without spectra/CPD."""
    wc_t = _weight_coords(target, cfg)
    wc_s = _weight_coords(source, cfg)
    w_t = graph_ops.edge_weights(wc_t, target.neighbors, target.nbr_mask)
    w_s = graph_ops.edge_weights(wc_s, source.neighbors, source.nbr_mask)
    ov_t, ov_s = target.overflow, source.overflow
    ovw_t = graph_ops.overflow_weights(wc_t, ov_t)
    ovw_s = graph_ops.overflow_weights(wc_s, ov_s)
    tmask = target.valid_mask[:, None]
    smooth_fn = (
        graph_ops.mean_filter_chebyshev
        if cfg.smoothing_method == "chebyshev"
        else graph_ops.mean_filter
    )
    corr = init_corr
    smoothed_tgt = target.points
    projected = source.points
    if cfg.smooth_correspondences:
        smoothed_tgt = smooth_fn(
            target.neighbors, w_t, target.points,
            cfg.graph_smoothing_iterations, ov_t, ovw_t,
        )
        gathered = smoothed_tgt[init_corr]
        projected = smooth_fn(
            source.neighbors, w_s, gathered,
            cfg.projection_smooth_iterations, ov_s, ovw_s,
        )
    # One k=3 query serves both the final correspondence (column 0) and
    # the IDW locations — saves a full [N, N] NN pass (ops.knn.knn3_masked).
    d3, i3 = knn3_masked(smoothed_tgt, target.valid_mask, projected)
    if cfg.smooth_correspondences:
        corr = i3[:, 0]
    weighted = idw_from_knn(d3, i3, target.points)
    smask = source.valid_mask[:, None]
    return {
        "correspondences": corr * source.valid_mask.astype(corr.dtype),
        "initial_correspondences": init_corr
        * source.valid_mask.astype(init_corr.dtype),
        "nearest_points": target.points[corr] * smask,
        "weighted_points": weighted * smask,
        "average_points": (source.points + weighted) / 2.0 * smask,
        "smoothed_target_coords": smoothed_tgt * tmask,
        "source_projected_on_target": projected * smask,
    }


# Above this fine vertex count the refine runs host-staged, so that the
# untraced KNN can route to the O(N) voxel-grid path (ops/grid_knn.py),
# which beats brute force at large N (on an H100 the two cross near
# ~6e5 vertices, ops/knn.py); staging alone changes no result.  The
# 600k value was chosen on the hardware the repo first targeted and no
# H100 measurement has re-decided it.  Override via
# PYFOCUSR_TPU_STAGED_REFINE_N (0 = off).
_STAGED_REFINE_N = int(os.environ.get("PYFOCUSR_TPU_STAGED_REFINE_N", "600000"))


@partial(jax.jit, static_argnames=("iterations", "method", "cfg"))
@f32_matmuls
def _smooth_graph_jit(
    graph: GraphArrays, values, iterations: int, method: str,
    cfg: PipelineConfig = None,
):
    wc = graph.points if cfg is None else _weight_coords(graph, cfg)
    w = graph_ops.edge_weights(wc, graph.neighbors, graph.nbr_mask)
    ovw = graph_ops.overflow_weights(wc, graph.overflow)
    fn = (
        graph_ops.mean_filter_chebyshev
        if method == "chebyshev"
        else graph_ops.mean_filter
    )
    return fn(graph.neighbors, w, values, iterations, graph.overflow, ovw)


def _refine_fine_level_staged(
    target: GraphArrays, source: GraphArrays, init_corr, cfg: PipelineConfig,
    ckpt=None,
):
    """The same math as :func:`_refine_fine_level` with each heavy stage
    dispatched as its own compiled program (smoothings jitted per graph;
    the KNN stages run outside any enclosing jit, so they can take the
    voxel-grid path).  Gated equal to the fused refine by
    tests/test_multires.py.

    ``ckpt`` (utils.checkpoint.StageCheckpointer): persists each smoothing
    stage — the two dominant device costs at multi-million scale — so a
    faulted run resumes past them (see ``register_pair_multires``).
    """
    tmask = target.valid_mask[:, None]
    corr = init_corr
    smoothed_tgt = target.points
    projected = source.points
    if cfg.smooth_correspondences:
        def _smooth_target():
            return _smooth_graph_jit(
                target, target.points, cfg.graph_smoothing_iterations,
                cfg.smoothing_method, cfg,
            )

        smoothed_tgt = (
            ckpt.get_or("refine_smoothed_target", _smooth_target)
            if ckpt is not None else _smooth_target()
        )

        def _smooth_projection():
            gathered = smoothed_tgt[init_corr]
            return _smooth_graph_jit(
                source, gathered, cfg.projection_smooth_iterations,
                cfg.smoothing_method, cfg,
            )

        projected = (
            ckpt.get_or("refine_projected", _smooth_projection)
            if ckpt is not None else _smooth_projection()
        )
    d3, i3 = knn3_masked(smoothed_tgt, target.valid_mask, projected)
    if cfg.smooth_correspondences:
        corr = i3[:, 0]
    weighted = idw_from_knn(d3, i3, target.points)
    smask = source.valid_mask[:, None]
    return {
        "correspondences": corr * source.valid_mask.astype(corr.dtype),
        "initial_correspondences": init_corr
        * source.valid_mask.astype(init_corr.dtype),
        "nearest_points": target.points[corr] * smask,
        "weighted_points": weighted * smask,
        "average_points": (source.points + weighted) / 2.0 * smask,
        "smoothed_target_coords": smoothed_tgt * tmask,
        "source_projected_on_target": projected * smask,
    }


def _aggregate_features(feats, label, nc):
    """Cluster-mean aggregation of per-vertex features onto the coarse
    mesh (features are already normalized; the mean preserves scale).
    Per-column np.bincount, not np.add.at — unbuffered-ufunc indexing
    was the measured decimation hotspot at 240k (see _luby_mis_numpy)."""
    acc = np.stack(
        [
            np.bincount(
                label, weights=feats[:, k].astype(np.float64), minlength=nc
            )
            for k in range(feats.shape[1])
        ],
        axis=1,
    )
    cnt = np.bincount(label, minlength=nc).astype(np.float64)[:, None]
    return (acc / np.maximum(cnt, 1.0)).astype(np.float32)


def _map_landmarks(landmark_pairs, map_t, map_s, target_mesh, source_mesh):
    """Validate FINE (source_vertex, target_vertex) pins and map them
    through the decimation cluster labels; several fine pins landing in
    one coarse cluster keep the first (consistent picks agree at cluster
    scale anyway).  Returns deduplicated i64 [L, 2] coarse pairs."""
    lm = np.asarray(landmark_pairs, np.int64)
    if lm.ndim != 2 or lm.shape[1] != 2:
        raise ValueError(f"landmark_pairs must be [L, 2], got {lm.shape}")
    if lm.size and (
        lm[:, 0].min() < 0
        or lm[:, 0].max() >= source_mesh.n_points
        or lm[:, 1].min() < 0
        or lm[:, 1].max() >= target_mesh.n_points
    ):
        raise ValueError(
            "landmark_pairs index out of range for the FINE meshes "
            f"(source {source_mesh.n_points}, target "
            f"{target_mesh.n_points} vertices)"
        )
    c = np.stack([map_s[lm[:, 0]], map_t[lm[:, 1]]], axis=1)
    _, first = np.unique(c[:, 0], return_index=True)
    return c[np.sort(first)]


def _run_fingerprint(
    target_mesh, source_mesh, cfg, key, coarse_n, seed,
    landmark_pairs, node_features, level_ratio,
) -> str:
    """Hash of every register_pair_multires input that determines its
    outputs — the validity token for stage checkpoints.  Mesh point_data is
    deliberately excluded: the registration never reads it (features enter
    only via the explicitly-hashed ``node_features``)."""
    import hashlib

    h = hashlib.sha256()
    h.update(b"pyfocusr_tpu-multires-ckpt-v1")
    for arr in (
        target_mesh.points, target_mesh.triangles,
        source_mesh.points, source_mesh.triangles,
    ):
        a = np.asarray(arr)
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    h.update(repr(cfg).encode())
    try:  # new-style typed PRNG keys refuse np.asarray; hash the raw bits
        key_bits = jax.random.key_data(key)
    except TypeError:
        key_bits = key
    h.update(np.asarray(key_bits).tobytes())
    h.update(str((int(coarse_n), int(seed), float(level_ratio or 0))).encode())
    if landmark_pairs is not None:
        h.update(np.asarray(landmark_pairs, np.int64).tobytes())
    if node_features is not None:
        for f in node_features:
            a = np.asarray(f, np.float32)
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    return h.hexdigest()


def register_pair_multires(
    target_mesh: TriMesh,
    source_mesh: TriMesh,
    cfg: PipelineConfig,
    key,
    coarse_n: int = 12000,
    seed: int = 0,
    device_mesh=None,
    landmark_pairs=None,
    node_features=None,
    topologies=None,
    checkpoint_dir: str | None = None,
    level_ratio: float = 100.0,
):
    """Full-resolution registration of arbitrarily large mesh pairs.

    1. Decimate both meshes to <= ``coarse_n`` (graph aggregation, host).
    2. Register the coarse pair with the full spectral pipeline.
    3. Prolong: fine source vertex -> its coarse cluster -> coarse
       correspondence -> representative fine target vertex.
    4. Refine at full resolution (reference smoothing + final locations).

    ``landmark_pairs`` (i64/i32 [L, 2] FINE-resolution (source_vertex,
    target_vertex) pairs): mapped through the decimation clusters and
    applied as MAP-CPD priors to the COARSE registration (see
    ``register_pair``).  The pins guide the coarse map; the fine refine
    then smooths freely, so landmark influence is soft at full resolution
    (cluster-sized, ~``n_fine/coarse_n`` vertices around each pin).
    Fine pins that collapse into the same coarse cluster are deduplicated
    (first wins).

    ``node_features`` (``(target_feats [Nt, K], source_feats [Ns, K])``,
    normalized like ``GraphArrays.node_features``): enables the
    feature-weighted configs at scale — decimation aggregates features per
    cluster (mean) for the coarse spectral registration, and the fine
    refine's smoothing weights carry the feature-augmented distances when
    ``include_features_in_adj_matrix`` is set (``_weight_coords``).

    Returns (results dict from ``_refine_fine_level`` at fine resolution,
    coarse results dict).  Time/memory scale linearly with fine N.

    ``device_mesh`` (single-axis ``jax.sharding.Mesh``): runs step 4
    vertex-sharded over the mesh's devices
    (``parallel.bigmesh.refine_fine_level_sharded``) — per-chip HBM and
    smoothing/KNN work drop to O(N/P) while the coarse solve (fixed
    budget) stays on one device.  Results match the single-device refine
    to f32 roundoff (tests/test_bigmesh.py).

    The fine refinement uses 'kd' final correspondences; an O(N^2)-memory
    'hungarian' assignment is exactly what multi-resolution exists to avoid
    at this scale, so that configuration is rejected explicitly.

    ``level_ratio``: maximum per-level contraction before an intermediate
    resolution is inserted at the geometric mean (recursively — e.g. a
    3.84M pair with coarse_n=12000, ratio 320, runs 12k -> ~215k -> 3.84M
    with ~18x jumps).  A single extreme jump leaves the prolonged init
    piecewise-constant over ratio-sized clusters AND forces the
    ratio-scaled projection-smoothing budget below; intermediate levels
    start each refine closer and smooth less.  Set 0/None for the old
    single-jump behavior.  The default 100 is measured on the bundled-pair
    subdivisions: at ratio 80 (960k/12k) the extra level changed NOTHING
    (unique 0.8662 both ways) and cost ~25% more wall time, while at
    ratio 107 (1.28M/12k) it lifted uniqueness 0.854 -> 0.872 at slightly
    better surface distance — so levels are inserted only beyond the
    ratio where they demonstrably pay.

    ``checkpoint_dir``: persist finished stages so a faulted run (at
    multi-million vertices a registration spans minutes of device stages)
    resumes instead of restarting.  Stage files are fingerprinted over EVERY
    functional input (meshes, cfg, key, coarse_n, seed, landmarks,
    features); a mismatch recomputes, so a stale directory can never leak
    wrong results — delete the directory to force a full rerun.  Saved
    stages: the coarse solve (+ prolonged init) always; the two fine
    smoothing stages when the host-staged refine runs (vertex counts >=
    PYFOCUSR_TPU_STAGED_REFINE_N, default 600k — exactly the runs long
    enough to care).  The ``device_mesh`` sharded refine checkpoints only
    the coarse stage.
    """
    if (
        cfg.final_correspondence_type != "kd"
        or cfg.initial_correspondence_type != "kd"
    ):
        # The initial type also runs at the COARSE level, where the two
        # independently decimated meshes almost never have equal vertex
        # counts — rejecting it here replaces a confusing 'vertex counts
        # don't match' error from deep inside the coarse stage.
        raise ValueError(
            "register_pair_multires uses 'kd' correspondences at every "
            "level; 'hungarian' at full resolution defeats the multi"
            "resolution decomposition, and at the coarse level the two "
            "independently decimated meshes rarely have the equal vertex "
            "counts it requires (set initial/final_correspondence_type='kd')"
        )
    feature_cfg = (
        cfg.use_features_as_coords
        or cfg.use_features_in_graph
        or cfg.include_features_in_adj_matrix
    )
    if feature_cfg and node_features is None:
        # Without explicit features the feature-weighted stages would
        # silently fall back to featureless weighting — reject loudly.
        raise ValueError(
            "feature-weighted configs need node_features=(target_feats, "
            "source_feats) — fine-resolution normalized [N, K] arrays; "
            "decimation aggregates them per cluster for the coarse level"
        )
    if device_mesh is not None and cfg.include_features_in_adj_matrix:
        raise ValueError(
            "include_features_in_adj_matrix is not supported with "
            "device_mesh (the sharded fine refine builds featureless "
            "smoothing weights); drop device_mesh or that option"
        )
    feats_t = feats_s = None
    if node_features is not None:
        feats_t, feats_s = node_features
        feats_t = np.asarray(feats_t, np.float32)
        feats_s = np.asarray(feats_s, np.float32)
        if (
            feats_t.ndim != 2
            or feats_s.ndim != 2
            or feats_t.shape[0] != target_mesh.n_points
            or feats_s.shape[0] != source_mesh.n_points
            or feats_t.shape[1] != feats_s.shape[1]
        ):
            raise ValueError(
                "node_features must be ([N_target, K], [N_source, K]) "
                f"matching the fine meshes; got {feats_t.shape} and "
                f"{feats_s.shape}"
            )
    # Fine topologies are needed for the refine stage anyway — build them
    # once and feed the edge lists into decimation's first round (the
    # extraction is the dominant host cost at multi-million scale).
    # ``topologies=(topo_t, topo_s)`` lets callers that already built them
    # (the CLI does for --features) skip the duplicate pass.
    if topologies is not None:
        topo_t, topo_s = topologies
    else:
        topo_t = build_topology(
            np.asarray(target_mesh.triangles), target_mesh.n_points
        )
        topo_s = build_topology(
            np.asarray(source_mesh.triangles), source_mesh.n_points
        )
    ckpt = None
    if checkpoint_dir is not None:
        from .utils.checkpoint import StageCheckpointer

        ckpt = StageCheckpointer(
            checkpoint_dir,
            _run_fingerprint(
                target_mesh, source_mesh, cfg, key, coarse_n, seed,
                landmark_pairs, node_features, level_ratio,
            ),
        )
        coarse_saved = ckpt.load("coarse")
        if coarse_saved is not None:
            init_fine = np.asarray(coarse_saved.pop("__init_fine__"))
            cs_n = int(coarse_saved.pop("__coarse_source_n__"))
            coarse_res = coarse_saved
            return _finish_multires(
                target_mesh, source_mesh, cfg, init_fine, cs_n, coarse_res,
                topo_t, topo_s, feats_t, feats_s, device_mesh, ckpt,
            )

    # --- Multi-level V-cycle: at extreme contraction ratios a single
    # coarse jump leaves the prolonged init piecewise-constant over huge
    # clusters (ratio fine vertices per coarse vertex) and forces a
    # ratio-scaled projection-smoothing budget to separate them.  Insert
    # an intermediate level at the geometric mean whenever the jump
    # exceeds ``level_ratio``: each level then prolongs from an init only
    # ~sqrt(ratio) coarse, so every refine starts closer and smooths less.
    n_fine = max(target_mesh.n_points, source_mesh.n_points)
    if level_ratio and n_fine > level_ratio * max(coarse_n, 1):
        import math as _math

        # Geometric mean, but never let the FINE-side jump itself exceed
        # level_ratio (sqrt(ratio) > level_ratio once ratio > level_ratio^2
        # — the mean alone would leave exactly the over-coarse init the
        # levels exist to prevent); the coarse-side remainder recurses.
        mid_n = max(
            int(round(_math.sqrt(float(n_fine) * coarse_n))),
            -(-n_fine // int(level_ratio)),
        )
        mt_mesh, mmap_t, mrep_t = decimate(
            target_mesh, mid_n, seed, edges=topo_t.edges
        )
        ms_mesh, mmap_s, _ = decimate(
            source_mesh, mid_n, seed + 1, edges=topo_s.edges
        )
        n_mid = max(mt_mesh.n_points, ms_mesh.n_points)
        if n_mid < 0.8 * n_fine:
            mid_feats = None
            if feats_t is not None:
                mid_feats = (
                    _aggregate_features(feats_t, mmap_t, mt_mesh.n_points),
                    _aggregate_features(feats_s, mmap_s, ms_mesh.n_points),
                )
            mid_lm = None
            if landmark_pairs is not None:
                mid_lm = _map_landmarks(
                    landmark_pairs, mmap_t, mmap_s, target_mesh, source_mesh
                )
            # The recursion inserts further levels until each jump is
            # small; its own checkpoints live in a per-level subdirectory
            # (same "coarse" stage name, different fingerprint — they must
            # not overwrite each other's files).  device_mesh passes
            # through so a sharded run's intermediate refines scale too.
            mid_res, _ = register_pair_multires(
                mt_mesh, ms_mesh, cfg, key, coarse_n=coarse_n, seed=seed,
                device_mesh=device_mesh,
                landmark_pairs=mid_lm, node_features=mid_feats,
                checkpoint_dir=(
                    None if checkpoint_dir is None
                    else os.path.join(
                        checkpoint_dir, f"level_{mt_mesh.n_points}"
                    )
                ),
                level_ratio=level_ratio,
            )
            mid_corr = np.asarray(mid_res["correspondences"], np.int64)
            init_fine = mrep_t[mid_corr[mmap_s]]
            return _save_coarse_and_finish(
                target_mesh, source_mesh, cfg, init_fine,
                ms_mesh.n_points, mid_res, topo_t, topo_s, feats_t,
                feats_s, device_mesh, ckpt,
            )
        # Decimation stalled short of a useful intermediate level (e.g. a
        # fragment soup whose components each collapsed to one vertex and
        # then stopped contracting): fall through to the single-jump path,
        # which degrades gracefully instead of recursing on an
        # equal-sized mesh forever.

    ct_mesh, map_t, rep_t = decimate(target_mesh, coarse_n, seed, edges=topo_t.edges)
    cs_mesh, map_s, rep_s = decimate(
        source_mesh, coarse_n, seed + 1, edges=topo_s.edges
    )
    cf_t = cf_s = None
    if feats_t is not None:
        cf_t = _aggregate_features(feats_t, map_t, ct_mesh.n_points)
        cf_s = _aggregate_features(feats_s, map_s, cs_mesh.n_points)
    ct = mesh_to_graph_arrays(ct_mesh, node_features=cf_t)
    cs = mesh_to_graph_arrays(cs_mesh, node_features=cf_s)
    lm_coarse = None
    if landmark_pairs is not None:
        c = _map_landmarks(
            landmark_pairs, map_t, map_s, target_mesh, source_mesh
        )
        # The coarse CPD subsample must exceed the pin count (pipeline
        # guard) — at aggressive coarse_n every cluster can end up pinned.
        n_reg_coarse = min(
            cfg.n_coords_spectral_registration,
            ct_mesh.n_points,
            cs_mesh.n_points,
        )
        if len(c) >= n_reg_coarse:
            raise ValueError(
                f"{len(c)} landmark pins survive decimation but the coarse "
                f"CPD subsample is only {n_reg_coarse} points; raise "
                "coarse_n (more clusters) or thin the landmarks"
            )
        lm_coarse = jnp.asarray(c, jnp.int32)
    coarse_res = register_pair(ct, cs, cfg, key, landmark_pairs=lm_coarse)
    coarse_corr = np.asarray(coarse_res["correspondences"], np.int64)
    init_fine = rep_t[coarse_corr[map_s]]
    return _save_coarse_and_finish(
        target_mesh, source_mesh, cfg, init_fine, cs_mesh.n_points,
        coarse_res, topo_t, topo_s, feats_t, feats_s, device_mesh, ckpt,
    )


def _save_coarse_and_finish(
    target_mesh, source_mesh, cfg, init_fine, cs_n, coarse_res,
    topo_t, topo_s, feats_t, feats_s, device_mesh, ckpt,
):
    """Persist the "coarse" stage (everything the fine stage needs: the
    prolonged init, the coarse source size that sets the projection-
    smoothing budget, and the returned coarse dict) and run the fine half
    — shared by the single-jump and multi-level branches so the
    checkpoint payload can never diverge between them."""
    if ckpt is not None:
        ckpt.save(
            "coarse",
            {
                **coarse_res,
                "__init_fine__": np.asarray(init_fine, np.int64),
                "__coarse_source_n__": np.int64(cs_n),
            },
        )
    return _finish_multires(
        target_mesh, source_mesh, cfg, init_fine, cs_n, coarse_res,
        topo_t, topo_s, feats_t, feats_s, device_mesh, ckpt,
    )


def _finish_multires(
    target_mesh, source_mesh, cfg, init_fine, cs_n, coarse_res,
    topo_t, topo_s, feats_t, feats_s, device_mesh, ckpt,
):
    """Fine-level half of :func:`register_pair_multires` (everything after
    the coarse solve) — split out so a checkpoint resume can enter here
    directly with the saved coarse artifacts."""
    # The prolonged correspondence is piecewise-constant over coarse
    # clusters (~ratio fine vertices share one target), so the fine-level
    # projection smoothing must diffuse far enough to separate cluster
    # members.  Swept on the 60k pair (ratio 4.3): 1 iteration leaves
    # unique fraction at 0.74 (below the direct-registration 0.87), ~5x
    # ratio reaches 0.85 at equal surface distance, and beyond ~70 the
    # extra smoothing starts degrading surface distance — hence the cap.
    # The cap itself scales with EXTREME contraction ratios: at 3.84M
    # (ratio 320) the fixed 100 left uniqueness at 0.773, while 300
    # iterations reached 0.804 at unchanged surface distance (0.033 vs
    # 0.035 mm) — so the ceiling is max(100, ratio).
    ratio = source_mesh.n_points / max(cs_n, 1)
    # Cap only the AUTO-derived term: an explicitly configured larger
    # projection_smooth_iterations is the user's call and is honored.
    proj_iters = max(
        cfg.projection_smooth_iterations,
        min(int(round(5.0 * ratio)), max(100, int(round(ratio)))),
    )
    fine_cfg = dataclasses.replace(
        cfg, projection_smooth_iterations=proj_iters
    )

    tg = mesh_to_graph_arrays(target_mesh, topology=topo_t, node_features=feats_t)
    sg = mesh_to_graph_arrays(source_mesh, topology=topo_s, node_features=feats_s)
    if device_mesh is not None:
        from .parallel.bigmesh import refine_fine_level_sharded

        fine_res = refine_fine_level_sharded(
            tg, sg, jnp.asarray(init_fine, jnp.int32), fine_cfg, device_mesh
        )
        return fine_res, coarse_res
    if _STAGED_REFINE_N > 0 and (
        max(tg.n_points, sg.n_points) >= _STAGED_REFINE_N
    ):
        fine_res = _refine_fine_level_staged(
            tg, sg, jnp.asarray(init_fine, jnp.int32), fine_cfg, ckpt=ckpt
        )
    else:
        # The fused single-program refine has no host seams to checkpoint
        # at — below the staged threshold the whole refine is one short
        # device step, so the coarse checkpoint is the useful one anyway.
        fine_res = _refine_fine_level(
            tg, sg, jnp.asarray(init_fine, jnp.int32), fine_cfg
        )
    return fine_res, coarse_res
