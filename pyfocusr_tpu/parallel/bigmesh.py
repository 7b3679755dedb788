"""Intra-mesh model parallelism: ONE giant registration sharded over devices.

``parallel/cohort.py`` distributes *pairs* (data parallelism).  This module distributes a *single* multi-million-vertex pair's
fine-level stages over a device mesh, the missing half of the scaling
story: the reference tops out at 15k vertices single-threaded (SURVEY
§2/§5.7), the single-device multires path here reaches millions of
vertices, and beyond that one device's memory and wall-clock become the
wall.  The fine-level
refinement (the reference's correspondence-smoothing + final-location
stages, ``focusr.py:368-431``) is where multires spends its time at that
scale, and it decomposes cleanly:

* **Graph smoothing** (the 40-600-step mean filter): vertex rows are
  sharded over the 'verts' mesh axis; each step ``all_gather``s the
  current iterate (f32 [N, 3] — 46 MB at 3.84M vertices),
  applies the device's local ELL rows + hub-overflow edges, and keeps its
  shard.  Communication per step is the iterate, NOT the graph: neighbor
  tables, weights and degrees stay resident on their owner device, so
  memory per device is O(N/P).
* **KNN / IDW final locations**: query rows sharded, reference replicated
  (brute-force KNN is embarrassingly parallel over queries).

Hub-overflow edges are pre-partitioned by OWNER row (the src vertex's
shard), padded per shard with src == dst rows (weight 0 by construction,
``ops.graph_ops.overflow_weights``), so each device scatter-adds only
into rows it owns.

Numerics: every per-row operation is identical to the single-device
refine (same einsum contraction per row, same Chebyshev recurrence, same
KNN), so results match the unsharded ``multires._refine_fine_level`` to
f32 roundoff — gated by tests/test_bigmesh.py on the virtual 8-device
CPU mesh (SURVEY §4: "multi-chip without a cluster").

Entry points: :func:`refine_fine_level_sharded` (drop-in for the refine
stage) and ``multires.register_pair_multires(..., device_mesh=...)``
which routes its fine stage here.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import graph_ops
from ..ops.knn import idw_from_knn, knn3_masked
from ..utils.precision import f32_matmuls

try:  # JAX >= 0.4.35 public API, else experimental
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

__all__ = [
    "pad_rows_for_sharding",
    "partition_overflow_by_owner",
    "refine_fine_level_sharded",
]


def pad_rows_for_sharding(graph, n_shards: int):
    """Pad a GraphArrays' vertex axis to a multiple of ``n_shards``.

    Padding rows are dead coordinates: valid_mask 0, nbr_mask 0 (so every
    edge weight is 0), neighbors pointing at row 0 (any in-range index is
    safe under a zero mask), zero points/features/indicators.  Under the
    smoothing operator a padding row has degree 0, so it maps to itself
    and never influences a real row (nothing points at it).

    Returns (padded GraphArrays, original row count).
    """
    from ..pipeline import GraphArrays

    n = graph.n_points
    n_pad = -(-n // n_shards) * n_shards
    if n_pad == n:
        if graph.patch_plan is not None:
            # The patch-dense plan's arrays are not vertex-sharded (their
            # leading dims are plan-internal); strip it so the uniform
            # P('verts') spec tree stays valid.  The sharded refine never
            # runs an eigensolve, so nothing is lost.
            import dataclasses as _dc

            graph = _dc.replace(graph, patch_plan=None)
        return graph, n
    extra = n_pad - n

    def pad0(x):
        return jnp.pad(x, ((0, extra),) + ((0, 0),) * (x.ndim - 1))

    return (
        GraphArrays(
            points=pad0(graph.points),
            neighbors=pad0(graph.neighbors),
            nbr_mask=pad0(graph.nbr_mask),
            valid_mask=pad0(graph.valid_mask),
            null_indicators=pad0(graph.null_indicators),
            overflow=graph.overflow,
            node_features=pad0(graph.node_features),
        ),
        n,
    )


def partition_overflow_by_owner(overflow, n_rows: int, n_shards: int):
    """Group hub-overflow directed edges by the shard that owns their src
    row, padding each group to a common length with src == dst rows
    (weight 0, scatter into the shard's own first row — a no-op).

    ``overflow``: i32 [E, 2] global (src, dst).  Returns i32
    [n_shards * e_max, 2] laid out so a P('verts') shard_map spec hands
    each device exactly its own edges, src/dst still GLOBAL indices.
    """
    ov = np.asarray(overflow)
    rows_per = n_rows // n_shards
    if ov.shape[0] == 0:
        e_max = 1  # shard_map needs >= 1 row per shard to split evenly
        out = np.zeros((n_shards * e_max, 2), np.int32)
        for s in range(n_shards):
            out[s, :] = s * rows_per
        return jnp.asarray(out)
    # Drop pre-existing padding rows (src == dst); re-pad per owner below.
    ov = ov[ov[:, 0] != ov[:, 1]]
    owner = ov[:, 0] // rows_per
    counts = np.bincount(owner, minlength=n_shards)
    e_max = max(int(counts.max()), 1)
    out = np.zeros((n_shards, e_max, 2), np.int64)
    for s in range(n_shards):
        out[s, :, :] = s * rows_per  # padding: src == dst == own first row
        mine = ov[owner == s]
        out[s, : mine.shape[0]] = mine
    return jnp.asarray(out.reshape(n_shards * e_max, 2), jnp.int32)


def _local_weights(pts_full, pts_shard, nbr_shard, mask_shard):
    """Edge weights w = 1/dist for this shard's rows (global neighbor
    indices gathered from the replicated point array) — the sharded form
    of ``graph_ops.edge_weights``."""
    diff = pts_full[nbr_shard] - pts_shard[:, None, :]
    dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    safe = jnp.maximum(jnp.where(mask_shard > 0, dist, 1.0), 1e-20)
    return jnp.where(mask_shard > 0, 1.0 / safe, 0.0)


def _spmv_local(nbr, w, x_full, ov, ov_w, row0):
    """y_shard = (W x)_local: ELL gather over the replicated iterate plus
    the shard-owned overflow scatter (src localized by the shard's first
    global row ``row0``)."""
    y = jnp.einsum("nd,ndc->nc", w, x_full[nbr])
    if ov.shape[0] > 0:
        y = y.at[ov[:, 0] - row0].add(ov_w[:, None] * x_full[ov[:, 1]])
    return y


def _degree_local(w, ov, ov_w, row0):
    d = jnp.sum(w, axis=1)
    if ov.shape[0] > 0:
        d = d.at[ov[:, 0] - row0].add(ov_w)
    return d


def _mean_filter_sharded(axis, nbr, w, ov, ov_w, row0, x_shard, iterations):
    """Exact mean filter, row-sharded: out <- diag(1/(1+d))(W + I) out with
    one [N, C] all_gather per step (the single-device op is
    ``graph_ops.mean_filter``)."""
    inv = 1.0 / (1.0 + _degree_local(w, ov, ov_w, row0))

    def step(carry, _):
        full = jax.lax.all_gather(carry, axis, tiled=True)
        out = inv[:, None] * (_spmv_local(nbr, w, full, ov, ov_w, row0) + carry)
        return out, None

    x, _ = jax.lax.scan(step, x_shard, None, length=iterations)
    return x


def _mean_filter_chebyshev_sharded(
    axis, nbr, w, ov, ov_w, row0, x_shard, iterations
):
    """Chebyshev-accelerated mean filter, row-sharded (single-device op:
    ``graph_ops.mean_filter_chebyshev``; same degree rule and coefficients,
    so the two paths agree to the polynomial-truncation level)."""
    q = iterations
    degree = min(q, int(math.sqrt(2.0 * q * math.log(1e5))) + 8)
    if degree >= q:
        return _mean_filter_sharded(axis, nbr, w, ov, ov_w, row0, x_shard, q)

    d = _degree_local(w, ov, ov_w, row0)
    inv_sqrt = (1.0 + d) ** -0.5
    inv_sqrt_full = jax.lax.all_gather(inv_sqrt, axis, tiled=True)

    def s_op(v_shard):
        v_full = jax.lax.all_gather(v_shard, axis, tiled=True)
        u_full = inv_sqrt_full[:, None] * v_full
        u_local = inv_sqrt[:, None] * v_shard
        return inv_sqrt[:, None] * (
            _spmv_local(nbr, w, u_full, ov, ov_w, row0) + u_local
        )

    coeffs = jnp.asarray(
        graph_ops._chebyshev_power_coeffs(q, degree), jnp.float32
    )
    x0 = x_shard / inv_sqrt[:, None]
    t_prev = x0
    t_cur = s_op(x0)
    acc = coeffs[0] * t_prev + coeffs[1] * t_cur

    def body(kk, carry):
        t_prev, t_cur, acc = carry
        t_next = 2.0 * s_op(t_cur) - t_prev
        acc = acc + coeffs[kk] * t_next
        return t_cur, t_next, acc

    _, _, acc = jax.lax.fori_loop(2, degree + 1, body, (t_prev, t_cur, acc))
    return inv_sqrt[:, None] * acc


# Compiled sharded-refine programs, keyed by (cfg, axis name, device
# identities); rebuilding the shard_map closure per call would defeat
# jit's cache.
_PROGRAM_CACHE: dict = {}


def _build_program(cfg, device_mesh: Mesh, axis: str):
    smooth = (
        _mean_filter_chebyshev_sharded
        if cfg.smoothing_method == "chebyshev"
        else _mean_filter_sharded
    )

    def shard_fn(tgt, src, ic_shard):
        # tgt/src are per-shard GraphArrays slices: [N/P] rows carrying
        # GLOBAL neighbor/overflow indices; overflow rows are shard-owned.
        n_t_local = tgt.points.shape[0]
        n_s_local = src.points.shape[0]
        row0_t = jax.lax.axis_index(axis) * n_t_local
        row0_s = jax.lax.axis_index(axis) * n_s_local

        tpts_full = jax.lax.all_gather(tgt.points, axis, tiled=True)
        tmask_full = jax.lax.all_gather(tgt.valid_mask, axis, tiled=True)
        spts_full = jax.lax.all_gather(src.points, axis, tiled=True)

        w_t = _local_weights(tpts_full, tgt.points, tgt.neighbors, tgt.nbr_mask)
        w_s = _local_weights(spts_full, src.points, src.neighbors, src.nbr_mask)
        ovw_t = graph_ops.overflow_weights(tpts_full, tgt.overflow)
        ovw_s = graph_ops.overflow_weights(spts_full, src.overflow)

        corr = ic_shard
        smoothed_tgt = tgt.points  # shard
        smoothed_full = tpts_full
        projected = src.points  # shard
        if cfg.smooth_correspondences:
            smoothed_tgt = smooth(
                axis, tgt.neighbors, w_t, tgt.overflow, ovw_t, row0_t,
                tgt.points, cfg.graph_smoothing_iterations,
            )
            smoothed_full = jax.lax.all_gather(smoothed_tgt, axis, tiled=True)
            gathered = smoothed_full[ic_shard]
            projected = smooth(
                axis, src.neighbors, w_s, src.overflow, ovw_s, row0_s,
                gathered, cfg.projection_smooth_iterations,
            )
        # One k=3 query serves both the final correspondence (column 0)
        # and the IDW locations (ops.knn.knn3_masked).
        d3, i3 = knn3_masked(smoothed_full, tmask_full, projected)
        if cfg.smooth_correspondences:
            corr = i3[:, 0]
        weighted = idw_from_knn(d3, i3, tpts_full)
        smask = src.valid_mask[:, None]
        cdt = corr.dtype
        return {
            "correspondences": corr * src.valid_mask.astype(cdt),
            "initial_correspondences": ic_shard
            * src.valid_mask.astype(ic_shard.dtype),
            "nearest_points": tpts_full[corr] * smask,
            "weighted_points": weighted * smask,
            "average_points": (src.points + weighted) / 2.0 * smask,
            "smoothed_target_coords": smoothed_tgt * tgt.valid_mask[:, None],
            "source_projected_on_target": projected * smask,
        }

    def spec_tree(tree):
        return jax.tree.map(lambda _: P(axis), tree)

    @f32_matmuls  # a default-precision (TF32) matmul would corrupt the
    def run(tgt, src, ic):  # SpMV einsum / KNN numerics (utils/precision.py)
        fn = shard_map(
            shard_fn,
            mesh=device_mesh,
            in_specs=(spec_tree(tgt), spec_tree(src), P(axis)),
            out_specs=P(axis),
            check_vma=False,
        )
        return fn(tgt, src, ic)

    return jax.jit(run)


def refine_fine_level_sharded(target, source, init_corr, cfg, device_mesh: Mesh):
    """Fine-level correspondence refinement of ONE pair, vertex-sharded over
    ``device_mesh`` (single axis).  Same contract and same math as
    ``multires._refine_fine_level`` — the reference's smoothing +
    final-location stages (``focusr.py:368-431``) — with each device
    owning N/P vertex rows of both graphs.

    This refine builds FEATURELESS smoothing weights: graphs carrying
    node_features may arrive (use_features_as_coords affects only the
    coarse stage, so that combination is fine), but
    ``include_features_in_adj_matrix`` — which puts features into the
    smoothing weights (``multires._weight_coords``) — is rejected by
    ``register_pair_multires`` before reaching here.  If the single-device
    refine ever grows more feature awareness, this twin must follow or the
    documented single/multi-device parity breaks.
    """
    if len(device_mesh.axis_names) != 1:
        raise ValueError(
            "refine_fine_level_sharded expects a single-axis device mesh; "
            f"got axes {device_mesh.axis_names}"
        )
    axis = device_mesh.axis_names[0]
    n_dev = int(device_mesh.devices.size)

    n_t = target.n_points
    n_s = source.n_points
    tgt, _ = pad_rows_for_sharding(target, n_dev)
    src, _ = pad_rows_for_sharding(source, n_dev)
    tgt = dataclasses.replace(
        tgt, overflow=partition_overflow_by_owner(tgt.overflow, tgt.n_points, n_dev)
    )
    src = dataclasses.replace(
        src, overflow=partition_overflow_by_owner(src.overflow, src.n_points, n_dev)
    )
    ic = jnp.asarray(init_corr, jnp.int32)
    if src.n_points != n_s:
        ic = jnp.pad(ic, (0, src.n_points - n_s))  # padded rows are masked out

    # Key on device IDENTITY (not mesh object identity): callers often build
    # a fresh Mesh per call, and a rebuilt shard_map closure would defeat
    # jit's executable cache.  platform+id, not id alone: device ids restart
    # at 0 per backend, so a CPU debug mesh and a GPU mesh would collide.
    dev_ids = tuple((d.platform, d.id) for d in device_mesh.devices.ravel())
    cache_key = (cfg, axis, dev_ids)
    prog = _PROGRAM_CACHE.get(cache_key)
    if prog is None:
        prog = _build_program(cfg, device_mesh, axis)
        _PROGRAM_CACHE[cache_key] = prog
    out = prog(tgt, src, ic)

    def cut(name, x):
        n = n_t if name == "smoothed_target_coords" else n_s
        return x[:n]

    return {k: cut(k, v) for k, v in out.items()}
