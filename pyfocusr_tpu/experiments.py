"""Measured-neutral alternative schedules, kept out of the mainline config.

Both entry points here were implemented, verified for exactness, and then
benched NEUTRAL-OR-SLOWER at the bundled 5k-15k sizes on the hardware the
repo first targeted (not re-measured on a GPU), so neither is
reachable from ``PipelineConfig`` (round-2 measurements, preserved here so
the negative results are reproducible rather than re-discovered):

* ``spectrum_union`` — solve BOTH meshes' eigenproblems in one Chebyshev
  run on their disjoint-union graph (block-diagonal Laplacian,
  per-partition Rayleigh-Ritz).  Matches separate solves to |cos| >= 0.9999
  but benched neutral: the filter is throughput-bound, and union ops cost
  proportionally more.
* ``spectrum_batched`` — pad the two graphs to a common static shape and
  vmap one eigensolve over them.  Benched SLOWER (batched gathers).

They may win on future toolchains (lower dispatch floors) or much smaller
meshes, where per-solve fixed costs dominate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .ops import graph_ops
from .ops.eigen import chebyshev_eigpairs
from .pipeline import (
    GraphArrays,
    PipelineConfig,
    _masked_minmax_norm,
    _pad_graph_arrays,
    _spectrum,
)


def spectrum_union(
    target: GraphArrays, source: GraphArrays, k: int, key, cfg: PipelineConfig
):
    """Both meshes' spectra from ONE eigensolve on their disjoint union.

    The union Laplacian is block-diagonal, so a single Chebyshev-filtered
    subspace of width 2k+extra serves both meshes, amortizing the
    (dispatch-latency-bound) filter iterations across the pair; the final
    per-partition Rayleigh-Ritz in ops/eigen.py recovers exact per-mesh
    eigenpairs even though similar meshes make the union spectrum
    near-doubly-degenerate.  Returns (lams [2,k], vecs_t [Nt,k], vecs_s [Ns,k]).

    xyz-only: this measurement harness builds the plain random-walk
    Laplacian and would silently benchmark a DIFFERENT operator than
    pipeline._spectrum under feature-weighted configs, so those are
    rejected up front.
    """
    if cfg.include_features_in_adj_matrix or cfg.use_features_in_graph:
        raise ValueError(
            "spectrum_union benchmarks the xyz-only Laplacian; "
            "feature-weighted graph configs are not supported here"
        )
    nt, ns = target.n_points, source.n_points
    dt, ds = target.neighbors.shape[1], source.neighbors.shape[1]
    d_pad = max(dt, ds)

    def pad_deg(g, d):
        nbrs = jnp.pad(g.neighbors, ((0, 0), (0, d_pad - d)))
        mask = jnp.pad(g.nbr_mask, ((0, 0), (0, d_pad - d)))
        return nbrs, mask

    nb_t, ms_t = pad_deg(target, dt)
    nb_s, ms_s = pad_deg(source, ds)
    points = jnp.concatenate([target.points, source.points])
    neighbors = jnp.concatenate([nb_t, nb_s + nt])
    nbr_mask = jnp.concatenate([ms_t, ms_s])
    valid = jnp.concatenate([target.valid_mask, source.valid_mask])
    ct, cs = target.null_indicators.shape[1], source.null_indicators.shape[1]
    nulls = jnp.zeros((nt + ns, ct + cs), jnp.float32)
    nulls = nulls.at[:nt, :ct].set(target.null_indicators)
    nulls = nulls.at[nt:, ct:].set(source.null_indicators)
    # Overflow: padding rows are src==dst, preserved under the +nt offset.
    overflow = jnp.concatenate([target.overflow, source.overflow + nt])
    union = GraphArrays(points, neighbors, nbr_mask, valid, nulls, overflow)

    mask = union.valid_mask
    w = graph_ops.edge_weights(union.points, union.neighbors, union.nbr_mask)
    ov = union.overflow
    ov_w = graph_ops.overflow_weights(union.points, ov)
    d = graph_ops.degree_vector(w, ov, ov_w)
    g = jnp.where(mask > 0, (d + graph_ops.DEGREE_EPS) ** -1, 1.0)
    sdiag = jnp.sqrt(g)

    def matvec(x):
        ax = graph_ops.sym_laplacian_matvec(
            union.neighbors, w, g, x * mask, ov, ov_w
        )
        return ax * mask

    null_basis = union.null_indicators * (1.0 / sdiag)[:, None] * mask[:, None]
    ws = graph_ops.spmv(union.neighbors, w, sdiag, ov, ov_w)
    lam_bound = jnp.max(mask * sdiag * (sdiag * d + ws))
    part = jnp.stack(
        [
            jnp.concatenate([target.valid_mask, jnp.zeros((ns,), jnp.float32)]),
            jnp.concatenate([jnp.zeros((nt,), jnp.float32), source.valid_mask]),
        ],
        axis=1,
    )
    lams, vecs, _ = chebyshev_eigpairs(
        matvec, null_basis, key, k,
        degree=cfg.eig_cheb_degree, sweeps=cfg.eig_cheb_sweeps,
        refine_cg_iters=cfg.eig_cheb_refine_cg,
        subspace_mask=mask, lam_max_bound=lam_bound,
        partition_masks=part,
    )
    out = []
    for pidx, (sl, m_p) in enumerate(
        [(slice(0, nt), target.valid_mask), (slice(nt, nt + ns), source.valid_mask)]
    ):
        v = vecs[:, pidx, :] * sdiag[:, None]
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=0, keepdims=True), 1e-30)
        v = _masked_minmax_norm(v[sl], m_p)
        out.append(v)
    return lams, out[0], out[1]


def spectrum_batched(
    target: GraphArrays, source: GraphArrays, k: int, keys, cfg: PipelineConfig
):
    """vmap one eigensolve over the pair (padded to a common static shape).

    Returns (lams_t, vecs_t, lams_s, vecs_s) trimmed back to each mesh's
    own length.  ``keys``: [2, ...] PRNG keys, one per mesh.
    """
    n_pad = max(target.n_points, source.n_points)
    d_pad = max(target.neighbors.shape[1], source.neighbors.shape[1])
    c_pad = max(target.null_indicators.shape[1], source.null_indicators.shape[1])
    e_pad = max(target.overflow.shape[0], source.overflow.shape[0])
    tg_p = _pad_graph_arrays(target, n_pad, d_pad, c_pad, e_pad)
    sg_p = _pad_graph_arrays(source, n_pad, d_pad, c_pad, e_pad)
    both = jax.tree.map(lambda a, b: jnp.stack([a, b]), tg_p, sg_p)
    lams2, vecs2, _ = jax.vmap(lambda g, kk: _spectrum(g, k, kk, cfg))(
        both, jnp.stack([keys[0], keys[1]])
    )
    return (
        lams2[0],
        vecs2[0, : target.n_points],
        lams2[1],
        vecs2[1, : source.n_points],
    )
