"""Brute-force nearest-neighbor / top-k kernels (KD-tree replacement).

The reference uses scipy cKDTree in three places: the eigsort spatial cost
(``eigsort.py:203-204``), the spectral correspondence search
(``focusr.py:351-353``), and the k=3 weighted final locations
(``focusr.py:409-426``); plus dense ``cdist`` for Hungarian mode
(``focusr.py:342``).  On an accelerator, brute force wins at these sizes
(N <= ~50k, D <= ~12), and the top-k rides along with the distances.

Squared distances are direct coordinate differences, sum_d (q_d - r_d)^2,
in exact f32, which XLA fuses into the min/argmin (or top-k) that consumes
them; queries are chunked so one [Nq, Nr] distance block stays bounded.
On an H100 this plain form was faster end to end than a hand-written
Pallas/Triton kernel that kept the running top-k in registers, so no
kernel is kept.

Distances returned are *Euclidean* (sqrt applied at the end), matching
``KDTree.query``.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp

# Masked-out reference rows are pushed to this coordinate so they can never
# win a nearest-neighbor query.  Single source of truth — pipeline.py
# re-exports it (`from .ops.knn import SENTINEL`), and the padding below
# uses it too (1e30^2 overflows f32 to inf, so padded rows never win).
SENTINEL = 1e30

__all__ = [
    "nn_query",
    "knn_query",
    "pairwise_sq_dists",
    "idw_pull_k3",
    "knn3_masked",
    "idw_from_knn",
]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pairwise_sq_dists(query: jnp.ndarray, ref: jnp.ndarray) -> jnp.ndarray:
    """[Nq, Nr] squared distances by direct coordinate differences.

    Exact f32: no |q|^2+|r|^2-2q.r cancellation and no matmul whose
    precision could drop to TF32; XLA fuses the difference, square and sum
    into the reduction that consumes them.  Non-finite reference
    coordinates (padding or caller data) are pushed to SENTINEL, whose rows
    square to inf and never win.  The KNN queries, the CPD E-steps and the
    Hungarian cost all use this one form.  Unchunked, use it only when the
    [Nq, Nr] product fits in memory; the query paths below chunk it."""
    ref = jnp.where(jnp.isfinite(ref), ref, SENTINEL)
    return jnp.sum(jnp.square(query[:, None, :] - ref[None, :, :]), axis=-1)


# One [Nq_chunk, Nr] distance block must fit in device memory with
# headroom; at ~1M x 1M the unchunked block would be terabytes, so queries
# are processed in chunks of rows.  256M f32 elements = 1 GB per block.
_QUERY_CHUNK_ELEMS = 256 * 1024 * 1024


def _query_chunks(nq: int, nr: int) -> int:
    per_chunk = max(_QUERY_CHUNK_ELEMS // max(nr, 1), 8)
    return -(-nq // per_chunk)  # ceil


def _chunked_query(impl, ref, query):
    """Process a large query set in row chunks so one [Nq, Nr] distance
    block never exceeds ~1 GB (identity when one chunk suffices).
    ``impl(ref, query_chunk)`` returns a pytree of [per, ...] arrays; the
    chunked results are re-flattened to the original Nq rows."""
    nq = query.shape[0]
    n_chunks = _query_chunks(nq, ref.shape[0])
    if n_chunks <= 1:
        return impl(ref, query)
    per = -(-nq // n_chunks)
    per = _round_up(per, 8)
    nq_pad = per * (-(-nq // per))
    q_p = jnp.pad(query, ((0, nq_pad - nq), (0, 0)))
    chunks = q_p.reshape(nq_pad // per, per, query.shape[1])
    out = jax.lax.map(lambda qc: impl(ref, qc), chunks)
    return jax.tree.map(
        lambda x: x.reshape((nq_pad,) + x.shape[2:])[:nq], out
    )


# Route large UNTRACED 3-D queries to the O(N) voxel-grid path
# (ops/grid_knn.py) instead of the O(Nq*Nr) brute path.  The grid is
# exact (certified per row with brute fallback), so routing is purely a
# perf decision.  Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W power
# limit), synthetic bone pairs, Nq = Nr = N, k=1, both arms of nn_query:
# brute runs ~7.8e11-8.1e11 pairs/s (2.07 ms at N=40,962, 34.2 ms at
# 163,842); the grid costs 23 / 26 / 224 ms at N = 10,242 / 40,962 /
# 163,842, i.e. ~1.6 us per vertex above ~40k.  Extrapolated, brute and
# grid cross near N ~ 1.25M (~1.6e12 pairs); below MIN (N ~ 600k) brute
# takes at most half the grid's time, above SURE (N ~ 2.5M) at least
# twice it.  Between them the winner depends on the device and the input
# — those calls are settled by a MEASURED race-once-per-bucket planner
# (ops/knn_routing.py).  The k >= 2 bounds are halved because brute cost
# grows with k while the grid's is flat.
_GRID_MIN_PAIRS_DEFAULT = 3.5e11  # below: brute surely wins
_GRID_SURE_PAIRS_DEFAULT = 6e12  # above: grid surely wins


def _backend_pair_scale() -> float:
    """The band bounds above are GPU measurements.  A CPU backend is ~2
    orders slower at brute, so both bounds shrink — without this, a
    'race' at 1e12 pairs on CPU would spend minutes on the brute arm it
    was meant to avoid."""
    return 1.0 if jax.default_backend() == "gpu" else 0.01


def _grid_decision(ref, query, k: int) -> str:
    """'brute' | 'grid' | 'race'.  Grid path applies only outside jit
    (its per-row fallback needs dynamic shapes), in 3-D, for small k.
    ``PYFOCUSR_TPU_KNN_GRID`` = off|auto|on plus
    ``PYFOCUSR_TPU_KNN_GRID_MIN_PAIRS`` / ``_SURE_PAIRS`` override (all
    read per call); setting
    MIN_PAIRS == SURE_PAIRS recovers a pure static threshold."""
    mode = os.environ.get("PYFOCUSR_TPU_KNN_GRID", "auto").lower()
    if mode in ("off", "0"):
        return "brute"
    if isinstance(ref, jax.core.Tracer) or isinstance(query, jax.core.Tracer):
        return "brute"
    if ref.ndim != 2 or query.ndim != 2:
        return "brute"
    if ref.shape[1] != 3 or query.shape[1] != 3 or k > 8:
        return "brute"
    if mode in ("on", "1", "force"):
        return "grid"
    scale = _backend_pair_scale()
    min_env = os.environ.get("PYFOCUSR_TPU_KNN_GRID_MIN_PAIRS")
    sure_env = os.environ.get("PYFOCUSR_TPU_KNN_GRID_SURE_PAIRS")
    min_pairs = float(
        min_env if min_env is not None else _GRID_MIN_PAIRS_DEFAULT * scale
    )
    if sure_env is not None:
        sure_pairs = float(sure_env)
    elif min_env is not None:
        # Back-compat: before the race planner, MIN_PAIRS alone meant
        # "grid at/above this".  A user who tuned it (typically because
        # brute is slow on their backend) must not suddenly get races
        # that EXECUTE the brute path; an explicit MIN without SURE
        # recovers the old pure-threshold semantics.  Set SURE too to
        # opt into a race band.
        sure_pairs = min_pairs
    else:
        sure_pairs = _GRID_SURE_PAIRS_DEFAULT * scale
    if k > 1:
        min_pairs /= 2.0
        sure_pairs /= 2.0
    pairs = float(query.shape[0]) * float(ref.shape[0])
    if pairs < min_pairs:
        return "brute"
    if pairs >= max(sure_pairs, min_pairs):
        return "grid"
    return "race"


@partial(jax.jit, static_argnames=("k",))
def _brute_knn(ref, query, k: int):
    """The O(Nq*Nr) k-NN path — knn_query without the grid routing; also
    the grid path's fallback.  Jitted as a whole, so an untraced call
    compiles the chunk loop once per shape, not on every call."""
    return _chunked_query(lambda r, q: _knn_query_impl(r, q, k), ref, query)


@jax.jit
def _brute_nn(ref, query):
    """The O(Nq*Nr) 1-NN path of nn_query, jitted like _brute_knn."""
    return _chunked_query(_nn_query_impl, ref, query)


def nn_query(ref: jnp.ndarray, query: jnp.ndarray):
    """Nearest neighbor of each query point among ref points (see
    _nn_query_impl); very large query sets are processed in row chunks so
    one [Nq, Nr] distance block never exceeds ~1 GB; very large untraced
    3-D queries route to the O(N) voxel-grid path.  Both routes compute
    direct f32 coordinate differences."""
    dec = _grid_decision(ref, query, 1)
    if dec != "brute":
        from .grid_knn import knn_grid

        def _run_grid():
            return knn_grid(ref, query, 1, brute=_brute_knn)

        if dec == "race":
            from .knn_routing import bucket_key, routed

            return routed(
                bucket_key(query.shape[0], ref.shape[0], 1),
                {"grid": lambda: _first_column(_run_grid()),
                 "brute": lambda: _brute_nn(ref, query)},
            )
        return _first_column(_run_grid())
    return _brute_nn(ref, query)


def _first_column(knn_result):
    d, i = knn_result
    return d[:, 0], i[:, 0]


@jax.jit
def _nn_query_impl(ref: jnp.ndarray, query: jnp.ndarray):
    """Nearest neighbor of each query point among ref points.

    Returns (distances [Nq], indices [Nq]) — the same contract as
    ``KDTree(ref).query(query)`` (reference ``focusr.py:351-353``),
    lowest index first on ties.
    """
    nr = ref.shape[0]
    d2 = pairwise_sq_dists(query, ref)
    best_idx = jnp.argmin(d2, axis=1).astype(jnp.int32)
    best_d2 = jnp.take_along_axis(d2, best_idx[:, None], axis=1)[:, 0]
    # Rows with no finite neighbor report index nr (cKDTree's
    # missing-neighbor sentinel) — same remap as _knn_query_impl, so the
    # nn / knn / grid routes agree on degenerate inputs.
    best_idx = jnp.where(jnp.isinf(best_d2), nr, best_idx)
    return jnp.sqrt(jnp.maximum(best_d2, 0.0)), best_idx


def knn_query(ref: jnp.ndarray, query: jnp.ndarray, k: int):
    """k nearest neighbors of each query among ref (see _knn_query_impl);
    large query sets chunked like nn_query; very large untraced 3-D
    queries via the O(N) voxel grid."""
    dec = _grid_decision(ref, query, k)
    if dec != "brute":
        from .grid_knn import knn_grid

        def _run_grid():
            return knn_grid(ref, query, k, brute=_brute_knn)

        if dec == "race":
            from .knn_routing import bucket_key, routed

            return routed(
                bucket_key(query.shape[0], ref.shape[0], k),
                {"grid": _run_grid, "brute": lambda: _brute_knn(ref, query, k)},
            )
        return _run_grid()
    return _brute_knn(ref, query, k)


@partial(jax.jit, static_argnames=("k",))
def _knn_query_impl(ref: jnp.ndarray, query: jnp.ndarray, k: int):
    """k nearest neighbors of each query among ref, ascending by distance.

    Returns (distances [Nq, k], indices [Nq, k]) — the contract of
    ``KDTree(ref).query(query, k=k)`` (reference ``focusr.py:409-412``);
    ``lax.top_k`` keeps the lower index first on ties.
    """
    nr = ref.shape[0]
    d2 = pairwise_sq_dists(query, ref)
    if nr < k:
        d2 = jnp.pad(d2, ((0, 0), (0, k - nr)), constant_values=jnp.inf)
    neg_d2, best_idx = jax.lax.top_k(-d2, k)
    best_d2 = -neg_d2
    # nr < k: the missing neighbors carry inf distance (and a padded
    # index); remap those to index nr — cKDTree's missing-neighbor
    # sentinel (index == n, distance == inf) — so callers can detect them.
    # SENTINEL-coordinate reference rows also report inf and are equally
    # non-neighbors, so the same sentinel applies.
    best_idx = jnp.where(jnp.isinf(best_d2), nr, best_idx)
    return jnp.sqrt(jnp.maximum(best_d2, 0.0)), best_idx


def knn3_masked(ref_positions, ref_mask, query_points):
    """k=3 neighbors of ``query_points`` among the valid rows of
    ``ref_positions`` (``ref_mask == 0`` rows pushed to ``SENTINEL``).

    This is the shared query behind the pipeline's final-correspondence
    search AND its k=3 IDW final locations: both run against the same
    (smoothed-target, projected-source) pair, and the final NN
    correspondence is exactly column 0 of the k=3 result (identical
    tie rule: ascending distance, lowest index first — the cKDTree
    contract both ``nn_query`` and ``knn_query`` implement).  Fusing them
    removes an entire [Nq, Nr] NN pass from every refine tail."""
    ref_q = jnp.where(ref_mask[:, None] > 0, ref_positions, SENTINEL)
    return knn_query(ref_q, query_points, k=3)


def idw_from_knn(dists, idxs, ref_values):
    """Inverse-distance k=3 interpolation from a precomputed
    ``knn3_masked`` result — the reference's weighted final-location
    semantics (``focusr.py:401-426``) including the exact-hit shortcut
    (distance-0 neighbor wins outright)."""
    vals = ref_values[idxs]  # [Nq, 3, D]
    exact = dists <= 0.0
    any_exact = jnp.any(exact, axis=1)
    first = jnp.argmax(exact, axis=1)
    exact_vals = jnp.take_along_axis(vals, first[:, None, None], axis=1)[:, 0]
    wts = 1.0 / jnp.maximum(dists, 1e-30)
    out = jnp.sum(vals * wts[:, :, None], axis=1) / jnp.sum(
        wts, axis=1, keepdims=True
    )
    return jnp.where(any_exact[:, None], exact_vals, out)


def idw_pull_k3(ref_positions, ref_mask, ref_values, query_points):
    """k=3 inverse-distance interpolation of ``ref_values`` at
    ``query_points`` (``knn3_masked`` + ``idw_from_knn``).  Shared by the
    pipeline's final locations and groupwise map inversion; callers that
    also need the final NN correspondence should call the two halves
    directly and reuse ``idxs[:, 0]``.

    Degenerate input (``ref_mask`` all zero — no valid reference rows at
    all) yields NaN outputs (0/0 total weight) rather than a silent
    fabricated value; callers must pass at least one valid row."""
    dists, idxs = knn3_masked(ref_positions, ref_mask, query_points)
    return idw_from_knn(dists, idxs, ref_values)
