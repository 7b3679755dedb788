"""Grid-binned EXACT nearest-neighbor queries for large 3-D point sets.

The brute-force path in ``ops/knn.py`` is ideal up to a few hundred
thousand points (one fused pass, no data structures), but it is
O(Nq * Nr).  The multires fine tails query in
3-D *physical* space between two nearly-coincident surfaces (reference
``focusr.py:391-396, 409-412``), where a uniform voxel grid makes the
query O(N): bin the reference points into cells of side ``s``, sort by
cell id, and search each query's 3x3x3 cell block.

Exactness is *certified per row*, not assumed:

* a row is EXACT iff the ball of radius d_k around the query is contained
  in the searched slab (per axis: ``q - d_k >= lo + (c-1)s`` unless the
  block is grid-clipped on that side, in which case no reference points
  exist beyond it), no searched run overflowed the candidate cap, the
  binary searches converged (column length within the unrolled budget),
  and at least k candidates were found;
* all other rows fall back to the brute-force kernel (padded to a power
  of two to bound recompiles).  The result therefore matches
  ``knn_query`` — including the cKDTree tie rule (ascending distance,
  lowest original index first), enforced here by a k-pass lexicographic
  (distance^2, index) min-reduction — up to f32 rounding of genuinely
  ulp-tied neighbors (both compute direct (q - r)^2 differences, but
  summed in different orders).

Accelerator mapping (gathers are the floor, so the design minimizes
gathered rows per query):

* the 27 neighbor cells are walked as 9 (x, y) *runs* of 3 z-consecutive
  cells — consecutive cell ids, hence one contiguous span of the sorted
  array per run;
* run boundaries come from a DENSE per-(x, y)-column start table built by
  bincount + cumsum (no sorting, no searching) plus an 8-step unrolled
  binary search on the z-cell within the column (bone-mesh columns are
  ~9 points on average, p99 ~47 at the default cell size) — replacing
  global ``searchsorted`` cut the lookup cost ~2.5x;
* candidate coordinates and original indices are packed into one
  [M, 4] array so each slot costs ONE gathered row (f32 mantissa holds
  indices exactly up to 2^24; larger references use two gathers).

Everything inside ``_grid_search`` / ``_grid_select`` is static-shaped
and jit-compiled; the host orchestrates chunking, the spacing probe, and
the fallback (dynamic row counts are impossible under jit, which is why
``knn.py`` only routes *untraced* calls here).

Masked reference rows (coordinates at/above ~1e29, e.g. ``knn.SENTINEL``)
get an out-of-range cell id, sort to the end of the order, and are never
candidates, matching the brute kernels' masking semantics.

Index agreement with the brute path is 1.000000 on a 960k x 960k
noisy sphere (fallback 1.2% of rows).  Below the crossover the grid's
cost (build + spacing probe + staged dispatches) loses to brute force;
on an H100 the two cross near 6e5 x 6e5 (see knn.py).  The crossover
band is settled by MEASUREMENT, not a constant: knn.py routes
sure-win sizes statically and races both exact paths once per
shape-class bucket in between, persisting the winner per device kind
(ops/knn_routing.py).  Cell size 1.25x the median d_k, run cap 12
(per-query max-run occupancy p99 = 9 on the subdivided bone mesh).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["knn_grid", "last_stats"]

# Diagnostics of the most recent knn_grid call (fallback fraction, cell
# size, grid dims) — read by benchmarks/tests; not part of the API.
last_stats: dict = {}

# Coordinates at/above this magnitude mark masked rows (knn.SENTINEL=1e30).
_VALID_LIMIT = 1e29
# Cell side as a multiple of the median K-TH-neighbor distance (so the
# exactness margin covers the typical d_k regardless of geometry: on a
# near-regular mesh d_3 ~ d_1 but on a Poisson-like cloud d_3 ~ 2 d_1),
# and the candidate cap per (x, y) run of 3 z-cells.  Sizing by d_k also
# normalizes run occupancy: measured on the subdivided bone mesh (960k,
# k=3) mean candidates/query ~22 with per-query max-run p99 = 9, so cap
# 12 keeps overflow rare; rows whose local d_k exceeds the margin go to
# a 2x-cell second pass before any brute fallback.
_S_MULT = 1.25
_RUN_CAP = 12
# Unrolled in-column binary-search steps: a span of length L has L + 1
# possible lower-bound answers, so 8 steps converge only for L <= 255 —
# columns of >= 2^8 rows are certified to the fallback instead (the
# exactly-256 case was verified non-convergent).
_ZSEARCH_STEPS = 8
_MAX_COL = 1 << _ZSEARCH_STEPS
# Query rows per compiled chunk (static shape; last chunk padded).
_CHUNK = 65536
# Grid caps: total cells (cell ids stay well inside int32) and (x, y)
# columns (the dense start table is a [Gx*Gy + 1] int32 array).
_MAX_CELLS = 2 ** 30
_MAX_COLS = 2 ** 23
_INT32_MAX = np.int32(2 ** 31 - 1)
# Above this many reference rows, f32 mantissas can no longer hold the
# original indices exactly and the packed single-gather trick is replaced
# by two gathers.
_PACK_MAX_REF = 1 << 24


def _lower_bound_z(sorted_cz, lo0, hi0, target):
    """Unrolled binary search: first position in [lo0, hi0) whose z-cell
    is >= target.  All operands [n, 9]; converges for spans <= 2^steps
    (longer spans are excluded by the caller's column-length check)."""
    lo, hi = lo0, hi0
    m_max = sorted_cz.shape[0] - 1
    for _ in range(_ZSEARCH_STEPS):
        mid = (lo + hi) >> 1
        v = sorted_cz[jnp.minimum(mid, m_max)]
        less = v < target
        new_lo = jnp.where(less, mid + 1, lo)
        new_hi = jnp.where(less, hi, mid)
        active = lo < hi
        lo = jnp.where(active, new_lo, lo)
        hi = jnp.where(active, new_hi, hi)
    return lo


# NOTE: the grid chunk is deliberately TWO jitted programs, not one:
# compiling the unrolled binary searches together with the candidate
# gather sends XLA:CPU's fusion pass into a non-terminating compile
# ("Very slow compile?" then hang; reproduced with and without an
# optimization_barrier under the 8-virtual-device test env).  Each half
# compiles in < 1 s; the split costs one extra dispatch per chunk.


@jax.jit
def _grid_search(sorted_cz, colstart, query, lo, s, dims):
    """Stage 1: per query, the 9 (x, y)-column z-run spans [start, end)
    in the cell-sorted order, plus the query's cell and the column-budget
    flag."""
    cell = jnp.floor((query - lo[None, :]) / s).astype(jnp.int32)
    cell = jnp.clip(cell, 0, dims[None, :] - 1)
    cx, cy, cz = cell[:, 0], cell[:, 1], cell[:, 2]
    g_y = dims[1]

    # 9 (dx, dy) columns; in each, the z-run [cz-1, cz+1].
    offs = jnp.array(
        [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)], jnp.int32
    )
    rx = cx[:, None] + offs[None, :, 0]  # [n, 9]
    ry = cy[:, None] + offs[None, :, 1]
    ok = (rx >= 0) & (rx < dims[0]) & (ry >= 0) & (ry < g_y)
    colid = jnp.where(ok, rx * g_y + ry, 0)
    c_lo = jnp.where(ok, colstart[colid], 0)
    c_hi = jnp.where(ok, colstart[colid + 1], 0)
    col_too_long = jnp.any(c_hi - c_lo >= _MAX_COL, axis=1)

    z0 = (cz - 1)[:, None]
    z1 = (cz + 1)[:, None]
    start = _lower_bound_z(sorted_cz, c_lo, c_hi, z0)
    end = _lower_bound_z(sorted_cz, start, c_hi, z1 + 1)
    return cell, start, end, col_too_long


@partial(jax.jit, static_argnames=("k", "cap", "packed"))
def _grid_select(sorted_cz, packed_ref, aux_ord, query, cell, start, end,
                 col_too_long, lo, s, dims, k: int, cap: int, packed: bool):
    """Stage 2: gather the candidate slots, take the lexicographic top-k,
    and certify exactness.

    Returns (d2 [n, k], idx [n, k] original indices, exact [n] bool).
    Rows with ``exact == False`` carry unusable results and must be
    re-solved by the caller's fallback.
    """
    n = query.shape[0]
    counts = end - start

    pos = start[:, :, None] + jnp.arange(cap, dtype=jnp.int32)[None, None, :]
    valid_c = pos < end[:, :, None]
    posc = jnp.minimum(pos, sorted_cz.shape[0] - 1)
    if packed:
        cand = packed_ref[posc]  # [n, 9, cap, 4]: xyz + original index
        cpts = cand[..., :3]
        cidx = cand[..., 3].astype(jnp.int32)
    else:
        cpts = packed_ref[posc]
        cidx = aux_ord[posc]
    diff = query[:, None, None, :] - cpts
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(valid_c, d2, jnp.inf).reshape(n, 9 * cap)
    idxf = jnp.where(valid_c, cidx, _INT32_MAX).reshape(n, 9 * cap)

    # k-pass lexicographic (d2, index) min — the cKDTree tie rule.  Each
    # reference point appears in at most one run, so (d2 == m, idx == mi)
    # uniquely identifies the extracted candidate.
    d_out, i_out = [], []
    for _ in range(k):
        m = jnp.min(d2, axis=1)
        mi = jnp.min(
            jnp.where(d2 == m[:, None], idxf, _INT32_MAX), axis=1
        )
        d_out.append(m)
        i_out.append(mi)
        d2 = jnp.where(
            (d2 == m[:, None]) & (idxf == mi[:, None]), jnp.inf, d2
        )
    d2k = jnp.stack(d_out, axis=1)
    idxk = jnp.stack(i_out, axis=1)

    # --- Exactness certificate ---
    dk = jnp.sqrt(d2k[:, k - 1])
    cellf = cell.astype(query.dtype)
    left_b = jnp.where(
        cell <= 0, -jnp.inf, lo[None, :] + (cellf - 1.0) * s
    )
    right_b = jnp.where(
        cell >= dims[None, :] - 1, jnp.inf, lo[None, :] + (cellf + 2.0) * s
    )
    contained = jnp.all(
        (query - dk[:, None] >= left_b) & (query + dk[:, None] <= right_b),
        axis=1,
    )
    overflow = jnp.any(counts > cap, axis=1)
    enough = jnp.sum(jnp.minimum(counts, cap), axis=1) >= k
    exact = (
        contained & enough & ~overflow & ~col_too_long & jnp.isfinite(dk)
    )
    return d2k, idxk, exact


@jax.jit
def _grid_prep(ref):
    """Device-side preprocessing: validity mask, masked bbox, cleaned
    coordinates.  One fused program; only scalars/bitmask get pulled."""
    finite = jnp.all(
        jnp.isfinite(ref) & (jnp.abs(ref) < _VALID_LIMIT), axis=1
    )
    big = jnp.float32(_VALID_LIMIT)
    ref_clean = jnp.where(jnp.isfinite(ref), ref, big)
    fin = finite[:, None]
    lo = jnp.min(jnp.where(fin, ref_clean, big), axis=0)
    hi = jnp.max(jnp.where(fin, ref_clean, -big), axis=0)
    return finite, ref_clean, lo, hi


@partial(jax.jit, static_argnames=("n_cols", "packed"))
def _grid_build(ref_clean, finite, lo, s, dims, n_cols: int, packed: bool):
    """Sort by cell id and build the dense per-column start table
    (bincount + cumsum — no searching) plus the packed candidate array."""
    cell = jnp.clip(
        jnp.floor((ref_clean - lo[None, :]) / s).astype(jnp.int32),
        0,
        dims[None, :] - 1,
    )
    colid = cell[:, 0] * dims[1] + cell[:, 1]
    cid = colid * dims[2] + cell[:, 2]
    cid = jnp.where(finite, cid, _INT32_MAX)
    order = jnp.argsort(cid).astype(jnp.int32)
    sorted_cz = jnp.where(finite, cell[:, 2], _INT32_MAX)[order]
    counts = jnp.bincount(
        jnp.where(finite, colid, n_cols), length=n_cols + 1
    )[:n_cols]
    colstart = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts).astype(jnp.int32)]
    )
    if packed:
        packed_ref = jnp.concatenate(
            [ref_clean[order], order[:, None].astype(jnp.float32)], axis=1
        )
        aux = jnp.zeros((1,), jnp.int32)  # unused
    else:
        packed_ref = ref_clean[order]
        aux = order
    return sorted_cz, packed_ref, aux, colstart


def _estimate_dk(ref, finite_np, brute, k: int) -> float:
    """Median k-th-neighbor distance of the valid reference rows, from a
    strided sample probed against a (possibly subsampled, with 2-manifold
    density correction) reference subset.  Only the tiny sample results
    transfer to the host.

    The k-th distance (not the NN spacing) is what the exactness margin
    must cover: on a near-regular mesh d_3 ~ d_1, but on a Poisson-like
    cloud d_3 ~ 2 d_1 — sizing cells by d_1 made ~30% of k=3 rows fail
    their certificate on noisy clouds.  Scaling by d_k also normalizes
    run occupancy across geometries (occ ~ (1.25 d_k sqrt(density))^2)."""
    m = ref.shape[0]
    m_valid = int(finite_np.sum())
    q_idx = np.arange(0, m, max(m // 4096, 1))[:4096]
    q_ok = finite_np[q_idx]
    if not q_ok.any():
        return 0.0
    if m > 262144:
        stride = math.ceil(m / 262144)
        r_idx = np.arange(0, m, stride)
        corr = math.sqrt(max(finite_np[r_idx].sum(), 1) / max(m_valid, 1))
        sub = ref[jnp.asarray(r_idx)]
    else:
        sub, corr = ref, 1.0
    d, _ = brute(sub, ref[jnp.asarray(q_idx)], k + 1)
    d = np.asarray(d)[q_ok]
    # Sample rows that hit themselves in the (sub)reference report d_0 = 0;
    # their true k-th neighbor is column k, others' is column k-1.
    dk = np.where(d[:, 0] > 0, d[:, k - 1], d[:, k])
    dk = dk[np.isfinite(dk) & (dk > 0)]
    if dk.size == 0:
        return 0.0
    return float(np.median(dk)) * corr


def knn_grid(ref, query, k: int, brute=None):
    """Exact k-NN of ``query`` among ``ref`` (both [*, 3]) via a uniform
    voxel grid, with certified per-row fallback to ``brute(ref, q, k)``.

    Host-orchestrated (never call under jit) but device-resident: only
    scalars, the validity bitmask, and the per-row exactness mask transfer
    over the host link.  Matches the ``ops.knn.knn_query`` contract:
    Euclidean distances ascending, cKDTree tie rule, masked/non-finite
    reference rows never selected, missing neighbors reported as
    (inf, len(ref)).  Neighbor sets are exact; indices/distances can
    differ from the XLA brute path only on genuinely ulp-tied pairs
    (see module docstring).
    """
    if brute is None:
        from .knn import _brute_knn as brute

    ref = jnp.asarray(ref)
    query = jnp.asarray(query)
    m, nq = ref.shape[0], query.shape[0]

    def _degenerate_stats(**kw):
        # last_stats documents "the most recent knn_grid call", so the
        # early-return paths must overwrite it too or a caller reads the
        # PREVIOUS call's fallback fraction as this one's.
        last_stats.clear()
        last_stats.update(
            n_ref=m, n_query=nq, k=k, cell_size=0.0, dims=(0, 0, 0),
            pass1_unresolved=0, fallback_rows=0, fallback_fraction=0.0,
        )
        last_stats.update(kw)

    if nq == 0:
        _degenerate_stats()
        return (
            jnp.zeros((0, k), query.dtype),
            jnp.zeros((0, k), jnp.int32),
        )

    finite, ref_clean, lo, hi = _grid_prep(ref)
    finite_np = np.asarray(finite)
    if int(finite_np.sum()) < max(k, 8):
        _degenerate_stats(fallback_rows=nq, fallback_fraction=1.0)
        return brute(ref, query, k)

    dk_est = _estimate_dk(ref_clean, finite_np, brute, k)
    if dk_est <= 0.0 or not np.isfinite(dk_est):
        _degenerate_stats(fallback_rows=nq, fallback_fraction=1.0)
        return brute(ref, query, k)

    ext = np.asarray(hi, np.float64) - np.asarray(lo, np.float64)
    s1 = _S_MULT * dk_est
    cap1 = max(_RUN_CAP, 2 * k + 6)

    def _pass(q_sub, s_want, cap):
        """One grid build + chunked certified query pass over ``q_sub``.
        Returns device (d2, idx, exact) and the realized (s, dims)."""
        s_val = s_want
        dims_np = np.maximum(np.floor(ext / s_val).astype(np.int64) + 1, 1)
        if int(dims_np.prod()) > _MAX_CELLS:
            s_val *= (int(dims_np.prod()) / _MAX_CELLS) ** (1.0 / 3.0)
            dims_np = np.maximum(
                np.floor(ext / s_val).astype(np.int64) + 1, 1
            )
        if int(dims_np[0] * dims_np[1]) > _MAX_COLS:
            s_val *= math.sqrt(int(dims_np[0] * dims_np[1]) / _MAX_COLS)
            dims_np = np.maximum(
                np.floor(ext / s_val).astype(np.int64) + 1, 1
            )
        dims = jnp.asarray(dims_np.astype(np.int32))
        n_cols = int(dims_np[0] * dims_np[1])
        s_j = jnp.float32(s_val)
        packed = m <= _PACK_MAX_REF
        sorted_cz, packed_ref, aux, colstart = _grid_build(
            ref_clean, finite, lo, s_j, dims, n_cols, packed
        )
        n_sub = q_sub.shape[0]
        chunk = min(_CHUNK, max(1 << max(n_sub - 1, 1).bit_length(), 512))
        d2_p, idx_p, ex_p = [], [], []
        for s0 in range(0, n_sub, chunk):
            q_c = q_sub[s0 : s0 + chunk]
            pad = chunk - q_c.shape[0]
            if pad:
                q_c = jnp.pad(q_c, ((0, pad), (0, 0)))
            cell_c, start_c, end_c, ctl_c = _grid_search(
                sorted_cz, colstart, q_c, lo, s_j, dims
            )
            d2c, idxc, exc = _grid_select(
                sorted_cz, packed_ref, aux, q_c, cell_c, start_c, end_c,
                ctl_c, lo, s_j, dims, k, cap, packed,
            )
            d2_p.append(d2c[: chunk - pad] if pad else d2c)
            idx_p.append(idxc[: chunk - pad] if pad else idxc)
            ex_p.append(exc[: chunk - pad] if pad else exc)
        cat = lambda xs: xs[0] if len(xs) == 1 else jnp.concatenate(xs)
        return cat(d2_p), cat(idx_p), cat(ex_p), s_val, dims_np

    # --- Pass 1: cells sized to the typical k-th-neighbor distance ---
    d2, idx, exact, s_real, dims_np = _pass(query, s1, cap1)
    dists = jnp.sqrt(jnp.maximum(d2, 0.0))
    fb1 = np.nonzero(~np.asarray(exact))[0]

    # --- Pass 2: rescue rows whose d_k exceeds the pass-1 margin (sparse
    # patches, dense-spot cap overflow) with 2x cells / 2x cap ---
    fb = fb1
    if fb1.size:
        n2 = 1 << max(int(fb1.size) - 1, 1).bit_length()
        q2 = query[jnp.asarray(np.resize(fb1, n2))]
        d2b, idxb, exactb, _, _ = _pass(q2, 2.0 * s_real, 2 * cap1)
        ex2 = np.asarray(exactb)[: fb1.size]
        good = np.nonzero(ex2)[0]
        if good.size:
            sel = jnp.asarray(good)
            tgt = jnp.asarray(fb1[good])
            dists = dists.at[tgt].set(
                jnp.sqrt(jnp.maximum(d2b[sel], 0.0))
            )
            idx = idx.at[tgt].set(idxb[sel])
        fb = fb1[~ex2]

    last_stats.clear()
    last_stats.update(
        n_ref=m, n_query=nq, k=k, cell_size=float(s_real),
        dims=tuple(int(x) for x in dims_np),
        pass1_unresolved=int(fb1.size),
        fallback_rows=int(fb.size),
        fallback_fraction=float(fb.size) / max(nq, 1),
    )

    # --- Certified brute fallback for the remainder (device scatter; only
    # the exactness bitmasks are pulled to the host) ---
    if fb.size:
        n_fb = 1 << max(int(fb.size) - 1, 1).bit_length()  # bound recompiles
        fb_pad = jnp.asarray(np.resize(fb, n_fb))  # repeats; extras discarded
        d_fb, i_fb = brute(ref, query[fb_pad], k)
        fb_j = jnp.asarray(fb)
        dists = dists.at[fb_j].set(d_fb[: fb.size])
        idx = idx.at[fb_j].set(i_fb[: fb.size])

    return dists, idx
