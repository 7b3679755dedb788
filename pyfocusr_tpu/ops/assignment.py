"""Linear assignment (Hungarian) solvers.

The reference uses scipy's Jonker-Volgenant ``linear_sum_assignment`` in two
regimes: (a) the tiny k x k eigenmap-matching problem (``eigsort.py:76-78``,
k ~ 6-10) and (b) the full N x N spectral-correspondence assignment for
``initial/final_correspondence_type='hungarian'`` (``focusr.py:346``, e.g.
5000 x 5000, equal vertex counts required — guard at ``focusr.py:377-385``).

Design:
  * (a) stays on host: an O(n^3) shortest-augmenting-path JV implementation in
    pure numpy (``lap_host``) with a vectorized Dijkstra relaxation — no
    device round-trip is worth making at k ~ 10, and it also serves as the
    exact fallback at any size.
  * (b) runs on device: the EXACT Sinkhorn-warmed Jonker-Volgenant solver
    (``sinkhorn_jv_lap``): annealed log-domain Sinkhorn duals warm-start a
    while-loop Dijkstra augmentation (0% optimality gap, full index
    agreement with scipy).  The round-1 epsilon-scaling auction
    (``auction_lap``) is retained as a legacy/approximate alternative
    only — its epsilon floor is optimal to within n * eps_final, not
    exact.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.precision import f32_matmuls

__all__ = [
    "lap_host",
    "sinkhorn_jv_lap",
    "auction_lap",
    "sinkhorn_auction_lap",
    "exact_lap_small",
    "linear_sum_assignment",
]


def lap_host(cost: np.ndarray):
    """Jonker-Volgenant shortest-augmenting-path LAP on the host (numpy).

    Returns (row_ind, col_ind) minimizing cost[row_ind, col_ind].sum(), rows
    in order — the scipy contract.  Requires n_rows <= n_cols (transposes
    internally otherwise).
    """
    cost = np.asarray(cost, dtype=np.float64)
    if not np.isfinite(cost).all():
        # scipy's contract; without it the Dijkstra augmentation (numpy AND
        # the C++ core) can spin forever on a NaN row — NaN comparisons
        # never select an augmenting column.
        raise ValueError("cost matrix contains non-finite entries")
    n_rows, n_cols = cost.shape
    if n_rows > n_cols:
        rows, cols = lap_host(cost.T)
        order = np.argsort(cols)
        return cols[order], rows[order]

    # Native C++ fast path (native/lap_jv.cpp via ctypes), if built.
    from ..native import lap_jv_native

    native_cols = lap_jv_native(cost)
    if native_cols is not None:
        return np.arange(n_rows), native_cols

    INF = np.inf
    u = np.zeros(n_rows + 1)
    v = np.zeros(n_cols + 1)
    # p[j] = row (1-based) matched to column j (1-based); column 0 is virtual.
    p = np.zeros(n_cols + 1, dtype=np.int64)
    way = np.zeros(n_cols + 1, dtype=np.int64)

    for i in range(1, n_rows + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n_cols + 1, INF)
        used = np.zeros(n_cols + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            # Vectorized relaxation over free columns.
            free = ~used[1:]
            cur = cost[i0 - 1, :] - u[i0] - v[1:]
            sub = minv[1:]
            upd = free & (cur < sub)
            sub[upd] = cur[upd]
            way[1:][upd] = j0
            masked = np.where(free, sub, INF)
            j1 = int(np.argmin(masked)) + 1
            delta = masked[j1 - 1]
            # Potential update.
            used_cols = np.where(used)[0]
            u[p[used_cols]] += delta
            v[used_cols] -= delta
            minv[1:][free] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        # Augment along the alternating path.
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1

    col_ind = np.zeros(n_rows, dtype=np.int64)
    for j in range(1, n_cols + 1):
        if p[j] > 0:
            col_ind[p[j] - 1] = j - 1
    return np.arange(n_rows), col_ind


@partial(jax.jit, static_argnames=("max_rounds",))
@f32_matmuls
def _auction_scaling_phase(cost_neg, eps, prices, max_rounds: int):
    """One epsilon phase: bid until every row is assigned (or round cap)."""
    n = cost_neg.shape[0]
    rows = jnp.arange(n, dtype=jnp.int32)
    assignment = jnp.full((n,), -1, jnp.int32)  # row -> col
    owner = jnp.full((n,), -1, jnp.int32)  # col -> row

    def cond(state):
        assignment, owner, prices, rounds = state
        return jnp.logical_and(jnp.any(assignment < 0), rounds < max_rounds)

    def body(state):
        assignment, owner, prices, rounds = state
        bidder = assignment < 0
        values = cost_neg - prices[None, :]
        top2, top2_idx = jax.lax.top_k(values, 2)
        best_j = top2_idx[:, 0]
        bids = top2[:, 0] - top2[:, 1] + eps

        neg_inf = jnp.array(-jnp.inf, cost_neg.dtype)
        bid_eff = jnp.where(bidder, bids, neg_inf)
        # Padded scatter-max: winning bid per column.
        tgt = jnp.where(bidder, best_j, n)
        col_bid = jnp.full((n + 1,), neg_inf, cost_neg.dtype).at[tgt].max(bid_eff)
        # Candidate winners (ties broken by smallest row index).
        cand = jnp.logical_and(bidder, bid_eff >= col_bid[best_j])
        cand_tgt = jnp.where(cand, best_j, n)
        col_winner = (
            jnp.full((n + 1,), n, jnp.int32)
            .at[cand_tgt]
            .min(jnp.where(cand, rows, n))
        )
        won = jnp.logical_and(cand, col_winner[best_j] == rows)
        won_tgt = jnp.where(won, best_j, n)

        # Price bump by the winning bid.
        prices = (
            jnp.concatenate([prices, jnp.zeros((1,), prices.dtype)])
            .at[won_tgt]
            .add(jnp.where(won, bids, 0.0))[:n]
        )
        # Evict previous owners of newly won columns.
        prev_owner_pad = jnp.concatenate([owner, jnp.array([-1], jnp.int32)])
        evicted_row = prev_owner_pad[won_tgt]  # per bidding row: who they evict
        evict_tgt = jnp.where(evicted_row >= 0, evicted_row, n)
        assignment = (
            jnp.concatenate([assignment, jnp.array([-1], jnp.int32)])
            .at[evict_tgt]
            .set(-1)[:n]
        )
        owner = (
            jnp.concatenate([owner, jnp.array([-1], jnp.int32)])
            .at[won_tgt]
            .set(jnp.where(won, rows, -1))[:n]
        )
        assignment = jnp.where(won, best_j, assignment)
        return assignment, owner, prices, rounds + 1

    assignment, owner, prices, rounds = jax.lax.while_loop(
        cond, body, (assignment, owner, prices, jnp.int32(0))
    )
    return assignment, prices


def auction_lap(
    cost: jnp.ndarray, eps_scaling_steps: int = 7, max_rounds: int = 100000
) -> jnp.ndarray:
    """Square LAP via forward auction with epsilon scaling, on device.

    Returns the column assigned to each row (i32 [n]).  Final eps is
    spread/(4n), giving a total cost within n*eps of optimal (exact for costs
    whose pairwise differences exceed that, which random geometric costs do).
    """
    cost = jnp.asarray(cost, jnp.float32)
    n = cost.shape[0]
    if n == 1:
        # top_k(values, 2) inside the bidding phase needs >= 2 columns; the
        # 1x1 assignment is trivially [0].
        return jnp.zeros((1,), jnp.int32)
    cost_neg = -cost
    spread = jnp.maximum(jnp.max(cost) - jnp.min(cost), 1e-12)
    prices = jnp.zeros((n,), cost.dtype)
    eps_final = spread / (4.0 * n)
    assignment = jnp.full((n,), -1, jnp.int32)
    eps = spread / 2.0
    for _ in range(eps_scaling_steps):
        eps = jnp.maximum(eps, eps_final)
        assignment, prices = _auction_scaling_phase(cost_neg, eps, prices, max_rounds)
        eps = eps / 6.0
    # A phase that exhausts max_rounds can leave rows at -1; complete them
    # so the documented permutation contract holds (a -1 used as a gather
    # index would silently wrap to the LAST column under jit).
    return _greedy_complete(assignment, n)


@partial(jax.jit, static_argnames=("levels", "iters_per_level"))
@f32_matmuls
def _sinkhorn_duals(cost, T0, T_factor: float, levels: int, iters_per_level: int):
    """Annealed log-domain Sinkhorn: dual potentials (f, g) of the entropic
    OT relaxation of the assignment LP, temperature T0 * T_factor^level.
    As T -> 0 the potentials converge to optimal LAP duals; each iteration is
    two [n, n] logsumexp reductions — pure memory-bound streaming work."""

    def one_T(carry, T):
        f, g = carry

        def one_iter(carry2, _):
            f, g = carry2
            f = -T * jax.nn.logsumexp((g[None, :] - cost) / T, axis=1)
            g = -T * jax.nn.logsumexp((f[:, None] - cost) / T, axis=0)
            return (f, g), None

        (f, g), _ = jax.lax.scan(
            one_iter, (f, g), None, length=iters_per_level
        )
        return (f, g), None

    n = cost.shape[0]
    Ts = T0 * T_factor ** jnp.arange(levels, dtype=cost.dtype)
    f0 = jnp.zeros((n,), cost.dtype)
    g0 = jnp.zeros((n,), cost.dtype)
    (f, g), _ = jax.lax.scan(one_T, (f0, g0), Ts)
    return f, g


def _greedy_complete(assignment, n):
    """Pair any still-unassigned rows with the free columns (index order).
    Safety net preserving the permutation invariant if the auction round cap
    is ever hit; with Sinkhorn warm-started prices this is a no-op in
    practice."""
    taken = jnp.zeros((n + 1,), jnp.int32).at[
        jnp.where(assignment >= 0, assignment, n)
    ].set(1)[:n]
    free_rank = jnp.cumsum(1 - taken) - 1  # rank of each free column
    # For the r-th unassigned row, pick the r-th free column.
    order = jnp.argsort(jnp.where(taken > 0, n, free_rank))  # free cols first
    unassigned_rank = jnp.cumsum(assignment < 0) - 1
    fill = order[jnp.clip(unassigned_rank, 0, n - 1)]
    return jnp.where(assignment < 0, fill, assignment)


_BIG = jnp.float32(1e30)


@jax.jit
@f32_matmuls
def _bulk_match(cost, v0):
    """Tight-edge bulk matching (JV column-reduction analog): one [n, n]
    pass assigns every row that wins its argmin column under feasible duals.
    Returns (u0, row4col0, col4row0)."""
    n = cost.shape[0]
    rows = jnp.arange(n, dtype=jnp.int32)
    u0 = jnp.min(cost - v0[None, :], axis=1)
    j_star = jnp.argmin(cost - u0[:, None] - v0[None, :], axis=1)
    col_winner = jnp.full((n + 1,), n, jnp.int32).at[j_star].min(rows)
    won = col_winner[j_star] == rows
    col4row0 = jnp.where(won, j_star, -1)
    row4col0 = (
        jnp.full((n + 1,), -1, jnp.int32)
        .at[jnp.where(won, j_star, n)]
        .set(rows)[:n]
    )
    return u0, row4col0, col4row0


@partial(jax.jit, static_argnames=("max_total_steps",))
@f32_matmuls
def _jv_device(cost, v0, max_total_steps: int):
    """Jonker-Volgenant shortest-augmenting-path LAP entirely on device.

    Structure mirrors the production JV implementations (e.g. scipy's):

      1. *Tight-edge bulk matching* (the vectorized analog of JV column
         reduction): with feasible duals (u = row minima of the reduced
         cost), every row's argmin column is a zero-reduced-cost edge;
         one scatter-min resolves column conflicts and assigns the ~90%
         of rows that win their argmin — a single [n, n] pass.
      2. *Dijkstra augmentation* for each remaining row (deferred dual
         updates, as in scipy's `_lsap`): each step touches ONE cost row
         (an [n] relax + masked argmin), so total work is
         sum-of-path-lengths * n — orders of magnitude less than auction
         rounds, which rescan the full [n, n] matrix per round and whose
         price wars never settled on contested geometric costs.

    ``v0`` warm-starts the column duals (annealed-Sinkhorn potentials
    shorten the augmenting paths).  ``max_total_steps`` is a global
    Dijkstra-step budget (watchdog guard): on exhaustion remaining rows
    stay unassigned for ``_greedy_complete``; the result is exact whenever
    the budget was not hit (none observed in practice).
    Returns (col_of_row i32 [n], steps_used).
    """
    n = cost.shape[0]
    rows = jnp.arange(n, dtype=jnp.int32)

    # --- Phase 1: tight-edge bulk matching (shared helper) --------------
    u0, row4col0, col4row0 = _bulk_match(cost, v0)

    # --- Phase 2: Dijkstra augmentation per unassigned row -------------
    def augment_row(carry, i_start):
        u, v, row4col, col4row, steps_left = carry

        def run(args):
            u, v, row4col, col4row, steps_left = args

            def dj_cond(s):
                _spc, _path, _scanned, _rvis, _i, _mv, sink, sl = s
                return jnp.logical_and(sink < 0, sl > 0)

            def dj_body(s):
                spc, path, scanned, rvis, i_cur, minVal, sink, sl = s
                rvis = rvis.at[i_cur].set(True)
                r = minVal + cost[i_cur] - u[i_cur] - v
                better = jnp.logical_and(~scanned, r < spc)
                spc = jnp.where(better, r, spc)
                path = jnp.where(better, i_cur, path)
                masked = jnp.where(scanned, _BIG, spc)
                j1 = jnp.argmin(masked)
                lowest = masked[j1]
                scanned = scanned.at[j1].set(True)
                owner = row4col[j1]
                is_free = owner < 0
                sink = jnp.where(is_free, j1, -1)
                i_cur = jnp.where(is_free, i_cur, owner)
                return (spc, path, scanned, rvis, i_cur, lowest, sink, sl - 1)

            spc0 = jnp.full((n,), _BIG)
            path0 = jnp.full((n,), -1, jnp.int32)
            scanned0 = jnp.zeros((n,), bool)
            rvis0 = jnp.zeros((n,), bool)
            spc, path, scanned, rvis, _, minVal, sink, steps_left = (
                jax.lax.while_loop(
                    dj_cond,
                    dj_body,
                    (spc0, path0, scanned0, rvis0, i_start,
                     jnp.float32(0.0), jnp.int32(-1), steps_left),
                )
            )

            def apply_augment(args):
                u, v, row4col, col4row = args
                # Deferred dual updates (scipy _lsap): over visited rows
                # (via their pre-augmentation columns) and scanned columns.
                spc_of_row = spc[jnp.clip(col4row, 0, n - 1)]
                upd_rows = jnp.logical_and(rvis, rows != i_start)
                u = jnp.where(upd_rows, u + minVal - spc_of_row, u)
                u = u.at[i_start].add(minVal)
                v = jnp.where(scanned, v - (minVal - spc), v)

                def aug_cond(s):
                    j, _, _ = s
                    return j >= 0

                def aug_body(s):
                    j, row4col, col4row = s
                    i = path[j]
                    row4col = row4col.at[j].set(i)
                    j_next = col4row[i]
                    col4row = col4row.at[i].set(j)
                    return (j_next, row4col, col4row)

                _, row4col, col4row = jax.lax.while_loop(
                    aug_cond, aug_body, (sink, row4col, col4row)
                )
                return u, v, row4col, col4row

            u, v, row4col, col4row = jax.lax.cond(
                sink >= 0,
                apply_augment,
                lambda a: a,
                (u, v, row4col, col4row),
            )
            return u, v, row4col, col4row, steps_left

        u, v, row4col, col4row, steps_left = jax.lax.cond(
            jnp.logical_and(col4row[i_start] < 0, steps_left > 0),
            run,
            lambda a: a,
            (u, v, row4col, col4row, steps_left),
        )
        return (u, v, row4col, col4row, steps_left), None

    (u, v, row4col, col4row, steps_left), _ = jax.lax.scan(
        augment_row,
        (u0, v0, row4col0, col4row0, jnp.int32(max_total_steps)),
        rows,
    )
    return col4row, jnp.int32(max_total_steps) - steps_left


def sinkhorn_jv_lap(
    cost: jnp.ndarray,
    levels: int = 14,
    iters_per_level: int = 30,
    max_total_steps: int | None = None,
    warm_start: bool = True,
) -> jnp.ndarray:
    """EXACT square LAP on device: annealed-Sinkhorn duals warm-start a
    device Jonker-Volgenant solve.

    Replaces the cold-started epsilon-scaling auction for large contested
    problems: on the bundled 5k spectral-correspondence cost the auction's
    price wars did not settle, while this solve is EXACT — gap 0.000000%
    and full index agreement with scipy.  The Sinkhorn warm start is two
    [n, n] logsumexp reductions per iteration (memory-bound streaming) and
    cuts JV augmentation steps ~2.4x; the augmentation is an XLA
    while_loop with one [n]-vector relax per step (``_jv_device``).

    Returns the column assigned to each row (i32 [n], always a permutation;
    rows beyond the step budget — none observed in practice — are paired
    with leftover columns).
    """
    cost = jnp.asarray(cost, jnp.float32)
    n = cost.shape[0]
    if cost.shape[1] != n:
        raise ValueError(
            f"sinkhorn_jv_lap requires a square cost matrix, got {cost.shape}"
            " (use lap_host / linear_sum_assignment for rectangular problems)"
        )
    if max_total_steps is None:
        max_total_steps = 60 * n
    if warm_start and n >= 512:
        spread = jnp.maximum(jnp.max(cost) - jnp.min(cost), 1e-12)
        _, g = _sinkhorn_duals(
            cost, spread / 4.0, 1.0 / 3.0, levels, iters_per_level
        )
        v0 = g
    else:
        v0 = jnp.zeros((n,), cost.dtype)
    assignment, _ = _jv_device(cost, v0, max_total_steps)
    return _greedy_complete(assignment, n)


# Backwards-compatible alias (round-1 name; auction superseded by JV).
def sinkhorn_auction_lap(cost, **kwargs):
    """Alias for :func:`sinkhorn_jv_lap`.  JV-solver kwargs (``levels``,
    ``iters_per_level``, ``max_total_steps``, ``warm_start``) pass through;
    the retired auction's tuning knobs (``eps_scaling_steps``,
    ``max_rounds``, ...) no longer exist and raise rather than being
    silently swallowed."""
    jv_kwargs = {"levels", "iters_per_level", "max_total_steps", "warm_start"}
    unknown = set(kwargs) - jv_kwargs
    if unknown:
        raise TypeError(
            f"sinkhorn_auction_lap: unsupported kwargs {sorted(unknown)} — "
            "the epsilon-scaling auction was replaced by the exact JV solver "
            f"(sinkhorn_jv_lap); supported tuning kwargs: {sorted(jv_kwargs)}"
        )
    return sinkhorn_jv_lap(cost, **kwargs)


def exact_lap_small(cost: jnp.ndarray) -> jnp.ndarray:
    """EXACT square LAP for tiny k (k <= 8) by static enumeration, on device.

    All k! permutations are a host-side static constant; the device work is
    one [k!, k] gather + sum + argmin.  Unlike the epsilon-scaling auction
    (optimal only to within n*eps_final = spread/4), this is exact regardless
    of cost magnitude or ties — which matters for the eigsort k x k matching,
    whose cost entries shrink toward the auction's epsilon floor as the
    eigsort subsample grows (observed wrong matchings on near-identical
    meshes at ``n_coords_spectral_ordering=1000``).

    Returns the column assigned to each row (i32 [k]).
    """
    import itertools

    k = cost.shape[0]
    if cost.shape[1] != k:
        # Silently enumerating only the first k columns would return a
        # suboptimal matching from a function documented as EXACT.
        raise ValueError(
            f"exact_lap_small requires a square cost, got {cost.shape}"
        )
    if k > 8:
        raise ValueError(f"exact_lap_small enumerates k! permutations; k={k} > 8")
    perms = jnp.asarray(
        np.array(list(itertools.permutations(range(k))), np.int32)
    )  # [k!, k]
    totals = jnp.sum(jnp.asarray(cost)[jnp.arange(k)[None, :], perms], axis=1)
    return perms[jnp.argmin(totals)]


def linear_sum_assignment(cost, device_threshold: int | None = 2048):
    """Dispatcher with the scipy contract: returns (row_ind, col_ind).

    Square problems larger than ``device_threshold`` solve on-device with
    the exact Sinkhorn-warmed JV (``sinkhorn_jv_lap``); smaller or
    rectangular problems use the host JV (no device round-trip is worth
    it there).  The device routing is gated on an actual accelerator
    backend: on a CPU-only install the annealed Sinkhorn + while_loop JV
    is far slower than the native host JV.
    Pass ``device_threshold=None`` to force the host path at every size.
    """
    n_rows, n_cols = cost.shape  # shape without materializing on host
    if (
        device_threshold is None
        or n_rows != n_cols
        or max(n_rows, n_cols) <= device_threshold
        or jax.default_backend() == "cpu"
    ):
        # Host path: the (single) device->host transfer happens here.
        return lap_host(np.asarray(cost))
    # Device path: keep a device-resident cost on device — np.asarray would
    # pull the full matrix to host and push it straight back (200 MB of
    # round-trip traffic at 5k x 5k f32).
    col_ind = np.asarray(sinkhorn_jv_lap(jnp.asarray(cost)))
    return np.arange(n_rows), col_ind
