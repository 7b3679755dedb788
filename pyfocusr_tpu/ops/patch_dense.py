"""Patch-dense Laplacian operator: dense blocks + compacted residual gather.

A filter-step redesign.  The wide-Chebyshev eigensolver spends most of its
device time in the ELL neighbor-gather SpMM
``sd*T - einsum("nd,ndc->nc", sw, T[neighbors])``.  The design rests on
three facts measured on the accelerator it was first written for (15k
mesh, [N,128] block); whether they hold on an H100 is not measured yet:

* the multi-column ELL gather is ISSUE-bound, not bandwidth-bound (bf16
  payloads do not help), with a cost that grows with every degree column;
* a single-index-per-row gather ``T[idx]`` ([N] -> [N,128] rows) is the
  fast path;
* a batched dense [P,128,128] x [P,128,128] einsum is much cheaper than
  the D=8 gather it can replace, and at precision=HIGHEST it is exact f32.

So: partition the vertices into BFS patches of 128, renumber
patch-contiguously, store all INTRA-patch edges as dense [P,128,128]
blocks (a batched matmul per step), and keep only the ~14% of
CROSS-patch edges as a residual compacted to the ~37% boundary rows,
applied with unrolled single-index row gathers.  Everything stays exact
f32 (scatter-free apply; the boundary add rides a zero-padded row
gather), with max|diff| = 0 vs the ELL op at HIGHEST on the bundled 15k
mesh (f32 summation order differs only where a row has both intra and
cross edges; observed differences are ~1e-7 relative).

Scope: the plan is built host-side once per mesh (numpy BFS; ~0.1 s at
15k) and attached to ``GraphArrays.patch_plan``; ``pipeline._spectrum``
uses it for the wide-Chebyshev filter only.  The dense blocks cost
``(N/128) * 64 KB`` (7.7 MB at 15k, 63 MB at 122k), so building is
gated to ``n <= PATCH_DENSE_MAX_N``; larger meshes keep the ELL path
(they run split-spectra/multires anyway).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["build_patch_plan", "patch_filter_factory", "PATCH_DENSE_MAX_N",
           "BLOCK"]

BLOCK = 128
# Above this, dense blocks cost > ~128 MB and the split-spectra/multires
# paths own the mesh anyway.
PATCH_DENSE_MAX_N = 150_000
# Residual-width cap: the boundary residual is applied as Dr unrolled
# row gathers, so a hub vertex whose cross-patch degree is huge (the
# 122k UV-sphere bench's poles reach ~350 via overflow edges) would
# make every filter step pay hundreds of gathers — measured 3.4x SLOWER
# end-to-end than the ELL path it replaced.  Such meshes fall back to
# ELL (build_patch_plan returns None).  Organic surface meshes sit at
# Dr <= 8.
DR_MAX = 16


def build_patch_plan(neighbors, nbr_mask, overflow=None, block: int = BLOCK):
    """Host-side patch plan for :func:`patch_filter_factory`.

    ``neighbors`` i32 [N, D], ``nbr_mask`` [N, D] (0 = padding slot),
    ``overflow`` i32 [E_o, 2] hub spill edges (src == dst rows are
    padding).  Returns a dict of numpy arrays (converted lazily to
    device arrays when attached to GraphArrays), or ``None`` when the
    mesh is too small/large to profit.

    The partition is a seeded BFS blocking: grow a patch from the first
    unassigned vertex until ``block`` members, repeat.  Bundled 15k
    bone: 13.7% cross edges, 37% boundary vertices, max cross degree 7.
    """
    neighbors = np.asarray(neighbors)
    nbr_mask = np.asarray(nbr_mask)
    n, D = neighbors.shape
    if n < 2 * block or n > PATCH_DENSE_MAX_N:
        return None
    from collections import deque

    real = nbr_mask > 0
    adj = [neighbors[i][real[i]] for i in range(n)]
    patch = np.full(n, -1, np.int32)
    order = []
    pid = 0
    for seed in range(n):
        if patch[seed] >= 0:
            continue
        q = deque([seed])
        count = 0
        while q and count < block:
            v = q.popleft()
            if patch[v] >= 0:
                continue
            patch[v] = pid
            order.append(v)
            count += 1
            for u in adj[v]:
                if patch[u] < 0:
                    q.append(u)
        pid += 1
    perm = np.asarray(order, np.int64)  # new -> old
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    npad = (n + block - 1) // block * block
    P = npad // block

    # ELL entries in new indexing.
    nbr_new = inv[neighbors][perm]  # [n, D] new-space cols of new-space rows
    real_new = real[perm]
    same = (nbr_new // block) == (np.arange(n) // block)[:, None]
    intra = same & real_new
    cross = (~same) & real_new
    rows_new = np.repeat(np.arange(n), D).reshape(n, D)
    # Flat source index into concat(sw.flat [old], ov_sw, [0]): ELL entry
    # (old_row, slot) -> old_row * D + slot.
    src_flat_ell = perm[:, None] * D + np.arange(D)[None, :]

    # Overflow edges classified the same way.
    ov_intra = ov_cross = None
    n_ov = 0
    if overflow is not None:
        overflow = np.asarray(overflow)
        n_ov = overflow.shape[0]
    if n_ov:
        ov_real = overflow[:, 0] != overflow[:, 1]
        ov_src_new = inv[overflow[:, 0]]
        ov_dst_new = inv[overflow[:, 1]]
        ov_same = (ov_src_new // block) == (ov_dst_new // block)
        ov_intra = ov_real & ov_same
        ov_cross = ov_real & ~ov_same

    zero_slot = n * D + n_ov  # index of the appended exact-zero value

    # --- dense intra blocks: scatter destinations + value sources ---
    dst = (rows_new[intra] // block) * block * block \
        + (rows_new[intra] % block) * block + (nbr_new[intra] % block)
    srcv = src_flat_ell[intra]
    if n_ov and ov_intra.any():
        dst = np.concatenate([
            dst,
            (ov_src_new[ov_intra] // block) * block * block
            + (ov_src_new[ov_intra] % block) * block
            + (ov_dst_new[ov_intra] % block),
        ])
        srcv = np.concatenate(
            [srcv, n * D + np.where(ov_intra)[0]]
        )

    # --- residual: compacted boundary rows, ragged -> [Nb, Dr] ---
    cross_deg = cross.sum(1).astype(np.int64)
    if n_ov and ov_cross.any():
        np.add.at(cross_deg, ov_src_new[ov_cross], 1)
    bnd = np.where(cross_deg > 0)[0]
    Nb = len(bnd)
    Dr = int(cross_deg[bnd].max()) if Nb else 1
    if Dr > DR_MAX:
        return None  # hub-heavy topology: the ELL path wins (see DR_MAX)
    res_cols = np.zeros((max(Nb, 1), Dr), np.int64)
    res_src = np.full((max(Nb, 1), Dr), zero_slot, np.int64)
    pos_of = np.full(n, -1, np.int64)
    pos_of[bnd] = np.arange(Nb)
    # Vectorized ragged fill: np.where returns row-major (row-sorted)
    # entries, so the within-row slot index is the offset from the first
    # occurrence of each row.
    cr, cs = np.where(cross)
    j_idx = np.arange(len(cr)) - np.searchsorted(cr, cr)
    res_cols[pos_of[cr], j_idx] = nbr_new[cr, cs]
    res_src[pos_of[cr], j_idx] = src_flat_ell[cr, cs]
    if n_ov and ov_cross.any():
        base = cross.sum(1).astype(np.int64)  # ELL cross count per row
        oe = np.where(ov_cross)[0]
        r_ov = ov_src_new[oe]
        order = np.argsort(r_ov, kind="stable")
        oe, r_ov = oe[order], r_ov[order]
        j_ov = base[r_ov] + (np.arange(len(oe))
                             - np.searchsorted(r_ov, r_ov))
        res_cols[pos_of[r_ov], j_ov] = ov_dst_new[oe]
        res_src[pos_of[r_ov], j_ov] = n * D + oe
    # Zero-row expansion gather: row -> its residual slot, pad rows -> Nb
    # (the appended zero row), so the boundary add is a plain row gather.
    exp_idx = np.full(npad, Nb, np.int64)
    exp_idx[bnd] = np.arange(Nb)

    perm_pad = np.zeros(npad, np.int64)
    perm_pad[:n] = perm
    valid_new = np.zeros(npad, np.float32)
    valid_new[:n] = 1.0
    return {
        "perm": perm_pad.astype(np.int32),         # [npad] new -> old (pad -> 0)
        "perm_valid": valid_new,                   # [npad]
        "inv_perm": inv.astype(np.int32),          # [n] old -> new
        "intra_dst": dst.astype(np.int32),         # [E_i] flat into [P*B*B]
        "intra_src": srcv.astype(np.int32),        # [E_i] flat into values
        "res_cols": res_cols.astype(np.int32),     # [Nb, Dr] new-space gather
        "res_src": res_src.astype(np.int32),       # [Nb, Dr] flat into values
        "exp_idx": exp_idx.astype(np.int32),       # [npad]
    }


def patch_filter_factory(plan, sw, ov_sw, sd, mask):
    """Chebyshev filter-op factory over the patch-dense operator.

    ``plan``: device-side dict from :func:`build_patch_plan`.
    ``sw`` f32 [N, D] symmetrized edge weights (old space), ``ov_sw``
    [E_o] overflow weights, ``sd`` [N] symmetrized diagonal, ``mask``
    [N] valid mask.  Returns ``factory(c, e) -> op`` with op exactly
    applying ``(2/e) * (A - c I)`` restricted to the masked subspace,
    where ``A x = sd*x - W_sym x`` — the same operator as the fused ELL
    factory in ``pipeline._spectrum``, with f32 summation regrouped
    (dense 128-dots for intra edges; measured agreement ~1e-7).

    All per-solve structures (dense blocks, residual weights) are built
    once here, outside the returned closure, so the 5 chunk invocations
    share them (XLA CSE would dedupe anyway; this makes it structural).
    """
    n, D = sw.shape
    npad = plan["perm"].shape[0]
    P = npad // BLOCK
    Nb, Dr = plan["res_cols"].shape

    # Unified value vector: ELL weights, overflow weights, exact zero.
    vals = jnp.concatenate(
        [sw.reshape(-1), ov_sw.reshape(-1), jnp.zeros((1,), sw.dtype)]
    )
    A = jnp.zeros((P * BLOCK * BLOCK,), sw.dtype).at[plan["intra_dst"]].add(
        -vals[plan["intra_src"]]
    ).reshape(P, BLOCK, BLOCK)
    res_w = vals[plan["res_src"]]  # [Nb, Dr]
    sd_new = sd[plan["perm"]] * plan["perm_valid"]  # sd is already masked
    mask_new = mask[plan["perm"]] * plan["perm_valid"]
    perm = plan["perm"]
    inv_perm = plan["inv_perm"]
    exp_idx = plan["exp_idx"]
    res_cols = [plan["res_cols"][:, j] for j in range(Dr)]
    res_ws = [res_w[:, j:j + 1] for j in range(Dr)]
    hi = jax.lax.Precision.HIGHEST

    def factory(c, e):
        alpha = 2.0 / e

        def op(T):
            b = T.shape[1]
            Tn = T[perm]  # [npad, b] into patch space (one fast row gather)
            yd = jnp.einsum(
                "pij,pjc->pic", A, Tn.reshape(P, BLOCK, b), precision=hi
            ).reshape(npad, b)
            yd = yd + (sd_new - c * mask_new)[:, None] * Tn
            if Nb:
                r = res_ws[0] * Tn[res_cols[0]]
                for j in range(1, Dr):
                    r = r + res_ws[j] * Tn[res_cols[j]]
                rz = jnp.concatenate([r, jnp.zeros((1, b), T.dtype)], axis=0)
                yd = yd - rz[exp_idx]
            return alpha * yd[inv_perm]

        return op

    return factory
