"""Fully-jittable eigsort: the same sign-flip/reorder computation as
spectral/eigsort.py but with zero host synchronization, so it can live inside
the single-program jit pipeline (pipeline.py) and under vmap/shard_map for
cohort registration.

Differences from the host version (spectral/eigsort.py):
  * the k x k assignment solves on device EXACTLY by static permutation
    enumeration (ops/assignment.exact_lap_small, k <= 8; exact device JV
    beyond) instead of host JV;
  * the column permutation + sign flip are applied with a one-hot permutation
    matrix (a matmul) because gather indices are traced;
  * both the equal-sample-size (sorted-difference) and unequal-sample-size
    (merged-CDF, vmapped) Wasserstein paths are supported; sample counts are
    static shapes, so the choice happens at trace time.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.assignment import _jv_device, exact_lap_small
from ..ops.knn import nn_query

_PREC = jax.lax.Precision.HIGHEST

__all__ = ["sort_eigenmaps_jit"]


def sort_eigenmaps_jit(
    eig_vals_target,
    eig_vals_source,
    rand_target_eig_vecs,
    rand_source_eig_vecs,
    rand_target_points,
    rand_source_points,
    eig_vecs_to_permute,
    target_as_reference: bool = True,
):
    """Returns (sorted_eig_vecs, Q_vec).

    ``eig_vecs_to_permute`` are the full-resolution eigvecs of the
    NON-reference graph: the source's when ``target_as_reference`` (default)
    — flipped/permuted into the target's mode order — or the target's when
    False (assignment on Q.T, reference ``eigsort.py:75-78,100-122``).

    Mirrors reference ``eigsort.py:54-140`` semantics (see spectral/eigsort.py
    for the cost definitions and file:line citations).
    """
    k = eig_vals_target.shape[0]
    # DELIBERATE deviation from the host path's clamp epsilon
    # (eigsort._EPS = f64 eps, matching the reference's f64 arithmetic):
    # this path computes v + 0.5 in f32, where the minimum vertex
    # (v = -0.5 after min-max normalization) lands within ~6e-8 ROUNDING
    # NOISE of zero.  Clamping at f32 eps bounds log(v + 0.5) at
    # log(1.2e-7) = -15.9; a f64-eps clamp would let pure rounding noise
    # produce log values anywhere in [-36, -15.9], scattering the W1 cost
    # of the affected column.  Measured (round-3 A/B): the f64-eps clamp
    # broke template-iteration pose invariance on spheres (near-tie
    # spectra); f32 eps is the numerically sound clamp for f32
    # arithmetic.  Host/jit parity for edge samples is therefore limited
    # by f32 rounding, not by this constant (tests/test_eigsort.py gates
    # at rtol 2e-3).
    eps = jnp.finfo(jnp.float32).eps

    # c_lambda (eigsort.py:142-160).  Guards beyond the reference: k == 1
    # has an empty diff (mean -> NaN) and an exactly degenerate spectrum
    # has gap == 0 (0/0 -> NaN) — both fall back to gap=1, which is
    # harmless (a 1x1 assignment is forced, and the downstream confidence
    # weighting is scale-invariant in that case).  The exponent is clamped
    # at 80 so far-apart mode pairs saturate at exp(80)~5.5e34 instead of
    # overflowing f32 to inf (evenly spaced spectra overflow at k >= ~15).
    def _mean_gap(v):
        if v.shape[0] < 2:
            return jnp.asarray(0.0, v.dtype)
        return jnp.mean(jnp.diff(v))

    gap = (_mean_gap(eig_vals_target) + _mean_gap(eig_vals_source)) / 2
    gap = jnp.where(gap > 0, gap, 1.0)
    diff = eig_vals_target[:, None] - eig_vals_source[None, :]
    c_lambda = jnp.exp(jnp.minimum(diff**2 / (2.0 * gap**2), 80.0))

    # c_hist (eigsort.py:162-189).  Equal sample sizes -> sorted-difference
    # W1 (one sort per matrix); unequal (reference: each graph keeps its own
    # rand_idxs, graph.py:274-290) -> exact merged-CDF W1 vmapped over the
    # k x k column pairs — both fully jittable (static shapes).
    lt_r = jnp.log(jnp.maximum(rand_target_eig_vecs + 0.5 + eps, eps))
    ls_r = jnp.log(jnp.maximum(rand_source_eig_vecs + 0.5 + eps, eps))
    lsf_r = jnp.log(jnp.maximum(-rand_source_eig_vecs + 0.5 + eps, eps))
    if rand_target_eig_vecs.shape[0] == rand_source_eig_vecs.shape[0]:
        lt = jnp.sort(lt_r, axis=0)
        ls = jnp.sort(ls_r, axis=0)
        lsf = jnp.sort(lsf_r, axis=0)
        c_hist = jnp.mean(jnp.abs(lt[:, :, None] - ls[:, None, :]), axis=0)
        c_hist_f = jnp.mean(jnp.abs(lt[:, :, None] - lsf[:, None, :]), axis=0)
    else:
        from ..ops.wasserstein import wasserstein_1d

        pairwise_w1 = jax.vmap(
            jax.vmap(wasserstein_1d, in_axes=(None, 1)), in_axes=(1, None)
        )
        c_hist = pairwise_w1(lt_r, ls_r)
        c_hist_f = pairwise_w1(lt_r, lsf_r)

    # c_spatial (eigsort.py:191-233).  Direct-difference form, NOT the
    # |t|^2+|g|^2-2tg matmul identity: for well-matched eigvec columns the
    # identity cancels catastrophically in f32 (sums ~1e2 cancelling to
    # ~1e0), and the resulting ~50% errors in the smallest Q entries get
    # amplified by the hypersensitive confidence weighting
    # exp(-(Q lam)^2 / 2 sigma^2) (focusr.py:459-490) — observed as a 0.91
    # vs 0.80 weight disagreement with the f64 oracle.  The [n, k, k]
    # broadcast is tiny (k <= ~10).
    _, idx = nn_query(rand_source_points, rand_target_points)
    gathered = rand_source_eig_vecs[idx]
    n_t = rand_target_eig_vecs.shape[0]
    d_straight = rand_target_eig_vecs[:, :, None] - gathered[:, None, :]
    d_flipped = rand_target_eig_vecs[:, :, None] + gathered[:, None, :]
    c_spatial = jnp.sqrt(jnp.sum(d_straight**2, axis=0)) / n_t
    c_spatial_f = jnp.sqrt(jnp.sum(d_flipped**2, axis=0)) / n_t

    c = c_spatial * c_lambda * c_hist
    c_f = c_spatial_f * c_lambda * c_hist_f
    Q = jnp.minimum(c, c_f)
    S = c > c_f

    # target_as_reference=False (eigsort.py:75-78,100-122) is the SAME
    # algorithm run on the transposed cost: assignment over Q.T's rows
    # (source modes), flips/permutation applied to the TARGET eigvecs.
    if not target_as_reference:
        Q = Q.T
        S = S.T

    # Assignment on device (rows=reference modes, cols=permuted-side modes).
    # k <= 8: exact static enumeration.  k > 8: exact device JV
    # (ops/assignment._jv_device) — replaces the round-1 epsilon-scaling
    # auction fallback, whose epsilon floor was too coarse for eigsort
    # costs (entries shrink toward ~1e-4 as the subsample grows; observed
    # wrong permutations on near-identical meshes).  Both paths are exact.
    if k <= 8:
        src_of_tgt = exact_lap_small(Q)  # [k]
    else:
        src_of_tgt, _ = _jv_device(
            Q, jnp.zeros((k,), jnp.float32), 64 * k
        )
        # Safety net for the (never-observed) step-budget bail: -1 gather
        # indices would silently clamp under jit, so substitute identity.
        src_of_tgt = jnp.where(
            jnp.any(src_of_tgt < 0), jnp.arange(k), src_of_tgt
        )
    rows = jnp.arange(k)
    Q_vec = Q[rows, src_of_tgt]
    flipped = S[rows, src_of_tgt]

    # sign[col] = -1 where that permuted-side column is a flipped best-match.
    sign = jnp.ones((k,), jnp.float32).at[src_of_tgt].set(
        jnp.where(flipped, -1.0, 1.0)
    )
    # Permutation matrix: out[:, r] = in[:, src_of_tgt[r]] (after flip).
    P = jax.nn.one_hot(src_of_tgt, k, dtype=jnp.float32).T
    # HIGHEST precision: at the default (TF32 on a GPU) this one-hot permutation
    # would round every eigenvector entry to bf16 when the public
    # entry point is called outside an f32_matmuls scope.
    vecs = jnp.matmul(eig_vecs_to_permute * sign[None, :], P, precision=_PREC)
    return vecs, Q_vec
