"""Eigenmap alignment: sign-flip and reorder source eigenvectors to match the
target's (or vice versa).

Re-design of the reference ``eigsort`` class (``eigsort.py:9-249``).  The
three cost matrices are computed as vectorized device ops instead of k^2
Python loops:

  * c_lambda — eigenvalue dissimilarity, one broadcast outer op
    (reference ``eigsort.py:142-160``; note the *positive* exponent:
    a growing cost, not a Gaussian similarity — preserved).
  * c_hist / c_hist_f — 1-D Wasserstein between log-shifted eigenvector
    samples, straight and sign-flipped (reference ``eigsort.py:162-189``),
    via exact sorted-quantile W1 (ops/wasserstein.py).
  * c_spatial / c_spatial_f — RMS eigenvector difference over nearest-neighbor
    pairs in normalized xyz (reference ``eigsort.py:191-233``), with the NN
    query as the brute-force device KNN and the k x k reduction as one matmul.

The final assignment (k ~ 6-10) solves on host (ops/assignment.lap_host).
The class mirrors the reference's *mutating* contract — ``sort_eigenmaps()``
permutes/flips ``graph_source.eig_vecs`` in place (or the target's when
``target_as_reference=False``) and returns the per-pair cost vector Q
(``eigsort.py:89,115-122``) — while the pure function ``sort_eigenmaps_fn``
exposes the same computation functionally for the jit pipeline.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.assignment import lap_host
from ..ops.knn import nn_query
from ..utils.logging import print_header

__all__ = ["eigsort", "sort_eigenmaps_fn"]

_EPS = float(np.finfo(np.float64).eps)


def _c_lambda(eig_vals_target, eig_vals_source, gap):
    """exp((lt_i - ls_j)^2 / (2 gap^2)) (reference ``eigsort.py:155-160``).
    Exponent clamped at 80 (matching the jit path, eigsort_jax.py): far-apart
    mode pairs saturate instead of overflowing f32 downstream."""
    diff = eig_vals_target[:, None] - eig_vals_source[None, :]
    return jnp.exp(jnp.minimum(diff**2 / (2.0 * gap**2), 80.0))


def _c_hist_pair(t_vecs, s_vecs):
    """W1 cost between log-shifted eigvec samples, straight and flipped.

    t_vecs [Nt, k], s_vecs [Ns, k] are the random-subsample eigenvectors.
    Returns (c_hist [k,k], c_hist_f [k,k]).
    """
    # Clamp to the valid log domain: eigvecs are min-max normalized into
    # [-0.5, 0.5] (graph.py:254-257) but numerical noise can leak epsilon
    # outside, which would NaN the whole cost matrix in the reference.
    lt = jnp.log(jnp.maximum(t_vecs + 0.5 + _EPS, _EPS))
    ls = jnp.log(jnp.maximum(s_vecs + 0.5 + _EPS, _EPS))
    ls_f = jnp.log(jnp.maximum(-s_vecs + 0.5 + _EPS, _EPS))
    if t_vecs.shape[0] == s_vecs.shape[0]:
        # Equal sample sizes: W1 = mean |sorted_u - sorted_v| exactly.
        st = jnp.sort(lt, axis=0)  # [N, k]
        ss = jnp.sort(ls, axis=0)
        ssf = jnp.sort(ls_f, axis=0)
        c = jnp.mean(jnp.abs(st[:, :, None] - ss[:, None, :]), axis=0)
        cf = jnp.mean(jnp.abs(st[:, :, None] - ssf[:, None, :]), axis=0)
        return c, cf
    from ..ops.wasserstein import wasserstein_1d

    # Unequal sample sizes: exact merged-CDF W1 vmapped over the k x k
    # column pairs (one compiled call instead of a Python k^2 loop).
    pairwise_w1 = jax.vmap(
        jax.vmap(wasserstein_1d, in_axes=(None, 1)), in_axes=(1, None)
    )
    return pairwise_w1(lt, ls), pairwise_w1(lt, ls_f)


def _c_spatial_pair(t_vecs, s_vecs, t_points_norm, s_points_norm):
    """RMS eigvec difference over xyz nearest neighbors
    (reference ``eigsort.py:191-233``).  Returns (c_spatial, c_spatial_f)."""
    # Direct-difference form (same fix as eigsort_jax): the t^2+g^2-2tg
    # matmul identity cancels catastrophically in f32 for well-matched
    # columns, corrupting the smallest Q entries that feed the confidence
    # weighting (focusr.py:459-490).
    _, idx = nn_query(s_points_norm, t_points_norm)
    gathered = s_vecs[idx]  # [Nt, k] source eigvec at NN of each target pt
    n_t = t_vecs.shape[0]
    d = t_vecs[:, :, None] - gathered[:, None, :]  # [Nt, k_t, k_s]
    d_f = t_vecs[:, :, None] + gathered[:, None, :]
    c = jnp.sqrt(jnp.sum(d * d, axis=0)) / n_t
    cf = jnp.sqrt(jnp.sum(d_f * d_f, axis=0)) / n_t
    return c, cf


def sort_eigenmaps_fn(
    eig_vals_target,
    eig_vals_source,
    rand_target_eig_vecs,
    rand_source_eig_vecs,
    rand_target_points,
    rand_source_points,
    eig_vecs_to_permute,  # full-resolution eigvecs of the non-reference graph
    target_as_reference: bool = True,
):
    """Pure eigsort: returns (permuted_flipped_eig_vecs, Q, matches, flips).

    Implements ``eigen_sort`` (reference ``eigsort.py:54-122``): build c and
    the flipped c_f from the three cost factors, Q = min elementwise, solve the
    assignment on Q (or Q^T), flip matched columns where the flipped variant
    won, permute columns into reference order, and reduce Q to the per-match
    cost vector (the deliberate deviation from the Matlab original documented
    at ``eigsort.py:79-89``).
    """
    # k == 1 (empty diff) and exactly degenerate spectra (gap 0) fall back
    # to gap=1 instead of producing NaN costs (matches eigsort_jax.py).
    k_t, k_s = eig_vals_target.shape[0], eig_vals_source.shape[0]
    gap_t = jnp.mean(jnp.diff(eig_vals_target)) if k_t > 1 else 0.0
    gap_s = jnp.mean(jnp.diff(eig_vals_source)) if k_s > 1 else 0.0
    gap = (gap_t + gap_s) / 2.0
    gap = jnp.where(gap > 0, gap, 1.0)

    c_lambda = _c_lambda(eig_vals_target, eig_vals_source, gap)
    c_hist, c_hist_f = _c_hist_pair(rand_target_eig_vecs, rand_source_eig_vecs)
    c_spatial, c_spatial_f = _c_spatial_pair(
        rand_target_eig_vecs,
        rand_source_eig_vecs,
        rand_target_points,
        rand_source_points,
    )

    c = np.asarray(c_spatial * c_lambda * c_hist)
    c_f = np.asarray(c_spatial_f * c_lambda * c_hist_f)
    Q = np.minimum(c, c_f)
    S = c > c_f  # True where the flipped pairing is better

    if target_as_reference:
        target_matches, source_matches = lap_host(Q)
    else:
        source_matches, target_matches = lap_host(Q.T)

    Q_vec = Q[target_matches, source_matches]
    flipped = S[target_matches, source_matches]

    vecs = eig_vecs_to_permute
    if target_as_reference:
        flip_cols = source_matches[flipped]
        sign = np.ones(vecs.shape[1], np.float32)
        sign[flip_cols] = -1.0
        vecs = vecs * jnp.asarray(sign)[None, :]
        # Column permutation: new[:, target_matches] = old[:, source_matches]
        perm = np.arange(vecs.shape[1])
        perm[target_matches] = source_matches
        vecs = vecs[:, jnp.asarray(perm)]
    else:
        flip_cols = target_matches[flipped]
        sign = np.ones(vecs.shape[1], np.float32)
        sign[flip_cols] = -1.0
        vecs = vecs * jnp.asarray(sign)[None, :]
        perm = np.arange(vecs.shape[1])
        perm[source_matches] = target_matches
        vecs = vecs[:, jnp.asarray(perm)]

    info = {
        "target_matches": target_matches,
        "source_matches": source_matches,
        "flipped": flipped,
        "c": c,
        "c_f": c_f,
        "Q_full": np.minimum(c, c_f),
        "c_lambda": np.asarray(c_lambda),
        "c_hist": np.asarray(c_hist),
        "c_hist_f": np.asarray(c_hist_f),
        "c_spatial": np.asarray(c_spatial),
        "c_spatial_f": np.asarray(c_spatial_f),
    }
    return vecs, jnp.asarray(Q_vec.astype(np.float32)), info


class eigsort:
    """API-compatible wrapper mirroring the reference class
    (``eigsort.py:9-52``): holds the two graphs, exposes the cost matrices as
    attributes, and ``sort_eigenmaps()`` mutates the non-reference graph's
    ``eig_vecs`` in place and returns Q."""

    def __init__(self, graph_target, graph_source, n_features, target_as_reference=True):
        self.graph_target = graph_target
        self.graph_source = graph_source
        self.n_features = n_features
        self.target_as_reference = target_as_reference

        self.rand_target_points = graph_target.get_rand_normalized_points()
        self.rand_source_points = graph_source.get_rand_normalized_points()
        self.rand_target_eig_vecs = graph_target.get_rand_eig_vecs()[:, :n_features]
        self.rand_source_eig_vecs = graph_source.get_rand_eig_vecs()[:, :n_features]

        self.c_lambda = None
        self.c_hist = None
        self.c_hist_f = None
        self.c_spatial = None
        self.c_spatial_f = None
        self.Q = None

    # ------------------------------------------------------------------
    # Individual cost computations — method-level API parity with the
    # reference class (``eigsort.py:142-233``).  ``sort_eigenmaps`` computes
    # everything in one fused pass; these exist for callers that inspected
    # the matrices piecemeal.
    # ------------------------------------------------------------------
    def calc_c_lambda(self):
        lt = np.asarray(self.graph_target.eig_vals[: self.n_features])
        ls = np.asarray(self.graph_source.eig_vals[: self.n_features])
        # Same k==1 / degenerate-spectrum fallback as the pure fn and the
        # jit path: an empty diff (NaN mean) or zero gap would NaN every
        # cost entry silently.
        gap_t = float(np.mean(np.diff(lt))) if lt.shape[0] > 1 else 0.0
        gap_s = float(np.mean(np.diff(ls))) if ls.shape[0] > 1 else 0.0
        gap = (gap_t + gap_s) / 2.0
        if not gap > 0:
            gap = 1.0
        self.c_lambda = np.asarray(
            _c_lambda(jnp.asarray(lt), jnp.asarray(ls), gap)
        )
        return self.c_lambda

    def calc_c_hist(self):
        c, cf = _c_hist_pair(self.rand_target_eig_vecs, self.rand_source_eig_vecs)
        self.c_hist = np.asarray(c)
        self.c_hist_f = np.asarray(cf)
        return self.c_hist

    def calc_c_spatial(self):
        c, cf = _c_spatial_pair(
            self.rand_target_eig_vecs,
            self.rand_source_eig_vecs,
            self.rand_target_points,
            self.rand_source_points,
        )
        self.c_spatial = np.asarray(c)
        self.c_spatial_f = np.asarray(cf)
        return self.c_spatial

    def eigen_sort(self):
        """Alias matching the reference's method name (``eigsort.py:54``):
        runs the full fused sort (costs + assignment + flip/permute)."""
        return self.sort_eigenmaps()

    def sort_eigenmaps(self):
        if self.target_as_reference:
            vecs_in = self.graph_source.eig_vecs
        else:
            vecs_in = self.graph_target.eig_vecs

        vecs_out, Q_vec, info = sort_eigenmaps_fn(
            self.graph_target.eig_vals[: self.n_features],
            self.graph_source.eig_vals[: self.n_features],
            self.rand_target_eig_vecs,
            self.rand_source_eig_vecs,
            self.rand_target_points,
            self.rand_source_points,
            vecs_in,
            target_as_reference=self.target_as_reference,
        )
        # Cost-matrix attributes mirror the reference (``eigsort.py:45-49``).
        self.c = info["c"]
        self.c_f = info["c_f"]
        self.c_lambda = info["c_lambda"]
        self.c_hist = info["c_hist"]
        self.c_hist_f = info["c_hist_f"]
        self.c_spatial = info["c_spatial"]
        self.c_spatial_f = info["c_spatial_f"]
        self.Q = Q_vec

        if self.target_as_reference:
            self.graph_source.eig_vecs = vecs_out
        else:
            self.graph_target.eig_vecs = vecs_out

        # Match/flip report (reference ``eigsort.py:123-140``).
        print_header("Eigenvector Sorting Results")
        ref_name = "target" if self.target_as_reference else "source"
        print(f"Using {ref_name} eigenmaps as the reference")
        print("The matches for eigenvectors were as follows:")
        print("Target\t|  Source")
        for t, s, fl in zip(
            info["target_matches"], info["source_matches"], info["flipped"]
        ):
            sv, tv = str(s), str(t)
            if fl:
                if self.target_as_reference:
                    sv = "-" + sv
                else:
                    tv = "-" + tv
            print("{:6}\t|  {:6}".format(tv, sv))
        print("*Negative source values means those eigenvectors were flipped*\n ")
        return self.Q
