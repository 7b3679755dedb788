"""Graph operators over padded fixed-degree (ELL) neighbor tables.

Everything here is a pure jittable function.  These replace the reference's
scipy.sparse machinery:

- feature-weighted adjacency assembly      (reference ``graph.py:148-178``)
- degree / inverse-degree                  (reference ``graph.py:216-219``)
- G vector variants (exp/log/square/shift) (reference ``graph.py:180-214``)
- random-walk Laplacian  L = G (D - W)     (reference ``graph.py:221-226``)
- iterative mean filter (graph low-pass)   (reference ``graph.py:320-354``)

Design: the sparse matrix never exists.  The graph is (neighbors i32[N,D],
weights f32[N,D]) with padding masked to weight 0; an SpMV is a gather plus a
masked weighted reduction over the small static degree axis D — static shapes,
no scatter, fuses cleanly under jit, and `lax.scan` turns the 40-600-iteration
smoothing loops into a single compiled loop on-device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.precision import f32_matmuls

__all__ = [
    "edge_weights",
    "overflow_weights",
    "degree_vector",
    "spmv",
    "mean_filter",
    "mean_filter_chebyshev",
    "g_vector",
    "laplacian_matvec",
    "sym_laplacian_matvec",
]

# Hub-vertex overflow: vertices whose degree exceeds the ELL cap carry their
# extra directed edges in a [E_o, 2] (src, dst) list processed by scatter-add,
# so SpMV cost is bounded by TOTAL edge count instead of max degree (a
# UV-sphere pole of degree 320 would otherwise inflate every row 40x).
# Padding rows use src == dst, which yields weight 0.

DEGREE_EPS = 1e-8  # matches reference ``graph.py:219`` (d + 1e-8)**-1


def edge_weights(coords: jnp.ndarray, neighbors: jnp.ndarray, nbr_mask: jnp.ndarray) -> jnp.ndarray:
    """Adjacency weights w[i,s] = 1 / ||c_i - c_{nbr[i,s]}|| over real slots.

    ``coords`` may be xyz [N,3] or xyz augmented with mean-range-scaled extra
    features [N, 3+K] (the ``include_features_in_adj_matrix`` path, reference
    ``graph.py:166-175``).  Padding slots get weight 0.
    """
    nbr_coords = coords[neighbors]  # [N, D, C]
    diff = nbr_coords - coords[:, None, :]
    dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    # Padding slots point at the vertex itself (dist 0); mask them out and
    # guard the reciprocal.  Degenerate meshes with coincident CONNECTED
    # vertices would make w = 1/0 = inf (the reference crashes the same way,
    # graph.py:177-178); clamp to a huge-but-finite weight instead so the
    # pipeline stays NaN-free.
    safe = jnp.maximum(jnp.where(nbr_mask > 0, dist, 1.0), 1e-20)
    return jnp.where(nbr_mask > 0, 1.0 / safe, 0.0)


def overflow_weights(coords: jnp.ndarray, overflow: jnp.ndarray) -> jnp.ndarray:
    """w = 1/dist for overflow directed edges; padding rows (src==dst) -> 0."""
    if overflow.shape[0] == 0:
        return jnp.zeros((0,), coords.dtype)
    src, dst = overflow[:, 0], overflow[:, 1]
    diff = coords[src] - coords[dst]
    dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    real = src != dst
    safe = jnp.maximum(jnp.where(real, dist, 1.0), 1e-20)
    return jnp.where(real, 1.0 / safe, 0.0)


def degree_vector(weights: jnp.ndarray, overflow=None, ov_w=None) -> jnp.ndarray:
    """d_i = sum_j w_ij (row sums of W; reference ``graph.py:216-218``)."""
    d = jnp.sum(weights, axis=1)
    if overflow is not None and overflow.shape[0] > 0:
        d = d.at[overflow[:, 0]].add(ov_w)
    return d


def spmv(
    neighbors: jnp.ndarray,
    weights: jnp.ndarray,
    x: jnp.ndarray,
    overflow=None,
    ov_w=None,
) -> jnp.ndarray:
    """y = W @ x for x of shape [N] or [N, C]."""
    if x.ndim == 1:
        y = jnp.sum(weights * x[neighbors], axis=1)
        if overflow is not None and overflow.shape[0] > 0:
            y = y.at[overflow[:, 0]].add(ov_w * x[overflow[:, 1]])
        return y
    y = jnp.einsum("nd,ndc->nc", weights, x[neighbors])
    if overflow is not None and overflow.shape[0] > 0:
        y = y.at[overflow[:, 0]].add(ov_w[:, None] * x[overflow[:, 1]])
    return y


@partial(jax.jit, static_argnames=("iterations",))
@f32_matmuls
def mean_filter(neighbors, weights, values, iterations: int, overflow=None, ov_w=None):
    """Iterative graph low-pass filter: out <- diag(1/(1+d)) (W + I) out,
    repeated ``iterations`` times (reference ``mean_filter_graph``,
    ``graph.py:320-354``; call sites use 1-600 iterations).

    Runs as one `lax.scan` — a single on-device loop of fused gather/SpMV
    steps instead of 600 scipy SpMV round-trips.
    """
    squeeze = values.ndim == 1
    x = values[:, None] if squeeze else values
    inv = 1.0 / (1.0 + degree_vector(weights, overflow, ov_w))

    def step(carry, _):
        out = inv[:, None] * (
            spmv(neighbors, weights, carry, overflow, ov_w) + carry
        )
        return out, None

    x, _ = jax.lax.scan(step, x, None, length=iterations)
    return x[:, 0] if squeeze else x


def g_vector(
    node_features,  # [K, N] normalized features, or None / shape (0, N)
    degrees: jnp.ndarray,
    feature_weights: jnp.ndarray,  # [K, K], only the diagonal is used
    p_function: str = "exp",
    include_features: bool = False,
    valid_mask: jnp.ndarray = None,  # [N] 1=real vertex; excludes padding
                                     # rows from the min/max scaling stats
) -> jnp.ndarray:
    """The diagonal of G in L = G (D - W)  (reference ``graph.py:180-214``).

    Default (no features): G = diag((d + 1e-8)^-1) — random-walk normalization.
    With features: per-feature transform p in {exp, log, square, shift-to->=0},
    scaled into the range of the degree diagonal and weighted by
    feature_weights[k,k], averaged over features, then multiplied by d_inv.

    Deviation from the reference, by design: ``graph.py:206`` computes
    ``np.ptp(self.degree_matrix)`` on a *sparse* matrix, which returns a sparse
    matrix rather than a scalar (verified empirically) — a latent defect in a
    path that is off by default.  We use the intended scalar, the peak-to-peak
    of the degree diagonal.
    """
    d_inv = (degrees + DEGREE_EPS) ** -1
    if not include_features or node_features is None or node_features.shape[0] == 0:
        return d_inv

    if valid_mask is None:
        def mmin(x):
            return jnp.min(x)

        def mmax(x):
            return jnp.max(x)
    else:
        def mmin(x):
            return jnp.min(jnp.where(valid_mask > 0, x, jnp.inf))

        def mmax(x):
            return jnp.max(jnp.where(valid_mask > 0, x, -jnp.inf))

    k_features = node_features.shape[0]
    g = jnp.zeros_like(degrees)
    deg_ptp = mmax(degrees) - mmin(degrees)
    for k in range(k_features):
        f = node_features[k]
        if p_function == "exp":
            gk = jnp.exp(f)
        elif p_function == "log":
            gk = jnp.log(f - mmin(f) + 1.0)
        elif p_function == "square":
            gk = f**2
        else:
            gk = f - mmin(f)
        # Guard a CONSTANT transformed feature (ptp 0 -> inf scaling -> NaN
        # spectrum): a feature with no variation carries no information, so
        # it gets zero weight — consistent with edge_weights' NaN-free clamp.
        gk_ptp = mmax(gk) - mmin(gk)
        scaling = jnp.where(
            gk_ptp > 0,
            feature_weights[k, k] * deg_ptp / jnp.maximum(gk_ptp, 1e-30),
            0.0,
        )
        g = g + gk * scaling
    g = g / k_features
    return g * d_inv


def laplacian_matvec(
    neighbors, weights, g, x, overflow=None, ov_w=None, degrees=None
):
    """L x = g * ((d * x) - W x) — the (generally non-symmetric) operator
    L = G (D - W) of reference ``graph.py:221-226`` applied matrix-free.

    ``degrees``: pass the precomputed degree vector when applying the
    operator inside a solver loop — recomputing the [N, D] row-sum +
    overflow scatter per application otherwise relies on XLA loop-invariant
    hoisting."""
    d = degrees if degrees is not None else degree_vector(weights, overflow, ov_w)
    if x.ndim == 1:
        return g * (d * x - spmv(neighbors, weights, x, overflow, ov_w))
    return g[:, None] * (
        d[:, None] * x - spmv(neighbors, weights, x, overflow, ov_w)
    )


def sym_laplacian_matvec(
    neighbors, weights, g, x, overflow=None, ov_w=None, degrees=None
):
    """Symmetrized operator A = diag(s) (D - W) diag(s), s = sqrt(g).

    A is similar to L = diag(g)(D - W):  L = diag(s) A diag(s)^-1, so they
    share eigenvalues and eigvecs map as u_L = s * v_A.  This makes the
    ARPACK-on-non-symmetric-L contract of the reference (``graph.py:357-389``)
    solvable with a symmetric device eigensolver.  Requires g > 0 (true for the
    default d_inv and for the exp feature transform).
    """
    s = jnp.sqrt(g)
    d = degrees if degrees is not None else degree_vector(weights, overflow, ov_w)
    if x.ndim == 1:
        sx = s * x
        return s * (d * sx - spmv(neighbors, weights, sx, overflow, ov_w))
    sx = s[:, None] * x
    return s[:, None] * (
        d[:, None] * sx - spmv(neighbors, weights, sx, overflow, ov_w)
    )


def sym_laplacian_quad_form(neighbors, weights, s, V, overflow=None, ov_w=None):
    """Per-column Rayleigh quotients of A = S(D-W)S on unit-norm V, computed
    as the EDGE-DIFFERENCE quadratic form

        lam_k = 1/2 sum_{directed edges (i,j)} w_ij (u_ik - u_jk)^2,  u = s V

    which is a sum of NON-NEGATIVE terms — unlike the matvec form
    V^T (S(D-W)S V), whose row-level D x - W x cancellation amplifies f32
    roundoff by ~d/lambda_rel (the source of the 3.6e-3 relative eigenvalue
    floor vs ARPACK on the 15k mesh; the quad form measures ~1e-5).  Both
    directions of every edge appear in the ELL+overflow structure, hence the
    1/2.  Adjacent u values are close, so the f32 subtraction u_i - u_j is
    (near-)exact by Sterbenz's lemma and each term carries only ~eps
    relative error.
    """
    u = s[:, None] * V  # [N, k]
    du = u[neighbors] - u[:, None, :]  # [N, D, k]
    acc = jnp.einsum("nd,ndk->k", weights, du * du)
    if overflow is not None and overflow.shape[0] > 0:
        dov = u[overflow[:, 0]] - u[overflow[:, 1]]
        acc = acc + jnp.sum(ov_w[:, None] * dov * dov, axis=0)
    return 0.5 * acc


def _chebyshev_power_coeffs(q: int, m: int):
    """Chebyshev-series coefficients of f(t) = t^q on [-1, 1], degree m,
    computed host-side to f64 accuracy via the discrete cosine transform at
    Chebyshev points (exact for m >= q; tail decays like exp(-k^2 / 2q))."""
    import numpy as np

    n = m + 1
    theta = (np.arange(n) + 0.5) * np.pi / n
    t = np.cos(theta)
    f = t.astype(np.float64) ** q
    k = np.arange(n)[:, None]
    c = (2.0 / n) * (np.cos(k * theta[None, :]) @ f)
    c[0] *= 0.5
    return c  # [m+1]


@partial(jax.jit, static_argnames=("iterations", "degree"))
@f32_matmuls
def mean_filter_chebyshev(
    neighbors, weights, values, iterations: int, overflow=None, ov_w=None,
    degree: int = 0,
):
    """Chebyshev-accelerated graph low-pass: applies the SAME operator power
    A^q (A = diag(1/(1+d))(W + I), reference ``graph.py:320-354``) as
    ``mean_filter`` but as a degree-~sqrt(2 q ln 1/eps) Chebyshev polynomial
    of the symmetrized operator — ~5x fewer SpMVs at q = 600 for ~1e-5
    approximation error.  A is row-stochastic (spectrum in [-1, 1]) and
    similar to S = D~^{-1/2}(W + I)D~^{-1/2}, so
    A^q x = D~^{-1/2} p_m(S) D~^{1/2} x.

    Opt-in (PipelineConfig.fast_smoothing): output differs from the exact
    600-step iteration at the polynomial-truncation level, not bitwise.
    """
    import math

    q = iterations
    if degree <= 0:
        degree = min(q, int(math.sqrt(2.0 * q * math.log(1e5))) + 8)
    if degree >= q:
        return mean_filter(neighbors, weights, values, q, overflow, ov_w)

    squeeze = values.ndim == 1
    x = values[:, None] if squeeze else values
    d = degree_vector(weights, overflow, ov_w)
    inv_sqrt = (1.0 + d) ** -0.5

    def s_op(v):
        # S v = D~^{-1/2} (W + I) D~^{-1/2} v
        u = inv_sqrt[:, None] * v
        return inv_sqrt[:, None] * (spmv(neighbors, weights, u, overflow, ov_w) + u)

    coeffs = jnp.asarray(_chebyshev_power_coeffs(q, degree), jnp.float32)
    x0 = x / inv_sqrt[:, None]  # D~^{1/2} x

    t_prev = x0
    t_cur = s_op(x0)
    acc = coeffs[0] * t_prev + coeffs[1] * t_cur

    def body(kk, carry):
        t_prev, t_cur, acc = carry
        t_next = 2.0 * s_op(t_cur) - t_prev
        acc = acc + coeffs[kk] * t_next
        return t_cur, t_next, acc

    _, _, acc = jax.lax.fori_loop(2, degree + 1, body, (t_prev, t_cur, acc))
    out = inv_sqrt[:, None] * acc
    return out[:, 0] if squeeze else out
