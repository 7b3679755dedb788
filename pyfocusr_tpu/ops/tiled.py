"""Tiled O(M*N) pairwise stages of full-resolution CPD.

The reference copes with quadratic cost by *subsampling* (CPD runs on
1000-5000 random points, ``focusr.py:300-306``; its docs recommend never
going far beyond that).  Here the pairwise stages are tiled instead, so the
[M, N] matrices never materialize in device memory (the 15k x 15k CPD
responsibility matrix would be 900 MB), which makes FULL-RESOLUTION CPD
practical — a capability the CPU reference does not have.

Hyperparameter note for full resolution: CPD's smoothness weight ``alpha``
multiplies sigma^2 against a data term that grows with the number of
registered points, so alpha tuned for an n-point subsample must be scaled by
~N/n when registering all N points (measured on the 15k pair: alpha=0.01 at
n=1000 == alpha~0.15 at N=15k; without rescaling the warp overfits and
correspondence quality collapses).

Contents (plain XLA, any backend):
  * ``cpd_estep_tiled`` — CPD E-step over row tiles of the responsibility
    matrix.
  * ``gaussian_matvec_tiled`` — Gaussian-Gram matvec in row tiles.

The E-step's squared distances are direct coordinate differences
(``knn.pairwise_sq_dists``); the Gaussian Gram keeps the matmul identity
of ``cpd.gaussian_kernel``.  All matmuls run at f32 precision (see
utils/precision.py for why).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .knn import pairwise_sq_dists

_PREC = jax.lax.Precision.HIGHEST

__all__ = ["cpd_estep_tiled", "gaussian_matvec_tiled"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ----------------------------------------------------------------------
# Tiled CPD E-step
# ----------------------------------------------------------------------
@partial(jax.jit, static_argnames=("tile_m",))
def cpd_estep_tiled(X, TY, sigma2, c, tile_m: int = 2048):
    """CPD E-step over M-tiles: returns (Pt1 [N], P1 [M], PX [M, D], Np, L)
    with P never materialized beyond one [tile_m, N] slab.

    c is the uniform-outlier constant ((2 pi s2)^{D/2} w/(1-w) M/N; 0 for
    w=0, the reference's setting).
    """
    N, D = X.shape
    M = TY.shape[0]
    m_pad = _round_up(M, tile_m)
    TY_p = jnp.pad(TY, ((0, m_pad - M), (0, 0)), constant_values=1e15)
    ty_tiles = TY_p.reshape(m_pad // tile_m, tile_m, D)

    def slab(ty_tile):
        return jnp.exp(-pairwise_sq_dists(ty_tile, X) / (2.0 * sigma2))

    # Pass 1: denominator per X point.
    def den_step(carry, ty_tile):
        return carry + jnp.sum(slab(ty_tile), axis=0), None

    den, _ = jax.lax.scan(den_step, jnp.zeros((N,), X.dtype), ty_tiles)
    den = jnp.maximum(den + c, 1e-30)
    L = -jnp.sum(jnp.log(den)) + D * N * jnp.log(sigma2) / 2.0

    # Pass 2: row sums P1 and moment PX with the normalized P.
    inv_den = 1.0 / den

    def row_step(_, ty_tile):
        Pn = slab(ty_tile) * inv_den[None, :]
        return None, (jnp.sum(Pn, axis=1), jnp.dot(Pn, X, precision=_PREC))

    _, (p1_tiles, px_tiles) = jax.lax.scan(row_step, None, ty_tiles)
    P1 = p1_tiles.reshape(m_pad)[:M]
    PX = px_tiles.reshape(m_pad, D)[:M]
    Pt1 = 1.0 - c * inv_den  # column sums of normalized P
    Np = jnp.sum(P1)
    return Pt1, P1, PX, Np, L


# ----------------------------------------------------------------------
# Tiled Gaussian-Gram matvec (for randomized eigendecomposition at full res)
# ----------------------------------------------------------------------
@partial(jax.jit, static_argnames=("tile",))
def gaussian_matvec_tiled(Y, beta, V, tile: int = 2048):
    """Z = G V where G = exp(-||y_i - y_j||^2 / 2 beta^2), computed in row
    tiles so the [M, M] Gram never materializes (M = 15k -> 900 MB saved)."""
    M, D = Y.shape
    m_pad = _round_up(M, tile)
    Y_p = jnp.pad(Y, ((0, m_pad - M), (0, 0)), constant_values=1e15)
    yn = jnp.sum(Y * Y, axis=1)
    y_tiles = Y_p.reshape(m_pad // tile, tile, D)

    def step(_, y_tile):
        # The Gram's matmul-identity distances (see cpd._gram_sq_dists).
        tn = jnp.sum(y_tile * y_tile, axis=1)
        d2 = tn[:, None] + yn[None, :] - 2.0 * jnp.dot(y_tile, Y.T, precision=_PREC)
        g = jnp.exp(-jnp.maximum(d2, 0.0) / (2.0 * beta**2))
        return None, jnp.dot(g, V, precision=_PREC)

    _, z_tiles = jax.lax.scan(step, None, y_tiles)
    return z_tiles.reshape(m_pad, -1)[:M]

