"""Coherent Point Drift (Myronenko & Song 2010) — affine and low-rank
deformable registration, on the accelerator.

Replaces the Cython ``cycpd`` package the reference drives from
``focusr.py:297-334``.  The API surface consumed there is preserved exactly:

    reg = deformable_registration(X=..., Y=..., num_eig=100,
                                  max_iterations=..., tolerance=...,
                                  alpha=..., beta=..., verbose=...)
    TY, params = reg.register()
    moved = reg.transform_point_cloud(other_points)   # out-of-sample

    reg = affine_registration(X=..., Y=..., max_iterations=..., tolerance=...)

(X = fixed reference cloud, Y = moving cloud; FOCUSR moves the *target*
spectral cloud onto the *source* — direction handled by the caller, see
``focusr.py:297-334``.)  Affine substitutes for rigid because D > 3
(``focusr.py:318``).

Design:
  * The EM loop is one `lax.while_loop` (tolerance + iteration cap), fully
    on-device; no per-iteration host sync.
  * E-step: responsibilities P [M, N] from one matmul (pairwise sq-dists
    at f32 precision) + row/col reductions.  P1/Pt1/PX are the only outputs.
  * Deformable M-step uses the *low-rank* Gaussian kernel G ~ Q L Q^T with the
    top ``num_eig`` eigenpairs (cycpd's ``num_eig`` knob, default 100,
    ``focusr.py:46,307``) obtained by randomized subspace iteration — two
    passes of [M, M] x [M, p] matmuls + QR + a small eigh, dense matmul work,
    instead of a host Lanczos.  The M-step is solved in the kernel
    eigenbasis with symmetric sqrt(lam) balancing (see _deformable_cpd_run)
    — mathematically the Woodbury solve, but f32-stable even for
    near-singular Grams (the reference example's beta=50).
  * ``transform_point_cloud`` evaluates the fitted field out-of-sample with
    a conditioning-aware form (see ``lowrank_transform``), tiled over rows
    so the [N_full, M] kernel never fully materializes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.precision import f32_matmuls

_PREC = jax.lax.Precision.HIGHEST

__all__ = [
    "affine_registration",
    "deformable_registration",
    "gaussian_kernel",
    "low_rank_gaussian",
    "lowrank_transform",
]


# Single source of truth for squared distances (direct differences, exact
# f32), shared with the KNN queries.
from .knn import pairwise_sq_dists as _sq_dists


def _gram_sq_dists(a, b):
    """Squared distances of the Gaussian Gram by the f32 (HIGHEST) matmul
    identity.  The Gram keeps this form rather than the direct
    differences of ``knn.pairwise_sq_dists``: the randomized eigensolve
    of ``low_rank_gaussian`` resolves the Gram's tail eigenvalues only to
    f32 noise, with either form (rank 40 of a 300-point Gram against
    float64, 24 draws: median error 2.8% direct, 3.2% identity), so the
    direct form gains nothing there and would re-draw that noise in every
    CPD warp and in the tail-eigenvalue test."""
    an = jnp.sum(a * a, axis=1, keepdims=True)
    bn = jnp.sum(b * b, axis=1, keepdims=True)
    return jnp.maximum(an + bn.T - 2.0 * jnp.dot(a, b.T, precision=_PREC), 0.0)


def gaussian_kernel(a, b, beta):
    """G[i, j] = exp(-||a_i - b_j||^2 / (2 beta^2))."""
    return jnp.exp(-_gram_sq_dists(a, b) / (2.0 * beta**2))


def _estep(X, TY, sigma2, w):
    """CPD E-step.  Returns (Pt1 [N], P1 [M], PX [M, D], Np, L).

    L is the negative log-likelihood term, returned for signature parity
    with the tiled E-step; the solvers converge on |delta sigma2|
    (pycpd semantics) and do not consume it, so XLA dead-code-eliminates
    it under jit.
    """
    M = TY.shape[0]
    N, D = X.shape
    d2 = _sq_dists(TY, X)  # [M, N]
    P = jnp.exp(-d2 / (2.0 * sigma2))
    c = (2.0 * jnp.pi * sigma2) ** (D / 2.0) * (w / (1.0 - w)) * (M / N) if w > 0 else 0.0
    den = jnp.sum(P, axis=0) + c
    den = jnp.maximum(den, 1e-30)
    L = -jnp.sum(jnp.log(den)) + D * N * jnp.log(sigma2) / 2.0
    P = P / den[None, :]
    Pt1 = jnp.sum(P, axis=0)
    P1 = jnp.sum(P, axis=1)
    PX = jnp.dot(P, X, precision=_PREC)
    Np = jnp.sum(P1)
    return Pt1, P1, PX, Np, L


def _init_sigma2(X, Y):
    """sigma2_0 = sum_ij ||y_i - x_j||^2 / (D M N) (pycpd initialize_sigma2)
    in CLOSED FORM: sum_ij d2 = N sum|y|^2 + M sum|x|^2 - 2 sum_y . sum_x,
    so no [M, N] buffer is ever allocated — the tiled E-step exists
    precisely to keep [M, N] out of HBM at large M*N, and materializing it
    here (10 GB at 50k x 50k) would defeat them.  Both clouds are shifted by
    their joint mean first (distance-invariant) so a large common offset
    cannot cancel catastrophically in f32."""
    N, D = X.shape
    M = Y.shape[0]
    c = (jnp.sum(X, axis=0) + jnp.sum(Y, axis=0)) / (M + N)
    Xc = X - c[None, :]
    Yc = Y - c[None, :]
    total = (
        N * jnp.sum(Yc * Yc)
        + M * jnp.sum(Xc * Xc)
        - 2.0
        * jnp.dot(jnp.sum(Yc, axis=0), jnp.sum(Xc, axis=0), precision=_PREC)
    )
    return jnp.maximum(total, 0.0) / (D * M * N)


# ----------------------------------------------------------------------
# Affine CPD
# ----------------------------------------------------------------------
@partial(jax.jit, static_argnames=("max_iterations", "w"))
@f32_matmuls
def _affine_cpd_run(X, Y, max_iterations: int, tolerance: float, w: float = 0.0):
    N, D = X.shape
    sigma2_0 = _init_sigma2(X, Y)

    def cond(state):
        B, t, sigma2, err, it = state
        return jnp.logical_and(it < max_iterations, err > tolerance)

    def body(state):
        B, t, sigma2, _, it = state
        TY = jnp.dot(Y, B.T, precision=_PREC) + t[None, :]
        Pt1, P1, PX, Np, L = _estep(X, TY, sigma2, w)
        mu_x = (X.T @ Pt1) / Np
        mu_y = (Y.T @ P1) / Np
        Xh = X - mu_x[None, :]
        Yh = Y - mu_y[None, :]
        # A = Xh^T P^T Yh computed from PX without materializing P twice.
        A = jnp.dot((PX - P1[:, None] * mu_x[None, :]).T, Yh, precision=_PREC)
        YPY = jnp.dot(Yh.T * P1[None, :], Yh, precision=_PREC)
        B_new = jnp.linalg.solve(YPY.T, A.T).T
        t_new = mu_x - B_new @ mu_y
        xPx = jnp.dot(Pt1, jnp.sum(Xh * Xh, axis=1))
        trAB = jnp.trace(A @ B_new.T)
        sigma2_new = (xPx - trAB) / (Np * D)
        sigma2_new = jnp.maximum(sigma2_new, tolerance / 10.0)
        err = jnp.abs(sigma2_new - sigma2)
        return B_new, t_new, sigma2_new, err, it + 1

    B0 = jnp.eye(D, dtype=X.dtype)
    t0 = jnp.zeros((D,), X.dtype)
    state = (B0, t0, sigma2_0, jnp.asarray(jnp.inf, X.dtype), jnp.int32(0))
    B, t, sigma2, err, it = jax.lax.while_loop(cond, body, state)
    TY = jnp.dot(Y, B.T, precision=_PREC) + t[None, :]
    return TY, B, t, sigma2, it


class affine_registration:
    """cycpd-compatible affine CPD (consumed at reference ``focusr.py:319-331``)."""

    def __init__(self, X, Y, max_iterations=100, tolerance=1e-8, w=0.0, **_ignored):
        self.X = jnp.asarray(X, jnp.float32)
        self.Y = jnp.asarray(Y, jnp.float32)
        self.max_iterations = int(max_iterations)
        self.tolerance = float(tolerance)
        self.w = float(w)
        self.B = None
        self.t = None
        self.sigma2 = None
        self.iterations_run = None
        self.TY = None

    def register(self):
        TY, B, t, sigma2, it = _affine_cpd_run(
            self.X, self.Y, self.max_iterations, self.tolerance, self.w
        )
        self.TY, self.B, self.t = TY, B, t
        self.sigma2 = float(sigma2)
        self.iterations_run = int(it)
        return TY, self.get_registration_parameters()

    def get_registration_parameters(self):
        # pycpd/cycpd convention: the returned B RIGHT-multiplies Y
        # (TY = Y @ B + t — see tools/pycpd_oracle.py AffineRegistration).
        # Internally this class stores the transpose (TY = Y @ B_int.T + t),
        # so migrated callers applying the returned params directly get the
        # correct transform even for non-symmetric (shear/rotation) fits.
        return {"B": np.asarray(self.B).T, "t": np.asarray(self.t)}

    def transform_point_cloud(self, points):
        points = jnp.asarray(points, jnp.float32)
        return jnp.dot(points, self.B.T, precision=_PREC) + self.t[None, :]


# ----------------------------------------------------------------------
# Low-rank deformable CPD
# ----------------------------------------------------------------------
@partial(jax.jit, static_argnames=("num_eig",))
@f32_matmuls
def low_rank_gaussian(Y, beta, num_eig: int, key):
    """Top-``num_eig`` eigenpairs of the M x M Gaussian Gram of Y via
    randomized subspace iteration (Halko et al.): exact enough for the
    fast-decaying Gaussian spectrum, and pure dense matmuls.

    For M above ~8k the Gram is applied in row tiles
    (tiled.gaussian_matvec_tiled) so it never materializes —
    full-resolution CPD support the CPU reference lacks.

    Returns (Q [M, k], lam [k]) with G ~ Q diag(lam) Q^T.
    """
    from .tiled import gaussian_matvec_tiled

    M = Y.shape[0]
    if M <= 8192:
        G = gaussian_kernel(Y, Y, beta)

        def gmat(V):
            return jnp.dot(G, V, precision=_PREC)
    else:
        def gmat(V):
            return gaussian_matvec_tiled(Y, beta, V)

    p = min(num_eig + 16, M)

    # NEGATIVE RESULT (round 4): replacing these Householder QRs (a
    # serial factorization) with SVQB-style Gram orthonormalization does
    # NOT work here.  The Gaussian Gram collapses
    # the block to condition ~1e5+, which SQUARES to ~1e10+ in the
    # [p, p] Gram — beyond f32: single SVQB corrupts the small-eigenvalue
    # tail 1.1x (the tail carries warp detail, see the num_eig note
    # below), double SVQB still misses 3% tolerance, and clamp-instead-
    # of-zero hybrids with a final QR get within 6% on 2/40 modes but
    # degrade non-monotonically with extra passes (clamped noise
    # directions don't re-sharpen predictably).  QR operates on V
    # directly at condition ~1e5 (f32-representable) and is the only
    # scheme that preserves the tail; the time saving is not worth the
    # documented ~6 mm parity cost of a corrupted tail.
    omega = jax.random.normal(key, (M, p), dtype=Y.dtype)
    Z = gmat(omega)
    Qb, _ = jnp.linalg.qr(Z)
    for _ in range(2):  # subspace iterations sharpen small eigvals
        Z = gmat(Qb)
        Qb, _ = jnp.linalg.qr(Z)
    H = Qb.T @ gmat(Qb)
    H = 0.5 * (H + H.T)
    lam, S = jnp.linalg.eigh(H)  # ascending
    lam = lam[::-1][:num_eig]
    S = S[:, ::-1][:, :num_eig]
    Q = Qb @ S
    # Keep ALL num_eig modes (cycpd keeps all 100 f64 eigh modes).  For very
    # smooth kernels (e.g. the reference example's beta=50 on unit-scale
    # spectral coords) the true spectrum decays below f32 resolution and the
    # randomized estimates of the tail are noise-floor values (can even be
    # negative) — but those modes still span the warp-carrying subspace, and
    # the balanced M-step in _deformable_cpd_run handles tiny eigenvalues
    # gracefully (a mode's gain goes to zero with its eigenvalue; no 1/lam
    # amplification).  Empirically, truncating them turned the fitted warp
    # into a near-rigid translation and cost ~6 mm of correspondence parity
    # vs the f64 reference on the bundled 5k pair.  Negative estimates clamp
    # to zero, which zeroes the mode exactly.
    lam = jnp.maximum(lam, 0.0)
    return Q, lam


@partial(jax.jit, static_argnames=("max_iterations", "w", "estep_impl"))
@f32_matmuls
def _deformable_cpd_run(
    X,
    Y,
    Q,
    lam,
    alpha: float,
    max_iterations: int,
    tolerance: float,
    w: float = 0.0,
    estep_impl: str = "dense",
    landmarks=None,
):
    """EM loop with a *balanced* low-rank M-step (numerically f32-safe
    reformulation of cycpd/pycpd ``low_rank``).

    The textbook Woodbury form
        W = (F - dPQ ((a_s2 inv(lam) + Q^T dPQ)^-1 (Q^T F))) / a_s2
    catastrophically cancels in f32 once a_s2 = alpha sigma2 becomes small
    (the parenthesized difference is ~a_s2 * W, i.e. ~1e-8 of its term
    magnitudes) — measured 0.11 warp deviation vs the f64 oracle on the
    reference example config (beta=50 -> near-rank-1 Gram).  Instead solve in
    the kernel eigenbasis with symmetric balancing: with S = diag(sqrt(lam)),
    z = S Q^T W, the M-step system (diag(P1) G + a_s2 I) W = F projects to

        (S C S + a_s2 I_k) z = S Q^T F,      C = Q^T diag(P1) Q

    (k x k SPD, no division by a_s2), and the fitted displacement is
    G W = Q S z — every quantity bounded.  Mathematically identical to
    Woodbury for the projected warp; in f32 it tracks the f64 EM trajectory
    to ~1e-3 where Woodbury diverges by ~1e-1.  State is z; the returned
    second element is z (spectral warp coefficients), not W.

    ``landmarks`` (beyond-reference capability): optional
    ``(lm_idx i32 [L], lm_pos f32 [L, D], lm_w f32 [L])`` prior
    correspondences — moving point ``Y[lm_idx[l]]`` is pulled toward the
    fixed position ``lm_pos[l]`` with pseudo-responsibility ``lm_w[l]``
    (the MAP extension of CPD with known correspondences: the landmark
    terms add to diag(P1) and PX in the M-step; sigma2 stays data-driven).
    A weight of ~10 pins a landmark strongly relative to the soft matches.
    """
    N, D = X.shape
    M = Y.shape[0]
    k = lam.shape[0]
    sigma2_0 = _init_sigma2(X, Y)
    # f32-identifiability gate: eigenvalue estimates below lam_max * 2 eps are
    # numerically meaningless (any f32 decomposition's noise floor), and once
    # a_s2 becomes tiny the balanced solve would amplify them into the warp
    # (z_j ~ Ft_j / sqrt(lam_j)).  Zeroing sqrt_lam removes the mode exactly:
    # its row of A reduces to a_s2 * e_j with zero rhs.
    eps2 = 2.0 * jnp.finfo(X.dtype).eps
    sqrt_lam = jnp.where(lam > lam[0] * eps2, jnp.sqrt(lam), 0.0)
    eye_k = jnp.eye(k, dtype=X.dtype)

    def kernel_apply_z(z):
        # Displacement at the control points: G W = Q diag(sqrt(lam)) z.
        return jnp.dot(Q, sqrt_lam[:, None] * z, precision=_PREC)

    if estep_impl == "dense":
        def estep(TY, sigma2):
            return _estep(X, TY, sigma2, w)
    else:
        from .tiled import cpd_estep_tiled

        def estep(TY, sigma2):
            c = (
                (2.0 * jnp.pi * sigma2) ** (D / 2.0) * (w / (1.0 - w)) * (M / N)
                if w > 0
                else 0.0
            )
            return cpd_estep_tiled(X, TY, sigma2, c)

    def cond(state):
        z, sigma2, err, it = state
        return jnp.logical_and(it < max_iterations, err > tolerance)

    if landmarks is not None:
        lm_idx, lm_pos, lm_w = landmarks
        lam_vec = jnp.zeros((M,), X.dtype).at[lm_idx].add(lm_w)
        lm_px = jnp.zeros((M, X.shape[1]), X.dtype).at[lm_idx].add(
            lm_w[:, None] * lm_pos
        )
    else:
        lam_vec = None

    def body(state):
        z, sigma2, _, it = state
        TY = Y + kernel_apply_z(z)
        Pt1, P1, PX, Np, L = estep(TY, sigma2)
        # Landmark priors augment the M-step SOLVE only; sigma2 below stays
        # data-driven (P1/PX from the E-step).
        if lam_vec is not None:
            P1_solve = P1 + lam_vec
            PX_solve = PX + lm_px
        else:
            P1_solve, PX_solve = P1, PX
        a_s2 = alpha * sigma2
        F = PX_solve - P1_solve[:, None] * Y  # [M, D]
        Ft = jnp.dot(Q.T, F, precision=_PREC)  # [k, D]
        C = jnp.dot(Q.T, P1_solve[:, None] * Q, precision=_PREC)  # [k, k]
        A = sqrt_lam[:, None] * C * sqrt_lam[None, :] + a_s2 * eye_k
        z_new = jnp.linalg.solve(A, sqrt_lam[:, None] * Ft)
        TY_new = Y + kernel_apply_z(z_new)
        xPx = jnp.dot(Pt1, jnp.sum(X * X, axis=1))
        yPy = jnp.dot(P1, jnp.sum(TY_new * TY_new, axis=1))
        trPXY = jnp.sum(TY_new * PX)
        sigma2_new = (xPx - 2.0 * trPXY + yPy) / (Np * D)
        sigma2_new = jnp.maximum(sigma2_new, tolerance / 10.0)
        err = jnp.abs(sigma2_new - sigma2)
        return z_new, sigma2_new, err, it + 1

    z0 = jnp.zeros((k, D), X.dtype)
    state = (z0, sigma2_0, jnp.asarray(jnp.inf, X.dtype), jnp.int32(0))
    z, sigma2, err, it = jax.lax.while_loop(cond, body, state)
    TY = Y + kernel_apply_z(z)
    return TY, z, sigma2, it


@partial(jax.jit, static_argnames=("tile",))
@f32_matmuls
def lowrank_transform(points, Y0, Q, lam, z, beta, tile: int = 2048):
    """Out-of-sample warp of the fitted low-rank CPD field (the reference
    applies it to the FULL target spectral cloud at ``focusr.py:334``):
    cycpd/pycpd semantics ``points + G(points, Y0) @ W``.

    The f32-stable evaluation uses the *balanced* weights
    W = Q diag(1/sqrt(lam)) z (with the same identifiability gate as the
    fit) — roundoff is amplified only by 1/sqrt(lam), not the 1/lam of the
    naive Woodbury W, so the exact form stays accurate even for the
    near-rank-1 Grams the reference produces (beta=50 on unit spectral
    clouds).  Measured against the pycpd-faithful f64 oracle
    (tools/pycpd_oracle.py, the code path cycpd cythonizes): 0.7-5.4% of
    the displacement magnitude across reference-shaped configs, vs 77-79%
    for the Nadaraya-Watson control-point interpolation that round 2
    auto-selected for ill-conditioned Grams (that branch matched only the
    round-2 paper-derived oracle's projected-W convention; it was removed
    when the oracle was made cycpd-faithful — see tests/test_cpd_oracles.py).

    Remaining deviation from pycpd in regimes where num_eig does NOT
    capture the kernel spectrum (small beta relative to data extent):
    pycpd's W keeps components outside the retained eigenbasis which the
    low-rank fit never represents; measured 32% of displacement at
    beta=3 on extent-2 clouds with num_eig=100/500.  The reference's
    config space (minmax-normalized spectral coords, beta >= 3) always has
    a captured spectrum.
    """
    # Same f32-identifiability gate as _deformable_cpd_run (whose z for gated
    # modes is exactly 0 anyway).
    eps2 = 2.0 * jnp.finfo(points.dtype).eps
    sqrt_lam = jnp.where(lam > lam[0] * eps2, jnp.sqrt(lam), 0.0)
    safe = jnp.maximum(sqrt_lam, jnp.finfo(points.dtype).tiny)
    wt = jnp.where(sqrt_lam[:, None] > 0, z / safe[:, None], 0.0)
    W = jnp.dot(Q, wt, precision=_PREC)  # [M, D] exact-form weights

    def move(pts):
        disp = jnp.dot(gaussian_kernel(pts, Y0, beta), W, precision=_PREC)
        return pts + disp

    n = points.shape[0]
    if n * Y0.shape[0] <= 32_000_000:
        return move(points)
    n_pad = ((n + tile - 1) // tile) * tile
    pts = jnp.pad(points, ((0, n_pad - n), (0, 0)))
    tiles = pts.reshape(n_pad // tile, tile, -1)

    def step(_, pt):
        return None, move(pt)

    _, out = jax.lax.scan(step, None, tiles)
    return out.reshape(n_pad, -1)[:n]


class deformable_registration:
    """cycpd-compatible low-rank deformable CPD
    (consumed at reference ``focusr.py:299-316``)."""

    def __init__(
        self,
        X,
        Y,
        num_eig=100,
        max_iterations=1000,
        tolerance=1e-8,
        alpha=0.5,
        beta=3.0,
        w=0.0,
        verbose=False,
        seed=0,
        estep_impl=None,  # None = auto: dense small, tiled large
        landmarks=None,  # (Y_indices i32 [L], fixed_positions f32 [L, D],
        #                  weights f32 [L]) prior correspondences
        **_ignored,
    ):
        self.X = jnp.asarray(X, jnp.float32)
        self.Y = jnp.asarray(Y, jnp.float32)
        self.num_eig = int(min(num_eig, self.Y.shape[0]))
        self.max_iterations = int(max_iterations)
        self.tolerance = float(tolerance)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.w = float(w)
        self.verbose = verbose
        self.seed = seed
        if estep_impl is None:
            big = self.X.shape[0] * self.Y.shape[0] > 3000 * 3000
            estep_impl = "tiled" if big else "dense"
        self.estep_impl = estep_impl
        if landmarks is not None:
            li, lp, lw = landmarks
            landmarks = (
                jnp.asarray(li, jnp.int32),
                jnp.asarray(lp, jnp.float32),
                jnp.asarray(lw, jnp.float32),
            )
        self.landmarks = landmarks
        self.z = None
        self.sigma2 = None
        self.iterations_run = None
        self.TY = None

    def register(self):
        Q, lam = low_rank_gaussian(
            self.Y, self.beta, self.num_eig, jax.random.PRNGKey(self.seed)
        )
        self._Q, self._lam = Q, lam
        TY, z, sigma2, it = _deformable_cpd_run(
            self.X,
            self.Y,
            Q,
            lam,
            self.alpha,
            self.max_iterations,
            self.tolerance,
            self.w,
            estep_impl=self.estep_impl,
            landmarks=self.landmarks,
        )
        self.TY, self.z = TY, z
        self.sigma2 = float(sigma2)
        self.iterations_run = int(it)
        if self.verbose:
            print(
                f"CPD deformable: {self.iterations_run} iterations, "
                f"sigma2={self.sigma2:.3e}"
            )
        return TY, self.get_registration_parameters()

    @property
    def W(self):
        """cycpd-compatible kernel weights (W such that displacement =
        G(., Y0) @ W).  Reconstructed from the balanced spectral coefficients
        z; for near-singular kernels (huge beta) entries are large by the
        same 1/lam the true cycpd W carries — prefer transform_point_cloud,
        which evaluates the field stably."""
        if self.z is None:
            return None
        sqrt_lam = jnp.sqrt(self._lam)
        safe = jnp.maximum(sqrt_lam, jnp.finfo(jnp.float32).tiny)
        wt = jnp.where(sqrt_lam[:, None] > 0, self.z / safe[:, None], 0.0)
        return jnp.dot(self._Q, wt, precision=_PREC)

    def get_registration_parameters(self):
        return {
            "W": np.asarray(self.W),
            "z": np.asarray(self.z),
            "beta": self.beta,
            "Y0": np.asarray(self.Y),
        }

    def transform_point_cloud(self, points):
        """Out-of-sample warp of the fitted field (applied to the full cloud
        at reference ``focusr.py:334``).  See ``lowrank_transform`` for the
        conditioning-aware evaluation."""
        points = jnp.asarray(points, jnp.float32)
        return lowrank_transform(
            points, self.Y, self._Q, self._lam, self.z, self.beta
        )
