"""Parity against straight numpy transcriptions of the reference's formulas
(SURVEY §4: the reference ships no usable tests, so we build the oracle).

These oracles are written as the reference writes them — literal per-element
loops over the published equations (with file:line citations) — and the
vectorized JAX implementations must reproduce them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial import KDTree
from scipy.stats import wasserstein_distance

from pyfocusr_tpu.spectral.eigsort import (
    _c_lambda,
    _c_hist_pair,
    _c_spatial_pair,
)


@pytest.fixture(scope="module")
def spectral_data(mesh_5k_source, mesh_5k_target):
    """Real eigenvectors from the two bundled meshes (k=4 for speed)."""
    from pyfocusr_tpu.spectral.graph import Graph

    gt = Graph(mesh_5k_target, n_spectral_features=4, n_rand_samples=2000, seed=0)
    gt.get_graph_spectrum()
    gs = Graph(mesh_5k_source, n_spectral_features=4, n_rand_samples=2000, seed=1)
    gs.get_graph_spectrum()
    return gt, gs


class TestEigsortCostOracles:
    def test_c_lambda_matches_loop(self, spectral_data):
        """Oracle: reference ``eigsort.py:142-160``."""
        gt, gs = spectral_data
        lt = np.asarray(gt.eig_vals)
        ls = np.asarray(gs.eig_vals)
        gap = (np.mean(np.diff(lt)) + np.mean(np.diff(ls))) / 2
        k = 4
        oracle = np.zeros((k, k))
        for i in range(k):
            for j in range(k):
                oracle[i, j] = np.exp((lt[i] - ls[j]) ** 2 / (2 * gap**2))
        ours = np.asarray(_c_lambda(jnp.asarray(lt), jnp.asarray(ls), gap))
        np.testing.assert_allclose(ours, oracle, rtol=1e-5)

    def test_c_hist_matches_loop(self, spectral_data):
        """Oracle: reference ``eigsort.py:162-189`` (Wasserstein on
        log-shifted eigvec samples, straight and flipped)."""
        gt, gs = spectral_data
        tv = np.asarray(gt.get_rand_eig_vecs())[:, :4]
        sv = np.asarray(gs.get_rand_eig_vecs())[:, :4]
        eps = np.finfo(float).eps
        k = 4
        c_ref = np.zeros((k, k))
        cf_ref = np.zeros((k, k))
        for i in range(k):
            for j in range(k):
                c_ref[i, j] = wasserstein_distance(
                    np.log(tv[:, i] + 0.5 + eps), np.log(sv[:, j] + 0.5 + eps)
                )
                cf_ref[i, j] = wasserstein_distance(
                    np.log(tv[:, i] + 0.5 + eps), np.log(-sv[:, j] + 0.5 + eps)
                )
        c, cf = _c_hist_pair(jnp.asarray(tv), jnp.asarray(sv))
        np.testing.assert_allclose(np.asarray(c), c_ref, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(cf), cf_ref, rtol=1e-4, atol=1e-6)

    def test_c_spatial_matches_loop(self, spectral_data):
        """Oracle: reference ``eigsort.py:191-233`` (RMS eigvec difference
        over xyz nearest neighbors)."""
        gt, gs = spectral_data
        tv = np.asarray(gt.get_rand_eig_vecs())[:, :4]
        sv = np.asarray(gs.get_rand_eig_vecs())[:, :4]
        tp = np.asarray(gt.get_rand_normalized_points())
        sp = np.asarray(gs.get_rand_normalized_points())
        _, idx = KDTree(sp).query(tp)
        k = 4
        n_t = tv.shape[0]
        c_ref = np.zeros((k, k))
        cf_ref = np.zeros((k, k))
        for i in range(k):
            for j in range(k):
                c_ref[i, j] = np.sqrt(np.sum((sv[idx, j] - tv[:, i]) ** 2)) / n_t
                cf_ref[i, j] = np.sqrt(np.sum((-sv[idx, j] - tv[:, i]) ** 2)) / n_t
        c, cf = _c_spatial_pair(
            jnp.asarray(tv), jnp.asarray(sv), jnp.asarray(tp), jnp.asarray(sp)
        )
        np.testing.assert_allclose(np.asarray(c), c_ref, rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(np.asarray(cf), cf_ref, rtol=1e-3, atol=1e-6)


class TestCPDOracle:
    """Full-rank numpy CPD EM oracle (Myronenko & Song 2010 eqs., the
    algorithm cycpd implements) vs our low-rank JAX implementation."""

    @staticmethod
    def _numpy_deformable_cpd(X, Y, alpha, beta, iters):
        M, D = Y.shape
        N = X.shape[0]
        G = np.exp(
            -((Y[:, None, :] - Y[None, :, :]) ** 2).sum(-1) / (2 * beta**2)
        )
        W = np.zeros((M, D))
        sigma2 = ((X[None] - Y[:, None]) ** 2).sum() / (D * M * N)
        for _ in range(iters):
            TY = Y + G @ W
            d2 = ((X[None] - TY[:, None]) ** 2).sum(-1)
            P = np.exp(-d2 / (2 * sigma2))
            den = np.maximum(P.sum(0), 1e-30)
            P = P / den[None, :]
            P1 = P.sum(1)
            PX = P @ X
            Np = P1.sum()
            A = np.diag(P1) @ G + alpha * sigma2 * np.eye(M)
            W = np.linalg.solve(A, PX - np.diag(P1) @ Y)
            TY = Y + G @ W
            xPx = (P.sum(0) * (X**2).sum(1)).sum()
            yPy = (P1 * (TY**2).sum(1)).sum()
            trPXY = (TY * PX).sum()
            sigma2 = max((xPx - 2 * trPXY + yPy) / (Np * D), 1e-12)
        return Y + G @ W, sigma2

    @staticmethod
    def _numpy_lowrank_cpd(X, Y, alpha, beta, iters, num_eig):
        """pycpd/cycpd ``low_rank`` algorithm with exact f64 eigh.  The
        noise-floor truncation below is inert at this test's num_eig/beta
        (all retained modes are far above the floor); ops/cpd keeps all
        modes and solves in the balanced eigenbasis instead."""
        M, D = Y.shape
        N = X.shape[0]
        G = np.exp(
            -((Y[:, None, :] - Y[None, :, :]) ** 2).sum(-1) / (2 * beta**2)
        )
        lam_all, Q_all = np.linalg.eigh(G)
        lam = lam_all[::-1][:num_eig].copy()
        Q = Q_all[:, ::-1][:, :num_eig].copy()
        valid = lam > lam.max() * 1e-6
        lam[~valid] = 1.0
        Q[:, ~valid] = 0.0
        inv_lam = np.diag(1.0 / lam)

        def kernel_apply(W):
            return Q @ (lam[:, None] * (Q.T @ W))

        W = np.zeros((M, D))
        sigma2 = ((X[None] - Y[:, None]) ** 2).sum() / (D * M * N)
        for _ in range(iters):
            TY = Y + kernel_apply(W)
            d2 = ((X[None] - TY[:, None]) ** 2).sum(-1)
            P = np.exp(-d2 / (2 * sigma2))
            den = np.maximum(P.sum(0), 1e-30)
            P = P / den[None, :]
            P1 = P.sum(1)
            PX = P @ X
            Np = P1.sum()
            a_s2 = alpha * sigma2
            F = PX - P1[:, None] * Y
            dPQ = P1[:, None] * Q
            inner = a_s2 * inv_lam + Q.T @ dPQ
            W = (F - dPQ @ np.linalg.solve(inner, Q.T @ F)) / a_s2
            TY = Y + kernel_apply(W)
            xPx = (P.sum(0) * (X**2).sum(1)).sum()
            yPy = (P1 * (TY**2).sum(1)).sum()
            trPXY = (TY * PX).sum()
            sigma2 = max((xPx - 2 * trPXY + yPy) / (Np * D), 1e-12)
        return Y + kernel_apply(W), sigma2

    def test_matches_numpy_lowrank_oracle_short(self):
        """Our JAX low-rank CPD == the f64 numpy low-rank oracle over a short
        EM trajectory (before f32-vs-f64 rounding compounds — as sigma^2
        shrinks the EM map becomes increasingly sensitive, so long-horizon
        trajectory comparison is ill-posed; final *quality* is checked by
        test_low_rank_close_to_full_rank)."""
        from pyfocusr_tpu.ops.cpd import deformable_registration

        rng = np.random.default_rng(0)
        M = 300
        Y = rng.uniform(-1, 1, size=(M, 3)).astype(np.float32)
        X = (Y + 0.1 * np.sin(2 * Y[:, [1, 2, 0]])).astype(np.float32)
        # num_eig=25: lam_25/lam_1 ~ 1e-4 — all retained modes are solidly
        # above the f32 noise floor, so the randomized and exact-eigh
        # low-rank models coincide and tight parity is meaningful.
        alpha, beta, iters, num_eig = 2.0, 1.5, 8, 25
        TY_ref, s2_ref = self._numpy_lowrank_cpd(
            X.astype(np.float64), Y.astype(np.float64), alpha, beta, iters, num_eig
        )
        reg = deformable_registration(
            X=X, Y=Y, num_eig=num_eig, max_iterations=iters, tolerance=0.0,
            alpha=alpha, beta=beta,
        )
        TY, _ = reg.register()
        err = np.linalg.norm(np.asarray(TY) - TY_ref, axis=1)
        assert err.max() < 2e-3, err.max()
        assert abs(reg.sigma2 - s2_ref) / s2_ref < 0.02

    def test_low_rank_close_to_full_rank(self):
        """Low-rank is a controlled approximation of the full-rank model
        (registration-quality agreement, not bitwise)."""
        from pyfocusr_tpu.ops.cpd import deformable_registration

        rng = np.random.default_rng(0)
        M = 300
        Y = rng.uniform(-1, 1, size=(M, 3)).astype(np.float32)
        X = (Y + 0.1 * np.sin(2 * Y[:, [1, 2, 0]])).astype(np.float32)
        alpha, beta, iters = 2.0, 1.5, 60
        TY_ref, _ = self._numpy_deformable_cpd(
            X.astype(np.float64), Y.astype(np.float64), alpha, beta, iters
        )
        reg = deformable_registration(
            X=X, Y=Y, num_eig=150, max_iterations=iters, tolerance=0.0,
            alpha=alpha, beta=beta,
        )
        TY, _ = reg.register()
        err = np.linalg.norm(np.asarray(TY) - TY_ref, axis=1)
        # Low-rank truncation (plus the f32 noise-floor cut) is a real model
        # difference from full rank once sigma^2 becomes small; demand
        # registration-quality agreement at half the warp scale.
        assert err.mean() < 0.05, err.mean()  # warp scale 0.1
