"""Pairwise stages against their plain references: the tiled CPD E-step
and Gaussian matvec, the Sinkhorn/JV assignment pieces, and the KNN
contract (cKDTree's results, tie rule and missing-neighbor sentinel)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyfocusr_tpu.ops import knn
from pyfocusr_tpu.ops.cpd import _estep, gaussian_kernel
from pyfocusr_tpu.ops.tiled import cpd_estep_tiled, gaussian_matvec_tiled


def _knn(ref, query, k, chunk_rows=None, monkeypatch=None):
    """knn.knn_query, optionally with query chunks of ``chunk_rows`` rows
    against this reference width (so chunk boundaries are exercised)."""
    if chunk_rows is not None:
        monkeypatch.setattr(
            knn, "_QUERY_CHUNK_ELEMS", chunk_rows * ref.shape[0]
        )
    return knn.knn_query(jnp.asarray(ref), jnp.asarray(query), k)


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(0)
    M, N, D = 700, 900, 3
    X = jnp.asarray(rng.uniform(-1, 1, (N, D)), jnp.float32)
    TY = jnp.asarray(rng.uniform(-1, 1, (M, D)), jnp.float32)
    return X, TY


class TestEstep:
    def test_tiled_matches_dense(self, clouds):
        X, TY = clouds
        ref = _estep(X, TY, 0.05, 0.0)
        out = cpd_estep_tiled(X, TY, 0.05, 0.0, tile_m=256)
        for a, b in zip(ref, out):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)

    def test_with_outlier_term(self, clouds):
        X, TY = clouds
        s2 = 0.05
        w = 0.1
        M, (N, D) = TY.shape[0], X.shape
        c = (2 * np.pi * s2) ** (D / 2) * (w / (1 - w)) * (M / N)
        ref = _estep(X, TY, s2, w)
        out = cpd_estep_tiled(X, TY, s2, c, tile_m=256)
        for a, b in zip(ref, out):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)

    def test_nonsquare_padding(self):
        # M not a multiple of the tile: padded rows must not leak into
        # den / Pt1 / L, and the P1 / PX slices drop them.
        rng = np.random.default_rng(1)
        X = jnp.asarray(rng.uniform(-1, 1, (513, 3)), jnp.float32)
        TY = jnp.asarray(rng.uniform(-1, 1, (258, 3)), jnp.float32)
        ref = _estep(X, TY, 0.1, 0.0)
        out = cpd_estep_tiled(X, TY, 0.1, 0.0, tile_m=128)
        assert out[1].shape == (258,) and out[2].shape == (258, 3)
        for a, b in zip(ref, out):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


def test_gaussian_matvec_tiled(clouds):
    _, TY = clouds
    rng = np.random.default_rng(2)
    V = jnp.asarray(rng.normal(size=(TY.shape[0], 5)), jnp.float32)
    ref = gaussian_kernel(TY, TY, 1.3) @ V
    out = gaussian_matvec_tiled(TY, 1.3, V, tile=256)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=5e-5)


@pytest.mark.slow
def test_fullres_cpd_matches_dense_small():
    """estep_impl='tiled' inside the EM loop == dense EM loop."""
    from pyfocusr_tpu.ops.cpd import _deformable_cpd_run, low_rank_gaussian

    rng = np.random.default_rng(0)
    M = 500
    Y = jnp.asarray(rng.uniform(-1, 1, (M, 3)), jnp.float32)
    X = Y + 0.1 * jnp.sin(2 * Y[:, [1, 2, 0]])
    Q, lam = low_rank_gaussian(Y, 1.5, 60, jax.random.PRNGKey(0))
    # Short trajectory: f32 reduction-order differences between the dense
    # and tiled E-step compound through the EM map as sigma^2 shrinks, so
    # long-horizon bitwise comparison is ill-posed (same caveat as the CPD
    # oracle tests).
    TY_dense, _, s2_dense, _ = _deformable_cpd_run(
        X, Y, Q, lam, 2.0, 8, 0.0, estep_impl="dense"
    )
    TY_tiled, _, s2_tiled, _ = _deformable_cpd_run(
        X, Y, Q, lam, 2.0, 8, 0.0, estep_impl="tiled"
    )
    np.testing.assert_allclose(
        np.asarray(TY_dense), np.asarray(TY_tiled), atol=1e-3
    )
    assert abs(float(s2_dense) - float(s2_tiled)) < 1e-5


def test_sinkhorn_duals_match_float64_logsumexp():
    """The annealed log-domain Sinkhorn duals (the device LAP's warm start)
    against a float64 numpy transcription of the same schedule."""
    from scipy.spatial.distance import cdist
    from scipy.special import logsumexp

    from pyfocusr_tpu.ops.assignment import _sinkhorn_duals

    rng = np.random.default_rng(0)
    a = rng.normal(size=(300, 3))
    b = a + 0.02 * rng.normal(size=a.shape)
    C = cdist(a, b)
    spread = C.max() - C.min()
    levels, iters = 6, 5
    f = np.zeros(300)
    g = np.zeros(300)
    for T in (spread / 4.0) * (1.0 / 3.0) ** np.arange(levels):
        for _ in range(iters):
            f = -T * logsumexp((g[None, :] - C) / T, axis=1)
            g = -T * logsumexp((f[:, None] - C) / T, axis=0)
    f32, g32 = _sinkhorn_duals(
        jnp.asarray(C, jnp.float32), jnp.float32(spread / 4.0), 1.0 / 3.0,
        levels, iters,
    )
    np.testing.assert_allclose(np.asarray(f32), f, atol=2e-4)
    np.testing.assert_allclose(np.asarray(g32), g, atol=2e-4)


def _lap_cost(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random((n, n)).astype(np.float32)
    A = rng.normal(size=(n, 3))
    B = A[rng.permutation(n)] + rng.normal(size=(n, 3)) * 0.01
    return np.linalg.norm(A[:, None, :] - B[None, :, :], axis=-1).astype(
        np.float32
    )


@pytest.mark.parametrize(
    "kind,warm", [("random", False), ("geometric", True)],
    ids=["cold", "warm"],
)
def test_jv_device_exact_vs_scipy(kind, warm):
    """The device Jonker-Volgenant solve is EXACT — same objective as
    scipy — from zero duals (cold) and from arbitrary warm column duals
    (the Sinkhorn warm start feeds it such duals)."""
    from scipy.optimize import linear_sum_assignment

    from pyfocusr_tpu.ops.assignment import _jv_device

    n = 96
    cost = _lap_cost(kind, n, 3)
    rng = np.random.default_rng(4)
    v0 = (rng.normal(size=n) * 0.01 if warm else np.zeros(n)).astype(np.float32)
    col, steps = _jv_device(jnp.asarray(cost), jnp.asarray(v0), 60 * n)
    col = np.asarray(col)
    assert sorted(col) == list(range(n))
    assert 0 <= int(steps) <= 60 * n
    ri, ci = linear_sum_assignment(cost)
    obj = cost[np.arange(n), col].sum()
    obj_ref = cost[ri, ci].sum()
    assert abs(obj - obj_ref) < 1e-5 * max(obj_ref, 1.0), (obj, obj_ref)


class TestKnnDirect:
    """Direct coordinate-difference KNN (the XLA path) vs scipy cKDTree."""

    @pytest.mark.parametrize(
        "nq,nr,d,k,chunk_rows",
        [
            (300, 500, 3, 1, None),
            (300, 500, 3, 3, None),
            # several query chunks, last one ragged
            (77, 2049, 12, 3, 16),
            (8, 9, 2, 3, None),
            (40, 300, 6, 16, 8),
        ],
        ids=["nn_small_d3", "knn3_small_d3", "unaligned_sizes_d12",
             "tiny_ref", "k16_d6"],
    )
    def test_matches_ckdtree(self, nq, nr, d, k, chunk_rows, monkeypatch):
        from scipy.spatial import cKDTree

        rng = np.random.default_rng(0)
        q = rng.normal(size=(nq, d)).astype(np.float32)
        r = rng.normal(size=(nr, d)).astype(np.float32)
        dist, idx = _knn(r, q, k, chunk_rows, monkeypatch)
        sd, si = cKDTree(r).query(q, k=k)
        sd, si = sd.reshape(nq, k), si.reshape(nq, k)
        np.testing.assert_allclose(np.asarray(dist), sd, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(idx), si)

    @pytest.mark.parametrize("layout", ["adjacent", "far_apart"])
    def test_tie_break_lower_index_first(self, layout):
        """Duplicate reference rows: the lower index wins, whether the
        twins are neighbors in index order or far apart."""
        rng = np.random.default_rng(1)
        base = rng.normal(size=(50, 3)).astype(np.float32)
        if layout == "adjacent":
            r = np.repeat(base, 2, axis=0)
            first, second = np.arange(0, 100, 2), np.arange(1, 100, 2)
        else:
            r = np.concatenate([base, base])
            first, second = np.arange(50), np.arange(50, 100)
        _, i = _knn(r, base, 2)
        i = np.asarray(i)
        np.testing.assert_array_equal(i[:, 0], first)
        np.testing.assert_array_equal(i[:, 1], second)
        _, i1 = knn.nn_query(jnp.asarray(r), jnp.asarray(base))
        np.testing.assert_array_equal(np.asarray(i1), first)

    def test_vmap_batches(self):
        from scipy.spatial import cKDTree

        rng = np.random.default_rng(2)
        qb = rng.normal(size=(3, 60, 3)).astype(np.float32)
        rb = rng.normal(size=(3, 90, 3)).astype(np.float32)
        f = jax.vmap(partial(knn.knn_query, k=3))
        db, ib = f(jnp.asarray(rb), jnp.asarray(qb))
        for b in range(3):
            sd, si = cKDTree(rb[b]).query(qb[b], k=3)
            np.testing.assert_allclose(np.asarray(db[b]), sd, atol=1e-5)
            np.testing.assert_array_equal(np.asarray(ib[b]), si)

    def test_exact_f32_where_matmul_identity_cancels(self):
        """Far from the origin the |q|^2+|r|^2-2q.r identity loses the
        small distances to cancellation; the direct form keeps them."""
        rng = np.random.default_rng(3)
        r = (1e4 + 10.0 * rng.random((200, 3))).astype(np.float32)
        q = r[:50] + np.float32(1e-2)
        d, i = knn.nn_query(jnp.asarray(r), jnp.asarray(q))
        np.testing.assert_array_equal(np.asarray(i), np.arange(50))
        # f32 differences of nearby f32 coordinates are exact.
        want = np.linalg.norm(
            q.astype(np.float64) - r[:50].astype(np.float64), axis=1)
        np.testing.assert_allclose(np.asarray(d), want, rtol=1e-5)


class TestKnnDirectContract:
    """NaN reference rows must never poison a query, and missing neighbors
    report cKDTree's (index == nr, inf) sentinel."""

    def test_nan_ref_row_does_not_poison_tile(self):
        rng = np.random.default_rng(0)
        ref = rng.normal(size=(40, 3)).astype(np.float32)
        ref[7] = np.nan  # one bad row
        query = ref[[3, 20, 33]] + 1e-4
        d, i = _knn(ref, query, 1)
        np.testing.assert_array_equal(np.asarray(i)[:, 0], [3, 20, 33])
        assert np.all(np.asarray(d) < 1e-3)

    def test_missing_neighbor_sentinel(self):
        # Only 2 selectable rows but k=3: the third slot must be
        # (index == nr, distance == inf).
        ref = np.asarray(
            [[0, 0, 0], [1, 0, 0], [knn.SENTINEL] * 3, [knn.SENTINEL] * 3],
            np.float32,
        )
        query = np.zeros((1, 3), np.float32)
        d, i = _knn(ref, query, 3)
        d, i = np.asarray(d), np.asarray(i)
        np.testing.assert_array_equal(i[0, :2], [0, 1])
        assert i[0, 2] == ref.shape[0]
        assert np.isinf(d[0, 2])


@pytest.mark.parametrize("nq,nr,want", [(3003, 2000, 12), (10, 10, 1)])
def test_query_chunk_count(monkeypatch, nq, nr, want):
    """Chunks bound the [rows, Nr] block to _QUERY_CHUNK_ELEMS (never
    below 8 rows)."""
    monkeypatch.setattr(knn, "_QUERY_CHUNK_ELEMS", 512 * 1024)
    assert knn._query_chunks(nq, nr) == want
