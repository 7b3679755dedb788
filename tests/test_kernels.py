"""KNN / Wasserstein / assignment kernels vs their scipy counterparts
(the native deps they replace: cKDTree, wasserstein_distance,
linear_sum_assignment — SURVEY §2.3)."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment as scipy_lap
from scipy.spatial import KDTree
from scipy.stats import wasserstein_distance

from pyfocusr_tpu.ops.assignment import auction_lap, lap_host, linear_sum_assignment
from pyfocusr_tpu.ops.knn import knn_query, nn_query, pairwise_sq_dists
from pyfocusr_tpu.ops.wasserstein import wasserstein_1d


class TestKNN:
    def test_nn_matches_kdtree(self):
        rng = np.random.default_rng(0)
        q = rng.random((777, 5)).astype(np.float32) * 10
        r = rng.random((1234, 5)).astype(np.float32) * 10
        d_ref, i_ref = KDTree(r).query(q)
        d, i = nn_query(jnp.asarray(r), jnp.asarray(q))
        assert (np.asarray(i) == i_ref).mean() > 0.999
        np.testing.assert_allclose(np.asarray(d), d_ref, atol=1e-3)

    def test_knn3_matches_kdtree(self):
        rng = np.random.default_rng(1)
        q = rng.random((500, 6)).astype(np.float32)
        r = rng.random((3000, 6)).astype(np.float32)
        d_ref, i_ref = KDTree(r).query(q, k=3)
        d, i = knn_query(jnp.asarray(r), jnp.asarray(q), k=3)
        assert (np.asarray(i) == i_ref).mean() > 0.999
        np.testing.assert_allclose(np.asarray(d), d_ref, atol=1e-3)

    def test_multi_tile(self):
        rng = np.random.default_rng(2)
        q = rng.random((100, 3)).astype(np.float32)
        r = rng.random((5000, 3)).astype(np.float32)
        _, i_ref = KDTree(r).query(q)
        _, i = nn_query(jnp.asarray(r), jnp.asarray(q))
        assert (np.asarray(i) == i_ref).mean() > 0.999

    def test_query_chunking_matches_unchunked(self, monkeypatch):
        # Force the large-query row-chunking path (normally only hit at
        # ~1M queries, where one [Nq, tile] block would OOM) and check it
        # agrees with the single-block path, padding rows sliced off.
        import pyfocusr_tpu.ops.knn as knn_mod

        rng = np.random.default_rng(7)
        q = rng.random((3003, 3)).astype(np.float32)
        r = rng.random((2000, 3)).astype(np.float32)
        d0, i0 = nn_query(jnp.asarray(r), jnp.asarray(q))
        d3, i3 = knn_query(jnp.asarray(r), jnp.asarray(q), k=3)
        monkeypatch.setattr(knn_mod, "_QUERY_CHUNK_ELEMS", 512 * 1024)
        assert knn_mod._query_chunks(q.shape[0], r.shape[0]) > 1
        d1, i1 = knn_mod.nn_query(jnp.asarray(r), jnp.asarray(q))
        d4, i4 = knn_mod.knn_query(jnp.asarray(r), jnp.asarray(q), k=3)
        assert d1.shape == (3003,) and i1.shape == (3003,)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i0))
        np.testing.assert_allclose(np.asarray(d1), np.asarray(d0), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(i4), np.asarray(i3))
        np.testing.assert_allclose(np.asarray(d4), np.asarray(d3), atol=1e-5)

    def test_knn3_masked_column0_is_nn(self):
        # The refine tails reuse knn3_masked's first column as the final
        # 'kd' correspondence instead of a separate nn_query — the two
        # must agree EXACTLY, including on distance ties (both implement
        # the cKDTree tie rule: lowest index wins).
        from pyfocusr_tpu.ops.knn import SENTINEL, idw_from_knn, knn3_masked

        rng = np.random.default_rng(7)
        r = rng.random((400, 3)).astype(np.float32)
        # Duplicate reference rows manufacture exact distance ties.
        r[100:140] = r[0:40]
        mask = np.ones(400, np.float32)
        mask[350:] = 0.0
        q = np.concatenate([rng.random((200, 3)).astype(np.float32),
                            r[20:60]])  # exact hits too
        d3, i3 = knn3_masked(jnp.asarray(r), jnp.asarray(mask), jnp.asarray(q))
        r_q = np.where(mask[:, None] > 0, r, SENTINEL)
        d_nn, i_nn = nn_query(jnp.asarray(r_q), jnp.asarray(q))
        np.testing.assert_array_equal(np.asarray(i3[:, 0]), np.asarray(i_nn))
        np.testing.assert_allclose(np.asarray(d3[:, 0]), np.asarray(d_nn),
                                   atol=1e-6)
        # And idw_pull_k3 == knn3_masked + idw_from_knn by construction.
        from pyfocusr_tpu.ops.knn import idw_pull_k3

        vals = rng.random((400, 3)).astype(np.float32)
        w0 = idw_pull_k3(jnp.asarray(r), jnp.asarray(mask), jnp.asarray(vals),
                         jnp.asarray(q))
        w1 = idw_from_knn(d3, i3, jnp.asarray(vals))
        np.testing.assert_array_equal(np.asarray(w0), np.asarray(w1))

    def test_pairwise_matches_cdist(self):
        from scipy.spatial.distance import cdist

        rng = np.random.default_rng(3)
        a = rng.random((50, 4)).astype(np.float32)
        b = rng.random((70, 4)).astype(np.float32)
        d2 = np.asarray(pairwise_sq_dists(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(np.sqrt(d2), cdist(a, b), atol=1e-4)


class TestWasserstein:
    def test_equal_sizes(self):
        rng = np.random.default_rng(0)
        u = rng.normal(size=1000)
        v = rng.normal(loc=0.3, size=1000)
        got = float(wasserstein_1d(jnp.asarray(u), jnp.asarray(v)))
        assert abs(got - wasserstein_distance(u, v)) < 1e-5

    def test_unequal_sizes(self):
        rng = np.random.default_rng(1)
        u = rng.normal(size=1000)
        v = rng.normal(loc=0.3, size=877)
        got = float(wasserstein_1d(jnp.asarray(u), jnp.asarray(v)))
        assert abs(got - wasserstein_distance(u, v)) < 1e-5


class TestAssignment:
    def test_lap_host_matches_scipy(self):
        rng = np.random.default_rng(0)
        for n, m in [(6, 6), (10, 10), (8, 12), (12, 8), (40, 40)]:
            c = rng.random((n, m))
            r1, c1 = lap_host(c)
            r2, c2 = scipy_lap(c)
            assert abs(c[r1, c1].sum() - c[r2, c2].sum()) < 1e-9

    def test_dispatcher_small(self):
        rng = np.random.default_rng(1)
        c = rng.random((7, 7))
        r1, c1 = linear_sum_assignment(c)
        r2, c2 = scipy_lap(c)
        assert abs(c[r1, c1].sum() - c[r2, c2].sum()) < 1e-9

    def test_exact_lap_small_exact_at_any_scale(self):
        """Regression: eigsort cost matrices shrink to ~1e-4 magnitude at
        large subsamples, below the auction's epsilon floor (it returned
        wrong permutations on near-identical meshes).  The enumeration solver
        must be exact regardless of cost magnitude."""
        from pyfocusr_tpu.ops.assignment import exact_lap_small

        rng = np.random.default_rng(3)
        for k in (2, 4, 6, 8):
            for scale in (1.0, 1e-4, 1e-6):
                c = (rng.random((k, k)) * scale).astype(np.float32)
                got = np.asarray(exact_lap_small(jnp.asarray(c)))
                assert len(set(got.tolist())) == k
                r2, c2 = scipy_lap(c.astype(np.float64))
                assert (
                    abs(c[np.arange(k), got].sum() - c[r2, c2].sum())
                    <= 1e-6 * scale * k
                )
        with pytest.raises(ValueError, match="k=9"):
            exact_lap_small(jnp.zeros((9, 9)))

    @pytest.mark.slow
    def test_auction_near_optimal(self):
        rng = np.random.default_rng(2)
        n = 300
        c = rng.random((n, n)).astype(np.float32)
        a = np.asarray(auction_lap(jnp.asarray(c)))
        assert len(set(a.tolist())) == n  # valid permutation
        r2, c2 = scipy_lap(c)
        gap = c[np.arange(n), a].sum() - c[r2, c2].sum()
        assert gap < 0.05 * abs(c[r2, c2].sum()) + 1e-6


class TestDeviceJV:
    """Exact on-device Jonker-Volgenant (ops/assignment.sinkhorn_jv_lap) —
    the solver behind 'hungarian' correspondences inside the jit pipeline
    (reference solves these with scipy JV on host, ``focusr.py:340-349``)."""

    def test_exact_on_random_and_geometric(self):
        from pyfocusr_tpu.ops.assignment import sinkhorn_jv_lap
        from scipy.spatial.distance import cdist

        rng = np.random.default_rng(0)
        cases = []
        for n in (30, 120, 400):
            cases.append(rng.uniform(0, 1, (n, n)).astype(np.float32))
        a = rng.normal(size=(300, 3))
        # Contested geometric costs (two near-identical clouds) — the case
        # that stalled the round-1 auction solver.
        cases.append(cdist(a, a + 0.005 * rng.normal(size=a.shape)).astype(np.float32))
        for C in cases:
            n = C.shape[0]
            got = np.asarray(sinkhorn_jv_lap(jnp.asarray(C)))
            assert len(np.unique(got)) == n  # permutation
            r2, c2 = scipy_lap(C.astype(np.float64))
            obj = C[np.arange(n), got].astype(np.float64).sum()
            ref = C[r2, c2].astype(np.float64).sum()
            assert obj <= ref * (1 + 1e-5) + 1e-6, (n, obj, ref)

    def test_warm_start_matches_cold(self):
        from pyfocusr_tpu.ops.assignment import sinkhorn_jv_lap

        rng = np.random.default_rng(5)
        C = rng.uniform(0, 1, (600, 600)).astype(np.float32)
        warm = np.asarray(sinkhorn_jv_lap(jnp.asarray(C), warm_start=True))
        cold = np.asarray(sinkhorn_jv_lap(jnp.asarray(C), warm_start=False))
        obj_w = C[np.arange(600), warm].astype(np.float64).sum()
        obj_c = C[np.arange(600), cold].astype(np.float64).sum()
        assert abs(obj_w - obj_c) <= 1e-4 * max(obj_w, obj_c)


def test_sinkhorn_jv_rejects_rectangular():
    from pyfocusr_tpu.ops.assignment import sinkhorn_jv_lap

    with pytest.raises(ValueError, match="square"):
        sinkhorn_jv_lap(jnp.zeros((4, 6)))


def test_knn_routing_k_over_128():
    """Large k (200) has no special route: knn_query returns cKDTree's
    neighbors."""
    rng = np.random.default_rng(9)
    r = rng.random((1000, 3)).astype(np.float32)
    q = rng.random((10, 3)).astype(np.float32)
    d, i = knn_query(jnp.asarray(r), jnp.asarray(q), k=200)
    d_ref, i_ref = KDTree(r).query(q, k=200)
    np.testing.assert_array_equal(np.asarray(i), i_ref)
    np.testing.assert_allclose(np.asarray(d), d_ref, atol=1e-5)


def test_knn_query_fewer_refs_than_k_matches_kdtree():
    """nr < k: missing neighbors report index == nr and inf distance —
    cKDTree's missing-neighbor sentinel — instead of a padded-row index."""
    import jax.numpy as jnp
    from scipy.spatial import KDTree

    from pyfocusr_tpu.ops.knn import knn_query

    rng = np.random.default_rng(0)
    ref = rng.normal(size=(2, 3)).astype(np.float32)
    query = rng.normal(size=(5, 3)).astype(np.float32)
    d, i = knn_query(jnp.asarray(ref), jnp.asarray(query), k=3)
    dk, ik = KDTree(ref).query(query, k=3)
    np.testing.assert_allclose(np.asarray(d)[:, :2], dk[:, :2], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(i), ik)  # missing -> index 2
    assert np.all(np.isinf(np.asarray(d)[:, 2]))


def test_exact_lap_small_rejects_rectangular():
    from pyfocusr_tpu.ops.assignment import exact_lap_small

    with pytest.raises(ValueError, match="square"):
        exact_lap_small(jnp.zeros((4, 6), jnp.float32))


def test_auction_lap_handles_1x1():
    from pyfocusr_tpu.ops.assignment import auction_lap

    out = np.asarray(auction_lap(jnp.zeros((1, 1), jnp.float32)))
    np.testing.assert_array_equal(out, [0])
