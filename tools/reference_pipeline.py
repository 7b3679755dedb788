"""Executable transcription of the reference pyfocusr pipeline (numpy/scipy).

This is the GOLDEN ORACLE for end-to-end parity testing (SURVEY §4, VERDICT
round-1 task #1): a faithful, *seeded* re-statement of the reference's math
using the same scipy primitives the reference calls (ARPACK shift-invert
``eigs``, ``KDTree``, ``linear_sum_assignment``, ``wasserstein_distance``,
sparse SpMV), so the JAX framework can be gated against what the reference
actually computes — not just against per-formula unit oracles.

It is NOT part of the production framework (which is JAX —
``pyfocusr_tpu``); it exists only to *generate* goldens
(tools/make_reference_golden.py -> tests/goldens/*.npz) and is vectorized
numpy rather than the reference's per-element VTK loops.

Reference behavior transcribed (file:line in /root/reference):
  adjacency w=1/dist per directed cell edge      pyfocusr/graph.py:148-178
  degree / D^-1 / L = D^-1 (D - W)               pyfocusr/graph.py:216-226
  recursive_eig (ARPACK sigma=1e-10, grow-k)     pyfocusr/graph.py:357-389
  eigvec min-max normalization to [-0.5, 0.5]    pyfocusr/graph.py:254-257
  mean_filter_graph                              pyfocusr/graph.py:320-354
  eigsort costs + assignment + flip/permute      pyfocusr/eigsort.py:54-233
  spectral coord assembly (± weighting)          pyfocusr/focusr.py:459-508
  CPD wrapper (X=source fixed, Y=target moving)  pyfocusr/focusr.py:297-334
  cycpd low-rank deformable / affine EM          (Myronenko & Song 2010; the
                                                  algorithm cycpd implements)
  kd / hungarian correspondences                 pyfocusr/focusr.py:340-366
  smoothed correspondences                       pyfocusr/focusr.py:368-399
  weighted k=3 IDW final locations               pyfocusr/focusr.py:401-426
  ICP pre-alignment (rigid/similarity)           pyfocusr/vtk_functions.py:12-29
"""

from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.optimize import linear_sum_assignment
from scipy.sparse.linalg import eigs
from scipy.spatial import KDTree
from scipy.spatial.distance import cdist
from scipy.stats import wasserstein_distance

MIN_EIG_VAL = 1e-10


# ---------------------------------------------------------------------------
# Graph layer (reference graph.py)
# ---------------------------------------------------------------------------

def reference_adjacency(
    points: np.ndarray, triangles: np.ndarray, adj_coords: np.ndarray = None
) -> sparse.csr_matrix:
    """W[i, j] = 1/||x_i - x_j|| for every directed edge of every cell, in
    cell orientation (graph.py:148-178).  lil assignment is set-semantics, so
    duplicate directed edges (none on a manifold, but possible in soup) are
    deduplicated rather than summed.

    ``adj_coords``: optional [N, 3+K] coordinates for the distance — xyz
    augmented with mean-range-scaled features when
    ``include_features_in_adj_matrix`` (graph.py:166-175)."""
    n = points.shape[0]
    x = points if adj_coords is None else adj_coords
    e = np.concatenate(
        [triangles[:, [0, 1]], triangles[:, [1, 2]], triangles[:, [2, 0]]]
    ).astype(np.int64)
    _, uniq = np.unique(e[:, 0] * n + e[:, 1], return_index=True)
    e = e[uniq]
    d = np.linalg.norm(x[e[:, 0]] - x[e[:, 1]], axis=1)
    return sparse.csr_matrix((1.0 / d, (e[:, 0], e[:, 1])), shape=(n, n))


def norm_node_features_ref(f, cap_std=3):
    """Reference feature normalization (graph.py:121-142): z-score with
    +-cap_std clamp, then 0-1 min-max."""
    f = np.asarray(f, np.float64)
    f = (f - f.mean()) / f.std()
    f = np.clip(f, -cap_std, cap_std)
    return (f - f.min()) / (f.max() - f.min())


def reference_g_vector(features, d, feature_weights, p_function="exp"):
    """Diagonal of the feature G matrix (graph.py:180-214): per-feature
    transform p in {exp, log, square, shift-to->=0}, each scaled by
    feature_weights[k,k] * ptp(degrees) / ptp(p(f)), averaged over features,
    times the inverse-degree diagonal.

    Deviation (shared with ops/graph_ops.g_vector, PARITY.md): graph.py:206
    calls np.ptp on a *sparse* degree matrix, which returns a sparse matrix
    (latent defect); the intended scalar ptp of the degree diagonal is used.
    """
    features = np.asarray(features, np.float64)
    k_features = features.shape[1]
    d_inv = (d + 1e-8) ** -1
    g = np.zeros_like(d)
    deg_ptp = np.ptp(d)
    for k in range(k_features):
        f = features[:, k]
        if p_function == "exp":
            gk = np.exp(f)
        elif p_function == "log":
            gk = np.log(f - f.min() + 1.0)
        elif p_function == "square":
            gk = f**2
        else:
            gk = f - f.min()
        g = g + gk * (feature_weights[k, k] * deg_ptp / np.ptp(gk))
    g = g / k_features
    return g * d_inv


def reference_laplacian(W: sparse.spmatrix, g_vec: np.ndarray = None):
    """L = G (D - W) (graph.py:216-226): G = D^-1 by default (with the
    reference's +1e-8 inverse-degree guard), or diag(g_vec) for the
    feature-weighted G (graph.py:180-214)."""
    d = np.asarray(W.sum(axis=1)).ravel()
    D = sparse.diags(d)
    if g_vec is None:
        g_vec = (d + 1e-8) ** -1
    return (sparse.diags(g_vec) @ (D - W)).tocsc(), d


def recursive_eig_ref(matrix, k, n_k_needed, k_buffer=1, sigma=1e-10, which="LM"):
    """ARPACK shift-invert about sigma=1e-10 with the reference's
    grow-k-and-retry contract (graph.py:357-389).  Returns the surviving
    (lambda > 1e-10) eigenpairs in ARPACK's output order (the reference does
    not re-sort; shift-invert returns them ascending in practice)."""
    vals, vecs = eigs(matrix, k=k, sigma=sigma, which=which, ncv=4 * k)
    if np.sum(np.real(vals) > MIN_EIG_VAL) < n_k_needed:
        return recursive_eig_ref(
            matrix, k + k_buffer + n_k_needed, n_k_needed, k_buffer, sigma, which
        )
    keep = np.where(np.real(vals) > MIN_EIG_VAL)[0]
    return np.real(vals[keep]), np.real(vecs[:, keep])


def graph_spectrum(
    points,
    triangles,
    n_spectral_features,
    features=None,
    include_features_in_adj=False,
    use_features_in_G=False,
    G_matrix_p_function="exp",
    feature_weights=None,
):
    """Full reference spectrum: W -> L -> recursive_eig -> [-0.5, 0.5]
    column normalization (graph.py:228-257), with the optional
    feature-weighted adjacency (graph.py:166-175) and G matrix
    (graph.py:180-214).

    ``features``: raw per-vertex features [N, K]; normalized here the way
    ``Graph.__init__`` does (z-score, clamp +-3, 0-1), then scaled by the
    mean xyz range for the adjacency augmentation (graph.py:114-119)."""
    adj_coords = None
    g_vec = None
    feats_n = None
    if features is not None and np.asarray(features).size:
        feats = np.atleast_2d(np.asarray(features, np.float64))
        if feats.shape[0] == len(points):
            feats = feats.T  # -> [K, N]
        feats_n = np.stack([norm_node_features_ref(f) for f in feats])  # [K, N]
        if feature_weights is None:
            feature_weights = np.eye(feats_n.shape[0])
    if feats_n is not None and include_features_in_adj:
        mean_range = np.mean(np.ptp(points, axis=0))
        adj_coords = np.concatenate(
            [np.asarray(points, np.float64), (feats_n * mean_range).T], axis=1
        )
    W = reference_adjacency(points, triangles, adj_coords)
    d = np.asarray(W.sum(axis=1)).ravel()
    if feats_n is not None and use_features_in_G:
        g_vec = reference_g_vector(
            feats_n.T, d, feature_weights, G_matrix_p_function
        )
    L, _ = reference_laplacian(W, g_vec)
    vals, vecs = recursive_eig_ref(
        L, k=n_spectral_features + 1, n_k_needed=n_spectral_features, k_buffer=1
    )
    vecs = (vecs - vecs.min(axis=0)) / np.ptp(vecs, axis=0) - 0.5
    return vals, vecs, W


def mean_filter_ref(W: sparse.spmatrix, values: np.ndarray, iterations: int):
    """out <- [diag(1/(1+d)) (W + I)] @ out, `iterations` times
    (graph.py:320-354)."""
    d = np.asarray(W.sum(axis=1)).ravel()
    A = sparse.diags(1.0 / (1.0 + d)) @ (W + sparse.eye(W.shape[0]))
    A = A.tocsr()
    out = np.asarray(values, np.float64)
    for _ in range(iterations):
        out = A @ out
    return out


# ---------------------------------------------------------------------------
# ICP (reference vtk_functions.py:12-29 — rigid / similarity, centroid start)
# ---------------------------------------------------------------------------

def icp_ref(source_pts, target_pts, mode="rigid", max_iterations=100):
    """Iterative closest point: centroid pre-match, NN correspondences,
    closed-form Umeyama update per iteration.  Returns (s, R, t) and the
    moved source points."""
    src = np.asarray(source_pts, np.float64)
    tgt = np.asarray(target_pts, np.float64)
    tree = KDTree(tgt)
    moved = src + (tgt.mean(axis=0) - src.mean(axis=0))  # StartByMatchingCentroids
    for _ in range(max_iterations):
        _, idx = tree.query(moved)
        corr = tgt[idx]
        mu_m, mu_c = moved.mean(axis=0), corr.mean(axis=0)
        A, B = moved - mu_m, corr - mu_c
        H = A.T @ B
        U, S, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        Dm = np.diag([1.0, 1.0, d])
        R = Vt.T @ Dm @ U.T
        s = (S * np.diag(Dm)).sum() / (A**2).sum() if mode == "similarity" else 1.0
        t = mu_c - s * (R @ mu_m)
        moved_new = s * (moved @ R.T) + t
        if np.abs(moved_new - moved).max() < 1e-9:
            moved = moved_new
            break
        moved = moved_new
    # Recover the net transform from the endpoints (robust to composition).
    mu_s, mu_e = src.mean(axis=0), moved.mean(axis=0)
    H = (src - mu_s).T @ (moved - mu_e)
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R_net = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    s_net = (
        (S * np.array([1.0, 1.0, d])).sum() / ((src - mu_s) ** 2).sum()
        if mode == "similarity"
        else 1.0
    )
    t_net = mu_e - s_net * (R_net @ mu_s)
    return (s_net, R_net, t_net), moved


# ---------------------------------------------------------------------------
# eigsort (reference eigsort.py)
# ---------------------------------------------------------------------------

def eigsort_ref(
    eig_vals_target,
    eig_vals_source,
    rand_vecs_target,
    rand_vecs_source,
    rand_pts_target_norm,
    rand_pts_source_norm,
    source_eig_vecs,
    target_eig_vecs=None,
    target_as_reference=True,
):
    """Eigsort: all three costs, Hungarian match, sign flip + column
    permutation of the FULL eigvecs of the non-reference side
    (eigsort.py:54-245).  Returns (sorted_vecs, Q_vec, matches, flip_mask)
    where sorted_vecs are the SOURCE eigvecs when target_as_reference
    (default) and the TARGET eigvecs otherwise (assignment on Q.T, target
    columns flipped/permuted — eigsort.py:75-78,100-122)."""
    k = len(eig_vals_target)
    eps = np.finfo(float).eps

    gap = (np.mean(np.diff(eig_vals_target)) + np.mean(np.diff(eig_vals_source))) / 2
    diff = eig_vals_target[:, None] - eig_vals_source[None, :]
    c_lambda = np.exp(diff**2 / (2 * gap**2))  # eigsort.py:142-160

    c_hist = np.zeros((k, k))
    c_hist_f = np.zeros((k, k))
    for i in range(k):  # eigsort.py:162-189
        lt = np.log(rand_vecs_target[:, i] + 0.5 + eps)
        for j in range(k):
            c_hist[i, j] = wasserstein_distance(
                lt, np.log(rand_vecs_source[:, j] + 0.5 + eps)
            )
            c_hist_f[i, j] = wasserstein_distance(
                lt, np.log(-rand_vecs_source[:, j] + 0.5 + eps)
            )

    _, nn = KDTree(rand_pts_source_norm).query(rand_pts_target_norm)
    g = rand_vecs_source[nn]  # eigsort.py:191-233
    n_t = rand_vecs_target.shape[0]
    c_spatial = np.zeros((k, k))
    c_spatial_f = np.zeros((k, k))
    for i in range(k):
        ti = rand_vecs_target[:, i]
        for j in range(k):
            c_spatial[i, j] = np.sqrt(np.sum((g[:, j] - ti) ** 2)) / n_t
            c_spatial_f[i, j] = np.sqrt(np.sum((-g[:, j] - ti) ** 2)) / n_t

    c = c_spatial * c_lambda * c_hist  # eigsort.py:54-122
    c_f = c_spatial_f * c_lambda * c_hist_f
    Q = np.minimum(c, c_f)
    S = c > c_f
    if target_as_reference:
        t_m, s_m = linear_sum_assignment(Q)
    else:
        s_m, t_m = linear_sum_assignment(Q.T)
    Q_vec = Q[t_m, s_m]
    flip = S[t_m, s_m]
    if target_as_reference:
        vecs = np.array(source_eig_vecs, np.float64, copy=True)
        for tm, sm, f in zip(t_m, s_m, flip):
            if f:
                vecs[:, sm] = -vecs[:, sm]
        vecs[:, t_m] = vecs[:, s_m]
    else:
        # Reverse mode mutates the TARGET eigvecs (eigsort.py:100-122):
        # flip matched flipped target columns, then reorder target columns
        # into the source's ordering.
        vecs = np.array(target_eig_vecs, np.float64, copy=True)
        for tm, sm, f in zip(t_m, s_m, flip):
            if f:
                vecs[:, tm] = -vecs[:, tm]
        vecs[:, s_m] = vecs[:, t_m]
    return vecs, Q_vec, (t_m, s_m), flip


# ---------------------------------------------------------------------------
# CPD — round-2 PAPER-DERIVED oracle (Myronenko & Song 2010 equations).
# SUPERSEDED for golden generation by tools/pycpd_oracle.py, a line-faithful
# transcription of the pycpd/cycpd code path the reference actually consumes;
# these helpers are kept so tests/test_cpd_oracles.py can quantify exactly
# where the paper derivation and the library code path differ (out-of-sample
# W projection, stopping criterion).
# ---------------------------------------------------------------------------

def cpd_deformable_lowrank(X, Y, alpha, beta, num_eig, max_iterations, tolerance):
    """Low-rank deformable CPD EM in f64.  X is the fixed cloud, Y moves.
    Returns (W_mat, sigma2, Y0) where the fitted transform of any points P is
    P + exp(-cdist(P, Y0)^2 / (2 beta^2)) @ W_mat (cycpd
    ``transform_point_cloud`` semantics, consumed at focusr.py:334)."""
    X = np.asarray(X, np.float64)
    Y0 = np.asarray(Y, np.float64)
    M, D = Y0.shape
    N = X.shape[0]
    G = np.exp(-cdist(Y0, Y0, "sqeuclidean") / (2 * beta**2))
    lam_all, Q_all = np.linalg.eigh(G)
    lam = lam_all[::-1][:num_eig].copy()
    Q = Q_all[:, ::-1][:, :num_eig].copy()
    inv_lam = 1.0 / lam

    W = np.zeros((M, D))
    sigma2 = cdist(X, Y0, "sqeuclidean").sum() / (D * M * N)
    q_prev = np.inf
    for _ in range(max_iterations):
        TY = Y0 + Q @ (lam[:, None] * (Q.T @ W))
        d2 = cdist(X, TY, "sqeuclidean").T  # [M, N]
        P = np.exp(-d2 / (2 * sigma2))
        den = np.maximum(P.sum(axis=0), np.finfo(float).tiny)
        P = P / den[None, :]
        P1 = P.sum(axis=1)
        PX = P @ X
        Np = P1.sum()
        a_s2 = alpha * sigma2
        F = PX - P1[:, None] * Y0
        dPQ = P1[:, None] * Q
        inner = a_s2 * np.diag(inv_lam) + Q.T @ dPQ
        W = (F - dPQ @ np.linalg.solve(inner, Q.T @ F)) / a_s2
        TY = Y0 + Q @ (lam[:, None] * (Q.T @ W))
        xPx = (P.sum(axis=0) * (X**2).sum(axis=1)).sum()
        yPy = (P1 * (TY**2).sum(axis=1)).sum()
        trPXY = (TY * PX).sum()
        q = (xPx - 2 * trPXY + yPy) / (2 * sigma2) + D * Np / 2 * np.log(sigma2)
        sigma2 = max((xPx - 2 * trPXY + yPy) / (Np * D), 1e-12)
        if abs(q_prev - q) <= tolerance:
            break
        q_prev = q
    # Project W to the low-rank subspace so out-of-sample transforms with the
    # FULL kernel reproduce the fitted low-rank displacement field.
    W_proj = Q @ (Q.T @ W)
    return W_proj, sigma2, Y0


def cpd_affine(X, Y, max_iterations, tolerance):
    """Affine CPD EM in f64 (cycpd affine, substituted for rigid at D > 3 —
    reference comment focusr.py:318).  Returns (B, t, sigma2)."""
    X = np.asarray(X, np.float64)
    Y0 = np.asarray(Y, np.float64)
    M, D = Y0.shape
    N = X.shape[0]
    B = np.eye(D)
    t = np.zeros(D)
    sigma2 = cdist(X, Y0, "sqeuclidean").sum() / (D * M * N)
    q_prev = np.inf
    for _ in range(max_iterations):
        TY = Y0 @ B.T + t
        d2 = cdist(X, TY, "sqeuclidean").T
        P = np.exp(-d2 / (2 * sigma2))
        den = np.maximum(P.sum(axis=0), np.finfo(float).tiny)
        P = P / den[None, :]
        P1 = P.sum(axis=1)
        Pt1 = P.sum(axis=0)
        Np = P1.sum()
        mu_x = (X * Pt1[:, None]).sum(axis=0) / Np
        mu_y = (P1[:, None] * Y0).sum(axis=0) / Np
        Xh = X - mu_x
        Yh = Y0 - mu_y
        A1 = Xh.T @ P.T @ Yh
        A2 = Yh.T @ (P1[:, None] * Yh)
        B = A1 @ np.linalg.inv(A2)
        t = mu_x - B @ mu_y
        TY = Y0 @ B.T + t
        xPx = (Pt1 * (Xh**2).sum(axis=1)).sum()
        trAB = np.trace(A1 @ B.T)
        q = (xPx - trAB) / (2 * sigma2) + D * Np / 2 * np.log(sigma2)
        sigma2 = max((xPx - trAB) / (Np * D), 1e-12)
        if abs(q_prev - q) <= tolerance:
            break
        q_prev = q
    return B, t, sigma2


# ---------------------------------------------------------------------------
# Full pipeline (reference focusr.py:23-570)
# ---------------------------------------------------------------------------

def run_reference_pipeline(
    target_points,
    target_triangles,
    source_points,
    source_triangles,
    *,
    icp_register_first=True,
    icp_registration_mode="rigid",
    n_spectral_features=3,
    n_extra_spectral=3,
    get_weighted_spectral_coords=False,
    rigid_before_non_rigid_reg=False,
    rigid_reg_max_iterations=100,
    rigid_tolerance=1e-8,
    non_rigid_max_iterations=300,
    non_rigid_tolerance=1e-8,
    non_rigid_alpha=0.01,
    non_rigid_beta=50.0,
    non_rigid_n_eigens=100,
    n_coords_spectral_ordering=10000,
    n_coords_spectral_registration=1000,
    initial_correspondence_type="hungarian",
    final_correspondence_type="kd",
    smooth_correspondences=True,
    graph_smoothing_iterations=600,
    projection_smooth_iterations=1,
    seed=0,
    icp_reg_target_to_source=False,
    target_eigenmap_as_reference=True,
    target_features=None,
    source_features=None,
    use_features_in_graph=False,
    include_features_in_adj_matrix=False,
    G_matrix_p_function="exp",
    feature_weights=None,
    use_features_as_coords=False,
    feature_smoothing_iterations=40,
):
    """The whole reference registration, seeded.  Returns a dict of every
    stage output the parity tests gate on."""
    rng = np.random.default_rng(seed)
    tgt_pts = np.asarray(target_points, np.float64)
    src_pts = np.asarray(source_points, np.float64)

    if icp_register_first:
        if icp_reg_target_to_source:
            # focusr.py:110-121: the TARGET mesh is ICP-moved into the
            # source frame.
            _, tgt_pts = icp_ref(tgt_pts, src_pts, mode=icp_registration_mode)
        else:
            _, src_pts = icp_ref(src_pts, tgt_pts, mode=icp_registration_mode)

    k_total = n_spectral_features + n_extra_spectral
    feat_kw = dict(
        include_features_in_adj=include_features_in_adj_matrix,
        use_features_in_G=use_features_in_graph,
        G_matrix_p_function=G_matrix_p_function,
        feature_weights=feature_weights,
    )
    vals_t, vecs_t, W_t = graph_spectrum(
        tgt_pts, target_triangles, k_total, features=target_features, **feat_kw
    )
    vals_s, vecs_s, W_s = graph_spectrum(
        src_pts, source_triangles, k_total, features=source_features, **feat_kw
    )
    vals_t, vecs_t = vals_t[:k_total], vecs_t[:, :k_total]
    vals_s, vecs_s = vals_s[:k_total], vecs_s[:, :k_total]

    # rand_idxs (graph.py:82,274-290): identity when n_rand >= n_points.
    def rand_idxs(n_points):
        if n_coords_spectral_ordering > n_points:
            return np.arange(n_points)
        return rng.choice(n_points, size=n_coords_spectral_ordering, replace=False)

    idx_t, idx_s = rand_idxs(len(tgt_pts)), rand_idxs(len(src_pts))

    def norm_sample(pts):  # graph.py:269-272
        return (pts - pts.min(axis=0)) / np.ptp(pts, axis=0)

    sorted_vecs, Q_vec, matches, flip = eigsort_ref(
        vals_t, vals_s, vecs_t[idx_t], vecs_s[idx_s],
        norm_sample(tgt_pts[idx_t]), norm_sample(src_pts[idx_s]), vecs_s,
        target_eig_vecs=vecs_t,
        target_as_reference=target_eigenmap_as_reference,
    )
    if target_eigenmap_as_reference:
        vecs_s_sorted, vecs_t_used = sorted_vecs, vecs_t
    else:
        # eigsort mutated the TARGET maps into the source's order
        # (eigsort.py:75-78,100-122); source maps stay as computed.
        vecs_s_sorted, vecs_t_used = vecs_s, sorted_vecs

    # Spectral coords (focusr.py:459-508).
    k_use = n_spectral_features
    src_coords = vecs_s_sorted[:, :k_use].copy()
    tgt_coords = vecs_t_used[:, :k_use].copy()
    if get_weighted_spectral_coords:
        lam_max = np.maximum(vals_s[:k_use], vals_t[:k_use])
        w = Q_vec[:k_use] * lam_max
        sigma = np.mean(w)
        wts = np.exp(-(w**2) / (2 * sigma**2))
        src_coords *= wts[None, :]
        tgt_coords *= wts[None, :]

    # Extra-feature appending (focusr.py:218-269): graph-smooth each
    # NORMALIZED node feature on its own mesh, min-max to [0, 1], rescale
    # by the scalar ptp of that mesh's (possibly weighted) spectral
    # coords, concatenate as extra registration dimensions.
    if use_features_as_coords and target_features is not None:

        def _extra_cols(coords, features, W):
            feats = np.atleast_2d(np.asarray(features, np.float64))  # [K, N]
            cols = []
            for f in feats:
                fn = norm_node_features_ref(f)
                sm = mean_filter_ref(W, fn, feature_smoothing_iterations)
                sm = sm - sm.min()
                sm = sm / sm.max()
                cols.append(np.ptp(coords) * sm)
            return np.stack(cols, axis=1)

        src_extra = _extra_cols(src_coords, source_features, W_s)
        tgt_extra = _extra_cols(tgt_coords, target_features, W_t)
        src_coords = np.concatenate([src_coords, src_extra], axis=1)
        tgt_coords = np.concatenate([tgt_coords, tgt_extra], axis=1)

    # CPD: TARGET cloud moves onto SOURCE (X = source fixed; focusr.py:297-334).
    def reg_sample(n_points):
        if n_coords_spectral_registration > n_points:
            return np.arange(n_points)
        return rng.choice(n_points, size=n_coords_spectral_registration, replace=False)

    # The CPD stage executes the pycpd/cycpd code path itself
    # (tools/pycpd_oracle.py — a line-faithful transcription of the library
    # the reference consumes at focusr.py:297-334), mirroring the
    # register-on-subsample + transform-full-cloud structure exactly.
    try:
        from tools.pycpd_oracle import affine_registration, deformable_registration
    except ImportError:  # run as a loose script from inside tools/
        from pycpd_oracle import affine_registration, deformable_registration

    if rigid_before_non_rigid_reg:
        reg = affine_registration(
            X=src_coords[reg_sample(len(src_pts))],
            Y=tgt_coords[reg_sample(len(tgt_pts))],
            max_iterations=rigid_reg_max_iterations,
            tolerance=rigid_tolerance,
        )
        reg.register()
        tgt_coords = reg.transform_point_cloud(tgt_coords)

    Xs = src_coords[reg_sample(len(src_pts))]
    Ys = tgt_coords[reg_sample(len(tgt_pts))]
    reg = deformable_registration(
        X=Xs, Y=Ys,
        num_eig=min(non_rigid_n_eigens, len(Ys)),
        max_iterations=non_rigid_max_iterations,
        tolerance=non_rigid_tolerance,
        alpha=non_rigid_alpha, beta=non_rigid_beta,
    )
    reg.register()
    tgt_coords = reg.transform_point_cloud(tgt_coords)

    # Initial correspondences (focusr.py:340-366).
    if initial_correspondence_type == "kd":
        _, init_corr = KDTree(tgt_coords).query(src_coords)
    else:
        dists = cdist(src_coords, tgt_coords)
        _, init_corr = linear_sum_assignment(dists)
    corr = init_corr

    smoothed_tgt = tgt_pts
    projected = src_pts
    if smooth_correspondences:  # focusr.py:368-399
        smoothed_tgt = mean_filter_ref(W_t, tgt_pts, graph_smoothing_iterations)
        projected = mean_filter_ref(
            W_s, smoothed_tgt[init_corr], projection_smooth_iterations
        )
        if final_correspondence_type == "kd":
            _, corr = KDTree(smoothed_tgt).query(projected)
        else:
            _, corr = linear_sum_assignment(cdist(projected, smoothed_tgt))

    # Weighted final locations (focusr.py:401-426).
    tree = KDTree(smoothed_tgt)
    dists, idxs = tree.query(projected, k=3)
    weighted = np.zeros_like(src_pts)
    for i in range(len(src_pts)):
        if 0 in dists[i]:
            weighted[i] = tgt_pts[idxs[i][np.where(dists[i] == 0)[0][0]]]
        else:
            wts = 1.0 / dists[i][:, None]
            weighted[i] = (tgt_pts[idxs[i]] * wts).sum(axis=0) / wts.sum()

    nearest = tgt_pts[corr]
    return {
        "source_points_icp": src_pts,
        "eig_vals_target": vals_t,
        "eig_vals_source": vals_s,
        "eig_vecs_target": vecs_t,
        "eig_vecs_source_sorted": vecs_s_sorted,
        "Q": Q_vec,
        "eigsort_matches_target": matches[0],
        "eigsort_matches_source": matches[1],
        "eigsort_flipped": flip,
        "spectral_coords_source": src_coords,
        "spectral_coords_target_moved": tgt_coords,
        "initial_correspondences": np.asarray(init_corr),
        "correspondences": np.asarray(corr),
        "smoothed_target_coords": smoothed_tgt,
        "source_projected_on_target": projected,
        "weighted_points": weighted,
        "nearest_points": nearest,
    }
