"""Symmetric and groupwise (all-pairs) registration.

The reference registers one ordered pair at a time (``Focusr.align_maps``,
reference ``focusr.py:514-570``) and its dead all-pairs harness
(``pyfocusr/test.py``) only compared surfaces, never correspondences.  This
module adds the two registration modes the ROADMAP lists beyond parity:

* ``register_pair_symmetric`` — run the fused pipeline in BOTH directions
  and fuse the forward map with the inverse of the backward map, yielding a
  correspondence that is consistent under swapping source and target, plus
  the forward/backward-consistency diagnostics that a one-directional run
  cannot provide.
* ``register_all_pairs`` — register every ordered pair of a cohort jointly
  (one fan-out over a 'pairs' axis, optionally sharded over a device mesh,
  the same SPMD pattern as ``cohort.register_cohort``), with transitive
  cycle-consistency metrics over vertex-index compositions.
* ``synchronize_correspondences`` — map synchronization: replace each direct
  map j->i with the consensus of all two-hop compositions j->k->i, the
  groupwise refinement that makes the pairwise maps mutually consistent.

Accelerator shape: the heavy work (B*(B-1) full registrations) is one
``lax.map`` over a stacked pairs axis — one compiled per-pair program, the
same on any number of devices (see ``cohort._batched_register``) —
optionally ``shard_map``-ed over a device mesh; the synchronization/consistency passes
are O(B^3) cheap gathers done in numpy on host (B is tens at most, N is
thousands: the gathers are microseconds and keeping them on host avoids
shipping [B^2, N] index tensors through jit).
"""

from __future__ import annotations

import functools
import itertools
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..mesh import TriMesh
from ..ops.knn import idw_pull_k3, nn_query
from ..pipeline import (
    SENTINEL,
    GraphArrays,
    PipelineConfig,
    _spectrum,
    register_pair,
)
from .cohort import check_cohort_config, pad_cohort, stack_graph_arrays

try:  # JAX >= 0.4.35 public API, else experimental
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

__all__ = [
    "register_pair_symmetric",
    "register_all_pairs",
    "synchronize_correspondences",
    "synchronize_spectral",
    "spectral_bases",
    "cycle_consistency_error",
]


# k=3 inverse-distance interpolation with exact-hit shortcut — the shared
# implementation of the reference's weighted final-location semantics
# (``focusr.py:401-426``), also used by the pipeline's final locations.
_idw_pull = idw_pull_k3


@jax.jit
def _symmetrize(
    fwd_points,  # [Ns, 3] forward map: per source vertex, location on target
    bwd_points,  # [Nt, 3] backward map: per target vertex, location on source
    source_points,  # [Ns, 3]
    target_points,  # [Nt, 3]
    source_mask,  # [Ns]
    target_mask,  # [Nt]
):
    """Fuse the forward map with the inverse of the backward map.

    The backward registration gives, for every TARGET vertex j, a location
    G(j) on the source surface.  Inverting it at source vertex i means
    interpolating the target vertices' ORIGINAL positions at the 3 nearest
    G(j) to x_i — a second, independent estimate F'(i) of where i lands on
    the target.  The symmetric map is the midpoint (F + F')/2 snapped back
    to a target vertex; |F - F'| is the forward/backward consistency
    diagnostic (0 for a perfectly involutive pair of maps).
    """
    inv = _idw_pull(bwd_points, target_mask, target_points, source_points)
    sym_points = 0.5 * (fwd_points + inv)
    tgt_q = jnp.where(target_mask[:, None] > 0, target_points, SENTINEL)
    _, sym_corr = nn_query(tgt_q, sym_points)
    fb_gap = jnp.linalg.norm(fwd_points - inv, axis=1)
    n_valid = jnp.maximum(jnp.sum(source_mask), 1.0)
    fb_consistency = jnp.sum(fb_gap * source_mask) / n_valid
    smask = source_mask[:, None]
    return (
        sym_points * smask,
        sym_corr * source_mask.astype(sym_corr.dtype),
        fb_consistency,
    )


def register_pair_symmetric(
    target: GraphArrays,
    source: GraphArrays,
    cfg: PipelineConfig,
    key: jax.Array,
):
    """Register source->target AND target->source, then fuse.

    Returns a dict:

    forward / backward    the two ``register_pair`` result pytrees
    sym_points            f32 [Ns, 3] symmetric landing estimate per source
                          vertex — the raw midpoint (F + F')/2 of the two
                          directions' estimates, which can lie slightly OFF
                          the target surface across thin/concave regions;
                          ``sym_correspondences`` is the on-surface (vertex-
                          snapped) version
    sym_correspondences   i32 [Ns] symmetric target index per source vertex
    target_sym_points / target_sym_correspondences   the mirror outputs per
                          target vertex (source index), from fusing the
                          backward map with the inverse forward map
    fb_consistency        mean |F - inv(G)| over real source vertices (mm) —
                          how far the two directions disagree
    cycle_error           mean |G(F_idx(i)) - x_i| over real source vertices
                          (mm) — the index-composition round trip

    A one-directional registration has no notion of these diagnostics; they
    are the acceptance metric for symmetric mode (tests/test_groupwise.py).
    """
    kf, kb = jax.random.split(key)
    fwd = register_pair(target, source, cfg, kf)
    bwd = register_pair(source, target, cfg, kb)
    sym_pts, sym_corr, fb = _symmetrize(
        fwd["weighted_points"], bwd["weighted_points"],
        source.points, target.points,
        source.valid_mask, target.valid_mask,
    )
    t_sym_pts, t_sym_corr, t_fb = _symmetrize(
        bwd["weighted_points"], fwd["weighted_points"],
        target.points, source.points,
        target.valid_mask, source.valid_mask,
    )
    # Index-composition cycle: i -> corr_fwd[i] (a target vertex) -> its
    # backward-mapped location on the source, vs x_i itself.
    cycle_gap = jnp.linalg.norm(
        bwd["weighted_points"][fwd["correspondences"]] - source.points, axis=1
    )
    n_valid = jnp.maximum(jnp.sum(source.valid_mask), 1.0)
    cycle_error = jnp.sum(cycle_gap * source.valid_mask) / n_valid
    return {
        "forward": fwd,
        "backward": bwd,
        "sym_points": sym_pts,
        "sym_correspondences": sym_corr,
        "target_sym_points": t_sym_pts,
        "target_sym_correspondences": t_sym_corr,
        "fb_consistency": fb,
        "cycle_error": cycle_error,
    }


def register_all_pairs(
    meshes: Sequence[TriMesh] | Sequence[GraphArrays],
    cfg: PipelineConfig,
    key: jax.Array,
    device_mesh: Mesh | None = None,
):
    """Jointly register every ORDERED pair of a cohort.

    All B*(B-1) registrations run as ONE program over a stacked pairs
    axis, one pair after another (optionally ``shard_map``-ed over the 'pairs' axis of
    ``device_mesh``; when the device count does not divide the pair count
    the batch is PADDED with dummy pairs — replicas of pair 0, dropped
    after the run — so every device stays active on any cohort size; the
    per-device waste is < 1 pair).  This is the groupwise generalization
    of the reference's one-pair to the all-pairs capability its dead
    ``test.py`` harness gestured at.

    Returns ``(corr, pair_index, results)``:

    corr        i32 [B, B, N_pad]; ``corr[j, i, v]`` = vertex of mesh i
                corresponding to vertex v of mesh j (mesh j registered as
                SOURCE onto target mesh i).  The diagonal is the identity.
    pair_index  list of (target_i, source_j) in stacking order
    results     the stacked per-pair result pytree (leading pairs axis)
    """
    meshes = list(meshes)
    if meshes and isinstance(meshes[0], TriMesh):
        graphs = pad_cohort(meshes)
    else:
        graphs = meshes
    B = len(graphs)
    if B < 2:
        raise ValueError("need at least two meshes for all-pairs registration")
    stacked = stack_graph_arrays(graphs)
    n_pad = int(stacked.valid_mask.shape[1])
    min_real = int(np.min(np.sum(np.asarray(stacked.valid_mask), axis=1)))
    check_cohort_config(min_real, cfg, padded_size=n_pad)

    pair_index = [(i, j) for i in range(B) for j in range(B) if i != j]
    ti = jnp.asarray([p[0] for p in pair_index], jnp.int32)
    si = jnp.asarray([p[1] for p in pair_index], jnp.int32)
    targets = jax.tree.map(lambda x: x[ti], stacked)
    sources = jax.tree.map(lambda x: x[si], stacked)
    keys = jax.random.split(key, len(pair_index))

    def _batched(tgts, srcs, ks):
        return jax.lax.map(
            lambda tsk: register_pair(tsk[0], tsk[1], cfg, tsk[2]),
            (tgts, srcs, ks),
        )

    if device_mesh is None:
        results = _batched(targets, sources, keys)
    else:
        if "pairs" not in device_mesh.axis_names:
            raise ValueError(
                "register_all_pairs shards over a 'pairs' mesh axis; got "
                f"axes {device_mesh.axis_names}"
            )
        # The sharding divides the PAIRS AXIS only — a multi-axis mesh's
        # other axes don't constrain the pair count.
        n_dev = device_mesh.shape["pairs"]
        n_pairs = len(pair_index)
        n_padded = -(-n_pairs // n_dev) * n_dev
        if n_padded != n_pairs:
            # Dummy pairs (replicas of pair 0) fill the last shard so the
            # axis divides evenly — all devices active on any cohort size
            # (6 pairs on 8 devices would leave 2 idle).  Dropped below
            # before results are returned.
            extra = n_padded - n_pairs
            pad = lambda a: jnp.concatenate(
                [a, jnp.repeat(a[:1], extra, axis=0)], axis=0
            )
            targets = jax.tree.map(pad, targets)
            sources = jax.tree.map(pad, sources)
            keys = pad(keys)
        spec = lambda tree: jax.tree.map(lambda _: P("pairs"), tree)
        # out_specs as a pytree PREFIX: every output leaf has a leading
        # pairs axis, so a single P('pairs') covers the whole tree (no
        # second abstract trace of the registration to enumerate leaves).
        fn = shard_map(
            _batched,
            mesh=device_mesh,
            in_specs=(spec(targets), spec(sources), P("pairs")),
            out_specs=P("pairs"),
            check_vma=False,
        )
        results = jax.jit(fn)(targets, sources, keys)
        if n_padded != n_pairs:
            results = jax.tree.map(lambda x: x[:n_pairs], results)

    corr = np.tile(np.arange(n_pad, dtype=np.int32), (B, B, 1))
    got = np.asarray(results["correspondences"])
    for p, (i, j) in enumerate(pair_index):
        corr[j, i] = got[p]
    return corr, pair_index, results


def cycle_consistency_error(
    corr: np.ndarray,  # [B, B, N] from register_all_pairs
    points: Sequence[np.ndarray],  # per-mesh [N_i, 3] real (unpadded) points
    n_real: Sequence[int],
) -> float:
    """Mean three-cycle transitivity error in mm.

    For every ordered triple (j, k, i): compose j->k->i and compare with the
    direct j->i, measuring the physical distance ON MESH i between the two
    landing vertices, averaged over real vertices and all triples.  Zero for
    perfectly transitive map sets; the groupwise acceptance metric.
    """
    B = corr.shape[0]
    if B < 3:
        # No 3-permutations exist; returning 0.0 would read as "perfectly
        # transitive" for a case the metric never measured.
        raise ValueError(
            f"cycle consistency needs >= 3 meshes, got B={B}; use the "
            "forward/backward-consistency diagnostics of "
            "register_pair_symmetric for pairs"
        )
    total, count = 0.0, 0
    for j, k, i in itertools.permutations(range(B), 3):
        v = np.arange(n_real[j])
        via = corr[k, i][corr[j, k][v]]
        direct = corr[j, i][v]
        d = np.linalg.norm(points[i][via] - points[i][direct], axis=1)
        total += float(d.mean())
        count += 1
    return total / max(count, 1)


def synchronize_correspondences(
    corr: np.ndarray,  # [B, B, N] from register_all_pairs
    points: Sequence[np.ndarray],  # per-mesh [N_i, 3] real points
    n_real: Sequence[int],
) -> np.ndarray:
    """Map synchronization: consensus-refine every pairwise map.

    Each direct map j->i is replaced by the per-vertex consensus of all
    two-hop compositions j->k->i, k != i (k == j gives the direct map
    itself — exactly once: k == i would re-yield it through the identity
    diagonal and silently double its consensus weight): the composed
    landing POSITIONS on mesh i are averaged over the B-1 contributing
    paths and snapped to the nearest mesh-i vertex.  This is Procrustes-
    style map synchronization specialized to vertex maps — transitive
    violations between independently-estimated pairwise maps shrink toward
    the consensus (tests assert the cycle error does not increase, and
    drops on noisy maps).

    Returns a corrected copy of ``corr`` (same shape; diagonal untouched).
    """
    B = corr.shape[0]
    out = corr.copy()
    for j in range(B):
        v = np.arange(n_real[j])
        for i in range(B):
            if i == j:
                continue
            acc = np.zeros((n_real[j], 3), np.float64)
            for k in range(B):
                if k == i:
                    # corr[i, i] is the identity: this path would re-yield
                    # the direct map and double-count it in the consensus.
                    continue
                if k == j:
                    landing = corr[j, i][v]
                else:
                    landing = corr[k, i][corr[j, k][v]]
                acc += points[i][landing]
            acc /= B - 1
            # Snap consensus positions back to mesh-i vertices (device KNN).
            _, snapped = nn_query(
                jnp.asarray(points[i], jnp.float32),
                jnp.asarray(acc, jnp.float32),
            )
            out[j, i, : n_real[j]] = np.asarray(snapped, np.int32)
    return out


@functools.partial(jax.jit, static_argnames=("k", "cfg"))
def _basis_spectrum(graph: GraphArrays, k: int, key, cfg: PipelineConfig):
    lams, vecs, _ = _spectrum(graph, k, key, cfg)
    return lams, vecs


def spectral_bases(
    graphs: Sequence[GraphArrays],
    cfg: PipelineConfig,
    key: jax.Array,
    n_basis: int = 12,
) -> List[np.ndarray]:
    """Per-mesh orthonormal low-frequency Laplacian bases.

    Each mesh's ``n_basis`` smallest nonzero eigenvectors (device
    eigensolve, the same ``_spectrum`` the pipeline uses) are restricted to
    real (unpadded) rows, re-orthonormalized by a host QR (the pipeline
    min-max normalizes columns, which breaks orthogonality), and row-scaled
    by sqrt(n_real) so descriptor rows are O(1) regardless of mesh size —
    the basis convention ``synchronize_spectral`` assumes.

    NEGATIVE RESULT (round 3, on the hardware the repo first targeted;
    not re-measured on a GPU): vmapping all B eigensolves into ONE
    program was SLOWER than B sequential dispatches.  Same root cause as
    the union/batched pair-spectra result (experiments.py): the
    [B, N, k]-batched ELL gather serialized worse than independent
    solves.  The sequential loop is deliberate.
    """
    keys = jax.random.split(key, max(len(graphs), 1))
    out = []
    for g, k_ in zip(graphs, keys):
        mask = np.asarray(g.valid_mask) > 0
        n = int(mask.sum())
        if n_basis >= n:
            raise ValueError(
                f"n_basis={n_basis} must be smaller than the real vertex "
                f"count {n}"
            )
        _, vecs = _basis_spectrum(g, n_basis, k_, cfg)
        v = np.asarray(vecs, np.float64)[mask]
        # The pipeline's min-max normalization adds a mesh-specific CONSTANT
        # component b_k*1 to every column; QR re-orthonormalizes but cannot
        # remove it (the span still contains a rotated slice of the constant
        # direction, degrading cross-mesh orthogonality of the functional
        # maps).  Center each column first.  Note this is the EUCLIDEAN
        # deconstant — random-walk modes are orthogonal to the constant in
        # the g-weighted inner product, not the Euclidean one, so centering
        # also strips each mode's (small, degree-variance-bound) Euclidean
        # constant component; the operation is the same deterministic
        # functional of the modes on every mesh and commutes with vertex
        # maps, which is what the synchronization model needs.
        v = v - v.mean(axis=0, keepdims=True)
        q, _ = np.linalg.qr(v)
        out.append(q * np.sqrt(n))
    return out


def synchronize_spectral(
    corr: np.ndarray,  # [B, B, N_pad] from register_all_pairs
    graphs: Sequence[GraphArrays],
    cfg: PipelineConfig,
    key: jax.Array,
    n_basis: int = 20,
    outlier_factor: float = 1.3,
    repair: str = "consensus",
):
    """Functional-map synchronization: detect inconsistent pairwise maps in
    a shared latent spectral basis, then repair ONLY those.

    Position consensus (``synchronize_correspondences``) averages two-hop
    landing positions into EVERY map — it repairs corruption but also
    perturbs already-good maps.  This is the spectral-domain alternative
    the ROADMAP lists: each vertex map j->i induces a functional map
    ``D[j,i] = pinv(Phi_j) @ P_ji @ Phi_i`` (the pullback expressed in the
    reduced Laplacian bases).  For a cycle-consistent map set these satisfy
    ``D[j,i] ~= Q_j @ Q_i.T`` with per-mesh orthogonal latent alignments
    Q_i, so the block matrix W with blocks D[j,i] is rank-``n_basis`` and
    its top eigenspace recovers every Q_i at once (synchronization by
    spectral relaxation; polar projection onto O(k) per block).  The
    Frobenius residual ``|D[j,i] - Q_j@Q_i.T| / sqrt(k)`` measures how far
    each input map sits from the global consensus; maps whose residual
    exceeds ``outlier_factor`` x the off-diagonal median are flagged
    (measured on the decimated bundled bone: a 50%-scrambled map scores
    ~0.73 vs a clean ceiling of ~0.53, a robust margin at factor 1.3) and
    repaired:

    * ``repair="consensus"`` (default): two-hop position consensus
      j->k->i routed ONLY through unflagged maps — the trusted-path
      version of ``synchronize_correspondences``.
    * ``repair="spectral"`` (also the fallback when no trusted two-hop
      path exists): nearest neighbor between the synchronized descriptor
      clouds ``Z_i = Phi_i @ Q_i`` — coarser (low-frequency basis) but
      needs no trusted path.

    Unflagged maps are returned bit-identical, so a clean map set is a
    fixed point.  Detection needs B >= 3 (with two meshes a transitivity
    violation cannot be attributed to either map); for B == 2 nothing is
    flagged.

    Accelerator shape: eigensolves and descriptor/consensus NN snaps run on
    device; only the [B*k, B*k] block eigenproblem (k, B tens at most)
    runs on host.

    Returns ``(out, info)``: ``out`` a corrected copy of ``corr`` and
    ``info`` a dict with ``Q`` [B, k, k] latent alignments, ``residuals``
    [B, B], ``flagged`` (boolean [B, B]), and ``bases`` (the synchronized
    descriptors ``Z_i``).
    """
    B = corr.shape[0]
    if len(graphs) != B:
        raise ValueError(f"corr is {B}x{B} but {len(graphs)} graphs given")
    if repair not in ("consensus", "spectral"):
        raise ValueError(f"unknown repair mode {repair!r}")
    masks = [np.asarray(g.valid_mask) > 0 for g in graphs]
    n_real = [int(m.sum()) for m in masks]
    # Padded index <-> real-row index maps.  NOTE: every producer
    # (mesh_to_graph_arrays / pad_cohort) pads TRAILING rows only, and the
    # [: n_real[j]] slices below assume exactly that — with trailing
    # padding both maps reduce to identities on the real prefix; they are
    # kept to make the padded-vs-real index spaces explicit at each
    # conversion site, not to support non-trailing padding.
    pad_of_real = [np.flatnonzero(m) for m in masks]
    real_of_pad = []
    for m in masks:
        r = np.zeros(m.shape[0], np.int64)
        r[m] = np.arange(int(m.sum()))
        real_of_pad.append(r)

    phis = spectral_bases(graphs, cfg, key, n_basis=n_basis)
    k = n_basis

    # Pairwise functional maps.  With the sqrt(n)-scaled orthonormal bases,
    # pinv(Phi_j) = Phi_j.T / n_j.
    D = np.zeros((B, B, k, k))
    for j in range(B):
        D[j, j] = np.eye(k)
        for i in range(B):
            if i == j:
                continue
            t = real_of_pad[i][corr[j, i][: n_real[j]]]
            D[j, i] = phis[j].T @ phis[i][t] / n_real[j]

    # Block synchronization: top-k eigenspace of the symmetrized block
    # matrix, polar-projected onto O(k) per mesh.
    W = D.transpose(0, 2, 1, 3).reshape(B * k, B * k)
    W = 0.5 * (W + W.T)
    _, evecs = np.linalg.eigh(W)
    U = evecs[:, -k:]
    Q = np.zeros((B, k, k))
    for i in range(B):
        a, _, bt = np.linalg.svd(U[i * k : (i + 1) * k])
        Q[i] = a @ bt

    residuals = np.zeros((B, B))
    for j in range(B):
        for i in range(B):
            if i != j:
                residuals[j, i] = np.linalg.norm(
                    D[j, i] - Q[j] @ Q[i].T
                ) / np.sqrt(k)

    off = ~np.eye(B, dtype=bool)
    flagged = np.zeros((B, B), dtype=bool)
    if B >= 3:
        thresh = outlier_factor * float(np.median(residuals[off]))
        flagged = off & (residuals > thresh)

    Z = [phis[i] @ Q[i] for i in range(B)]
    points = [np.asarray(g.points)[m] for g, m in zip(graphs, masks)]

    def _spectral_map(j, i):
        _, idx = nn_query(
            jnp.asarray(Z[i], jnp.float32), jnp.asarray(Z[j], jnp.float32)
        )
        return pad_of_real[i][np.asarray(idx, np.int64)].astype(np.int32)

    out = corr.copy()
    for j in range(B):
        for i in range(B):
            if not flagged[j, i]:
                continue
            trusted = [
                t
                for t in range(B)
                if t != j and t != i and not flagged[j, t] and not flagged[t, i]
            ]
            if repair == "spectral" or not trusted:
                out[j, i, : n_real[j]] = _spectral_map(j, i)
                continue
            acc = np.zeros((n_real[j], 3), np.float64)
            for t in trusted:
                landing = real_of_pad[i][
                    corr[t, i][corr[j, t][: n_real[j]]]
                ]
                acc += points[i][landing]
            acc /= len(trusted)
            _, snapped = nn_query(
                jnp.asarray(points[i], jnp.float32),
                jnp.asarray(acc, jnp.float32),
            )
            out[j, i, : n_real[j]] = pad_of_real[i][
                np.asarray(snapped, np.int64)
            ].astype(np.int32)
    return out, {"Q": Q, "residuals": residuals, "flagged": flagged, "bases": Z}
