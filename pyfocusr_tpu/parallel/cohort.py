"""Cohort data-parallelism: batched template-to-subject registration sharded
over a device mesh.

The reference has no distributed code at all (SURVEY §2: "no DP/TP/PP/...");
its scalability story is subsampling.  This framework's first-class
distributed feature is *cohort* parallelism: register
one template mesh against N subject meshes — the statistical-shape-model
workload hinted at by ``target_eigenmap_as_reference`` (reference
``focusr.py:32-35``) and the dead all-pairs harness (``pyfocusr/test.py``) —
with one (or more) pairs per device.

Design: subjects are padded to a common static shape (pipeline.GraphArrays
valid_mask machinery), stacked on a leading cohort axis, and each device
registers its shard of that axis one subject after another inside a
``shard_map`` over the 'cohort' mesh axis.  Collectives: the cohort-mean
template update is a ``psum`` across devices.  Everything per-pair stays on
one device (SURVEY §5.8).
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..mesh import TriMesh
from ..ops.icp import icp
from ..ops.knn import nn_query
from ..pipeline import (
    GraphArrays,
    PipelineConfig,
    mesh_to_graph_arrays,
    prepare_source,
    register_pair,
    register_pair_prepared_source,
    source_spectrum_hoistable,
)

try:  # JAX >= 0.4.35 public API, else experimental
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

__all__ = [
    "stack_graph_arrays",
    "pad_cohort",
    "check_cohort_config",
    "register_cohort",
    "iterate_template",
    "build_ssm_template",
    "cohort_shape_modes",
    "ssm_project",
    "ssm_sample",
    "fit_subject_to_ssm",
    "cohort_mean_shape",
    "all_pairs_surface_errors",
]


def pad_cohort(meshes: Sequence[TriMesh]) -> List[GraphArrays]:
    """Pad a list of meshes to common (n_points, degree) for stacking."""
    from ..mesh import build_topology

    topos = [
        build_topology(np.asarray(m.triangles), m.n_points) for m in meshes
    ]
    n_pad = max(m.n_points for m in meshes)
    d_pad = max(t.max_degree for t in topos)
    c_pad = max(max(t.n_components, 1) for t in topos)
    e_pad = max(t.overflow_edges.shape[0] for t in topos)
    return [
        mesh_to_graph_arrays(
            m,
            pad_n_points=n_pad,
            pad_degree=d_pad,
            pad_components=c_pad,
            pad_overflow=e_pad,
            topology=t,  # reuse the pad-sizing pass (built once per mesh)
        )
        for m, t in zip(meshes, topos)
    ]


def stack_graph_arrays(graphs: Sequence[GraphArrays]) -> GraphArrays:
    """Stack equal-shape GraphArrays along a new leading cohort axis.

    Patch-dense plans (``patch_plan``) are kept only when every graph
    carries one AND their shapes agree (same topology class — e.g. one
    mesh jittered N ways); otherwise they are stripped: plan shapes are
    topology-dependent, so equal-vertex-count meshes with different
    triangulations would stack ragged."""
    import dataclasses as _dc

    plans = [g.patch_plan for g in graphs]
    keep = all(p is not None for p in plans) and len(
        {tuple(sorted((k, v.shape) for k, v in p.items())) for p in plans}
    ) == 1
    if not keep:
        graphs = [
            _dc.replace(g, patch_plan=None) if g.patch_plan is not None else g
            for g in graphs
        ]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *graphs)


def _batched_register(targets, template, cfg, keys, prep=None):
    """register_pair for each subject of the cohort axis, one after another
    (``lax.map``); the template (and its prepared spectrum, when hoisted)
    is shared by all of them.

    Not vmapped: a vmapped registration compiles to a different program
    for each batch size, and the last-bit differences between those
    programs come out as different correspondences — the CPD keeps every
    low-rank Gaussian mode, as cycpd does, and the tail modes sit at the
    f32 noise floor.  (Measured on XLA:CPU, 8 subjects of 642 vertices:
    vmapped over 2 per device against 8 on one device, eigenvectors and
    eigsort equal bit for bit, CPD-moved spectral coordinates apart by
    up to 1e-2, 2.6% of correspondences different.)  One per-subject program
    gives the same registrations on any number of devices."""
    if prep is None:
        fn = lambda tk: register_pair(tk[0], template, cfg, tk[1])
    else:
        fn = lambda tk: register_pair_prepared_source(
            prep, tk[0], template, cfg, tk[1]
        )
    return jax.lax.map(fn, (targets, keys))


def check_cohort_config(
    meshes_min_points: int,
    cfg: PipelineConfig,
    padded_size: int | None = None,
) -> None:
    """Padded-cohort hazards, checked pre-jit (the per-pair guards in
    ``pipeline._check_padding_hazards`` cannot run under vmap/shard_map
    tracers):

    1. subsample sizes must not exceed the smallest real vertex count, or
       padding rows leak into the eigsort/CPD subsamples
       (pipeline._rand_idxs has static sample sizes);
    2. 'hungarian' correspondences are one-to-one over ALL rows, so any
       padding (``padded_size`` > smallest real count) would let padding
       rows steal assignments — rejected outright.
    """
    knobs = ["n_coords_spectral_ordering", "n_coords_spectral_registration"]
    padded = padded_size is not None and padded_size > meshes_min_points
    if cfg.icp_register_first and padded:
        # The ICP landmark draw has the same static-sample-size padding
        # hazard; on UNPADDED graphs an oversized value just clamps to n.
        knobs.append("icp_n_landmarks")
    for name in knobs:
        if getattr(cfg, name) > meshes_min_points:
            raise ValueError(
                f"{name}={getattr(cfg, name)} exceeds the smallest cohort "
                f"mesh size {meshes_min_points}; padding rows would leak "
                "into subsamples. Lower it to at most the smallest real "
                "vertex count."
            )
    use_hungarian = (
        cfg.initial_correspondence_type == "hungarian"
        or cfg.final_correspondence_type == "hungarian"
    )
    if use_hungarian and padded_size is not None and padded_size > meshes_min_points:
        raise ValueError(
            "'hungarian' correspondences need unpadded equal-size graphs: "
            f"the cohort is padded to {padded_size} rows but the smallest "
            f"mesh has {meshes_min_points} real vertices, so padding rows "
            "would participate in the one-to-one assignment. Use "
            "correspondence type 'kd' for padded cohorts."
        )


def register_cohort(
    template: GraphArrays,
    targets: GraphArrays,  # stacked, leading cohort axis (global batch)
    cfg: PipelineConfig,
    key: jax.Array,
    device_mesh: Mesh | None = None,
    prepared_template: bool | None = None,
):
    """Register the template (as source) to every target in the cohort.

    With a device mesh, the cohort axis is sharded over the 'cohort' mesh
    axis via shard_map and the cohort-mean template update is computed with a
    cross-device psum.  Returns (per-pair results pytree, mean_shape [N, 3]).

    The per-pair direction matches the SSM workflow the reference documents
    at ``focusr.py:32-35``: the template is the *source*, each cohort subject
    the *target*, so ``weighted_points`` live in template vertex order and can
    be averaged across the cohort directly.

    ``prepared_template`` hoists the template's eigensolve out of the
    per-pair fan-out (``pipeline.prepare_source``): it runs ONCE and the
    spectrum is shared by every subject instead of being recomputed per
    pair.  Default (None) enables the hoist whenever the config
    permits it (``pipeline.source_spectrum_hoistable`` — always true for
    rigid/absent ICP); passing True forces it (raising on non-hoistable
    configs), False disables it.
    """
    batch = jax.tree.leaves(targets)[0].shape[0]
    # One host transfer for the whole batch (a per-subject float() loop
    # would be B blocking device-to-host copies).
    min_real = int(np.min(np.sum(np.asarray(targets.valid_mask), axis=1)))
    min_real = min(min_real, int(np.sum(np.asarray(template.valid_mask))))
    # 'hungarian' padding hazard: padding on EITHER side of a pair lets
    # dead rows steal one-to-one assignments, so check the larger of the
    # template's and the targets' padded sizes.
    check_cohort_config(
        min_real,
        cfg,
        padded_size=max(
            int(template.valid_mask.shape[0]),
            int(targets.valid_mask.shape[1]),
        ),
    )
    keys = jax.random.split(key, batch)

    if prepared_template is None:
        prepared_template = source_spectrum_hoistable(cfg)
    prep = (
        prepare_source(template, cfg, jax.random.fold_in(key, batch))
        if prepared_template
        else None
    )

    if device_mesh is None:
        results = _batched_register(targets, template, cfg, keys, prep)
        mean_shape = jnp.mean(results["weighted_points"], axis=0)
        return results, mean_shape

    n_dev = device_mesh.devices.size
    if batch % n_dev != 0:
        raise ValueError(
            f"cohort size {batch} must be divisible by device count {n_dev}"
        )

    in_specs = (
        jax.tree.map(lambda _: P("cohort"), targets),
        jax.tree.map(lambda _: P(), template),
        P("cohort"),
        jax.tree.map(lambda _: P(), prep),
    )
    out_specs = (
        jax.tree.map(lambda _: P("cohort"), jax.eval_shape(
            lambda t, k: _batched_register(t, template, cfg, k, prep),
            targets, keys,
        )),
        P(),
    )

    def shard_fn(tgt_shard, tmpl, key_shard, prep_arg):
        res = _batched_register(tgt_shard, tmpl, cfg, key_shard, prep_arg)
        local_sum = jnp.sum(res["weighted_points"], axis=0)
        total = jax.lax.psum(local_sum, axis_name="cohort")
        return res, total / batch

    fn = shard_map(
        shard_fn,
        mesh=device_mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)(targets, template, keys, prep)


def iterate_template(
    template: GraphArrays,
    targets: GraphArrays,  # stacked, leading cohort axis
    cfg: PipelineConfig,
    key: jax.Array,
    n_iterations: int = 3,
    device_mesh: Mesh | None = None,
    tolerance: float = 0.0,
    procrustes: bool = True,
    checkpoint_dir: str | None = None,
):
    """Groupwise template iteration — the standard SSM loop.

    Each round registers the current template to every cohort subject
    (``register_cohort``: one sharded fan-out + one cross-device ``psum``) and
    moves the template's vertices to the cohort-mean corresponding locations.
    The template TOPOLOGY is fixed; only its geometry evolves, so every
    iteration reuses the same compiled executable (static shapes).

    ``procrustes=True`` (default) rigidly aligns each round's mean shape
    back onto the PREVIOUS template pose (closed-form Kabsch on the 1:1
    vertex correspondence, rotation+translation, no scale) before applying
    it.  Without this, per-round re-registration lets a global pose drift
    accumulate in the template, and downstream SSM mode variances mix pose
    with shape (the round-1 ROADMAP caveat).  With it, mode variances are
    invariant to global rotations injected into the subjects
    (tests/test_cohort.py).

    This realizes the workflow the reference only gestures at
    (``focusr.py:32-35``: template eigenmaps as the cohort reference) but
    never implements — its scalability story stops at one pair at a time.

    Returns ``(template, results, motions)``: the converged template
    GraphArrays, the FINAL round's per-pair results pytree, and the mean
    per-vertex template motion (same units as the points) per iteration —
    a monotone-decreasing motion trace is the convergence certificate.
    Stops early once motion < ``tolerance`` (if nonzero).
    """
    import dataclasses as _dc

    from ..ops.icp import apply_rigid, umeyama

    n_valid = jnp.maximum(jnp.sum(template.valid_mask), 1.0)
    motions: List[float] = []
    results = None
    for _ in range(int(n_iterations)):
        key, sub = jax.random.split(key)
        results, mean_shape = register_cohort(
            template, targets, cfg, sub, device_mesh
        )
        if procrustes:
            s_, R_, t_ = umeyama(
                mean_shape, template.points, with_scale=False,
                weights=template.valid_mask,
            )
            mean_shape = apply_rigid(mean_shape, s_, R_, t_)
        new_pts = jnp.where(
            template.valid_mask[:, None] > 0, mean_shape, template.points
        )
        motion = float(
            jnp.sum(
                jnp.linalg.norm(new_pts - template.points, axis=1)
                * template.valid_mask
            )
            / n_valid
        )
        template = _dc.replace(template, points=new_pts)
        motions.append(motion)
        if checkpoint_dir:
            # Per-round snapshot: long cohort runs on preemptible fleets can
            # resume by seeding ``template`` from the latest round file.
            import os

            import numpy as _np

            os.makedirs(checkpoint_dir, exist_ok=True)
            _np.savez(
                os.path.join(
                    checkpoint_dir, f"template_round_{len(motions):03d}.npz"
                ),
                points=_np.asarray(template.points),
                motion=_np.asarray(motions),
            )
        if tolerance and motion < tolerance:
            break
    return template, results, motions


def build_ssm_template(
    meshes: Sequence[TriMesh],
    cfg: PipelineConfig,
    key: jax.Array,
    n_iterations: int = 3,
    template_index: int = 0,
    device_mesh: Mesh | None = None,
    tolerance: float = 0.0,
    procrustes: bool = True,
):
    """End-to-end SSM template construction from raw meshes.

    Pads + stacks the cohort, seeds the template from
    ``meshes[template_index]``, runs ``iterate_template``, and returns
    ``(template_mesh, results, motions)`` where ``template_mesh`` is a
    TriMesh on the seed subject's topology with the converged mean-shape
    geometry.  The seed subject stays in the cohort (it is a subject too;
    the template drifts toward the true mean regardless of the seed).
    """
    meshes = list(meshes)
    graphs = pad_cohort(meshes)
    template = graphs[template_index]
    targets = stack_graph_arrays(graphs)
    template, results, motions = iterate_template(
        template, targets, cfg, key,
        n_iterations=n_iterations,
        device_mesh=device_mesh,
        tolerance=tolerance,
        procrustes=procrustes,
    )
    n_real = meshes[template_index].n_points
    template_mesh = TriMesh(
        template.points[:n_real], meshes[template_index].triangles
    )
    return template_mesh, results, motions


def cohort_shape_modes(corresponded_points, n_modes: int | None = None):
    """Statistical shape model from corresponded cohorts: PCA of shapes.

    ``corresponded_points``: [B, N, 3] per-subject point sets in TEMPLATE
    vertex order — exactly the stacked ``results['weighted_points']`` of
    ``register_cohort``/``iterate_template`` (every subject's corresponding
    locations for each template vertex, so rows are comparable across
    subjects).  This is the deliverable of the SSM workflow the reference
    gestures at with ``target_eigenmap_as_reference`` (``focusr.py:32-35``)
    but never implements.

    Returns ``(mean_shape [N, 3], modes [m, N, 3], variances [m])``:
    ``modes[i]`` is the i-th unit principal displacement field and
    ``variances[i]`` its variance across the cohort (descending); a shape is
    synthesized as ``mean + sum_i b_i * sqrt(variances[i]) * modes[i]``.
    At most B-1 modes are nonzero; ``n_modes`` truncates further.

    Accelerator shape: the PCA runs through the [B, B] Gram matrix of centered
    flattened shapes (B = cohort size << 3N), so device work is one
    [B, 3N] x [3N, B] matmul + a tiny eigh — no [3N, 3N] covariance ever
    materializes.
    """
    P = jnp.asarray(corresponded_points, jnp.float32)  # [B, N, 3]
    B, N, D = P.shape
    flat = P.reshape(B, N * D)
    mean = jnp.mean(flat, axis=0)
    C = flat - mean[None, :]
    gram = jnp.dot(C, C.T, precision=jax.lax.Precision.HIGHEST) / max(B - 1, 1)
    evals, evecs = jnp.linalg.eigh(gram)  # ascending
    m = min(n_modes, B) if n_modes is not None else B
    idx = jnp.arange(B - 1, B - 1 - m, -1)  # descending variance
    variances = jnp.maximum(evals[idx], 0.0)
    # modes = C^T y / ||C^T y||.  Columns whose variance is at the f32
    # noise floor must be ZEROED, not normalized: their raw vector is
    # eps-level noise inside span(C), and normalizing it yields a garbage
    # direction NON-orthogonal to the real modes — ssm_project would then
    # double-count energy and mis-reconstruct (caught by the in-sample
    # exact-reconstruction test).  Threshold relative to the largest mode.
    raw = jnp.dot(C.T, evecs[:, idx], precision=jax.lax.Precision.HIGHEST)
    norms = jnp.linalg.norm(raw, axis=0, keepdims=True)
    valid = variances > 1e-6 * jnp.maximum(variances[0], 1e-30)
    modes = jnp.where(
        valid[None, :], raw / jnp.maximum(norms, 1e-20), 0.0
    )
    return (
        mean.reshape(N, D),
        modes.T.reshape(m, N, D),
        variances,
    )


def ssm_project(points, mean, modes, variances=None, n_modes: int | None = None):
    """Project a CORRESPONDED shape onto an existing SSM mode basis.

    Completes the SSM workflow ``cohort_shape_modes`` starts (VERDICT r2
    task 9): fit a held-out subject to the model instead of rebuilding it.

    ``points``: f32 [N, 3] subject locations in TEMPLATE vertex order —
    i.e. a row of ``results['weighted_points']`` from a registration of the
    template to the subject.  ``mean`` [N, 3], ``modes`` [m, N, 3]
    (unit-norm principal displacement fields), ``variances`` [m] — exactly
    ``cohort_shape_modes``'s outputs.

    Returns ``(coeffs [m'], reconstruction [N, 3], residual_rms)``:
    ``coeffs[i] = <modes[i], points - mean>`` — raw displacement amplitude
    along mode i when ``variances`` is None, or divided by
    ``sqrt(variances[i])`` (conventional standard-deviation units, the
    form ``ssm_sample`` consumes) when ``variances`` is given.
    ``reconstruction = mean`` plus the modes at the projected amplitudes —
    the model's best rank-m' approximation of the subject — and
    ``residual_rms`` the per-vertex RMS of what the model cannot
    represent.  ``n_modes`` truncates the basis.
    """
    P = jnp.asarray(points, jnp.float32)
    mean = jnp.asarray(mean, jnp.float32)
    modes = jnp.asarray(modes, jnp.float32)
    if n_modes is not None:
        modes = modes[:n_modes]
    m = modes.shape[0]
    N, D = mean.shape
    x = (P - mean).reshape(N * D)
    B = modes.reshape(m, N * D)
    coeffs = jnp.dot(B, x, precision=jax.lax.Precision.HIGHEST)  # [m]
    recon = mean + jnp.tensordot(coeffs, modes, axes=1)
    if variances is not None:
        # Return standard-deviation units — the convention ``ssm_sample``
        # consumes, so project->sample round-trips without manual scaling.
        sig = jnp.sqrt(jnp.maximum(jnp.asarray(variances, jnp.float32), 0.0))
        coeffs = coeffs / jnp.maximum(sig[:m], 1e-30)
    residual_rms = jnp.sqrt(
        jnp.mean(jnp.sum((P - recon) ** 2, axis=1))
    )
    return coeffs, recon, residual_rms


def ssm_sample(
    mean,
    modes,
    variances,
    b=None,
    key=None,
    n_samples: int = 1,
    clip_std: float = 3.0,
):
    """Synthesize shapes from the SSM — the generative direction that
    completes the workflow (fit ``cohort_shape_modes`` -> project
    ``ssm_project`` -> sample here).

    A shape is ``mean + sum_i b_i * sqrt(variances[i]) * modes[i]`` with
    ``b`` in standard-deviation units (the convention stated in
    ``cohort_shape_modes``'s docstring).  Either pass explicit coefficients
    ``b`` ([m] for one shape, [S, m] for a batch) — e.g. ``b=[2, 0, ...]``
    to visualize mode 1 at +2 sigma — or a PRNG ``key`` to draw
    ``n_samples`` standard-normal coefficient vectors, clipped to
    ``+-clip_std`` so samples stay in the plausible shape space.

    Returns f32 [N, 3] when ``b`` is 1-D, else [S, N, 3].
    """
    mean = jnp.asarray(mean, jnp.float32)
    modes = jnp.asarray(modes, jnp.float32)
    sig = jnp.sqrt(jnp.maximum(jnp.asarray(variances, jnp.float32), 0.0))
    m = modes.shape[0]
    if (b is None) == (key is None):
        raise ValueError("pass exactly one of b= (coefficients) or key=")
    if b is None:
        b = jnp.clip(
            jax.random.normal(key, (n_samples, m), dtype=jnp.float32),
            -clip_std,
            clip_std,
        )
    b = jnp.asarray(b, jnp.float32)
    squeeze = b.ndim == 1
    b2 = b[None, :] if squeeze else b
    if b2.shape[1] != m:
        raise ValueError(
            f"coefficient length {b2.shape[1]} != number of modes {m}"
        )
    shapes = mean[None] + jnp.tensordot(b2 * sig[None, :], modes, axes=1)
    return shapes[0] if squeeze else shapes


def fit_subject_to_ssm(
    subject_mesh: TriMesh,
    template_mesh: TriMesh,
    mean,
    modes,
    cfg: PipelineConfig,
    key,
    n_modes: int | None = None,
):
    """Out-of-sample SSM fit of a RAW mesh: register the template to the
    subject (template as the moving/source side, exactly as
    ``iterate_template`` registers the cohort), take the template-vertex-
    order corresponded locations, and project them onto the mode basis.

    Returns ``(coeffs, reconstruction [N, 3], residual_rms)`` with N the
    template's vertex count.
    """
    tg = mesh_to_graph_arrays(subject_mesh)
    sg = mesh_to_graph_arrays(template_mesh)
    res = register_pair(tg, sg, cfg, key)
    corresponded = res["weighted_points"][: template_mesh.n_points]
    return ssm_project(corresponded, mean, modes, n_modes=n_modes)


def cohort_mean_shape(template: TriMesh, weighted_points_mean) -> TriMesh:
    """Mean-shape mesh on the template topology (average-mesh construction,
    the cohort generalization of reference ``get_average_shape``,
    ``focusr.py:433-453``)."""
    return template.with_points(weighted_points_mean)


def all_pairs_surface_errors(meshes: Sequence[TriMesh], icp_mode: str = "rigid"):
    """All-pairs ICP + symmetric surface-distance matrix over a cohort.

    Resurrects the reference's dead-code capability hint
    (``pyfocusr/test.py:1-30``: ``get_all_pairwise_surface_errors`` referenced
    undefined helpers and was never importable) as a real, tested utility.
    Returns an [n, n] matrix of mean symmetric nearest-neighbor distances
    after rigid ICP alignment of each ordered pair.
    """
    n = len(meshes)
    out = np.zeros((n, n), np.float64)
    pts = [jnp.asarray(m.points, jnp.float32) for m in meshes]
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            _, moved = icp(pts[i], pts[j], mode=icp_mode, max_iterations=50)
            d_ij, _ = nn_query(pts[j], moved)
            d_ji, _ = nn_query(moved, pts[j])
            out[i, j] = float((jnp.mean(d_ij) + jnp.mean(d_ji)) / 2.0)
    return out
