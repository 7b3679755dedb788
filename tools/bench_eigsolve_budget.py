#!/usr/bin/env python
"""Solve-level time budget of one wide-Chebyshev eigensolve (VERDICT r4 #1).

The round-4 roofline proved the FILTER STEP runs at 99.9% of HBM peak
(94.6 us/step, 165 steps/solve ~ 15.6 ms), yet `eigensolve_k6_both` is
~185 ms — so ~80% of the eigensolve lives in phases never itemized at
the min-of-reps standard.  This probe times each phase of ONE cold
15k-mesh solve on the current backend.

Methodology (dispatch-latency-proof): every eager dispatch pays a fixed
per-call cost, so each phase is repeated R times
INSIDE one jitted ``lax.fori_loop`` with a serializing carry (iteration
i's input depends on iteration i-1's output, so XLA can neither hoist
nor overlap the bodies), the program is timed min-over-reps with a
discarded warm-up, and the per-application time is (loop_time -
empty_loop_time) / R.  The full solve is timed as the pipeline runs it:
one jit.

Phases:
  filter_step    one Chebyshev recurrence step on the [N, 128] block
  project_out    null-space projection of the block
  gram           G = Y^T Y            ([N,128] -> [128,128], HIGHEST)
  eigh128        jnp.linalg.eigh of a [128,128] Gram
  rotate         Y @ U                ([N,128] x [128,128])
  svqb_rr        the full orthonormalize+Rayleigh-Ritz composite
  quad_form      cancellation-free final eigenvalue quotients
  solve          jit(_spectrum) — the real thing

Prints one JSON dict; the phase-sum model vs the measured solve exposes
any unattributed dispatch/loop overhead.
"""

import json
import os
import sys
import time
from functools import partial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax
import jax.numpy as jnp

from pyfocusr_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

REPS = int(os.environ.get("REPS", "10"))


def timed(fn, *args, reps=REPS):
    out = fn(*args)
    jax.block_until_ready(out)  # warm-up: compile must not vote
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    from pyfocusr_tpu.mesh import load_mesh
    from pyfocusr_tpu.ops import graph_ops
    from pyfocusr_tpu.ops.eigen import _project_out
    from pyfocusr_tpu.pipeline import (
        PipelineConfig,
        _spectrum,
        mesh_to_graph_arrays,
    )

    mesh_path = sys.argv[1] if len(sys.argv) > 1 else (
        "/root/reference/data/target_mesh_15k.vtk"
    )
    cfg = PipelineConfig()
    g = mesh_to_graph_arrays(load_mesh(mesh_path))
    n = g.points.shape[0]
    b = cfg.eig_wide_block
    deg = cfg.eig_wide_degree
    chunks = cfg.eig_wide_chunks
    res = {"n": n, "block": b, "degree": deg, "chunks": chunks,
           "backend": jax.default_backend(),
           "device": jax.devices()[0].device_kind, "reps": REPS}

    # Rebuild the exact operator the pipeline builds (same math as
    # _spectrum's wide path).
    mask = g.valid_mask
    w = graph_ops.edge_weights(g.points, g.neighbors, g.nbr_mask)
    ov, ov_w = g.overflow, graph_ops.overflow_weights(g.points, g.overflow)
    d = graph_ops.degree_vector(w, ov, ov_w)
    gv = jnp.where(mask > 0, (d + graph_ops.DEGREE_EPS) ** -1, 1.0)
    s = jnp.sqrt(gv)
    sw = s[:, None] * w * s[g.neighbors]
    sd = s * s * d * mask
    ws = graph_ops.spmv(g.neighbors, w, s, ov, ov_w)
    lam_max = float(jnp.max(mask * s * (s * d + ws))) * 1.005
    null_basis = g.null_indicators * (1.0 / s)[:, None] * mask[:, None]
    v0 = null_basis / jnp.maximum(
        jnp.linalg.norm(null_basis, axis=0, keepdims=True), 1e-30
    )

    key = jax.random.PRNGKey(0)
    Y = jax.random.normal(key, (n, b), jnp.float32)
    prec = jax.lax.Precision.HIGHEST
    has_ov = ov is not None and ov.shape[0] > 0

    def op_block(T, c, e):
        alpha = 2.0 / e
        y = (alpha * (sd - c * mask))[:, None] * T - jnp.einsum(
            "nd,ndc->nc", alpha * sw, T[g.neighbors],
            precision=prec,
        )
        if has_ov:
            osw = ov_w * s[ov[:, 0]] * s[ov[:, 1]]
            y = y.at[ov[:, 0]].add(-(alpha * osw)[:, None] * T[ov[:, 1]])
        return y

    c0 = (lam_max + lam_max * 1e-3) / 2.0
    e0 = (lam_max - lam_max * 1e-3) / 2.0

    def loop(body, x, r):
        """Serialized r-fold application: iteration i consumes i-1's
        output, so the bodies cannot be hoisted or overlapped."""
        return jax.lax.fori_loop(0, r, lambda i, t: body(t), x)

    # Per-phase in-program repetition counts, sized so loop time ~ tens
    # of ms (well above the dispatch floor).
    R_BIG = 200     # [N,128]-shaped ops
    R_EIGH = 100

    probes = {}

    @jax.jit
    def empty_big(T):
        return loop(lambda t: t, Y, R_BIG)

    base_big = timed(empty_big, Y)

    @jax.jit
    def p_filter(T):
        return loop(lambda t: op_block(t, c0, e0), T, R_BIG)

    probes["filter_step"] = (timed(p_filter, Y) - base_big) / R_BIG

    @jax.jit
    def p_proj(T):
        return loop(lambda t: _project_out(v0, t), T, R_BIG)

    probes["project_out"] = (timed(p_proj, Y) - base_big) / R_BIG

    @jax.jit
    def p_gram_rotate(T):
        # gram + rotate fused per iteration (keeps [N,128] shape for the
        # carry); reported as the pair, also split below via rotate-only.
        def body(t):
            G = jnp.matmul(t.T, t, precision=prec)
            return jnp.matmul(t, G, precision=prec) * 1e-3

        return loop(body, T, R_BIG)

    gram_rotate = (timed(p_gram_rotate, Y) - base_big) / R_BIG

    @jax.jit
    def p_rotate(T, U):
        return loop(lambda t: jnp.matmul(t, U, precision=prec) * 0.999, T,
                    R_BIG)

    U0 = jnp.eye(b, dtype=jnp.float32)
    probes["rotate"] = (timed(p_rotate, Y, U0) - base_big) / R_BIG
    probes["gram"] = gram_rotate - probes["rotate"]

    G0 = jnp.matmul(Y.T, Y, precision=prec)

    @jax.jit
    def empty_eigh(G):
        return loop(lambda x: x, G0, R_EIGH)

    base_eigh = timed(empty_eigh, G0)

    @jax.jit
    def p_eigh(G):
        def body(x):
            e, U = jnp.linalg.eigh(G0 + 1e-12 * x)
            return U

        return loop(body, G, R_EIGH)

    probes["eigh128"] = (timed(p_eigh, G0) - base_eigh) / R_EIGH

    # The svqb_rr composite as written in ops/eigen.py.
    def svqb_rr(T, rk):
        nrm = jnp.linalg.norm(T, axis=0, keepdims=True)
        T = T / jnp.maximum(nrm, 1e-30)
        G = jnp.matmul(T.T, T, precision=prec)
        e, U = jnp.linalg.eigh(G)
        floor = e[-1] * 1e-10
        valid = e > floor
        inv = jnp.where(valid, 1.0 / jnp.sqrt(jnp.maximum(e, floor)), 0.0)
        Q = jnp.matmul(T, U * inv[None, :], precision=prec)
        noise = jax.random.normal(rk, Q.shape, dtype=Q.dtype)
        noise = noise * mask[:, None]
        noise = _project_out(v0, noise)
        noise = noise / jnp.maximum(
            jnp.linalg.norm(noise, axis=0, keepdims=True), 1e-30
        )
        Q = jnp.where(valid[None, :], Q, noise)
        AQ = op_block(Q, c0, e0)
        H = jnp.matmul(Q.T, AQ, precision=prec)
        H = 0.5 * (H + H.T)
        theta, S = jnp.linalg.eigh(H)
        return jnp.matmul(Q, S, precision=prec)

    R_SVQB = 20

    @jax.jit
    def empty_svqb(T):
        return loop(lambda t: t, T, R_SVQB)

    @jax.jit
    def p_svqb(T):
        return loop(lambda t: svqb_rr(t, jax.random.PRNGKey(1)), T, R_SVQB)

    probes["svqb_rr"] = (timed(p_svqb, Y) - timed(empty_svqb, Y)) / R_SVQB

    R_Q = 50

    @jax.jit
    def p_quad(V):
        def body(v):
            q = graph_ops.sym_laplacian_quad_form(
                g.neighbors, w, s, v * mask[:, None], ov, ov_w
            )
            return v * (1.0 + 0.0 * q[0])

        return loop(body, V, R_Q)

    V6 = Y[:, :6]

    @jax.jit
    def empty_q(V):
        return loop(lambda v: v, V, R_Q)

    probes["quad_form"] = (timed(p_quad, V6) - timed(empty_q, V6)) / R_Q

    @partial(jax.jit, static_argnames=())
    def full_solve(seed):
        lams, vecs, _ = _spectrum(g, 6, jax.random.PRNGKey(0) + seed, cfg)
        return lams

    probes["solve"] = timed(full_solve, jnp.uint32(0))

    for k_, v_ in probes.items():
        res[f"{k_}_ms"] = v_ * 1e3

    # Budget model of one cold solve from the measured phases:
    # chunks x (deg filter steps + project_out + svqb_rr) + final
    # matvec + quad_form.
    model = (
        chunks * (deg * probes["filter_step"] + probes["project_out"]
                  + probes["svqb_rr"])
        + probes["filter_step"]
        + probes["quad_form"]
    )
    res["model_ms"] = model * 1e3
    res["unattributed_ms"] = (probes["solve"] - model) * 1e3
    res["svqb_rr_total_ms"] = chunks * probes["svqb_rr"] * 1e3
    res["filter_total_ms"] = chunks * deg * probes["filter_step"] * 1e3
    res["eigh_total_ms"] = 2 * chunks * probes["eigh128"] * 1e3
    print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                      for k, v in res.items()}))


if __name__ == "__main__":
    main()
