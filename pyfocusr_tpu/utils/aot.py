"""Ahead-of-time export of compiled registration programs (serving path).

The reference is a research library with no deployment story; production
serving of an accelerator registration pipeline needs two things the
interactive path lacks:

1. **No first-contact compile.**  A cold ``register_pair`` compile takes
   minutes.  The persistent compilation cache
   (``utils/compile_cache.py``) covers repeat runs on one machine;
   `export_registration` goes further and serializes the fully-lowered
   program (StableHLO via ``jax.export``) to an artifact that any worker
   with the same topology can load and run without tracing or re-lowering
   Python at all.
2. **Pinned shapes.**  Serving fleets register cohorts of a known size
   class; the artifact pins (n_target, n_source, degrees, ...) and the
   config, making the served program immutable and auditable.

Usage:
    path = export_registration(cfg, tg_example, sg_example, "reg_15k.jaxexp")
    runner = load_registration(path)
    res = runner(tg, sg, key)          # same output dict as register_pair

The CLI ``warmup`` command uses the same machinery to pre-populate the
compile cache for a list of mesh sizes (see cli.py).

.. warning:: **Trust boundary.**  The executable format
   (``export_registration_exec`` / ``load_registration_exec``,
   conventionally ``.jaxexec``) is a *pickle* payload: loading one
   executes arbitrary code embedded in the file.  Only load ``.jaxexec``
   artifacts you exported yourself or received over a channel you trust
   end-to-end (same fleet, authenticated storage).  A magic header is
   checked before unpickling so a swapped/corrupt file fails fast, but
   the header is no integrity protection — an attacker who can write the
   artifact can write the header.  For artifacts crossing a trust
   boundary use the **StableHLO format** (``export_registration`` /
   ``load_registration``): it deserializes declarative IR, not pickle.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp

__all__ = [
    "export_registration",
    "load_registration",
    "export_registration_exec",
    "load_registration_exec",
    "validate_artifact",
]


def _meta_path(path: str) -> str:
    return path + ".meta.json"


# Leading bytes of every executable-format artifact, written before the
# pickle payload.  Checked BEFORE unpickling so a file that is not a
# pyfocusr_tpu executable artifact (wrong path, truncated copy, StableHLO
# artifact passed to the wrong loader) fails fast with a clear error
# instead of feeding arbitrary bytes to pickle.  NOT an integrity or
# authenticity mechanism — see the module-level trust-boundary warning.
_EXEC_MAGIC = b"#pyfocusr_tpu.jaxexec.v1\n"
# v2: same pickle payload, zlib-compressed after the header (a raw 15k
# executable serializes to ~100+ MB; device binaries compress well).
# Loaders accept both.
_EXEC_MAGIC_Z = b"#pyfocusr_tpu.jaxexec.v2z\n"


def _shape_sig(g) -> dict:
    return {
        "points": list(g.points.shape),
        "neighbors": list(g.neighbors.shape),
        "overflow": list(g.overflow.shape),
        "node_features": list(g.node_features.shape),
    }

_REGISTERED = False


def _ensure_serializable():
    """Register GraphArrays for jax.export pytree serialization (idempotent;
    its aux data is None so the payload is empty)."""
    global _REGISTERED
    if _REGISTERED:
        return
    from ..pipeline import GraphArrays

    jax.export.register_pytree_node_serialization(
        GraphArrays,
        serialized_name="pyfocusr_tpu.GraphArrays",
        serialize_auxdata=lambda aux: b"",
        deserialize_auxdata=lambda blob: None,
    )
    _REGISTERED = True


def _specs_like(tree):
    return jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tree
    )


def _program_fingerprint(cfg) -> str:
    """Config fingerprint for AOT artifacts — the FULL config modulo
    ``landmark_weight`` only.  ``pipeline._cfg_fingerprint`` additionally
    normalizes the eig warm-start knobs, which is correct for PREPARED
    STATE (they don't change the prepared spectrum) but wrong here: they
    change the compiled ``_register_pair_jit`` program baked into the
    artifact (review finding r4), and the exported program also carries
    no landmarks, so landmark_weight is the one genuinely dead knob."""
    import dataclasses

    from ..pipeline import PipelineConfig

    default_w = PipelineConfig.__dataclass_fields__["landmark_weight"].default
    return repr(dataclasses.replace(cfg, landmark_weight=default_w))


def validate_artifact(path: str, cfg=None, target=None, source=None) -> None:
    """Validate an artifact's sidecar metadata against the given config /
    graph shapes (and, for executable-format sidecars, this host's device
    kind + jax version) WITHOUT touching the artifact bytes.  Raises
    ``ValueError`` on mismatch; sidecar-less artifacts skip validation.
    Shared by both loaders and by callers that hold a loaded runner and
    only need to re-check a new input (e.g. the CLI's per-source loop)."""
    mp = _meta_path(path)
    if not os.path.exists(mp):
        return
    with open(mp) as f:
        meta = json.load(f)
    if cfg is not None and meta.get("cfg_fingerprint") != _program_fingerprint(cfg):
        raise ValueError(
            f"AOT artifact {path} was exported under a different "
            "PipelineConfig; re-export (delete the artifact or pass a "
            "matching config)"
        )
    for name, g in (("target", target), ("source", source)):
        if g is not None and meta.get(name) != _shape_sig(g):
            raise ValueError(
                f"AOT artifact {path} was exported for {name} shapes "
                f"{meta.get(name)} but got {_shape_sig(g)}; re-export "
                "for this shape class"
            )
    if meta.get("format") == "executable":
        kind = jax.devices()[0].device_kind
        if meta.get("device_kind") not in (None, kind):
            raise ValueError(
                f"AOT executable {path} targets device kind "
                f"{meta.get('device_kind')!r} but this host has {kind!r}; "
                "re-export (executables are device-pinned — use the "
                "StableHLO format for portability)"
            )
        if meta.get("jax_version") not in (None, jax.__version__):
            raise ValueError(
                f"AOT executable {path} was serialized under jax "
                f"{meta.get('jax_version')} but this is {jax.__version__}; "
                "re-export"
            )


def _export_program(cfg, target_example, source_example):
    """The ``jax.export.Exported`` registration program behind
    :func:`export_registration`, before serialization (``exp.call`` runs
    it in this process)."""
    from ..pipeline import _register_pair_jit

    _ensure_serializable()
    fn = jax.jit(
        lambda tg, sg, key: _register_pair_jit(tg, sg, cfg, key)
    )
    return jax.export.export(fn)(
        _specs_like(target_example),
        _specs_like(source_example),
        jax.ShapeDtypeStruct((2,), jnp.uint32),
    )


def export_registration(cfg, target_example, source_example, path: str) -> str:
    """Serialize the fully-lowered ``register_pair`` program for the given
    config and example GraphArrays shapes to ``path``.

    ``target_example`` / ``source_example`` fix every static shape (vertex
    counts, ELL degree, overflow length, feature count); the exported
    program accepts any inputs of those exact shapes.  The artifact is
    platform-specific (exported for the current default backend).  Writing
    it needs the ``flatbuffers`` package (``jax.export`` serialization).

    Scale note: jax.export serializes ONE program, so this wraps the fused
    single-program pipeline.  Above ``pipeline._SPLIT_SPECTRA_N`` vertices
    the live ``register_pair`` instead hoists each eigensolve into its own
    program (measured 3.4x faster at 122k — pipeline.py split-spectra
    notes); exporting such shapes would permanently serve the slow fused
    variant, so it is rejected rather than silently degraded.
    """
    from ..pipeline import _SPLIT_SPECTRA_N, _check_padding_hazards

    n_max = max(target_example.n_points, source_example.n_points)
    if _SPLIT_SPECTRA_N > 0 and n_max >= _SPLIT_SPECTRA_N:
        raise ValueError(
            f"export_registration serializes the fused single-program "
            f"pipeline, which is ~3.4x slower than the split-spectra path "
            f"register_pair uses at {n_max} vertices (threshold "
            f"{_SPLIT_SPECTRA_N}); serve large pairs through register_pair "
            "with the persistent compilation cache instead"
        )

    # The example arrays are concrete, so the padding guards register_pair
    # runs pre-jit apply here too — an exported 'hungarian' program must
    # not silently serve corrupt assignments on padded graphs.
    _check_padding_hazards(target_example, source_example, cfg)
    exp = _export_program(cfg, target_example, source_example)
    blob = exp.serialize()
    # Atomic publish: a process killed mid-write must not leave a
    # truncated artifact at the serving path.
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    # Sidecar metadata: the artifact itself carries no record of the config
    # or shapes it was exported under; the sidecar lets load_registration
    # fail loudly instead of serving a stale program on mismatched inputs.
    meta = {
        "cfg_fingerprint": _program_fingerprint(cfg),
        "target": _shape_sig(target_example),
        "source": _shape_sig(source_example),
        "platform": jax.default_backend(),
    }
    tmpm = f"{_meta_path(path)}.tmp.{os.getpid()}"
    with open(tmpm, "w") as f:
        json.dump(meta, f)
    os.replace(tmpm, _meta_path(path))
    return path


def load_registration(path: str, cfg=None, target=None, source=None):
    """Load an exported registration program; returns
    ``runner(target, source, key) -> results dict`` (no tracing, no
    Python-level pipeline code on the serving path).

    With ``cfg`` / ``target`` / ``source`` given, validates them against
    the artifact's sidecar metadata (written by :func:`export_registration`)
    and raises ``ValueError`` on mismatch — a serving process must not
    silently run a program exported under a different config or shape
    class.  Sidecar-less artifacts (pre-metadata exports) skip validation."""
    _ensure_serializable()
    validate_artifact(path, cfg=cfg, target=target, source=source)
    if jax.default_backend() == "cpu":
        # XLA:CPU jaxlib hazard (bisected on this toolchain): executing a
        # DESERIALIZED exported program whose LAPACK custom calls (eigh /
        # svd lowerings) were never lowered in THIS process segfaults —
        # the FFI targets register lazily at lowering time, and a fresh
        # serving process that only deserializes never lowers them.
        # Priming one tiny eigh lowering (no compile, no execute)
        # registers the whole LAPACK family and makes cross-process
        # serving safe.  GPU backends register their solver targets at
        # plugin load and are unaffected.
        jax.jit(jnp.linalg.eigh).lower(jnp.eye(2, dtype=jnp.float32))
    with open(path, "rb") as f:
        exp = jax.export.deserialize(f.read())

    def runner(target, source, key):
        return exp.call(target, source, key)

    return runner


def export_registration_exec(cfg, target_example, source_example,
                             path: str) -> str:
    """Serialize the fully-COMPILED registration executable to ``path``
    (``jax.experimental.serialize_executable``) — the zero-compile serving
    format.

    Unlike :func:`export_registration` (StableHLO, portable across
    processes but re-COMPILED on every load), this pickles the XLA
    executable itself: a fresh process deserializes it and runs without
    compiling.  The artifact is pinned to the exact (device kind, jaxlib
    version); the sidecar records both and :func:`load_registration_exec`
    rejects mismatches.  Use this for same-fleet serving; use the
    StableHLO format for portability.
    """
    import pickle

    from jax.experimental import serialize_executable as _se

    from ..pipeline import (
        _SPLIT_SPECTRA_N,
        _check_padding_hazards,
        _register_pair_jit,
    )

    n_max = max(target_example.n_points, source_example.n_points)
    if _SPLIT_SPECTRA_N > 0 and n_max >= _SPLIT_SPECTRA_N:
        raise ValueError(
            "export_registration_exec serializes the fused single-program "
            f"pipeline; at {n_max} vertices the split-spectra path is "
            "~3.4x faster — serve large pairs through register_pair"
        )
    _check_padding_hazards(target_example, source_example, cfg)
    fn = jax.jit(lambda tg, sg, key: _register_pair_jit(tg, sg, cfg, key))
    # Commit the example inputs to ONE device: on multi-device hosts an
    # uncommitted input can lower as replicated-across-all-devices, and
    # the serialized executable would then demand N-sharded inputs at
    # serve time ("expected args ... to have 8 shards").
    dev = jax.devices()[0]
    # Compile FRESH, never from the persistent cache: serializing an
    # executable that was itself loaded from the compilation cache
    # produces a payload that fails at execute time on this toolchain
    # ("Buffer Definition Event: Function ... not found" on XLA:CPU).
    # Export is a rare offline step; paying the full compile here keeps
    # the artifact deterministic.
    prev_cache = jax.config.jax_enable_compilation_cache
    try:
        jax.config.update("jax_enable_compilation_cache", False)
        compiled = fn.lower(
            jax.device_put(target_example, dev),
            jax.device_put(source_example, dev),
            jax.device_put(jax.random.PRNGKey(0), dev),
        ).compile()
    finally:
        jax.config.update("jax_enable_compilation_cache", prev_cache)
    payload, in_tree, out_tree = _se.serialize(compiled)
    blob = pickle.dumps((payload, in_tree, out_tree))
    # zlib level 1: measured the sweet spot for device binaries — higher
    # levels cost multiples of compression time for a few more percent.
    import zlib

    zblob = zlib.compress(blob, 1)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_EXEC_MAGIC_Z)
        f.write(zblob)
    os.replace(tmp, path)
    meta = {
        "format": "executable",
        "cfg_fingerprint": _program_fingerprint(cfg),
        "target": _shape_sig(target_example),
        "source": _shape_sig(source_example),
        "platform": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "jax_version": jax.__version__,
    }
    tmpm = f"{_meta_path(path)}.tmp.{os.getpid()}"
    with open(tmpm, "w") as f:
        json.dump(meta, f)
    os.replace(tmpm, _meta_path(path))
    return path


def load_registration_exec(path: str, cfg=None, target=None, source=None):
    """Load an executable-format artifact (see
    :func:`export_registration_exec`); returns the same
    ``runner(target, source, key)`` contract as :func:`load_registration`.
    Validates the sidecar (config fingerprint, shapes, device kind, jax
    version) when present.

    .. warning:: the artifact body is **pickle** — loading it executes
       code from the file.  Only load artifacts from trusted sources
       (see the module-level trust-boundary warning); the magic-header
       check below rejects non-artifact files before unpickling but does
       not authenticate the producer.  Use the StableHLO format
       (:func:`load_registration`) across trust boundaries.

    XLA:CPU caveat (upstream, this toolchain): a process that mixes a
    DESERIALIZED executable with persistent-cache-loaded executables can
    fail at execute time ("Buffer Definition Event: Function ... not
    found") — CPU serving processes should disable the compilation cache
    (``jax.config.update('jax_enable_compilation_cache', False)``)."""
    import pickle

    from jax.experimental import serialize_executable as _se

    validate_artifact(path, cfg=cfg, target=target, source=source)
    with open(path, "rb") as f:
        head = f.read(max(len(_EXEC_MAGIC), len(_EXEC_MAGIC_Z)))
        if head.startswith(_EXEC_MAGIC_Z):
            import zlib

            blob = zlib.decompress(head[len(_EXEC_MAGIC_Z):] + f.read())
        elif head.startswith(_EXEC_MAGIC):
            blob = head[len(_EXEC_MAGIC):] + f.read()
        else:
            raise ValueError(
                f"{path} is not a pyfocusr_tpu executable artifact "
                f"(missing {_EXEC_MAGIC!r} header): wrong file, a "
                "truncated copy, a StableHLO artifact (use "
                "load_registration), or an artifact from a pre-header "
                "release — re-export with export_registration_exec"
            )
        payload, in_tree, out_tree = pickle.loads(blob)
    dev = jax.devices()[0]
    # Pin execution to ONE device: the default rebinds the executable to
    # every local device ("expected args ... to have 8 shards" on
    # multi-device hosts), but the program was compiled single-device.
    loaded = _se.deserialize_and_load(
        payload, in_tree, out_tree, execution_devices=[dev]
    )

    def runner(target, source, key):
        # Committed single-device inputs, matching the export-side pin.
        return loaded(
            jax.device_put(target, dev),
            jax.device_put(source, dev),
            jax.device_put(key, dev),
        )

    return runner
