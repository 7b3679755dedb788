"""Checkpoint / resume for registration results.

The reference has no checkpointing (SURVEY §5.4): all intermediate state
lives as ``Focusr`` attributes for post-hoc inspection.  Here every pipeline
stage is a pure function over array pytrees, so checkpointing is plain
serialization: ``save_results``/``load_results`` round-trip any result pytree
(the ``register_pair`` output dict, cohort results, or a hand-built dict of
``Focusr`` attributes) through a single ``.npz`` file.
"""

from __future__ import annotations

import os
import re
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "save_results",
    "load_results",
    "focusr_state_dict",
    "restore_focusr_state",
    "StageCheckpointer",
]


def save_results(path: str, tree) -> None:
    """Serialize an array pytree (dict/list/tuple nesting) to ``.npz``,
    self-describing via flattened pytree paths."""
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    keys = ["/".join(str(p) for p in kp) for kp, _ in paths]
    np.savez_compressed(
        path,
        __keys__=np.array(keys),
        **{f"leaf_{i}": np.asarray(v) for i, (_, v) in enumerate(paths)},
    )


def load_results(path: str) -> dict:
    """Load a checkpoint as a flat {path: array} dict (keys are the pytree
    paths written by :func:`save_results`)."""
    with np.load(path, allow_pickle=False) as data:
        keys = [str(k) for k in data["__keys__"]]
        return {
            k: data[f"leaf_{i}"] for i, k in enumerate(keys)
        }


class StageCheckpointer:
    """Fingerprinted stage-level checkpoint store for long multi-stage runs
    (e.g. multi-million-vertex multires registrations, where a process
    that dies mid-run would otherwise redo hundreds of seconds of
    finished stages on retry).

    Each stage is one ``<dir>/<stage>.npz`` holding an array pytree (via
    :func:`save_results`) plus the RUN fingerprint — a caller-computed hash
    of every input that determines the stage outputs.  ``get_or(stage, fn)``
    returns the saved pytree when the file exists AND its fingerprint
    matches; otherwise it computes ``fn()``, saves atomically (tmp +
    ``os.replace``, so a crash mid-write never leaves a half checkpoint),
    and returns the fresh value.  A mismatched fingerprint is simply a
    miss: the stale file is overwritten after recompute.

    Loaded leaves come back as device arrays; only dict-shaped pytrees (or
    single arrays) round-trip — enough for the pipeline's result dicts.
    """

    def __init__(self, directory: str, fingerprint: str):
        self.dir = directory
        self.fingerprint = str(fingerprint)
        os.makedirs(directory, exist_ok=True)
        self.loaded: list = []  # stage names served from disk (observability)

    def _path(self, stage: str) -> str:
        if not re.fullmatch(r"[A-Za-z0-9_.-]+", stage):
            raise ValueError(f"invalid checkpoint stage name {stage!r}")
        return os.path.join(self.dir, f"{stage}.npz")

    def load(self, stage: str):
        """The stage's saved pytree, or None on miss/fingerprint mismatch
        (or an unreadable/corrupt file — a torn download is a miss, not an
        error)."""
        path = self._path(stage)
        if not os.path.exists(path):
            return None
        try:
            flat = load_results(path)
        except Exception:
            return None
        # Check the fingerprint BEFORE touching any array leaf: a stale
        # multi-million-vertex checkpoint must cost a header read, not a
        # full host->device upload of arrays about to be discarded.
        fp = next(
            (
                str(v)
                for k, v in flat.items()
                if _attr_from_path(k) == "__fingerprint__"
            ),
            None,
        )
        if fp != self.fingerprint:
            return None
        out = {
            _attr_from_path(k): jnp.asarray(v)
            for k, v in flat.items()
            if _attr_from_path(k) != "__fingerprint__"
        }
        self.loaded.append(stage)
        if set(out) == {"__value__"}:
            return out["__value__"]
        return out

    def save(self, stage: str, tree) -> None:
        if not isinstance(tree, dict):
            tree = {"__value__": tree}
        tree = dict(tree)
        tree["__fingerprint__"] = np.array(self.fingerprint)
        path = self._path(stage)
        # The suffix MUST end in ".npz": np.savez appends it otherwise and
        # the rename would promote the empty mkstemp file instead.
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp.npz")
        os.close(fd)
        try:
            save_results(tmp, tree)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def get_or(self, stage: str, fn):
        val = self.load(stage)
        if val is not None:
            return val
        val = fn()
        self.save(stage, jax.block_until_ready(val))
        return val


_FOCUSR_RESULT_ATTRS = (
    "Q",
    "spectral_weights",
    "source_spectral_coords",
    "target_spectral_coords",
    "source_spectral_coords_b4_reg",
    "source_spectral_coords_after_rigid",
    "smoothed_target_coords",
    "source_projected_on_target",
    "corresponding_target_idx_for_each_source_pt",
    "nearest_neighbor_transformed_points",
    "weighted_avg_transformed_points",
)


def focusr_state_dict(reg) -> dict:
    """Snapshot the reference-named result attributes of a Focusr instance
    (the post-hoc-inspection state of reference ``focusr.py:174-212``)."""
    out = {}
    for name in _FOCUSR_RESULT_ATTRS:
        val = getattr(reg, name, None)
        if val is not None:
            out[name] = jnp.asarray(val)
    return out


_PYTREE_KEY_RE = re.compile(r"^\[['\"](.+)['\"]\]$")


def _attr_from_path(name: str) -> str:
    """Map a flattened pytree path (e.g. ``\"['Q']\"``) or a bare attribute
    name to the Focusr attribute it denotes."""
    leaf = name.rsplit("/", 1)[-1]
    m = _PYTREE_KEY_RE.match(leaf)
    return m.group(1) if m else leaf


def restore_focusr_state(reg, state: dict, strict: bool = True) -> None:
    """Restore a :func:`focusr_state_dict` / :func:`load_results` snapshot
    onto a Focusr instance.

    Only attributes in the known result-attribute set are restored; an
    unrecognized key raises (``strict=True``, default) rather than silently
    setting a mis-parsed attribute name.
    """
    for name, val in state.items():
        key = _attr_from_path(name)
        if key not in _FOCUSR_RESULT_ATTRS:
            if strict:
                raise KeyError(
                    f"checkpoint key {name!r} -> {key!r} is not a known "
                    f"Focusr result attribute; pass strict=False to skip"
                )
            continue
        setattr(reg, key, jnp.asarray(val))
