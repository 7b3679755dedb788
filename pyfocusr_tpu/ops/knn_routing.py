"""Measured KNN path routing: race-once-per-shape-class planner.

The brute/grid crossover of ``knn.py`` moves with the device
generation, memory bandwidth and host speed, so near it any fixed
constant picks the wrong path for some machine.  Instead of a hand-tuned
constant, routing inside the ambiguous band is
MEASURED on the actual device, FFTW-planner style:

* outside the band the physics is unambiguous (brute is O(Nq*Nr) at
  ~8e11 pairs/s on an H100; the grid pays ~1.6 us per vertex, see
  ``knn._GRID_MIN_PAIRS_DEFAULT``), so the static bounds decide
  immediately;
* the first call inside the band for a given (k-class, log2-pairs
  bucket) runs BOTH paths — one untimed warm-up (compiles must not vote)
  plus one timed run each — returns the faster path's result, and
  persists the winner per device kind;
* every later call in that bucket (across processes) uses the recorded
  winner, so steady-state routing is never slower than the best manual
  choice.

The cache lives in ``$PYFOCUSR_TPU_CAL_DIR`` (default
``~/.cache/pyfocusr_tpu``) as ``knn_routing_<device-kind>.json``; delete
it to re-calibrate (e.g. after a toolchain upgrade).  Both paths are
exact (grid rows are certified with brute fallback — grid_knn.py), so
racing is purely a performance decision and the two results are
interchangeable.

Determinism note: at exactly-equidistant points the brute and grid paths
may break NN-index ties differently, so which *index* a tied query
returns can depend on the recorded winner — i.e. on the host's cache
state.  Distances (and everything derived from them) are identical
either way; pin the cache file (or delete it and let one process race)
when bit-identical indices across hosts matter.
"""

from __future__ import annotations

import json
import math
import os
import re
import time

import jax

__all__ = ["bucket_key", "routed", "cache_file"]

# In-memory view of the persisted cache (per cache file), so one process
# races each bucket at most once even if the file is unwritable.
_MEM: dict = {}


def _cal_dir() -> str:
    return os.environ.get(
        "PYFOCUSR_TPU_CAL_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "pyfocusr_tpu"),
    )


def cache_file() -> str:
    try:
        kind = jax.devices()[0].device_kind
    except Exception:
        kind = "unknown"
    kind = re.sub(r"[^A-Za-z0-9_.-]+", "_", kind)
    return os.path.join(_cal_dir(), f"knn_routing_{kind}.json")


def bucket_key(nq: int, nr: int, k: int) -> str:
    """Shape-class bucket: log2 k-class x log2 of the pair count x log2
    of the SMALLER side.  Factor-of-2 buckets span the ~3.5e11..6e12
    ambiguous band in ~4 buckets per class; the min-side component keeps
    extreme aspect ratios apart — grid cost scales with the REFERENCE
    size while brute scales with the product, so a winner raced at
    1e4 x 1e8 must not be misapplied to 1e6 x 1e6 (review finding r4).
    The k-class is log2-bucketed rather than the earlier 1-vs->=2 split:
    brute cost grows ~linearly with k while grid cost is flat, so a
    'brute' winner raced at k=2 must not be reused at k=8 (advisor
    finding r4 — perf-only, both paths are exact)."""
    pairs = max(float(nq) * float(nr), 1.0)
    side = max(float(min(nq, nr)), 1.0)
    return (f"k{int(math.log2(max(k, 1)))}_p{int(math.log2(pairs))}"
            f"_m{int(math.log2(side))}")


def _load(path: str) -> dict:
    if path in _MEM:
        return _MEM[path]
    data = {}
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            data = {}
    except (OSError, ValueError):
        data = {}
    _MEM[path] = data
    return data


def _store(path: str, data: dict) -> None:
    """Persist ``data``, merging with whatever is on disk right now:
    two processes racing DIFFERENT buckets concurrently each write their
    own snapshot, and without the merge the last writer would drop the
    other's entry (advisor finding r4 — the loser only re-races later,
    so the cost was wasted work, not wrong results).  The merge prefers
    our own entries on key collision (same bucket raced twice: either
    winner is valid — see the tie-break note below)."""
    try:
        disk = {}
        try:
            with open(path) as f:
                disk = json.load(f)
            if not isinstance(disk, dict):
                disk = {}
        except (OSError, ValueError):
            disk = {}
        data = {**disk, **data}
        _MEM[path] = data
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        _MEM[path] = data
        # unwritable cache dir: the in-memory copy still avoids re-races


def routed(bucket: str, runners: dict):
    """Run the recorded winner for ``bucket``, or race all ``runners``
    (dict name -> thunk returning a jax pytree) once and record it.

    The race runs each path twice — one discarded warm-up so compile
    time cannot vote, then one timed run — and returns the timed result
    of the winner."""
    path = cache_file()
    cache = _load(path)
    entry = cache.get(bucket)
    if isinstance(entry, dict) and entry.get("winner") in runners:
        return runners[entry["winner"]]()

    times, results = {}, {}
    for name, thunk in runners.items():
        jax.block_until_ready(thunk())  # warm-up: compiles must not vote
        t0 = time.perf_counter()
        out = thunk()
        jax.block_until_ready(out)
        times[name] = time.perf_counter() - t0
        results[name] = out
    winner = min(times, key=times.get)
    cache = dict(cache)
    cache[bucket] = {
        "winner": winner,
        "times_s": {n: round(t, 4) for n, t in times.items()},
    }
    _store(path, cache)
    return results[winner]
