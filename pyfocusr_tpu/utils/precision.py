"""Precision utilities.

On an NVIDIA GPU from Ampere on (the H100 included), an f32 matmul with no
precision set runs in TF32 on the tensor cores, which keeps about three
decimal digits.  That silently destroys the numerics this library depends
on (Lanczos reorthogonalization, randomized kernel eigendecompositions,
distance-matrix cancellation): reduced-precision matmuls were observed to
explode CPD warps and collapse correspondences while the identical code was
exact on CPU.  Every jitted entry point therefore traces under
``jax.default_matmul_precision("highest")`` (true f32), and the
registration program has no matmul below ``HIGHEST``;
``dot_precision_census`` audits a lowered program for exactly that rule.
"""

import collections
import functools
import re

import jax

__all__ = ["f32_matmuls", "dot_precision_census"]

_DOT_OP = re.compile(r"stablehlo\.(?:dot_general|convolution)\b(.*)")
_PRECISION = re.compile(r"precision\s*=\s*\[([^\]]*)\]")


def dot_precision_census(stablehlo_text: str) -> dict:
    """Count the ``dot_general``/``convolution`` ops of a lowered program
    (``jax.jit(f).lower(...).as_text()``) by their operand precision:
    ``{"HIGHEST": n, "HIGH": m, "DEFAULT": d}``.  An op without a
    ``precision`` attribute counts as DEFAULT; an op whose two operand
    precisions differ counts under the lower one."""
    rank = {"DEFAULT": 0, "HIGH": 1, "HIGHEST": 2}
    counts = collections.Counter()
    for line in stablehlo_text.splitlines():
        op = _DOT_OP.search(line)
        if op is None:
            continue
        m = _PRECISION.search(op.group(1))
        names = [p.strip() for p in m.group(1).split(",")] if m else []
        names = [n for n in names if n in rank] or ["DEFAULT"]
        counts[min(names, key=rank.__getitem__)] += 1
    return dict(counts)


def f32_matmuls(fn):
    """Decorator: trace ``fn`` under highest (true f32) matmul precision."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper
