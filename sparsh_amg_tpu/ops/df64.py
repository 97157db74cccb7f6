"""Double-float (df64) arithmetic: ~47-bit-mantissa precision from fp32 pairs.

The device solve runs in fp32 (SURVEY.md §7 hard-part #1).  To reach the
reference's 1e-8 relative-residual target — below fp32 roundoff — the outer
iterative-refinement loop computes residuals and accumulates the solution in
double-float arithmetic: each value is an unevaluated sum hi + lo of two
fp32s.  Classic error-free transforms (Knuth two_sum, Dekker split/two_prod);
all elementwise ops, fully vectorized, no x64 mode needed.

These identities rely on IEEE round-to-nearest fp32 ops, and XLA does not
reassociate floating-point by default.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# 2^12 + 1 for fp32 Dekker splitting.  numpy (not jnp) scalar: a module-
# level jnp constant would initialize the JAX backend at import time,
# which breaks multi-process use (jax.distributed.initialize must run
# before the first backend touch — see parallel.multihost).
_SPLIT = np.float32(4097.0)


def two_sum(a, b):
    """s + e == a + b exactly."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def fast_two_sum(a, b):
    """Requires |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """p + e == a * b exactly (Dekker, no FMA required)."""
    p = a * b
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def add(x_hi, x_lo, y_hi, y_lo):
    """df64 + df64."""
    s, e = two_sum(x_hi, y_hi)
    e = e + (x_lo + y_lo)
    return fast_two_sum(s, e)


def sub(x_hi, x_lo, y_hi, y_lo):
    return add(x_hi, x_lo, -y_hi, -y_lo)


def mul_f32(x_hi, x_lo, a):
    """df64 * fp32."""
    p, e = two_prod(x_hi, a)
    e = e + x_lo * a
    return fast_two_sum(p, e)


def mul(x_hi, x_lo, y_hi, y_lo):
    """df64 * df64."""
    p, e = two_prod(x_hi, y_hi)
    e = e + (x_hi * y_lo + x_lo * y_hi)
    return fast_two_sum(p, e)


def from_f64_np(x):
    """Split a float64 numpy array into (hi, lo) fp32 arrays."""
    import numpy as np
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def to_f64_np(hi, lo):
    import numpy as np
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)


def dot(x, y):
    """Compensated (df64-accurate) dot product of two fp32 vectors.

    Returns (hi, lo).  Sequential accumulation via pairwise tree to keep the
    reduction XLA-friendly: we do the error-free products elementwise, then
    a compensated pairwise reduction in log2(n) steps.
    """
    p, e = two_prod(x, y)
    s_hi, s_lo = p, e
    n = s_hi.shape[0]
    # pairwise compensated reduction; pad to power of two
    size = 1
    while size < n:
        size *= 2
    pad = size - n
    if pad:
        s_hi = jnp.pad(s_hi, (0, pad))
        s_lo = jnp.pad(s_lo, (0, pad))
    while s_hi.shape[0] > 1:
        h = s_hi.shape[0] // 2
        s_hi, s_lo = add(s_hi[:h], s_lo[:h], s_hi[h:], s_lo[h:])
    return s_hi[0], s_lo[0]


def norm2_sq(x):
    """Compensated squared 2-norm; returns (hi, lo)."""
    return dot(x, x)
