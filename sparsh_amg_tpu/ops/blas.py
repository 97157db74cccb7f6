"""BLAS-1 ops (SURVEY.md §2 C8: axpy/dot/norm, MPI-allreduced in the
reference; here jnp + optional compensated accumulation, psum'd inside
shard_map on the distributed path)."""
from __future__ import annotations

import jax.numpy as jnp

from . import df64
from .formats import HIGHEST


def dot(x, y, compensated: bool = True):
    """Inner product of fp32 vectors.  Compensated (df64) accumulation by
    default: at n ~ 1e8 a naive fp32 reduction loses ~4 digits."""
    if compensated:
        hi, lo = df64.dot(x, y)
        return hi + lo
    return jnp.dot(x, y, precision=HIGHEST,
                   preferred_element_type=jnp.float32)


def norm_sq(x, compensated: bool = True):
    return dot(x, x, compensated)


def axpy(a, x, y):
    return a * x + y
