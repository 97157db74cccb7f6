"""Bandwidth-reducing row ordering (SURVEY.md §7 hard-part #2).

The DIA layout and the distributed halo layout both require column
indices near the diagonal, and gathers are cheapest when they are local.  Structured stencils come
pre-banded; general (e.g. SuiteSparse) matrices get a reverse Cuthill-McKee
permutation at setup so they become banded too.  The permutation is applied
once on the host; b/x are (un)permuted at the solve boundary.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph


def bandwidth(A: sp.csr_matrix) -> int:
    if A.nnz == 0:
        return 0
    # per-row column extrema via reduceat — the nnz-length rows array
    # (np.repeat) cost 23 s cold at 192^3 on this page-fault-bound host
    indptr = A.indptr
    nz = np.diff(indptr) > 0
    starts = indptr[:-1][nz].astype(np.int64)
    cmax = np.maximum.reduceat(A.indices, starts)
    cmin = np.minimum.reduceat(A.indices, starts)
    rows = np.flatnonzero(nz)
    return int(max((cmax - rows).max(), (rows - cmin).max()))


def rcm_permutation(A: sp.csr_matrix) -> np.ndarray:
    """Symmetric-pattern RCM ordering (scipy csgraph, C implementation —
    the same algorithm as the native rcm_order kernel)."""
    return np.asarray(
        csgraph.reverse_cuthill_mckee(A.tocsr(), symmetric_mode=True))


def maybe_reorder(A: sp.csr_matrix, mode: str = "auto",
                  target_frac: float = 0.15):
    """Return (A_permuted, perm or None).

    mode "rcm" always permutes; "auto" permutes only when the bandwidth
    exceeds target_frac * n AND RCM actually improves it; "none" never.
    """
    if mode == "none":
        return A, None
    n = A.shape[0]
    bw = bandwidth(A)
    if mode == "auto" and bw <= target_frac * n:
        return A, None
    perm = rcm_permutation(A)
    Ap = A[perm][:, perm].tocsr()
    if mode == "auto" and bandwidth(Ap) >= bw:
        return A, None
    return Ap, perm
