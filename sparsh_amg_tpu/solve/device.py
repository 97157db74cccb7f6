"""Frozen device hierarchy (SURVEY.md §2 C23: the reference copies its CPU
hierarchy to the GPU once before the solve; here the host hierarchy is
frozen into padded device layouts and uploaded once).

Each level carries: the operator in a DIA/ELL layout, inverse-diagonal and
l1-inverse-diagonal vectors for the smoothers, a lambda_max estimate of
D^-1 A for Chebyshev, the prolongator/restrictor in ELL, and — on the
coarsest level — a dense inverse applied as one matvec.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..params import AMGParams
from ..setup.hierarchy import Hierarchy
from ..ops.formats import (csr_to_device, csr_to_ell, csr_to_dense,
                           _round_up, DiaMatrix, HIGHEST)


@partial(jax.tree_util.register_dataclass,
         data_fields=["A", "dinv", "l1_dinv", "lam_max", "P", "R",
                      "coarse_inv", "L", "U"],
         meta_fields=["n", "coarse_sweeps"])
@dataclasses.dataclass(frozen=True)
class DeviceLevel:
    A: object                 # DiaMatrix | EllMatrix, (n_pad x n_pad)
    dinv: jax.Array           # (n_pad,) 1/a_ii, 0 in padding
    l1_dinv: jax.Array        # (n_pad,) 1/(a_ii + sum|offdiag|), 0 in padding
    lam_max: jax.Array        # scalar: power-iteration estimate of lam_max(D^-1 A)
    P: object | None          # EllMatrix (n_pad x nc_pad) or None on coarsest
    R: object | None          # EllMatrix (nc_pad x n_pad) or None on coarsest
    coarse_inv: jax.Array | None  # dense (n_pad x n_pad) inverse on coarsest
    L: object | None = None   # strict lower triangle (two-stage GS)
    U: object | None = None   # strict upper triangle
    n: int = 0                # logical size
    coarse_sweeps: int = 16   # l1-Jacobi sweeps when coarse_inv is None

    @property
    def n_pad(self) -> int:
        return self.dinv.shape[0]

    def coarse_solve(self, b: jax.Array) -> jax.Array:
        """Dense inverse applied as one matvec (reference: LAPACK LU on the
        coarsest level, SURVEY.md C17).  When no inverse was built
        (coarse_solver='smooth', or stalled coarsening left the level too
        large), fall back to params.coarse_smooth_sweeps of l1-Jacobi.

        The inverse is stored TIGHT (256-padded, not the level's 2048
        vector pad): a 1.1k-row coarsest level padded to 2048^2 fp32 is
        16.8 MB of upload vs 5.3 MB tight.  Slice in, pad out."""
        if self.coarse_inv is None:
            from .smoothers import l1_jacobi
            return l1_jacobi(self, b, jnp.zeros_like(b),
                             sweeps=self.coarse_sweeps, zero_start=True)
        r = self.coarse_inv.shape[-1]
        y = jnp.dot(self.coarse_inv, b[:r], precision=HIGHEST,
                    preferred_element_type=b.dtype)
        if b.shape[0] > r:
            y = jnp.pad(y, (0, b.shape[0] - r))
        return y


@partial(jax.tree_util.register_dataclass,
         data_fields=["levels"], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class DeviceHierarchy:
    levels: tuple  # tuple[DeviceLevel, ...]

    @property
    def n_levels(self) -> int:
        return len(self.levels)


def abs_row_sum(A: sp.csr_matrix) -> np.ndarray:
    """Row sums of |a_ij| (l1 smoother diagonal, Gershgorin bound) without
    np.abs(A)'s full-CSR copy."""
    from .._native import get_lib, csr_arrays
    lib = get_lib()
    if lib is not None and A.nnz >= (1 << 16):
        indptr, _, data = csr_arrays(A)
        out = np.empty(A.shape[0], dtype=np.float64)
        lib.abs_row_sum(A.shape[0], indptr, data, out)
        return out
    return np.asarray(np.abs(A).sum(axis=1)).ravel()


# power iteration above this size costs host seconds (20 full sparse
# matvecs — ~1.5 GB of host traffic at 884k rows, 2-3 s on this VM); the
# free Gershgorin bound takes over in "hybrid" mode.  Gershgorin is a
# GUARANTEED upper bound (the safe direction for the Chebyshev window)
# and tight for stencil operators; only sub-128k levels — where power
# costs milliseconds — refine it
_POWER_MAX_N = 1 << 17


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("diag_idx",))
def _dia_diag_stats(bands, diag_idx: int):
    """Smoother diagonals + Gershgorin bound from fp32 DIA bands, computed
    on device (padding rows have all-zero bands -> dinv/l1_dinv 0 there,
    matching the host construction)."""
    d = bands[diag_idx]
    absrow = jnp.sum(jnp.abs(bands), axis=0)
    dinv = jnp.where(d != 0, 1.0 / d, 0.0)
    l1 = d + (absrow - jnp.abs(d))
    l1_dinv = jnp.where(l1 != 0, 1.0 / l1, 0.0)
    lam = jnp.max(jnp.where(d != 0, absrow / jnp.abs(d), 0.0))
    return dinv, l1_dinv, jnp.maximum(lam, 1e-30)


def lambda_max_estimate(A: sp.csr_matrix, d: np.ndarray,
                        absrow: np.ndarray, method: str = "hybrid") -> float:
    """Upper bound on lambda_max(D^-1 A) for the Chebyshev window.

    Gershgorin (max_i sum_j |a_ij| / |a_ii|) is a GUARANTEED upper bound —
    the dangerous direction is undershoot (a window missing the top of the
    spectrum: measured 416 instead of 10 PCG iterations at 96^3) — and is
    free given the l1 row sums.  It is tight for FD stencils (2.000 vs
    power's 2.039 on 5-pt Poisson) but ~1.3x loose on Q1 elasticity, so
    "hybrid" refines small levels with min(power, gershgorin) and uses
    pure Gershgorin only where the power iteration would cost host seconds
    (n > 2^20; at the 100M north star it would be ~30-60 s)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        ratios = np.where(d != 0, absrow / np.abs(d), 0.0)
    g = float(ratios.max()) if ratios.size else 1.0
    if g <= 0.0 or not np.isfinite(g):
        g = 1.0
    if method == "gershgorin":
        return g
    if method == "power":
        return _lambda_max_dinv_a(A)
    if A.shape[0] <= _POWER_MAX_N:
        return min(_lambda_max_dinv_a(A), g)
    return g


def _lambda_max_dinv_a(A: sp.csr_matrix, iters: int = 20,
                       seed: int = 0) -> float:
    """Host power iteration for lambda_max(D^-1 A) (Chebyshev upper bound).
    Do NOT reduce iters: at 10 iterations the estimate undershoots and the
    Chebyshev window misses the top of the spectrum — measured 416 PCG
    iterations instead of 10 on 96^3 Poisson."""
    d = A.diagonal()
    dinv = np.where(d != 0, 1.0 / d, 0.0)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(A.shape[0])
    v /= np.linalg.norm(v) + 1e-30
    lam = 1.0
    for _ in range(iters):
        w = dinv * (A @ v)
        lam = float(np.linalg.norm(w))
        if lam == 0.0:
            return 1.0
        v = w / lam
    return lam * 1.05  # small safety margin


def dense_inverse(A: sp.csr_matrix, method: str = "lu") -> np.ndarray:
    """Explicit coarse inverse via the configured host factorization
    (params.coarse_solver; reference C17 uses LAPACK LU/Cholesky).  The
    device apply stays a single fp32 matvec either way — triangular
    back-substitution is sequential and parallelizes poorly, so the
    factorization choice lives on the host where the inverse is formed."""
    import scipy.linalg as sla
    Ad = A.toarray()
    n = Ad.shape[0]
    if method == "cholesky":
        # also an SPD check: cho_factor raises on an indefinite operator
        c_and_low = sla.cho_factor(Ad)
        return sla.cho_solve(c_and_low, np.eye(n))
    if method == "lu":
        return sla.lu_solve(sla.lu_factor(Ad), np.eye(n))
    raise ValueError(f"unknown coarse_solver {method!r}")


def to_device(hier: Hierarchy, params: AMGParams | None = None,
              dtype=None, fine_hi=None) -> DeviceHierarchy:
    """fine_hi: optionally the already-uploaded fp32 fine-level DiaMatrix
    (the df64 refinement operator's hi half).  When its layout matches
    what csr_to_device would build, the fine band_dtype operator is
    DERIVED ON DEVICE by casting those bands instead of uploading a
    second copy of the largest matrix (2 B/nnz less host-to-device
    traffic)."""
    params = params or hier.params
    dtype = dtype or jnp.dtype(params.dtype)
    bdtype = jnp.dtype(params.band_dtype)
    levels = []
    for li, lev in enumerate(hier.levels):
        A = lev.A
        n = A.shape[0]
        is_coarsest = li == len(hier.levels) - 1 or lev.P is None
        # every level vector is padded to a multiple of 2048 rows;
        # csr_to_df64 pads the fine level the same way, so the two fine
        # operators share one vector length
        fine_reuse = (li == 0 and isinstance(fine_hi, DiaMatrix)
                      and fine_hi.n_rows == n and not is_coarsest
                      and n > params.dense_size
                      and fine_hi.n_pad == _round_up(max(n, 1), 2048))
        if fine_reuse:
            dev_A = fine_hi if fine_hi.bands.dtype == bdtype else \
                dataclasses.replace(
                    fine_hi, bands=jax.jit(
                        lambda b: b.astype(bdtype))(fine_hi.bands))
        else:
            dev_A = csr_to_device(A, dtype=bdtype,
                                  prefer_dia=params.prefer_dia,
                                  dia_max_bands=params.dia_max_bands,
                                  dense_size=params.dense_size,
                                  pad_multiple=2048)
        n_pad = dev_A.n_pad
        # l1_dinv is consumed only by the l1-Jacobi/gs2 smoothers and the
        # no-inverse coarse fallback — for the Chebyshev/Jacobi flagship
        # it was 2x28 MB of dead HBM at 192^3 (round-3 footprint audit)
        need_l1 = params.smoother in ("l1jacobi", "gs2") or is_coarsest
        if (fine_reuse and 0 in fine_hi.offsets and n > _POWER_MAX_N
                and params.lambda_max != "power"
                and jnp.dtype(params.dtype) == jnp.float32):
            # derive the smoother diagonals + Gershgorin lambda_max ON
            # DEVICE from the already-uploaded fp32 bands: saves 8 B/row
            # of upload and the host abs-row-sum pass; above _POWER_MAX_N
            # the hybrid estimate is pure Gershgorin anyway
            dinv_j, l1_dinv_j, lam = _dia_diag_stats(
                fine_hi.bands, fine_hi.offsets.index(0))
            if not need_l1:
                l1_dinv_j = None
        else:
            d = A.diagonal()
            dinv = np.zeros(n_pad)
            dinv[:n] = np.where(d != 0, 1.0 / d, 0.0)
            # l1-Jacobi diagonal: a_ii + sum_j|a_ij| off-diagonal
            absrow = abs_row_sum(A)
            lam = lambda_max_estimate(A, d, absrow, params.lambda_max) \
                if not is_coarsest or n > 1 else 1.0
            dinv_j = jnp.asarray(dinv, dtype=dtype)
            l1_dinv_j = None
            if need_l1:
                l1d = d + (absrow - np.abs(d))
                l1_dinv = np.zeros(n_pad)
                l1_dinv[:n] = np.where(l1d != 0, 1.0 / l1d, 0.0)
                l1_dinv_j = jnp.asarray(l1_dinv, dtype=dtype)

        P = R = coarse_inv = None
        if not is_coarsest:
            nc = lev.P.shape[1]
            if max(n, nc) <= params.dense_size:
                P = csr_to_dense(lev.P, dtype=bdtype, pad_multiple=2048)
                R = csr_to_dense(lev.R, dtype=bdtype, pad_multiple=2048)
            else:
                P = csr_to_ell(lev.P, dtype=bdtype, pad_multiple=2048)
                R = csr_to_ell(lev.R, dtype=bdtype, pad_multiple=2048)
        elif n <= params.coarse_inv_max and params.coarse_solver != "smooth":
            r = min(_round_up(max(n, 1), 256), n_pad)
            dense = np.zeros((r, r), dtype=np.float32)
            dense[:n, :n] = dense_inverse(A, params.coarse_solver)
            # fp32 always (NOT band_dtype): a bf16 inverse is an 8-bit-
            # mantissa coarse solve — measurably weaker as the cycle's
            # exact-solve anchor (VERDICT r1 weak #4)
            coarse_inv = jnp.asarray(dense, dtype=dtype)

        L = U = None
        if params.smoother == "gs2" and coarse_inv is None:
            conv = lambda T: csr_to_device(
                T.tocsr(), dtype=bdtype, prefer_dia=params.prefer_dia,
                dia_max_bands=params.dia_max_bands,
                dense_size=params.dense_size, pad_multiple=2048)
            L = conv(sp.tril(A, -1))
            U = conv(sp.triu(A, 1))

        levels.append(DeviceLevel(
            A=dev_A,
            dinv=dinv_j,
            l1_dinv=l1_dinv_j,
            lam_max=jnp.asarray(lam, dtype=dtype),
            P=P, R=R, coarse_inv=coarse_inv, L=L, U=U, n=n,
            coarse_sweeps=params.coarse_smooth_sweeps,
        ))
    return DeviceHierarchy(levels=tuple(levels))
