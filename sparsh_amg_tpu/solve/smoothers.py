"""Smoothers (SURVEY.md §2 C14-C16).

The reference ships weighted Jacobi, hybrid Gauss-Seidel, and Chebyshev.
True Gauss-Seidel is sequential and has no efficient data-parallel form;
the standard data-parallel replacements (SURVEY.md §7 hard-part #6,
PAPERS.md two-stage GS) are l1-Jacobi (convergent without damping for any
SPD M-matrix row scaling) and Chebyshev (a pure SpMV recurrence).
All smoothers preserve zero padding because dinv/l1_dinv are zero there.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..ops.formats import spmv


def _jacobi_like(A, b, x, sweeps, dinv, omega, zero_start):
    """Shared weighted-Jacobi sweep loop."""
    if sweeps <= 0:
        return x
    if zero_start:
        x = omega * dinv * b if omega != 1.0 else dinv * b
        sweeps -= 1
    for _ in range(sweeps):
        x = x + omega * dinv * (b - spmv(A, x))
    return x


def jacobi(level, b, x, sweeps: int, omega: float, zero_start: bool = False):
    """Weighted Jacobi: x <- x + omega D^-1 (b - A x)."""
    return _jacobi_like(level.A, b, x, sweeps, level.dinv, omega, zero_start)


def l1_jacobi(level, b, x, sweeps: int, zero_start: bool = False):
    """l1-Jacobi (hybrid-GS replacement): x <- x + D_l1^-1 (b - A x),
    D_l1 = diag(a_ii + sum_{j!=i} |a_ij|).  Unconditionally convergent
    smoother for SPD A (Baker, Falgout, Kolev, Yang 2011)."""
    return _jacobi_like(level.A, b, x, sweeps, level.l1_dinv, 1.0,
                        zero_start)


def chebyshev(level, b, x, degree: int, lower_frac: float,
              zero_start: bool = False):
    """Chebyshev polynomial smoother of the given degree on D^-1 A, with
    eigenvalue window [lower_frac * lam_max, lam_max] (hypre/PyAMG
    convention).  degree SpMVs, no dot products."""
    if degree <= 0:
        return x
    lmax = level.lam_max
    lmin = lower_frac * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    A = level.A
    if zero_start:
        r = level.dinv * b
    else:
        r = level.dinv * (b - spmv(A, x))
    d = r / theta
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        x = x + d
        r = r - level.dinv * spmv(A, d)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x + d


def two_stage_gs(level, b, x, sweeps: int, stages: int = 2,
                 backward: bool = False, zero_start: bool = False):
    """Two-stage Gauss-Seidel (the data-parallel form of the reference's
    hybrid GS, PAPERS.md arXiv:2104.01196): each sweep solves the
    triangular system (D + L) z = r inexactly with `stages` Jacobi
    iterations on the triangle:  z_0 = D^-1 r,  z_{k+1} = D^-1 (r - L z_k).
    `backward=True` uses U instead (post-smoothing direction), so a
    pre-forward/post-backward pair keeps the V-cycle symmetric for PCG."""
    T = level.U if backward else level.L
    if T is None:
        # triangles not built for this hierarchy — degrade to l1-Jacobi
        return l1_jacobi(level, b, x, sweeps, zero_start)
    for s in range(sweeps):
        if zero_start and s == 0:
            r = b
        else:
            r = b - spmv(level.A, x)
        z = level.dinv * r
        for _ in range(stages - 1):
            z = level.dinv * (r - spmv(T, z))
        x = z if (zero_start and s == 0) else x + z
    return x


def smooth(level, b, x, params, zero_start: bool = False, sweeps: int = None,
           backward: bool = False, coarse: bool = False):
    """Dispatch on params.smoother.  `backward` selects the sweep direction
    for direction-dependent smoothers (two-stage GS); `coarse` selects the
    reduced coarse-level Chebyshev degree when configured."""
    name = params.smoother
    if name == "jacobi":
        nu = sweeps if sweeps is not None else params.nu1
        return jacobi(level, b, x, nu, params.jacobi_omega, zero_start)
    if name == "l1jacobi":
        nu = sweeps if sweeps is not None else params.nu1
        return l1_jacobi(level, b, x, nu, zero_start)
    if name == "chebyshev":
        degree = (params.cheby_degree_coarse
                  if coarse and params.cheby_degree_coarse
                  else params.cheby_degree)
        return chebyshev(level, b, x, degree,
                         params.cheby_lower_frac, zero_start)
    if name == "gs2":
        nu = sweeps if sweeps is not None else params.nu1
        return two_stage_gs(level, b, x, nu, params.gs_stages, backward,
                            zero_start)
    raise ValueError(f"unknown smoother {name!r}")
