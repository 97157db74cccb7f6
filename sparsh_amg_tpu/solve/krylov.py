"""Krylov solvers with AMG preconditioning (SURVEY.md §2 C19-C20, §3.1).

PCG and BiCGStab, each in two execution modes:

* device mode — the whole iteration as one `lax.while_loop`: a single XLA
  computation, convergence control as a traced predicate.  Ideal when the
  host-device link is thin or several hosts run one program.
* host/chunked mode — k iterations per jitted dispatch (`lax.fori_loop`
  inside, no data-dependent control flow), with the convergence check on
  the host once per chunk.  This mirrors the reference's GPU driver (host
  loop around device kernels with a ||r|| readback) and avoids the
  per-while-iteration synchronization cost some backends impose; the only
  price is up to k-1 extra iterations past convergence, which for CG are
  harmless (guarded divisions).

The iteration bodies are shared between both modes.  `dot_fn` overrides
the inner product (distributed path: psum-reduced pdot — the reference's
MPI_Allreduce).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.blas import dot


def _mkdot(dot_fn, compensated):
    return dot_fn or partial(dot, compensated=compensated)


# ---------------------------------------------------------------------------
# PCG
# ---------------------------------------------------------------------------

def pcg_init(matvec, precond, b, _dot, x0=None):
    if x0 is None:
        x = jnp.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    z = precond(r)
    p = z
    return (x, r, z, p, _dot(r, z), _dot(r, r), jnp.int32(0))


def pcg_step(matvec, precond, _dot, state):
    x, r, z, p, rz_, rr_, k = state
    q = matvec(p)
    pq = _dot(p, q)
    alpha = rz_ / jnp.where(pq != 0, pq, 1.0)
    x = x + alpha * p
    r = r - alpha * q
    z = precond(r)
    rz_new = _dot(r, z)
    beta = rz_new / jnp.where(rz_ != 0, rz_, 1.0)
    p = z + beta * p
    return (x, r, z, p, rz_new, _dot(r, r), k + 1)


def pcg(matvec, precond, b, tol: float, maxiter: int, x0=None,
        compensated: bool = False, dot_fn=None):
    """Device-mode PCG: stops when ||r||/||b|| <= tol (traced predicate).
    Returns (x, iters, relres)."""
    _dot = _mkdot(dot_fn, compensated)
    state = pcg_init(matvec, precond, b, _dot, x0)
    bb = _dot(b, b)
    tol2bb = (tol * tol) * bb

    def cond(st):
        return jnp.logical_and(st[6] < maxiter, st[5] > tol2bb)

    state = jax.lax.while_loop(
        cond, lambda st: pcg_step(matvec, precond, _dot, st), state)
    x, r, z, p, rz, rr, k = state
    relres = jnp.sqrt(rr / jnp.where(bb != 0, bb, 1.0))
    return x, k, relres


def pcg_chunk(matvec, precond, chunk: int, compensated: bool = False,
              dot_fn=None):
    """Host-mode helpers: (init_fn(b) -> state, chunk_fn(state) -> state).
    chunk_fn advances `chunk` iterations with no data-dependent control
    flow; state[5] is ||r||^2, state[6] the iteration count."""
    _dot = _mkdot(dot_fn, compensated)

    def init_fn(b, x0=None):
        return pcg_init(matvec, precond, b, _dot, x0)

    def chunk_fn(state):
        # trace-time unroll (python loop, straight-line XLA): no device
        # loop predicate is read back inside a chunk, and XLA schedules
        # the unrolled chunk at least as well as a loop body
        for _ in range(chunk):
            state = pcg_step(matvec, precond, _dot, state)
        return state

    return init_fn, chunk_fn


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------

def bicgstab_init(matvec, b, _dot, x0=None):
    if x0 is None:
        x = jnp.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    one = jnp.asarray(1.0, dtype=b.dtype)
    v = jnp.zeros_like(b)
    p = jnp.zeros_like(b)
    # state: x, r, v, p, rho, alpha, omega, rr, k, brk
    return (x, r, v, p, one, one, one, _dot(r, r), jnp.int32(0),
            jnp.asarray(False))


def bicgstab_step(matvec, precond, _dot, rhat, state):
    x, r, v, p, rho, alpha, omega, rr, k, brk = state
    rho_new = _dot(rhat, r)
    breakdown = (rho_new == 0) | (omega == 0)
    beta = (rho_new / jnp.where(rho != 0, rho, 1.0)) * \
           (alpha / jnp.where(omega != 0, omega, 1.0))
    p = r + beta * (p - omega * v)
    phat = precond(p)
    v = matvec(phat)
    rhat_v = _dot(rhat, v)
    alpha = rho_new / jnp.where(rhat_v != 0, rhat_v, 1.0)
    s = r - alpha * v
    shat = precond(s)
    t = matvec(shat)
    tt = _dot(t, t)
    omega = _dot(t, s) / jnp.where(tt != 0, tt, 1.0)
    x_new = x + alpha * phat + omega * shat
    r_new = s - omega * t
    # freeze the state on breakdown (host mode keeps stepping to chunk end)
    keep = lambda new, old: jnp.where(brk | breakdown, old, new)
    x = jax.tree.map(keep, x_new, x)
    r = jax.tree.map(keep, r_new, r)
    return (x, r, v, p, rho_new, alpha, omega, _dot(r, r), k + 1,
            brk | breakdown)


def bicgstab(matvec, precond, b, tol: float, maxiter: int, x0=None,
             compensated: bool = False, dot_fn=None):
    """Device-mode preconditioned BiCGStab (Templates, Barrett et al. 1994)
    for nonsymmetric systems (reference config: anisotropic
    W-cycle+BiCGStab)."""
    _dot = _mkdot(dot_fn, compensated)
    if x0 is None:
        rhat = b
    else:
        rhat = b - matvec(x0)
    state = bicgstab_init(matvec, b, _dot, x0)
    bb = _dot(b, b)
    tol2bb = (tol * tol) * bb

    def cond(st):
        return (st[8] < maxiter) & (st[7] > tol2bb) & jnp.logical_not(st[9])

    state = jax.lax.while_loop(
        cond, lambda st: bicgstab_step(matvec, precond, _dot, rhat, st),
        state)
    rr, k = state[7], state[8]
    relres = jnp.sqrt(rr / jnp.where(bb != 0, bb, 1.0))
    return state[0], k, relres


def bicgstab_chunk(matvec, precond, chunk: int, compensated: bool = False,
                   dot_fn=None):
    """Host-mode helpers for BiCGStab; state[7] is ||r||^2, state[8] the
    iteration count, state[9] the breakdown flag."""
    _dot = _mkdot(dot_fn, compensated)

    def init_fn(b, x0=None):
        return bicgstab_init(matvec, b, _dot, x0)

    def chunk_fn(rhat, state):
        for _ in range(chunk):          # trace-time unroll (see pcg_chunk)
            state = bicgstab_step(matvec, precond, _dot, rhat, state)
        return state

    return init_fn, chunk_fn


# ---------------------------------------------------------------------------
# Stationary AMG iteration (no Krylov acceleration)
# ---------------------------------------------------------------------------

def stationary_init(matvec, precond, b, _dot, x0=None):
    """State: (x, r, ||r||^2, k) — the classical standalone multigrid
    solve x += M^-1 r (the reference's L4 cycle driver used directly,
    SURVEY.md §3.3, before any Krylov wrapper)."""
    if x0 is None:
        x = jnp.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    return (x, r, _dot(r, r), jnp.int32(0))


def stationary_step(matvec, precond, _dot, state):
    x, r, rr, k = state
    e = precond(r)
    x = x + e
    r = r - matvec(e)       # one matvec per iteration (incremental residual)
    return (x, r, _dot(r, r), k + 1)


def stationary(matvec, precond, b, tol: float, maxiter: int, x0=None,
               compensated: bool = False, dot_fn=None):
    """Device-mode standalone AMG solve: cycle until ||r||/||b|| <= tol.
    Same (x, iters, relres) contract as pcg/bicgstab, so the solver's
    refinement driver and loop modes work unchanged."""
    _dot = _mkdot(dot_fn, compensated)
    state = stationary_init(matvec, precond, b, _dot, x0)
    bb = _dot(b, b)
    tol2bb = (tol * tol) * bb

    def cond(st):
        return jnp.logical_and(st[3] < maxiter, st[2] > tol2bb)

    state = jax.lax.while_loop(
        cond, lambda st: stationary_step(matvec, precond, _dot, st), state)
    x, r, rr, k = state
    relres = jnp.sqrt(rr / jnp.where(bb != 0, bb, 1.0))
    return x, k, relres
