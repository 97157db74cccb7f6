"""The plain-XLA operator paths against scipy float64: DIA shifted FMAs
(SpMV, residual, Jacobi sweep, Chebyshev smoothing) and ELL gathers, at
stencil, wide-band, transfer, irregular and systems shapes.

Tolerances: every check is per row, 2*(row nnz + 2) fp32 epsilons of
the magnitude the rounding errors scale with (|A||x| (+ |b|) summed in
float64) — each product and sum of a row rounds once in fp32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from sparsh_amg_tpu.models import poisson2d, poisson3d
from sparsh_amg_tpu.models.elasticity import elasticity2d, elasticity3d
from sparsh_amg_tpu.ops import formats
from sparsh_amg_tpu.ops.formats import (DiaMatrix, EllMatrix, csr_to_dia,
                                        csr_to_ell, residual)
from sparsh_amg_tpu.params import AMGParams, flagship_params
from sparsh_amg_tpu.setup.hierarchy import amg_setup
from sparsh_amg_tpu.solve.smoothers import chebyshev, jacobi

EPS32 = float(np.finfo(np.float32).eps)


def _wide_band():
    # offsets neither small nor multiples of 128
    n = 1000
    offs = [-300, -129, -127, -5, 0, 3, 127, 128, 301]
    rng = np.random.default_rng(1)
    diags = [rng.standard_normal(n) for _ in offs]
    diags[offs.index(0)] = 10.0 + np.abs(diags[offs.index(0)])
    return sp.diags(diags, offs, shape=(n, n), format="csr")


DIA_SHAPES = {
    "poisson2d-20": lambda: poisson2d(20),
    "poisson2d-37": lambda: poisson2d(37),
    "poisson3d-12": lambda: poisson3d(12),
    "wide-band": _wide_band,
}


def _vec(rng, n, n_pad):
    v = np.zeros(n_pad, np.float32)
    v[:n] = rng.standard_normal(n).astype(np.float32)
    return v


def _assert_rows(y, y_ref, scale, nnz):
    err = np.abs(np.asarray(y, np.float64) - y_ref)
    bound = 2 * (nnz + 2) * EPS32 * scale + 1e-30
    assert np.all(err <= bound), float((err / bound).max())


@pytest.mark.parametrize("op", ["spmv", "residual", "jacobi", "chebyshev"])
@pytest.mark.parametrize("shape", sorted(DIA_SHAPES))
def test_dia_ops_match_scipy(shape, op):
    A = DIA_SHAPES[shape]().tocsr()
    A.data = A.data.astype(np.float32).astype(np.float64)  # fp32 bands
    n = A.shape[0]
    D = csr_to_dia(A)
    assert isinstance(D, DiaMatrix)
    rng = np.random.default_rng(2)
    x, b = _vec(rng, n, D.n_pad), _vec(rng, n, D.n_pad)
    xs, bs = x[:n].astype(np.float64), b[:n].astype(np.float64)
    absA = abs(A)
    nnz = np.diff(A.indptr)
    d = A.diagonal()
    dinv = np.zeros(D.n_pad, np.float32)
    dinv[:n] = (1.0 / d).astype(np.float32)
    dv = dinv[:n].astype(np.float64)
    if op == "spmv":
        y = np.asarray(jax.jit(lambda v: D.spmv(v))(x))[:n]
        _assert_rows(y, A @ xs, absA @ np.abs(xs), nnz)
    elif op == "residual":
        y = np.asarray(jax.jit(residual)(D, x, b))[:n]
        _assert_rows(y, bs - A @ xs, absA @ np.abs(xs) + np.abs(bs), nnz)
    else:
        lam = float((np.abs(dv) * (absA @ np.ones(n))).max())  # Gershgorin
        level = _Level(A=D, dinv=jnp.asarray(dinv),
                       lam_max=jnp.asarray(lam, jnp.float32))
        if op == "jacobi":
            y = np.asarray(jax.jit(lambda lv, bb, xx: jacobi(
                lv, bb, xx, 1, 0.7))(level, b, x))[:n]
            y_ref = xs + 0.7 * dv * (bs - A @ xs)
            scale = np.abs(xs) + 0.7 * np.abs(dv) * (
                absA @ np.abs(xs) + np.abs(bs))
            _assert_rows(y, y_ref, scale, nnz)
        else:
            y = np.asarray(jax.jit(lambda lv, bb, xx: chebyshev(
                lv, bb, xx, 3, 1.0 / 30.0))(level, b, x))[:n]
            y_ref = _cheb_ref(A, dv, lam, bs, xs, 3, 1.0 / 30.0)
            # three chained SpMVs: normwise, a few 1e-7 in fp32
            rel = np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)
            assert rel <= 1e-5, rel


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _Level:
    """The fields the smoothers read from a DeviceLevel."""
    A: object
    dinv: jax.Array
    lam_max: jax.Array


def _cheb_ref(A, dinv, lmax, b, x, degree, lower_frac):
    """solve/smoothers.chebyshev's recurrence in float64."""
    lmin = lower_frac * lmax
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = dinv * (b - A @ x)
    d = r / theta
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        x = x + d
        r = r - dinv * (A @ d)
        d = rho_new * rho * d + 2.0 * rho_new / delta * r
        rho = rho_new
    return x + d


# ---------------------------------------------------------------------------
# ELL gathers
# ---------------------------------------------------------------------------

def _flagship_transfers():
    hier = amg_setup(poisson3d(16), flagship_params())
    return hier.levels[0]


def _pmis_transfers():
    hier = amg_setup(poisson3d(16), AMGParams(
        coarsening="pmis", interpolation="extpi", interp_max=4))
    return hier.levels[0]


def _block_rows(kind):
    rng = np.random.default_rng(0)
    if kind == "elas3d":
        return elasticity3d(6)
    if kind == "elas2d":
        return elasticity2d(12)
    nb, bs = 70, 3
    P = (sp.random(nb, nb, density=0.08, random_state=1) > 0)
    P = (P + P.T + sp.eye(nb)).tocsr()
    M = sp.kron(P, np.ones((bs, bs))).tocsr()
    M.data = np.where(rng.random(M.nnz) > 0.3,
                      rng.standard_normal(M.nnz), 0.0)
    M.eliminate_zeros()
    return M


ELL_SHAPES = {
    "square-poisson2d": lambda: poisson2d(40),
    "P-pmis": lambda: _pmis_transfers().P,
    "R-pmis": lambda: _pmis_transfers().R,
    "R0-pmis2-skewed": lambda: _flagship_transfers().R,
    "irregular-random": lambda: sp.random(
        300, 450, density=0.02, random_state=4, format="csr"),
    "empty-and-padded-rows": lambda: sp.csr_matrix(
        (np.array([2.0, 3.0, 4.0]),
         (np.array([0, 0, 5]), np.array([1, 7, 3]))), shape=(9, 11)),
    "block-elas2d": lambda: _block_rows("elas2d"),
    "block-elas3d": lambda: _block_rows("elas3d"),
    "block-random": lambda: _block_rows("random"),
}


@pytest.mark.parametrize("shape", sorted(ELL_SHAPES))
def test_ell_spmv_matches_scipy(shape):
    M = ELL_SHAPES[shape]().tocsr()
    M.data = M.data.astype(np.float32).astype(np.float64)
    E = csr_to_ell(M, pad_multiple=2048)
    assert isinstance(E, EllMatrix) and E.n_pad % 2048 == 0
    rng = np.random.default_rng(3)
    x = _vec(rng, M.shape[1], max(M.shape[1], 1))
    y = np.asarray(jax.jit(lambda v: E.spmv(v))(jnp.asarray(x)))
    assert y.shape == (E.n_pad,)
    assert not np.any(y[M.shape[0]:])            # padding rows stay zero
    xs = x.astype(np.float64)
    _assert_rows(y[: M.shape[0]], M @ xs, abs(M) @ np.abs(xs),
                 np.diff(M.indptr))


def test_ell_skewed_r0_loop_path(monkeypatch):
    """The degree-skewed aggressive-coarsening R0 gives the same answer
    through the bounded-memory loop path as through the one-shot gather
    (the loop path takes over above _ELL_GATHER_MAX_BYTES)."""
    R = _flagship_transfers().R.tocsr()
    deg = np.diff(R.indptr)
    assert deg.max() > 1.2 * deg.mean()      # rows padded to the longest
    E = csr_to_ell(R)
    x = jnp.asarray(np.random.default_rng(5).standard_normal(
        R.shape[1]).astype(np.float32))
    y_one = np.asarray(E.spmv(x))
    monkeypatch.setattr(formats, "_ELL_GATHER_MAX_BYTES", 0)
    y_loop = np.asarray(jax.jit(lambda v: E.spmv(v))(x))
    np.testing.assert_allclose(y_loop, y_one, rtol=1e-5, atol=1e-6)
