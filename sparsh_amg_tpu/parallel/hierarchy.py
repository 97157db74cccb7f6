"""Distributed device hierarchy (SURVEY.md §2 C21/C23/C24).

The reference's multi-GPU mode keeps every AMG level row-partitioned across
MPI ranks, with per-level comm packages and idle ranks on tiny coarse
grids.  Here every level is row-partitioned over the same 1-D mesh
(Partition with identical padded blocks), smoother vectors are stacked with
a leading shard axis, and the coarsest level is *agglomerated*: its dense
inverse is pre-split row-wise so each shard computes its slice of
``A_c^-1 (all_gather r_c)`` — the collective form of the reference's
"gather small coarse grids onto fewer processors" strategy (C24).

All stacked arrays use leading axis nd; ``local(tree)`` (= leaf[0] inside
shard_map) turns the stacked hierarchy into the per-shard one.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..params import AMGParams
from ..ops import df64
from ..ops.formats import HIGHEST
from ..setup.hierarchy import Hierarchy
from ..solve.device import (lambda_max_estimate, abs_row_sum,
                            dense_inverse, DeviceLevel)
from .partition import Partition, _round_up as _round_up_raw
from .dist import DistDia, DistEll, csr_to_dist, GatherOut, ReplSrc


def _round_up_128(x: int) -> int:
    return _round_up_raw(x, 128)


@partial(jax.tree_util.register_dataclass,
         data_fields=["A_hi", "lo"], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class DistDf64:
    """Distributed df64 operator: A = A_hi + lo, lo sharing A_hi's layout
    (see ops/df64_ops.py for the serial twin)."""
    A_hi: object              # DistDia | DistEll (fp32)
    lo: jax.Array | None      # same shape as A_hi.bands / A_hi.vals;
                              # None when every entry is fp32-exact

    def _mul(self, d, a_hi, x_hi, x_lo):
        if self.lo is None:
            return df64.mul_f32(x_hi, x_lo, a_hi)
        return df64.mul(a_hi, self.lo[d], x_hi, x_lo)

    def spmv_df64(self, x_hi, x_lo):
        A = self.A_hi
        from .dist import halo_exchange
        if isinstance(A, DistDia):
            eh = halo_exchange(x_hi, A.h, A.nd, A.axis)
            el = halo_exchange(x_lo, A.h, A.nd, A.axis)
            n_loc = A.n_loc
            y_hi = jnp.zeros(n_loc, dtype=x_hi.dtype)
            y_lo = jnp.zeros(n_loc, dtype=x_hi.dtype)
            for d, off in enumerate(A.offsets):
                sh = jax.lax.dynamic_slice(eh, (A.h + off,), (n_loc,))
                sl = jax.lax.dynamic_slice(el, (A.h + off,), (n_loc,))
                p_hi, p_lo = self._mul(d, A.bands[d], sh, sl)
                y_hi, y_lo = df64.add(y_hi, y_lo, p_hi, p_lo)
            return y_hi, y_lo
        assert isinstance(A, DistEll)
        if A.mode == "halo":
            sh_src = halo_exchange(x_hi, A.h, A.nd, A.axis)
            sl_src = halo_exchange(x_lo, A.h, A.nd, A.axis)
        else:
            sh_src = jax.lax.all_gather(x_hi, A.axis, tiled=True)
            sl_src = jax.lax.all_gather(x_lo, A.axis, tiled=True)
        y_hi = jnp.zeros(A.n_loc, dtype=x_hi.dtype)
        y_lo = jnp.zeros(A.n_loc, dtype=x_hi.dtype)
        for k in range(A.k):
            gh = sh_src.at[A.cols[k]].get(mode="promise_in_bounds")
            gl = sl_src.at[A.cols[k]].get(mode="promise_in_bounds")
            p_hi, p_lo = self._mul(k, A.vals[k], gh, gl)
            y_hi, y_lo = df64.add(y_hi, y_lo, p_hi, p_lo)
        return y_hi, y_lo

    def residual_df64(self, b_hi, b_lo, x_hi, x_lo):
        ax_hi, ax_lo = self.spmv_df64(x_hi, x_lo)
        return df64.sub(b_hi, b_lo, ax_hi, ax_lo)


@partial(jax.tree_util.register_dataclass,
         data_fields=["A", "dinv", "l1_dinv", "lam_max", "P", "R",
                      "coarse_inv", "L", "U"],
         meta_fields=["n", "axis", "coarse_sweeps"])
@dataclasses.dataclass(frozen=True)
class DistLevel:
    """One distributed level.  Field names mirror solve.device.DeviceLevel
    so the serial smoothers/cycles apply unchanged inside shard_map."""
    A: object                  # DistDia | DistEll
    dinv: jax.Array            # (nd, n_loc) stacked / (n_loc,) local
    l1_dinv: jax.Array
    lam_max: jax.Array         # (nd,) stacked / scalar local
    P: object | None           # DistEll coarse->fine (None on coarsest)
    R: object | None           # DistEll fine->coarse
    coarse_inv: jax.Array | None  # (nd, n_loc, ncp) row-slice of A_c^-1
    L: object | None = None    # strict lower triangle (two-stage GS)
    U: object | None = None    # strict upper triangle
    n: int = 0
    axis: str = "rows"
    coarse_sweeps: int = 16    # l1-Jacobi sweeps when coarse_inv is None

    def coarse_solve(self, b_loc: jax.Array) -> jax.Array:
        """x_loc = (A_c^-1 b)_loc: all_gather b, multiply the local row
        slice of the dense inverse (reference C17 + C24
        agglomeration).  Falls back to params.coarse_smooth_sweeps of
        l1-Jacobi when no dense inverse was built."""
        if self.coarse_inv is None:
            from ..solve.smoothers import l1_jacobi
            return l1_jacobi(self, b_loc, jnp.zeros_like(b_loc),
                             sweeps=self.coarse_sweeps, zero_start=True)
        b_full = jax.lax.all_gather(b_loc, self.axis, tiled=True)
        return jnp.dot(self.coarse_inv, b_full, precision=HIGHEST,
                       preferred_element_type=b_loc.dtype)


@dataclasses.dataclass(frozen=True)
class DistHierarchy:
    levels: tuple              # tuple[DistLevel, ...] (stacked arrays)
    parts: tuple               # tuple[Partition, ...] per level
    nd: int
    axis: str

    @property
    def n_levels(self) -> int:
        return len(self.levels)


def local(tree):
    """Stacked -> per-shard view inside shard_map (leading axis is 1)."""
    return jax.tree.map(lambda a: a[0], tree)


def _stack_vec(part: Partition, v: np.ndarray, dtype) -> jnp.ndarray:
    return jnp.asarray(part.pad_vec(v), dtype=dtype)


def _stack_full(arr, nd: int, dtype=None):
    """Replicate a host array across the stacked leading shard axis."""
    a = np.broadcast_to(np.asarray(arr), (nd,) + np.shape(arr))
    return jnp.asarray(np.ascontiguousarray(a), dtype=dtype)


def _replicated_level(lev, part: Partition, next_part: Partition | None,
                      params: AMGParams, dtype, bdtype, nd: int,
                      is_coarsest: bool) -> DeviceLevel:
    """Build a level in REPLICATED form: a serial DeviceLevel whose arrays
    carry a stacked leading nd axis (identical copies, one per shard).
    Inside shard_map its smoothers/transfers run with zero collectives —
    the reference's 'gather small coarse grids onto fewer processors'
    (C24).  Vector length == part.n_pad so the GatherOut all_gather at
    the boundary lines up exactly."""
    from ..ops.formats import csr_to_device, csr_to_ell
    import jax.tree as jtree
    A = lev.A
    n = A.shape[0]
    L_pad = part.n_pad
    dev_A = csr_to_device(A, dtype=bdtype, prefer_dia=params.prefer_dia,
                          dia_max_bands=params.dia_max_bands,
                          dense_size=params.dense_size, pad_multiple=L_pad)
    d = A.diagonal()
    dinv = np.zeros(L_pad)
    dinv[:n] = np.where(d != 0, 1.0 / d, 0.0)
    absrow = abs_row_sum(A)
    l1d = d + (absrow - np.abs(d))
    l1_dinv = np.zeros(L_pad)
    l1_dinv[:n] = np.where(l1d != 0, 1.0 / l1d, 0.0)
    lam = lambda_max_estimate(A, d, absrow, params.lambda_max) \
        if not is_coarsest or n > 1 else 1.0

    P = R = coarse_inv = None
    if not is_coarsest:
        nc = lev.P.shape[1]
        M_pad = next_part.n_pad
        if max(n, nc) <= params.dense_size:
            from ..ops.formats import csr_to_dense
            # tight dense blocks; spmv re-pads to the level vector lengths
            P = csr_to_dense(lev.P.tocsr(), dtype=bdtype, out_pad=L_pad,
                             in_pad=M_pad)
            R = csr_to_dense(lev.R.tocsr(), dtype=bdtype, out_pad=M_pad,
                             in_pad=L_pad)
        else:
            P = csr_to_ell(lev.P, dtype=bdtype, pad_multiple=L_pad)
            R = csr_to_ell(lev.R, dtype=bdtype, pad_multiple=M_pad)
    elif n <= params.coarse_inv_max and params.coarse_solver != "smooth":
        # tight 256-pad (not L_pad); DeviceLevel.coarse_solve slices/pads
        from ..ops.formats import _round_up
        r = min(_round_up(max(n, 1), 256), L_pad)
        dense = np.zeros((r, r), dtype=np.float32)
        dense[:n, :n] = dense_inverse(A, params.coarse_solver)
        coarse_inv = jnp.asarray(dense, dtype=dtype)

    Lt = Ut = None
    if params.smoother == "gs2" and coarse_inv is None:
        conv = lambda T: csr_to_device(
            T.tocsr(), dtype=bdtype, prefer_dia=params.prefer_dia,
            dia_max_bands=params.dia_max_bands,
            dense_size=params.dense_size, pad_multiple=L_pad)
        Lt = conv(sp.tril(A, -1))
        Ut = conv(sp.triu(A, 1))

    serial = DeviceLevel(
        A=dev_A,
        dinv=jnp.asarray(dinv, dtype=dtype),
        l1_dinv=jnp.asarray(l1_dinv, dtype=dtype),
        lam_max=jnp.asarray(lam, dtype=dtype),
        P=P, R=R, coarse_inv=coarse_inv, L=Lt, U=Ut, n=n,
        coarse_sweeps=params.coarse_smooth_sweeps)
    # stack every leaf with a leading nd axis (device_put shards it into
    # one identical copy per device)
    return jtree.map(lambda a: _stack_full(a, nd, dtype=a.dtype), serial)


def to_dist(hier: Hierarchy, nd: int, params: AMGParams | None = None,
            dtype=None, axis: str = "rows") -> DistHierarchy:
    """Freeze a host hierarchy into the distributed stacked layout.

    Levels with n <= params.replicate_size (never the finest) are stored
    replicated (see _replicated_level); the level above them carries the
    boundary-crossing transfer wrappers GatherOut / ReplSrc.
    """
    params = params or hier.params
    dtype = dtype or jnp.dtype(params.dtype)
    bdtype = jnp.dtype(params.band_dtype)
    # sub-mesh agglomeration (C24 at mesh scale): coarse levels get a
    # shard height of at least sub_mesh_min_rows, concentrating their
    # rows on the leading ceil(n/n_loc) shards (trailing shards are
    # all-padding and contribute zeros to the collectives) — never the
    # finest level
    def mk(n, li):
        part = Partition.make(n, nd,
                              pad_multiple=params.row_align or 128)
        if (li > 0 and params.sub_mesh_min_rows
                and n > params.replicate_size
                and part.n_loc < params.sub_mesh_min_rows):
            part = Partition(n=n, nd=nd, n_loc=_round_up_raw(
                params.sub_mesh_min_rows, max(128, params.row_align)))
        return part
    parts = [mk(lev.A.shape[0], li) for li, lev in enumerate(hier.levels)]
    n_lv = len(hier.levels)
    rep_from = n_lv
    if params.replicate_size > 0:
        for i in range(1, n_lv):
            if hier.levels[i].A.shape[0] <= params.replicate_size:
                rep_from = i
                break
    levels = []
    for li, lev in enumerate(hier.levels):
        A = lev.A
        n = A.shape[0]
        part = parts[li]
        is_coarsest = li == n_lv - 1 or lev.P is None
        if li >= rep_from:
            levels.append(_replicated_level(
                lev, part, parts[li + 1] if not is_coarsest else None,
                params, dtype, bdtype, nd, is_coarsest))
            continue
        dev_A = csr_to_dist(A, part, part, dtype=bdtype, axis=axis,
                            prefer_dia=params.prefer_dia,
                            dia_max_bands=params.dia_max_bands,
                            dense_size=params.dense_size)
        d = A.diagonal()
        dinv = _stack_vec(part, np.where(d != 0, 1.0 / d, 0.0), dtype)
        absrow = abs_row_sum(A)
        l1d = d + (absrow - np.abs(d))
        l1_dinv = _stack_vec(part, np.where(l1d != 0, 1.0 / l1d, 0.0), dtype)
        lam = lambda_max_estimate(A, d, absrow, params.lambda_max) \
            if not is_coarsest or n > 1 else 1.0
        lam_max = jnp.full((nd,), lam, dtype=dtype)

        P = R = coarse_inv = None
        if not is_coarsest:
            cpart = parts[li + 1]
            nc = lev.P.shape[1]
            pr_dense = params.dense_size if max(n, nc) <= params.dense_size \
                else 0
            if li + 1 >= rep_from:
                # replication boundary: R all_gathers its distributed
                # product; P consumes the already-full coarse vector
                # (gather-mode column indexing, no collective)
                R = GatherOut(op=csr_to_dist(
                    lev.R, cpart, part, dtype=bdtype, axis=axis,
                    prefer_dia=False, dense_size=pr_dense), axis=axis)
                P = ReplSrc(op=csr_to_dist(
                    lev.P, part, cpart, dtype=bdtype, axis=axis,
                    prefer_dia=False, dense_size=pr_dense,
                    max_halo_frac=-1.0))   # force gather-mode indexing
            else:
                P = csr_to_dist(lev.P, part, cpart, dtype=bdtype, axis=axis,
                                prefer_dia=False, dense_size=pr_dense)
                R = csr_to_dist(lev.R, cpart, part, dtype=bdtype, axis=axis,
                                prefer_dia=False, dense_size=pr_dense)
        elif n <= params.coarse_inv_max and params.coarse_solver != "smooth":
            ncp = part.n_pad
            dense = np.zeros((ncp, ncp), dtype=np.float32)
            dense[:n, :n] = dense_inverse(A, params.coarse_solver)
            # fp32 always, not band_dtype (see solve.device.to_device)
            coarse_inv = jnp.asarray(
                dense.reshape(nd, part.n_loc, ncp), dtype=dtype)

        L = U = None
        if params.smoother == "gs2" and coarse_inv is None:
            conv = lambda T: csr_to_dist(
                T.tocsr(), part, part, dtype=bdtype, axis=axis,
                prefer_dia=params.prefer_dia,
                dia_max_bands=params.dia_max_bands,
                dense_size=params.dense_size)
            L = conv(sp.tril(A, -1))
            U = conv(sp.triu(A, 1))

        levels.append(DistLevel(
            A=dev_A, dinv=dinv, l1_dinv=l1_dinv, lam_max=lam_max,
            P=P, R=R, coarse_inv=coarse_inv, L=L, U=U, n=n, axis=axis,
            coarse_sweeps=params.coarse_smooth_sweeps))
    return DistHierarchy(levels=tuple(levels), parts=tuple(parts), nd=nd,
                         axis=axis)


def fine_df64(hier: Hierarchy, dist: DistHierarchy, params: AMGParams,
              axis: str = "rows") -> DistDf64:
    """df64 fine-level operator for distributed iterative refinement."""
    A = hier.levels[0].A
    part = dist.parts[0]
    A_hi_host = A.copy()
    A_hi_host.data = A.data.astype(np.float32).astype(np.float64)
    lo_host = A.copy()
    lo_host.data = A.data - A_hi_host.data
    A_hi = csr_to_dist(A_hi_host, part, part, dtype=jnp.float32, axis=axis,
                       prefer_dia=params.prefer_dia,
                       dia_max_bands=params.dia_max_bands)
    if not lo_host.data.any():     # every entry fp32-exact -> drop lo
        return DistDf64(A_hi=A_hi, lo=None)
    lo_dev = csr_to_dist(lo_host, part, part, dtype=jnp.float32, axis=axis,
                         prefer_dia=params.prefer_dia,
                         dia_max_bands=params.dia_max_bands)
    if isinstance(A_hi, DistDia):
        assert isinstance(lo_dev, DistDia) and lo_dev.offsets == A_hi.offsets
        return DistDf64(A_hi=A_hi, lo=lo_dev.bands)
    assert isinstance(lo_dev, DistEll) and lo_dev.vals.shape == A_hi.vals.shape
    return DistDf64(A_hi=A_hi, lo=lo_dev.vals)
