"""Distributed sparse operators + collectives (SURVEY.md §3.4, §5.8).

The reference's distributed SpMV is the hypre-ParCSR pattern: post
Irecv/Isend for ghost entries, multiply the local diagonal block while the
wire is busy, then the off-diagonal block (SURVEY.md §3.4).  The JAX
equivalent implemented here:

* ``halo_exchange`` — neighbor `ppermute` of fixed-width boundary slices
  over the mesh axis (contiguous row blocks ⇒ ghost traffic is
  nearest-neighbor; XLA lowers it to NCCL on GPUs).  XLA schedules the collective asynchronously,
  so the local-block FMA work overlaps with it exactly as Isend/Irecv
  overlap in the reference.
* ``DistDia`` / ``DistEll`` — per-shard local operator blocks whose columns
  index an *extended* vector [left-halo | local | right-halo].  Operators
  whose column reach exceeds the immediate neighbors fall back to
  ``all_gather`` of the source vector (only ever hit on tiny coarse levels,
  where the gather is cheap — the analogue of the reference's idle-rank
  coarse handling).
* ``pdot`` — compensated (df64) local dot + `psum` across the axis: the
  reference's MPI_Allreduce.

All classes hold *stacked* arrays with a leading ``nd`` axis on the host /
global side; inside ``shard_map`` each shard sees the leading axis as 1 and
``local()`` squeezes it.  All shapes are uniform across shards (shard_map
requirement), guaranteed by Partition's block == n_loc layout.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..ops import df64
from ..ops.formats import HIGHEST
from .partition import Partition, _round_up


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def halo_exchange(x_loc: jax.Array, h: int, nd: int, axis: str) -> jax.Array:
    """Build the extended vector [left_halo | x_loc | right_halo].

    left_halo  = last h entries of the LEFT neighbor (zeros on shard 0),
    right_halo = first h entries of the RIGHT neighbor (zeros on the last
    shard) — `ppermute` zero-fills absent sources, giving the Dirichlet
    boundary behavior of the reference's halo exchange for free.
    """
    if h == 0:
        return x_loc
    if nd == 1:
        z = jnp.zeros((h,), dtype=x_loc.dtype)
        return jnp.concatenate([z, x_loc, z])
    fwd = [(i, i + 1) for i in range(nd - 1)]
    bwd = [(i + 1, i) for i in range(nd - 1)]
    left = jax.lax.ppermute(x_loc[-h:], axis, fwd)
    right = jax.lax.ppermute(x_loc[:h], axis, bwd)
    return jnp.concatenate([left, x_loc, right])


def pdot(x: jax.Array, y: jax.Array, axis: str, compensated: bool = True):
    """Global inner product: compensated local dot + psum (the reference's
    locally-summed MPI_Allreduce, SURVEY.md §2 C8)."""
    if compensated:
        hi, lo = df64.dot(x, y)
        hi = jax.lax.psum(hi, axis)
        lo = jax.lax.psum(lo, axis)
        return hi + lo
    return jax.lax.psum(jnp.dot(x, y, precision=HIGHEST,
                                preferred_element_type=jnp.float32), axis)


# ---------------------------------------------------------------------------
# Distributed operator types
# ---------------------------------------------------------------------------

@partial(jax.tree_util.register_dataclass,
         data_fields=["bands"],
         meta_fields=["offsets", "h", "nd", "axis", "n_rows", "n_cols"])
@dataclasses.dataclass(frozen=True)
class DistDia:
    """Row-block DIA operator.  bands[s, d, i] = A[row s*n_loc+i,
    col s*n_loc+i+offsets[d]] — offsets stay GLOBAL because block == n_loc
    (partition.py).  SpMV is halo exchange + pure shifted FMAs: the zero-
    gather fast path for stencil levels."""
    bands: jax.Array          # (nd, n_diags, n_loc) stacked; (n_diags, n_loc) local
    offsets: tuple            # static global offsets, |off| <= h
    h: int                    # halo width
    nd: int
    axis: str
    n_rows: int               # logical global rows
    n_cols: int

    @property
    def n_loc(self) -> int:
        return self.bands.shape[-1]

    def local(self) -> "DistDia":
        return dataclasses.replace(self, bands=self.bands[0])

    def spmv(self, x_loc: jax.Array) -> jax.Array:
        """y_loc = (A @ x)_loc; call inside shard_map with local arrays.

        The reference overlaps MPI halo receives with the local-block
        product (SURVEY.md §3.4, hypre-ParCSR).  Same structure here: the
        interior product depends only on x_loc, so XLA schedules it
        concurrently with the neighbor `ppermute`s; the narrow boundary
        corrections (|off| rows per diagonal) consume the halos after."""
        n_loc = self.n_loc
        h, nd, axis = self.h, self.nd, self.axis
        maxoff = max((abs(o) for o in self.offsets), default=0)
        if h == 0 or maxoff == 0:
            ext = halo_exchange(x_loc, h, nd, axis)
            y = jnp.zeros(n_loc, dtype=x_loc.dtype)
            for d, off in enumerate(self.offsets):
                seg = jax.lax.dynamic_slice(ext, (h + off,), (n_loc,))
                y = y + self.bands[d] * seg
            return y
        if nd == 1:
            left = jnp.zeros((h,), dtype=x_loc.dtype)
            right = left
        else:
            fwd = [(i, i + 1) for i in range(nd - 1)]
            bwd = [(i + 1, i) for i in range(nd - 1)]
            left = jax.lax.ppermute(x_loc[-h:], axis, fwd)
            right = jax.lax.ppermute(x_loc[:h], axis, bwd)
        # interior: halo treated as zero — no dependence on the collectives
        xp = jnp.pad(x_loc, (maxoff, maxoff))
        y = jnp.zeros(n_loc, dtype=x_loc.dtype)
        for d, off in enumerate(self.offsets):
            seg = jax.lax.dynamic_slice(xp, (maxoff + off,), (n_loc,))
            y = y + self.bands[d] * seg
        # boundary corrections from the received halos
        for d, off in enumerate(self.offsets):
            if off > 0:
                y = y.at[n_loc - off:].add(
                    self.bands[d, n_loc - off:] * right[:off])
            elif off < 0:
                a = -off
                y = y.at[:a].add(self.bands[d, :a] * left[h - a:])
        return y


@partial(jax.tree_util.register_dataclass,
         data_fields=["cols", "vals"],
         meta_fields=["h", "nd", "axis", "mode", "n_rows", "n_cols"])
@dataclasses.dataclass(frozen=True)
class DistEll:
    """Row-block transposed-ELL operator.

    mode == "halo":   cols index the extended vector (len n_loc + 2h).
    mode == "gather": cols index the all-gathered blocked source
                      (len nd * n_loc_src) — coarse-level fallback.
    Padding slots have val == 0 and col == h (a harmless local position).
    """
    cols: jax.Array           # (nd, K, n_loc) stacked / (K, n_loc) local
    vals: jax.Array
    h: int
    nd: int
    axis: str
    mode: str
    n_rows: int
    n_cols: int

    @property
    def n_loc(self) -> int:
        return self.cols.shape[-1]

    @property
    def k(self) -> int:
        return self.cols.shape[-2]

    def local(self) -> "DistEll":
        return dataclasses.replace(self, cols=self.cols[0],
                                   vals=self.vals[0])

    def spmv(self, x_loc: jax.Array) -> jax.Array:
        from ..ops.formats import _ell_spmv
        if self.mode == "halo":
            src = halo_exchange(x_loc, self.h, self.nd, self.axis)
        else:
            src = jax.lax.all_gather(x_loc, self.axis, tiled=True)
        return _ell_spmv(self.cols, self.vals, src, self.n_loc)


@partial(jax.tree_util.register_dataclass,
         data_fields=["mat"],
         meta_fields=["nd", "axis", "n_rows", "n_cols"])
@dataclasses.dataclass(frozen=True)
class DistDense:
    """Densified small-level operator, row-sliced per shard: each shard
    holds its (n_loc, m_pad_global) slice and multiplies the all-gathered
    source vector (the distributed twin of
    ops.formats.DenseMatrix; agglomeration per SURVEY.md C24)."""
    mat: jax.Array            # (nd, n_loc, m_pad) stacked / (n_loc, m_pad) local
    nd: int
    axis: str
    n_rows: int
    n_cols: int

    @property
    def n_loc(self) -> int:
        return self.mat.shape[-2]

    def local(self) -> "DistDense":
        return dataclasses.replace(self, mat=self.mat[0])

    def spmv(self, x_loc: jax.Array) -> jax.Array:
        x_full = jax.lax.all_gather(x_loc, self.axis, tiled=True)
        return jnp.dot(self.mat, x_full, precision=HIGHEST,
                       preferred_element_type=x_loc.dtype)


def dist_spmv(A, x_loc):
    return A.spmv(x_loc)


# ---------------------------------------------------------------------------
# Replication-boundary wrappers (level-wise agglomeration, SURVEY.md C24:
# "gather small coarse grids onto fewer processors").  Levels below
# params.replicate_size are stored REPLICATED — every shard holds the full
# operator and runs smoothing/transfers locally with zero collectives.
# These two wrappers implement the single distributed<->replicated crossing.
# ---------------------------------------------------------------------------

@partial(jax.tree_util.register_dataclass,
         data_fields=["op"], meta_fields=["axis"])
@dataclasses.dataclass(frozen=True)
class GatherOut:
    """Restriction across the replication boundary: distributed input,
    replicated output — the wrapped dist->dist product followed by ONE
    all_gather (the only collective the replicated region ever costs)."""
    op: object                # DistEll | DistDense (fine-dist -> coarse-dist)
    axis: str

    def local(self):
        return dataclasses.replace(self, op=self.op.local())

    def spmv(self, x_loc: jax.Array) -> jax.Array:
        return jax.lax.all_gather(self.op.spmv(x_loc), self.axis,
                                  tiled=True)


@partial(jax.tree_util.register_dataclass,
         data_fields=["op"], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class ReplSrc:
    """Prolongation across the replication boundary: replicated input,
    distributed output.  The wrapped operator indexes the blocked-global
    source (gather-mode layout), but the input is already full on every
    shard, so NO collective is issued."""
    op: object                # DistEll(mode="gather") | DistDense

    def local(self):
        return dataclasses.replace(self, op=self.op.local())

    def spmv(self, x_full: jax.Array) -> jax.Array:
        if isinstance(self.op, DistDense):
            return jnp.dot(self.op.mat, x_full, precision=HIGHEST,
                           preferred_element_type=x_full.dtype)
        from ..ops.formats import _ell_spmv
        return _ell_spmv(self.op.cols, self.op.vals, x_full, self.op.n_loc)


# ---------------------------------------------------------------------------
# Host-side construction
# ---------------------------------------------------------------------------

def _csr_fields(A: sp.csr_matrix):
    rows = np.repeat(np.arange(A.shape[0], dtype=np.int64),
                     np.diff(A.indptr))
    return rows, A.indices.astype(np.int64), A.data


def csr_to_dist(A: sp.csr_matrix, part_dst: Partition, part_src: Partition,
                dtype=jnp.float32, axis: str = "rows",
                prefer_dia: bool = True, dia_max_bands: int = 32,
                max_halo_frac: float = 1.0, dense_size: int = 0):
    """Freeze a host CSR operator into a distributed device layout.

    ``part_dst`` partitions the rows (output vector), ``part_src`` the
    columns (input vector).  Picks, in order of preference:

    1. DistDia — square stencil structure, same partition both sides,
       bandwidth within the halo budget (zero gathers);
    2. DistEll halo mode — any structure whose columns stay within the
       immediate neighbor shards;
    3. DistEll gather mode — anything else (all_gather of the source).
    """
    nd = part_dst.nd
    assert nd == part_src.nd
    n, m = A.shape
    assert n == part_dst.n and m == part_src.n
    nl_d, nl_s = part_dst.n_loc, part_src.n_loc

    if dense_size and n <= dense_size and m <= dense_size:
        dense = np.zeros((part_dst.n_pad, part_src.n_pad))
        dense[:n, :m] = A.toarray()
        return DistDense(mat=jnp.asarray(
            dense.reshape(nd, nl_d, part_src.n_pad), dtype=dtype),
            nd=nd, axis=axis, n_rows=n, n_cols=m)

    rows, cols, data = _csr_fields(A)

    same_part = (n == m and nl_d == nl_s)
    if prefer_dia and same_part and A.nnz > 0:
        offs = np.unique(cols - rows)
        maxoff = int(np.abs(offs).max()) if len(offs) else 0
        h = _round_up(maxoff, 128) if maxoff else 0
        if (len(offs) <= dia_max_bands and h <= max_halo_frac * nl_s
                and len(offs) * n <= 4 * A.nnz):
            bands = np.zeros((nd, len(offs), nl_d), dtype=np.float64)
            pos = np.searchsorted(offs, cols - rows)
            s_idx, r_loc = np.divmod(rows, nl_d)
            bands[s_idx, pos, r_loc] = data
            return DistDia(bands=jnp.asarray(bands, dtype=dtype),
                           offsets=tuple(int(o) for o in offs), h=h,
                           nd=nd, axis=axis, n_rows=n, n_cols=m)

    # ELL: per-(shard,row) slot layout
    nnz_per_row = np.diff(A.indptr)
    K = max(int(nnz_per_row.max()) if n > 0 else 0, 1)
    s_idx, r_loc = np.divmod(rows, nl_d)
    t_idx, c_loc = np.divmod(cols, nl_s)

    # halo feasibility: every column on shard s-1, s, or s+1
    d = t_idx - s_idx
    if len(d) and np.all(np.abs(d) <= 1):
        # required width: right reach needs h > c_loc; left reach needs
        # h > nl_s - 1 - c_loc (ext position j - (nl_s - h) >= 0)
        h_r = int((c_loc[d == 1] + 1).max()) if np.any(d == 1) else 0
        h_l = int((nl_s - c_loc[d == -1]).max()) if np.any(d == -1) else 0
        h = _round_up(max(h_r, h_l), 128) if (h_r or h_l) else 0
    else:
        h = nl_s + 1  # force gather
    mode = "halo" if h <= max_halo_frac * nl_s else "gather"

    if mode == "halo":
        ext = np.where(d == 0, h + c_loc,
                       np.where(d == 1, h + nl_s + c_loc,
                                c_loc - (nl_s - h)))
        fill = h
    else:
        ext = cols  # blocked global == plain global (block == n_loc)
        fill = 0
        h = 0

    slot = np.arange(A.nnz, dtype=np.int64) - np.repeat(
        A.indptr[:-1].astype(np.int64), nnz_per_row)
    cols_arr = np.full((nd, K, nl_d), fill, dtype=np.int32)
    vals_arr = np.zeros((nd, K, nl_d), dtype=np.float64)
    cols_arr[s_idx, slot, r_loc] = ext
    vals_arr[s_idx, slot, r_loc] = data
    return DistEll(cols=jnp.asarray(cols_arr),
                   vals=jnp.asarray(vals_arr, dtype=dtype),
                   h=int(h), nd=nd, axis=axis, mode=mode, n_rows=n, n_cols=m)
