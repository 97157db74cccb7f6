"""Process-local device freeze of a BlockedHierarchy (VERDICT r3 next
#1/#6; SURVEY.md §3.5 per-rank H2D).

`to_dist` (parallel/hierarchy.py) freezes a GLOBAL host hierarchy into
stacked (nd, ...) device layouts — every process must hold the global
matrix.  This module is its process-local twin: each rank freezes only
ITS OWN row blocks (the dpp = nd / n_procs device shards it feeds) from
a per-rank :class:`~..setup.blocked.BlockedHierarchy`, agreeing on the
shared static metadata (DIA offsets, ELL K/halo widths, Chebyshev
lambda_max) through the same :class:`~..setup.comm.BlockComm` the
blocked setup used.  The per-shard blocks are
BIT-IDENTICAL to what the global `csr_to_dist` builds — asserted in
tests/test_blocked_dist.py — so the solve is numerically identical to
the single-process path while no rank ever materializes a global
matrix, hierarchy, or O(n) vector (the replicated coarse tail is tiny
by construction).

Upload happens through :func:`put_local_stacked`: each process passes
its (dpp, ...) local stack and `jax.make_array_from_callback` serves
only addressable shards — the multi-process-safe sibling of
`put_sharded` that never forms the host-global array.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..params import AMGParams
from ..setup.blocked import BlockedHierarchy
from ..setup.comm import BlockComm
from ..solve.device import abs_row_sum
from .partition import Partition, _round_up
from .dist import DistDia, DistEll, DistDense, GatherOut, ReplSrc
from .hierarchy import DistLevel, DistDf64, DistHierarchy, _replicated_level

_I64 = np.int64


# ---------------------------------------------------------------------------
# Small per-block helpers
# ---------------------------------------------------------------------------

def _rows_of_nnz(A: sp.csr_matrix) -> np.ndarray:
    return np.repeat(np.arange(A.shape[0], dtype=_I64), np.diff(A.indptr))


def block_diag(A_own: sp.csr_matrix, r0: int) -> np.ndarray:
    """Diagonal entries of a row-block CSR with global columns (the
    diagonal of local row i sits at column r0 + i)."""
    rows = _rows_of_nnz(A_own)
    mask = A_own.indices == (rows + r0)
    d = np.zeros(A_own.shape[0], dtype=np.float64)
    d[rows[mask]] = A_own.data[mask]
    return d


def block_tri(A_own: sp.csr_matrix, r0: int, upper: bool) -> sp.csr_matrix:
    """Strict upper/lower triangle of a row-block CSR with global
    columns (scipy's tril/triu compare against LOCAL row ids)."""
    rows = _rows_of_nnz(A_own) + r0
    keep = (A_own.indices > rows) if upper else (A_own.indices < rows)
    out = sp.csr_matrix(
        (A_own.data[keep], A_own.indices[keep],
         np.concatenate([[0], np.cumsum(
             np.bincount(rows - r0, weights=keep,
                         minlength=A_own.shape[0])).astype(_I64)])),
        shape=A_own.shape)
    return out


def _pad_rows(v_own: np.ndarray, dpp: int, n_loc: int) -> np.ndarray:
    """(n_own,) owned-row values -> (dpp, n_loc) local padded stack."""
    out = np.zeros(dpp * n_loc, dtype=v_own.dtype)
    out[: v_own.shape[0]] = v_own
    return out.reshape(dpp, n_loc)


def lambda_max_blocked(A_own: sp.csr_matrix, r0: int, n: int,
                       d_own: np.ndarray, absrow_own: np.ndarray,
                       comm: BlockComm, method: str = "hybrid") -> float:
    """Distributed lambda_max(D^-1 A) upper bound, numerically identical
    to `solve.device.lambda_max_estimate` on the assembled matrix:
    Gershgorin is an allreduce_max of the local row ratios; the hybrid
    power refinement (n <= 2^20 only, so the gathered iterate is <= 8 MB)
    runs the same row-wise recurrence with per-iteration allgather of
    the owned output rows — same values in the same order, bitwise."""
    from ..solve.device import _POWER_MAX_N
    with np.errstate(divide="ignore", invalid="ignore"):
        ratios = np.where(d_own != 0, absrow_own / np.abs(d_own), 0.0)
    g_loc = float(ratios.max()) if ratios.size else 0.0
    g = float(comm.allreduce_max(g_loc))
    if g <= 0.0 or not np.isfinite(g):
        g = 1.0
    if method == "gershgorin":
        return g
    if method != "power" and n > _POWER_MAX_N:
        return g
    p = _power_blocked(A_own, d_own, n, comm)
    return p if method == "power" else min(p, g)


def _power_blocked(A_own: sp.csr_matrix, d_own: np.ndarray, n: int,
                   comm: BlockComm, iters: int = 20,
                   seed: int = 0) -> float:
    """Blocked twin of `solve.device._lambda_max_dinv_a`: every rank
    holds the same seeded global iterate (n <= 2^20), computes its owned
    rows of D^-1 A v, and the allgather reassembles the global vector in
    rank order — bit-identical norms."""
    dinv = np.where(d_own != 0, 1.0 / d_own, 0.0)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v) + 1e-30
    lam = 1.0
    for _ in range(iters):
        w_own = dinv * (A_own @ v)
        w = np.concatenate(comm.allgather(w_own))
        lam = float(np.linalg.norm(w))
        if lam == 0.0:
            return 1.0
        v = w / lam
    return lam * 1.05


def gather_csr(comm: BlockComm, A_own: sp.csr_matrix) -> sp.csr_matrix:
    """Assemble the (small) global CSR from every rank's row block —
    used only for matrices at/below the dense/replication thresholds."""
    blocks = comm.allgather((A_own.indptr, A_own.indices, A_own.data,
                             A_own.shape))
    rows = sum(b[3][0] for b in blocks)
    indptr = np.zeros(rows + 1, dtype=_I64)
    off = 0
    for ip, _, _, shp in blocks:
        indptr[off + 1: off + shp[0] + 1] = indptr[off] + ip[1:]
        off += shp[0]
    return sp.csr_matrix(
        (np.concatenate([b[2] for b in blocks]),
         np.concatenate([b[1] for b in blocks]),
         indptr), shape=(rows, blocks[0][3][1]))


# ---------------------------------------------------------------------------
# Process-local csr_to_dist
# ---------------------------------------------------------------------------

def csr_rows_to_dist(A_own: sp.csr_matrix, r0: int, part_dst: Partition,
                     part_src: Partition, comm: BlockComm, d0: int,
                     dpp: int, dtype=jnp.float32, axis: str = "rows",
                     prefer_dia: bool = True, dia_max_bands: int = 32,
                     max_halo_frac: float = 1.0, dense_size: int = 0,
                     as_numpy: bool = False):
    """Process-local `parallel.dist.csr_to_dist`: freeze the owned row
    block (global columns) into the SAME distributed layout the global
    builder picks, with the format decision and all static metadata
    agreed through `comm`.  Data arrays carry a LOCAL leading axis dpp
    (this rank's shards d0..d0+dpp-1) instead of nd; everything else —
    including per-shard bit patterns — matches the global build.

    ``as_numpy`` keeps the stacked data as host numpy (tests compare
    against the global build without device round-trips)."""
    nd = part_dst.nd
    n, m = int(part_dst.n), int(part_src.n)
    assert A_own.shape[1] == m
    nl_d, nl_s = part_dst.n_loc, part_src.n_loc
    assert r0 == min(d0 * nl_d, n), "rank rows must align to its shards"
    n_own = A_own.shape[0]
    jnp_ = (lambda a, dtype=None: np.asarray(a, dtype=dtype)) if as_numpy \
        else jnp.asarray

    nnz_g = int(comm.allreduce_sum(int(A_own.nnz)))

    if dense_size and n <= dense_size and m <= dense_size:
        A = gather_csr(comm, A_own)
        dense = np.zeros((part_dst.n_pad, part_src.n_pad))
        dense[:n, :m] = A.toarray()
        sl = dense.reshape(nd, nl_d, part_src.n_pad)[d0:d0 + dpp]
        return DistDense(mat=jnp_(np.ascontiguousarray(sl), dtype=dtype),
                         nd=nd, axis=axis, n_rows=n, n_cols=m)

    rows_g = _rows_of_nnz(A_own) + r0
    cols = A_own.indices.astype(_I64)
    data = A_own.data

    same_part = (n == m and nl_d == nl_s)
    if prefer_dia and same_part and nnz_g > 0:
        offs_loc = np.unique(cols - rows_g)
        offs = np.unique(np.concatenate(comm.allgather(offs_loc))) \
            if comm.size > 1 else offs_loc
        maxoff = int(np.abs(offs).max()) if len(offs) else 0
        h = _round_up(maxoff, 128) if maxoff else 0
        if (len(offs) <= dia_max_bands and h <= max_halo_frac * nl_s
                and len(offs) * n <= 4 * nnz_g):
            bands = np.zeros((dpp, len(offs), nl_d), dtype=np.float64)
            pos = np.searchsorted(offs, cols - rows_g)
            s_idx, r_loc = np.divmod(rows_g, nl_d)
            bands[s_idx - d0, pos, r_loc] = data
            return DistDia(bands=jnp_(bands, dtype=dtype),
                           offsets=tuple(int(o) for o in offs), h=h,
                           nd=nd, axis=axis, n_rows=n, n_cols=m)

    nnz_per_row = np.diff(A_own.indptr)
    K_loc = int(nnz_per_row.max()) if n_own > 0 and A_own.nnz else 0
    K = max(int(comm.allreduce_max(K_loc)), 1)
    s_idx, r_loc = np.divmod(rows_g, nl_d)
    t_idx, c_loc = np.divmod(cols, nl_s)

    d = t_idx - s_idx
    ok_loc = bool(np.all(np.abs(d) <= 1)) if len(d) else True
    feasible = nnz_g > 0 and \
        bool(comm.allreduce_sum(int(not ok_loc)) == 0)
    if feasible:
        h_r = int((c_loc[d == 1] + 1).max()) if np.any(d == 1) else 0
        h_l = int((nl_s - c_loc[d == -1]).max()) if np.any(d == -1) else 0
        h_r = int(comm.allreduce_max(h_r))
        h_l = int(comm.allreduce_max(h_l))
        h = _round_up(max(h_r, h_l), 128) if (h_r or h_l) else 0
    else:
        h = nl_s + 1
    mode = "halo" if h <= max_halo_frac * nl_s else "gather"

    if mode == "halo":
        ext = np.where(d == 0, h + c_loc,
                       np.where(d == 1, h + nl_s + c_loc,
                                c_loc - (nl_s - h)))
        fill = h
    else:
        ext = cols
        fill = 0
        h = 0

    slot = np.arange(A_own.nnz, dtype=_I64) - np.repeat(
        A_own.indptr[:-1].astype(_I64), nnz_per_row)
    cols_arr = np.full((dpp, K, nl_d), fill, dtype=np.int32)
    vals_arr = np.zeros((dpp, K, nl_d), dtype=np.float64)
    cols_arr[s_idx - d0, slot, r_loc] = ext
    vals_arr[s_idx - d0, slot, r_loc] = data
    return DistEll(cols=jnp_(cols_arr), vals=jnp_(vals_arr, dtype=dtype),
                   h=int(h), nd=nd, axis=axis, mode=mode, n_rows=n,
                   n_cols=m)


# ---------------------------------------------------------------------------
# Hierarchy freeze + df64 fine operator
# ---------------------------------------------------------------------------

def blocked_to_dist(bh: BlockedHierarchy, nd: int, comm: BlockComm,
                    params: AMGParams | None = None, dtype=None,
                    axis: str = "rows", as_numpy: bool = False
                    ) -> DistHierarchy:
    """Freeze a per-rank BlockedHierarchy into the distributed stacked
    layout — the process-local twin of `to_dist`.  Blocked levels become
    DistLevels with LOCAL (dpp-leading) data stacks; the gathered coarse
    tail becomes replicated levels exactly as the global path replicates
    everything at/below params.replicate_size.  Upload the result with
    :func:`put_local_stacked`."""
    params = params or bh.params
    dtype = dtype or jnp.dtype(params.dtype)
    bdtype = jnp.dtype(params.band_dtype)
    assert nd % comm.size == 0
    dpp = nd // comm.size
    d0 = comm.rank * dpp
    blk = bh.levels
    tail = bh.tail
    assert blk, "no blocked levels (problem below the blocked threshold)"
    ns = [l.n for l in blk] + [lev.A.shape[0] for lev in tail.levels]
    parts = [Partition.make(n, nd, pad_multiple=params.row_align or 128)
             for n in ns]
    # the split must reproduce to_dist's replicate_size boundary: every
    # tail level replicated, every blocked level distributed
    assert all(l.n > params.replicate_size for l in blk)
    assert tail.levels[0].A.shape[0] <= params.replicate_size
    n_blk = len(blk)
    levels = []
    for li, bl in enumerate(blk):
        part = parts[li]
        assert bl.r0 == min(d0 * part.n_loc, bl.n), \
            "blocked level not aligned to the device partition " \
            "(build with bounds_fn=partition_bounds)"
        A_own = bl.A
        conv = lambda M, r0_, pd, ps, **kw: csr_rows_to_dist(
            M, r0_, pd, ps, comm, d0, dpp, dtype=bdtype, axis=axis,
            as_numpy=as_numpy, **kw)
        dev_A = conv(A_own, bl.r0, part, part,
                     prefer_dia=params.prefer_dia,
                     dia_max_bands=params.dia_max_bands,
                     dense_size=params.dense_size)
        d_own = block_diag(A_own, bl.r0)
        absrow_own = abs_row_sum(A_own)
        jnp_ = (lambda a, dtype=None: np.asarray(a, dtype=dtype)) \
            if as_numpy else jnp.asarray
        dinv = jnp_(_pad_rows(np.where(d_own != 0, 1.0 / d_own, 0.0),
                              dpp, part.n_loc), dtype=dtype)
        l1d = d_own + (absrow_own - np.abs(d_own))
        l1_dinv = jnp_(_pad_rows(np.where(l1d != 0, 1.0 / l1d, 0.0),
                                 dpp, part.n_loc), dtype=dtype)
        lam = lambda_max_blocked(A_own, bl.r0, bl.n, d_own, absrow_own,
                                 comm, params.lambda_max)
        lam_max = jnp_(np.full((dpp,), lam), dtype=dtype)

        cpart = parts[li + 1]
        nc = bl.P.shape[1]
        pr_dense = params.dense_size \
            if max(bl.n, nc) <= params.dense_size else 0
        c0 = min(d0 * cpart.n_loc, nc)
        if li + 1 >= n_blk:
            # replication boundary into the gathered tail
            R = GatherOut(op=conv(bl.R, c0, cpart, part,
                                  prefer_dia=False, dense_size=pr_dense),
                          axis=axis)
            Pp = ReplSrc(op=conv(bl.P, bl.r0, part, cpart,
                                 prefer_dia=False, dense_size=pr_dense,
                                 max_halo_frac=-1.0))
        else:
            Pp = conv(bl.P, bl.r0, part, cpart, prefer_dia=False,
                      dense_size=pr_dense)
            R = conv(bl.R, c0, cpart, part, prefer_dia=False,
                     dense_size=pr_dense)

        L = U = None
        if params.smoother == "gs2":
            tri = lambda up: conv(block_tri(A_own, bl.r0, up), bl.r0,
                                  part, part,
                                  prefer_dia=params.prefer_dia,
                                  dia_max_bands=params.dia_max_bands,
                                  dense_size=params.dense_size)
            L = tri(False)
            U = tri(True)

        levels.append(DistLevel(
            A=dev_A, dinv=dinv, l1_dinv=l1_dinv, lam_max=lam_max,
            P=Pp, R=R, coarse_inv=None, L=L, U=U, n=bl.n, axis=axis,
            coarse_sweeps=params.coarse_smooth_sweeps))

    n_tail = len(tail.levels)
    for ti, lev in enumerate(tail.levels):
        li = n_blk + ti
        is_coarsest = ti == n_tail - 1 or lev.P is None
        levels.append(_replicated_level(
            lev, parts[li], parts[li + 1] if not is_coarsest else None,
            params, dtype, bdtype, dpp, is_coarsest))
    return DistHierarchy(levels=tuple(levels), parts=tuple(parts), nd=nd,
                         axis=axis)


def fine_df64_blocked(A_own: sp.csr_matrix, r0: int, part: Partition,
                      comm: BlockComm, params: AMGParams, d0: int,
                      dpp: int, axis: str = "rows",
                      as_numpy: bool = False) -> DistDf64:
    """Process-local twin of `fine_df64`: hi/lo split of the owned fine
    rows (see ops/df64_ops.py)."""
    A_hi_host = A_own.copy()
    A_hi_host.data = A_own.data.astype(np.float32).astype(np.float64)
    lo_host = A_own.copy()
    lo_host.data = A_own.data - A_hi_host.data
    conv = lambda M: csr_rows_to_dist(
        M, r0, part, part, comm, d0, dpp, dtype=jnp.float32, axis=axis,
        prefer_dia=params.prefer_dia, dia_max_bands=params.dia_max_bands,
        as_numpy=as_numpy)
    A_hi = conv(A_hi_host)
    lo_any = bool(comm.allreduce_sum(int(bool(lo_host.data.any()))))
    if not lo_any:
        return DistDf64(A_hi=A_hi, lo=None)
    lo_dev = conv(lo_host)
    if isinstance(A_hi, DistDia):
        assert isinstance(lo_dev, DistDia) and lo_dev.offsets == A_hi.offsets
        return DistDf64(A_hi=A_hi, lo=lo_dev.bands)
    assert isinstance(lo_dev, DistEll) and lo_dev.vals.shape == A_hi.vals.shape
    return DistDf64(A_hi=A_hi, lo=lo_dev.vals)


def slice_to_blocked(hier, rank: int, nd: int, n_procs: int,
                     params: AMGParams | None = None) -> BlockedHierarchy:
    """Slice a GLOBAL Hierarchy into one rank's BlockedHierarchy view
    (partition-aligned row blocks; levels above params.replicate_size
    blocked, the rest the replicated tail).  The migration/test bridge:
    `blocked_to_dist(slice_to_blocked(H, r, ...))` must equal the global
    `to_dist(H, ...)` shard-for-shard, bitwise."""
    from ..setup.blocked import BlockedLevel, partition_bounds
    from ..setup.hierarchy import Hierarchy
    params = params or hier.params
    levels = []
    li = 0
    align = params.row_align
    while (li < hier.n_levels - 1 and hier.levels[li].P is not None
           and hier.levels[li].n > params.replicate_size):
        lev = hier.levels[li]
        n = lev.n
        bounds = partition_bounds(n, nd, n_procs, align=align)
        r0, r1 = int(bounds[rank]), int(bounds[rank + 1])
        nc = lev.P.shape[1]
        bounds_c = partition_bounds(nc, nd, n_procs, align=align)
        c0, c1 = int(bounds_c[rank]), int(bounds_c[rank + 1])
        levels.append(BlockedLevel(
            A=lev.A[r0:r1].tocsr(), r0=r0, r1=r1, n=n, bounds=bounds,
            P=lev.P[r0:r1].tocsr(), R=lev.R[c0:c1].tocsr(),
            cf=lev.cf[r0:r1] if lev.cf is not None else None))
        li += 1
    tail = Hierarchy(levels=hier.levels[li:], params=params)
    return BlockedHierarchy(levels=levels, tail=tail, params=params)


# ---------------------------------------------------------------------------
# Multi-process-safe local upload
# ---------------------------------------------------------------------------

def put_local_stacked(tree, mesh: Mesh, axis: str, d0: int, dpp: int):
    """Upload a pytree whose leaves are LOCAL (dpp-leading) stacks into
    global (nd-leading) sharded arrays.  Each process serves only its
    addressable shards from its local stack — no process ever forms the
    host-global array (contrast `put_sharded`, which requires it)."""
    nd = mesh.devices.size
    sh = NamedSharding(mesh, P(axis))

    def put_leaf(leaf):
        host = np.asarray(leaf)
        assert host.shape[0] == dpp, (host.shape, dpp)
        gshape = (nd,) + host.shape[1:]

        def cb(idx):
            s = idx[0]
            start = 0 if s.start is None else s.start
            return host[start - d0: (start - d0) + 1]
        return jax.make_array_from_callback(gshape, sh, cb)
    return jax.tree.map(put_leaf, tree)
