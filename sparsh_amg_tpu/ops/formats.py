"""Device sparse-matrix layouts and SpMV (SURVEY.md §2 C1, C4/C5).

The reference stores CSR on host and device and runs OpenMP/cuSPARSE SpMV.
Here matrices are frozen at setup time into padded, static layouts whose
SpMV is plain XLA (no hand-written kernels):

* DIA (diagonal): for stencil-structured matrices every nonzero lies on one
  of a few constant offsets ``col - row``; y = sum_d band_d * shift(x, d).
  Pure shifted elementwise FMAs that XLA fuses into one pass — zero
  gathers, memory-bandwidth bound.
* ELL-T (transposed ELLPACK): ``cols``/``vals`` of shape (K, n_pad); row i
  has its nonzeros spread over the K slots (padded with val=0, col=0).
  y = sum_k vals[k] * x[cols[k]] — one (K, n_pad) gather.
* Dense: small coarse levels as one matrix-vector product.

All are registered pytrees so entire hierarchies jit cleanly.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# fp32 matrix-vector products must not run in TF32 on GPUs (about 10
# mantissa bits): every dense product in the solve path asks for full
# fp32 precision explicitly.
HIGHEST = jax.lax.Precision.HIGHEST


@partial(jax.tree_util.register_dataclass,
         data_fields=["bands"], meta_fields=["offsets", "n_rows", "n_cols"])
@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Diagonal storage. bands[d, i] = A[i, i + offsets[d]] (0 outside)."""
    bands: jax.Array          # (n_diags, n_pad)
    offsets: tuple            # static ints, sorted
    n_rows: int
    n_cols: int

    @property
    def n_pad(self) -> int:
        return self.bands.shape[1]

    def spmv(self, x: jax.Array) -> jax.Array:
        """y[i] = sum_d bands[d,i] * x[i + off_d];  x padded to n_pad."""
        n_pad = self.n_pad
        maxoff = max((abs(o) for o in self.offsets), default=0)
        xp = jnp.pad(x, (maxoff, maxoff))
        y = jnp.zeros(n_pad, dtype=x.dtype)
        for d, off in enumerate(self.offsets):
            seg = jax.lax.dynamic_slice(xp, (maxoff + off,), (n_pad,))
            y = y + self.bands[d] * seg
        return y


@partial(jax.tree_util.register_dataclass,
         data_fields=["cols", "vals"], meta_fields=["n_rows", "n_cols"])
@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Transposed-ELL storage: cols/vals (K, n_pad); pad entries val=0,col=0."""
    cols: jax.Array           # (K, n_pad) int32
    vals: jax.Array           # (K, n_pad)
    n_rows: int
    n_cols: int

    @property
    def n_pad(self) -> int:
        return self.cols.shape[1]

    @property
    def k(self) -> int:
        return self.cols.shape[0]

    def spmv(self, x: jax.Array) -> jax.Array:
        """y = sum_k vals[k] * x[cols[k]].  x must have length >= n_cols;
        padding cols point at entry 0 with val 0, so any x works.

        Small K unrolls (lets XLA fuse the whole sum); large K uses a
        fori_loop so coarse levels with hundreds of slots don't explode
        the traced graph / compile time."""
        return _ell_spmv(self.cols, self.vals, x, self.n_pad)


# one-shot gather ceiling: (K, n_pad) fp32 temporary; above this fall back
# to a loop to bound memory
_ELL_GATHER_MAX_BYTES = 512 * 1024 * 1024


def _ell_spmv(cols, vals, x, n_pad, unroll_max: int = 2):
    K = cols.shape[0]
    if K <= unroll_max:
        y = jnp.zeros(n_pad, dtype=x.dtype)
        for k in range(K):
            y = y + vals[k] * x.at[cols[k]].get(mode="promise_in_bounds")
        return y

    if K * n_pad * 4 <= _ELL_GATHER_MAX_BYTES:
        # single (K, n_pad) gather + elementwise + reduce: 3 kernels total
        # regardless of K (vs K sequential gather+fma rounds)
        g = x.at[cols].get(mode="promise_in_bounds")
        return jnp.sum(vals * g, axis=0, dtype=x.dtype)

    def body(k, y):
        c = jax.lax.dynamic_index_in_dim(cols, k, 0, keepdims=False)
        v = jax.lax.dynamic_index_in_dim(vals, k, 0, keepdims=False)
        return y + v * x.at[c].get(mode="promise_in_bounds")

    # seed the carry with the k=0 term (not jnp.zeros) so it carries the
    # same shard_map varying-manual-axes type as the loop body's output
    y0 = vals[0] * x.at[cols[0]].get(mode="promise_in_bounds")
    return jax.lax.fori_loop(1, K, body, y0)


@partial(jax.tree_util.register_dataclass,
         data_fields=["mat"], meta_fields=["n_rows", "n_cols", "out_pad"])
@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Densified small-level operator: spmv is one dense matvec.  Coarse
    AMG levels lose all sparsity structure (SURVEY.md §6: RS coarse
    operators densify); below a size threshold a dense product is both
    faster and compiles O(1) regardless of nnz/row.

    `mat` is padded TIGHT (multiples of 256) rather than to the level
    vector length: level pads are multiples of 2048, and a 2048-padded
    square at a few-k rows is mostly zeros — e.g. a 4.2k-row level padded
    to 6144^2 bf16 is 75 MB vs 37 MB tight.  spmv slices its input to
    mat's columns and zero-pads its output back to `out_pad` (the level
    vector length); both fuse with the surrounding elementwise ops."""
    mat: jax.Array            # (r_pad, c_pad), tight 256-multiples
    n_rows: int
    n_cols: int
    out_pad: int              # level vector length the spmv must emit

    @property
    def n_pad(self) -> int:
        return self.out_pad

    def spmv(self, x: jax.Array) -> jax.Array:
        r, c = self.mat.shape
        y = jnp.dot(self.mat, x[:c], precision=HIGHEST,
                    preferred_element_type=x.dtype)
        if self.out_pad > r:
            y = jnp.pad(y, (0, self.out_pad - r))
        return y


def spmv(A, x: jax.Array) -> jax.Array:
    """Polymorphic SpMV over device layouts."""
    return A.spmv(x)


def residual(A, x: jax.Array, b: jax.Array) -> jax.Array:
    """r = b - A x."""
    return b - A.spmv(x)


# ---------------------------------------------------------------------------
# Host -> device conversion
# ---------------------------------------------------------------------------

def csr_diag_offsets(A: sp.csr_matrix) -> np.ndarray:
    """Distinct values of (col - row) over the nonzeros."""
    rows = np.repeat(np.arange(A.shape[0], dtype=np.int64),
                     np.diff(A.indptr))
    return np.unique(A.indices.astype(np.int64) - rows)


def csr_to_dia(A: sp.csr_matrix, dtype=jnp.float32,
               pad_multiple: int = 128, _pre=None) -> DiaMatrix:
    n, m = A.shape
    assert n == m, "DIA layout requires a square matrix"
    n_pad = _round_up(max(n, 1), pad_multiple)
    if _pre is not None and isinstance(_pre, np.ndarray):
        # native path: _pre is just the sorted offsets; one OpenMP pass
        # fills the fp32 band table (no nnz-length temporaries)
        from .._native import get_lib, csr_arrays
        lib = get_lib()
        uoffs = _pre
        indptr, indices, data = csr_arrays(A)
        bands = np.empty((len(uoffs), n_pad), dtype=np.float32)
        lib.dia_fill_f32(n, n_pad, len(uoffs), indptr, indices, data,
                         uoffs, bands)
        return DiaMatrix(bands=jnp.asarray(bands, dtype=dtype),
                         offsets=tuple(int(o) for o in uoffs),
                         n_rows=n, n_cols=m)
    if _pre is not None:
        rows, offs, uoffs = _pre   # reuse csr_to_device's computation
    else:
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
        offs = A.indices.astype(np.int64) - rows
        uoffs = np.unique(offs)
    bands = np.zeros((len(uoffs), n_pad), dtype=np.float64)
    pos = np.searchsorted(uoffs, offs)
    bands[pos, rows] = A.data
    return DiaMatrix(bands=jnp.asarray(bands, dtype=dtype),
                     offsets=tuple(int(o) for o in uoffs),
                     n_rows=n, n_cols=m)


def csr_to_ell(A: sp.csr_matrix, dtype=jnp.float32,
               pad_multiple: int = 128) -> EllMatrix:
    n, m = A.shape
    nnz_per_row = np.diff(A.indptr)
    K = max(int(nnz_per_row.max()) if n > 0 else 0, 1)
    n_pad = _round_up(max(n, 1), pad_multiple)
    from .._native import get_lib, csr_arrays
    lib = get_lib()
    if lib is not None and A.nnz >= (1 << 16):
        # block-tiled parallel fill — the numpy fancy-index scatter into
        # the (K, n_pad) tables took 11 s for the 192^3 restriction
        indptr, indices, data = csr_arrays(A)
        cols = np.empty((K, n_pad), dtype=np.int32)
        vals = np.empty((K, n_pad), dtype=np.float32)
        lib.ell_fill_f32(n, n_pad, K, indptr, indices, data,
                         cols.reshape(-1), vals.reshape(-1))
    else:
        cols = np.zeros((K, n_pad), dtype=np.int32)
        vals = np.zeros((K, n_pad), dtype=np.float64)
        rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
        # slot index of each nnz within its row
        slot = np.arange(A.nnz, dtype=np.int64) - np.repeat(
            A.indptr[:-1].astype(np.int64), nnz_per_row)
        cols[slot, rows] = A.indices
        vals[slot, rows] = A.data
    return EllMatrix(cols=jnp.asarray(cols),
                     vals=jnp.asarray(vals, dtype=dtype),
                     n_rows=n, n_cols=m)


def csr_to_dense(A: sp.csr_matrix, dtype=jnp.float32,
                 pad_multiple: int = 128,
                 out_pad: int | None = None,
                 in_pad: int | None = None) -> DenseMatrix:
    """mat stays tight (256-multiples); `out_pad` (default: n rounded to
    pad_multiple) is the level vector length spmv emits.  `in_pad`, when
    given, caps the column pad at the SOURCE vector's length (level pads
    from the distributed Partition can be smaller than the 256 round-up,
    e.g. 384 for a ~300-row level on 8 shards — slicing x[:512] of a
    384-long vector would silently truncate the dot)."""
    n, m = A.shape
    if out_pad is None:
        out_pad = _round_up(max(n, 1), pad_multiple)
    tight = min(pad_multiple, 256)
    np_, mp_ = _round_up(max(n, 1), tight), _round_up(max(m, 1), tight)
    np_ = min(np_, out_pad)
    if in_pad is not None:
        mp_ = min(mp_, in_pad)
    # fill float32 directly — toarray() would materialize an f64 square
    # (3.5 GB at 21k rows) before the cast
    dense = np.zeros((np_, mp_), dtype=np.float32)
    dense[:n, :m] = A.astype(np.float32).toarray()
    return DenseMatrix(mat=jnp.asarray(dense, dtype=dtype), n_rows=n,
                       n_cols=m, out_pad=out_pad)


def csr_to_device(A: sp.csr_matrix, dtype=jnp.float32, prefer_dia: bool = True,
                  dia_max_bands: int = 32, pad_multiple: int = 128,
                  dense_size: int = 0):
    """Pick the device layout for a host CSR matrix.

    Dense matvec below `dense_size` rows; DIA when the matrix is square,
    stencil-structured (few distinct diagonals) and dense-enough within
    them; ELL otherwise.
    """
    n, m = A.shape
    if dense_size and n <= dense_size and m <= dense_size:
        return csr_to_dense(A, dtype, pad_multiple,
                            in_pad=_round_up(max(m, 1), pad_multiple))
    if prefer_dia and n == m and A.nnz > 0:
        from .._native import get_lib, csr_arrays
        lib = get_lib()
        if lib is not None and jnp.dtype(dtype).itemsize <= 4:
            indptr, indices, _ = csr_arrays(A)
            uoffs = np.empty(dia_max_bands + 1, dtype=np.int64)
            k = int(lib.dia_offsets(n, indptr, indices, dia_max_bands,
                                    uoffs))
            # DIA wastes (n_diags*n - nnz) slots; accept if <= 2x blowup
            if 0 < k and k * n <= 4 * A.nnz:
                return csr_to_dia(A, dtype, pad_multiple,
                                  _pre=uoffs[:k].copy())
        else:
            rows = np.repeat(np.arange(n, dtype=np.int64),
                             np.diff(A.indptr))
            offs = A.indices.astype(np.int64) - rows
            uoffs = np.unique(offs)
            if len(uoffs) <= dia_max_bands and len(uoffs) * n <= 4 * A.nnz:
                return csr_to_dia(A, dtype, pad_multiple,
                                  _pre=(rows, offs, uoffs))
    return csr_to_ell(A, dtype, pad_multiple)


def device_matvec_dense(A, n: int | None = None):
    """Return a dense-vector matvec closure y = A@x with logical sizes
    (truncates padding). Mostly for tests."""
    def mv(x):
        xp = jnp.pad(x, (0, A.n_pad - x.shape[0])) \
            if x.shape[0] < A.n_pad else x
        return A.spmv(xp)[: (n or A.n_rows)]
    return mv
