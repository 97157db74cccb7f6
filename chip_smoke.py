#!/usr/bin/env python3
"""Smoke test of the AMG solve path on NVIDIA GPUs.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # four cards: distributed solves only

One card, in order (any failure raises and the exit code is non-zero):

1. Device: JAX must report a GPU; prints the card's name and power limit
   and the native setup library that was loaded (the numpy fallback is
   refused: a numpy setup at 192^3 would not be the system).
2. Kernel parity at real widths on the flagship 192^3 3-D Poisson
   hierarchy (7,077,888 unknowns): every operator of the cycle and the
   refinement against scipy/numpy float64 on the host, each within a
   stated bound; df64 two_sum/two_prod exact on 2^20 random pairs.
3. The flagship solve to tol 1e-8, true residual recomputed in float64
   on the host against the assembled matrix.
4. One systems solve: elasticity3d m=40 with RBM smoothed aggregation
   (the scripts/run_configs.py row).
5. The last line is one JSON object naming the device.

With --four only the four-card path and what it is compared with run:
DistAMGSolver from the global setup, DistAMGSolver.from_blocked (the
process-local pipeline, one process driving all four cards) and the
one-card AMGSolver, all on 192^3 Poisson.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

EPS32 = float(np.finfo(np.float32).eps)       # 2^-23
DF64_UNIT = 2.0 ** -48                        # df64 rounding unit
FLAGSHIP_N = 192


def log(msg: str) -> None:
    print(msg, flush=True)


def result_line(devs) -> str:
    """The final line: platform, kind and count as JAX reports them."""
    d = devs[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}})


# ---------------------------------------------------------------------------
# Parity checks: device result vs a float64 host reference
# ---------------------------------------------------------------------------

def row_bound_ratio(y, y_ref, scale, ulps) -> float:
    """max_i |y_i - y_ref_i| / (ulps_i * scale_i): <= 1 passes.  `scale`
    is the magnitude the rounding errors are proportional to (|A||x|
    summed in float64), `ulps` the number of rounding units allowed."""
    err = np.abs(np.asarray(y, np.float64) - y_ref)
    den = np.asarray(ulps, np.float64) * scale
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(den > 0, err / den, np.where(err > 0, np.inf, 0.0))
    return float(r.max()) if r.size else 0.0


def check(name: str, ratio: float, tol_text: str) -> None:
    ok = ratio <= 1.0
    log(f"parity {name}: bound ratio {ratio:.3e} "
        f"({'ok' if ok else 'FAIL'}; tolerance: {tol_text})")
    if not ok:
        raise AssertionError(f"parity {name} outside its bound: "
                             f"ratio {ratio:.3e}")


def host_values(M, dtype):
    """The host CSR with values rounded the way the device layout holds
    them (float64 -> float32 -> dtype), back in float64."""
    import jax.numpy as jnp
    M = M.tocsr().copy()
    M.data = np.asarray(M.data.astype(np.float32).astype(jnp.dtype(dtype)),
                        dtype=np.float64)
    return M


def spmv_parity(name, op, M, dtype, rng, n_pad_in):
    """y = op.spmv(x) against scipy float64 on dtype-rounded values.
    Bound per row: 2 * (nnz_row + 1) fp32 epsilons of (|M||x|)_row — each
    of the row's products and sums rounds once in fp32 (bf16 values are
    exact in fp32, so bf16 bands need no extra term)."""
    import jax
    import jax.numpy as jnp
    Mh = host_values(M, dtype)
    x = np.zeros(n_pad_in, np.float32)
    x[: M.shape[1]] = rng.standard_normal(M.shape[1]).astype(np.float32)
    y = np.asarray(jax.jit(lambda v: op.spmv(v))(jnp.asarray(x)))
    y = y[: M.shape[0]]
    xs = x[: M.shape[1]].astype(np.float64)
    y_ref = Mh @ xs
    scale = abs(Mh) @ np.abs(xs)
    nnz = np.diff(Mh.indptr)
    check(name, row_bound_ratio(y, y_ref, scale, 2 * (nnz + 1) * EPS32),
          "2*(row nnz+1) fp32 eps of |M||x| per row")


def dense_precision_probe():
    """A dense fp32 matvec whose exact result needs all 24 mantissa bits
    of x: ones(256, 256) @ (1 + 2^-20).  fp32 gives 256 + 2^-12 exactly;
    TF32 (10 mantissa bits) would round x to 1 and return 256."""
    import jax
    import jax.numpy as jnp
    from sparsh_amg_tpu.ops.formats import DenseMatrix
    D = DenseMatrix(mat=jnp.ones((256, 256), jnp.float32), n_rows=256,
                    n_cols=256, out_pad=256)
    x = jnp.full((256,), 1.0 + 2.0 ** -20, jnp.float32)
    y = np.asarray(jax.jit(lambda v: D.spmv(v))(x), np.float64)
    want = 256.0 + 2.0 ** -12
    err = float(np.abs(y - want).max())
    log(f"parity dense fp32 precision probe: max err {err:.3e} "
        f"({'ok' if err == 0.0 else 'FAIL'}; tolerance: exact)")
    if err != 0.0:
        raise AssertionError("dense matvec is not full fp32 (TF32?)")


def df64_exactness(n: int = 1 << 20, seed: int = 1):
    """two_sum / two_prod on n random fp32 pairs must be EXACT against
    float64 (exponents within 2^+-10, so a+b and a*b are exact in f64)."""
    import jax
    import jax.numpy as jnp
    from sparsh_amg_tpu.ops import df64
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-10, 11, n)
         ).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-10, 11, n)
         ).astype(np.float32)
    s, e = jax.jit(df64.two_sum)(jnp.asarray(a), jnp.asarray(b))
    p, f = jax.jit(df64.two_prod)(jnp.asarray(a), jnp.asarray(b))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    bad_sum = int(np.count_nonzero(
        np.asarray(s, np.float64) + np.asarray(e, np.float64) != a64 + b64))
    bad_prod = int(np.count_nonzero(
        np.asarray(p, np.float64) + np.asarray(f, np.float64) != a64 * b64))
    log(f"parity df64 exactness on {n} pairs: two_sum inexact {bad_sum}, "
        f"two_prod inexact {bad_prod} "
        f"({'ok' if bad_sum == bad_prod == 0 else 'FAIL'}; "
        f"tolerance: exact)")
    if bad_sum or bad_prod:
        raise AssertionError("df64 error-free transforms are not exact")


def df64_residual_parity(solver, A, rng):
    """The df64 refinement residual r = b - A x of the fine operator near
    a solution (|r| ~ 1e-8 |A||x|, the regime refinement runs in) against
    float64.  Bound per row: 2*(nnz_row+1) df64 units (2^-48) of
    (|A||x| + |b|)_row — every df64 product and sum rounds once at that
    unit; fp32 or FMA-broken arithmetic misses it by ~2^24."""
    import jax
    import jax.numpy as jnp
    from sparsh_amg_tpu.ops import df64
    from sparsh_amg_tpu.ops.df64_ops import residual_df64
    n, n_pad = A.shape[0], solver.n_pad
    x = rng.standard_normal(n)
    b = A @ x + 1e-8 * rng.standard_normal(n)
    xp, bp = np.zeros(n_pad), np.zeros(n_pad)
    xp[:n], bp[:n] = x, b
    x_hi, x_lo = df64.from_f64_np(xp)
    b_hi, b_lo = df64.from_f64_np(bp)
    r_hi, r_lo = jax.jit(residual_df64)(
        solver.A_df, jnp.asarray(b_hi), jnp.asarray(b_lo),
        jnp.asarray(x_hi), jnp.asarray(x_lo))
    r = df64.to_f64_np(jax.device_get(r_hi), jax.device_get(r_lo))[:n]
    xs = df64.to_f64_np(x_hi, x_lo)[:n]
    bs = df64.to_f64_np(b_hi, b_lo)[:n]
    r_ref = bs - A @ xs
    scale = abs(A) @ np.abs(xs) + np.abs(bs)
    nnz = np.diff(A.indptr)
    ratio = row_bound_ratio(r, r_ref, scale, 2 * (nnz + 1) * DF64_UNIT)
    rel = float(np.linalg.norm(r - r_ref) / np.linalg.norm(scale))
    log(f"parity df64 residual A0: normwise error / || |A||x|+|b| || "
        f"= {rel:.3e}")
    check("df64 residual A0", ratio,
          "2*(row nnz+1) df64 units (2^-48) of |A||x|+|b| per row")


def kernel_parity(solver, A, params, seed: int = 0) -> None:
    """Every operator the cycle and the refinement run, on the card."""
    import jax
    import jax.numpy as jnp
    from sparsh_amg_tpu.ops.formats import (DiaMatrix, EllMatrix, residual,
                                            DenseMatrix)
    from sparsh_amg_tpu.solve.smoothers import chebyshev
    rng = np.random.default_rng(seed)
    dev = solver.device
    H = solver.hierarchy
    l0 = dev.levels[0]
    n0, n_pad = A.shape[0], l0.n_pad
    log("operators: " + ", ".join(
        f"L{i}: A={type(l.A).__name__} n={l.n}"
        + (f" P={type(l.P).__name__} R={type(l.R).__name__}"
           if l.P is not None else "")
        for i, l in enumerate(dev.levels)))

    A_hi = solver.A_df.A_hi
    assert isinstance(A_hi, DiaMatrix), type(A_hi)
    spmv_parity("fine DIA SpMV fp32 bands", A_hi, A, jnp.float32, rng,
                n_pad)
    assert isinstance(l0.A, DiaMatrix), type(l0.A)
    spmv_parity(f"fine DIA SpMV {l0.A.bands.dtype} bands", l0.A, A,
                l0.A.bands.dtype, rng, n_pad)

    # residual r = b - A x with fp32 bands: one more rounding (the
    # subtraction) on top of the SpMV bound, scaled by |A||x| + |b|
    x = rng.standard_normal(n_pad).astype(np.float32)
    b = rng.standard_normal(n_pad).astype(np.float32)
    x[n0:] = 0.0
    b[n0:] = 0.0
    r = np.asarray(jax.jit(residual)(A_hi, jnp.asarray(x),
                                     jnp.asarray(b)))[:n0]
    xs, bs = x[:n0].astype(np.float64), b[:n0].astype(np.float64)
    r_ref = bs - A @ xs
    scale = abs(A) @ np.abs(xs) + np.abs(bs)
    nnz = np.diff(A.indptr)
    check("fine residual fp32 bands",
          row_bound_ratio(r, r_ref, scale, 2 * (nnz + 2) * EPS32),
          "2*(row nnz+2) fp32 eps of |A||x|+|b| per row")

    # one Chebyshev smoothing step (the cycle's degree, nonzero start)
    # against the same recurrence in float64 on the bf16-rounded A and
    # the device's dinv/lambda_max: `degree` chained SpMVs plus vector
    # updates in fp32 -> normwise relative error of a few 1e-7 per SpMV;
    # 1e-5 leaves headroom yet catches TF32 (~1e-3) or bf16 vectors.
    deg = params.cheby_degree
    y = np.asarray(jax.jit(lambda lv, bb, xx: chebyshev(
        lv, bb, xx, deg, params.cheby_lower_frac))(
        l0, jnp.asarray(b), jnp.asarray(x)))[:n0]
    Ab = host_values(A, l0.A.bands.dtype)
    dinv = np.asarray(l0.dinv, np.float64)[:n0]
    lmax = float(l0.lam_max)
    lmin = params.cheby_lower_frac * lmax
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    xr = xs.copy()
    rr = dinv * (bs - Ab @ xr)
    d = rr / theta
    for _ in range(deg - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        xr = xr + d
        rr = rr - dinv * (Ab @ d)
        d = rho_new * rho * d + 2.0 * rho_new / delta * rr
        rho = rho_new
    y_ref = xr + d
    rel = float(np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref))
    check(f"Chebyshev step (degree {deg}) on L0", rel / 1e-5,
          "normwise relative error 1e-5")

    # transfers and the first coarse operator: ELL gathers
    P0, R0 = l0.P, l0.R
    assert isinstance(P0, EllMatrix) and isinstance(R0, EllMatrix), \
        (type(P0), type(R0))
    l1 = dev.levels[1]
    spmv_parity(f"ELL P0 (K={P0.k})", P0, H.levels[0].P, P0.vals.dtype,
                rng, l1.n_pad)
    spmv_parity(f"ELL R0 (K={R0.k})", R0, H.levels[0].R, R0.vals.dtype,
                rng, n_pad)
    A1 = l1.A
    assert isinstance(A1, (EllMatrix, DenseMatrix)), type(A1)
    spmv_parity(f"{type(A1).__name__} A1", A1, H.levels[1].A,
                A1.vals.dtype if isinstance(A1, EllMatrix)
                else A1.mat.dtype, rng, l1.n_pad)

    # dense coarse-inverse apply against float64 on the fp32 inverse;
    # bound: 2*(nc+1) fp32 eps of |C||b| per row (nc-term dot products)
    lc = dev.levels[-1]
    C = np.asarray(lc.coarse_inv, np.float64)
    bc = np.zeros(lc.n_pad, np.float32)
    bc[: lc.n] = rng.standard_normal(lc.n).astype(np.float32)
    yc = np.asarray(jax.jit(lambda lv, v: lv.coarse_solve(v))(
        lc, jnp.asarray(bc)))[: C.shape[0]]
    bcs = bc[: C.shape[1]].astype(np.float64)
    check(f"dense coarse inverse apply (n={lc.n})",
          row_bound_ratio(yc, C @ bcs, np.abs(C) @ np.abs(bcs),
                          np.full(C.shape[0], 2 * (C.shape[1] + 1) * EPS32)),
          "2*(n+1) fp32 eps of |C||b| per row")
    dense_precision_probe()
    df64_residual_parity(solver, A, rng)
    df64_exactness()


# ---------------------------------------------------------------------------
# Solves
# ---------------------------------------------------------------------------

def true_relres(A, x, b) -> float:
    return float(np.linalg.norm(b - A @ np.asarray(x, np.float64))
                 / np.linalg.norm(b))


def timed_solve(solver, A, b, label: str, card: str):
    """Compile and warm the solver, then time a solve and check its
    float64 true relative residual; returns the SolveResult."""
    t0 = time.perf_counter()
    rhs = solver.prepare_rhs(b)
    if hasattr(solver, "warm"):
        solver.warm()        # compiles every program a solve dispatches
    else:
        solver.solve(rhs)    # the first solve sets the chunk schedule
    solver.solve(rhs)
    warm_s = time.perf_counter() - t0
    res = solver.solve(rhs)
    rel = true_relres(A, res.x, b)
    log(f"{label}: iterations {res.iterations}, refinement passes "
        f"{res.refine_passes}, solve {res.solve_time:.4f} s, warm/compile "
        f"{warm_s:.1f} s, reported relres {res.relres:.3e}, float64 true "
        f"relres {rel:.3e} [card: {card}]")
    if not (res.converged and rel <= 1e-8):
        raise AssertionError(f"{label}: true relres {rel:.3e} > 1e-8")
    return res


def memory_line(card: str, devices=None) -> None:
    from sparsh_amg_tpu.utils.meminfo import device_memory_stats
    import jax
    for d in devices or jax.devices()[:1]:
        st = device_memory_stats(d)
        log(f"memory_stats {d}: bytes_in_use {st.get('bytes_in_use')}, "
            f"peak_bytes_in_use {st.get('peak_bytes_in_use')}, "
            f"bytes_limit {st.get('bytes_limit')} [card: {card}]")


def flagship_phase(card: str, n: int = FLAGSHIP_N):
    from sparsh_amg_tpu.models.poisson import poisson3d
    from sparsh_amg_tpu.params import KrylovParams, flagship_params
    from sparsh_amg_tpu.setup.hierarchy import amg_setup
    from sparsh_amg_tpu.solve.solver import AMGSolver
    params = flagship_params()
    A = poisson3d(n)
    log(f"flagship poisson3d({n}): {A.shape[0]} unknowns, {A.nnz} nnz")
    t0 = time.perf_counter()
    hier = amg_setup(A, params)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = AMGSolver(A, params, KrylovParams(method="cg", tol=1e-8,
                                               loop_mode="auto"),
                       hierarchy=hier)
    to_device_s = time.perf_counter() - t0
    log(f"flagship setup {setup_s:.2f} s, to_device {to_device_s:.2f} s, "
        f"levels {hier.n_levels}, opC {hier.operator_complexity():.3f}, "
        f"loop_mode {solver.krylov.loop_mode}, device bytes "
        f"{solver.device_bytes()} [card: {card}]")
    kernel_parity(solver, A, params)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    timed_solve(solver, A, b, f"flagship poisson3d({n})", card)
    memory_line(card)


def elasticity_phase(card: str, scale: int = 1):
    """scripts/run_configs.py's elasticity3d row (m=40 at scale 1)."""
    from scripts.run_configs import configs
    from sparsh_amg_tpu.solve.solver import AMGSolver
    name, build, params, krylov = next(
        c for c in configs(scale) if c[0].startswith("elasticity3d_"))
    A, ns = build()
    A = A.tocsr()
    t0 = time.perf_counter()
    solver = AMGSolver(A, params, krylov, nullspace=ns)
    log(f"{name}: {A.shape[0]} unknowns, {A.nnz} nnz, setup+to_device "
        f"{time.perf_counter() - t0:.2f} s, operators "
        f"{[type(l.A).__name__ for l in solver.device.levels]}")
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    timed_solve(solver, A, b, name, card)


def per_device_bytes(tree) -> dict:
    """Bytes of a sharded pytree's arrays held on each device."""
    import jax
    out = {}
    for leaf in jax.tree_util.tree_leaves(tree):
        if isinstance(leaf, jax.Array):
            for s in leaf.addressable_shards:
                out[str(s.device)] = out.get(str(s.device), 0) \
                    + s.data.nbytes
    return out


def four_card_phase(card: str, n: int = FLAGSHIP_N, nd: int = 4):
    """Global-setup and process-local distributed solves on nd cards,
    compared with the one-card solve of the same system."""
    import jax
    from sparsh_amg_tpu.models.poisson import poisson3d, poisson3d_rows
    from sparsh_amg_tpu.params import KrylovParams, flagship_params
    from sparsh_amg_tpu.parallel.solver import DistAMGSolver, default_mesh
    from sparsh_amg_tpu.setup.hierarchy import amg_setup
    from sparsh_amg_tpu.solve.solver import AMGSolver
    if len(jax.devices()) < nd:
        raise RuntimeError(f"--four needs {nd} devices, JAX found "
                           f"{len(jax.devices())}")
    params = flagship_params()
    krylov = KrylovParams(method="cg", tol=1e-8, loop_mode="auto")
    mesh = default_mesh(nd)
    A = poisson3d(n)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    log(f"poisson3d({n}): {A.shape[0]} unknowns, {A.nnz} nnz on {nd} "
        f"cards")
    t0 = time.perf_counter()
    hier = amg_setup(A, params)
    log(f"global setup {time.perf_counter() - t0:.2f} s")
    iters = {}
    for label, make in (
            ("global-setup DistAMGSolver",
             lambda: DistAMGSolver(A, mesh=mesh, params=params,
                                   krylov=krylov, hierarchy=hier)),
            ("process-local DistAMGSolver.from_blocked",
             lambda: DistAMGSolver.from_blocked(
                 lambda r0, r1: poisson3d_rows(n, r0, r1), A.shape[0],
                 mesh=mesh, params=params, krylov=krylov)),
            ("one-card AMGSolver",
             lambda: AMGSolver(A, params, krylov, hierarchy=hier))):
        t0 = time.perf_counter()
        solver = make()
        log(f"{label}: setup/freeze/upload {time.perf_counter() - t0:.2f} "
            f"s, loop_mode {solver.krylov.loop_mode}")
        if isinstance(solver, DistAMGSolver):
            by_dev = per_device_bytes((solver.levels, solver.A_df))
            tot = sum(by_dev.values())
            log(f"{label}: operator bytes per card "
                + ", ".join(f"{d}: {v} ({v / tot:.3f})"
                            for d, v in sorted(by_dev.items())))
        res = timed_solve(solver, A, b, label, card)
        iters[label] = res.iterations
        memory_line(card, jax.devices()[:nd])
        del solver
    spread = max(iters.values()) - min(iters.values())
    log(f"iterations {iters}: spread {spread} "
        f"({'ok' if spread <= 1 else 'FAIL'}; tolerance: +-1)")
    if spread > 1:
        raise AssertionError(f"iteration counts differ by {spread}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its comparisons")
    args = ap.parse_args(argv)

    from sparsh_amg_tpu._native import get_lib
    from sparsh_amg_tpu.utils.compile_cache import enable_compile_cache
    from sparsh_amg_tpu.utils.meminfo import require_gpu, gpu_name_power
    enable_compile_cache()
    devs = require_gpu()
    card = gpu_name_power()
    log(f"card: {card}")
    log(f"jax devices: {len(devs)} x {devs[0].device_kind}")
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native setup library failed to build; the "
                           "numpy fallback is not the system")
    log(f"native setup library: {lib._name}")

    t0 = time.perf_counter()
    if args.four:
        four_card_phase(card)
        devs = devs[:4]
    else:
        flagship_phase(card)
        elasticity_phase(card)
        devs = devs[:1]
    log(f"phases done in {time.perf_counter() - t0:.1f} s [card: {card}]")
    print(result_line(devs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
