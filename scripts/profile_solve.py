#!/usr/bin/env python
"""Phase-level profile of one host-chunked solve at 192^3 (VERDICT r2
weak #2 follow-up): times every dispatch and transfer of the refinement
driver separately — b upload, kr_init, main/tail chunks, rr readbacks,
refine residual/update, true-resnorm, x download — to show where the
measured solve_s goes beyond the device-time bound.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--chunk", type=int, default=12)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from sparsh_amg_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from sparsh_amg_tpu.models.poisson import poisson3d
    from sparsh_amg_tpu.params import AMGParams, KrylovParams
    from sparsh_amg_tpu.setup.hierarchy import amg_setup
    from sparsh_amg_tpu.solve.solver import AMGSolver
    from sparsh_amg_tpu.ops import df64

    params = AMGParams(smoother="chebyshev", cycle="V",
                       band_dtype="bfloat16", coarsening="pmis",
                       interpolation="extpi", interp_max=4,
                       rap_drop_tol=0.01, agg_levels=1,
                       interp_max_composed=5, intermediate_drop_tol=0.02,
                       aggressive="pmis2", dense_size=8192,
                       cheby_degree_coarse=1, cheby_coarse_from=1)
    n = args.n ** 3
    A = poisson3d(args.n)
    hier = amg_setup(A, params)
    solver = AMGSolver(A, params,
                       KrylovParams(method="cg", tol=1e-8, loop_mode="host",
                                    chunk=args.chunk),
                       hierarchy=hier)
    solver.warm()
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)
    solver.solve(b, tol=1e-2)       # prime rho estimate

    # --- instrumented replication of solve() ------------------------------
    T = {}

    def tick(name, t0):
        t1 = time.perf_counter()
        T[name] = T.get(name, 0.0) + (t1 - t0)
        return t1

    t = time.perf_counter()
    bpad = solver._pad(np.asarray(b, dtype=np.float64))
    b_hi_np, b_lo_np = df64.from_f64_np(bpad)
    t = tick("host_prep", t)
    b_hi = jnp.asarray(b_hi_np)
    b_lo = jnp.asarray(b_lo_np)
    jax.block_until_ready((b_hi, b_lo))
    t = tick("b_upload_57MB", t)

    levels = solver.device.levels
    Afine = solver.A_df.A_hi
    kr = solver.krylov
    x_hi = jnp.zeros(solver.n_pad, dtype=jnp.float32)
    x_lo = jnp.zeros(solver.n_pad, dtype=jnp.float32)
    bnorm = float(np.linalg.norm(bpad))
    tol = 1e-8
    relres = 1.0
    total_iters = 0
    for p in range(2):
        r_hi = solver._refine_residual(solver.A_df, b_hi, b_lo, x_hi, x_lo)
        jax.block_until_ready(r_hi)
        t = tick("refine_residual", t)
        itol = max(kr.inner_tol, tol / max(relres, 1e-30) * 0.1)
        st = solver._kr_init(levels, Afine, r_hi)
        jax.block_until_ready(st[0])
        t = tick("kr_init", t)
        rr0 = float(st[5])
        t = tick("rr_readback", t)
        target = itol * itol * rr0
        rr = rr0
        main = kr.chunk
        tail = max(1, main // 4)
        while True:
            rho2 = solver._rho2_est
            if rho2 and 0 < rho2 < 1 and rr > target > 0:
                need = int(np.ceil(np.log(target / rr) / np.log(rho2)))
                k = main if need >= main else tail
            else:
                k = main
            st = solver._kr_chunk(levels, Afine, r_hi, st, k=k)
            jax.block_until_ready(st[0])
            t = tick(f"chunk_k{k}", t)
            rr = float(st[5])
            t = tick("rr_readback", t)
            if rr <= target or st[6] >= 100:
                break
        total_iters += int(st[6])
        x_hi, x_lo = solver._refine_update(x_hi, x_lo, st[0])
        jax.block_until_ready(x_hi)
        t = tick("refine_update", t)
        rnsq = float(solver._true_resnorm(solver.A_df, b_hi, b_lo,
                                          x_hi, x_lo))
        t = tick("true_resnorm+rb", t)
        relres = float(np.sqrt(max(rnsq, 0.0))) / bnorm
        if relres <= tol:
            break
    xh = jax.device_get(x_hi)
    xl = jax.device_get(x_lo)
    t = tick("x_download_57MB", t)
    x = df64.to_f64_np(xh, xl)
    t = tick("host_post", t)
    T["TOTAL"] = sum(T.values())
    T["iterations"] = total_iters
    T["relres"] = relres
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in T.items()}))


if __name__ == "__main__":
    main()
