"""Flagship benchmark on one GPU (BASELINE.json configs[1]: 3-D 7-point
Poisson, V-cycle + Chebyshev smoother, AMG-PCG to 1e-8).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

The headline metric is effective SpMV throughput during the solve phase
(nnz processed per second across every SpMV the solve performs), compared
against the measured speed-of-light for this card: copy bandwidth divided
by the bytes each nnz must move in the DIA layout (BASELINE.json:2 and
SURVEY.md §6 define the acceptance metric this way).
"""
import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=192,
                    help="grid points per side (n^3 unknowns)")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--dist", type=int, default=0, metavar="N",
                    help="row-shard over N devices (weak-scaling harness; "
                         "0 = serial single chip)")
    ap.add_argument("--coarsening", default="rs",
                    choices=["rs", "pmis", "aggregation"])
    ap.add_argument("--loop-mode", default="auto",
                    choices=["auto", "host", "device"],
                    help="Krylov loop placement; auto probes the "
                         "per-dispatch RTT (device when < 1 ms)")
    ap.add_argument("--chunk", type=int, default=12,
                    help="host-mode iterations per dispatch (smaller = "
                         "smaller XLA temp arena; useful near the HBM "
                         "ceiling at 50M+ unknowns single-chip)")
    ap.add_argument("--dense-size", type=int, default=2048,
                    help="densify levels at/below this n (ELL above)")
    ap.add_argument("--aggressive", default="pmis2",
                    choices=["composed", "pmis2"],
                    help="aggressive-step scheme: pmis2 = second PMIS on "
                         "the distance-2 C-C graph + smoothed multipass "
                         "interp (no intermediate RAP); composed = two "
                         "full rounds")
    args = ap.parse_args()

    import jax
    from sparsh_amg_tpu.utils.compile_cache import enable_compile_cache
    from sparsh_amg_tpu.utils.meminfo import require_gpu, gpu_name_power
    enable_compile_cache()
    devs = require_gpu()
    card = gpu_name_power()
    print(f"# card: {card}", flush=True)
    from sparsh_amg_tpu.models.poisson import poisson3d
    from sparsh_amg_tpu.params import AMGParams, KrylovParams
    from sparsh_amg_tpu.solve.solver import AMGSolver

    nside = args.n
    n = nside ** 3
    t0 = time.perf_counter()
    A = poisson3d(nside)
    gen_s = time.perf_counter() - t0

    # Flagship setup: aggressive PMIS + ext+i distance-two interpolation
    # on the first coarsening step and ML-style RAP filtering — opC ~1.2,
    # 4-5 levels; the coarse levels stay sparse (nnz/row <= ~55) so no
    # GB-scale dense blocks are materialized or uploaded.
    if args.coarsening == "aggregation":
        interp = "smoothed"
        extra = {}
    else:
        interp = "extpi"
        # interp_max_composed=5: re-truncate the composed aggressive-
        # coarsening P (K 13 -> 5, i.e. 2.6x smaller device transfer
        # tables) — iteration-neutral at 64^3..96^3 on the CPU backend
        extra = dict(interp_max=4, rap_drop_tol=0.01, agg_levels=1,
                     interp_max_composed=5,
                     # throwaway intermediate RAP filtered at 0.02 —
                     # iteration-neutral 64^3..128^3 on the CPU backend,
                     # ~2x faster aggressive-coarsening host setup step
                     intermediate_drop_tol=0.02,
                     aggressive=args.aggressive)
        if args.coarsening == "rs":
            args.coarsening = "pmis"   # flagship pairing
    params = AMGParams(smoother="chebyshev", cycle="V",
                       band_dtype="bfloat16",
                       coarsening=args.coarsening, interpolation=interp,
                       # dense matvec for small levels (one kernel in
                       # place of a gather); with opC 1.2 no level between
                       # ~30k and ~4k exists, so the cap stays modest
                       dense_size=args.dense_size, cheby_degree_coarse=1,
                       cheby_coarse_from=1, **extra)
    # loop_mode="auto" (VERDICT r3 next #4): a measured per-dispatch RTT
    # probe picks the placement — "device" (single-dispatch while_loop,
    # fewest iterations) where the round trip is under 1 ms, else "host"
    # (trace-time-unrolled chunks)
    krylov = KrylovParams(method="cg", tol=args.tol,
                          loop_mode=args.loop_mode, chunk=args.chunk)
    setup_parts = {}
    if args.dist:
        from sparsh_amg_tpu.parallel.solver import (DistAMGSolver,
                                                    default_mesh)
        solver = DistAMGSolver(A, mesh=default_mesh(args.dist),
                               params=params, krylov=krylov)
    else:
        # split the setup phases so the JSON line shows where setup_s
        # goes (host hierarchy build vs device freeze/upload)
        from sparsh_amg_tpu.setup.hierarchy import amg_setup
        t1 = time.perf_counter()
        hier = amg_setup(A, params)
        setup_parts["amg_setup_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        solver = AMGSolver(A, params, krylov, hierarchy=hier)
        setup_parts["to_device_s"] = time.perf_counter() - t1

    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)

    if args.dist:
        solver.solve(b, tol=1e-2)            # warmup (compile)
        res = solver.solve(b)
        rhs_upload_s = None
    else:
        # compile every dispatched program, then prime the chunk-size
        # contraction estimate — the timed run never compiles
        solver.warm()
        t1 = time.perf_counter()
        rhs = solver.prepare_rhs(b)          # 2x n_pad fp32 H2D, timed apart
        rhs_upload_s = time.perf_counter() - t1
        solver.solve(rhs, tol=1e-2)
        res = min((solver.solve(rhs) for _ in range(2)),
                  key=lambda r: r.solve_time)
        if args.loop_mode == "auto":
            # The RTT probe alone can mispredict; auto therefore runs a
            # measured A/B of both placements on the warmed solver and
            # keeps the winner; compiles hit the persistent cache on
            # repeat runs.
            import dataclasses
            first_mode = solver.krylov.loop_mode
            ab = {first_mode: res.solve_time}
            alt = "device" if first_mode == "host" else "host"
            solver.krylov = dataclasses.replace(solver.krylov,
                                                loop_mode=alt)
            solver._build_jitted()
            solver.warm()
            solver.solve(rhs, tol=1e-2)
            res_alt = min((solver.solve(rhs) for _ in range(2)),
                          key=lambda r: r.solve_time)
            ab[alt] = res_alt.solve_time
            if res_alt.solve_time < res.solve_time:
                res = res_alt
            else:
                solver.krylov = dataclasses.replace(solver.krylov,
                                                    loop_mode=first_mode)
            setup_parts["loop_mode_ab_s"] = ab

    nnz = A.nnz
    # EXACT per-iteration work: the accounting module mirrors the cycle
    # recursion op for op and prices it in true nnz and device-layout HBM
    # bytes (replaces round 1's +-10% analytic estimate, VERDICT weak #9)
    from sparsh_amg_tpu.utils.accounting import work_per_iteration
    # dist layouts differ per shard: price nnz-only there (dev=None)
    dev = None if args.dist else solver.device
    work = work_per_iteration(solver.hierarchy, dev, params)
    eff_nnz = work.effective_nnz(res.iterations, res.refine_passes)
    nnz_per_s = eff_nnz / max(res.solve_time, 1e-12)

    from sparsh_amg_tpu.utils.meminfo import hbm_spec_bw
    from sparsh_amg_tpu.utils.timing import measure_copy_bw
    bw = measure_copy_bw()
    bw_spec = hbm_spec_bw()
    # DIA 7-band fp32: 7 band streams + ~1 x read + 1 y write per row
    bytes_per_nnz = (7 + 1 + 1) * 4 / 7
    sol_nnz_per_s = bw / bytes_per_nnz
    sol_nnz_per_s_spec = bw_spec / bytes_per_nnz

    out = {
        "metric": "amg_pcg_poisson3d_spmv_throughput",
        "value": nnz_per_s,
        "unit": "nnz/s",
        "vs_baseline": nnz_per_s / sol_nnz_per_s,
        "gflops": 2.0 * eff_nnz / max(res.solve_time, 1e-12) / 1e9,
        "n": n,
        "nnz": int(nnz),
        "iterations": res.iterations,
        "refine_passes": res.refine_passes,
        "converged": bool(res.converged),
        "relres": res.relres,
        "solve_s": res.solve_time,
        # setup_s stays the FULL setup wall time (hierarchy + freeze +
        # upload); the *_s parts break it down when running serial
        "setup_s": res.setup_time + setup_parts.get("amg_setup_s", 0.0),
        **setup_parts,
        "problem_gen_s": gen_s,
        # H2D of the rhs, reported apart from solve_s: the solve loop runs
        # with a device-resident rhs (prepare_rhs), matching the
        # reference's GPU driver where b is uploaded once before the loop
        "rhs_upload_s": rhs_upload_s,
        "levels": solver.hierarchy.n_levels,
        "operator_complexity": solver.hierarchy.operator_complexity(),
        "hbm_bw_GBs": bw / 1e9,
        "hbm_bw_spec_GBs": bw_spec / 1e9,
        "speed_of_light_nnz_per_s": sol_nnz_per_s,
        # share of the published peak (utils/meminfo.py)
        "vs_spec": nnz_per_s / sol_nnz_per_s_spec,
        # exact counted work (utils/accounting.py): per-iteration SpMV
        # equivalents and the achieved fraction of measured copy bandwidth
        "spmv_equiv_per_iter": work.spmv_equiv,
        "bytes_per_iter": work.bytes_per_iter,
        "hbm_fraction": (work.bytes_per_iter * max(res.iterations, 1)
                         / max(res.solve_time, 1e-12) / bw
                         if work.bytes_per_iter else None),
        "hbm_fraction_spec": (work.bytes_per_iter * max(res.iterations, 1)
                              / max(res.solve_time, 1e-12) / bw_spec
                              if work.bytes_per_iter else None),
        "backend": jax.default_backend(),
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "card": card,
        "loop_mode": solver.krylov.loop_mode,   # resolved (auto -> probe)
        "device_bytes": solver.device_bytes(),
    }
    if args.loop_mode == "auto":
        from sparsh_amg_tpu.utils.timing import measure_dispatch_rtt
        out["dispatch_rtt_ms"] = measure_dispatch_rtt() * 1e3
    if not args.dist:
        from sparsh_amg_tpu.utils.accounting import footprint_table
        out["device_bytes_by_level"] = footprint_table(solver.device,
                                                       solver.A_df)
    from sparsh_amg_tpu.utils.meminfo import device_memory_stats
    stats = device_memory_stats()
    for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
        if k in stats:
            out[k] = stats[k]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
