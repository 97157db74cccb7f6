#!/usr/bin/env python
"""Blocked per-host setup cost vs the global setup (VERDICT r3 next #7).

Times the FULL flagship blocked setup (setup/blocked.py: distributed
pmis2 + multipass + Jacobi repair + blocked transpose/RAP, per-rank row
blocks exchanging only boundary data) on N simulated hosts (threads;
the native kernels drop the GIL) against the global `amg_setup` on the
same machine — equal total core count, so the ratio is the price of
process-locality.  Also spot-checks level-0 bit-identity and end-to-end
iteration parity.

Writes BLOCKED_SETUP_r4.json.

Usage: python scripts/blocked_setup_bench.py [--n 192] [--blocks 8]
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
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--nd", type=int, default=8,
                    help="device count the freeze targets")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "BLOCKED_SETUP_r5.json"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from sparsh_amg_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from sparsh_amg_tpu.models.poisson import poisson3d, poisson3d_rows
    from sparsh_amg_tpu.params import AMGParams
    from sparsh_amg_tpu.setup.hierarchy import amg_setup
    from sparsh_amg_tpu.setup.blocked import (blocked_amg_setup,
                                              block_bounds,
                                              partition_bounds)
    from sparsh_amg_tpu.setup.comm import run_blocked_procs

    params = AMGParams(smoother="chebyshev", cycle="V",
                       band_dtype="bfloat16", coarsening="pmis",
                       interpolation="extpi", interp_max=4,
                       rap_drop_tol=0.01, agg_levels=1,
                       interp_max_composed=5, intermediate_drop_tol=0.02,
                       aggressive="pmis2", dense_size=2048,
                       cheby_degree_coarse=1, cheby_coarse_from=1)
    n = args.n ** 3
    nb = args.blocks
    nd = args.nd
    # device-aligned bounds (the deployment shape): the same ranks then
    # FREEZE their shards — setup + freeze is the full per-host pipeline
    # cost (VERDICT r4 next #2)
    bounds = partition_bounds(n, nd, nb)

    # blocked FIRST, on real forked processes (PipeComm): ThreadComm
    # shares one GIL so every numpy phase serializes across simulated
    # hosts — the thread simulation over-charged the blocked setup ~3x
    # vs its deployment shape.  Forking happens before the parent runs
    # any native OpenMP region (libgomp team state is not fork-safe).
    ncores = os.cpu_count() or 1
    omp_each = max(1, ncores // nb)

    # Each side runs TWICE and reports cold AND warm: a fork-fresh child
    # pays anonymous/COW page faults the long-lived global process does
    # not (measured 7.4 s cold vs 2.05 s warm per child at 96^3 — the
    # same 2-3x cold factor the global setup shows across process
    # lifetimes: 28 s vs 10 s at 192^3).  Warm-vs-warm is the headline
    # (steady-state of a setup-serving process, and how every other
    # RESULTS number is quoted); cold-vs-cold is also printed.
    bounds_fn = lambda nc: partition_bounds(nc, nd, nb)

    def fn(rank, comm):
        from sparsh_amg_tpu.parallel.blocked_dist import (
            blocked_to_dist, fine_df64_blocked)
        r0, r1 = int(bounds[rank]), int(bounds[rank + 1])
        A_own = poisson3d_rows(args.n, r0, r1)
        times = []
        for _ in range(2):
            H = None                       # drop the previous hierarchy
            t0 = time.perf_counter()       # BEFORE timing: holding it
            H = blocked_amg_setup(A_own, bounds, comm, params,
                                  bounds_fn=bounds_fn)
            times.append(time.perf_counter() - t0)
            # (rep 2 would otherwise allocate past the held GBs onto
            # fresh pages and measure the fault path again, 1.6-2.3x)
        dpp = nd // comm.size
        freeze = []
        for _ in range(2):
            D = None
            t0 = time.perf_counter()
            D = blocked_to_dist(H, nd, comm, params, as_numpy=True)
            D = (D, fine_df64_blocked(H.levels[0].A, r0, D.parts[0],
                                      comm, params, rank * dpp, dpp,
                                      as_numpy=True))
            freeze.append(time.perf_counter() - t0)
        D = None
        l0 = H.levels[0]                   # timed IN-child: shipping the
        return {                           # hierarchy back through the
            "cold_s": times[0],            # result pipe is not setup cost
            "warm_s": times[1],
            "freeze_cold_s": freeze[0],
            "freeze_warm_s": freeze[1],
            "cf0": l0.cf,
            "P0": (l0.P.indptr, l0.P.indices, l0.P.data),
            "sizes_blk": [(l.n, l.A.nnz) for l in H.levels],
            "sizes_tail": [(l.n, l.nnz) for l in H.tail.levels],
        }

    t0 = time.perf_counter()
    parts = run_blocked_procs(fn, nb, omp_threads=omp_each)
    wall_s = time.perf_counter() - t0
    blocked_cold_s = max(p["cold_s"] for p in parts)
    blocked_s = max(p["warm_s"] for p in parts)
    freeze_s = max(p["freeze_warm_s"] for p in parts)
    freeze_cold_s = max(p["freeze_cold_s"] for p in parts)
    print(f"blocked setup ({nb} ranks, forked processes, "
          f"OMP {omp_each}/rank): cold {blocked_cold_s:.1f}s / "
          f"warm {blocked_s:.1f}s + freeze {freeze_s:.1f}s in-child "
          f"(launch+result wall {wall_s:.1f}s)", flush=True)

    # global reference (all cores), same cold/warm protocol
    t0 = time.perf_counter()
    A = poisson3d(args.n)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    H_g = amg_setup(A, params)
    global_cold_s = time.perf_counter() - t0
    H_g = None                             # same drop-before-rerun rule
    t0 = time.perf_counter()
    H_g = amg_setup(A, params)
    global_s = time.perf_counter() - t0
    print(f"global setup: cold {global_cold_s:.1f}s / warm "
          f"{global_s:.1f}s  {H_g!r}", flush=True)
    lvl0_P = H_g.levels[0].P
    lvl0_cf = H_g.levels[0].cf
    sizes_g = [(l.n, l.nnz) for l in H_g.levels]
    del A, H_g

    # level-0 bit-identity (P rows + cf per rank)
    ident = True
    for rank, p in enumerate(parts):
        r0, r1 = int(bounds[rank]), int(bounds[rank + 1])
        ident &= bool(np.array_equal(p["cf0"], lvl0_cf[r0:r1]))
        Pg = lvl0_P[r0:r1].tocsr()
        _, P_idx, P_dat = p["P0"]
        ident &= bool(np.array_equal(P_idx, Pg.indices)
                      and np.array_equal(P_dat, Pg.data))
    sizes_b = ([(n_l, int(sum(q["sizes_blk"][i][1] for q in parts)))
                for i, (n_l, _) in enumerate(parts[0]["sizes_blk"])]
               + parts[0]["sizes_tail"])

    ratio = blocked_s / global_s
    out = {"n": n, "grid": args.n, "blocks": nb, "nd": nd,
           "omp_per_rank": omp_each,
           "freeze_warm_s": freeze_s, "freeze_cold_s": freeze_cold_s,
           "gen_s": gen_s,
           "global_setup_cold_s": global_cold_s,
           "global_setup_s": global_s,
           "blocked_setup_cold_s": blocked_cold_s,
           "blocked_setup_s": blocked_s,
           "ratio": ratio,
           "ratio_cold": blocked_cold_s / global_cold_s,
           "level0_bit_identical": ident,
           "levels_global": sizes_g, "levels_blocked": sizes_b,
           "within_1p5x": ratio <= 1.5}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in
                      ("global_setup_s", "blocked_setup_s", "ratio",
                       "level0_bit_identical", "within_1p5x")}))
    sys.exit(0 if (ident and ratio <= 1.5) else 1)


if __name__ == "__main__":
    main()
