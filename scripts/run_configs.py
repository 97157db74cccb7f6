#!/usr/bin/env python
"""Non-flagship acceptance configs on one GPU.

Runs every configuration below in one process and writes one JSON record
per config (iters / relres / true relres / solve_s / setup_s / opC /
levels / device operator kinds):

  * poisson2d 1024^2 — BASELINE config[0] (V + weighted-Jacobi + PCG)
  * anisotropic eps=1e-3 rotated 45deg at 1024^2 and 2048^2 — config[2]
    (smoothed aggregation, W-cycle, BiCGStab), plus a PMIS/gs2 recipe
  * elasticity2d 512 RBM-SA — rigid-body nullspace, node-amalgamated
    aggregation (agg_blocksize=2), unfiltered P smoothing, V+CG
  * elasticity3d 40 (hex Q1, 81-entry rows) RBM-SA — 6 rigid-body
    modes, agg_blocksize=3
  * convection3d 96^3 — nonsymmetric, PMIS/gs2, BiCGStab
  * jump2d random contrast 1e4 at 1024^2 — PMIS + ext+i, V+CG
  * delaunay 1M — irregular graph Laplacian, RCM-ordered

A config failure is recorded and does not abort the rest.

Usage: python scripts/run_configs.py [--only NAME] [--scale K] [--out F]
"""
import argparse
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def configs(scale: int = 1):
    from sparsh_amg_tpu.models.poisson import poisson2d
    from sparsh_amg_tpu.models.anisotropic import anisotropic2d
    from sparsh_amg_tpu.models.elasticity import (
        elasticity2d, elasticity2d_nullspace,
        elasticity3d, elasticity3d_nullspace)
    from sparsh_amg_tpu.models.jump import jump2d
    from sparsh_amg_tpu.params import AMGParams, KrylovParams

    m2, me, m3 = 1024 // scale, 512 // scale, 40 // scale

    yield (f"poisson2d_{m2}_wjacobi_V_cg",
           lambda: (poisson2d(m2), None),
           AMGParams(smoother="jacobi", coarsening="pmis",
                     interpolation="extpi", interp_max=4),
           KrylovParams(method="cg", tol=1e-8, maxiter=300))
    # agg_theta=0.25 (round 5): the default 0.08 marks cross-
    # characteristic couplings strong and aggregation loses the rotated
    # direction — iterations grew 80 -> 118 with n.  At 0.25 aggregates
    # follow the characteristic: 22/22/21/25 iters at 256/512/1024/1448^2
    # on the CPU mesh (grid-independent), opC 1.54.
    yield (f"aniso2d_{m2}_eps1e-3_rot45_aggW_bicgstab",
           lambda: (anisotropic2d(m2, epsilon=1e-3, angle_deg=45), None),
           AMGParams(coarsening="aggregation", interpolation="smoothed",
                     cycle="W", smoother="l1jacobi", agg_theta=0.25),
           KrylovParams(method="bicgstab", tol=1e-8, maxiter=400))
    m2b = 2048 // scale
    yield (f"aniso2d_{m2b}_eps1e-3_rot45_aggW_bicgstab",
           lambda: (anisotropic2d(m2b, epsilon=1e-3, angle_deg=45), None),
           AMGParams(coarsening="aggregation", interpolation="smoothed",
                     cycle="W", smoother="l1jacobi", agg_theta=0.25),
           KrylovParams(method="bicgstab", tol=1e-8, maxiter=400))
    yield (f"aniso2d_{m2}_pmis_extpi_W_gs2_bicgstab",
           lambda: (anisotropic2d(m2, epsilon=1e-3, angle_deg=45), None),
           AMGParams(coarsening="pmis", interpolation="extpi",
                     interp_max=4, cycle="W", smoother="gs2",
                     rap_drop_tol=0.01),
           KrylovParams(method="bicgstab", tol=1e-8, maxiter=400))
    yield (f"elasticity2d_{me}_rbm_sa_V_cg",
           lambda: (elasticity2d(me), elasticity2d_nullspace(me)),
           AMGParams(coarsening="aggregation", interpolation="smoothed",
                     smoother="chebyshev", coarse_size=200,
                     agg_blocksize=2, p_smooth_filter=False),
           KrylovParams(method="cg", tol=1e-8, maxiter=300))
    yield (f"elasticity3d_{m3}_rbm_sa_V_cg",
           lambda: (elasticity3d(m3), elasticity3d_nullspace(m3)),
           AMGParams(coarsening="aggregation", interpolation="smoothed",
                     smoother="chebyshev", coarse_size=200,
                     agg_blocksize=3, p_smooth_filter=False),
           KrylovParams(method="cg", tol=1e-8, maxiter=300))
    from sparsh_amg_tpu.models.convection import convection3d
    mc = 96 // scale
    yield (f"convection3d_{mc}_pmis_extpi_V_bicgstab",
           lambda: (convection3d(mc), None),
           AMGParams(smoother="gs2", coarsening="pmis",
                     interpolation="extpi", interp_max=4,
                     rap_drop_tol=0.01),
           KrylovParams(method="bicgstab", tol=1e-8, maxiter=300))
    yield (f"jump2d_{m2}_random_1e4_V_cg",
           lambda: (jump2d(m2, contrast=1e4, pattern="random"), None),
           AMGParams(smoother="chebyshev", coarsening="pmis",
                     interpolation="extpi", interp_max=4),
           KrylovParams(method="cg", tol=1e-8, maxiter=300))
    # irregular structure (VERDICT r4 missing #3): Delaunay-graph
    # Laplacian, RCM-ordered, >= 1M rows — the G3_circuit-class surrogate
    # (SuiteSparse unfetchable: zero egress).  l1-Jacobi: the Chebyshev
    # window mis-behaves on heterogeneous-weight graphs (82 vs 21 iters
    # at 256^2 on the CPU mesh); iteration counts pinned grid-independent
    # 20-22 from 16k to 1M.
    from sparsh_amg_tpu.models.unstructured import delaunay_laplacian
    yield (f"delaunay_{m2}sq_rcm_l1jac_V_cg",
           lambda: (delaunay_laplacian(m2 * m2), None),
           AMGParams(smoother="l1jacobi", coarsening="pmis",
                     interpolation="extpi", interp_max=4,
                     rap_drop_tol=0.01),
           KrylovParams(method="cg", tol=1e-8, maxiter=300))


def run_one(name, build, params, krylov):
    import jax
    from sparsh_amg_tpu.setup.hierarchy import amg_setup
    from sparsh_amg_tpu.solve.solver import AMGSolver
    rec = {"name": name}
    t0 = time.perf_counter()
    A, ns = build()
    A = A.tocsr()
    rec["n"] = int(A.shape[0])
    rec["nnz"] = int(A.nnz)
    rec["gen_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hier = amg_setup(A, params, nullspace=ns)
    rec["amg_setup_s"] = time.perf_counter() - t0
    rec["levels"] = hier.n_levels
    rec["operator_complexity"] = hier.operator_complexity()
    t0 = time.perf_counter()
    solver = AMGSolver(A, params, krylov, hierarchy=hier)
    rec["to_device_s"] = time.perf_counter() - t0
    rec["setup_s"] = rec["amg_setup_s"] + rec["to_device_s"]
    rec["device_ops"] = [type(l.A).__name__ for l in solver.device.levels]
    rec["device_bytes_mb"] = solver.device_bytes() / 1e6
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    t0 = time.perf_counter()
    solver.warm()
    rec["warm_s"] = time.perf_counter() - t0
    rhs = solver.prepare_rhs(b)
    solver.solve(rhs, tol=1e-2)          # prime contraction estimate
    res = solver.solve(rhs)
    rec.update(iterations=res.iterations, refine_passes=res.refine_passes,
               converged=bool(res.converged), relres=res.relres,
               solve_s=res.solve_time)
    x = res.x
    rec["true_relres"] = float(np.linalg.norm(b - A @ x)
                               / np.linalg.norm(b))
    print(f"{name}: n={rec['n']:,} iters={res.iterations} "
          f"relres={res.relres:.2e} solve={res.solve_time:.2f}s "
          f"setup={rec['setup_s']:.1f}s opC="
          f"{rec['operator_complexity']:.2f} ops={rec['device_ops']}",
          flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="substring filter on config names")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide problem sizes by this (CPU smoke test)")
    ap.add_argument("--out", default="configs.json")
    args = ap.parse_args()

    import jax
    from sparsh_amg_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    out = {"device": str(dev), "platform": dev.platform,
           "kind": dev.device_kind,
           "ts": time.strftime("%Y-%m-%d %H:%M:%S"), "configs": []}
    for name, build, params, krylov in configs(args.scale):
        if args.only and args.only not in name:
            continue
        try:
            out["configs"].append(run_one(name, build, params, krylov))
        except Exception as e:
            traceback.print_exc()
            out["configs"].append({"name": name, "error": repr(e)})
    out["ok"] = all(c.get("converged") and c.get("true_relres", 1) <= 1e-8
                    for c in out["configs"])
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"ok": out["ok"],
                      "n_configs": len(out["configs"])}))
    sys.exit(0 if out["ok"] else 1)


if __name__ == "__main__":
    main()
