"""Benchmark / example-driver CLI (SURVEY.md §2 C26: the reference's main()
programs read a matrix, pick strategy/smoother/cycle via argv, solve, and
print timings).

    python -m sparsh_amg_tpu.cli --problem poisson3d --n 8000000 \
        --smoother chebyshev --cycle V --krylov cg --tol 1e-8 --json
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .params import AMGParams, KrylovParams
from .models import get_problem
from .solve.solver import AMGSolver


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sparsh_amg_tpu",
                                description=__doc__)
    p.add_argument("--problem", default="poisson2d",
                   help="poisson2d|poisson3d|anisotropic|elasticity|"
                        "elasticity3d|jump|convection|convection3d|anisotropic3d or "
                        "a path to a "
                        "MatrixMarket .mtx file")
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--rhs", default=None, metavar="PATH",
                   help="right-hand-side file (.mtx array or plain text); "
                        "default is a seeded random vector")
    p.add_argument("--theta", type=float, default=0.25)
    p.add_argument("--coarsening", default="rs",
                   choices=["rs", "pmis", "hmis", "aggregation"])
    p.add_argument("--interpolation", default=None,
                   choices=[None, "direct", "extpi", "tentative", "smoothed"])
    p.add_argument("--interp-max", type=int, default=6,
                   help="max interpolation entries per row (truncation)")
    p.add_argument("--agg-levels", type=int, default=0,
                   help="aggressive (composed double) coarsening on the "
                        "first k levels")
    p.add_argument("--aggressive", default="composed",
                   choices=["composed", "pmis2"],
                   help="aggressive-step scheme: composed = two full "
                        "rounds via an intermediate RAP; pmis2 = second "
                        "PMIS on the distance-2 C-C graph + smoothed "
                        "multipass interpolation (no intermediate "
                        "operator, ~2x faster setup)")
    p.add_argument("--rap-drop-tol", type=float, default=0.0,
                   help="Galerkin operator drop/lump filter threshold")
    p.add_argument("--agg-blocksize", type=int, default=1,
                   help="dofs per node for node-amalgamated aggregation "
                        "(2 = 2-D elasticity; coarse levels amalgamate "
                        "by the near-nullspace dimension automatically)")
    p.add_argument("--no-p-smooth-filter", action="store_true",
                   help="SA: smooth P with the UNFILTERED operator "
                        "(systems recipe — pair with --agg-blocksize; "
                        "keeps opC bounded via node aggregation while "
                        "preserving cross-dof couplings)")
    p.add_argument("--smoother", default="jacobi",
                   choices=["jacobi", "l1jacobi", "chebyshev", "gs2"])
    p.add_argument("--cycle", default="V", choices=["V", "W", "F"])
    p.add_argument("--nu1", type=int, default=1)
    p.add_argument("--nu2", type=int, default=1)
    p.add_argument("--krylov", default="cg",
                   choices=["cg", "bicgstab", "amg"],
                   help="amg = standalone cycle iteration (no Krylov)")
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--maxiter", type=int, default=500)
    p.add_argument("--no-refine", action="store_true")
    p.add_argument("--coarse-size", type=int, default=1024)
    p.add_argument("--dense-size", type=int, default=2048)
    p.add_argument("--band-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--loop-mode", default="host",
                   choices=["host", "device", "auto"],
                   help="Krylov loop placement (see KrylovParams; auto "
                        "probes the per-dispatch RTT)")
    p.add_argument("--chunk", type=int, default=4,
                   help="iterations per dispatch in host loop mode")
    p.add_argument("--reorder", default="auto",
                   choices=["auto", "rcm", "none"])
    p.add_argument("--dist", type=int, default=0, metavar="N",
                   help="row-shard over N devices (0 = serial single device)")
    p.add_argument("--save-hierarchy", default=None, metavar="PATH.npz",
                   help="serialize the host hierarchy after setup")
    p.add_argument("--load-hierarchy", default=None, metavar="PATH.npz",
                   help="reuse a saved hierarchy instead of running setup")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the solve into DIR")
    p.add_argument("--coarse-solver", default="lu",
                   choices=["lu", "cholesky", "smooth"])
    p.add_argument("--verbose", action="store_true",
                   help="per-chunk/per-pass structured residual logging")
    p.add_argument("--json", action="store_true",
                   help="print one JSON line with the results")
    return p


def run(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if args.verbose:
        import logging
        from .utils.logging import get_logger
        get_logger().setLevel(logging.DEBUG)
    interp = args.interpolation or (
        "smoothed" if args.coarsening == "aggregation" else "direct")
    params = AMGParams(theta=args.theta, coarsening=args.coarsening,
                       interpolation=interp, smoother=args.smoother,
                       cycle=args.cycle, nu1=args.nu1, nu2=args.nu2,
                       coarse_size=args.coarse_size, reorder=args.reorder,
                       dense_size=args.dense_size,
                       band_dtype=args.band_dtype,
                       coarse_solver=args.coarse_solver,
                       interp_max=args.interp_max,
                       agg_levels=args.agg_levels,
                       aggressive=args.aggressive,
                       agg_blocksize=args.agg_blocksize,
                       p_smooth_filter=not args.no_p_smooth_filter,
                       rap_drop_tol=args.rap_drop_tol)
    krylov = KrylovParams(method=args.krylov, tol=args.tol,
                          maxiter=args.maxiter, refine=not args.no_refine,
                          loop_mode=args.loop_mode, chunk=args.chunk)

    if args.problem.endswith((".mtx", ".mm")):
        from .utils.io import read_matrix, read_rhs
        A = read_matrix(args.problem)
        if args.rhs:
            b = read_rhs(args.rhs, n=A.shape[0])
        else:
            rng = np.random.default_rng(0)
            b = rng.standard_normal(A.shape[0])
        name = args.problem
        nullspace = None
    else:
        prob = get_problem(args.problem, n=args.n)
        A, b, name = prob.A, prob.b, prob.name
        nullspace = prob.nullspace
        if args.rhs:
            from .utils.io import read_rhs
            b = read_rhs(args.rhs, n=A.shape[0])

    hierarchy = None
    if args.load_hierarchy:
        from .utils.serialize import load_hierarchy
        hierarchy = load_hierarchy(args.load_hierarchy)
    if args.dist:
        from .parallel.solver import DistAMGSolver, default_mesh
        solver = DistAMGSolver(A, mesh=default_mesh(args.dist),
                               params=params, krylov=krylov,
                               hierarchy=hierarchy, nullspace=nullspace)
    else:
        solver = AMGSolver(A, params, krylov, hierarchy=hierarchy,
                           nullspace=nullspace)
    if args.save_hierarchy:
        from .utils.serialize import save_hierarchy
        save_hierarchy(args.save_hierarchy, solver.hierarchy)

    if args.profile:
        import jax
        with jax.profiler.trace(args.profile):
            res = solver.solve(b)
    else:
        res = solver.solve(b)
    nnz = A.nnz
    out = {
        "problem": name, "n": A.shape[0], "nnz": int(nnz),
        "levels": solver.hierarchy.n_levels,
        "operator_complexity": solver.hierarchy.operator_complexity(),
        "converged": bool(res.converged), "relres": res.relres,
        "iterations": res.iterations, "refine_passes": res.refine_passes,
        "setup_time_s": res.setup_time, "solve_time_s": res.solve_time,
        "dof_per_s": A.shape[0] * max(res.iterations, 1) / max(res.solve_time, 1e-12),
    }
    if args.json:
        print(json.dumps(out))
    else:
        print(solver.hierarchy)
        print(res)
        for k, v in out.items():
            print(f"{k:>22s}: {v}")
    return out


if __name__ == "__main__":
    run()
