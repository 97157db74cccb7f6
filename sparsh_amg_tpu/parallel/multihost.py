"""Multi-host / multi-process execution (SURVEY.md §5.8, §4.4).

The reference launches one MPI rank per GPU across nodes; the JAX
equivalent is `jax.distributed.initialize()` + a mesh spanning every
process's devices.  Each process runs the same SPMD program; after
`init_multihost()` `jax.devices()` returns the global device list and
`DistAMGSolver` row-shards across all of them through the same
collectives.  On one multi-GPU host a single process drives every card
(`DistAMGSolver(A, mesh=default_mesh(4))`) and needs none of this.

`launch_processes()` is a CPU test harness only: it spawns N CPU
processes, each with its own virtual devices federated through the
coordination service (gloo collectives), and the worker below runs a
full distributed solve whose iteration count and answer must match the
single-process run — `tests/test_multihost.py` asserts exactly that
(SURVEY.md §4.4: "multi-host logic testable via `jax.distributed`
multi-process on one machine").  One-rank-per-GPU runs through it are
not supported yet.

The two primitives every multi-process-clean data path needs:

* `put_sharded`  — upload a host-stacked pytree so each process feeds only
  its ADDRESSABLE shards (`jax.make_array_from_callback`); a bare
  `device_put` of a global array is single-process-only.
* `gather_to_host` — fetch a row-sharded global array back to every host
  (resharding identity jit to a fully-replicated layout); a bare
  `device_get` of a non-addressable array raises.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   cpu_devices_per_process: int | None = None) -> None:
    """Initialize the JAX distributed runtime (no-op if single-process).

    Pass the arguments explicitly (the reference's mpirun analog: one
    process per host); nothing in a plain GPU host's environment describes
    a cluster.  ``cpu_devices_per_process`` forces the CPU backend with
    that many virtual devices per process and gloo cross-process
    collectives — the test configuration.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if cpu_devices_per_process is not None:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", cpu_devices_per_process)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = "rows") -> Mesh:
    """1-D mesh over every device of every participating host."""
    return Mesh(np.array(jax.devices()), (axis,))


# ---------------------------------------------------------------------------
# Multi-process-safe data movement
# ---------------------------------------------------------------------------

def put_sharded(tree, mesh: Mesh, axis: str):
    """Shard every leaf's leading axis over ``mesh`` — multi-process-safe.

    Single-process this is exactly ``jax.device_put(tree, sh)``.  Multi-
    process, each process holds the full host-stacked array (leading axis
    = global shard count) but only its addressable devices' rows are
    uploaded, via ``jax.make_array_from_callback`` — the replacement for
    the reference's per-rank H2D of its row block (SURVEY.md §3.5).
    """
    sh = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        return jax.device_put(tree, sh)

    def put_leaf(leaf):
        host = np.asarray(leaf)
        return jax.make_array_from_callback(host.shape, sh,
                                            lambda idx: host[idx])
    return jax.tree.map(put_leaf, tree)


def replicate_fn(mesh: Mesh):
    """Jitted identity that reshards to fully-replicated — the multi-
    process-safe way to read a row-sharded result back on every host
    (cache the returned callable: it compiles once per shape)."""
    return jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))


def gather_to_host(x, mesh: Mesh, _rep=None) -> np.ndarray:
    """Fetch a (possibly non-addressable) global array to host numpy."""
    if jax.process_count() == 1:
        return np.asarray(jax.device_get(x))
    rep = _rep if _rep is not None else replicate_fn(mesh)
    return np.asarray(jax.device_get(rep(x)))


# ---------------------------------------------------------------------------
# Pod-less multi-process harness (launcher + worker)
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_processes(num_processes: int, n: int = 24,
                     devices_per_process=2,
                     timeout: float = 900.0, setup: str = "blocked",
                     krylov_method: str = "cg",
                     problem: str = "poisson3d",
                     row_align: int | None = None) -> list[dict]:
    """Spawn ``num_processes`` federated CPU worker processes, each running
    the full distributed solve below; returns their result dicts.

    The CPU stand-in for `mpirun -np N`: same program, same collectives,
    real process boundaries (gloo over TCP).  Workers always run on the
    CPU backend.

    ``setup="blocked"`` (default) runs the PROCESS-LOCAL path: each
    worker assembles only its row block, coarsens through the blocked
    per-host setup and uploads only addressable shards (VERDICT r3 next
    #1).  ``setup="global"`` keeps the legacy every-process-builds-
    everything path (uneven ``devices_per_process`` lists are only
    supported here).  ``devices_per_process`` may be an int or a
    per-process list (uneven topologies; gloo doesn't care).
    """
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    # the worker sizes its own virtual-device count; strip any inherited
    # force_host flag (pytest's conftest sets 8) so they don't fight
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    env["XLA_FLAGS"] = " ".join(flags)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    if np.ndim(devices_per_process) == 0:
        dpp = [int(devices_per_process)] * num_processes
    else:
        dpp = [int(d) for d in devices_per_process]
    tmp = tempfile.TemporaryDirectory()
    outs = [os.path.join(tmp.name, f"worker_{i}.json")
            for i in range(num_processes)]
    procs = []
    for i in range(num_processes):
        cmd = [sys.executable, "-m", "sparsh_amg_tpu.parallel.multihost",
               "--process-id", str(i),
               "--num-processes", str(num_processes),
               "--coordinator", f"localhost:{port}",
               "--devices-per-process", str(dpp[i]),
               "--n", str(n), "--setup", setup, "--problem", problem,
               "--krylov", krylov_method, "--out", outs[i]]
        if row_align is not None:
            cmd += ["--row-align", str(row_align)]
        procs.append(subprocess.Popen(cmd, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    results = []
    with tmp:
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            if p.returncode != 0:
                for q in procs:
                    q.kill()
                raise RuntimeError(
                    f"worker {i} failed (rc={p.returncode}):\n"
                    + out.decode(errors="replace")[-4000:])
            with open(outs[i]) as f:
                results.append(json.load(f))
    return results


def _elasticity_sa_params(row_align: int = 6144):
    """The RBM-SA elasticity recipe (scripts/run_configs.py
    elasticity3d row), with the node/nullspace row alignment the blocked
    setup requires: row blocks must not split a node's 3 dofs or an
    aggregate's 6 coarse dofs — lcm(2048, 3, 6) = 6144 also keeps the
    device invariant (levels pad to 2048 multiples)."""
    from ..params import AMGParams
    return AMGParams(coarsening="aggregation", interpolation="smoothed",
                     smoother="chebyshev", coarse_size=200,
                     agg_blocksize=3, p_smooth_filter=False,
                     row_align=row_align)


def _problem_spec(problem: str, m: int, row_align: int | None = None):
    """(n_glob, make_rows, make_nullspace, params) for a worker."""
    if problem == "poisson3d":
        from ..models.poisson import poisson3d_rows
        from ..params import flagship_params
        return (m ** 3,
                lambda r0, r1: poisson3d_rows(m, r0, r1),
                None, flagship_params())
    if problem == "elasticity3d":
        from ..models.elasticity import (elasticity3d_rows,
                                         elasticity3d_nullspace_rows)
        n_glob = 3 * (m + 1) ** 2 * m       # x==0 face clamped
        params = _elasticity_sa_params(row_align or 6144)
        return (n_glob,
                lambda r0, r1: elasticity3d_rows(m, r0, r1),
                lambda r0, r1: elasticity3d_nullspace_rows(m, r0, r1),
                params)
    raise ValueError(f"unknown problem {problem!r}")


def _worker_main(argv=None) -> None:
    import argparse
    import resource
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--devices-per-process", type=int, default=2)
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--setup", choices=("blocked", "global"),
                    default="blocked")
    ap.add_argument("--problem", choices=("poisson3d", "elasticity3d"),
                    default="poisson3d")
    ap.add_argument("--row-align", type=int, default=None)
    ap.add_argument("--krylov", default="cg")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    init_multihost(coordinator_address=args.coordinator,
                   num_processes=args.num_processes,
                   process_id=args.process_id,
                   cpu_devices_per_process=args.devices_per_process)

    from ..params import KrylovParams
    from .solver import DistAMGSolver

    n_glob, make_rows, make_ns, params = _problem_spec(
        args.problem, args.n, args.row_align)
    krylov = KrylovParams(method=args.krylov, tol=1e-8,
                          maxiter=60 if args.problem == "poisson3d"
                          else 200)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n_glob)      # deterministic rhs; sliced below

    if args.setup == "blocked":
        # PROCESS-LOCAL path: assemble only the owned row block, blocked
        # per-host setup, addressable-shard upload, rank-local result.
        solver = DistAMGSolver.from_blocked(
            make_rows, n_glob, mesh=global_mesh(), params=params,
            krylov=krylov, make_nullspace=make_ns)
        r0, r1 = solver.row_range
        b_loc = np.ascontiguousarray(b[r0:r1])
        del b                       # steady state holds only the block
        res = solver.solve(b_loc)
        x_loc = np.asarray(res.x, dtype=np.float64)
        # true residual on the owned rows against the global solution
        # (explicit opt-in gather — the only O(n) array this worker
        # ever forms, and only for this verification)
        x_glob = solver.gather_global(res)
        A_own = solver.blocked.levels[0].A
        r_own = A_own @ x_glob - b_loc
        rn = float(solver.comm.allreduce_sum(float(np.dot(r_own, r_own))))
        bn = float(solver.comm.allreduce_sum(float(np.dot(b_loc, b_loc))))
        true_relres = float(np.sqrt(rn / bn))
        local_rows = int(A_own.shape[0])
        local_nnz = int(A_own.nnz)
        blk_nnz = int(sum(l.A.nnz for l in solver.blocked.levels))
        tail_nnz = int(sum(l.nnz for l in solver.blocked.tail.levels))
        holds_global_fine = False
    else:
        if args.problem == "elasticity3d":
            from ..models.elasticity import (elasticity3d,
                                             elasticity3d_nullspace)
            A = elasticity3d(args.n)
            ns = elasticity3d_nullspace(args.n)
        else:
            from ..models.poisson import poisson3d
            A = poisson3d(args.n)
            ns = None
        solver = DistAMGSolver(A, mesh=global_mesh(), params=params,
                               krylov=krylov, nullspace=ns)
        res = solver.solve(b)
        r0, r1 = solver.row_range       # (0, n): global mode
        x_loc = np.asarray(res.x, dtype=np.float64)
        r = A @ x_loc - b
        true_relres = float(np.linalg.norm(r) / np.linalg.norm(b))
        local_rows = int(A.shape[0])
        local_nnz = int(A.nnz)
        blk_nnz = tail_nnz = 0
        holds_global_fine = True

    out = {
        "process_id": args.process_id,
        "process_count": jax.process_count(),
        "n_devices": len(jax.devices()),
        "n_local_devices": len(jax.local_devices()),
        "n": n_glob,
        "problem": args.problem,
        "setup": args.setup,
        "krylov": args.krylov,
        "iterations": res.iterations,
        "passes": res.refine_passes,
        "relres": res.relres,
        "converged": bool(res.converged),
        "true_relres": true_relres,
        "row_range": [int(r0), int(r1)],
        "local_rows": local_rows,
        "local_nnz": local_nnz,
        "blocked_levels_nnz": blk_nnz,
        "tail_nnz": tail_nnz,
        "holds_global_fine": holds_global_fine,
        "setup_s": float(solver.setup_time),
        "maxrss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0,
        "x_norm": float(np.linalg.norm(x_loc)),
        "x_head": x_loc[:8].tolist(),
    }
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"worker {args.process_id}: setup={args.setup} "
          f"iters={res.iterations} relres={res.relres:.2e} "
          f"rows=[{r0},{r1}) devices={len(jax.devices())}")


if __name__ == "__main__":
    _worker_main()
