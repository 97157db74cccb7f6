"""Per-host row-block setup (setup/blocked.py; VERDICT r3 next #1/#2/#7).

The blocked path must reproduce the GLOBAL setup exactly: PMIS weights
are pure functions of global index + exchanged ST-degrees, and every
interpolation row is computed by the same native kernel on the same
(ghost-extended, order-preserving) inputs, so per-block computation with
boundary exchanges is bit-identical to the one-host computation.
Asserted here for the plain extpi step, the AGGRESSIVE flagship step
(pmis2 second round + multipass + Jacobi repair), and the FULL blocked
hierarchy (recursion + gathered coarse tail), plus convergence and
distributed-solver handoff runs.
"""
import numpy as np
import pytest
import scipy.sparse as sp

from sparsh_amg_tpu.models.poisson import poisson3d, poisson2d
from sparsh_amg_tpu.params import AMGParams, KrylovParams
from sparsh_amg_tpu.setup.strength import classical_strength
from sparsh_amg_tpu.setup.splitting import pmis_splitting
from sparsh_amg_tpu.setup.interp import extpi_interpolation, truncate_rows
from sparsh_amg_tpu.setup.blocked import (block_bounds, blocked_pmis_comm,
                                          blocked_coarsen_once,
                                          blocked_coarsen_step,
                                          blocked_amg_setup, stitch_blocked,
                                          _vstack_blocks)
from sparsh_amg_tpu.setup.comm import run_blocked
from sparsh_amg_tpu.setup.hierarchy import amg_setup, Hierarchy, Level
from sparsh_amg_tpu.setup.galerkin import galerkin_product
from sparsh_amg_tpu.setup.transpose import csr_transpose

PARAMS = AMGParams(coarsening="pmis", interpolation="extpi", interp_max=4)
# the flagship production config (bench.py): aggressive pmis2 first level,
# multipass + fused Jacobi repair, ML-filtered RAP
FLAGSHIP = AMGParams(coarsening="pmis", interpolation="extpi",
                     interp_max=4, rap_drop_tol=0.01, agg_levels=1,
                     interp_max_composed=5, intermediate_drop_tol=0.02,
                     aggressive="pmis2")


def _global_once(A, params):
    mask, S = classical_strength(A, params.theta)
    cf = pmis_splitting(S)
    P = truncate_rows(extpi_interpolation(A, mask, cf), params.interp_max)
    return P, cf, S


def _csr_equal(X, Y):
    return (X.shape == Y.shape and np.array_equal(X.indptr, Y.indptr)
            and np.array_equal(X.indices, Y.indices)
            and np.array_equal(X.data, Y.data))


@pytest.mark.parametrize("nside,n_blocks", [(16, 3), (64, 8)])
def test_blocked_matches_global_poisson3d(nside, n_blocks):
    A = poisson3d(nside)
    P_g, cf_g, _ = _global_once(A, PARAMS)
    P_b, cf_b = blocked_coarsen_once(A, PARAMS, n_blocks)
    assert np.array_equal(cf_g, cf_b)
    assert _csr_equal(P_g, P_b)


def test_blocked_pmis_alone_matches_native():
    """The distributed PMIS driver (per-round boundary exchange through
    the comm) equals the native single-host pmis on an anisotropic 2-D
    problem."""
    from sparsh_amg_tpu.models.anisotropic import anisotropic2d
    A = anisotropic2d(48, epsilon=1e-3, angle_deg=30.0)
    mask, S = classical_strength(A, PARAMS.theta)
    cf_g = pmis_splitting(S)
    n = A.shape[0]
    nb = 5
    bounds = block_bounds(n, nb)

    def fn(rank, comm):
        r0, r1 = int(bounds[rank]), int(bounds[rank + 1])
        _, S_o = classical_strength(A[r0:r1].tocsr(), PARAMS.theta,
                                    row_offset=r0)
        return blocked_pmis_comm(S_o, r0, r1, bounds, comm, seed=0)

    cf_b = np.concatenate(run_blocked(fn, nb))
    assert np.array_equal(cf_g, cf_b)


def test_blocked_direct_interp():
    p = AMGParams(coarsening="pmis", interpolation="direct", interp_max=4)
    A = poisson2d(24)
    mask, S = classical_strength(A, p.theta)
    cf = pmis_splitting(S)
    from sparsh_amg_tpu.setup.interp import direct_interpolation
    P_g = truncate_rows(direct_interpolation(A, mask, cf), p.interp_max)
    P_b, cf_b = blocked_coarsen_once(A, p, 4)
    assert np.array_equal(cf, cf_b)
    assert _csr_equal(P_g, P_b)


def test_blocked_aggressive_step_bit_identical():
    """The blocked AGGRESSIVE step (distributed dist-2 C-C graph, second
    PMIS round, per-pass multipass exchanges, fused Jacobi repair) is
    bit-identical to the global `_coarsen_aggressive` — the flagship
    coarsening a multi-host run would actually use (VERDICT r3 missing
    #2)."""
    from sparsh_amg_tpu.setup.hierarchy import _coarsen_aggressive
    A = poisson3d(20).tocsr()
    P_g, cf_g = _coarsen_aggressive(A, FLAGSHIP)
    for nb in (3, 8):
        bounds = block_bounds(A.shape[0], nb)

        def fn(rank, comm):
            r0, r1 = int(bounds[rank]), int(bounds[rank + 1])
            return blocked_coarsen_step(A[r0:r1].tocsr(), r0, r1, bounds,
                                        comm, FLAGSHIP, aggressive=True)

        outs = run_blocked(fn, nb)
        P_b = _vstack_blocks([o[0] for o in outs])
        cf_b = np.concatenate([o[1] for o in outs])
        assert np.array_equal(cf_g, cf_b), f"cf mismatch at nb={nb}"
        assert _csr_equal(P_g, P_b), f"P mismatch at nb={nb}"


def test_blocked_full_hierarchy_flagship():
    """Full blocked hierarchy under the FLAGSHIP config: blocked levels'
    (cf, P) bit-identical to the global setup, coarse operators equal to
    rounding (the RAP sums rank contributions in a different order), and
    the solve converges in the same +-1 iterations (VERDICT r3 next #1
    'blocked flagship hierarchy matches global')."""
    from sparsh_amg_tpu.solve.solver import AMGSolver
    A = poisson3d(24)
    H_g = amg_setup(A, FLAGSHIP)
    nb = 4
    bounds = block_bounds(A.shape[0], nb)

    def fn(rank, comm):
        r0, r1 = int(bounds[rank]), int(bounds[rank + 1])
        return blocked_amg_setup(A[r0:r1].tocsr(), bounds, comm, FLAGSHIP)

    parts = run_blocked(fn, nb)
    # no rank ever built a matrix taller than its block + the coarse tail
    for rank, p in enumerate(parts):
        r0, r1 = int(bounds[rank]), int(bounds[rank + 1])
        assert p.levels[0].A.shape[0] == r1 - r0
    H_b = stitch_blocked(parts)
    assert H_b.n_levels == H_g.n_levels
    n_blk = len(parts[0].levels)
    assert n_blk >= 1
    for i in range(n_blk):
        lg, lb = H_g.levels[i], H_b.levels[i]
        assert np.array_equal(lg.cf, lb.cf), f"cf level {i}"
        assert _csr_equal(lg.P, lb.P), f"P level {i}"
        assert _csr_equal(lg.R, lb.R), f"R level {i}"
    # coarse operators agree to rounding
    for i in range(1, H_g.n_levels):
        lg, lb = H_g.levels[i], H_b.levels[i]
        assert lg.A.shape == lb.A.shape
        d = abs(lg.A - lb.A)
        scale = max(abs(lg.A).max(), 1.0)
        assert (d.max() if d.nnz else 0.0) <= 1e-12 * scale

    kr = KrylovParams(method="cg", tol=1e-8)
    b = np.random.default_rng(7).standard_normal(A.shape[0])
    res_g = AMGSolver(A, FLAGSHIP, kr, hierarchy=H_g).solve(b)
    res_b = AMGSolver(A, FLAGSHIP, kr, hierarchy=H_b).solve(b)
    assert res_g.converged and res_b.converged
    assert abs(res_g.iterations - res_b.iterations) <= 1


def test_blocked_setup_to_distributed_handoff():
    """Per-host row-block setup feeds the DISTRIBUTED solver: the
    hierarchy whose finest level came from blocked setup solves under an
    8-way shard_map with the same iteration count as the fully-global
    distributed solve (SURVEY §3.2 setup -> MPI-boundary handoff)."""
    import jax
    from sparsh_amg_tpu.parallel.solver import DistAMGSolver, default_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    A = poisson3d(24)
    params = PARAMS
    kr = KrylovParams(method="cg", tol=1e-8)
    P, cf = blocked_coarsen_once(A, params, 8)
    R = csr_transpose(P)
    Ac = galerkin_product(A, P, R=R, drop_tol=params.rap_drop_tol)
    sub = amg_setup(Ac, params)
    hier_b = Hierarchy(
        levels=[Level(A=A.astype(np.float64), P=P, R=R, cf=cf)]
        + sub.levels, params=params)
    b = np.random.default_rng(11).standard_normal(A.shape[0])
    mesh = default_mesh(8)
    res_b = DistAMGSolver(A, mesh=mesh, params=params, krylov=kr,
                          hierarchy=hier_b).solve(b)
    res_g = DistAMGSolver(A, mesh=mesh, params=params, krylov=kr).solve(b)
    assert res_b.converged and res_g.converged
    assert abs(res_b.iterations - res_g.iterations) <= 1
    np.testing.assert_allclose(res_b.x, res_g.x, rtol=1e-6, atol=1e-8)


def test_blocked_hierarchy_convergence():
    """Hierarchy whose finest level came from the blocked setup converges
    in the same iteration count (+-1) as the global setup."""
    from sparsh_amg_tpu.solve.solver import AMGSolver
    A = poisson3d(32)
    params = PARAMS
    kr = KrylovParams(method="cg", tol=1e-8)

    hier_g = amg_setup(A, params)

    P, cf = blocked_coarsen_once(A, params, 4)
    R = csr_transpose(P)
    Ac = galerkin_product(A, P, R=R, drop_tol=params.rap_drop_tol)
    sub = amg_setup(Ac, params)
    A0 = A.astype(np.float64)
    hier_b = Hierarchy(
        levels=[Level(A=A0, P=P, R=R, cf=cf)] + sub.levels, params=params)

    b = np.random.default_rng(3).standard_normal(A.shape[0])
    res_g = AMGSolver(A, params, kr, hierarchy=hier_g).solve(b)
    res_b = AMGSolver(A, params, kr, hierarchy=hier_b).solve(b)
    assert res_g.converged and res_b.converged
    assert abs(res_g.iterations - res_b.iterations) <= 1


def test_pipecomm_matches_threadcomm(monkeypatch):
    """PipeComm (forked processes, pairwise pipes — the deployment-shaped
    cost-harness transport) produces the identical blocked hierarchy to
    ThreadComm: same level-0 cf/P per rank and same level sizes.  The
    fused-RAP gate is forced open so the branch production sizes take
    (thread_local native arena) runs under BOTH transports — at the
    default gate every toy size falls through to two-pass and the
    equivalence would be vacuous for the fused path."""
    import sparsh_amg_tpu.setup.blocked as blocked_mod
    from sparsh_amg_tpu.setup.comm import run_blocked_procs
    monkeypatch.setattr(blocked_mod, "_FUSED_MIN_NNZ", 0)
    m, nb = 20, 4
    A = poisson3d(m)
    n = A.shape[0]
    bounds = block_bounds(n, nb)

    def fn(rank, comm):
        r0, r1 = int(bounds[rank]), int(bounds[rank + 1])
        H = blocked_amg_setup(A[r0:r1].tocsr(), bounds, comm, FLAGSHIP)
        l0 = H.levels[0]
        return (l0.cf, l0.P.indices.copy(), l0.P.data.copy(),
                [(l.n, l.A.nnz) for l in H.levels],
                [(l.n, l.nnz) for l in H.tail.levels])

    ref = run_blocked(fn, nb)            # threads (the pytest harness)
    got = run_blocked_procs(fn, nb)      # forked processes + pipes
    for r in range(nb):
        assert np.array_equal(ref[r][0], got[r][0])
        assert np.array_equal(ref[r][1], got[r][1])
        assert np.array_equal(ref[r][2], got[r][2])
        assert ref[r][3] == got[r][3]
        assert ref[r][4] == got[r][4]


def test_run_blocked_procs_raises_on_rank_failure():
    """A rank failure must raise in the parent, not hang: the parent
    closes its pipe-end copies so a dead child's result recv sees EOF,
    and peers blocked in collectives EOF in turn (review finding r4)."""
    from sparsh_amg_tpu.setup.comm import run_blocked_procs

    def fn(rank, comm):
        if rank == 1:
            raise ValueError("boom on rank 1")
        comm.allgather(rank)               # peers unblock via pipe EOF
        return rank

    with pytest.raises(RuntimeError, match="failed"):
        run_blocked_procs(fn, 3)
