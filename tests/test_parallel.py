"""Distributed-path tests on the 8-virtual-device CPU mesh (SURVEY.md §4.4:
the JAX-native 'fake backend' — shard_map halo exchange, psum dots, and
agglomerated coarse solves exercised without several cards)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparsh_amg_tpu.models.poisson import poisson2d, poisson3d
from sparsh_amg_tpu.params import AMGParams, KrylovParams
from sparsh_amg_tpu.parallel import (Partition, csr_to_dist, DistAMGSolver)
from sparsh_amg_tpu.parallel.dist import DistDia, DistEll
from sparsh_amg_tpu.parallel.solver import default_mesh
from sparsh_amg_tpu.parallel.hierarchy import local
from sparsh_amg_tpu.solve.solver import AMGSolver


NDEV = len(jax.devices())


def _rand_csr(n, m, density, seed, banded=None):
    rng = np.random.default_rng(seed)
    A = sp.random(n, m, density=density, random_state=rng,
                  format="csr", dtype=np.float64)
    if banded is not None:
        rows = np.repeat(np.arange(n), np.diff(A.indptr))
        keep = np.abs(A.indices - rows * m // n) <= banded
        A.data[~keep] = 0.0
        A.eliminate_zeros()
    return A


def _dist_spmv_host(A, op, part_dst, part_src, mesh):
    """Run op.spmv under shard_map and return the logical result."""
    axis = mesh.axis_names[0]

    @jax.jit
    def run(op_st, x_st):
        def body(op_s, x_s):
            return local(op_s).spmv(x_s[0])[None]
        return jax.shard_map(body, mesh=mesh, in_specs=(P(axis), P(axis)),
                             out_specs=P(axis))(op_st, x_st)

    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.shape[1])
    xp = jnp.asarray(part_src.pad_vec(x), dtype=jnp.float32)
    y = run(op, xp)
    return part_dst.unpad_vec(np.asarray(y)), A @ x


@pytest.mark.parametrize("n", [40, 700])
def test_dist_dia_spmv_poisson(n):
    A = poisson2d(int(np.sqrt(n)) or 2)
    part = Partition.make(A.shape[0], NDEV)
    mesh = default_mesh()
    op = csr_to_dist(A, part, part)
    assert isinstance(op, DistDia)
    got, want = _dist_spmv_host(A, op, part, part, mesh)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


def test_dist_ell_halo_spmv():
    # banded random matrix -> halo mode
    n = 600
    A = _rand_csr(n, n, 0.02, seed=1, banded=60)
    A = A + sp.identity(n)
    part = Partition.make(n, NDEV)
    mesh = default_mesh()
    op = csr_to_dist(A.tocsr(), part, part, prefer_dia=False)
    assert isinstance(op, DistEll)
    got, want = _dist_spmv_host(A, op, part, part, mesh)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


def test_dist_ell_gather_spmv():
    # fully random -> columns reach beyond neighbors -> gather mode
    n = 600
    A = (_rand_csr(n, n, 0.05, seed=2) + sp.identity(n)).tocsr()
    part = Partition.make(n, NDEV)
    mesh = default_mesh()
    op = csr_to_dist(A, part, part, prefer_dia=False)
    assert isinstance(op, DistEll) and op.mode == "gather"
    got, want = _dist_spmv_host(A, op, part, part, mesh)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


def test_dist_rectangular_spmv():
    # P-like operator: fine rows, coarse cols
    nf, nc = 500, 180
    A = (_rand_csr(nf, nc, 0.02, seed=3) +
         sp.csr_matrix((np.ones(nc), (np.arange(nc), np.arange(nc))),
                       shape=(nf, nc))).tocsr()
    pf = Partition.make(nf, NDEV)
    pc = Partition.make(nc, NDEV)
    mesh = default_mesh()
    op = csr_to_dist(A, pf, pc, prefer_dia=False)
    got, want = _dist_spmv_host(A, op, pf, pc, mesh)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


def test_dist_solve_matches_serial_poisson2d():
    A = poisson2d(32)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.shape[0])
    params = AMGParams(coarse_size=40)
    # device loop mode for exact iteration-count parity (host mode rounds
    # counts up to the dispatch chunk)
    kr = KrylovParams(tol=1e-8, loop_mode="device")
    serial = AMGSolver(A, params, kr).solve(b)
    dist = DistAMGSolver(A, params=params, krylov=kr).solve(b)
    assert serial.converged and dist.converged
    # both reach the same tolerance against the true residual
    r_s = np.linalg.norm(b - A @ serial.x) / np.linalg.norm(b)
    r_d = np.linalg.norm(b - A @ dist.x) / np.linalg.norm(b)
    assert r_s <= 1e-8 and r_d <= 1e-8
    # iteration counts should be essentially identical (same algorithm,
    # same hierarchy; only reduction order differs)
    assert abs(dist.iterations - serial.iterations) <= 3


def test_dist_solve_poisson3d_chebyshev():
    A = poisson3d(12)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(A.shape[0])
    params = AMGParams(smoother="chebyshev", coarse_size=40)
    res = DistAMGSolver(A, params=params,
                        krylov=KrylovParams(tol=1e-8)).solve(b)
    assert res.converged
    assert np.linalg.norm(b - A @ res.x) / np.linalg.norm(b) <= 1e-8


def test_dist_solve_nd1_vs_nd8():
    """1-device and 8-device meshes agree (SURVEY.md §4.4)."""
    A = poisson2d(24)
    rng = np.random.default_rng(2)
    b = rng.standard_normal(A.shape[0])
    params = AMGParams(coarse_size=40)
    kr = KrylovParams(tol=1e-8)
    r1 = DistAMGSolver(A, mesh=default_mesh(1), params=params,
                       krylov=kr).solve(b)
    r8 = DistAMGSolver(A, mesh=default_mesh(), params=params,
                       krylov=kr).solve(b)
    assert r1.converged and r8.converged
    np.testing.assert_allclose(r1.x, r8.x, rtol=1e-6, atol=1e-9)


def test_dist_bf16_bands_keep_fp32_krylov_matvec():
    """ADVICE.md (round 1, medium): with band_dtype=bfloat16 the dist
    Krylov matvec must use the fp32 A_df.A_hi, not the bf16 cycle bands —
    otherwise refinement stalls on matrices with bf16-inexact entries.
    Scaling Poisson by pi/3 makes every entry bf16-inexact."""
    A = (poisson3d(12) * (np.pi / 3.0)).tocsr()
    rng = np.random.default_rng(3)
    b = rng.standard_normal(A.shape[0])
    params = AMGParams(coarse_size=40, band_dtype="bfloat16")
    kr = KrylovParams(tol=1e-8, loop_mode="device")
    serial = AMGSolver(A, params, kr).solve(b)
    dist = DistAMGSolver(A, params=params, krylov=kr).solve(b)
    assert serial.converged and dist.converged
    assert np.linalg.norm(b - A @ dist.x) / np.linalg.norm(b) <= 1e-8
    # same algorithm on the same hierarchy: iteration counts and refine
    # passes must match the serial solver (the bf16-matvec bug showed up
    # as ~1.5x the iterations and an extra refinement pass)
    assert dist.refine_passes == serial.refine_passes
    assert abs(dist.iterations - serial.iterations) <= 2


def test_dist_loop_modes_agree():
    """Distributed host-chunked and device while_loop modes agree."""
    A = poisson2d(24)
    b = np.random.default_rng(8).standard_normal(A.shape[0])
    params = AMGParams(coarse_size=40)
    rh = DistAMGSolver(A, params=params,
                       krylov=KrylovParams(loop_mode="host")).solve(b)
    rd = DistAMGSolver(A, params=params,
                       krylov=KrylovParams(loop_mode="device")).solve(b)
    assert rh.converged and rd.converged
    for r in (rh, rd):
        assert np.linalg.norm(b - A @ r.x) / np.linalg.norm(b) <= 1e-8


def test_levelwise_replication_structure_and_equality():
    """Level-wise agglomeration (VERDICT r1 #4): levels at/below
    replicate_size are stored replicated (serial DeviceLevel with a
    stacked shard axis), the boundary carries GatherOut/ReplSrc wrappers,
    and the solve matches the fully-distributed one."""
    from sparsh_amg_tpu.parallel.dist import GatherOut, ReplSrc
    from sparsh_amg_tpu.solve.device import DeviceLevel
    A = poisson3d(16)        # 4096 unknowns, several sub-1k coarse levels
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    params_rep = AMGParams(smoother="chebyshev", coarse_size=40,
                           replicate_size=600)
    params_full = params_rep.replace(replicate_size=0)
    kr = KrylovParams(tol=1e-8, loop_mode="device")
    s_rep = DistAMGSolver(A, params=params_rep, krylov=kr)
    s_full = DistAMGSolver(A, params=params_full, krylov=kr)
    levs = s_rep.dist.levels
    # at least one replicated level and a wrapped transition
    rep_idx = [i for i, l in enumerate(levs) if isinstance(l, DeviceLevel)]
    assert rep_idx, "no replicated levels built"
    trans = rep_idx[0] - 1
    assert trans >= 0
    assert isinstance(levs[trans].R, GatherOut)
    assert isinstance(levs[trans].P, ReplSrc)
    # every level below the boundary is replicated
    assert all(isinstance(levs[i], DeviceLevel)
               for i in range(rep_idx[0], len(levs)))
    r_rep = s_rep.solve(b)
    r_full = s_full.solve(b)
    assert r_rep.converged and r_full.converged
    assert np.linalg.norm(b - A @ r_rep.x) / np.linalg.norm(b) <= 1e-8
    assert abs(r_rep.iterations - r_full.iterations) <= 2


def test_replication_nd1_vs_nd8():
    """1-device and 8-device meshes agree with replication active."""
    A = poisson2d(24)
    b = np.random.default_rng(6).standard_normal(A.shape[0])
    params = AMGParams(coarse_size=40, replicate_size=400)
    kr = KrylovParams(tol=1e-8)
    r1 = DistAMGSolver(A, mesh=default_mesh(1), params=params,
                       krylov=kr).solve(b)
    r8 = DistAMGSolver(A, mesh=default_mesh(), params=params,
                       krylov=kr).solve(b)
    assert r1.converged and r8.converged
    np.testing.assert_allclose(r1.x, r8.x, rtol=1e-6, atol=1e-9)


def test_dist_bicgstab_matches_serial():
    """BiCGStab under shard_map (VERDICT r2 weak #5): nonsymmetric
    convection-diffusion, distributed iteration count matches serial."""
    from sparsh_amg_tpu.models.convection import convection2d
    A = convection2d(24)
    b = np.random.default_rng(7).standard_normal(A.shape[0])
    params = AMGParams(coarse_size=40)
    kr = KrylovParams(method="bicgstab", tol=1e-8, maxiter=200,
                      loop_mode="device")
    serial = AMGSolver(A, params, kr).solve(b)
    dist = DistAMGSolver(A, params=params, krylov=kr).solve(b)
    assert serial.converged and dist.converged
    assert np.linalg.norm(b - A @ dist.x) / np.linalg.norm(b) <= 1e-8
    assert abs(dist.iterations - serial.iterations) <= 3


@pytest.mark.parametrize("cycle", ["W", "F"])
def test_dist_w_f_cycles_match_serial(cycle):
    """W and F cycles under shard_map (VERDICT r2 weak #5)."""
    A = poisson2d(24)
    b = np.random.default_rng(9).standard_normal(A.shape[0])
    params = AMGParams(coarse_size=40, cycle=cycle)
    kr = KrylovParams(tol=1e-8, loop_mode="device")
    serial = AMGSolver(A, params, kr).solve(b)
    dist = DistAMGSolver(A, params=params, krylov=kr).solve(b)
    assert serial.converged and dist.converged
    assert np.linalg.norm(b - A @ dist.x) / np.linalg.norm(b) <= 1e-8
    assert abs(dist.iterations - serial.iterations) <= 2


def test_dist_gs2_smoother_matches_serial():
    """Two-stage Gauss-Seidel under shard_map (VERDICT r2 weak #5): the
    L/U triangle operators cross the distributed path."""
    A = poisson2d(24)
    b = np.random.default_rng(10).standard_normal(A.shape[0])
    params = AMGParams(coarse_size=40, smoother="gs2")
    kr = KrylovParams(tol=1e-8, loop_mode="device")
    serial = AMGSolver(A, params, kr).solve(b)
    dist = DistAMGSolver(A, params=params, krylov=kr).solve(b)
    assert serial.converged and dist.converged
    assert np.linalg.norm(b - A @ dist.x) / np.linalg.norm(b) <= 1e-8
    assert abs(dist.iterations - serial.iterations) <= 2


def test_dist_ell_solve_matches_serial():
    """With replication off and the dense threshold low, the distributed
    hierarchy's irregular levels and transfers freeze as DistEll (halo or
    gather mode) and the 8-device solve matches the serial answer."""
    A = poisson3d(16)
    rng = np.random.default_rng(4)
    b = rng.standard_normal(A.shape[0])
    params = AMGParams(smoother="chebyshev", coarsening="pmis",
                       interpolation="extpi", interp_max=4,
                       rap_drop_tol=0.01, coarse_size=40, dense_size=64,
                       replicate_size=0)   # keep levels distributed
    kr = KrylovParams(tol=1e-8, loop_mode="device")
    dist = DistAMGSolver(A, params=params, krylov=kr)
    kinds = []
    for lev in dist.dist.levels[1:]:
        for op in (lev.A, lev.P, lev.R):
            op = getattr(op, "op", op)      # unwrap GatherOut/ReplSrc
            if op is not None:
                kinds.append(type(op).__name__)
    assert kinds.count("DistEll") >= 3, kinds
    res = dist.solve(b)
    assert res.converged
    assert np.linalg.norm(b - A @ res.x) / np.linalg.norm(b) <= 1e-8
    serial = AMGSolver(A, params, kr).solve(b)
    assert abs(res.iterations - serial.iterations) <= 3
    np.testing.assert_allclose(res.x, serial.x, rtol=1e-6, atol=1e-7)


def test_sub_mesh_agglomeration():
    """sub_mesh_min_rows (SURVEY.md §5.8; VERDICT r3 missing #6):
    mid-size coarse levels concentrate their rows on the leading shards
    (n_loc >= the floor, trailing shards all-padding) instead of
    spreading 128-row slivers across the whole mesh; the solve matches
    the fully-spread one."""
    A = poisson3d(16)        # 4096 unknowns
    b = np.random.default_rng(9).standard_normal(A.shape[0])
    base = AMGParams(smoother="chebyshev", coarse_size=40,
                     replicate_size=100)    # keep mid levels distributed
    sub = base.replace(sub_mesh_min_rows=512)
    kr = KrylovParams(tol=1e-8, loop_mode="device")
    s_sub = DistAMGSolver(A, params=sub, krylov=kr)
    s_spread = DistAMGSolver(A, params=base, krylov=kr)
    # some coarse level is concentrated: bigger shard height than the
    # spread layout and at least one trailing all-padding shard
    concentrated = [
        (ps.n_loc, pf.n_loc, ps.count(ps.nd - 1))
        for li, (ps, pf) in enumerate(zip(s_sub.dist.parts,
                                          s_spread.dist.parts))
        if li > 0 and ps.n_loc > pf.n_loc]
    assert concentrated, "no level concentrated"
    assert any(c[2] == 0 for c in concentrated), \
        "concentration left no shard empty"
    # finest level untouched
    assert s_sub.dist.parts[0].n_loc == s_spread.dist.parts[0].n_loc
    r_sub = s_sub.solve(b)
    r_spread = s_spread.solve(b)
    assert r_sub.converged and r_spread.converged
    assert np.linalg.norm(b - A @ r_sub.x) / np.linalg.norm(b) <= 1e-8
    assert abs(r_sub.iterations - r_spread.iterations) <= 2
