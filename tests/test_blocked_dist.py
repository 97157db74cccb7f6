"""Process-local device freeze (parallel/blocked_dist.py; VERDICT r3
next #1/#6).

`blocked_to_dist` must reproduce the global `to_dist` SHARD-FOR-SHARD:
identical pytree structure (all comm-agreed static metadata — DIA
offsets, ELL K/h/mode, lambda_max) and bit-identical data
in each rank's dpp-slice of every stacked leaf.  Asserted here through
`slice_to_blocked` (same hierarchy on both sides, so every difference
is a freeze bug, not setup rounding), for the flagship config, gs2
triangles, and distributed ELL levels.
"""
import numpy as np
import pytest

import jax

from sparsh_amg_tpu.models.poisson import poisson3d
from sparsh_amg_tpu.params import AMGParams, KrylovParams, flagship_params
from sparsh_amg_tpu.setup.hierarchy import amg_setup
from sparsh_amg_tpu.setup.comm import run_blocked
from sparsh_amg_tpu.parallel.hierarchy import to_dist
from sparsh_amg_tpu.parallel.blocked_dist import (
    blocked_to_dist, slice_to_blocked, fine_df64_blocked, csr_rows_to_dist,
    put_local_stacked)
from sparsh_amg_tpu.parallel.hierarchy import fine_df64
from sparsh_amg_tpu.parallel.partition import Partition

FLAGSHIP = flagship_params()

ND, NPROCS = 8, 4


def _assert_shard_equal(tree_g, tree_b, rank, dpp, label=""):
    """Global stacked pytree vs one rank's local stacked pytree: same
    structure, and leaf_g[d0:d0+dpp] == leaf_b bitwise."""
    td_g = jax.tree_util.tree_structure(tree_g)
    td_b = jax.tree_util.tree_structure(tree_b)
    assert td_g == td_b, f"{label}: treedef mismatch\n{td_g}\n{td_b}"
    lg = jax.tree_util.tree_leaves(tree_g)
    lb = jax.tree_util.tree_leaves(tree_b)
    d0 = rank * dpp
    for i, (g, b) in enumerate(zip(lg, lb)):
        g = np.asarray(g)
        b = np.asarray(b)
        assert g.shape[1:] == b.shape[1:], (label, i, g.shape, b.shape)
        sl = g[d0:d0 + dpp]
        assert np.array_equal(sl, b), \
            f"{label}: leaf {i} differs on rank {rank}"


def _freeze_all_ranks(hier, params):
    dpp = ND // NPROCS

    def fn(rank, comm):
        bh = slice_to_blocked(hier, rank, ND, NPROCS, params)
        dist = blocked_to_dist(bh, ND, comm, params, as_numpy=True)
        part0 = dist.parts[0]
        Adf = fine_df64_blocked(bh.levels[0].A, bh.levels[0].r0, part0,
                                comm, params, rank * dpp, dpp,
                                as_numpy=True)
        return dist, Adf

    return run_blocked(fn, NPROCS), dpp


@pytest.mark.parametrize("params", [
    FLAGSHIP,
    AMGParams(coarsening="pmis", interpolation="extpi", smoother="gs2",
              interp_max=4, dense_size=2048),
])
def test_blocked_freeze_matches_global(params):
    A = poisson3d(24)
    hier = amg_setup(A, params)
    dist_g = to_dist(hier, ND, params)
    Adf_g = fine_df64(hier, dist_g, params)
    outs, dpp = _freeze_all_ranks(hier, params)
    for rank, (dist_b, Adf_b) in enumerate(outs):
        assert dist_b.n_levels == dist_g.n_levels
        assert dist_b.parts == dist_g.parts
        for li in range(dist_g.n_levels):
            _assert_shard_equal(dist_g.levels[li], dist_b.levels[li],
                                rank, dpp, f"rank{rank} level{li}")
        _assert_shard_equal(Adf_g, Adf_b, rank, dpp, f"rank{rank} df64")


def test_blocked_freeze_ell_levels():
    """With the dense/replication thresholds pushed down, distributed
    irregular levels freeze as DistEll and the comm-agreed process-local
    freeze reproduces the global one bitwise."""
    import dataclasses
    params = dataclasses.replace(FLAGSHIP, dense_size=256,
                                 replicate_size=512)
    A = poisson3d(32)
    hier = amg_setup(A, params)
    dist_g = to_dist(hier, ND, params)
    outs, dpp = _freeze_all_ranks(hier, params)

    def ops_of(lev):
        out = [("A", lev.A)]
        for nm, op in (("P", lev.P), ("R", lev.R)):
            if op is not None:
                out.append((nm, getattr(op, "op", op)))
        return out

    kinds = [type(op).__name__ for l in dist_g.levels[1:]
             for _, op in ops_of(l)]
    assert "DistEll" in kinds, kinds
    for rank, (dist_b, _) in enumerate(outs):
        for li in range(dist_g.n_levels):
            _assert_shard_equal(dist_g.levels[li], dist_b.levels[li],
                                rank, dpp, f"ell rank{rank} level{li}")


def test_csr_rows_to_dist_gather_mode():
    """A matrix whose columns reach beyond the neighbor shards must
    agree on gather mode across ranks (the coarse-level fallback)."""
    import scipy.sparse as sp
    from sparsh_amg_tpu.parallel.dist import csr_to_dist, DistEll
    rng = np.random.default_rng(0)
    n = 1024
    # random sparse: global column reach
    A = sp.random(n, n, density=4 / n, random_state=rng,
                  format="csr") + sp.eye(n, format="csr")
    A = A.tocsr()
    A.sum_duplicates()
    part = Partition.make(n, ND)
    op_g = csr_to_dist(A, part, part, prefer_dia=True)
    assert isinstance(op_g, DistEll) and op_g.mode == "gather"
    dpp = ND // NPROCS

    def fn(rank, comm):
        d0 = rank * dpp
        r0 = min(d0 * part.n_loc, n)
        r1 = min((d0 + dpp) * part.n_loc, n)
        return csr_rows_to_dist(A[r0:r1].tocsr(), r0, part, part, comm,
                                d0, dpp, as_numpy=True)

    for rank, op_b in enumerate(run_blocked(fn, NPROCS)):
        assert op_b.mode == "gather" and op_b.h == op_g.h
        _assert_shard_equal(op_g, op_b, rank, dpp, f"gather rank{rank}")


def test_put_local_stacked_roundtrip():
    """put_local_stacked serves each shard from the local stack; in a
    single process (all shards addressable) it must equal the plain
    put_sharded of the host-global stack."""
    if len(jax.devices()) < ND:
        pytest.skip("needs 8 virtual devices")
    from sparsh_amg_tpu.parallel.solver import default_mesh
    mesh = default_mesh(ND)
    host = np.arange(ND * 5 * 3, dtype=np.float32).reshape(ND, 5, 3)
    out = put_local_stacked(host, mesh, "rows", d0=0, dpp=ND)
    np.testing.assert_array_equal(np.asarray(out), host)


def test_blocked_freeze_solves():
    """End-to-end: a DistAMGSolver driven by the blocked freeze (rank 0
    of a 1-process comm == all shards local) converges identically to
    the global solver."""
    if len(jax.devices()) < ND:
        pytest.skip("needs 8 virtual devices")
    from sparsh_amg_tpu.parallel.solver import (DistAMGSolver,
                                                default_mesh)
    A = poisson3d(24)
    kr = KrylovParams(method="cg", tol=1e-8)
    mesh = default_mesh(ND)
    res_g = DistAMGSolver(A, mesh=mesh, params=FLAGSHIP,
                          krylov=kr).solve(
        np.random.default_rng(5).standard_normal(A.shape[0]))
    from sparsh_amg_tpu.models.poisson import poisson3d_rows
    solver_b = DistAMGSolver.from_blocked(
        lambda r0, r1: poisson3d_rows(24, r0, r1),
        A.shape[0], mesh=mesh, params=FLAGSHIP, krylov=kr)
    r0, r1 = solver_b.row_range
    b_loc = np.random.default_rng(5).standard_normal(A.shape[0])[r0:r1]
    res_b = solver_b.solve(b_loc)
    assert res_b.converged
    assert abs(res_b.iterations - res_g.iterations) <= 1
    # local x equals the global solution rows
    np.testing.assert_allclose(res_b.x, res_g.x[r0:r1], rtol=1e-6,
                               atol=1e-8)
    # explicit opt-in global assembly
    xg = solver_b.gather_global(res_b)
    np.testing.assert_allclose(xg, res_g.x, rtol=1e-6, atol=1e-8)


def test_rehearsal_path_freeze_matches_global():
    """The DRESS-REHEARSAL pipeline (per-rank generator -> blocked setup
    -> per-rank freeze) produces shards bitwise equal to the global
    `to_dist` freeze of the stitched hierarchy, pinned at test scale
    through the same code path a large multi-rank run takes."""
    from sparsh_amg_tpu.models.poisson import poisson3d_rows
    from sparsh_amg_tpu.setup.blocked import (blocked_amg_setup,
                                              partition_bounds,
                                              stitch_blocked)
    m, nd, nprocs = 32, 8, 4
    n = m ** 3
    params = FLAGSHIP
    bounds = partition_bounds(n, nd, nprocs)
    dpp = nd // nprocs

    def fn(rank, comm):
        r0, r1 = int(bounds[rank]), int(bounds[rank + 1])
        A_own = poisson3d_rows(m, r0, r1)
        assert A_own.shape[0] < n          # no rank holds the fine matrix
        bh = blocked_amg_setup(
            A_own, bounds, comm, params,
            bounds_fn=lambda nc: partition_bounds(nc, nd, nprocs))
        dist = blocked_to_dist(bh, nd, comm, params, as_numpy=True)
        Adf = fine_df64_blocked(bh.levels[0].A, r0, dist.parts[0], comm,
                                params, rank * dpp, dpp, as_numpy=True)
        return bh, dist, Adf

    outs = run_blocked(fn, nprocs)
    hier = stitch_blocked([o[0] for o in outs])
    dist_g = to_dist(hier, nd, params)
    Adf_g = fine_df64(hier, dist_g, params)
    for rank, (_, dist_b, Adf_b) in enumerate(outs):
        for li in range(dist_g.n_levels):
            _assert_shard_equal(dist_g.levels[li], dist_b.levels[li],
                                rank, dpp, f"rehearsal rank{rank} l{li}")
        _assert_shard_equal(Adf_g, Adf_b, rank, dpp,
                            f"rehearsal rank{rank} df64")
