"""Solver configuration.

The reference (SParSH-AMG, cmgcds/SParSH-AMG) configures solves through argv
flags in its example drivers plus compile-time constants (theta, omega,
nu1/nu2, cycle type, hybrid strategy enum) — see SURVEY.md §5.6.  Here the
whole configuration surface is a single frozen dataclass so that it can be
hashed and used as a static argument to jitted solve functions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AMGParams:
    """Parameters controlling AMG hierarchy construction and cycling.

    Mirrors the reference's setup/solve knobs (SURVEY.md §2 C9-C18):
    strength threshold, coarsening scheme, interpolation, smoother, cycle
    shape, and coarsest-level handling.
    """

    # --- setup phase ---
    theta: float = 0.25                # strength-of-connection threshold
    agg_theta: float = 0.08            # symmetric-strength threshold for
                                       # aggregation (|a_ij| vs sqrt(a_ii a_jj);
                                       # 0.25 would mark NOTHING strong on a
                                       # 3-D Laplacian where offdiag/diag=1/6)
    coarsening: str = "rs"             # rs | pmis | hmis | aggregation
    interpolation: str = "direct"      # direct | extpi | tentative | smoothed
                                       # (extpi = extended+i distance-two
                                       # interpolation — the pairing for
                                       # aggressive pmis/hmis coarsening)
    interp_max: int = 6                # max interpolation entries per row
                                       # (hypre P_max_elmts; 0 = no limit)
    agg_levels: int = 0                # apply AGGRESSIVE coarsening on the
                                       # first k hierarchy steps: two
                                       # coarsening+interp rounds composed
                                       # into one transfer (P = P1 @ P2,
                                       # Galerkin operator unchanged —
                                       # A2 = P2^T (P1^T A P1) P2), so the
                                       # intermediate level never enters
                                       # the cycle (hypre agg_num_levels /
                                       # Notay double-pairwise analogue)
    interp_max_composed: int = 0       # after an aggressive (composed)
                                       # coarsening step, re-truncate the
                                       # composed P1@P2 to this many entries
                                       # per row and re-form the Galerkin
                                       # operator from the FINE-level A
                                       # (hypre truncates multipass/composed
                                       # interpolation the same way); cuts
                                       # the device transfer tables ~2x for
                                       # one extra host SpGEMM. 0 = off.
    aggressive: str = "composed"       # HOW an aggressive step coarsens:
                                       # "composed" = two full rounds with
                                       # an intermediate (filtered) RAP,
                                       # P = trunc(P1@P2); "pmis2" = second
                                       # PMIS round on the distance-2 C-C
                                       # strength graph + multipass
                                       # interpolation straight from the
                                       # fine A (hypre agg_num_levels +
                                       # agg_interp_type=4) — no
                                       # intermediate operator at all,
                                       # ~2x faster setup per step
    multipass_smooth: bool = True      # aggressive="pmis2" only: one
                                       # damped-Jacobi pass over the
                                       # multipass P against the strength-
                                       # filtered A, then re-truncation.
                                       # Repairs multipass's weight quality
                                       # (measured 96^3 Poisson: 28 -> 20
                                       # PCG iterations, matching composed
                                       # ext+i) for ~one extra native
                                       # SpGEMM of P's width
    intermediate_drop_tol: float = 0.0 # drop tolerance for the THROWAWAY
                                       # intermediate operator of an
                                       # aggressive-coarsening step (it only
                                       # seeds the second split + P2
                                       # weights; the final operator is
                                       # re-formed variationally from the
                                       # fine A when interp_max_composed>0,
                                       # so a harder filter here only
                                       # perturbs interpolation weights).
                                       # 0 = use rap_drop_tol.
    rap_drop_tol: float = 0.0          # drop coarse-operator entries with
                                       # |a_ij| < tol*sqrt(a_ii*a_jj), lumped
                                       # to the diagonal (ML-style filtering;
                                       # bounds coarse nnz/row at a small
                                       # iteration cost; 0 = off)
    max_levels: int = 25
    coarse_size: int = 1024            # stop coarsening at/below this n:
                                       # the dense inverse is cheap up
                                       # to a few thousand rows, and every
                                       # level saved removes a full smoother
                                       # + transfer stage from the cycle
    jacobi_omega_smooth_P: float = 2.0 / 3.0  # for smoothed aggregation
    row_align: int = 0                 # distributed row-partition
                                       # alignment override: shard row
                                       # counts (Partition.n_loc) are
                                       # rounded to this multiple instead
                                       # of the 128 default.  Systems
                                       # problems under the BLOCKED setup
                                       # need node-aligned blocks (no
                                       # rank may own a fraction of a
                                       # node's dofs): set to
                                       # lcm(128, agg_blocksize,
                                       # nullspace_dim) — e.g. 384 for
                                       # 3-D elasticity (bs=3, 6 RBMs).
                                       # 0 = default 128.
    agg_blocksize: int = 1             # dofs per node on the FINEST level
                                       # (2 = 2-D elasticity): aggregation
                                       # amalgamates node blocks so a
                                       # node's dofs never split across
                                       # aggregates; coarser levels are
                                       # amalgamated by the near-nullspace
                                       # dimension automatically
    p_smooth_spectral: bool = False    # SA only: rescale the P-smoothing
                                       # omega by a power estimate of
                                       # rho(D^-1 A_filtered) (pyamg
                                       # convention omega_eff = omega/rho;
                                       # fixed omega under-smooths when
                                       # rho is far from 1, e.g. ~2.9 for
                                       # Q1 elasticity)
    p_smooth_compensation: str = "lump"  # SA filtered-A diagonal handling:
                                       # lump | subtract (Vanek A^F) | none
    p_smooth_filter: bool = True       # SA: strength-filter A before
                                       # smoothing P.  Keep True for
                                       # scalar problems (unfiltered
                                       # smoothing -> opC 10.5 on 64^3
                                       # Poisson); set False for systems
                                       # with agg_blocksize > 1, where
                                       # node aggregation already bounds
                                       # the pattern and the filter
                                       # distorts cross-dof couplings
                                       # (elasticity 96: 32 -> 22 iters
                                       # at identical opC 1.32)
    # --- solve phase ---
    smoother: str = "jacobi"           # jacobi | l1jacobi | chebyshev | gs2
    lambda_max: str = "hybrid"         # Chebyshev lambda_max(D^-1 A) bound:
                                       # hybrid (Gershgorin, refined by
                                       # min(power,gersh) on levels <= 2^20
                                       # rows) | power | gershgorin
    gs_stages: int = 2                 # inner Jacobi stages approximating the
                                       # triangular solve in two-stage GS
                                       # (PAPERS.md arXiv:2104.01196)
    jacobi_omega: float = 2.0 / 3.0
    cheby_degree: int = 3
    cheby_degree_coarse: int = 0       # Chebyshev degree on levels >=
                                       # cheby_coarse_from (0 = same as
                                       # cheby_degree); coarse sweeps cost
                                       # disproportionate traffic/launches
    cheby_coarse_from: int = 2         # first level using the reduced degree
    cheby_lower_frac: float = 1.0 / 30.0  # lower bound = frac * lambda_max
    nu1: int = 1                       # pre-smoothing sweeps
    nu2: int = 1                       # post-smoothing sweeps
    cycle: str = "V"                   # V | W | F
    coarse_solver: str = "lu"          # lu | cholesky | smooth: which host
                                       # factorization builds the explicit
                                       # coarse inverse (applied as ONE fp32
                                       # matvec on device — triangular
                                       # solves are sequential); "cholesky"
                                       # additionally verifies SPD;
                                       # "smooth" skips the
                                       # inverse and runs l1-Jacobi sweeps
    coarse_inv_max: int = 8192         # build a dense inverse only if the
                                       # coarsest n is at/below this; else
                                       # fall back to heavy l1-Jacobi sweeps
                                       # (guards stalled coarsening)
    coarse_smooth_sweeps: int = 16     # l1-Jacobi sweeps when no dense
                                       # inverse exists (smooth / too-large)
    # --- device layout ---
    dtype: str = "float32"             # device solve dtype (vectors, dinv)
    band_dtype: str = "float32"        # matrix-data dtype (bands/vals/
                                       # dense blocks).  "bfloat16" halves
                                       # the dominant HBM traffic of every
                                       # cycle; the cycle is only a
                                       # preconditioner, so reduced matrix
                                       # precision costs at most ~1 Krylov
                                       # iteration (vectors stay fp32)
    prefer_dia: bool = True            # use DIA (stencil) layout when it fits
    dia_max_bands: int = 32            # densify-to-bands threshold
    reorder: str = "auto"              # none | rcm | auto: RCM-permute the
                                       # fine matrix when its bandwidth is
                                       # too wide for the DIA/halo layouts
                                       # (SURVEY.md §7 hard-part #2)
    dense_size: int = 2048             # densify levels at/below this n
                                       # (coarse AMG operators lose sparsity;
                                       # a dense matvec compiles O(1))
    replicate_size: int = 4096         # distributed solves: levels at/below
                                       # this n are REPLICATED on every
                                       # shard — smoothing and transfers run
                                       # shard-locally with zero collectives
                                       # (level-wise agglomeration, C24);
                                       # the crossing costs one all_gather
                                       # per cycle.  0 disables.
    sub_mesh_min_rows: int = 0         # distributed solves: SUB-MESH
                                       # agglomeration for mid-size coarse
                                       # levels (between replicate_size and
                                       # full distribution) — pick each
                                       # level's shard height n_loc >= this,
                                       # concentrating its rows on the
                                       # leading ceil(n/n_loc) shards and
                                       # leaving the rest all-padding (the
                                       # reference's "gather small coarse
                                       # grids onto fewer processors" at
                                       # mesh scale; SURVEY.md §5.8).  At
                                       # 8-16 chips 0 (off) is right; on
                                       # larger meshes set ~2048 so coarse
                                       # smoothers keep arithmetic density
                                       # instead of 128-row slivers on
                                       # every shard.  Never applied to the
                                       # finest level.

    def replace(self, **kw) -> "AMGParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class KrylovParams:
    """Outer Krylov solve controls (reference: solve() argv flags)."""

    method: str = "cg"                 # cg | bicgstab | amg (standalone
                                       # cycle iteration, no Krylov)
    tol: float = 1e-8                  # relative residual target
    maxiter: int = 500
    # Iteration-loop placement (SURVEY.md §3.1): "device" runs the whole
    # Krylov loop as one lax.while_loop (single XLA computation, best for
    # multi-host runs); "host" dispatches `chunk` iterations per jitted
    # call and checks convergence on the host — the reference's GPU-driver
    # pattern, robust to backends with per-while-iteration sync overhead.
    # "auto" probes the per-dispatch RTT at solver build and picks
    # "device" when it is < 1 ms (utils.timing.resolve_loop_mode).
    loop_mode: str = "host"            # host | device | auto
    chunk: int = 4                     # iterations per dispatch (host mode;
                                       # up to chunk-1 overrun per solve)
    # Mixed-precision iterative refinement: the device cycle runs in fp32;
    # to reach tol below fp32 roundoff the outer loop recomputes residuals
    # in double-float (df64) arithmetic and accumulates x in df64.  SURVEY.md §7 "hard parts" #1.
    refine: bool = True
    inner_tol: float = 1e-5            # per-refinement-pass inner tolerance
    max_refine: int = 6
    # Inner Krylov dot products: plain fp32 (XLA pairwise reduction,
    # ~log2(n)*eps relative error — far below inner_tol).  The df64
    # compensated dot is reserved for the OUTER refinement residuals: its
    # log2(n)-stage tree reduction is many kernels per call, vs one fused
    # fp32 reduce.
    compensated_dots: bool = False


def flagship_params(**overrides) -> AMGParams:
    """The flagship 3-D Poisson recipe (bench.py's defaults): aggressive
    PMIS + ext+i on the first step (pmis2), Chebyshev V-cycle, bf16
    cycle bands, dense levels below 2048 rows."""
    return AMGParams(smoother="chebyshev", cycle="V", coarsening="pmis",
                     interpolation="extpi", interp_max=4,
                     rap_drop_tol=0.01, agg_levels=1,
                     interp_max_composed=5, intermediate_drop_tol=0.02,
                     aggressive="pmis2", band_dtype="bfloat16",
                     dense_size=2048, cheby_degree_coarse=1,
                     cheby_coarse_from=1).replace(**overrides)


DEFAULT_AMG = AMGParams()
DEFAULT_KRYLOV = KrylovParams()
