"""sparsh_amg_tpu — an algebraic multigrid solver library in JAX.

A from-scratch rebuild of the capabilities of SParSH-AMG (cmgcds/SParSH-AMG,
a hybrid CPU-GPU MPI+OpenMP+CUDA AMG library; see SURVEY.md): classical and
aggregation AMG setup, weighted-Jacobi / l1-Jacobi / Chebyshev smoothing,
V/W/F cycles, and AMG-preconditioned CG / BiCGStab, solved on a GPU:

* setup runs on the host (native C++ graph kernels + scipy SpGEMM),
* the solve phase is one jitted XLA computation over padded DIA/ELL layouts,
* 1e-8 residuals from an fp32 solve via df64 iterative refinement,
* distribution via `jax.sharding` row partitioning with halo collectives
  (see `sparsh_amg_tpu.parallel`).
"""
from ._native import tune_malloc as _tune_malloc
_tune_malloc()   # one-time heap tuning; see _native.tune_malloc docstring
from .params import AMGParams, KrylovParams
from .setup import amg_setup, Hierarchy
from . import models, ops, parallel, setup, solve, utils
from .solve.solver import AMGSolver
from .solve.device import to_device
# expose the one-shot convenience under a non-shadowing name; binding it as
# `solve` would overwrite the `sparsh_amg_tpu.solve` SUBMODULE attribute and
# break dotted imports (`import sparsh_amg_tpu.solve.cycles`)
from .solve.solver import solve as solve_system

__version__ = "0.1.0"

__all__ = [
    "AMGParams", "KrylovParams", "amg_setup", "Hierarchy",
    "AMGSolver", "solve_system", "to_device",
    "models", "ops", "parallel", "setup", "solve", "utils",
]
