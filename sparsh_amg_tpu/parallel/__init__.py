"""Multi-chip distribution layer (SURVEY.md §2 C21/C24, §5.8).

The reference distributes via MPI: contiguous row blocks per rank, halo
(ghost-value) Isend/Irecv around local SpMV, MPI_Allreduce for dots.  Here
the same row-block decomposition is expressed in JAX: a 1-D
`jax.sharding.Mesh`, all solve kernels inside `shard_map`, halo exchange as
neighbor `ppermute` (NCCL on GPUs), reductions as `psum`, and coarse-level
agglomeration as `all_gather` onto replicated dense solves.
"""
from .partition import Partition
from .dist import DistDia, DistEll, csr_to_dist, halo_exchange, pdot
from .hierarchy import to_dist, DistHierarchy, DistLevel
from .solver import DistAMGSolver
from .multihost import init_multihost, global_mesh

__all__ = [
    "Partition", "DistDia", "DistEll", "csr_to_dist", "halo_exchange",
    "pdot", "to_dist", "DistHierarchy", "DistLevel", "DistAMGSolver",
    "init_multihost", "global_mesh",
]
