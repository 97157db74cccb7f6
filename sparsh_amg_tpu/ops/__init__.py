"""Device compute kernels.

The reference's kernel layer (SURVEY.md §1 L1: SpMV, SpMM, transpose, axpy/
dot, smoother sweeps in OpenMP + CUDA) maps here to plain XLA operations
over padded, statically-shaped sparse layouts:

* ``DiaMatrix`` — diagonal (stencil) storage: SpMV is a sum of shifted
  vector multiplies, no gathers at all; memory-bandwidth bound on the
  structured fine grids that dominate the benchmark suite.
* ``EllMatrix`` — padded ELL for general/unstructured levels; SpMV is a
  vectorized gather + multiply-accumulate.
"""
from .formats import DiaMatrix, EllMatrix, csr_to_device, spmv
from . import df64

__all__ = ["DiaMatrix", "EllMatrix", "csr_to_device", "spmv", "df64"]
