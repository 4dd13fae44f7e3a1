"""mf_data_locality_tpu_torch — the BP4 matrix-free solver in PyTorch and CUDA.

A port of :mod:`mf_data_locality_tpu` (JAX/Pallas) to PyTorch with CUDA
C++ kernels for NVIDIA Hopper (``sm_90a``).  It solves CEED benchmark
problem BP4 — 3-component vector Poisson on a sine-deformed hex box,
FE_Q(p) with Gauss(p+2) quadrature and a node-blocked Jacobi
preconditioner — with the merged ("data-locality") conjugate gradient:
each iteration makes one pass over the vectors and one 7-scalar reduction.

Solver state lives in lattice form ``(C, Nz, Ny, Nx)``.  Three solvers:
the fused merged CG (one kernel per iteration), and the merged and the
textbook (baseline) CG on the dense operator apply, cell-batched or on the
lattice.  Every kernel is hand-written CUDA (``csrc/``), compiled with
``nvcc`` at first use (:mod:`.ops._build`), and has a plain-PyTorch
version beside it (:mod:`.ops.cg_fused_kernel`, :mod:`.ops.laplace_apply`),
which a wrapper takes only for tensors on the CPU.

The runtime imports ``torch`` and ``numpy``; it never imports JAX.

Float32 matrix products and convolutions are pinned to full float32
(TF32 off) on import, so nothing in the package or its comparisons
silently runs at TF32 precision.
"""

import torch

__version__ = "0.1.0"

# Kernel-matmul precision rungs (``laplace_pallas._mm``):
#   "highest": exact accumulation at the working dtype (f32 or f64);
#   "split3":  matrices split into bf16 hi/lo parts, the streamed
#              operand too, three products (hi.hi + lo.hi + hi.lo) summed
#              in f32 (f32 only);
#   "split2m": matrices rounded to bf16 once, the streamed operand split
#              hi/lo into two bf16 parts, products summed in f32 (f32
#              only);
#   "bf16":    matrices and the streamed operand rounded to bf16, one
#              product, summed in f32 (f32 tables; d and h may be stored
#              in bf16, ``dtype=torch.bfloat16``).
PRECISIONS = frozenset({"highest", "split3", "split2m", "bf16"})

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
