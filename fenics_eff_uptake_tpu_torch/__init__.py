"""PyTorch / CUDA port of ``fenics_eff_uptake_tpu`` for one NVIDIA H100.

The JAX package beside this one is the frozen reference; every module here
mirrors its counterpart's name (``fem/assembly.py``, ``ops/banded.py``,
``parallel/sweep.py``, ``solvers/multilevel.py``, ``analysis/...``,
``studies/...``) so a reader can hold the two side by side.

What is ported so far is the no-advection mu sweep
(``studies.phase_a.run_mu_sweep``): P2 assembly, the banded operator, the
4-level hybrid multigrid preconditioner with windowed-band transfers, the
fused mixed-precision (f32 CG inside f64 defect correction) sweep solve, and
the batched flux / mass / mu_eff metrics.

The three TPU (Pallas) kernels of that path are CUDA C++ kernels written for
Hopper (``ops/csrc``), built with nvcc at first use
(``ops/_build.py``).  Each has a plain PyTorch version beside it that runs
on CPU tensors and serves as the kernel's oracle.

Host-only modules of the JAX package that never load jax (``params``,
``meshing``, ``fem.elements``, ``fem.quadrature``, ``fem.dofmap``,
``fem.space``) are imported, not copied.  This package imports ``torch``
and never ``jax``.
"""

__version__ = "0.1.0"
