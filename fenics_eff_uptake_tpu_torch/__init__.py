"""PyTorch / CUDA port of ``fenics_eff_uptake_tpu`` for one NVIDIA H100.

The JAX package beside this one is the frozen reference; every module here
mirrors its counterpart's name (``fem/assembly.py``, ``ops/banded.py``,
``parallel/sweep.py``, ``solvers/...``, ``models/stokes_flow.py``,
``analysis/...``, ``studies/...``) so a reader can hold the two side by side.

What is ported so far:

* the no-advection mu sweep (``studies.phase_a.run_mu_sweep``): P2
  assembly, the banded operator, the 4-level hybrid multigrid with
  windowed-band transfers, the fused mixed-precision (f32 CG inside f64
  defect correction) sweep solve, and the batched flux / mass / mu_eff
  metrics;
* the no-uptake flow study (``studies.no_uptake.run_geometry_study``):
  Taylor-Hood Stokes by f32 MINRES with multigrid and coarse-pressure
  deflation inside f64 defect correction (``models.stokes_flow``), the
  advective transport system with a multiplicative multigrid carrying the
  velocity, batched f32 BiCGStab inside f64 defect correction, and the
  advective metrics.

The three TPU (Pallas) kernels of both paths are CUDA C++ kernels written
for Hopper (``ops/csrc``), built with nvcc at first use
(``ops/_build.py``).  Each has a plain PyTorch version beside it that runs
on CPU tensors and serves as the kernel's oracle.

The host layers it needs are its own copies of the JAX package's
(``params``, ``meshing`` with a binding that builds the C++ mesher from
``native/meshkernel.cpp``, its only mesher, ``fem.elements``, ``fem.quadrature``,
``fem.dofmap``, ``fem.space``), under the same names.  This package imports
``torch`` and never ``jax``, and nothing of the JAX package.
"""

__version__ = "0.1.0"
