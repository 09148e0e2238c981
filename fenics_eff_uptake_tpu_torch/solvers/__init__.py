"""Matrix-free Krylov solvers (replace the reference's direct LU backend)."""

from .batched import BatchedResult, batched_bicgstab, batched_cg
from .bicgstab import bicgstab
from .cg import cg, jacobi_preconditioner
from .gmres import gmres
from .mixed import refined_solve
from .stokes import stokes_schur_cg
from .twolevel import build_twolevel, make_preconditioner
