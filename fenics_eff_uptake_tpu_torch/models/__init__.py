"""Physics models: the reference's solver layer (solvers.py) re-designed."""

from .advdiff import advdiff_solve
from .diffusion import build_diffusion_system, pure_diffusion_solve
from .stokes_flow import stokes_solve, stokes_zero_fields, taylor_hood_spaces
