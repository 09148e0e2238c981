"""Post-processing engine (the reference's analysis.py layer): per-run
flux, mass, mu_eff and profile metrics, and the batched sweep metrics."""

from .boundary_export import export_boundary_flux_comparison
from .flux import (compute_flux_metrics, compute_physical_flux_boundary,
                   compute_sulcus_segment_fluxes, compute_uptake_flux_bottom,
                   compute_uptake_flux_segments)
from .integrals import integrate_scalar, l2_error
from .locate import PointLocator
from .mass import compute_mass_metrics
from .mu_eff import (compute_mu_eff_arc, compute_mu_eff_enh,
                     compute_mu_eff_metrics, compute_mu_eff_sim,
                     compute_mu_eff_sim_mouth, sample_mu_along_bottom)
from .profiles import (compute_conc_profiles, compute_velocity_metrics,
                       eval_function, extract_line_profile)
