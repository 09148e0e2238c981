"""Package CLI: ``python -m fenics_eff_uptake_tpu_torch <study> [...]``.

One non-interactive entry point for the five studies of the port,
the JAX package's menu pointed at this package's modules; every argument
after the study's name goes to that study's own ``main`` (each takes
``--device``, ``cuda`` by default, and sets its device up itself).  Run with
no arguments for a numbered menu.
"""

from __future__ import annotations

import importlib
import sys

STUDIES = {
    "phase-a": ("Phase A: no-advection mu_eff studies "
                "(mu sweep / aspect ratio / geometry / mu_eff)",
                "fenics_eff_uptake_tpu_torch.studies.phase_a"),
    "phase-b": ("Phase B: sulcus vs rectangle mu sweep",
                "fenics_eff_uptake_tpu_torch.studies.phase_b"),
    "no-uptake": ("No-uptake geometry x Peclet flow study",
                  "fenics_eff_uptake_tpu_torch.studies.no_uptake"),
    "adv-diff": ("Adv-diff step-mu(x) validation (Pe x mu)",
                 "fenics_eff_uptake_tpu_torch.studies.adv_diff"),
    "mesh-convergence": ("Mesh-refinement convergence ladder",
                         "fenics_eff_uptake_tpu_torch.studies"
                         ".mesh_convergence"),
}


def _menu():
    keys = list(STUDIES)
    print("fenics-eff-uptake (PyTorch / CUDA) -- studies:")
    for i, k in enumerate(keys, 1):
        print(f"  {i}. {STUDIES[k][0]}   [{k}]")
    choice = input("Select study number (or q): ").strip()
    if choice.lower() in ("q", ""):
        return None
    try:
        return keys[int(choice) - 1]
    except (ValueError, IndexError):
        print("invalid choice")
        return None


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        key = _menu()
        if key is None:
            return
        rest = []
    else:
        key, rest = argv[0], argv[1:]
    if key in ("-h", "--help"):
        print(__doc__)
        for k, (desc, _) in STUDIES.items():
            print(f"  {k:18} {desc}")
        return
    if key not in STUDIES:
        print(f"unknown study '{key}'; one of {list(STUDIES)}")
        sys.exit(2)
    importlib.import_module(STUDIES[key][1]).main(rest)


if __name__ == "__main__":
    main()
