"""The PyTorch port imports neither jax, pandas nor triton (the card's
machine has no jax and no pandas), and nothing of the JAX package: it
carries its own copies of the host layers it uses."""

# Each check runs in a fresh interpreter: this test process has jax loaded
# already (tests/conftest.py).

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    import fenics_eff_uptake_tpu_torch as pkg
    names = [pkg.__name__]
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names.append(m.name)
    return names


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_port_modules_load_no_jax_or_triton():
    mods = _port_modules()
    assert len(mods) > 15, mods
    for name in ("studies.adv_diff", "studies.phase_a", "studies.phase_b",
                 "studies.no_uptake", "convert"):
        assert f"fenics_eff_uptake_tpu_torch.{name}" in mods, name
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [k for k in ('jax', 'jaxlib', 'triton', 'pandas') "
            "if k in sys.modules]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


_NO_JAX_PACKAGE = (
    "bad = sorted(k for k in sys.modules if k == 'fenics_eff_uptake_tpu' "
    "or k.startswith('fenics_eff_uptake_tpu.'))\n"
    "assert not bad, bad\n")


def test_port_modules_load_nothing_of_the_jax_package():
    mods = _port_modules()
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            + _NO_JAX_PACKAGE + "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _chip_smoke_imports():
    """Every module chip_smoke.py imports, at top level or inside its
    functions (which only run on a card)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    return names


def test_chip_smoke_imports_load_nothing_of_the_jax_package():
    names = [n for n in _chip_smoke_imports()
             if n.startswith("fenics_eff_uptake_tpu_torch")]
    assert len(names) > 5, names
    code = ("import importlib, sys\nimport chip_smoke\n"
            f"for m in {sorted(set(names))!r}:\n"
            "    importlib.import_module(m)\n"
            + _NO_JAX_PACKAGE + "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_loads_no_jax():
    proc = _run("import sys, chip_smoke\n"
                "assert 'jax' not in sys.modules\n"
                "print('ok')\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    # imports inside functions only run on a card: read them from the source
    names = _chip_smoke_imports()
    assert "fenics_eff_uptake_tpu_torch.studies.phase_a" in names, names
    assert "fenics_eff_uptake_tpu_torch.studies.no_uptake" in names, names
    assert "fenics_eff_uptake_tpu_torch.studies.adv_diff" in names, names
    assert "fenics_eff_uptake_tpu_torch.studies.phase_b" in names, names
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "fenics_eff_uptake_tpu",
                                  "pandas")]
    assert not bad, bad


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke run exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "",
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
