"""The PyTorch port imports neither jax nor triton.

Each check runs in a fresh interpreter: this test process has jax loaded
already (tests/conftest.py)."""

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
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [k for k in ('jax', 'jaxlib', 'triton') "
            "if k in sys.modules]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
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
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "fenics_eff_uptake_tpu_torch.studies.phase_a" in names, names
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "fenics_eff_uptake_tpu")]
    assert not bad, bad


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke run exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "",
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
