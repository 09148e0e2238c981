"""The isolation check: whole top-level names, the harness and the run
load no JAX, and the reference loads nothing of the package under test."""

import subprocess
import sys

import pytest

from benchmark.isolation import FORBIDDEN, REFERENCE_FORBIDDEN, loaded
from benchmark.manifest import ROOT


def test_whole_top_level_names():
    mods = {"fenics_eff_uptake_tpu_torch", "fenics_eff_uptake_tpu_torch.ops",
            "jaxtyping", "numpy"}
    assert loaded(modules=mods) == []
    assert loaded(modules=mods | {"jax.numpy"}) == ["jax"]
    assert loaded(modules=mods | {"fenics_eff_uptake_tpu.params"}) == \
        ["fenics_eff_uptake_tpu"]
    assert loaded(REFERENCE_FORBIDDEN, mods) == \
        ["fenics_eff_uptake_tpu_torch"]


def modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print('\\n'.join(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_reference_loads_nothing_of_the_program():
    mods = modules_after("import benchmark.reference, benchmark.check")
    assert loaded(REFERENCE_FORBIDDEN, mods) == []


def test_harness_loads_no_jax():
    mods = modules_after("import benchmark.harness, benchmark.port")
    assert "fenics_eff_uptake_tpu_torch" in {m.split(".")[0] for m in mods}
    assert loaded(FORBIDDEN, mods) == []


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in (ROOT / "benchmark" / "reference").rglob("*.py")))
def test_reference_sources_import_nothing_of_the_program(path):
    src = (ROOT / path).read_text()
    for name in REFERENCE_FORBIDDEN:
        assert f"import {name}" not in src and f"from {name}" not in src


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "noadv.mu_sweep",
         "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2 and out.stdout == ""
