"""The port's roofline model (``utils/roofline.py``) against the JAX
package's, on the CPU.

* ``_band_cost``, ``_elem_cost`` and ``roofline_summary`` (given the same
  peaks) equal JAX's on the same inputs.
* ``ml_cg_iteration_cost`` and ``assembly_cost`` on the port's mu-sweep
  system and hierarchy equal JAX's functions on the same shapes, in every
  cycle and with f32 or bf16 transfer bands (JAX's ``FEU_ML_TB_BF16``, the
  port's ``transfer_dtype``).  The shapes themselves differ by design, and
  the test asserts how: JAX, forced into its TPU configuration with the
  environment of ``tests/test_banded.py``, pads every band's tile count,
  element count and dof count to its static-shape buckets (powers of two,
  so a TPU program compiles once per bucket), while the port pads to the
  next 256-row tile only; the rows per tile and the band widths are the
  same, so a tile costs the same in both, and JAX's model counts its
  padding tiles too.
* ``chip_peaks`` returns the H100 row for "NVIDIA H100 80GB HBM3", the JAX
  package's nominal row for a CPU device, and raises for a card without a
  row.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu.meshing.generator import generate_mesh
from fenics_eff_uptake_tpu.parallel import sweep as jsw
from fenics_eff_uptake_tpu.solvers import multilevel as jml
from fenics_eff_uptake_tpu.utils import roofline as jr
from fenics_eff_uptake_tpu_torch.convert import mesh_from
from fenics_eff_uptake_tpu_torch.parallel import sweep as tsw
from fenics_eff_uptake_tpu_torch.solvers import multilevel as tml
from fenics_eff_uptake_tpu_torch.utils import roofline as tr

torch.set_num_threads(2)

KW = dict(width=10.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
          refinement_factor=1, domain_type="sulcus")
TPU_ENV = {"FEU_ML_TBAND": "1", "FEU_ML_BAND": "1",
           "FEU_ML_CYCLE": "hybrid", "FEU_CHEAP_PASSES": "1",
           "FEU_FUSED_SOLVE": "1"}
MUS = np.array([0.1, 1.0, 10.0])
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def systems():
    """The mu-sweep system and 4-level hierarchy (h = 0.15, levels at 0.3
    and 0.45) of each package."""
    mesh = generate_mesh(mesh_size=0.15, **KW)
    levels = [mesh] + [generate_mesh(mesh_size=m, **KW) for m in (0.3, 0.45)]
    D = np.ones(len(MUS))
    with pytest.MonkeyPatch.context() as mp:
        for k, v in TPU_ENV.items():
            mp.setenv(k, v)
        jsys = jsw.build_transport_system(mesh, element="P2",
                                          pad_shapes=True, band=True)
        jm = jml.build_multilevel(jsys, levels, D, mu_values=MUS)
    tlevels = [mesh_from(m) for m in levels]
    psys = tsw.build_transport_system(tlevels[0], "cpu")
    pml = tml.build_multilevel(psys, tlevels, D, MUS)
    return SimpleNamespace(jsys=jsys, jml=jm, psys=psys, pml=pml)


def _as_jax(sys_t, ml):
    """The port's system and hierarchy in the shape of the JAX package's
    objects, as far as its cost model reads them."""
    def system(s):
        return SimpleNamespace(Kband=s.Kband, K=s.K, ndofs=s.ndofs)
    levels = [SimpleNamespace(
        sys=system(lv.sys),
        bands=(SimpleNamespace(band=lv.bands.p), None,
               SimpleNamespace(band=lv.bands.r), None))
        for lv in ml.levels]
    return system(sys_t), SimpleNamespace(levels=levels, Ainv=ml.Ainv)


@pytest.mark.parametrize("shape,B,nbytes", [((9, 256, 768), 20, 4),
                                            ((3, 256, 1024), 3, 2),
                                            ((1, 256, 128), 1, 8)])
def test_band_cost_matches_jax(shape, B, nbytes):
    assert tr._band_cost(shape, B, nbytes) == jr._band_cost(shape, B, nbytes)


@pytest.mark.parametrize("shape,B,nbytes", [((971, 6, 6), 20, 4),
                                            ((209, 3, 3), 3, 8),
                                            ((4096, 6, 6), 1, 2)])
def test_elem_cost_matches_jax(shape, B, nbytes):
    assert tr._elem_cost(shape, B, nbytes) == jr._elem_cost(shape, B, nbytes)


def test_shapes_differ_only_by_jax_padding(systems):
    s = systems
    pairs = [(s.jsys.Kband.shape, s.psys.Kband.shape)]
    for jl, pl in zip(s.jml.levels, s.pml.levels):
        pairs += [(jl.sys.Kband.shape, pl.sys.Kband.shape),
                  (jl.bands[0].band.shape, pl.bands.p.shape),
                  (jl.bands[2].band.shape, pl.bands.r.shape)]
    assert len(s.jml.levels) == len(s.pml.levels) == 3
    for j, p in pairs:
        assert tuple(j[1:]) == tuple(p[1:]), (j, p)   # rows, width
        assert j[0] >= p[0], (j, p)                   # tiles
    assert any(j[0] > p[0] for j, p in pairs)
    assert s.jsys.ndofs >= s.psys.ndofs and s.psys.ndofs % 256 == 0
    assert s.jsys.K.A64.shape[0] >= s.psys.K.A64.shape[0]
    assert s.jml.Ainv.shape[-1] >= s.pml.Ainv.shape[-1]


@pytest.mark.parametrize("cycle", ["hybrid", "mult", "add"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_iteration_cost_matches_jax(systems, monkeypatch, cycle, bf16):
    fake_sys, fake_ml = _as_jax(systems.psys, systems.pml)
    monkeypatch.setenv("FEU_ML_TB_BF16", "1" if bf16 else "0")
    want = jr.ml_cg_iteration_cost(fake_sys, fake_ml, len(MUS), cycle=cycle)
    got = tr.ml_cg_iteration_cost(
        systems.psys, systems.pml, len(MUS), cycle=cycle,
        transfer_dtype=torch.bfloat16 if bf16 else None)
    assert got == want
    # and on its own objects JAX's model counts its padding on top
    assert jr.ml_cg_iteration_cost(systems.jsys, systems.jml, len(MUS),
                                   cycle=cycle)["bytes_per_iter"] >= \
        got["bytes_per_iter"]


def test_assembly_cost_and_summary_match_jax(systems):
    fake_sys, fake_ml = _as_jax(systems.psys, systems.pml)
    assert tr.assembly_cost(systems.psys) == jr.assembly_cost(fake_sys)
    cost = tr.ml_cg_iteration_cost(systems.psys, systems.pml, len(MUS),
                                   cycle="hybrid")
    peaks = tr.chip_peaks(kind=H100)
    for passes in (0, 3):
        assert tr.roofline_summary(cost, 17, 0.0123, passes, systems.psys,
                                   len(MUS), peaks) == \
            jr.roofline_summary(cost, 17, 0.0123, passes, fake_sys,
                                len(MUS), peaks)


def test_chip_peaks():
    pk = tr.chip_peaks(kind=H100)
    assert pk == {"kind": H100, "hbm_gbps": 3350.0, "bf16_tflops": 989.0,
                  "f32_tflops": 67.0, "f64_tflops": 34.0,
                  "f32_matmul_tflops": 67.0}
    with pytest.raises(ValueError, match="no published peaks"):
        tr.chip_peaks(kind="NVIDIA A100-SXM4-80GB")
    cpu, jcpu = tr.chip_peaks("cpu"), jr.chip_peaks()
    assert jcpu["kind"] == "cpu"
    for k in ("kind", "hbm_gbps", "bf16_tflops", "f32_matmul_tflops"):
        assert cpu[k] == jcpu[k], k
