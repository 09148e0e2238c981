"""The per-layer metric readers on a small synthetic run, the union of
device records and the whole-trace rule."""

import pytest

from benchmark.harness import Run, _reader
from benchmark.manifest import load_manifest
from benchmark.tracer import is_whole, union_seconds


def synthetic():
    reqs = [
        {"id": 0, "seconds": 0.5, "points": 2, "traced": True,
         "iters": [30, 34], "stages": {"meshing": 0.01, "assembly": 0.02,
                                       "ml_setup": 0.3, "solve": 0.1,
                                       "metrics": 0.07}},
        {"id": 1, "seconds": 0.4, "points": 2, "traced": False,
         "iters": [31, 33], "stages": {"meshing": 0.02, "assembly": 0.04,
                                       "ml_setup": 0.2, "solve": 0.08,
                                       "metrics": 0.06}},
        {"id": 2, "seconds": 0.4, "points": 2, "traced": False,
         "iters": [32, 32], "stages": {"meshing": 0.04, "assembly": 0.06,
                                       "ml_setup": 0.4, "solve": 0.12,
                                       "metrics": 0.04}},
    ]
    windows = [{"wall": 0.4, "busy": 0.08, "device": 0.09, "ops": {},
                "stages": {"ml_setup": {"wall": 0.3, "busy": 0.03,
                                        "device": 0.03, "ops": {}},
                           "solve": {"wall": 0.1, "busy": 0.05,
                                     "device": 0.06, "ops": {}}},
                "solve_bound_s": 0.003}]
    return Run(reqs, windows)


@pytest.mark.parametrize("name,value", [
    ("mesh_s_per_req", 0.03), ("assembly_s_per_req", 0.05),
    ("ml_setup_s_per_req", 0.3), ("solve_s_per_req", 0.1),
    ("metrics_s_per_req", 0.05),
    ("krylov_iters_per_point", (64 + 64 + 64) / 6),
    ("solve_roofline", 100 * 0.003 / 0.06),
    ("device_idle_share", 1 - 0.08 / 0.4)])
def test_reader(name, value):
    assert _reader(name)(synthetic()) == pytest.approx(value)


@pytest.mark.parametrize("name", ["solve_roofline", "device_idle_share",
                                  "mesh_s_per_req"])
def test_reader_finds_nothing(name):
    empty = Run([{"id": 0, "seconds": 1.0, "points": 1, "traced": False,
                  "iters": [1], "stages": {"solve": 0.5}}], [])
    assert _reader(name)(empty) is None


def test_every_per_layer_metric_has_a_reader():
    for m in load_manifest()["per_layer"]:
        assert callable(_reader(m["name"]))


def test_union_seconds():
    assert union_seconds([(0, 10), (5, 20), (30, 40), (31, 32)]) == \
        pytest.approx(30e-6)
    assert union_seconds([]) == 0.0


@pytest.mark.parametrize("names,launched,whole", [
    (["s", "band_f32_kernel<4>", "element_tiles_kernel<f>", "add"], 2, True),
    (["band_f32_kernel<4>", "add"], 2, False),      # a hand record lost
    (["add"], 0, True)])
def test_whole_trace_rule(names, launched, whole):
    assert is_whole(names, launched) is whole
