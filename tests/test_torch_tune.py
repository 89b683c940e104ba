"""The reference's tuning and cost-decomposition scripts in the port
(fluca_tpu_torch/examples/tune512.py, tune128.py, tune_cavity3d.py,
profile3d.py, profile_mom3d.py, pin128.py --outer, sphere_drag.py --N),
on the CPU at tiny sizes: each main runs with --device cpu and prints one
JSON line with its keys and device; a combo held to a gate it cannot meet
comes out FAIL and is not chosen; the combo lists and labels equal the
reference scripts', read from their text (the scripts set environment
variables when imported, so they are not imported)."""

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest

from fluca_tpu_torch.examples import (
    pin128, profile3d, profile_mom3d, sphere_drag, tune128, tune512, tune_cavity3d,
)

from torch_threads import one_thread_per_worker  # noqa: F401 (autouse fixture)

REF = Path(__file__).resolve().parents[1] / "examples"
CPU = ["--device", "cpu"]


def line_of(capsys) -> dict:
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"]["platform"] == "cpu"
    return out


def test_tune512_candidates_equal_the_reference():
    """CANDIDATES is examples/tune512.py's list, tuple for tuple."""
    tree = ast.parse((REF / "tune512.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "CANDIDATES")
    assert [tuple(c) for c in ast.literal_eval(node.value)] == tune512.CANDIDATES


def test_tune128_combos_equal_the_reference():
    """COMBOS' labels, in order, are the labels examples/tune128.py runs
    (:72-107); their configs are the presets it builds."""
    text = (REF / "tune128.py").read_text()
    labels = [label for label, _ in tune128.COMBOS]
    at = [text.index(f'"{label}"') for label in labels]
    assert at == sorted(at) and len(labels) == 6
    cfgs = [make() for _, make in tune128.COMBOS]
    assert [(c.maxiter, c.outer_type, c.mom_solver, c.schur_solver, c.precond_dtype,
             c.precond_scope) for c in cfgs] == [
        (3, "gcr", "bicgstab", "cg", None, "both"),
        (3, "gcr", "bicgstab", "cg", "bfloat16", "both"),
        (3, "gcr", "bicgstab", "cg", "bfloat16", "mom"),
        (4, "gcr", "bicgstab", "cg", "bfloat16", "both"),
        (3, "gcr", "jacobi", "vcycle", None, "both"),
        (3, "richardson", "jacobi", "vcycle", None, "both"),
    ]


def test_tune_cavity3d_forms_equal_the_reference():
    text = (REF / "tune_cavity3d.py").read_text()
    assert re.findall(r'run\("([^"]+)"', text) == [label for label, _ in tune_cavity3d.FORMS]


def test_pin128_outer_sweep_equals_the_reference():
    """The sweep of examples/tune_budget_tpu.py:53-57: f32 production(),
    then production(o, 8, 6) with bf16 at o = 3, 4, 5."""
    text = (REF / "tune_budget_tpu.py").read_text()
    assert 'dev("production_o3_f32", CNLinearConfig.production())' in text
    assert "for o in (3, 4, 5):" in text and 'dev(f"production_o{o}_bf16", c)' in text
    sweep = pin128.outer_sweep()
    assert [label for label, _ in sweep] == ["production_o3_f32", "production_o3_bf16",
                                            "production_o4_bf16", "production_o5_bf16"]
    assert [(c.maxiter, c.mom_maxiter, c.schur_maxiter, c.precond_dtype) for _, c in sweep] == [
        (3, 8, 6, None), (3, 8, 6, "bfloat16"), (4, 8, 6, "bfloat16"), (5, 8, 6, "bfloat16")]


@pytest.mark.parametrize("retention, verdict", [(tune512.RETENTION_MIN, "PASS"),
                                                (2.0, "FAIL: mean flow decayed")])
def test_tune512_main_and_its_gates(capsys, monkeypatch, retention, verdict):
    """A combo that keeps the gates passes and is the fastest PASS; held to
    a retention it cannot meet (2x the initial mean flow, planted here), it
    is marked FAIL and nothing is chosen."""
    monkeypatch.setattr(tune512, "RETENTION_MIN", retention)
    tune512.main(CPU + ["--grid", "16x8x8", "--steps", "2", "--only", "o2_jacobi5_s8"])
    out = line_of(capsys)
    assert out["grid"] == [16, 8, 8] and out["retention_gate"] == retention
    (rec,) = out["results"]
    assert rec["label"] == "o2_jacobi5_s8_bf16mom" and rec["verdict"] == verdict
    if verdict == "PASS":
        assert out["fastest_pass"] == rec["label"] and rec["ksp_rnorm_30"] <= 500
        assert {"steps_per_sec", "ms_per_step", "retention_10", "retention_40",
                "ksp_rnorm"} <= set(rec)
    else:
        assert out["fastest_pass"] is None and "steps_per_sec" not in rec


def test_tune512_rnorm_gate_fails_a_looser_combo():
    """fastest_pass skips a faster combo that failed its gates."""
    results = [{"label": "a", "verdict": "PASS", "steps_per_sec": 1.0},
               {"label": "b", "verdict": "FAIL: quality gate", "steps_per_sec": 9.0}]
    assert tune512.fastest_pass(results) == "a"
    assert tune512.fastest_pass(results[1:]) is None


def test_tune128_main(capsys):
    tune128.main(CPU + ["--N", "8", "--steps", "1"])
    out = line_of(capsys)
    assert out["grid"] == [8, 8, 8] and out["steps"] == 5
    assert [r["label"] for r in out["results"]] == [label for label, _ in tune128.COMBOS]
    prod = out["results"][0]
    assert prod["finite"] and prod["max_dvx_vs_production"] == 0.0
    for r in out["results"]:
        assert "error" in r or {"steps_per_sec", "ms_per_step", "rnorm", "retention",
                                "max_dvx_vs_production"} <= set(r)


def test_tune_cavity3d_main(capsys):
    tune_cavity3d.main(CPU + ["--N", "8x8x8", "--steps", "1"])
    out = line_of(capsys)
    assert out["grid"] == [8, 8, 8]
    assert list(out["steps_per_sec"]) == [label for label, _ in tune_cavity3d.FORMS]
    assert all(v > 0 for v in out["steps_per_sec"].values())


@pytest.mark.parametrize("fast", [False, True])
def test_profile3d_main(capsys, fast):
    profile3d.main(CPU + ["--N", "8", "--steps", "1"] + (["--fast"] if fast else []))
    out = line_of(capsys)
    assert out["preset"] == ("production_fast" if fast else "production")
    assert list(out["ms_per_step"]) == ["o3/m8/s6", "o3/m8/s2", "o3/m2/s6", "o1/m8/s6"]
    assert {"per_schur_iter_ms", "per_mom_iter_ms", "per_outer_iter_ms", "outer_fixed_part_ms",
            "step_fixed_part_ms"} <= set(out)
    assert ("spmv_ms" in out) != fast


def test_profile3d_marginal_costs():
    """The reference's arithmetic (profile3d.py:140-152)."""
    m = profile3d.marginal({"base": 100.0, "s2": 76.0, "m2": 64.0, "o1": 40.0})
    assert m["per_schur_iter_ms"] == 2.0 and m["per_mom_iter_ms"] == 2.0
    assert m["per_outer_iter_ms"] == 30.0 and m["outer_fixed_part_ms"] == 30.0 - 12.0 - 16.0
    assert m["step_fixed_part_ms"] == 100.0 - 90.0


def test_profile_mom3d_main(capsys, monkeypatch):
    monkeypatch.setattr(profile_mom3d, "APPLY_ITERS", (2, 4))
    monkeypatch.setattr(profile_mom3d, "SOLVE_ITERS", (2, 3))
    profile_mom3d.main(CPU + ["--N", "8"])
    out = line_of(capsys)
    assert out["speed_of_light_fields"] == [18, 3]
    # v, the 12 face arrays and the 3 outputs, in float32
    assert out["a_apply_bytes"] == 4 * (6 * 8**3 + 12 * 8 * 8 * 8 + 4 * 8 * 8)
    assert {"a_apply_ms", "speed_of_light_ms", "a_apply_bound_ms", "bicgstab8_ms",
            "per_iter_ms", "vec_op_share_ms_per_iter"} <= set(out)


def test_pin128_outer_main(capsys):
    pin128.main(CPU + ["--steps", "1", "--outer"])
    out = line_of(capsys)
    assert list(out["outer_sweep"]) == [label for label, _ in pin128.outer_sweep()]
    assert all(np.isfinite(v) for v in out["outer_sweep"].values())
    assert out["outer_sweep_pass"] == {k: v < pin128.PIN_BAR for k, v in out["outer_sweep"].items()}


@pytest.mark.parametrize("n", [8, 10])
def test_sphere_drag_builds_the_grid_it_names(n):
    ns, ibm = sphere_drag.setup(2.0, 0.5, "cpu", n)
    assert tuple(ns.mesh.N) == (n, n, n) and ibm.markers.X.shape[0] > 0


def test_sphere_drag_n_main(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(sphere_drag, "T_MAX", 0.05)
    monkeypatch.setattr(sphere_drag, "CHUNK", 3)
    sphere_drag.main(CPU + ["--L", "2", "--N", "8", "--out-dir", str(tmp_path)])
    out = line_of(capsys)
    assert sphere_drag.N == 128
    assert out["N"] == 8 and out["config"].startswith("sphere 8^3")
    assert out["cells_per_diameter"] == pytest.approx(0.5 / (2.0 / 8))
    assert (tmp_path / "sphere8_checkpoint").exists()
