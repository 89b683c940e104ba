"""No module that a run loads is JAX or the JAX package: a cell's
CPU-reachable path (set-up, window, traced steps, the reference) run in
a fresh process, then its modules' top-level names compared whole."""

import subprocess
import sys

from conftest import ROOT

from benchmark.harness import FORBIDDEN, forbidden_modules

SCRIPT = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})
from conftest import tiny_cell, SEED
from benchmark.harness import run_cell, result_line, forbidden_modules
for kind in ("channel", "sphere"):
    run = run_cell(tiny_cell(kind), SEED, 0.1, True, time.perf_counter(), device="cpu")
    result_line(run, True)
print(sorted({{m.split('.')[0] for m in sys.modules}}))
print(forbidden_modules())
"""


def test_a_run_loads_no_jax():
    r = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    names, bad = r.stdout.strip().splitlines()[-2:]
    assert bad == "[]"
    assert "'fluca_tpu_torch'" in names
    assert not any(f"'{f}'" in names for f in FORBIDDEN)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fluca_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fluca_tpu.ns", sys)
    assert forbidden_modules() == ["fluca_tpu"]
