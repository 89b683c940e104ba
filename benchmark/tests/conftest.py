"""Shared pieces of the benchmark's CPU tests: tiny cells of each flow,
run through the harness on the CPU with the program's plain versions.

    python -m pytest benchmark/tests -q

Tests marked ``card`` need a CUDA card and skip elsewhere (decided inside
the test).
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.harness import Cell, load_json  # noqa: E402

B = ROOT / "benchmark"
# a seed above 2**31, as large as a benchmark check may draw
SEED = 2**31 + 17
LIMITS = tuple(f"{step}_{part}_gap" for step in ("start", "step", "post") for part in ("vel", "p"))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(kind: str, dtype: str = "float64", limits=None, solver=None) -> Cell:
    """A small cell of ``kind`` ("channel" or "sphere") built from the
    real configuration and traffic files with the grid shrunk; every
    limit 1e-9 unless ``limits`` are given."""
    if kind == "channel":
        cfg = load_json(B / "configs/channel512.json")
        cfg.update(N=[16, 8, 8])
        tr = load_json(B / "traffic/shipped.json")
    else:
        cfg = load_json(B / "configs/sphere192.json")
        cfg.update(N=[24, 16, 16], L=[3.0, 2.0, 2.0], center=[1.0, 1.0, 1.0])
        tr = load_json(B / "traffic/wake.json")
    cfg["dtype"] = dtype
    if solver is not None:
        tr = dict(tr, solver=dict(tr["solver"], **solver))
    return Cell(name=f"tiny.{kind}", root=ROOT, chips=1, config=cfg, traffic=tr,
                limits={"limits": limits or dict.fromkeys(LIMITS, 1e-9)},
                end_to_end=[], per_layer=[])
