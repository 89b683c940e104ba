"""Each cell's run on a CUDA card, short: the result line's keys, the
cell's end-to-end metrics, and ``correct``. Skips where torch sees no
card (decided inside the test)."""

import json
import subprocess
import sys

import pytest
from conftest import ROOT, SEED

from benchmark.harness import load_cell


def cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", cells())
def test_a_short_run_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs only on the GPU")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
                        str(SEED), "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, timeout=1500, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True, line["checks"]
    cell = load_cell(workload)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
