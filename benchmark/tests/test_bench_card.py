"""On a card: each cell run once as the driver runs it, short, with the
contract's last line and ``correct`` true. Skips without a card."""
import json
import subprocess
import sys

import pytest

from benchmark.registry import ROOT, Registry

CELLS = [w["name"] for w in Registry().bench["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct(card, cell, traced):
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        cell, "--seed", str(2 ** 31 + 17), "--seconds", "3",
                        "--trace", str(traced)], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["compared"]
    assert line["device"]["platform"] == "gpu"
