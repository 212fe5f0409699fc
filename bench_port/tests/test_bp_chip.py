"""On the card: each cell runs through `run.py` with a short window, prints
its result line last, and reads `correct`.  Skipped without CUDA (the
port's kernels have no CPU mode); run on the card with
`python3 -m pytest --noconftest -m cuda bench_port/tests/test_bp_chip.py`."""
import json
import subprocess
import sys

import pytest

from bench_port.harness import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    out = subprocess.run([sys.executable, "-m", "bench_port.run", "--workload", cell,
                          "--seed", "4294967311", "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["attempted"] > 0


def test_run_refuses_without_the_cards(tmp_path):
    """Without CUDA (or in a directory holding only BENCHMARK.json and the
    benchmark's files, where the port is missing) a run prints no result and
    exits non-zero."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "bench_port.run", "--workload",
                          MANIFEST["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
