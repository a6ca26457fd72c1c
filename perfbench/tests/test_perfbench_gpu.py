"""On the card: one run of each one-GPU cell at the benchmark's length,
through its command, is correct and prints the contract's last line."""

import json
import subprocess

import pytest

from perfbench.tests.tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"] if w["chips"] == 1])
def test_a_run_on_the_card(cell, cuda_device):
    out = subprocess.run(BENCH["command"] + ["--workload", cell, "--seed", "2147483777",
                                             "--seconds", str(BENCH["run_seconds"]),
                                             "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert {"setup_s"} <= set(line["metrics"]) and list(line)[-1] == "checks"
