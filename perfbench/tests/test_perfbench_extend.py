"""A configuration, a traffic mix, a cell and a per-layer metric are added
with new files and entries alone: no file of the benchmark is edited."""

import json
import os
import shutil
import subprocess
import sys

from perfbench.tests.tiny import ROOT


def test_add_by_files_and_entries(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "ccedit-tv2v-sd15.json").read_text())
    cfg["name"] = "dummy-config"
    (pb / "configs" / "dummy-config.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "edit30.json").read_text())
    (pb / "traffic" / "dummy_mix.json").write_text(json.dumps(dict(traffic, steps=20)))
    (pb / "limits" / "dummy.cell.json").write_text(json.dumps({"row_err": 0.1}))
    (pb / "metrics" / "dummy_metric.py").write_text(
        'UNIT, LAYER, MOVES = "ms", "network", "clip_s"\n\n\ndef read(ctx):\n    return 1.0\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="dummy-config",
                                 file="perfbench/configs/dummy-config.json"))
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy-config",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_metric", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "network", "moves": "clip_s",
                               "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench import run\n"
            "bench, entry, config, traffic, limits = run.cell_spec('dummy.cell')\n"
            "names = [m['name'] for m in run.cell_metrics(bench, 'dummy.cell', True)]\n"
            "print(config['name'], traffic['steps'], limits, 'dummy_metric' in names,\n"
            "      run.load_reader('dummy_metric').read(None))" % str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["dummy-config", "20", "{'row_err':", "0.1}", "True", "1.0"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


W8A8 = """
import argparse, json, sys, torch
sys.path[:0] = [{root!r}, {repo!r}]
from perfbench import run as R
from perfbench.tests.tiny import tiny_spec
from ccedit_tpu_torch.ops import quant
from ccedit_tpu_torch.ops.attention import quantized_qk_enabled
calls = {{"qconv": 0, "qlinear": 0}}
def counted(name, fn):
    def call(*args, **kw):
        calls[name] += 1
        return fn(*args, **kw)
    return call
for name in calls:
    setattr(quant, name, counted(name, getattr(quant, name)))
a = argparse.Namespace(workload="tv2v.edit.w8a8", seed=2 ** 31 + 5, seconds=3.0, trace=0)
result = R.run(a, device=torch.device("cpu"), spec=tiny_spec("tv2v.edit.w8a8"))
print(json.dumps([quant.quantized_matmul_enabled(), quantized_qk_enabled(), calls]))
"""


def test_a_w8a8_cell_is_data(tmp_path):
    """The W8A8 edit that PERF.md keeps for later comes as a configuration
    that lists the port's int8 switches, a limits file and two entries; the
    run turns the switches on from the configuration alone."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "ccedit-tv2v-sd15.json").read_text())
    cfg.update(name="ccedit-tv2v-sd15-w8a8", int8=["matmul", "qk"])
    (pb / "configs" / "ccedit-tv2v-sd15-w8a8.json").write_text(json.dumps(cfg))
    limits = json.loads((pb / "limits" / "tv2v.edit.json").read_text())
    (pb / "limits" / "tv2v.edit.w8a8.json").write_text(json.dumps(limits))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="ccedit-tv2v-sd15-w8a8",
                                 file="perfbench/configs/ccedit-tv2v-sd15-w8a8.json"))
    bench["workloads"].append({"name": "tv2v.edit.w8a8", "config": "ccedit-tv2v-sd15-w8a8",
                               "traffic": "edit30", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {k: v for k, v in os.environ.items() if not k.startswith("CCEDIT_")}
    out = subprocess.run([sys.executable, "-c", W8A8.format(root=str(tmp_path), repo=str(ROOT))],
                         capture_output=True, text=True, timeout=900, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    matmul, qk, calls = json.loads(out.stdout.strip().splitlines()[-1])
    assert matmul and qk
    # the window's convolutions and dense layers went through the W8A8 path
    assert calls["qconv"] > 0 and calls["qlinear"] > 0, calls
    after = {p: p.read_bytes() for p in before}
    assert after == before
