"""BENCHMARK.json and every file it names: they parse, keep to the
contract's names, units and limits, and each metric has its reader."""

import json
import re

import pytest

from perfbench import run as R
from perfbench.tests.tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and re.match(r"^[A-Za-z0-9_./\-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    for w in BENCH["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds_and_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    # a full check of 24 cells, 2 + 14 runs each, fits in 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_parse_and_match():
    for c in BENCH["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and any(str(f).startswith(str(ROOT / p)) for p in BENCH["paths"])
        data = json.loads(f.read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
    for w in BENCH["workloads"]:
        bench, entry, config, traffic, limits = R.cell_spec(w["name"])
        assert entry is w or entry == w
        numbers = {k: v for k, v in limits.items() if k != "optional"}
        assert numbers and all(v >= 0 for v in numbers.values())
        assert set(limits.get("optional", [])) <= set(numbers)
        assert {"steps", "cfg_scale", "frames", "height", "width", "prompts"} <= set(traffic)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_reader_declares_its_metric(metric):
    reader = R.load_reader(metric["name"])
    assert reader.UNIT == metric["unit"]
    if "moves" in metric:
        assert reader.LAYER == metric["layer"] and reader.MOVES == metric["moves"]


def test_moves_is_reported_where_the_metric_is():
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        e2e = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e.get("workloads", cells), (m["name"], cell)
    for cell in cells:
        assert any(m for m in R.cell_metrics(BENCH, cell, False) if m["name"] != "setup_s")
        assert R.cell_metrics(BENCH, cell, True)
        assert any(m["name"] == "setup_s" for m in R.cell_metrics(BENCH, cell, False))


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("change", [
    ("traffic", "clients", 2), ("traffic", "mode", "open_loop"), ("traffic", "world", 4),
    ("traffic", "sampler", "EulerEDMSampler"), ("config", "dtype", "float8_e4m3fn"),
    ("config", "int8", ["conv"]), ("config", "world", 4), ("reference", "frame", "first"),
    ("reference", "prior_type", "video_ref")], ids=lambda c: f"{c[0]}.{c[1]}")
def test_a_key_or_value_that_nothing_runs_is_refused(change):
    from perfbench.cell import validate

    _, _, config, traffic, _ = R.cell_spec("tvi2v.edit")
    validate(config, traffic)
    where, key, value = change
    target = {"traffic": traffic, "config": config, "reference": traffic["reference"]}[where]
    target[key] = value
    with pytest.raises(ValueError, match="perfbench: "):
        validate(config, traffic)


@pytest.mark.parametrize("env", [{"CCEDIT_INT8": "1"}, {"CCEDIT_QUANT_QK": "1"}])
def test_an_int8_switch_the_configuration_does_not_set_is_refused(env, monkeypatch):
    from ccedit_tpu_torch.ops.attention import quantized_qk_enabled, set_quantized_qk
    from ccedit_tpu_torch.ops.quant import quantized_matmul_enabled, set_quantized_matmul

    from perfbench.cell import set_int8

    config = R.cell_spec("tv2v.edit")[2]
    for k in ("CCEDIT_INT8", "CCEDIT_QUANT_MATMUL", "CCEDIT_QUANT_QK"):
        monkeypatch.delenv(k, raising=False)
    set_int8(config)
    assert not quantized_matmul_enabled() and not quantized_qk_enabled()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="int8 switches"):
        set_int8(config)
    set_int8(dict(config, int8=["matmul", "qk"]) if "CCEDIT_INT8" in env else
             dict(config, int8=["qk"]))
    assert quantized_qk_enabled()
    set_quantized_matmul(False)
    set_quantized_qk(False)
