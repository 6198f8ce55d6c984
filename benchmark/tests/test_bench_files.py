"""``BENCHMARK.json`` and the files the harness finds by name: every
configuration, traffic, cell and metric file parses and agrees with it,
and a cell or a metric added as files and entries alone is picked up."""

import json
import os
import re
import shutil

import pytest
import yaml

from benchmark import harness, metrics

import tiny

BENCH = os.path.join(tiny.ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_spec_shape():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["paths"] == ["benchmark"] and 1 <= s["run_seconds"] <= 51
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for c in s["configs"] + s["workloads"]:
        assert NAME.match(c["name"]) and len(c["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_cell_files_parse_and_agree(cell):
    s = spec()
    entry = next(w for w in s["workloads"] if w["name"] == cell)
    c = harness.load_cell(cell)
    assert c["cell"]["config"] == entry["config"] and c["cell"]["traffic"] == entry["traffic"]
    assert c["cell"].get("chips", 1) == entry["chips"]
    conf = next(x for x in s["configs"] if x["name"] == entry["config"])
    assert conf["file"] == f"benchmark/configs/{entry['config']}.json"
    for key in conf["reduced"]:
        assert key in c["config"]
    with open(os.path.join(tiny.ROOT, c["traffic"]["yaml"])) as f:
        yml = yaml.safe_load(f)
    assert yml["system"]["guidance_type"] == c["config"]["guidance"]
    assert c["cell"]["limits"] and set(c["cell"]["limits"]) <= {"loss", "grad", "change",
                                                                 "change_median"}


@pytest.mark.parametrize("metric", [m["name"] for m in spec()["per_layer"]])
def test_metric_readers_load(metric):
    assert callable(metrics.reader(metric))


def test_new_cell_and_metric_need_only_files(tmp_path):
    """A copy of the benchmark with one more cell file, metric file and
    BENCHMARK.json entry: the harness finds the cell and reports the
    metric, no code edited."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", ".runs", "__pycache__"))
    s = spec()
    (tmp_path / "benchmark" / "workloads" / "sd21.extra.json").write_text(
        json.dumps({"config": "sd21-base", "traffic": "sd-512x4", "chips": 1,
                    "limits": {"loss": 1, "grad": 1, "change": 1}}))
    (tmp_path / "benchmark" / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return 2 * len(ctx['data_ms'])\n")
    s["workloads"].append({"name": "sd21.extra", "config": "sd21-base", "traffic": "sd-512x4",
                           "chips": 1, "why": "an added cell"})
    s["per_layer"].append({"name": "new_metric", "unit": "1", "better": "lower",
                           "source": "host_clock", "layer": "data module", "moves": "step_ms",
                           "workloads": ["sd21.extra"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    cell = harness.load_cell("sd21.extra", bench_dir=str(tmp_path / "benchmark"))
    assert cell["config"]["name"] == "sd21-base"
    assert [m["name"] for m in metrics.per_layer("sd21.extra", str(tmp_path))][-1] == "new_metric"
    import importlib.util

    spec_ = importlib.util.spec_from_file_location(
        "copied_metrics", tmp_path / "benchmark" / "metrics" / "__init__.py")
    copied = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(copied)
    out = copied.read_all("sd21.extra", {"data_ms": [1.0, 2.0], "trace": None}, str(tmp_path))
    assert out["new_metric"] == {"value": 4.0, "unit": "1"}
