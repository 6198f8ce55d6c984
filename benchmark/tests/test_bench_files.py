"""``BENCHMARK.json`` and the files the harness finds by name: every
configuration, traffic, cell and metric file parses and agrees with it,
and a cell, a metric or a configuration of a new kind added as files and
entries alone is picked up."""

import json
import os
import re
import shutil
import sys

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


TOY_KIND = '''"""A toy kind: the sd step at tiny sizes, with one more sub-model that
its reference requires and a seeded input file that it checks."""

import os

import numpy as np

from benchmark.kinds import sd


def _condition(seed):
    return np.random.default_rng(seed).random((4, 4, 4)).astype(np.float32)


def _extra(config):
    width = config["extra"]["width"]
    return {"name": "extra", "config": config["extra"], "file": "pytorch_model.bin",
            "shapes": {"proj.weight": (width, 4), "proj.bias": (width,)}}


def weight_files(config):
    return sd.weight_files(config) + [_extra(config)]


def inputs(cell, seed, run_dir):
    path = os.path.join(run_dir, "condition.npy")
    np.save(path, _condition(seed))
    return [f"system.condition_path={path}"]


class Reference(sd.Reference):
    def __init__(self, yaml_cfg, config, weights, device, precision):
        if tuple(weights["extra"]["proj.weight"].shape) != _extra(config)["shapes"]["proj.weight"]:
            raise ValueError("the extra sub-model is not the kind's")
        super().__init__(yaml_cfg, dict(config, kind="sd"), weights, device, precision)
        self.condition = yaml_cfg["system"]["condition_path"]

    def init_state(self, seed):
        if not np.array_equal(np.load(self.condition), _condition(seed)):
            raise ValueError("the input file is not the seed's")
        return super().init_state(seed)


def model_seconds(config, ctx, flags):
    return 0.25 * ctx["step_s_untraced"] * len(ctx["batch"]["c2w"]) / ctx["batch_shape"][0]
'''


def copied_checkout(tmp_path):
    """A checkout in ``tmp_path``: a copy of the benchmark and of
    ``BENCHMARK.json``, the program linked in."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", ".runs", "__pycache__"))
    os.symlink(os.path.join(tiny.ROOT, "threestudio_3dgs_tpu_torch"),
               tmp_path / "threestudio_3dgs_tpu_torch")
    return spec()


def test_new_kind_needs_only_files(tmp_path, monkeypatch):
    """A copy of the benchmark with one more kind, configuration, traffic and
    cell file and their ``BENCHMARK.json`` entries: a traced CPU run of the
    cell draws the kind's extra sub-model, writes its seeded input, follows
    the steps with its reference (which fails the run without either) and
    reports ``mfu`` from its ``model_seconds``, no code file edited."""
    s = copied_checkout(tmp_path)
    bench = tmp_path / "benchmark"
    base = tiny.cell("sd21.t2i")
    (bench / "kinds" / "toy.py").write_text(TOY_KIND)
    config = dict(base["config"], name="tiny-toy", kind="toy", extra={"width": 8})
    (bench / "configs" / "tiny-toy.json").write_text(json.dumps(config))
    (bench / "traffic" / "toy-64x2.json").write_text(json.dumps(base["traffic"]))
    (bench / "workloads" / "toy.t2i.json").write_text(json.dumps(
        {"config": "tiny-toy", "traffic": "toy-64x2", "chips": 1,
         "limits": {"loss": 1e-3, "grad": 1e-2, "change": 5e-2}}))
    s["configs"].append({"name": "tiny-toy", "source": "https://example.org/toy",
                         "file": "benchmark/configs/tiny-toy.json", "reduced": [],
                         "why": "a kind of its own"})
    s["workloads"].append({"name": "toy.t2i", "config": "tiny-toy", "traffic": "toy-64x2",
                           "chips": 1, "why": "an added kind"})
    next(m for m in s["per_layer"] if m["name"] == "mfu")["workloads"].append("toy.t2i")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    # the harness finds the checkout on the path; the program still imports from the repo
    monkeypatch.setattr(sys, "path", sys.path + [str(tmp_path)])
    cell = harness.load_cell("toy.t2i", bench_dir=str(bench))
    work = tmp_path / "work"
    r = harness.run("toy.t2i", 20251020, 0.5, True, root=str(tmp_path), device="cpu",
                    require_card=False, cell=cell, log=lambda s: None, work_dir=str(work))
    assert r["correct"], r["compared"]
    (wdir,) = (work / ".cache" / "weights").iterdir()
    assert sorted(p.name for p in wdir.iterdir()) == ["complete", "extra", "unet", "vae"]
    assert json.loads((wdir / "extra" / "config.json").read_text()) == {"width": 8}
    import torch

    extra = torch.load(wdir / "extra" / "pytorch_model.bin", weights_only=True)
    assert {k: tuple(v.shape) for k, v in extra.items()} == {"proj.weight": (8, 4),
                                                           "proj.bias": (8,)}
    assert r["metrics"]["mfu"]["value"] == pytest.approx(25.0)


def test_unknown_kind_fails_before_any_weight(tmp_path):
    c = tiny.cell("sd21.t2i")
    c["config"]["kind"] = "nosuch"
    with pytest.raises(FileNotFoundError, match=r"kinds/nosuch\.py"):
        harness.run(c["name"], 1, 0.5, False, root=tiny.ROOT, device="cpu", require_card=False,
                    cell=c, log=lambda s: None, work_dir=str(tmp_path))
    assert not (tmp_path / ".cache").exists()
