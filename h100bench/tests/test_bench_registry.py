"""The harness finds cells, configurations, traffic, metrics, systems and
kernel byte counts by name, and a new file adds one without an edit."""

import json
import shutil

import pytest

from h100bench import harness


def test_cells_name_their_files():
    for name in harness.names("cells", ".json"):
        cell, config, traffic = harness.load_cell(name)
        assert cell["name"] == name
        assert config["name"] == cell["config"]
        assert traffic["name"] == cell["traffic"]
        assert (harness.ROOT / "systems" / f"{config['system']}.py").is_file()
        assert cell["chips"] in (1, 4)


def test_benchmark_json_matches_the_files():
    spec = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = harness.load_json("cells", w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
    for c in spec["configs"]:
        config = json.loads((harness.ROOT.parent / c["file"]).read_text())
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        reader = harness.load_module("metrics", m["name"])
        assert reader.UNIT == m["unit"]


@pytest.fixture
def copy_root(tmp_path, monkeypatch):
    root = tmp_path / "h100bench"
    shutil.copytree(harness.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(harness, "ROOT", root)
    return root


def test_a_new_metric_file_is_read(copy_root):
    (copy_root / "metrics" / "step.count.py").write_text(
        'UNIT = "steps"\n\ndef read(run):\n    return run.steps\n')
    assert "step.count" in harness.cell_metrics("x", False, None)
    run = harness.Run()
    run.steps = 7
    assert harness.load_module("metrics", "step.count").read(run) == 7


def test_a_new_cell_file_is_read(copy_root):
    cell = harness.load_json("cells", "flagship-288.slosh")
    cell.update(name="flagship-288.other", traffic="other")
    (copy_root / "cells" / "flagship-288.other.json").write_text(json.dumps(cell))
    traffic = harness.load_json("traffic", "slosh")
    traffic.update(name="other", segment_steps=7)
    (copy_root / "traffic" / "other.json").write_text(json.dumps(traffic))
    assert "flagship-288.other" in harness.names("cells", ".json")
    _, config, traffic = harness.load_cell("flagship-288.other")
    assert traffic["segment_steps"] == 7 and config["name"] == "flagship-288"


def test_a_new_kernel_byte_file_is_read(copy_root):
    from h100bench import trace

    (copy_root / "kernel_bytes" / "halo_thing.py").write_text(
        'MODULE = "halo7"\n\ndef nbytes(args, kwargs, out):\n    return 1\n')
    assert "halo_thing" in trace.Wrappers(copy_root).kernels


def test_metric_selection_follows_benchmark_json():
    spec = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["y"]}],
            "per_layer": [{"name": "c", "workloads": ["x"]}]}
    assert harness.cell_metrics("x", False, spec) == ["a"]
    assert harness.cell_metrics("x", True, spec) == ["c"]
    assert harness.cell_metrics("y", True, spec) == []
