"""The harness finds cells, configurations, traffic, metrics, systems,
tanks and kernel byte counts by name, and a new file adds one without an
edit."""

import json
import shutil
import time

import pytest

from h100bench import compare, harness
from h100bench.tests import tiny


def test_cells_name_their_files():
    for name in harness.names("cells", ".json"):
        cell, config, traffic = harness.load_cell(name)
        assert cell["name"] == name
        assert config["name"] == cell["config"]
        assert traffic["name"] == cell["traffic"]
        assert (harness.ROOT / "systems" / f"{config['system']}.py").is_file()
        tank = config.get("tank", "cylinder")
        assert (harness.ROOT / "tanks" / f"{tank}.py").is_file()
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


# A box tank of its own keys (Lx, Ly, Lz, a cell size, an orbit) that
# maps them onto the cylinder's code: square in plan, as the cylinder's
# grid is. Its system builds the port's one-case step on the same map.
BOX_TANK = '''
from h100bench import harness


def as_cylinder(config):
    assert config["Lx"] == config["Ly"]
    return dict(config["orbit"], H=config["Lz"], D=config["Lx"],
                mesh=config["cell"], geo="flat", round_to=8)


def _cylinder():
    return harness.load_module("tanks", "cylinder")


def make_inputs(config, traffic, seed, device, rows=None):
    return _cylinder().make_inputs(as_cylinder(config), traffic, seed,
                                   device, rows)


def reference_segment(config, traffic, seed, device, n_steps, hook=None):
    return _cylinder().reference_segment(as_cylinder(config), traffic, seed,
                                         device, n_steps, hook=hook)
'''

BOX_SYSTEM = '''
from h100bench import harness


def build(config, device):
    box = harness.load_module("tanks", "box")
    return harness.load_module("systems", "case_step").build(
        box.as_cylinder(config), device)
'''


def test_a_new_tank_file_is_read(copy_root):
    (copy_root / "tanks" / "box.py").write_text(BOX_TANK)
    box = {"Lx": 1.0, "Ly": 1.0, "Lz": 2.0, "cell": 0.1, "orbit": {}}
    assert harness.tank({"tank": "box"}).as_cylinder(box)["H"] == 2.0
    cylinder = copy_root / "tanks" / "cylinder.py"
    assert harness.tank({}).__file__ == str(cylinder)


def test_a_configuration_without_the_cylinders_keys_runs(copy_root):
    """Nothing outside the tank and system files reads H, D, mesh, geo,
    round_to or the orbit's keys: a box configuration has none of them,
    and runs to a correct result whose control fails the limits."""
    (copy_root / "tanks" / "box.py").write_text(BOX_TANK)
    (copy_root / "systems" / "box_step.py").write_text(BOX_SYSTEM)
    _, cell, flagship, traffic = tiny.cell(tiny.FLAGSHIP)
    config = {"name": "box", "system": "box_step", "tank": "box",
              "Lx": flagship["D"], "Ly": flagship["D"], "Lz": flagship["H"],
              "cell": flagship["mesh"],
              "orbit": {k: flagship[k] for k in ("R", "freq", "duration",
                                                 "ramp")}}
    cell = dict(cell, name="box.slosh", config="box")
    r = harness.run("box.slosh", cell, config, traffic, 2 ** 31 + 3, 0.2,
                    False, "cpu", time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0
    vals = compare.control(config, traffic, 31337, "cpu")
    assert any(v > cell["limits"][k] for k, v in vals.items())


def test_a_tank_with_no_file_fails_before_set_up(copy_root):
    (copy_root / "systems" / "boom.py").write_text(
        "def build(config, device):\n    raise RuntimeError('built')\n")
    name, cell, _, traffic = tiny.cell(tiny.FLAGSHIP)
    config = {"name": "x", "system": "boom", "tank": "no-such-tank"}
    with pytest.raises(FileNotFoundError, match="tanks/no-such-tank.py"):
        harness.run(name, cell, config, traffic, 1, 0.2, False, "cpu",
                    time.perf_counter())
    with pytest.raises(FileNotFoundError, match="tanks/no-such-tank.py"):
        compare.control(config, traffic, 1, "cpu")


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
