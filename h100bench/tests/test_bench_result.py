"""A run's result line and what a run refuses: no card, no JAX."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from h100bench import harness
from h100bench.tests import tiny

REPO = Path(harness.ROOT).parent


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    r = tiny.run(tiny.FLAGSHIP, trace=trace)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(r) == want + ["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    if trace:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(r["device"])
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in r["compared"].values():
        assert set(c) == {"value", "limit"}


def test_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         "flagship-288.slosh", "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_nothing_of_jax_is_loaded_by_a_run():
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from h100bench.tests import tiny; from h100bench import harness;"
            "tiny.run(tiny.SWEEP, trace=True);"
            "import openfoam_tpp_tpu_torch;"
            "print(harness.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "openfoam_tpp_tpu_torch_x", sys)
    assert "openfoam_tpp_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "openfoam_tpp_tpu.config", sys)
    assert harness.forbidden_modules() == ["openfoam_tpp_tpu"]


def test_result_is_one_json_line():
    r = tiny.run(tiny.SWEEP)
    line = json.dumps(r)
    assert "\n" not in line and json.loads(line)["correct"] is True
