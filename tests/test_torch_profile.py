"""The `profile` verb of the PyTorch port (utils/profiling.py), on the CPU.

The counterpart of tests/test_bootstrap_profile.py::test_profile_case_smoke
(a fresh case, 3 profiled steps under torch.profiler, the trace and
`summary.txt` written, the stats keys those of the JAX package's
profile_case on the same case); the command line's `--action profile`
after a short `run` (it profiles from the checkpoint); a 6DoF case,
whose step takes the motion of its table as `run_case` builds it; and
the device busy time the chip scripts read from a trace.
"""

import json
import os
import shutil
import unittest.mock as mock

from openfoam_tpp_tpu.manager.cases import setup_case as jsetup
from openfoam_tpp_tpu.utils.profiling import profile_case as jprofile
from openfoam_tpp_tpu_torch.manager import cases as tcases
from openfoam_tpp_tpu_torch.manager import cli as tcli
from openfoam_tpp_tpu_torch.solver import timestep as ttimestep
from openfoam_tpp_tpu_torch.utils import profiling as tprof

ROW = {"H": 0.04, "D": 0.016, "mesh": 0.004, "geo": "flat", "R": 0.002,
       "freq": 2.5, "duration": 0.2, "dt": 1e-3, "ramp": 0.02}
quiet = lambda *a: None


def _summary_keys(path):
    with open(path) as f:
        return [ln.split(":", 1)[0] for ln in f if ln.strip()]


def test_profile_case_smoke(tmp_path):
    case_dir = tcases.setup_case(ROW, str(tmp_path / "port"))
    stats = tprof.profile_case(case_dir, n_steps=3, log=quiet, device="cpu")
    assert stats["n_steps"] == 3
    assert stats["cell_updates_per_sec"] > 0
    assert stats["device"] == "cpu" and stats["p_iters"] > 0
    summary = os.path.join(stats["trace_dir"], "summary.txt")
    assert os.path.isfile(summary)
    with open(os.path.join(stats["trace_dir"], tprof.TRACE_FILE)) as f:
        assert json.load(f)["traceEvents"]

    # The JAX package's profile_case on the same case: the same keys, in
    # the summary too.
    jcase = jsetup(ROW, str(tmp_path / "jax"))
    assert os.path.basename(jcase) == os.path.basename(case_dir)
    jstats = jprofile(jcase, n_steps=2, log=quiet)
    assert list(stats) == list(jstats)
    assert stats["grid"] == jstats["grid"]
    assert stats["fluid_cells"] == jstats["fluid_cells"]
    assert _summary_keys(summary) == _summary_keys(
        os.path.join(jstats["trace_dir"], "summary.txt"))


def test_cli_profile_after_run(tmp_path, monkeypatch, capsys):
    case_dir = tcases.setup_case({**ROW, "duration": 0.05}, str(tmp_path))
    name = os.path.basename(case_dir)
    base = ["--headless", "--base-dir", str(tmp_path), "--case", name,
            "--device", "cpu"]
    assert tcli.main(base + ["--action", "run"]) == 0
    monkeypatch.setenv("OFTPP_PROFILE_STEPS", "2")
    assert tcli.main(base + ["--action", "profile"]) == 0
    out = capsys.readouterr()
    assert "not ported" not in out.err
    assert "Profiling from checkpoint t=0.0500" in out.out
    outdir = os.path.join(case_dir, "postProcessing", "profile")
    with open(os.path.join(outdir, "summary.txt")) as f:
        text = f.read()
    assert "n_steps: 2\n" in text
    assert os.path.isfile(os.path.join(outdir, tprof.TRACE_FILE))
    shutil.rmtree(outdir)


def test_profile_6dof_case_takes_its_motion(tmp_path):
    case_dir = tcases.setup_case_6dof(
        {"Lx": 0.2, "Ly": 0.2, "Lz": 0.2, "mesh": 0.05, "duration": 0.1},
        str(tmp_path))
    with mock.patch.object(ttimestep, "make_step",
                           wraps=ttimestep.make_step) as spy:
        stats = tprof.profile_case(case_dir, n_steps=2, log=quiet,
                                   device="cpu")
    motion = spy.call_args.kwargs["motion"]
    assert motion is not None and motion.has_rotation
    assert stats["n_steps"] == 2 and stats["grid"] == [4, 4, 4]


def test_busy_union_us_merges_overlapping_device_spans():
    """The device busy time of a trace (utils/devtime.py, which chip_smoke.py
    and scripts/port_step_profile.py read): overlapping and touching device
    intervals count once, gaps and host events not at all."""
    import types

    import torch

    from openfoam_tpp_tpu_torch.utils.devtime import busy_union_us

    def ev(start, end, kind):
        return types.SimpleNamespace(
            device_type=getattr(torch.autograd.DeviceType, kind),
            time_range=types.SimpleNamespace(start=start, end=end))

    events = [ev(10.0, 20.0, "CUDA"), ev(0.0, 100.0, "CPU"),
              ev(15.0, 30.0, "CUDA"), ev(30.0, 32.0, "CUDA"),
              ev(50.0, 51.5, "CUDA")]
    assert busy_union_us(events) == 23.5
    assert busy_union_us([ev(0.0, 5.0, "CPU")]) == 0.0
