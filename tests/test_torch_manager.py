"""The port's manager top layer against the JAX package's, on the CPU:
the menu's range and index parsing, the resource estimate's formulas, the
Slurm job script, the dependency check, the interactive menu and the
headless verbs it drives.

Tolerances: none. These are host copies of the JAX modules (the resource
constants excepted: the card's, not the TPU's), so the same inputs must
give the same lists, errors, strings and bytes; the menu's case.json and
the `flow` CSV byte-equal to the JAX package's.
"""

import io
import os
import shutil
import sys

import pytest

from openfoam_tpp_tpu.manager import cli as jcli
from openfoam_tpp_tpu.manager import submit as jsubmit
from openfoam_tpp_tpu.utils import naming as jnaming
from openfoam_tpp_tpu.utils import resources as jres
from openfoam_tpp_tpu_torch.manager import cases as tcases
from openfoam_tpp_tpu_torch.manager import cli as tcli
from openfoam_tpp_tpu_torch.manager import submit as tsubmit
from openfoam_tpp_tpu_torch.utils import bootstrap
from openfoam_tpp_tpu_torch.utils import naming as tnaming
from openfoam_tpp_tpu_torch.utils import resources as tres

# The verify skill's piped menu answers: build the tiny case, exit.
TINY_ANSWERS = ["1", "0.04", "0.02", "0.004", "flat", "0.002", "3.0", "0.1",
                "0.0005", "-1", "6"]
TINY_NAME = "case_H0.04_D0.02_flat_R0.002_f3.0_d0.1_m0.004"


def _outcome(fn, *a):
    try:
        return ("ok", fn(*a))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", [
    "1:0.5:3", "1:3", "0.1, 0.2", "0.3", "0.002:0.001:0.005", " 2:-1:1 ",
    "0.1:0.1:0.3", "5:1", "1,,2", "", "1:2:3:4", "1:0:3", "a", "1:x"])
def test_parse_range_as_jax(spec):
    assert _outcome(tnaming.parse_range, spec) == _outcome(
        jnaming.parse_range, spec)


@pytest.mark.parametrize("spec,n", [
    ("all", 4), (" ALL ", 2), ("1, 3-5, 7", 6), ("2", 3), ("0, 9", 3),
    ("3-1", 5), ("", 3), ("1-2-3", 4), ("x", 2), ("1,,2", 3)])
def test_parse_indices_as_jax(spec, n):
    assert _outcome(tnaming.parse_indices, spec, n) == _outcome(
        jnaming.parse_indices, spec, n)


@pytest.mark.parametrize("x", [0.1, 2.0, 0.009, 1e-7, 3])
def test_format_float_as_jax(x):
    assert tnaming.format_float(x) == jnaming.format_float(x)


PARAMS = [dict(H=0.1, D=0.02, mesh=0.002, geo="flat", R=0.003, freq=2.0,
               duration=10.0),
          dict(H=0.208, D=0.2, mesh=0.00185, geo="flat", R=0.004, freq=1.88,
               duration=20.0),
          dict(H=0.05, D=0.03, mesh=0.001, geo="cap", R=0.0, freq=0.0,
               duration=0.33),
          dict(H=2.0, D=1.0, mesh=0.01, geo="cap", R=0.1, freq=5.0,
               duration=1e-4)]


@pytest.mark.parametrize("p", PARAMS)
def test_resource_formulas_as_jax(p):
    assert tres.estimate_cells(p) == jres.estimate_cells(p)
    assert tres.estimate_steps(p) == jres.estimate_steps(p)
    for s in (0.0, 59.4, 3600.0, 1e5):
        assert tres.format_time(s) == jres.format_time(s)
        assert tsubmit._walltime(s) == jsubmit._walltime(s)
    est = tres.estimate_resources(p)
    n = est.n_cells * est.n_steps
    assert est.wall_seconds == n / tres.GPU_CELL_UPDATES_PER_SEC
    assert est.memory_bytes == est.n_cells * tres.BYTES_PER_CELL + 0.5e9
    assert est.fits_on_chip == (est.memory_bytes < tres.DEVICE_BYTES)
    assert "one H100" in est.summary() and "chip" not in est.summary()


def test_resources_hold_no_tpu_figure():
    src = open(tres.__file__).read()
    for figure in ("2.13e8", "16e9", "v5e", "TPU", "HBM_BYTES"):
        assert figure not in src
    assert tres.GPU_CELL_UPDATES_PER_SEC != jres.TPU_CELL_UPDATES_PER_SEC


def test_run_script_contents(tmp_path):
    d = tcases.setup_case(
        {"H": 0.05, "D": 0.02, "mesh": 0.004, "duration": 0.5}, str(tmp_path))
    path = tsubmit.write_job_script(d, "run")
    assert os.path.basename(path) == "run_simulation.slurm"
    text = open(path).read()
    assert "#SBATCH --nodes=1" in text
    assert "--action run" in text
    assert os.path.basename(d) in text
    assert "--gres=gpu:1" in text and "#SBATCH --partition=gpu" in text
    assert "python -m openfoam_tpp_tpu_torch --headless" in text


def test_postprocess_script_sizing(tmp_path):
    d = tcases.setup_case({}, str(tmp_path))
    path = tsubmit.write_job_script(d, "interface")
    text = open(path).read()
    assert "--time=01:00:00" in text
    assert "--mem=8G" in text
    assert "--action interface" in text
    assert os.path.basename(path) == "postprocess_interface.slurm"


def test_job_script_is_jax_s_but_for_the_card(tmp_path, monkeypatch):
    """The same case gives JAX's script with the port's module, the gpu
    partition and gres, and the port's sizing."""
    d = tcases.setup_case({"H": 0.05, "D": 0.02, "mesh": 0.004,
                           "duration": 0.5}, str(tmp_path))
    monkeypatch.setattr(jres, "estimate_resources", tres.estimate_resources)
    for action in ("run", "video"):
        got = open(tsubmit.write_job_script(d, action)).read()
        want = open(jsubmit.write_job_script(d, action, "gpu", "gpu:1")).read()
        assert got == want.replace("-m openfoam_tpp_tpu ",
                                   "-m openfoam_tpp_tpu_torch ")


def test_submit_without_sbatch_writes_the_script(tmp_path, monkeypatch):
    d = tcases.setup_case({}, str(tmp_path))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    lines = []
    assert not tsubmit.submit_case(d, "run", log=lines.append)
    assert "sbatch not found" in lines[0]
    assert os.path.exists(os.path.join(d, "run_simulation.slurm"))


def test_check_dependencies_clean_env():
    assert bootstrap.check_dependencies(include_optional=False) == []
    assert set(bootstrap.REQUIRED) == {"torch", "numpy"}
    assert set(bootstrap.OPTIONAL) == {"matplotlib", "scipy", "PIL"}


def test_ensure_dependencies_reports_and_blocks(monkeypatch, capsys):
    monkeypatch.setattr(
        bootstrap, "check_dependencies",
        lambda include_optional=True: ["required dependency 'torch' is "
                                       "missing (need >= 2.0)"])
    monkeypatch.delenv("OFTPP_BOOTSTRAP", raising=False)
    assert not bootstrap.ensure_dependencies()
    err = capsys.readouterr().err
    assert "torch" in err and "OFTPP_BOOTSTRAP" in err


def test_ensure_dependencies_provisions_only_when_asked(monkeypatch):
    monkeypatch.setattr(
        bootstrap, "check_dependencies",
        lambda include_optional=True: ["required dependency 'torch' is "
                                       "missing"])
    monkeypatch.delenv(bootstrap._REEXEC_GUARD, raising=False)
    calls = []
    monkeypatch.setattr(bootstrap, "_provision_and_reexec",
                        lambda base: calls.append(base) or True)
    monkeypatch.setenv("OFTPP_BOOTSTRAP", "1")
    assert bootstrap.ensure_dependencies(base_dir="/x")
    assert calls == ["/x"]
    monkeypatch.setenv(bootstrap._REEXEC_GUARD, "1")
    assert not bootstrap.ensure_dependencies(base_dir="/x")
    assert calls == ["/x"]


def test_provision_reexecs_the_port(monkeypatch, tmp_path):
    """Provisioning (mocked: nothing runs pip) installs torch and numpy,
    then the repository without its dependencies, and re-executes
    `-m openfoam_tpp_tpu_torch` with the re-exec guard set."""
    runs, execs = [], []
    monkeypatch.setattr(bootstrap.subprocess, "run",
                        lambda cmd, check: runs.append(cmd))
    monkeypatch.setattr(bootstrap.os, "execve",
                        lambda py, argv, env: execs.append((py, argv, env)))
    monkeypatch.setattr(sys, "argv", ["x", "--headless"])
    assert bootstrap._provision_and_reexec(str(tmp_path))
    py = os.path.join(str(tmp_path), bootstrap.VENV_DIR, "bin", "python")
    assert runs[0][1:3] == ["-m", "venv"]
    assert runs[1] == [py, "-m", "pip", "install", "torch", "numpy"]
    assert runs[2][:5] == [py, "-m", "pip", "install", "--no-deps"]
    assert execs[0][1] == [py, "-m", "openfoam_tpp_tpu_torch", "--headless"]
    assert execs[0][2][bootstrap._REEXEC_GUARD] == "1"


def test_main_checks_dependencies_first(monkeypatch, tmp_path):
    monkeypatch.setattr(bootstrap, "ensure_dependencies",
                        lambda base_dir=".": False)
    assert tcli.main(["--base-dir", str(tmp_path), "--headless", "--action",
                      "config"]) == 2


def _menu(pkg_cli, base, answers, monkeypatch, **kw):
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(answers) + "\n"))
    return pkg_cli.main_menu(str(base), **kw)


def test_menu_builds_the_jax_case(tmp_path, monkeypatch, capsys):
    """The verify skill's piped answers: the same case directory and a
    byte-equal case.json from both packages' menus; the port's build line
    carries its own estimate."""
    _menu(jcli, tmp_path / "jax", TINY_ANSWERS, monkeypatch)
    _menu(tcli, tmp_path / "torch", TINY_ANSWERS, monkeypatch)
    out = capsys.readouterr().out
    assert "CUDA Sloshing Manager" in out and "one H100" in out
    names = [tcases.list_cases(str(tmp_path / k)) for k in ("jax", "torch")]
    assert names[0] == names[1] == [TINY_NAME]
    j, t = (open(tmp_path / k / TINY_NAME / "case.json", "rb").read()
            for k in ("jax", "torch"))
    assert j == t


def test_menu_postprocess_flow_writes_jax_s_csv(tmp_path, monkeypatch):
    """Menu 3 → case 1 → action 3 (flow) writes the CSV that the JAX
    package's `action_flow` writes for the same case."""
    case = tcases.setup_case(dict(H=0.04, D=0.02, mesh=0.004, R=0.002,
                                  freq=3.0, duration=0.1), str(tmp_path / "t"))
    jcase = tcases.setup_case(dict(H=0.04, D=0.02, mesh=0.004, R=0.002,
                                   freq=3.0, duration=0.1),
                              str(tmp_path / "j"))
    _menu(tcli, tmp_path / "t", ["3", "1", "3", "6"], monkeypatch)
    assert jcli.action_flow(jcase)
    rel = os.path.join("postProcessing", "potential_flow",
                       "potential_flow_wall.csv")
    got = open(os.path.join(case, rel), "rb").read()
    assert got == open(os.path.join(jcase, rel), "rb").read()
    assert len(got.splitlines()) == 1 + 11 * 64


def test_menu_without_answers_exits_at_once(tmp_path, monkeypatch, capsys):
    """EOF on stdin (a captured pytest) is the default answer: Exit."""
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    assert tcli.main(["--base-dir", str(tmp_path)]) == 0
    assert capsys.readouterr().out.count("Choice: ") == 1


def test_menu_runs_on_the_device_asked_for(tmp_path, monkeypatch):
    """Run cases → 1 runs `run` on --device, and with two cases picked
    'run as batches' goes to action_runsweep on it."""
    calls = []
    monkeypatch.setattr(tcli, "action_run",
                        lambda d, device: calls.append(("run", device)))
    monkeypatch.setattr(tcli, "action_runsweep",
                        lambda ds, device: calls.append(("sweep", device,
                                                         len(ds))))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    for freq in (2.0, 3.0):
        tcases.setup_case(dict(freq=freq), str(tmp_path))
    _menu(tcli, tmp_path, ["2", "1", "2", "all", "y", "6"], monkeypatch,
          device="meta")
    assert calls == [("run", "meta"), ("sweep", "meta", 2)]
