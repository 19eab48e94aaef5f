"""Headless command line of the port.

    python -m openfoam_tpp_tpu_torch --headless --base-dir D --case C --action run
    python -m openfoam_tpp_tpu_torch --headless --base-dir D --case C --action interface
    python -m openfoam_tpp_tpu_torch --headless --base-dir D --case C --action profile
    python -m openfoam_tpp_tpu_torch --headless --base-dir D --action runsweep [--case A,B|all] [--percase-dt]
    python -m openfoam_tpp_tpu_torch --headless --base-dir D --action build6dof [--params Lx=20,mesh=1] [--motion-table F | --native-table]
    python -m openfoam_tpp_tpu_torch --headless --base-dir D --action config

Port of the headless `run`, `interface`, `profile`, `runsweep`,
`build6dof` and `config` verbs of openfoam_tpp_tpu/manager/cli.py
(`profile`: OFTPP_PROFILE_STEPS steps, default 20, under torch.profiler;
utils/profiling.py). The solver verbs run
on the CUDA device unless `--device cpu` is given. The interactive menu
and the other verbs and flags of that command line are not ported yet:
asking for one exits non-zero. PyTorch runs eagerly, so there is no dependency bootstrap and
no compile cache to set up.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

from openfoam_tpp_tpu_torch.config import DEFAULTS
from openfoam_tpp_tpu_torch.manager import cases as case_mgr

NOT_PORTED = ("flow", "video")


def action_interface(case_dir: str, device="cuda") -> bool:
    from openfoam_tpp_tpu_torch.manager.runner import (_case_shape_hint,
                                                       build_case_geometry,
                                                       iterate_snapshots)
    from openfoam_tpp_tpu_torch.post.interface import extract_interface

    params = case_mgr.load_case_params(case_dir)
    geom = build_case_geometry(params, _case_shape_hint(case_dir))
    print(f"  📊 Extracting interface for {case_dir} (on-device column pass)...")
    out = extract_interface(case_dir, geom, iterate_snapshots(case_dir),
                            device=device)
    print(f"  ✅ Extraction complete: {out}")
    return True


def action_run(case_dir: str, device="cuda") -> bool:
    from openfoam_tpp_tpu_torch.manager.runner import run_case

    print(f"  🚀 Running {os.path.basename(case_dir)} ...")
    run_case(case_dir, device=device)
    return True


def action_profile(case_dir: str, device="cuda") -> bool:
    """torch.profiler trace + per-step timing of a case
    (utils/profiling.py)."""
    from openfoam_tpp_tpu_torch.utils.profiling import profile_case

    print(f"  ⏱  Profiling {os.path.basename(case_dir)} ...")
    n = int(os.environ.get("OFTPP_PROFILE_STEPS", "20"))
    profile_case(case_dir, n_steps=n, device=device)
    return True


def action_runsweep(case_dirs: list[str], lockstep: bool = True,
                    device="cuda") -> bool:
    """Run many cases as batches on one card (manager/sweeprun.py).
    `lockstep=False` (--percase-dt) gives every case its own adaptive dt
    (solo-run parity). A group of one case runs through `run`."""
    from openfoam_tpp_tpu_torch.manager.sweeprun import (group_cases,
                                                         run_cases_batched)

    for group in group_cases(case_dirs):
        if len(group) == 1:
            action_run(group[0], device=device)
        else:
            print(f"  🚀 Batched run: {len(group)} cases in one batch"
                  + ("" if lockstep else " (per-case dt)"))
            run_cases_batched(group, lockstep=lockstep, device=device)
    return True


ACTIONS = {"interface": action_interface, "run": action_run,
           "profile": action_profile}


def _default_6dof_table() -> str | None:
    """Path of the native gen6dof binary (`make -C native`), if built."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    exe = os.path.join(here, "native", "gen6dof")
    return exe if os.path.isfile(exe) and os.access(exe, os.X_OK) else None


def build_6dof_case(overrides: dict | None = None, base_dir: str = ".",
                    motion_table: str | None = None,
                    use_native: bool = False) -> str:
    """Build a closed-tank 6DoF case; with `use_native` the motion table
    comes from native/gen6dof when it is built, else from the Python sine
    table."""
    tmp = None
    if use_native and motion_table is None:
        exe = _default_6dof_table()
        if exe:
            fd, tmp = tempfile.mkstemp(suffix=".dat")
            os.close(fd)
            subprocess.run([exe, "sine", tmp], check=True)
            motion_table = tmp
            print(f"  🧱 motion table from native gen6dof: {exe}")
        else:
            print("  ⚠ native/gen6dof not built (make -C native); "
                  "using the Python sine table")
    try:
        case_dir = case_mgr.setup_case_6dof(overrides, base_dir,
                                            motion_table=motion_table)
    finally:
        if tmp is not None:
            os.remove(tmp)
    print(f"   ✅ {os.path.basename(case_dir)} (6DoF closed tank)")
    return case_dir


def display_config(base_dir: str = "."):
    """Configuration overview: the parameter schema with its defaults, and
    every existing case with its run status."""
    print("\n--- Current configuration ---")
    print("  Orbital cylinder defaults (DEFAULTS):")
    for k, v in DEFAULTS.items():
        print(f"    {k:10s} = {v}")
    print("  6DoF closed-tank defaults:")
    for k, v in case_mgr.DEFAULTS_6DOF.items():
        if k != "model":
            print(f"    {k:10s} = {v}")
    all_cases = case_mgr.list_cases(base_dir)
    if not all_cases:
        print("  (no cases built yet)")
        return
    print(f"  {len(all_cases)} case(s) in {os.path.abspath(base_dir)}:")
    for c in all_cases:
        case_dir = os.path.join(base_dir, c)
        params = case_mgr.load_case_params(case_dir)
        done = case_mgr.is_case_done(case_dir)
        prog = case_mgr.case_progress(case_dir)
        status = ("done" if done
                  else f"t={prog:g}/{params['duration']:g}s" if prog > 0
                  else "new")
        print(f"    {c}  [{status}]")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Sloshing simulation manager (PyTorch/CUDA port)")
    ap.add_argument("--headless", action="store_true",
                    help="non-interactive mode (the only one ported)")
    ap.add_argument("--case", help="case directory name")
    ap.add_argument("--action",
                    choices=sorted(ACTIONS) + ["build6dof", "config",
                                               "runsweep"] + list(NOT_PORTED),
                    help="headless action")
    ap.add_argument("--base-dir", default=".", help="cases root directory")
    ap.add_argument("--params", default="",
                    help="comma-separated key=value overrides for "
                         "--action build6dof (e.g. Lx=20,mesh=1)")
    ap.add_argument("--motion-table", default=None,
                    help="existing 6DoF.dat to copy into a build6dof case")
    ap.add_argument("--native-table", action="store_true",
                    help="generate the build6dof motion table with the "
                         "native gen6dof binary")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
                         "the plain PyTorch path)")
    ap.add_argument("--percase-dt", action="store_true",
                    help="runsweep: per-case adaptive dt with holds at "
                         "write targets (solo-run parity) instead of the "
                         "lockstep batch-min dt")
    ap.add_argument("--submit", action="store_true",
                    help="Slurm submission (not ported yet)")
    ap.add_argument("--devices", type=str, default=None,
                    help="sharded runs over several cards and sweep "
                         "farming (not ported yet: they come with the "
                         "torch.distributed slice)")
    args = ap.parse_args(argv)

    unported = [what for what, asked in (
        ("the interactive menu (use --headless)", not args.headless),
        (f"--action {args.action}", args.action in NOT_PORTED),
        ("--submit", args.submit),
        ("--devices (runs over several cards come with the "
         "torch.distributed slice; the x-sharded step is "
         "make_step(spmd=SpmdCtx(n)), its shards on one card)",
         args.devices not in (None, "1")),
    ) if asked]
    if unported:
        print(f"❌ not ported yet: {', '.join(unported)}", file=sys.stderr)
        return 2
    if args.action == "config":
        display_config(args.base_dir)
        return 0
    if args.action == "build6dof":
        overrides = {}
        for kv in filter(None, args.params.split(",")):
            k, _, v = kv.partition("=")
            overrides[k.strip()] = float(v)
        build_6dof_case(overrides, args.base_dir,
                        motion_table=args.motion_table,
                        use_native=args.native_table)
        return 0
    if args.action == "runsweep":
        # --case: comma-separated case names, or "all"/omitted for every
        # unfinished case under --base-dir.
        if args.case and args.case != "all":
            names = [c.strip() for c in args.case.split(",")]
        else:
            names = [c for c in case_mgr.list_cases(args.base_dir)
                     if not case_mgr.is_case_done(
                         os.path.join(args.base_dir, c))]
        dirs = [os.path.join(args.base_dir, c) for c in names]
        missing = [d for d in dirs if not os.path.isdir(d)]
        if missing:
            print(f"❌ case(s) not found: {missing}")
            return 1
        if not dirs:
            print("Nothing to run.")
            return 0
        return 0 if action_runsweep(dirs, lockstep=not args.percase_dt,
                                    device=args.device) else 1
    if not (args.case and args.action):
        ap.error("--headless requires --case and --action")
    case_dir = os.path.join(args.base_dir, args.case)
    if not os.path.isdir(case_dir):
        print(f"❌ case not found: {case_dir}")
        return 1
    print(f"Post-processing: {args.action} on {args.case}"
          if args.action != "run" else f"Running: {args.case}")
    return 0 if ACTIONS[args.action](case_dir, device=args.device) else 1


if __name__ == "__main__":
    sys.exit(main())
