"""Command line of the port: the interactive manager and its headless verbs.

    python -m openfoam_tpp_tpu_torch [--base-dir D] [--device cpu]        (the menu)
    python -m openfoam_tpp_tpu_torch --headless --base-dir D --case C --action run|interface|flow|video|profile [--submit [--partition P]]
    python -m openfoam_tpp_tpu_torch --headless --base-dir D --case C --action run --devices N[xM] --device cuda:0
    python -m openfoam_tpp_tpu_torch --headless --base-dir D --action runsweep [--case A,B|all] [--percase-dt] [--devices N --device cuda:0]
    python -m openfoam_tpp_tpu_torch --headless --base-dir D --action build6dof [--params Lx=20,mesh=1] [--motion-table F | --native-table]
    python -m openfoam_tpp_tpu_torch --headless --base-dir D --action config

Port of openfoam_tpp_tpu/manager/cli.py on one card: the menu (build
cases from MATLAB-style ranges, run them or run them as batches, post-
process, build a 6DoF case, show the configuration), the verbs, and
`--submit` (a Slurm job per case on a GPU partition, manager/submit.py).
`profile` runs OFTPP_PROFILE_STEPS steps (default 20) under
torch.profiler (utils/profiling.py). The solver verbs and the menu run on
the CUDA device unless `--device cpu` is given; `flow` (potential theory)
and `video` (matplotlib frames of the checkpoints) run on the host.
`--devices N[xM]` runs a case over a device mesh of that many positions
(`run`: the grid's x, or x and y, axes; `runsweep`: each batch's case
axis, a remainder that does not divide N run apart), each position on
the device `--device` gives it: `cuda` the first N cards, an indexed
device (`cuda:0`, `cpu`) all on that one, a comma list one each
(parallel/sharding.py; a `run` over distinct cards is not ported). The
dependency check runs first (utils/bootstrap.py). PyTorch runs eagerly,
so there is no compile cache to set up.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

from openfoam_tpp_tpu_torch.config import DEFAULTS
from openfoam_tpp_tpu_torch.manager import cases as case_mgr
from openfoam_tpp_tpu_torch.utils import naming, resources


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


def action_flow(case_dir: str, device=None) -> bool:
    """Potential-flow prediction of the case (host numpy; `device` is not
    used): liquid depth d = H/2, the case's own duration."""
    from openfoam_tpp_tpu_torch.utils import potential_flow as pf

    params = case_mgr.load_case_params(case_dir)
    print(f"  📐 Generating potential flow prediction for "
          f"{os.path.basename(case_dir)}...")
    out_dir = os.path.join(case_dir, "postProcessing", "potential_flow")
    os.makedirs(out_dir, exist_ok=True)
    out, summary = pf.generate_wall_elevation_csv(
        out_dir,
        R=params["D"] / 2.0,
        a=params["R"],
        freq=params["freq"],
        d=params["H"] / 2.0,
        duration=params["duration"],
    )
    pf.print_summary(summary)
    print(f"  ✅ Potential flow data saved: {out}")
    return True


def action_video(case_dir: str, device=None) -> bool:
    """Free-surface video of the case's checkpoints (host matplotlib;
    `device` is not used)."""
    from openfoam_tpp_tpu_torch.post.video import generate_video

    return generate_video(case_dir)


def action_run(case_dir: str, device="cuda", devices=None) -> bool:
    from openfoam_tpp_tpu_torch.manager.runner import run_case

    print(f"  🚀 Running {os.path.basename(case_dir)} ..."
          + (f" ({devices}-device sharded)" if devices not in (None, 1, "1")
             else ""))
    run_case(case_dir, devices=devices, device=device)
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
                    device="cuda", devices=None) -> bool:
    """Run many cases as batches (manager/sweeprun.py). `lockstep=False`
    (--percase-dt) gives every case its own adaptive dt (solo-run
    parity). A group of one case runs through `run`.

    `devices=N` farms each batch over an N-position case-axis mesh on the
    devices `device` gives (device.py); a group remainder that does not
    divide N runs unfarmed on the first of them."""
    from openfoam_tpp_tpu_torch.device import device_positions
    from openfoam_tpp_tpu_torch.manager.sweeprun import (group_cases,
                                                         run_cases_batched)
    from openfoam_tpp_tpu_torch.parallel.sharding import parse_devices

    d_x, d_y = parse_devices(devices)
    n_dev = d_x * d_y
    first = device_positions(device, n_dev)[0] if n_dev > 1 else device

    for group in group_cases(case_dirs):
        chunks = [(group, 1)]
        if n_dev > 1 and len(group) > 1:
            head = len(group) - (len(group) % n_dev)
            chunks = ([(group[:head], n_dev)] if head else []) \
                + ([(group[head:], 1)] if head < len(group) else [])
        for part, nd in chunks:
            if len(part) == 1:
                action_run(part[0], device=first)
            else:
                print(f"  🚀 Batched run: {len(part)} cases in one batch"
                      + (f" over {nd} devices" if nd > 1 else "")
                      + ("" if lockstep else " (per-case dt)"))
                run_cases_batched(part, lockstep=lockstep, devices=nd,
                                  device=device if nd > 1 else first)
    return True


ACTIONS = {"interface": action_interface, "flow": action_flow,
           "video": action_video, "run": action_run,
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


# ------------------------------------------------------------------- menus

def _prompt(msg: str, default: str = "") -> str:
    try:
        raw = input(msg).strip()
    except EOFError:
        return default
    return raw or default


def menu_build_cases(base_dir: str = "."):
    """Per-parameter entry with MATLAB ranges; zip/Cartesian sweep
    semantics (the reference's main.py:431-566)."""
    print("\n--- Build Cases ---")
    print("Enter values (or MATLAB ranges start:step:end, comma lists).")
    sweep = {}
    for key, dv in DEFAULTS.items():
        if key == "n_cpus":
            continue
        raw = _prompt(f"  {key} [{dv}]: ", str(dv))
        if key == "geo":
            vals = [v.strip() for v in raw.split(",")]
            for v in vals:
                if v not in ("flat", "cap"):
                    print(f"  ⚠ invalid geo {v!r}, using 'flat'")
            vals = [v if v in ("flat", "cap") else "flat" for v in vals]
            sweep[key] = vals
        else:
            try:
                sweep[key] = naming.parse_range(raw)
            except ValueError as e:
                print(f"  ⚠ {e}; using default")
                sweep[key] = [dv]

    def confirm(n):
        return _prompt(
            f"  Cartesian product gives {n} cases. Proceed? [y/N]: ", "n"
        ).lower().startswith("y")

    rows, mode = case_mgr.expand_sweep(sweep, confirm_cartesian=confirm)
    if not rows:
        print("  Cancelled.")
        return
    print(f"  {len(rows)} case(s) ({mode} mode):")
    for row in rows:
        est = resources.estimate_resources({**DEFAULTS, **row})
        d = case_mgr.setup_case(row, base_dir)
        print(f"   ✅ {os.path.basename(d)}  — {est.summary()}")


def menu_run_cases(base_dir: str = ".", device="cuda"):
    all_cases = case_mgr.list_cases(base_dir)
    if not all_cases:
        print("  No cases found. Build some first.")
        return
    print("\n--- Run Cases ---")
    for i, c in enumerate(all_cases):
        params = case_mgr.load_case_params(os.path.join(base_dir, c))
        done = case_mgr.is_case_done(os.path.join(base_dir, c))
        prog = case_mgr.case_progress(os.path.join(base_dir, c))
        status = "✅ done" if done else (
            f"▶ t={prog:g}/{params['duration']:g}s" if prog > 0 else "· new"
        )
        print(f"  {i + 1}. {c}  [{status}]")
    sel = _prompt("Select cases (e.g. 1,3-5 or all): ", "")
    if not sel:
        return
    # Cluster submission ("Are you on Oscar?" in the reference's user
    # guide): offered when a Slurm scheduler is present.
    submit = False
    if shutil.which("sbatch"):
        submit = _prompt(
            "Submit to Slurm instead of running locally? [y/N]: ", "n"
        ).lower().startswith("y")
    picked = [os.path.join(base_dir, all_cases[idx])
              for idx in naming.parse_indices(sel, len(all_cases))]
    if submit:
        from openfoam_tpp_tpu_torch.manager.submit import submit_case

        for case_dir in picked:
            submit_case(case_dir, "run")
        return
    batched = len(picked) > 1 and _prompt(
        f"Run the {len(picked)} cases as batches "
        "(one batch per compatible group)? [y/N]: ", "n"
    ).lower().startswith("y")
    if batched:
        action_runsweep(picked, device=device)
    else:
        for case_dir in picked:
            action_run(case_dir, device=device)


def menu_postprocess(base_dir: str = ".", device="cuda"):
    all_cases = case_mgr.list_cases(base_dir)
    if not all_cases:
        print("  No cases found.")
        return
    print("\n--- Postprocess ---")
    for i, c in enumerate(all_cases):
        print(f"  {i + 1}. {c}")
    sel = _prompt("Select cases (e.g. 1,3-5 or all): ", "")
    if not sel:
        return
    print("  Actions: 1) video  2) interface  3) flow (potential theory)")
    act = _prompt("Action [2]: ", "2")
    action = {"1": "video", "2": "interface", "3": "flow"}.get(act, "interface")
    for idx in naming.parse_indices(sel, len(all_cases)):
        ACTIONS[action](os.path.join(base_dir, all_cases[idx]), device=device)


def menu_build_6dof(base_dir: str = "."):
    """Interactive build for the closed-tank 6DoF family (the reference's
    sloshingTank3D6DoF)."""
    print("\n--- Build 6DoF closed-tank case ---")
    overrides = {}
    for key in ("Lx", "Ly", "Lz", "mesh", "chamfer", "duration", "dt"):
        dv = case_mgr.DEFAULTS_6DOF[key]
        raw = _prompt(f"  {key} [{dv}]: ", str(dv))
        try:
            overrides[key] = float(raw)
        except ValueError:
            print(f"  ⚠ invalid {key}; using default")
            overrides[key] = dv
    table = _prompt(
        "  Motion table path [blank = gen6DoF sine table]: ", ""
    ) or None
    use_native = False
    if table is None and _default_6dof_table():
        use_native = _prompt(
            "  Generate table with native gen6dof? [Y/n]: ", "y"
        ).lower().startswith("y")
    build_6dof_case(overrides, base_dir, motion_table=table,
                    use_native=use_native)


def main_menu(base_dir: str = ".", device="cuda"):
    while True:
        print("\n========== CUDA Sloshing Manager ==========")
        print(" 1. Build cases (parameter sweeps)")
        print(" 2. Run cases (CUDA solver, resume-aware)")
        print(" 3. Postprocess (interface / flow / video)")
        print(" 4. Build 6DoF closed-tank case")
        print(" 5. Show configuration")
        print(" 6. Exit")
        choice = _prompt("Choice: ", "6")
        if choice == "1":
            menu_build_cases(base_dir)
        elif choice == "2":
            menu_run_cases(base_dir, device=device)
        elif choice == "3":
            menu_postprocess(base_dir, device=device)
        elif choice == "4":
            menu_build_6dof(base_dir)
        elif choice == "5":
            display_config(base_dir)
        else:
            return


# --------------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Sloshing simulation manager (PyTorch/CUDA port)")
    ap.add_argument("--headless", action="store_true",
                    help="non-interactive mode (reference parity)")
    ap.add_argument("--case", help="case directory name")
    ap.add_argument("--action",
                    choices=sorted(ACTIONS) + ["build6dof", "config",
                                               "runsweep"],
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
                         "the plain PyTorch path); with --devices N also "
                         "an indexed device (cuda:0) for all N positions, "
                         "or a comma list of N devices")
    ap.add_argument("--submit", action="store_true",
                    help="submit the action as a Slurm job on one GPU "
                         "instead of running it in-process")
    ap.add_argument("--partition", default="gpu", help="Slurm partition")
    ap.add_argument("--percase-dt", action="store_true",
                    help="runsweep: per-case adaptive dt with holds at "
                         "write targets (solo-run parity) instead of the "
                         "lockstep batch-min dt")
    ap.add_argument("--devices", type=str, default=None,
                    help="run over a mesh of N device positions: with "
                         "run, the grid's x axis (or 'NxM' for x and y) on "
                         "positions that share one device; with runsweep, "
                         "each batch's case axis farmed over the N "
                         "positions (see --device); a farm whose positions "
                         "share one card launches every kernel once per "
                         "position and is slower than the plain batch")
    args = ap.parse_args(argv)

    # Dependency self-check (the reference's venv bootstrap, main.py:9-95):
    # OFTPP_BOOTSTRAP=1 enables venv self-provisioning and re-exec.
    from openfoam_tpp_tpu_torch.utils.bootstrap import ensure_dependencies

    if not ensure_dependencies(base_dir=args.base_dir):
        return 2

    if not args.headless:
        main_menu(args.base_dir, device=args.device)
        return 0
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
                                    device=args.device,
                                    devices=args.devices) else 1
    if not (args.case and args.action):
        ap.error("--headless requires --case and --action")
    case_dir = os.path.join(args.base_dir, args.case)
    if not os.path.isdir(case_dir):
        print(f"❌ case not found: {case_dir}")
        return 1
    if args.submit:
        from openfoam_tpp_tpu_torch.manager.submit import submit_case

        return 0 if submit_case(case_dir, args.action,
                                partition=args.partition) else 1
    print(f"Post-processing: {args.action} on {args.case}"
          if args.action != "run" else f"Running: {args.case}")
    if args.action == "run" and args.devices:
        ok = action_run(case_dir, device=args.device, devices=args.devices)
    else:
        ok = ACTIONS[args.action](case_dir, device=args.device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
