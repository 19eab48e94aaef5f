"""Headless command line of the port.

    python -m openfoam_tpp_tpu_torch --headless --base-dir D --case C --action run
    python -m openfoam_tpp_tpu_torch --headless --base-dir D --case C --action interface
    python -m openfoam_tpp_tpu_torch --headless --base-dir D --action runsweep [--case A,B|all] [--percase-dt]

Port of the headless `run`, `interface` and `runsweep` verbs of
openfoam_tpp_tpu/manager/cli.py. All run on the CUDA device unless
`--device cpu` is given. The interactive menu and the other verbs and
flags of that command line are not ported yet: asking for one exits
non-zero. PyTorch runs eagerly, so there is no dependency bootstrap and
no compile cache to set up.
"""

from __future__ import annotations

import argparse
import os
import sys

from openfoam_tpp_tpu_torch.manager import cases as case_mgr

NOT_PORTED = ("build6dof", "config", "flow", "profile", "video")


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


ACTIONS = {"interface": action_interface, "run": action_run}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Sloshing simulation manager (PyTorch/CUDA port)")
    ap.add_argument("--headless", action="store_true",
                    help="non-interactive mode (the only one ported)")
    ap.add_argument("--case", help="case directory name")
    ap.add_argument("--action",
                    choices=sorted(ACTIONS) + ["runsweep"] + list(NOT_PORTED),
                    help="headless action")
    ap.add_argument("--base-dir", default=".", help="cases root directory")
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
