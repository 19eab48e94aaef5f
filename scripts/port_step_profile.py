#!/usr/bin/env python3
"""Where the port's flagship step spends its time, on one CUDA device.

    python3 scripts/port_step_profile.py [--warm 30] [--steps 5]
                                         [--set OFTPP_SMOOTH_SWEEPS=2 ...]
                                         [--warm-default]
                                         [--sweep 128 | --sweep-box]
                                         [--spmd 4] [--variant KERNEL:NAME]
                                         [--tank6dof] [--csf]
                                         [--tiled 128]

Runs the flagship case (H0.208/D0.2/R0.004/f1.88, mesh 0.00185,
round_to=8 → 112³) through openfoam_tpp_tpu_torch's `make_step` with
SolverControls(use_pallas=True) (the bench's configuration) and carry_precond,
`--warm` steps from rest, then traces `--steps` steps with
torch.profiler (the last half of the warm-up steps are timed with the
profiler off). `--set VAR=VALUE` (repeatable) sets an OFTPP_* variable
while the step is built, e.g. the two-sweep smoother with or without its
fused kernels (OFTPP_SMOOTH_SWEEPS=2, OFTPP_FUSED_CHEB=0);
`--warm-default` warms up with the default step instead, and builds the
`--set` step (with a fresh preconditioner bundle) only for the traced
steps, so that two configurations are traced from the same state. Prints wall ms/step, device-busy ms/step (the sum of
CUDA kernel times; memcpy/memset included), the device idle share
1 − busy/wall, kernel launches per step, and the kernels by device
time. Device busy is the time at least one kernel runs (the union of
the kernels' intervals); the kernel time summed is printed beside it
(the two differ where kernels overlap). The full table goes to
perf_out/port_step_profile.txt.

`--sweep N` profiles the sweep step instead: N cases of the default tank
(H 0.1, D 0.02, mesh 0.002, round_to=4 → 12×12×50 each, forcing rows
R = 0.002 + 2e-5·i, f = 1.5 + 0.01·i) through `make_sweep_step` with the
case axis trailing. `--sweep-box` profiles the solo step of one such case
(`use_pallas=True`), which the sweep replaces N times over.

`--spmd S` profiles the flagship's x-sharded step, `make_step(...,
spmd=SpmdCtx(S))`: S x-slabs of the grid on the one card; the 7-point
apply and resid islands are one launch over the slabs, every other
island a halo kernel per slab.

`--tank6dof` profiles the 6DoF step instead: the reference tutorial's
20 × 20 × 40 m tank as `build_chamfer_tank_geometry(20, 20, 40,
mesh=0.25, chamfer=0.2, z0=-20)` (80×80×160), filled to z = 0 with a
0.01 s first step, under the gen6DoF sine table resampled as
`build_case_motion` does (chip_smoke.py phase 8's configuration).

`--csf` profiles the flagship step with water's surface tension against
air (sigma 0.072 N/m: the capillary dt bound, the curvature and the CSF
source; chip_smoke.py phase 9's configuration).

`--tiled N` profiles the tiled sweep step instead: N cases of the default
tank at round_to=8 (16×16×50 each) merged along x (2048×16×50 for N =
128), the sweep rows above, `make_tiled_sweep_step(...,
SolverControls(use_pallas=True))` (chip_smoke.py phase 10's
configuration).

`--variant KERNEL:NAME` profiles the step with one of
scripts/port_kernel_variants.py's source variants of a kernel (its
`EDITS[KERNEL][NAME]`, e.g. `resid_scaled_7pt_nb:2 columns`): the
package is copied to perf_out/variant_trees/ with that edit made to
the kernel's source, and the step runs from the copy, so the variant is
measured where the step runs it.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import sys
import time


def variant_tree(repo, spec):
    """A copy of the package under perf_out/variant_trees/ whose kernel
    source carries the edits of port_kernel_variants.EDITS for `spec`
    (KERNEL:NAME); returns the copy's root."""
    from port_kernel_variants import EDITS, SOURCE

    kernel, _, name = spec.partition(":")
    root = os.path.join(repo, "perf_out", "variant_trees",
                        re.sub(r"\W+", "_", spec))
    pkg = os.path.join(root, "openfoam_tpp_tpu_torch")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(repo, "openfoam_tpp_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = os.path.join(pkg, "csrc", f"{SOURCE[kernel]}.cu")
    with open(src) as f:
        text = f.read()
    for old, new in EDITS[kernel][name]:
        if text.count(old) != 1:
            raise SystemExit(f"--variant {spec}: its edit does not match")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text)
    return root


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm", type=int, default=30)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--set", action="append", default=[], metavar="VAR=VALUE")
    ap.add_argument("--sweep", type=int, default=0, metavar="N")
    ap.add_argument("--sweep-box", action="store_true")
    ap.add_argument("--spmd", type=int, default=0, metavar="S")
    ap.add_argument("--warm-default", action="store_true")
    ap.add_argument("--variant", metavar="KERNEL:NAME")
    ap.add_argument("--tank6dof", action="store_true")
    ap.add_argument("--csf", action="store_true")
    ap.add_argument("--tiled", type=int, default=0, metavar="N")
    args = ap.parse_args()
    if args.warm_default and args.sweep:
        ap.error("--warm-default profiles the single-grid step, not --sweep")
    if args.tank6dof and (args.sweep or args.sweep_box or args.spmd):
        ap.error("--tank6dof profiles the unsharded single-tank step")
    if args.tiled and (args.sweep or args.sweep_box or args.spmd
                       or args.tank6dof or args.csf or args.warm_default):
        ap.error("--tiled profiles the tiled sweep step alone")

    def set_vars():   # read when the step is built, below
        for pair in args.set:
            var, _, value = pair.partition("=")
            os.environ[var] = value

    if not args.warm_default:
        set_vars()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_step_profile: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo if args.variant is None
                    else variant_tree(repo, args.variant))
    from openfoam_tpp_tpu_torch.config import PhysicalProperties, SolverControls
    from openfoam_tpp_tpu_torch.core.state import CaseParams, init_state
    from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
    from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
    from openfoam_tpp_tpu_torch.solver.timestep import make_step
    from openfoam_tpp_tpu_torch.utils.devtime import busy_union_us

    dev = torch.device("cuda")
    motion = None
    if args.tank6dof:
        import tempfile

        from openfoam_tpp_tpu_torch.core.motion import TableMotion
        from openfoam_tpp_tpu_torch.mesh import build_chamfer_tank_geometry
        from openfoam_tpp_tpu_torch.utils.io import (
            generate_sine_motion_table, read_6dof_table)

        geom = build_chamfer_tank_geometry(20.0, 20.0, 40.0, mesh=0.25,
                                           chamfer=0.2, z0=-20.0)
        with tempfile.TemporaryDirectory() as d:
            rows = read_6dof_table(generate_sine_motion_table(
                os.path.join(d, "6DoF.dat")))
        motion = TableMotion.from_table(*rows, resample_dt=0.05, device=dev)
    elif args.sweep or args.sweep_box or args.tiled:
        geom = build_tank_geometry(H=0.1, D=0.02, mesh=0.002, geo="flat",
                                   round_to=8 if args.tiled else 4)
    else:
        geom = build_tank_geometry(H=0.208, D=0.2, mesh=0.00185, geo="flat",
                                   round_to=8)
    sweep_rows = [{"R": 0.002 + 2e-5 * i, "freq": 1.5 + 0.01 * i,
                   "duration": 10.0} for i in range(args.sweep or args.tiled)]
    if args.tiled:
        from openfoam_tpp_tpu_torch.parallel.sweep import batch_params
        from openfoam_tpp_tpu_torch.parallel.tiled_sweep import (
            make_tiled_sweep_step, tile_state)

        tiled_step = make_tiled_sweep_step(
            geom, args.tiled, PhysicalProperties(),
            SolverControls(use_pallas=True), device=dev)
        params = batch_params(sweep_rows, device=dev)
        state = tile_state(geom, args.tiled, device=dev)
        bundle = None

        def step(state, params, precond=None):
            return (*tiled_step(state, params), None)
    elif args.sweep:
        from openfoam_tpp_tpu_torch.parallel.sweep import (batch_params,
                                                           batch_states,
                                                           make_sweep_step)

        sweep_step = make_sweep_step(geom, device=dev)
        params = batch_params(sweep_rows, device=dev)
        state = batch_states(geom, args.sweep, device=dev)
        bundle = None

        def step(state, params, precond=None):
            return (*sweep_step(state, params), None)
    else:
        def build():
            return make_step(geom, PhysicalProperties(
                                 sigma=0.072 if args.csf else 0.0),
                             SolverControls(use_pallas=True),
                             carry_precond=True,
                             spmd=SpmdCtx(args.spmd) if args.spmd else None,
                             motion=motion, device=dev)

        step = build()
        params = (CaseParams.make(R=0.002, freq=1.5, duration=10.0, device=dev)
                  if args.sweep_box else
                  CaseParams.make(R=0.0, freq=0.0, duration=40.0, device=dev)
                  if args.tank6dof else
                  CaseParams.make(R=0.004, freq=1.88, duration=20.0,
                                  device=dev))
        state = (init_state(geom, fill_height=0.0, dt0=0.01, device=dev)
                 if args.tank6dof else init_state(geom, device=dev))
        bundle = step.init_precond(state)
    # The last half of the warm-up steps, timed with the profiler off.
    n_quiet = args.warm - args.warm // 2
    for i in range(args.warm):
        if i == args.warm // 2:
            torch.cuda.synchronize()
            t_quiet = time.perf_counter()
        state, d, bundle = step(state, params, precond=bundle)
    torch.cuda.synchronize()
    quiet = (time.perf_counter() - t_quiet) / n_quiet if n_quiet else None
    if args.warm_default:
        set_vars()
        step = build()
        bundle = step.init_precond(state)
    torch.cuda.synchronize()

    iters = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, d, bundle = step(state, params, precond=bundle)
            iters.append(int(d.p_iters.max()))   # the slowest case's
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_attr = ("device_time_total" if hasattr(events[0], "device_time_total")
                else "cuda_time_total")
    kernels = [e for e in events if getattr(e, dev_attr) > 0
               and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    summed_us = sum(getattr(e, dev_attr) for e in kernels)
    busy_us = busy_union_us(prof.events())
    n_launch = sum(e.count for e in kernels)
    n = args.steps
    what = (f"{args.tiled}-case tiled sweep, " if args.tiled else
            f"{args.sweep}-case sweep of " if args.sweep else
            f"{args.spmd}-shard step of " if args.spmd else
            "6DoF step of the chamfered tank " if args.tank6dof else
            "CSF (sigma 0.072 N/m) step of " if args.csf else "")
    print(f"[profile] {what}{geom.shape}, {n} steps after {args.warm}"
          f"{' of the default step' if args.warm_default else ''}, "
          f"{' '.join(args.set) or 'defaults'}"
          f"{f'; variant {args.variant}' if args.variant else ''}; p_iters "
          f"{iters}")
    if quiet is not None:
        print(f"  wall {quiet * 1e3:.3f} ms/step over the last {n_quiet} "
              f"warm-up steps (profiler off)")
    print(f"  wall {wall / n * 1e3:.3f} ms/step (profiler on); device busy "
          f"{busy_us / n / 1e3:.3f} ms/step (kernel time summed "
          f"{summed_us / n / 1e3:.3f}); idle share "
          f"{1 - busy_us / 1e6 / wall:.4f}; device ops {n_launch / n:.1f}/step")
    kernels.sort(key=lambda e: -getattr(e, dev_attr))
    lines = [f"{getattr(e, dev_attr) / n / 1e3:9.4f} ms/step  "
             f"{e.count / n:8.1f}/step  {e.key[:110]}" for e in kernels]
    for line in lines[:20]:
        print("  " + line)
    os.makedirs(os.path.join(repo, "perf_out"), exist_ok=True)
    tag = "".join("_" + pair for pair in args.set) + (
        "_" + re.sub(r"\W+", "_", args.variant) if args.variant else "") + (
        f"_tiled{args.tiled}" if args.tiled else
        f"_sweep{args.sweep}" if args.sweep else
        "_sweep_box" if args.sweep_box else
        f"_spmd{args.spmd}" if args.spmd else
        "_tank6dof" if args.tank6dof else "") + ("_csf" if args.csf else "")
    with open(os.path.join(repo, "perf_out", f"port_step_profile{tag}.txt"),
              "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
