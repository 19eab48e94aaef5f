#!/usr/bin/env python3
"""Where the port's flagship step spends its time, on one CUDA device.

    python3 scripts/port_step_profile.py [--warm 30] [--steps 5]
                                         [--set OFTPP_SMOOTH_SWEEPS=2 ...]
                                         [--warm-default]
                                         [--sweep 128 | --sweep-box]
                                         [--spmd 4] [--variant KERNEL:NAME]

Runs the flagship case (H0.208/D0.2/R0.004/f1.88, mesh 0.00185,
round_to=8 → 112³) through openfoam_tpp_tpu_torch's `make_step` with
SolverControls(use_pallas=True) (the bench's configuration) and carry_precond,
`--warm` steps from rest, then traces `--steps` steps with
torch.profiler. `--set VAR=VALUE` (repeatable) sets an OFTPP_* variable
while the step is built, e.g. the two-sweep smoother with or without its
fused kernels (OFTPP_SMOOTH_SWEEPS=2, OFTPP_FUSED_CHEB=0);
`--warm-default` warms up with the default step instead, and builds the
`--set` step (with a fresh preconditioner bundle) only for the traced
steps, so that two configurations are traced from the same state. Prints wall ms/step, device-busy ms/step (the sum of
CUDA kernel times; memcpy/memset included), the device idle share
1 − busy/wall, kernel launches per step, and the kernels by device
time. Device busy is the time at least one kernel runs (the union of
the kernels' intervals); the kernel time summed is printed beside it
(the two differ where kernels overlap, as the x-sharded step's chained
resid launches do). The full table goes to perf_out/port_step_profile.txt.

`--sweep N` profiles the sweep step instead: N cases of the default tank
(H 0.1, D 0.02, mesh 0.002, round_to=4 → 12×12×50 each, forcing rows
R = 0.002 + 2e-5·i, f = 1.5 + 0.01·i) through `make_sweep_step` with the
case axis trailing. `--sweep-box` profiles the solo step of one such case
(`use_pallas=True`), which the sweep replaces N times over.

`--spmd S` profiles the flagship's x-sharded step, `make_step(...,
spmd=SpmdCtx(S))`: S x-slabs of the grid on the one card, each island a
halo kernel per slab.

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


def busy_union_us(events, cuda):
    """µs in which at least one of the trace's device events runs."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == cuda)
    total, start, end = 0.0, None, None
    for s, e in spans:
        if end is None or s > end:
            total += 0.0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total + (0.0 if end is None else end - start)


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
    args = ap.parse_args()
    if args.warm_default and args.sweep:
        ap.error("--warm-default profiles the single-grid step, not --sweep")

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

    dev = torch.device("cuda")
    if args.sweep or args.sweep_box:
        geom = build_tank_geometry(H=0.1, D=0.02, mesh=0.002, geo="flat",
                                   round_to=4)
    else:
        geom = build_tank_geometry(H=0.208, D=0.2, mesh=0.00185, geo="flat",
                                   round_to=8)
    if args.sweep:
        from openfoam_tpp_tpu_torch.parallel.sweep import (batch_params,
                                                           batch_states,
                                                           make_sweep_step)

        sweep_step = make_sweep_step(geom, device=dev)
        params = batch_params(
            [{"R": 0.002 + 2e-5 * i, "freq": 1.5 + 0.01 * i, "duration": 10.0}
             for i in range(args.sweep)], device=dev)
        state = batch_states(geom, args.sweep, device=dev)
        bundle = None

        def step(state, params, precond=None):
            return (*sweep_step(state, params), None)
    else:
        def build():
            return make_step(geom, PhysicalProperties(),
                             SolverControls(use_pallas=True),
                             carry_precond=True,
                             spmd=SpmdCtx(args.spmd) if args.spmd else None,
                             device=dev)

        step = build()
        params = (CaseParams.make(R=0.002, freq=1.5, duration=10.0, device=dev)
                  if args.sweep_box else
                  CaseParams.make(R=0.004, freq=1.88, duration=20.0,
                                  device=dev))
        state = init_state(geom, device=dev)
        bundle = step.init_precond(state)
    for _ in range(args.warm):
        state, d, bundle = step(state, params, precond=bundle)
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
    busy_us = busy_union_us(prof.events(), torch.autograd.DeviceType.CUDA)
    n_launch = sum(e.count for e in kernels)
    n = args.steps
    what = (f"{args.sweep}-case sweep of " if args.sweep else
            f"{args.spmd}-shard step of " if args.spmd else "")
    print(f"[profile] {what}{geom.shape}, {n} steps after {args.warm}"
          f"{' of the default step' if args.warm_default else ''}, "
          f"{' '.join(args.set) or 'defaults'}"
          f"{f'; variant {args.variant}' if args.variant else ''}; p_iters "
          f"{iters}")
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
        f"_sweep{args.sweep}" if args.sweep else
        "_sweep_box" if args.sweep_box else
        f"_spmd{args.spmd}" if args.spmd else "")
    with open(os.path.join(repo, "perf_out", f"port_step_profile{tag}.txt"),
              "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
