#!/usr/bin/env python3
"""Where the port's flagship step spends its time, on one CUDA device.

    python3 scripts/port_step_profile.py [--warm 30] [--steps 5]

Runs the flagship case (H0.208/D0.2/R0.004/f1.88, mesh 0.00185,
round_to=8 → 112³) through openfoam_tpp_tpu_torch's `make_step` with
SolverControls(use_pallas=True) (the bench's configuration) and carry_precond,
`--warm` steps from rest, then traces `--steps` steps with
torch.profiler. Prints wall ms/step, device-busy ms/step (the sum of
CUDA kernel times; memcpy/memset included), the device idle share
1 − busy/wall, kernel launches per step, and the kernels by device
time. The full table goes to perf_out/port_step_profile.txt.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm", type=int, default=30)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_step_profile: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from openfoam_tpp_tpu_torch.config import PhysicalProperties, SolverControls
    from openfoam_tpp_tpu_torch.core.state import CaseParams, init_state
    from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
    from openfoam_tpp_tpu_torch.solver.timestep import make_step

    dev = torch.device("cuda")
    geom = build_tank_geometry(H=0.208, D=0.2, mesh=0.00185, geo="flat",
                               round_to=8)
    step = make_step(geom, PhysicalProperties(),
                     SolverControls(use_pallas=True),
                     carry_precond=True, device=dev)
    params = CaseParams.make(R=0.004, freq=1.88, duration=20.0, device=dev)
    state = init_state(geom, device=dev)
    bundle = step.init_precond(state)
    for _ in range(args.warm):
        state, d, bundle = step(state, params, precond=bundle)
    torch.cuda.synchronize()

    iters = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, d, bundle = step(state, params, precond=bundle)
            iters.append(int(d.p_iters))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_attr = ("device_time_total" if hasattr(events[0], "device_time_total")
                else "cuda_time_total")
    kernels = [e for e in events if getattr(e, dev_attr) > 0
               and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_us = sum(getattr(e, dev_attr) for e in kernels)
    n_launch = sum(e.count for e in kernels)
    n = args.steps
    print(f"[profile] {geom.shape}, {n} steps after {args.warm}; p_iters {iters}")
    print(f"  wall {wall / n * 1e3:.3f} ms/step (profiler on); device busy "
          f"{busy_us / n / 1e3:.3f} ms/step; idle share "
          f"{1 - busy_us / 1e6 / wall:.4f}; device ops {n_launch / n:.1f}/step")
    kernels.sort(key=lambda e: -getattr(e, dev_attr))
    lines = [f"{getattr(e, dev_attr) / n / 1e3:9.4f} ms/step  "
             f"{e.count / n:8.1f}/step  {e.key[:110]}" for e in kernels]
    for line in lines[:20]:
        print("  " + line)
    os.makedirs(os.path.join(repo, "perf_out"), exist_ok=True)
    with open(os.path.join(repo, "perf_out", "port_step_profile.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
