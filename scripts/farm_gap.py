#!/usr/bin/env python3
"""How far a sweep farmed over a device mesh drifts from the unfarmed
batch, step by step, and how far planted faults of the farm move it.

    python3 scripts/farm_gap.py [--seeds 0 1 2 3] [--positions 4]
                                [--cases 128] [--device cuda:0]
                                [--out perf_out/farm_gap.json]

The cases are chip_smoke.py's manager study (8 freq × 4 R × 2 H × 2 D,
mesh 2 mm: 128 cases on one 12×12×50 grid, 0.1 s from rest in two
0.05 s write intervals), as `runsweep` runs them: the lockstep geometry
step (parallel/sweep.py `make_geom_sweep_step`) on the whole batch, and
the same step farmed by `sharded_step` over
`make_mesh(P, case_axis=P, devices=[device] * P)`, both stepped side by
side to each write target. Seed 0 is the study as it is; seed s > 0
scales every case's R and freq by 1 + 0.1·U(-1, 1) from
`numpy.random.default_rng(s)`. After every step it prints, over the
cases, the largest |Δu|, |Δv|, |Δw| (m/s) and |Δalpha| between the farm
and the batch, each velocity's largest ratio to 1e-2 of the case's own
scale (chip_smoke.py's phase-4 limit), the case-steps whose p_iters
differ, and whether the lockstep dt is equal.

The cases are in `runsweep`'s order (sorted by case name), in which
every position holds the same 32 (R, freq) pairs in the same order.
Planted faults, on seed 0's cases: `swap` exchanges the forcing
parameters of the first case of position 0 and the second of position 1
(freq 1.5 against 1.6 Hz: chip_smoke.py's planted fault); `own_dt` gives every
position its own lockstep minimum (each part a lockstep batch of its
own, no minimum across positions). The JSON (`--out`) holds every
reading.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

STUDY = {"freq": [1.5 + 0.1 * i for i in range(8)],
         "R": [0.002, 0.003, 0.004, 0.005], "H": [0.1, 0.08],
         "D": [0.02, 0.016], "mesh": 0.002, "geo": "flat",
         "duration": 0.1, "dt": 0.001, "ramp": 1.0}
WRITE = 0.05


def study_rows(seed: int, n: int) -> list[dict]:
    from openfoam_tpp_tpu_torch.manager.cases import expand_sweep
    from openfoam_tpp_tpu_torch.utils.naming import get_case_name

    rows, _ = expand_sweep(STUDY)
    rows = sorted(rows, key=get_case_name)[:n]
    if seed:
        rng = np.random.default_rng(seed)
        for r in rows:
            r["R"] *= 1.0 + 0.1 * rng.uniform(-1.0, 1.0)
            r["freq"] *= 1.0 + 0.1 * rng.uniform(-1.0, 1.0)
    return rows


def run(rows, positions: int, dev, fault: str | None) -> list[dict]:
    import torch

    from openfoam_tpp_tpu_torch.config import (PhysicalProperties,
                                               SolverControls)
    from openfoam_tpp_tpu_torch.parallel import sharding as sh
    from openfoam_tpp_tpu_torch.parallel.sweep import (
        batch_params, batch_states_geom, build_batched_geometry,
        lockstep_step, make_geom_sweep_step)

    props, controls = PhysicalProperties(), SolverControls()
    bgeom = build_batched_geometry(rows, round_to=4, device=dev)
    params = batch_params(rows, device=dev)
    step = make_geom_sweep_step(bgeom, props, controls)
    mesh = sh.make_mesh(positions, case_axis=positions,
                        devices=[dev] * positions)
    farm = sh.sharded_step([make_geom_sweep_step(g, props, controls)
                            for g in sh.shard_batched_geometry(bgeom, mesh)],
                           mesh, batched=True)
    parts = farm.sharding.put(batch_states_geom(bgeom, dt0=STUDY["dt"]))
    pparts = sh.params_sharding(mesh, batched=True).put(params)
    if fault == "swap":
        # Copies: the parts are views of the batch's own params.
        a, b = pparts[0], pparts[1]
        fa = {f.name: getattr(a, f.name).clone()
              for f in dataclasses.fields(a)}
        fb = {f.name: getattr(b, f.name).clone()
              for f in dataclasses.fields(b)}
        for k in fa:
            fa[k][0], fb[k][1] = getattr(b, k)[1], getattr(a, k)[0]
        pparts[:2] = [type(a)(**fa), type(b)(**fb)]
    ref = batch_states_geom(bgeom, dt0=STUDY["dt"])

    def farm_step(parts, t_stop):
        if fault != "own_dt":
            return farm(parts, pparts, t_stop=t_stop)
        out = [lockstep_step([s.lockstep], [p], [q], t_stop)
               for s, p, q in zip(farm.steps, parts, pparts)]
        return [o[0][0] for o in out], [o[1][0] for o in out]

    readings, k = [], 0
    for t_target in (WRITE, 2 * WRITE):
        t_stop = torch.tensor(float(np.float32(t_target)), device=dev)
        while bool(ref.t.min() < t_stop):
            parts, diags = farm_step(parts, t_stop)
            ref, rdiag = step(ref, params, t_stop=t_stop)
            k += 1
            got = farm.sharding.gather(parts, device=dev)
            its = torch.cat([d.p_iters.to(dev) for d in diags])
            row = {"step": k, "t": float(ref.t[0]),
                   "dt_equal": bool(torch.equal(got.dt, ref.dt)),
                   "t_equal": bool(torch.equal(got.t, ref.t)),
                   "p_iters_moved": int((its != rdiag.p_iters).sum())}
            a = (got.alpha - ref.alpha).abs().flatten(0, 2).max(0).values
            row["alpha"] = float(a.max())
            for name in "uvw":
                g, r = getattr(got, name), getattr(ref, name)
                err = (g - r).abs().flatten(0, 2).max(0).values
                scale = r.abs().flatten(0, 2).max(0).values
                ratio = err / torch.clamp(1e-2 * scale, min=1e-30)
                row[name] = float(err.max())
                row[name + "_over_phase4"] = float(ratio.max())
                row[name + "_scale_min"] = float(scale.min())
            readings.append(row)
    return readings


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--positions", type=int, default=4)
    ap.add_argument("--cases", type=int, default=128)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    from openfoam_tpp_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    out = {"cases": args.cases, "positions": args.positions,
           "device": str(dev), "runs": {}}
    plan = [(f"seed {s}", s, None) for s in args.seeds]
    plan += [("fault swap", 0, "swap"), ("fault own_dt", 0, "own_dt")]
    for label, seed, fault in plan:
        readings = run(study_rows(seed, args.cases), args.positions, dev,
                       fault)
        out["runs"][label] = readings
        for r in readings:
            print(f"[{label}] step {r['step']:2d} t {r['t']:.6f} "
                  f"du {r['u']:.3e} dv {r['v']:.3e} dw {r['w']:.3e} "
                  f"dalpha {r['alpha']:.3e} over phase 4: "
                  f"u {r['u_over_phase4']:.3f} v {r['v_over_phase4']:.3f} "
                  f"w {r['w_over_phase4']:.3f}; p_iters moved "
                  f"{r['p_iters_moved']}; dt equal {r['dt_equal']}, "
                  f"t equal {r['t_equal']}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
