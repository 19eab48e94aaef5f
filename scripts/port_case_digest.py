#!/usr/bin/env python3
"""Digest of the flagship case run through the port's `run_case` on one
CUDA device.

    python3 scripts/port_case_digest.py [--duration 0.1]
    python3 scripts/port_case_digest.py --spmd S [--warm 60] [--steps 12]

Builds the flagship case (H0.208/D0.2/R0.004/f1.88, mesh 0.00185 → 112³,
ramp 2 s) in a temporary directory with `setup_case`, runs it with
`run_case` on the card, and prints one JSON line: the steps, the final
time and the sha256 of every field of every checkpoint. The package is
imported from the current directory, so the same script digests another
checkout of the port (run it from that checkout's root): two trees whose
digests match ran the case to the same bits.

With `--spmd S` it digests the x-sharded step instead, as chip_smoke.py
phases 3 and 3b drive it: the flagship's default step
(`make_step(..., SolverControls(use_pallas=True), carry_precond=True)`)
for `--warm` steps from rest, then `--steps` steps of the same step
built with `spmd=SpmdCtx(S)`; it prints the sha256 of every field after
them and every sharded step's p_iters.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=0.1)
    ap.add_argument("--spmd", type=int, default=0, metavar="S")
    ap.add_argument("--warm", type=int, default=60)
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("port_case_digest: no CUDA device", file=sys.stderr)
        return 2
    if args.spmd:
        return sharded_digest(torch, args)
    from openfoam_tpp_tpu_torch.manager.cases import setup_case
    from openfoam_tpp_tpu_torch.manager.runner import run_case
    from openfoam_tpp_tpu_torch.utils.io import (list_checkpoints,
                                                 load_checkpoint)

    params = dict(H=0.208, D=0.2, geo="flat", R=0.004, freq=1.88,
                  mesh=0.00185, duration=args.duration, dt=0.001, ramp=2.0)
    with tempfile.TemporaryDirectory(prefix="port_case_digest_") as base:
        case = setup_case(params, base)
        stats = run_case(case, log=lambda line: None)
        digests = {}
        for t, path in list_checkpoints(case):
            chk = load_checkpoint(path)
            digests[f"{t:.6f}"] = {
                k: hashlib.sha256(chk[k].tobytes()).hexdigest()[:16]
                for k in ("alpha", "u", "v", "w", "p", "t", "dt", "step")}
    print(json.dumps({"package": os.path.dirname(sys.modules[
        "openfoam_tpp_tpu_torch"].__file__), "steps": stats["steps"],
        "sim_seconds": stats["sim_seconds"], "checkpoints": digests}))
    return 0


def sharded_digest(torch, args) -> int:
    from openfoam_tpp_tpu_torch.config import (PhysicalProperties,
                                               SolverControls)
    from openfoam_tpp_tpu_torch.core.state import CaseParams, init_state
    from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
    from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
    from openfoam_tpp_tpu_torch.solver.timestep import make_step

    dev = torch.device("cuda")
    geom = build_tank_geometry(H=0.208, D=0.2, mesh=0.00185, geo="flat",
                               round_to=8)
    params = CaseParams.make(R=0.004, freq=1.88, duration=20.0, device=dev)

    def build(spmd=None):
        return make_step(geom, PhysicalProperties(),
                         SolverControls(use_pallas=True), carry_precond=True,
                         spmd=spmd, device=dev)

    step = build()
    state = init_state(geom, device=dev)
    bundle = step.init_precond(state)
    for _ in range(args.warm):
        state, _, bundle = step(state, params, precond=bundle)
    step = build(SpmdCtx(args.spmd))
    bundle = step.init_precond(state)
    iters = []
    for _ in range(args.steps):
        state, d, bundle = step(state, params, precond=bundle)
        iters.append(int(d.p_iters))
    fields = {k: hashlib.sha256(getattr(state, k).cpu().numpy().tobytes())
              .hexdigest()[:16]
              for k in ("alpha", "u", "v", "w", "p", "t", "dt", "step")}
    print(json.dumps({"package": os.path.dirname(sys.modules[
        "openfoam_tpp_tpu_torch"].__file__), "spmd": args.spmd,
        "warm": args.warm, "steps": args.steps, "p_iters": iters,
        "fields": fields}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
