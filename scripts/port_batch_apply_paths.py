#!/usr/bin/env python3
"""The batch apply's launches by shape on the sweep paths, and a digest of
each path's result, on one CUDA device.

    python3 scripts/port_batch_apply_paths.py [--paths sweep,farm,ranks,geometry]
                                              [--out FILE]

Drives four paths as chip_smoke.py drives them: `sweep`, phase 6's
128-case `make_sweep_step` batch (N_SWEEP steps from rest); `farm`, phase
12's lockstep geometry step on the same rows farmed over FARM_POSITIONS
case positions of the card (N_FARM steps); `ranks`, phase 12g (i)'s farm
over a (case, x, y) = FARM_GRID grid of gloo ranks sharing the card
(N_FARM steps, no landing on the write grid); `geometry`, phase 12h
(iii)'s geometry sweep over GEOM_RANK_GRID ranks (N_GEOM_RANKS steps). In
each it wraps `seven_point.apply_7pt_nb` (row 10a's entry point; its
`.launches` stays as it is) and counts the calls of the stepping, which
starts when the path sets the launch counts to 0, per step by (shape,
dtype, unit or stored diagonal): on the ranks, rank 0's and the sum over
the ranks. It prints, and writes to `--out` as JSON, those counts and
the sha256 of each path's final fields (on the ranks, rank 0's gathered
batch) and of every step's p_iters (every rank's).

The package and chip_smoke.py are imported from the current directory:
run from another checkout's root (with this file's path), it counts and
digests that tree, so two trees whose digests match ran each path to
the same bits.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import sys

PATHS = ("sweep", "farm", "ranks", "geometry")


def count_apply():
    """Wrap `seven_point.apply_7pt_nb`: returns (the list of every call's
    (shape, dtype, diagonal), the wrapper). The wrapper's `.launches`
    counts as the entry point's does, so a path that sets the counts to
    0 before its steps leaves the steps' calls as the list's last
    `.launches` entries."""
    from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp

    orig = sp.apply_7pt_nb
    calls = []

    def counted(p, split, diag=None, **kw):
        n0 = orig.launches
        out = orig(p, split, diag, **kw)
        counted.launches += orig.launches - n0
        calls.append(("x".join(map(str, p.shape)),
                      str(p.dtype).rsplit(".", 1)[1],
                      "unit" if diag is None else "diag"))
        return out

    counted.launches = 0
    sp.apply_7pt_nb = counted
    return calls, counted


def per_step(calls, counted, n_steps):
    """The stepping's calls per step, keyed 'shape dtype diagonal'."""
    stepped = calls[len(calls) - counted.launches:] if counted.launches else []
    c = collections.Counter(" ".join(k) for k in stepped)
    return {k: v / n_steps for k, v in sorted(c.items())}


def sha(obj) -> str:
    import numpy as np

    h = hashlib.sha256()
    if isinstance(obj, dict):
        for k in sorted(obj):
            h.update(k.encode())
            h.update(np.ascontiguousarray(obj[k]).tobytes())
    else:
        h.update(json.dumps(obj).encode())
    return h.hexdigest()[:16]


def counted_job(ctx, log, job, n_steps, *args):
    """A rank's `job(ctx, log, n_steps, *args)` with row 10a's calls
    counted; returns its p_iters, the counts and (rank 0) the digest of
    the gathered batch."""
    calls, counted = count_apply()
    res = job(ctx, log, n_steps, *args)
    out = {"p_iters": res["p_iters"], "block": res["block"],
           "apply_per_step": per_step(calls, counted, n_steps)}
    if "whole" in res:
        out["fields"] = sha(res["whole"])
    return out


def run_sweep(cs, dev):
    import torch

    from openfoam_tpp_tpu_torch.config import (PhysicalProperties,
                                               SolverControls)
    from openfoam_tpp_tpu_torch.core.state import state_to_numpy
    from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
    from openfoam_tpp_tpu_torch.parallel.sweep import (batch_params,
                                                       batch_states,
                                                       make_sweep_step)

    calls, counted = count_apply()
    geom = build_tank_geometry(**cs.SWEEP_TANK, round_to=4)
    step = make_sweep_step(geom, PhysicalProperties(), SolverControls(),
                           device=dev)
    states = batch_states(geom, cs.SWEEP_CASES, device=dev)
    params = batch_params(cs.sweep_rows(), device=dev)
    counted.launches = 0
    iters = []
    for _ in range(cs.N_SWEEP):
        states, d = step(states, params)
        iters.append(d.p_iters.cpu().tolist())
    torch.cuda.synchronize()
    return {"steps": cs.N_SWEEP,
            "apply_per_step": per_step(calls, counted, cs.N_SWEEP),
            "fields": sha(state_to_numpy(states)), "p_iters": sha(iters)}


def run_farm(cs, dev):
    import torch

    from openfoam_tpp_tpu_torch.config import (PhysicalProperties,
                                               SolverControls)
    from openfoam_tpp_tpu_torch.core.state import state_to_numpy
    from openfoam_tpp_tpu_torch.parallel import sharding as sh
    from openfoam_tpp_tpu_torch.parallel.sweep import (batch_params,
                                                       batch_states_geom,
                                                       build_batched_geometry,
                                                       make_geom_sweep_step)

    calls, counted = count_apply()
    rows = [{**cs.SWEEP_TANK, **r} for r in cs.sweep_rows()]
    bgeom = build_batched_geometry(rows, round_to=4, device=dev)
    params = batch_params(rows, device=dev)
    n = cs.FARM_POSITIONS
    mesh = sh.make_mesh(n, case_axis=n, devices=[dev] * n)
    farm = sh.sharded_step(
        [make_geom_sweep_step(g, PhysicalProperties(), SolverControls())
         for g in sh.shard_batched_geometry(bgeom, mesh)], mesh, batched=True)
    parts = farm.sharding.put(batch_states_geom(bgeom))
    pparts = sh.params_sharding(mesh, batched=True).put(params)
    counted.launches = 0
    iters = []
    for _ in range(cs.N_FARM):
        parts, d = farm(parts, pparts)
        iters.append([x.p_iters.cpu().tolist() for x in d])
    torch.cuda.synchronize()
    whole = farm.sharding.gather(parts, device=dev)
    return {"steps": cs.N_FARM,
            "apply_per_step": per_step(calls, counted, cs.N_FARM),
            "fields": sha(state_to_numpy(whole)), "p_iters": sha(iters)}


def run_ranks(cs, dev, job, grid, n_steps, n_timed):
    from openfoam_tpp_tpu_torch.config import SolverControls
    from openfoam_tpp_tpu_torch.parallel import ranks as rk

    card = f"cuda:{dev.index or 0}"
    n = grid[0] * grid[1] * grid[2]
    res = rk.launch(counted_job, [card] * n, grid=grid,
                    args=(job, n_steps, n_timed,
                          SolverControls(write_interval=0.0)),
                    log=lambda line: None)
    total = collections.Counter()
    for r in res:
        total.update(r["apply_per_step"])
    return {"steps": n_steps, "grid": list(grid),
            "blocks": [r["block"] for r in res],
            "apply_per_step": res[0]["apply_per_step"],
            "apply_per_step_all_ranks": dict(sorted(total.items())),
            "fields": res[0]["fields"],
            "p_iters": sha([r["p_iters"] for r in res])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("port_batch_apply_paths: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {}
    for path in args.paths.split(","):
        if path == "sweep":
            res = run_sweep(cs, dev)
        elif path == "farm":
            res = run_farm(cs, dev)
        elif path == "ranks":
            res = run_ranks(cs, dev, cs.farm_rank_job, cs.FARM_GRID,
                            cs.N_FARM, cs.N_FARM_TIMED)
        elif path == "geometry":
            res = run_ranks(cs, dev, cs.geom_rank_job, cs.GEOM_RANK_GRID,
                            cs.N_GEOM_RANKS, cs.N_GEOM_RANKS_TIMED)
        else:
            raise SystemExit(f"unknown path {path!r}; one of {PATHS}")
        out[path] = res
        print(f"{path}: {json.dumps(res)}", flush=True)
    out["package"] = os.path.dirname(
        sys.modules["openfoam_tpp_tpu_torch"].__file__)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
