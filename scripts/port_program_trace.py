#!/usr/bin/env python3
"""The port's spans and host reads on one cell of the H100 benchmark.

    python3 scripts/port_program_trace.py --workload CELL [--seed N]

Run from a checkout's root on a CUDA card (exits 2 without one): the
benchmark (h100bench/) and the port are imported from the current
directory. It sets the cell up as h100bench/harness.py does (seeded
inputs, the system, one warm segment), then:

  1. one step under `torch.cuda.set_sync_debug_mode("warn")` and
     `collect()`: the synchronizing operations it warns of, by the
     innermost lines of the checkout on the stack that called them,
     against its `host_read` count;
  2. one segment profiled with CUDA activity and `collect()` on
     (h100bench/program_trace.py): the idle-by-span table (stderr), the
     three per-step readings, the share of kernel-launch runtime calls
     inside a `step` span, the kernels' lags behind their launch calls,
     the table's sum against the segment's idle, and
     `host.syncs_per_step` against the segment's p_iters plus its CG
     calls a step;
  3. the cost of tracing: windows of WINDOW_S seconds of whole segments
     with `collect()` off and on, in TURNS turns (off, on, on, off per
     turn), each its step p50 and rate (fluid cells x simulated s per
     s / 1e6, as mcell_sim_s_per_s).

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import traceback
import warnings

HERE = os.path.abspath(__file__)
TURNS = 3          # cost windows: turns of (off, on, on, off)
WINDOW_S = 12.0    # seconds a cost window


def setup(workload, seed, dev):
    """(system, carry0, n, fluid cells, t_in) as harness.run sets up."""
    import torch

    from h100bench import harness, waves

    cell, config, traffic = harness.load_cell(workload)
    inputs = waves.make_inputs(config, traffic, seed, dev)
    system = harness.load_module("systems", config["system"]).build(
        config, dev)
    carry0 = system.start(inputs)
    n = int(traffic["segment_steps"])
    harness._segment(system, carry0, n, "cuda")
    torch.cuda.synchronize()
    t_in = inputs["state"]["t"].detach().double().cpu().numpy()
    return system, carry0, n, system.fluid_cells, t_in


def sync_check(system, carry0):
    """One step under the sync debug mode: warnings by calling line, and
    the step's host reads."""
    import torch

    from openfoam_tpp_tpu_torch.utils import profiling

    where = collections.Counter()

    def caught(message, category, filename, lineno, file=None, line=None):
        # the innermost lines of this checkout (the port, the benchmark)
        # and of this script on the stack of the call that synchronized
        if "synchroniz" in str(message):
            ours = [f"{os.path.relpath(f.filename)}:{f.lineno}"
                    for f in traceback.extract_stack()[:-1]
                    if os.path.abspath(f.filename).startswith(
                        (os.getcwd(), HERE))]
            where[" < ".join(ours[::-1][:3])] += 1

    with warnings.catch_warnings(), profiling.collect() as rec:
        warnings.simplefilter("always")
        warnings.showwarning = caught
        torch.cuda.set_sync_debug_mode("warn")
        try:
            system.step(carry0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return {"sync_warnings": sum(where.values()), "by_line": dict(where),
            "host_reads": rec.host_reads,
            "n_host_reads": sum(rec.host_reads.values())}


def window(system, carry0, n, cells, t_in, on):
    """Whole segments until WINDOW_S seconds have passed: step p50 (ms)
    and rate, with `collect()` on or off."""
    import contextlib

    import numpy as np

    from h100bench import harness
    from openfoam_tpp_tpu_torch.utils import profiling

    secs, sim = [], 0.0
    with profiling.collect() if on else contextlib.nullcontext():
        w0 = time.perf_counter()
        while True:
            _, recs, s = harness._segment(system, carry0, n, "cuda")
            secs += s
            sim += float(np.sum(harness._records(recs)[-1, 0] - t_in))
            if time.perf_counter() - w0 >= WINDOW_S:
                break
        wall = time.perf_counter() - w0
    return {"collect": on, "steps": len(secs),
            "step_ms_p50": float(np.percentile(secs, 50) * 1e3),
            "rate": cells * sim / wall / 1e6}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1234567890123)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_program_trace: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.set_num_threads(1)
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(dev)}
    t0 = time.perf_counter()
    system, carry0, n, cells, t_in = setup(args.workload, args.seed, dev)
    out["setup_s"] = time.perf_counter() - t0
    out["sync"] = sync_check(system, carry0)

    from h100bench import harness, program_trace

    held = {}

    def segment():
        held["out"] = harness._segment(system, carry0, n, "cuda")

    r = program_trace.profile_program(segment)
    print(program_trace.table(r), file=sys.stderr, flush=True)
    rec = harness._records(held["out"][1])
    iters = rec[:, 3]
    iters = iters.max(axis=1) if iters.ndim == 2 else iters
    steps = max(r.steps, 1)
    m = program_trace.metrics(r)
    out["program"] = {
        **m, "p_iters_mean": float(np.mean(iters)),
        "cg_calls_per_step": r.cg_calls / steps,
        "syncs_minus_iters_and_cg_calls": (
            m["host.syncs_per_step"] - float(np.mean(iters))
            - r.cg_calls / steps),
        "idle_ms_per_step": r.idle_s * 1e3 / steps,
        "busy_ms_per_step": r.busy_s * 1e3 / steps,
        "window_ms_per_step": r.window_s * 1e3 / steps,
        "idle_share": r.idle_s / r.window_s,
        "table_sum_over_idle": (sum(r.idle_by_span.values()) / r.idle_s
                                if r.idle_s > 0 else None),
        "launch_calls": r.launch_calls,
        "launch_calls_in_step_share": (
            r.launch_calls_in_step / r.launch_calls
            if r.launch_calls else None),
        "kernels_paired": r.kernels_paired,
        "kernels_after_launch_share": (
            r.kernels_after_launch / r.kernels_paired
            if r.kernels_paired else None),
        "launch_lag_min_us": (None if r.launch_lag_min_ns is None
                              else r.launch_lag_min_ns * 1e-3),
        "launch_lag_max_us": (None if r.launch_lag_max_ns is None
                              else r.launch_lag_max_ns * 1e-3),
        "idle_ms_per_step_by_span": {k: v * 1e3 / steps
                                     for k, v in r.idle_by_span.items()},
        "host_reads": r.host_reads,
        "launches_per_step": {k: v / steps for k, v in r.launches.items()}}
    cost = []
    for _ in range(TURNS):
        for on in (False, True, True, False):
            cost.append(window(system, carry0, n, cells, t_in, on))
    out["cost"] = cost
    for on in (False, True):
        ws = [c for c in cost if c["collect"] is on]
        out[f"cost_{'on' if on else 'off'}"] = {
            "step_ms_p50_median": float(np.median(
                [c["step_ms_p50"] for c in ws])),
            "rate_median": float(np.median([c["rate"] for c in ws]))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
