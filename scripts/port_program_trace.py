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
     the table's sum against the segment's idle,
     `host.syncs_per_step` against the segment's p_iters plus its CG
     calls a step, and the pressure CG's CUDA graphs captured and
     replayed a step by site (`profiling.graph_counts()`);
  3. the cost of tracing: windows of WINDOW_S seconds of whole segments
     with `collect()` off and on, in `--turns` turns (default TURNS; off,
     on, on, off per turn), each its step p50 and rate (fluid cells x
     simulated s per s / 1e6, as mcell_sim_s_per_s);
  4. one segment with the CG's graphs and one with every CG iteration
     run eagerly (`_cg_core(_graphs=False)`), from the same carry, each
     under torch.profiler (CUDA activity): whether the fields and the
     steps' scalars are bitwise equal, and the kernel entries' launch
     counts and the hand-written kernels' records by symbol equal (a
     replay's launches are credited from its capture); each symbol's
     device µs a record in both;
  5. the benchmark's `kernels.*` shares on a segment run eagerly (its
     wrappers see every entry call there, none in a replay), with each
     entry's bytes, µs and roofline a call, and from those bytes the
     hand-written kernels' roofline and busy shares in both segments of
     4.

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


def graph_check(system, carry0, n):
    """One segment with the CG's graphs and one with every iteration
    eager, each under torch.profiler (chip_smoke.py's
    `graph_launch_check`): the fields and the steps' scalars bitwise
    equal, the launches the entries count and the hand-written kernel
    records by symbol equal. Adds, per hand-written kernel symbol, its
    records a step and its device µs a record in each run."""
    from chip_smoke import graph_launch_check
    from h100bench import harness

    def run():
        carry, recs, _ = harness._segment(system, carry0, n, "cuda")
        fields = system.fields(carry)
        return [fields[k] for k in sorted(fields)] + [
            x for r in recs for x in r]

    res = graph_launch_check("one segment", run, fatal=False)

    def per_record(mode, name):
        rec, us = res[mode]["kernels"].get(name, (0, 0.0))
        return us / rec if rec else None

    res["by_symbol"] = {
        name[:120]: {"records_per_step": rec / n,
                     "us_graphs": per_record("graphs", name),
                     "us_eager": per_record("eager", name)}
        for name, (rec, _) in sorted(res["graphs"]["kernels"].items(),
                                     key=lambda kv: -kv[1][1])}
    res["all_equal"] = not res["problems"]
    return res


def kernel_reading(system, carry0, n, check):
    """The benchmark's `kernels.roofline_share` and `kernels.busy_share`
    (h100bench/trace.py's host-traced segment, its wrappers on the kernel
    entries) on a segment whose CG iterations all run eagerly, where the
    wrappers see every call; by entry its calls a step, bytes and device
    µs a call and roofline. With the bytes of those calls, the same
    shares of the hand-written kernels in `check`'s two CUDA-only
    segments (the same launches, the records by symbol equal): what the
    benchmark would read if it saw the kernels a graph replays."""
    import json

    from h100bench import harness, trace
    from openfoam_tpp_tpu_torch.solver import poisson

    core = poisson._cg_core
    poisson._cg_core = lambda *a, **k: core(*a, **{**k, "_graphs": False})
    try:
        r = trace.profile_segment(
            lambda: harness._segment(system, carry0, n, "cuda"), n,
            harness.ROOT, True)
    finally:
        poisson._cg_core = core
    with open(harness.ROOT / "peaks.json") as f:
        bw = json.load(f)["hbm_bytes_per_s"]
    calls = [c for c in r.calls if c[2] > 0]
    if not calls:
        return None
    nbytes = sum(b for _, b, _ in calls)
    by_entry = {}
    for entry, b, sec in calls:
        c = by_entry.setdefault(entry, [0, 0, 0.0])
        c[0], c[1], c[2] = c[0] + 1, c[1] + b, c[2] + sec
    out = {"eager_wrapped": {
        "kernels.roofline_share": 100.0 * nbytes / bw
        / sum(s for _, _, s in calls),
        "kernels.busy_share": 100.0 * r.handwritten_share,
        "by_entry": {k: {"calls_per_step": c / n, "bytes_per_call": b / c,
                         "us_per_call": sec * 1e6 / c,
                         "roofline": 100.0 * b / bw / sec}
                     for k, (c, b, sec) in sorted(by_entry.items())}}}
    for mode in ("graphs", "eager"):
        m = check[mode]
        hw_us = sum(us for _, us in m["kernels"].values())
        if not hw_us:
            continue
        out[f"{mode}_cuda_only"] = {
            "roofline_share": 100.0 * nbytes / bw / (hw_us * 1e-6),
            "busy_share": 100.0 * hw_us / m["busy_us"],
            "handwritten_ms_per_step": hw_us * 1e-3 / n,
            "busy_ms_per_step": m["busy_us"] * 1e-3 / n}
    return out


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
    ap.add_argument("--turns", type=int, default=TURNS,
                    help="turns of the cost windows (0: none)")
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

    from openfoam_tpp_tpu_torch.utils import profiling

    graphs = profiling.graph_counts()
    r = program_trace.profile_program(segment)
    graphs_after = profiling.graph_counts()
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
        "launches_per_step": {k: v / steps for k, v in r.launches.items()},
        **{f"graph_{kind}_per_step": {
            site: (n_after - graphs[kind].get(site, 0)) / steps
            for site, n_after in graphs_after[kind].items()}
           for kind in ("captures", "replays")}}
    cost = []
    for _ in range(args.turns):
        for on in (False, True, True, False):
            cost.append(window(system, carry0, n, cells, t_in, on))
    out["cost"] = cost
    out["graph_check"] = graph_check(system, carry0, n)
    out["kernels"] = kernel_reading(system, carry0, n, out["graph_check"])
    for on in (False, True):
        ws = [c for c in cost if c["collect"] is on]
        if not ws:
            continue
        out[f"cost_{'on' if on else 'off'}"] = {
            "step_ms_p50_median": float(np.median(
                [c["step_ms_p50"] for c in ws])),
            "rate_median": float(np.median([c["rate"] for c in ws]))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
