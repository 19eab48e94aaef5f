"""The benchmark's harness: one run of one cell, driven by data.

Everything is found by name under this directory: a cell in
`cells/<cell>.json` names its configuration (`configs/<config>.json`)
and its traffic (`traffic/<traffic>.json`); the configuration names the
system under test (`systems/<system>.py`, which builds the port's step);
each metric is read by `metrics/<metric>.py`; each hand-written kernel
entry of the port has its bytes a call in `kernel_bytes/<entry>.py`; the
spans of a traced run are listed in `spans.json`. A new cell,
configuration, metric or kernel is a new file, and nothing here changes.

A run: set-up (the inputs from the seed, the port's step, one untimed
segment that warms the kernels and the allocator), then the window: the
segment of `segment_steps` steps replayed from the seeded input, its
carry restored each time, the clock read after a synchronize at each
step's end, until `seconds` have passed at a segment's end. A traced run
then profiles one more segment. Last, with the program's state freed
but for the last segment's output, the plain reference steps the same
input and `compare.py` decides `correct`.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from h100bench import compare, waves

ROOT = Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> dict:
    """`<kind>/<name>.json` under the benchmark's directory."""
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` under the benchmark's directory, imported by its
    path (a name may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind}/{name}.py: no such file")
    spec = importlib.util.spec_from_file_location(
        f"h100bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(kind: str, suffix: str) -> list[str]:
    return sorted(p.name[: -len(suffix)] for p in (ROOT / kind).iterdir()
                  if p.name.endswith(suffix) and not p.name.startswith("_"))


def load_cell(name: str) -> tuple[dict, dict, dict]:
    cell = load_json("cells", name)
    return cell, load_json("configs", cell["config"]), load_json(
        "traffic", cell["traffic"])


def cell_metrics(cell_name: str, trace: bool, spec: dict | None) -> list[str]:
    """The metrics a run of the cell reports: BENCHMARK.json's
    `end_to_end` (untraced) or `per_layer` (traced) entries whose
    `workloads` hold the cell or that have none; without a BENCHMARK.json
    (the tests), every metric whose reader gives a number."""
    if spec is None:
        return names("metrics", ".py")
    key = "per_layer" if trace else "end_to_end"
    return [m["name"] for m in spec[key]
            if cell_name in m.get("workloads", [cell_name])]


class Run:
    """What a run measured; the metric readers read it."""

    def __init__(self):
        self.setup_s = None
        self.step_s = []          # wall seconds of every step of the window
        self.window_s = None
        self.steps = 0            # steps in the window
        self.n_cases = 1
        self.chips = 1            # cards the cell asks for and the run uses
        self.fluid_cells = 0      # per case
        self.case_sim_s = 0.0     # simulated seconds, summed over cases
        self.p_iters = []         # per step: the batch's CG iterations
        self.peak_bytes = None
        self.trace = None         # trace.Reading of a traced segment


def _segment(system, carry, n, clock=None):
    """`n` steps from `carry`: (carry', records, step seconds)."""
    recs, secs = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        carry, rec = system.step(carry)
        if clock == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        recs.append(rec)
    return carry, recs, secs


def _records(recs) -> np.ndarray:
    """(n_steps, 7[, B]) float64 of the steps' device scalars."""
    rows = [torch.stack([x.to(torch.float64) for x in r]) for r in recs]
    return torch.stack(rows).cpu().numpy()


def gates(rec: np.ndarray, p_max_iters: int) -> np.ndarray:
    """Per step (and case) True where a gate of PERF.md section 2 breaks:
    a non-finite scalar, Courant above 0.6, the CG at its cap, or alpha
    outside [0, 1]."""
    co, iters = rec[:, 1], rec[:, 3]
    amin, amax = rec[:, 5], rec[:, 6]
    bad = ~np.isfinite(rec).all(axis=1)
    return (bad | (co > 0.6) | (iters >= p_max_iters) | (amin < 0.0)
            | (amax > 1.0))


def run(cell_name: str, cell: dict, config: dict, traffic: dict, seed: int,
        seconds: float, trace: bool, device, t_start: float,
        spec: dict | None = None, fault=None) -> dict:
    """One run of a cell; returns the result dict (`correct`, `attempted`,
    `failed`, `metrics`, `device`, [`breakdown`], `compared`). `fault`
    (tests only): a callable given the system after it is built, which may
    break it."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    clock = "cuda" if on_card else None
    out = Run()
    out.chips = int(cell["chips"])
    n = int(traffic["segment_steps"])

    # --- set-up ---
    inputs = waves.make_inputs(config, traffic, seed, dev)
    system = load_module("systems", config["system"]).build(config, dev)
    if fault is not None:
        fault(system)
    carry0 = system.start(inputs)
    out.n_cases = system.n_cases
    out.fluid_cells = system.fluid_cells
    t_in = inputs["state"]["t"].detach().to(torch.float64).cpu().numpy()
    _segment(system, carry0, n, clock)
    if on_card:
        torch.cuda.synchronize()
    out.setup_s = time.perf_counter() - t_start

    # --- window: no garbage collection pass inside it ---
    recs_all, carry = [], None
    gc.collect()
    gc.disable()
    try:
        w0 = time.perf_counter()
        while True:
            carry, recs, secs = _segment(system, carry0, n, clock)
            out.step_s += secs
            rec = _records(recs)
            recs_all.append(rec)
            if time.perf_counter() - w0 >= seconds:
                break
        out.window_s = time.perf_counter() - w0
    finally:
        gc.enable()
    if on_card:
        out.peak_bytes = torch.cuda.max_memory_allocated(dev)
    out.steps = len(out.step_s)
    out.case_sim_s = float(sum(np.sum(r[-1, 0] - t_in) for r in recs_all))
    it = np.concatenate([r[:, 3] for r in recs_all])
    out.p_iters = (it.max(axis=1) if it.ndim == 2 else it).tolist()
    failed = int(sum(gates(r, system.p_max_iters).sum() for r in recs_all))
    attempted = out.steps * out.n_cases
    last_rec = recs_all[-1]

    q = np.percentile(np.asarray(out.step_s) * 1e3, [5, 50, 95, 100])
    print(f"h100bench: {out.steps} steps in {out.window_s:.3f} s, step ms "
          f"p5 {q[0]:.2f} p50 {q[1]:.2f} p95 {q[2]:.2f} max {q[3]:.2f}; "
          f"set-up {out.setup_s:.3f} s", file=sys.stderr, flush=True)
    if trace:
        from h100bench import trace as tr

        out.trace = tr.profile_segment(
            lambda: _segment(system, carry0, n, clock), n, ROOT, on_card)

    # --- correctness: the last segment's output against the reference ---
    prog = {k: v.detach() for k, v in system.fields(carry).items()}
    prog_iters = last_rec[:, 3]
    del system, carry0, carry, inputs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    compared = compare.check(cell, config, traffic, seed, dev, prog,
                             prog_iters, out.fluid_cells)
    del prog
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())

    metrics = {}
    for name in cell_metrics(cell_name, trace, spec):
        reader = load_module("metrics", name)
        value = reader.read(out)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": reader.UNIT}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": failed, "metrics": metrics,
              "device": device_info(dev, out)}
    if trace and out.trace is not None:
        result["breakdown"] = out.trace.breakdown
    result["compared"] = compared
    return result


def device_info(dev, out: Run) -> dict:
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": min(torch.cuda.device_count(), out.chips),
                "memory_peak_bytes": int(out.peak_bytes)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if out.trace is not None:
        info["busy_s"] = out.trace.busy_s
        info["window_s"] = out.trace.window_s
    return info


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (whole names: the port's name begins with the JAX package's)."""
    banned = {"jax", "jaxlib", "flax", "openfoam_tpp_tpu"}
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & banned)
