"""The comparison that decides `correct`.

The plain reference of the configuration's tank (`tanks/<tank>.py`; for
the cylinder, reference/: plain PyTorch in f32 on its own geometry)
steps, from the same seeded input as the program's, the segment that
the timed path replays, and the program's output of its last segment is
held against it. Nothing here reads a key of the tank: a new cell,
configuration, tank, metric or kernel is a new file. The numbers
compared, each per case and then the worst case:

  alpha_gap     max |alpha - alpha_ref| over the cells
  alpha_rel     ||alpha - alpha_ref|| / ||alpha_ref||
  vel_rel       ||(u, v, w) - ref|| / ||ref||, every face of the three grids
  p_rel         ||p - p_ref|| / ||p_ref||
  t_rel         |t - t_ref| / (t_ref - t0), the simulated time advanced
  dt_rel        |dt - dt_ref| / dt_ref, the next step's dt base
  iters_gap     max over the steps of |p_iters - p_iters_ref|
  cells_gap     |fluid cells - fluid cells of the reference's geometry|

Each compared number has its limit in the cell's file (`limits`), set
from the readings PERF.md gives; `control` is the same
comparison with the reference's state rounded to bfloat16 after every
step in the program's place (tests/ and control.py).
"""

from __future__ import annotations

import numpy as np
import torch

FIELDS = ("alpha", "u", "v", "w", "p")


def reference_segment(config, traffic, seed, device, n_steps, hook=None):
    """(final state, p_iters (n_steps[, B]) numpy, t0, fluid cells a case)
    of the configuration's tank's plain reference over `n_steps` steps
    from the seeded input."""
    from h100bench import harness   # harness imports this module

    return harness.tank(config).reference_segment(config, traffic, seed,
                                                  device, n_steps, hook=hook)


def numbers(prog: dict, prog_iters, ref: dict, ref_iters, t0, cells_gap):
    """The compared numbers (see the module docstring) as floats."""
    f64 = lambda t: t.to(torch.float64)
    cells = lambda t: (t.reshape(-1, t.shape[-1]) if t.dim() == 4
                       else t.reshape(-1, 1))
    diff = {k: cells(f64(prog[k]) - f64(ref[k])) for k in FIELDS}
    refc = {k: cells(f64(ref[k])) for k in FIELDS}
    norm = lambda a: torch.sqrt(torch.sum(a * a, dim=0))
    alpha_gap = torch.max(torch.abs(diff["alpha"]), dim=0).values
    vel_num = torch.sqrt(sum(norm(diff[k]) ** 2 for k in ("u", "v", "w")))
    vel_den = torch.sqrt(sum(norm(refc[k]) ** 2 for k in ("u", "v", "w")))
    p_rel = norm(diff["p"]) / norm(refc["p"])
    t_ref = f64(ref["t"])
    t_rel = torch.abs(f64(prog["t"]) - t_ref) / (t_ref - f64(t0))
    dt_rel = torch.abs(f64(prog["dt"]) - f64(ref["dt"])) / f64(ref["dt"])
    worst = lambda t: float(torch.max(t.reshape(-1)).cpu())
    iters = np.abs(np.asarray(prog_iters, np.float64)
                   - np.asarray(ref_iters, np.float64))
    return {"alpha_gap": worst(alpha_gap),
            "alpha_rel": worst(norm(diff["alpha"]) / norm(refc["alpha"])),
            "vel_rel": worst(vel_num / vel_den),
            "p_rel": worst(p_rel), "t_rel": worst(t_rel),
            "dt_rel": worst(dt_rel), "iters_gap": float(iters.max()),
            "cells_gap": float(cells_gap)}


def check(cell, config, traffic, seed, device, prog, prog_iters,
          prog_cells) -> dict:
    """{number: {"value", "limit"}} of the program's last segment, for
    the numbers the cell's `limits` hold (a number whose control reading
    does not stand three times clear of sound runs has no limit and is
    not compared)."""
    ref, ref_iters, t0, ref_cells = reference_segment(
        config, traffic, seed, device, int(traffic["segment_steps"]))
    vals = numbers(prog, prog_iters, ref, ref_iters, t0,
                   abs(prog_cells - ref_cells))
    limits = cell["limits"]
    return {k: {"value": vals[k], "limit": float(v)} for k, v in limits.items()}


def bf16_state(state: dict) -> dict:
    """The control's rounding: every field held in bfloat16 between steps."""
    out = dict(state)
    for k in FIELDS:
        out[k] = state[k].to(torch.bfloat16).to(torch.float32)
    return out


def control(config, traffic, seed, device) -> dict:
    """The compared numbers of the control: the reference with its state
    held in bfloat16 between steps, against the reference."""
    n = int(traffic["segment_steps"])
    ref, ref_iters, t0, _ = reference_segment(config, traffic, seed, device, n)
    low, low_iters, _, _ = reference_segment(config, traffic, seed, device, n,
                                             hook=bf16_state)
    return numbers(low, low_iters, ref, ref_iters, t0, 0)
