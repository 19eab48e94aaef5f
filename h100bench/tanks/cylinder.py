"""The tank of an orbital-cylinder configuration (H, D, mesh, geo,
round_to, and R, freq, duration, ramp or a `study` of them): an open-top
cylinder shaken on an analytic orbit, the tank of every configuration
that names none.

A tank file gives the two functions the harness and compare.py call:

  make_inputs(config, traffic, seed, device, rows=None)
      -> {"state", "forcing", "rows"}: the seeded input, `state` holding
      alpha, u, v, w, p, t, dt as f32 tensors (a trailing case axis for
      a batch), `forcing` what the tank's system and reference read,
      `rows` the cases;
  reference_segment(config, traffic, seed, device, n_steps, hook=None)
      -> (state, p_iters (n_steps[, B]) numpy, t0, fluid cells a case):
      the plain reference over `n_steps` steps from that input, on a
      geometry the tank builds itself from the configuration, with
      nothing of the port. `hook`, when given, maps the state after
      every step (the control's rounding).

Here the input is waves.py's developed m = 1 wave and the reference
reference/step.py on reference/geometry.py's cylinder.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench import waves
from h100bench.reference import geometry as rgeom
from h100bench.reference import step as rstep


def make_inputs(config, traffic, seed, device, rows=None) -> dict:
    return waves.make_inputs(config, traffic, seed, device, rows)


def reference_segment(config, traffic, seed, device, n_steps, hook=None):
    geom = rgeom.build_tank_geometry(H=config["H"], D=config["D"],
                                     mesh=config["mesh"], geo=config["geo"],
                                     round_to=config["round_to"])
    inputs = make_inputs(config, traffic, seed, device)
    B = len(inputs["rows"])
    ga = rstep.geometry_arrays(geom, device, batch=B if B > 1 else None)
    state = dict(inputs["state"])
    with torch.no_grad():
        state, iters, _ = rstep.run(state, inputs["forcing"], ga,
                                    tuple(float(h) for h in geom.spacing),
                                    n_steps, lockstep=B > 1, hook=hook)
    it = torch.stack([torch.as_tensor(i) for i in iters]).cpu().numpy()
    cells = int(np.count_nonzero(geom.vfrac > 0))
    return state, it, inputs["state"]["t"], cells
