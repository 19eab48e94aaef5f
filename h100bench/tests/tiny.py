"""Tiny sizes of the two cells for the CPU tests: the cells' own files
with the grid coarsened and the study and segment shortened."""

from __future__ import annotations

import time

from h100bench import harness

FLAGSHIP = ("flagship-288.slosh", {"mesh": 0.02}, {"segment_steps": 20})
SWEEP = ("sweep-defaults.b1024",
         {"mesh": 0.005, "study": {"freq": [1.0, 2.5, 4],
                                   "R": [0.0008, 0.0008, 4],
                                   "duration": 10.0, "ramp": -1}},
         {"segment_steps": 20})


def cell(which):
    name, cfg, trf = which
    c, config, traffic = harness.load_cell(name)
    return name, c, dict(config, **cfg), dict(traffic, **trf)


def run(which, seed=1234567890123, trace=False, fault=None, seconds=0.2):
    name, c, config, traffic = cell(which)
    return harness.run(name, c, config, traffic, seed, seconds, trace, "cpu",
                       time.perf_counter(), fault=fault)
