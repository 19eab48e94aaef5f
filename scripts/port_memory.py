#!/usr/bin/env python3
"""The card's memory over one cell of the H100 benchmark: what the caching
allocator holds, its private pools (a CUDA graph's memory) apart.

    python3 scripts/port_memory.py --workload CELL [--seed N] [--segments K]

Run from a checkout's root on a CUDA card (exits 2 without one): the
benchmark (h100bench/) and the port are imported from the current
directory, so the one script reads any checkout that has the benchmark.
It sets the cell up as h100bench/harness.py does (seeded inputs, the
system, one warm segment), runs K more segments (default 3) as the
window does, then one more with the peaks reset before it. Prints one
JSON line of bytes:

  whole            over set-up and the K segments:
    max_allocated  `torch.cuda.max_memory_allocated()`, what the
                   benchmark's `peak_mem_gib` reads
    max_reserved   `torch.cuda.max_memory_reserved()`: the most the
                   allocator held on the card
    allocated, reserved         after the last segment
    private_reserved, private_allocated
                   of the segments in private pools (a CUDA graph's,
                   `torch.cuda.graph_pool_handle()`), after the last
                   segment (`torch.cuda.memory_snapshot()`)
  one_segment      max_allocated and max_reserved over the last segment
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def private_pools():
    """(reserved, allocated) bytes of the allocator's segments outside its
    default pool."""
    import torch

    reserved = allocated = 0
    for seg in torch.cuda.memory_snapshot():
        if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0):
            reserved += seg["total_size"]
            allocated += seg["allocated_size"]
    return reserved, allocated


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1234567890123)
    ap.add_argument("--segments", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())

    import torch

    if not torch.cuda.is_available():
        print("port_memory: no CUDA device", file=sys.stderr)
        return 2
    from h100bench import harness, waves

    dev = torch.device("cuda:0")
    cell, config, traffic = harness.load_cell(args.workload)
    inputs = waves.make_inputs(config, traffic, args.seed, dev)
    system = harness.load_module("systems", config["system"]).build(
        config, dev)
    carry0 = system.start(inputs)
    n = int(traffic["segment_steps"])
    for _ in range(1 + args.segments):
        harness._segment(system, carry0, n, "cuda")
    torch.cuda.synchronize()
    pr, pa = private_pools()
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(dev),
           "whole": {"max_allocated": torch.cuda.max_memory_allocated(dev),
                     "max_reserved": torch.cuda.max_memory_reserved(dev),
                     "allocated": torch.cuda.memory_allocated(dev),
                     "reserved": torch.cuda.memory_reserved(dev),
                     "private_reserved": pr, "private_allocated": pa}}
    torch.cuda.reset_peak_memory_stats(dev)
    harness._segment(system, carry0, n, "cuda")
    torch.cuda.synchronize()
    out["one_segment"] = {
        "max_allocated": torch.cuda.max_memory_allocated(dev),
        "max_reserved": torch.cuda.max_memory_reserved(dev)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
