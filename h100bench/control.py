"""The control of a cell's comparison, on the card at the cell's size.

    python3 h100bench/control.py --workload CELL --seeds 1,2,3

For each seed: the reference with its state held in bfloat16 between
steps (the step below the configuration's f32 that would tempt a later
change) put in the program's place, compared with the reference by the
numbers of compare.py. Prints one JSON line per seed with each number
and the cell's limit; a limit that a control reading does not exceed
cannot tell the control from a sound run. The benchmark's runs do not
run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))

    import torch

    from h100bench import compare, harness

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell, config, traffic = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        vals = compare.control(config, traffic, seed, torch.device(args.device))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": vals, "limits": cell["limits"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
