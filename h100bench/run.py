"""Run one cell of the port's H100 benchmark.

    python3 h100bench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. The cell is h100bench/cells/CELL.json; the
metrics it reports are BENCHMARK.json's for it. Prints each compared
number beside its limit as the last lines of standard error, and the
result as the last line of standard output: one JSON object with
`correct`, `attempted`, `failed`, `metrics`, `device` (and `breakdown`
with --trace 1), then `compared`. Exits 2 without a CUDA device (it
never falls back to the CPU) or with fewer than the cell asks for, and 3
if the JAX package or JAX is loaded once the run is over.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))

    import torch

    from h100bench import harness

    torch.set_num_threads(1)   # the steps run on the card: one host thread
    cell, config, traffic = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("h100bench: no CUDA device (torch.cuda.is_available() is "
              "False); the benchmark runs on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"h100bench: {args.workload} asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    spec_path = REPO / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text()) if spec_path.is_file() else None
    result = harness.run(args.workload, cell, config, traffic, args.seed,
                         args.seconds, bool(args.trace), "cuda:0", T_START,
                         spec=spec)
    found = harness.forbidden_modules()
    if found:
        print(f"h100bench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
