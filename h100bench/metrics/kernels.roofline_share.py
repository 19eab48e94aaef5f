"""Layer `ops/kernels/*` (csrc/*.cu): sum over the traced calls of the
hand-written kernel entries that have a byte count (kernel_bytes/) of
bytes / peak HBM bandwidth, over the sum of their device time. An
aggregate only: a coarse-level call served from L2 can beat the HBM
bound alone."""

import json
from pathlib import Path

UNIT = "%"


def read(run):
    if run.trace is None:
        return None
    with open(Path(__file__).resolve().parents[1] / "peaks.json") as f:
        bw = json.load(f)["hbm_bytes_per_s"]
    calls = [c for c in run.trace.calls if c[2] > 0]
    if not calls:
        return None
    return 100.0 * sum(b / bw for _, b, _ in calls) / sum(s for _, _, s in calls)
