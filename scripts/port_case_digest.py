#!/usr/bin/env python3
"""Digest of the flagship case run through the port's `run_case` on one
CUDA device.

    python3 scripts/port_case_digest.py [--duration 0.1]

Builds the flagship case (H0.208/D0.2/R0.004/f1.88, mesh 0.00185 → 112³,
ramp 2 s) in a temporary directory with `setup_case`, runs it with
`run_case` on the card, and prints one JSON line: the steps, the final
time and the sha256 of every field of every checkpoint. The package is
imported from the current directory, so the same script digests another
checkout of the port (run it from that checkout's root): two trees whose
digests match ran the case to the same bits.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=0.1)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("port_case_digest: no CUDA device", file=sys.stderr)
        return 2
    from openfoam_tpp_tpu_torch.manager.cases import setup_case
    from openfoam_tpp_tpu_torch.manager.runner import run_case
    from openfoam_tpp_tpu_torch.utils.io import (list_checkpoints,
                                                 load_checkpoint)

    params = dict(H=0.208, D=0.2, geo="flat", R=0.004, freq=1.88,
                  mesh=0.00185, duration=args.duration, dt=0.001, ramp=2.0)
    with tempfile.TemporaryDirectory(prefix="port_case_digest_") as base:
        case = setup_case(params, base)
        stats = run_case(case, log=lambda line: None)
        digests = {}
        for t, path in list_checkpoints(case):
            chk = load_checkpoint(path)
            digests[f"{t:.6f}"] = {
                k: hashlib.sha256(chk[k].tobytes()).hexdigest()[:16]
                for k in ("alpha", "u", "v", "w", "p", "t", "dt", "step")}
    print(json.dumps({"package": os.path.dirname(sys.modules[
        "openfoam_tpp_tpu_torch"].__file__), "steps": stats["steps"],
        "sim_seconds": stats["sim_seconds"], "checkpoints": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
