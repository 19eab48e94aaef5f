#!/usr/bin/env python3
"""What bounds the port's fused momentum right-hand side kernel, on one
CUDA device.

    python3 scripts/port_kernel_variants.py [--source NAME=PATH ...]

Builds openfoam_tpp_tpu_torch/csrc/momentum_rhs.cu as it is and in
variants that each change one thing, plus each `--source` (a file with
the same C interface, such as an earlier revision), and times every
build at the flagship's 112³ shapes on the same seeded inputs with zero
wall faces (dev2 on; CUDA events, 20 launches after 3 warm-up, in 5
rounds of alternating order). Each build's output is held against the
unchanged source's. Per build it prints the median µs per call, the
multiple of the byte bound, the SASS
instructions of its dev2-on kernels (`cuobjdump -sass`, a static count)
and an issue estimate from them: every output face's warp issuing a
third of those instructions (one component's body) once, at one warp
instruction per cycle on each of the SM's 4 schedulers at the card's
maximum SM clock.
Variants:

  int64 index    64-bit index arithmetic for every neighbour read
  interleaved    blocks ordered by x-plane, then component (the three
                 components of a plane side by side), instead of all of
                 u's blocks, then v's, then w's
  fast division  nvcc -prec-div=false (approximate f32 division)
  no limiter     the van Leer limiter returns its downwind difference
                 (no division, no branch; the loads stay)

Writes perf_out/port_kernel_variants.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

SHAPE = (112, 112, 112)
SPACING = (0.00185,) * 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak bandwidth
REPS = 20
ROUNDS = 5

# (old, new) text replacements of each variant; each must match once.
EDITS = {
    "int64 index": [(
        "return __ldg(p + (c.i[0] * e[1] + c.i[1]) * e[2] + c.i[2]);",
        "return __ldg(p + ((int64_t)c.i[0] * e[1] + c.i[1]) * e[2] + c.i[2]);")],
    "interleaved": [
        ("  const int n0 = F.vel[0].e[0];\n"
         "  const int c = blockIdx.z / n0, i = blockIdx.z - c * n0;",
         "  const int i = blockIdx.z / 3, c = blockIdx.z - 3 * i;"),
        ("(ny + 1 + kBY - 1) / kBY, 3 * (nx + 1));",
         "(ny + 1 + kBY - 1) / kBY, 3 * nx + 1);")],
    "no limiter": [(
        "  const float safe = fabsf(down) > kEps ? down : (down >= 0.0f ? kEps : -kEps);\n"
        "  const float r = up / safe;\n"
        "  const float phi = (r + fabsf(r)) / (1.0f + fabsf(r));\n"
        "  return phi * down;",
        "  return down + 0.0f * up;")],
}
FLAGS = {"fast division": ["-prec-div=false"]}


def build(name, text, extra, out_dir, nvcc, flags):
    """Start nvcc on `text`; returns (process, library path)."""
    slug = re.sub(r"\W+", "_", name)
    src = os.path.join(out_dir, f"{slug}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, f"lib{slug}.so")
    cmd = [nvcc, *flags, *extra, "-o", lib, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def sass_counts(lib, cuobjdump):
    """SASS instructions per dev2-on kernel function of `lib`."""
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[fn] += 1
    # The dev2-on kernels with ∇·U: their last two template flags are true.
    return {k: v for k, v in counts.items()
            if "momentum_rhs_kernel" in k and "Lb1ELb1E" in k}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of another source with the same C interface")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from openfoam_tpp_tpu_torch.ops.kernels import _build

    nvcc = _build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    base = (_build.CSRC / "momentum_rhs.cu").read_text()
    builds = {"as built": (base, [])}
    for name, edits in EDITS.items():
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: its edit no longer "
                                 f"matches csrc/momentum_rhs.cu")
            text = text.replace(old, new)
        builds[name] = (text, [])
    for name, extra in FLAGS.items():
        builds[name] = (base, extra)
    for spec in args.source:
        name, path = spec.split("=", 1)
        with open(path) as f:
            builds[name] = (f.read(), [])

    out_dir = os.path.join(repo, "perf_out", "kernel_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {n: build(n, t, x, out_dir, nvcc, _build.NVCC_FLAGS)
             for n, (t, x) in builds.items()}
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = lib

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    nx, ny, nz = SHAPE
    face_shapes = ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))

    def faces():
        f = [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).to(dev)
             for s in face_shapes]
        f[0][0], f[0][-1], f[1][:, 0], f[1][:, -1] = 0, 0, 0, 0
        f[2][:, :, 0], f[2][:, :, -1] = 0, 0
        return f

    def cells(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, SHAPE).astype(np.float32)).to(dev)

    vel, rp = faces(), faces()
    mu, div_u = cells(1e-5, 2e-3), cells(-0.1, 0.1)
    ins = (*vel, *rp, mu, div_u)
    outs = [torch.empty(s, device=dev) for s in face_shapes]
    n_bytes = sum(t.numel() * 4 for t in (*ins, *outs))
    bound_us = n_bytes / HBM_BYTES_PER_S * 1e6
    stream = _build.stream_of(mu)

    def runner(lib_path):
        lib = ctypes.CDLL(lib_path)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.momentum_rhs_launch
        fn.argtypes = [ci] + [vp] * 11 + [ci] * 3 + [cf] * 3 + [vp]
        fn.restype = ci
        ptrs = [_build.ptr(t) for t in (*ins, *outs)]

        def call():
            _build.check(fn(1, *ptrs, nx, ny, nz, *SPACING, stream), lib_path)
        return call

    calls, results, ref = {}, {}, None
    for name, lib in libs.items():
        calls[name] = call = runner(lib)
        call()
        torch.cuda.synchronize()
        got = [o.clone() for o in outs]
        if ref is None:
            ref = got
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        scale = max(float(r.abs().max()) for r in ref)
        results[name] = {"rel_err_vs_as_built": err / scale, "us": [],
                         "sass_dev2_kernels": sass_counts(lib, cuobjdump)}
    # Rounds in alternating order, so a drift of the card's clock during
    # the run does not favour one build.
    for rnd in range(ROUNDS):
        for name in (list(calls) if rnd % 2 == 0 else list(calls)[::-1]):
            call = calls[name]
            for _ in range(3):
                call()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                call()
            end.record()
            torch.cuda.synchronize()
            results[name]["us"].append(start.elapsed_time(end) / REPS * 1e3)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    card_name, power, mhz = smi.stdout.strip().splitlines()[0].split(", ")
    card = f"{card_name}, {power} W"
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    warps = sum(e0 * e1 * -(-e2 // 32) for e0, e1, e2 in face_shapes)
    issue_rate = n_sm * 4 * float(mhz) * 1e6     # warp instructions / s
    for build_name, r in results.items():
        us = float(np.median(r["us"]))
        sass = r["sass_dev2_kernels"]
        issue_us = warps * sum(sass.values()) / 3 / issue_rate * 1e6
        r.update(median_us=us, x_bound=us / bound_us, issue_us=issue_us)
        print(f"{build_name:26s} {us:9.2f} us median of {ROUNDS} "
              f"({min(r['us']):.2f}-{max(r['us']):.2f})  {us / bound_us:6.2f}x "
              f"bound  rel err vs as built {r['rel_err_vs_as_built']:.2e}  "
              f"SASS {sum(sass.values())} in {len(sass)} kernel(s), issue "
              f"estimate {issue_us:.1f} us", flush=True)
    print(f"shape {SHAPE}, {n_bytes / 1e6:.2f} MB, byte bound {bound_us:.2f} us; "
          f"{warps} warps, {n_sm} SMs at {mhz} MHz; {card}")
    with open(os.path.join(repo, "perf_out", "port_kernel_variants.json"), "w") as f:
        json.dump({"card": card, "shape": SHAPE, "bytes": n_bytes,
                   "bound_us": bound_us, "builds": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
