#!/usr/bin/env python3
"""What bounds the port's FCT limiter and momentum right-hand side
kernels, on one CUDA device, and how each compares with another design.

    python3 scripts/port_kernel_variants.py [--source NAME=PATH ...]

Builds openfoam_tpp_tpu_torch/csrc/mules_fct.cu and momentum_rhs.cu as
they are and in variants that each change one thing, plus each
`--source` (a file with the same C interface, such as an earlier
revision: `git show REV:openfoam_tpp_tpu_torch/csrc/mules_fct.cu > f.cu`;
its kernel is told by the entry point it defines), and times every build
at the flagship's 112³ shapes on the same seeded inputs: fct_iter with
bf16 λ/anti (the step's streams), momentum_rhs with dev2 on and zero wall
faces. Device time: each timed run of 20 launches (after 3 warm-up) is
queued behind a device-side wait long enough for the host to enqueue all
of them (openfoam_tpp_tpu_torch/utils/devtime.py, chip_smoke.py's
yardstick too), so the host's ctypes cost per call does not pace it;
builds are timed in 5 rounds of alternating order (A, B, …, B, A), so a
drift of the card's clock favours none. Each build's output is held against the
unchanged source's. Per build it prints the median µs per call, the
multiple of the byte bound, the SASS instructions of its main
instantiation (`cuobjdump -sass`, a static count), and that
instantiation's registers, spill bytes and static shared memory from
`ptxas -v` (momentum_rhs also takes dynamic shared memory, the size in
its source). Variants:

  fct_iter      x chunk 8 / 32   at most 8 / 32 planes per block (16)
                tile 4 x 32      (y, z) tiles of 4 × 32 cells, six warps
                                 (8 × 32, ten warps)
                fast division    nvcc -prec-div=false
  momentum_rhs  IEEE division    the limiter's division IEEE-rounded (as
                                 built: div.full.f32, 2 ulp)
                two-division limiter
                                 stencil.vanleer_limited's form, r = up /
                                 down then φ(r), IEEE divisions, instead
                                 of the one-division form
                x chunk 4 / 16   planes per block (8 as built)

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

CHUNK = "constexpr int kCX = 16;   // x planes per block, at most"
MCHUNK = "constexpr int kCX = 8;   // x planes per block"
EDITS = {
    "fct_iter": {
        "x chunk 8": [(CHUNK, CHUNK.replace("16", "8"))],
        "x chunk 32": [(CHUNK, CHUNK.replace("16", "32"))],
        "tile 4 x 32": [("constexpr int kTZ = 32, kTY = 8;", "constexpr int kTZ = 32, kTY = 4;"),
                        ("constexpr int kWarps = 10,", "constexpr int kWarps = 6,")],
    },
    "momentum_rhs": {
        "IEEE division": [("  asm(\"div.full.f32 %0, %1, %2;\" : \"=f\"(q) : \"f\"(a), \"f\"(b));",
                           "  q = a / b;")],
        "two-division limiter": [(
            "  const float den = fabsf(up) + fabsf(down);\n"
            "  return den > 0.0f ? div_full(up * fabsf(down) + fabsf(up) * down, den)\n"
            "                    : 0.0f;",
            "  const float safe = fabsf(down) > 1e-30f ? down : (down >= 0.0f ? 1e-30f : -1e-30f);\n"
            "  const float r = up / safe;\n"
            "  const float phi = (r + fabsf(r)) / (1.0f + fabsf(r));\n"
            "  return phi * down;")],
        "x chunk 4": [(MCHUNK, MCHUNK.replace("8", "4"))],
        "x chunk 16": [(MCHUNK, MCHUNK.replace("8", "16"))],
    },
}
FLAGS = {"fct_iter": {"fast division": ["-prec-div=false"]}}
ENTRY = {"fct_iter": "mules_fct_launch", "momentum_rhs": "momentum_rhs_launch"}
SOURCE = {"fct_iter": "mules_fct", "momentum_rhs": "momentum_rhs"}
# Mangled-name fragments of each kernel's main instantiation: fct_iter on
# bf16 streams, single grid; momentum_rhs with dev2 and ∇·U, single grid.
MAIN = {"fct_iter": ("fct_iter_kernel", "nv_bfloat16Lb0E"),
        "momentum_rhs": ("momentum_rhs_kernel", "Lb1ELb1ELb0E")}


def build(name, text, extra, out_dir, nvcc, flags):
    """Start nvcc on `text`; returns (process, library path)."""
    slug = re.sub(r"\W+", "_", name)
    src = os.path.join(out_dir, f"{slug}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, f"lib{slug}.so")
    cmd = [nvcc, *flags, "-Xptxas", "-v", *extra, "-o", lib, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def is_main(kernel, fn):
    return all(part in fn for part in MAIN[kernel])


def sass_count(kernel, lib, cuobjdump):
    """SASS instructions of the main instantiation in `lib`."""
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    count, fn = 0, None
    for line in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn and is_main(kernel, fn) and re.match(
                r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            count += 1
    return count


def ptxas_report(kernel, log):
    """Registers, spill bytes and static shared memory of the main
    instantiation, from nvcc's `-Xptxas -v` output."""
    rep, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            fn = m.group(1)
            continue
        if not fn or not is_main(kernel, fn):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rep["spill_store_bytes"], rep["spill_load_bytes"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rep["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            rep["static_smem_bytes"] = int(s.group(1)) if s else 0
    return rep


def operands(torch, kernel, dev):
    """(inputs, outputs, launch arguments) of `kernel` at SHAPE."""
    rng = np.random.default_rng(2024)
    nx, ny, nz = SHAPE

    def cells(lo, hi, dtype=torch.float32):
        return torch.from_numpy(rng.uniform(lo, hi, SHAPE).astype(np.float32)
                                ).to(dev).to(dtype)

    if kernel == "fct_iter":
        al = cells(0, 1)
        cell = (al, torch.clamp(al + cells(0, 0.2), max=1.0),
                torch.clamp(al - cells(0, 0.2), min=0.0), cells(1e-4, 2e-4))
        lams = tuple(cells(0, 1, torch.bfloat16) for _ in range(3))
        antis = tuple((1e-3 * cells(-1, 1)).to(torch.bfloat16) for _ in range(3))
        ins = (*lams, *antis, *cell)
        outs = [torch.empty_like(lams[0]) for _ in range(3)]
        return ins, outs, [1]
    face_shapes = ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))

    def faces():
        f = [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).to(dev)
             for s in face_shapes]
        f[0][0], f[0][-1], f[1][:, 0], f[1][:, -1] = 0, 0, 0, 0
        f[2][:, :, 0], f[2][:, :, -1] = 0, 0
        return f

    vel, rp = faces(), faces()
    ins = (*vel, *rp, cells(1e-5, 2e-3), cells(-0.1, 0.1))
    outs = [torch.empty(s, device=dev) for s in face_shapes]
    return ins, outs, [1]


def runner(torch, _build, kernel, lib_path, ins, outs, lead):
    lib = ctypes.CDLL(lib_path)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(lib, ENTRY[kernel])
    n_ptr = len(ins) + len(outs)
    n_f = 4 if kernel == "fct_iter" else 3
    fn.argtypes = [ci] + [vp] * n_ptr + [ci] * 3 + [cf] * n_f + [vp]
    fn.restype = ci
    ptrs = [_build.ptr(t) for t in (*ins, *outs)]
    scal = (*SPACING, 1e-12) if kernel == "fct_iter" else SPACING
    stream = _build.stream_of(ins[0])

    def call():
        _build.check(fn(*lead, *ptrs, *SHAPE, *scal, stream), lib_path)
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of another source with one kernel's C "
                         "interface")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from openfoam_tpp_tpu_torch.ops.kernels import _build
    from openfoam_tpp_tpu_torch.utils.devtime import device_ms

    kernels = sorted(ENTRY)
    nvcc = _build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    builds = {}   # (kernel, name) → (text, extra flags)
    for kernel in kernels:
        base = (_build.CSRC / f"{SOURCE[kernel]}.cu").read_text()
        builds[kernel, "as built"] = (base, [])
        for name, edits in EDITS[kernel].items():
            text = base
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"{kernel} variant {name!r}: its edit no "
                                     f"longer matches csrc/{SOURCE[kernel]}.cu")
                text = text.replace(old, new)
            builds[kernel, name] = (text, [])
        for name, extra in FLAGS.get(kernel, {}).items():
            builds[kernel, name] = (base, extra)
    for spec in args.source:
        name, path = spec.split("=", 1)
        with open(path) as f:
            text = f.read()
        owner = [k for k in kernels if f"int {ENTRY[k]}(" in text]
        if len(owner) != 1:
            raise SystemExit(f"--source {spec}: defines none of "
                             f"{[ENTRY[k] for k in kernels]}")
        builds[owner[0], name] = (text, [])

    out_dir = os.path.join(repo, "perf_out", "kernel_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {key: build(f"{key[0]} {key[1]}", t, x, out_dir, nvcc,
                        _build.NVCC_FLAGS)
             for key, (t, x) in builds.items()}
    libs, logs = {}, {}
    for key, (proc, lib) in procs.items():
        logs[key], _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{key}: nvcc exit {proc.returncode}\n{logs[key]}")
        libs[key] = lib

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    card_name, power = smi.stdout.strip().splitlines()[0].split(", ")
    card = f"{card_name}, {power} W"
    report = {"card": card, "shape": SHAPE, "kernels": {}}
    for kernel in kernels:
        ins, outs, lead = operands(torch, kernel, dev)
        n_bytes = sum(t.numel() * t.element_size() for t in (*ins, *outs))
        bound_us = n_bytes / HBM_BYTES_PER_S * 1e6
        calls, results, ref = {}, {}, None
        for (k, name), lib in libs.items():
            if k != kernel:
                continue
            calls[name] = call = runner(torch, _build, kernel, lib, ins, outs,
                                        lead)
            call()
            torch.cuda.synchronize()
            got = [o.float().clone() for o in outs]
            if ref is None:
                ref = got
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            scale = max(float(r.abs().max()) for r in ref)
            results[name] = {"rel_err_vs_as_built": err / scale, "us": [],
                             "sass_main": sass_count(kernel, lib, cuobjdump),
                             **ptxas_report(kernel, logs[kernel, name])}
        order = list(calls)
        for rnd in range(ROUNDS):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                results[name]["us"].append(device_ms(calls[name], REPS) * 1e3)
        for name, r in results.items():
            us = float(np.median(r["us"]))
            r.update(median_us=us, x_bound=us / bound_us)
            print(f"{kernel:12s} {name:22s} {us:9.2f} us median of {ROUNDS} "
                  f"({min(r['us']):.2f}-{max(r['us']):.2f})  "
                  f"{us / bound_us:6.2f}x bound  rel err vs as built "
                  f"{r['rel_err_vs_as_built']:.2e}  SASS {r['sass_main']}  "
                  f"regs {r.get('registers')}  spills "
                  f"{r.get('spill_store_bytes')}/{r.get('spill_load_bytes')} B  "
                  f"static smem {r.get('static_smem_bytes')} B", flush=True)
        print(f"{kernel}: shape {SHAPE}, {n_bytes / 1e6:.2f} MB, byte bound "
              f"{bound_us:.2f} us; {card}", flush=True)
        report["kernels"][kernel] = {"bytes": n_bytes, "bound_us": bound_us,
                                     "builds": results}
    with open(os.path.join(repo, "perf_out", "port_kernel_variants.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
