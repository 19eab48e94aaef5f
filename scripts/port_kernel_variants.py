#!/usr/bin/env python3
"""What bounds the port's redesigned kernels (the FCT limiter, the
momentum right-hand side, the MULES fluxes, the CG apply-dot, the
projection epilogue, the fused cheb2 smoothers and the V-cycle
residual's halo and batch forms), on one CUDA device, and how each
compares with another design.

    python3 scripts/port_kernel_variants.py [--source NAME=PATH ...]
                                            [--only KERNEL ...]

Builds openfoam_tpp_tpu_torch/csrc/mules_fct.cu, momentum_rhs.cu,
mules_flux.cu, seven_point.cu (its apply-dot mode), correction.cu and
cheb2.cu (its pre and post-dot modes) as they are and in
variants that each change one thing, plus each `--source` (a file with
the same C entry point, such as an earlier revision: `git show
REV:openfoam_tpp_tpu_torch/csrc/mules_fct.cu > f.cu`; its kernel is told
by the entry point it defines; an apply-dot, cheb2 or correction
source without the ticket argument is called without it), and times
every build at the flagship's 112³ shapes on the same seeded inputs:
fct_iter with bf16 λ/anti (the step's streams), momentum_rhs with dev2
on and zero wall faces, flux_all with bf16 uc/anti (the step's),
apply_dot_7pt in f32 (CG's), correct_divmax with an open top and zero
wall faces, cheb2_pre_7pt in bf16 and cheb2_post_dot_7pt from bf16 to
f32 (the V-cycle's). The V-cycle residual b − Â·p or (b − A·p)/diag
(mode 1 of seven_point.cu and seven_point_batch.cu) runs in cases
instead: `resid_scaled_7pt_h` as the x-sharded step's island over 4
x-slabs of the 112³ inputs (one launch over a table of the 4 slabs; and
4 launches of a table of one slab each; a source without the slab table
launches the 4 halo launches of its design in both) and as the
single-grid kernel at 112³, 14³ and 4³, `resid_scaled_7pt_nb` at the sweep's three levels
(12×12×50, 6×6×25, 3×3×13, 128 cases); every case in f32 and bf16, unit
and with diagonal, each build's output held bitwise against the
unchanged source's; timed in bf16, the island unit and with diagonal (its
one-slab launches unit), the single grid and the sweep unit at the top
level, with diagonal below.
`apply_dot_7pt_nb` (the sweep CG's batch apply-dot, mode 2 of
seven_point_batch.cu) runs at the sweep's 12×12×50×128 in f32: each
build's Â·p held bitwise and its per-case dots to 1e-5 against the
unchanged source's (and its dots bitwise from call to call), timed twice:
on one set of inputs (18.4 MB, which stays in the 50 MB L2 from launch to
launch) and cycling through four sets (73.7 MB, so each launch finds
its inputs mostly outside L2); it also prints the CUDA kernels one call
runs (torch.profiler). A source whose entry takes no ticket (the
earlier design of two kernels a call, 0494de9) is called without it.
`apply_7pt_nb` (the sweep's batch apply, seven_point_batch_apply_launch)
runs each of its bodies (one thread per element, the z march, two cases
a thread over the flat (column, plane, case pair) space; a variant only
the body it edits; a source without that entry its mode 0) at the shapes
the sweep paths launch it at (APPLY_NB_CASES, and with `--apply-shapes
JSON` every shape scripts/port_batch_apply_paths.py counted), each run
held bitwise against the as-built one-thread-per-element body, the plain
PyTorch version timed beside them, and an empty kernel of one block and of one full wave of 256-thread blocks (the
card's floor for a launch); SASS, registers and spills of each body's f32
unit and bf16 stored-diagonal instantiations.
Device time: each timed run of 20 launches (after 3 warm-up) is queued
behind a device-side wait long enough for the host to enqueue all
of them (openfoam_tpp_tpu_torch/utils/devtime.py, chip_smoke.py's
yardstick too), so the host's ctypes cost per call does not pace it;
builds are timed in 5 rounds of alternating order (A, B, …, B, A), so a
drift of the card's clock favours none. For flux_all and apply_dot_7pt
every build's halo entry point is also timed as the x-sharded step runs
it: the 4 launches of one island over 4 x-slabs of the same inputs
(`island_us`; an apply-dot source whose halo entry takes no running
dot leaves its shards' partials unsummed); correct_divmax's too. Each build's output is held against the
unchanged source's. Per build it prints the median µs per call, the
multiple of the byte bound, the SASS instructions of its main
instantiation (`cuobjdump -sass`, a static count; for an apply-dot
source of two launches, its first kernel), and that instantiation's
registers, spill bytes and static shared memory from `ptxas -v`
(momentum_rhs also takes dynamic shared memory, the size in its source).
Variants:

  fct_iter      x chunk 8 / 32   at most 8 / 32 planes per block (16)
                tile 4 x 32      (y, z) tiles of 4 × 32 cells, six warps
                                 (8 × 32, ten warps)
                fast division    nvcc -prec-div=false
                isnan selects    the NaN-keeping max / min as isnan tests
                                 around fmaxf / fminf (as built: PTX
                                 max.NaN / min.NaN)
  momentum_rhs  IEEE division    the limiter's division IEEE-rounded (as
                                 built: div.full.f32, 2 ulp)
                two-division limiter
                                 stencil.vanleer_limited's form, r = up /
                                 down then φ(r), IEEE divisions, instead
                                 of the one-division form
                x chunk 4 / 16   planes per block (8 as built)
  flux_all      waves 0.5 / 2.0  x chunks sized for half / two waves of
                                 the card at the kernel's occupancy (one)
                8 / no blocks per SM
                                 __launch_bounds__ minimum blocks: at most
                                 32 / any registers (6: 40)
                every division   the limiter's two IEEE divisions at every
                                 face, as the plain formula writes them
                                 (as built: skipped where the dividend is
                                 ±0 and the result known, bitwise equal)
                one-division limiter
                                 van Leer as (up·|down| + |up|·down) /
                                 (|up| + |down|), one IEEE division
                fast division    nvcc -prec-div=false
  apply_dot_7pt waves 0.5 / 2.0  as flux_all's
                4 / 8 blocks per SM
                                 __launch_bounds__ minimum blocks: at most
                                 64 / 32 registers (none)
                4 / 8 planes per warp
                                 planes each warp of the last block sums per
                                 batch of the final sum, loads in flight
                                 together (16)
  correct_divmax IEEE division  the spacing's divisions IEEE-rounded,
                                 as the earlier design (as built: times
                                 the f32 reciprocal, bitwise as the plain
                                 version on the card)
                IEEE division, zero skipped
                                 the same, skipped where the dividend is
                                 ±0 (the result is that zero)
                tile 16 x 16 / 8 x 32
                                 (z, y) tiles of 16 × 16 / 8 × 32 cells
                                 (32 × 8)
                waves 0.5 / 2.0  as flux_all's
                3 / 6 / 8 / no blocks per SM
                                 __launch_bounds__ minimum blocks: at most
                                 80 / 40 / 32 / any registers (4: 64)
                unroll 2         the x march unrolled by two planes
  cheb2_pre_7pt / cheb2_post_dot_7pt
                block 32 x 8     blocks of 32 × 8 threads, 30 × 6 outputs
                                 (32 × 16, 30 × 14)
                waves 0.5 / 2.0  as flux_all's (x chunks of at most 16
                                 planes)
                3 / 4 blocks per SM
                                 __launch_bounds__ minimum blocks: at most
                                 40 / 32 registers (none)
  resid_scaled_7pt_h
                table by switch  a block copies its slab's descriptor from
                                 the table with a switch over the slab
                                 (constant offsets; as built: indexed by
                                 the slab)
                ldg loads        every operand load through __ldg (the
                                 read-only path; as built: plain loads)
                division         the slab as blockIdx.z / nx (as built:
                                 a multiply-high by ⌈2^32 / nx⌉)
  apply_dot_7pt_nb
                unroll 2 / 4     the plane loop unrolled (not unrolled)
                4 / 16 z warps   warps (sets of z planes) per block (8)
                6 / 12 slot runs partials a thread of a last block loads
                                 at once (3)
                5 blocks per SM  __launch_bounds__ minimum blocks: at most
                                 48 registers (none)
                diag no dot / diag no final sum
                                 diagnostics, outputs not the function's:
                                 the main pass alone; with the ticket
  apply_7pt_nb  pairs block 64 / 256 / 512
                                 threads per block of the pair body (128)
                march tile 1 x 1 / 2 x 2 / 2 x 4 / 3 x 4
                                 (x, y) columns per block of the march
                                 body (4 x 4; 1 x 1 is the resid's march)
                march waves 2.0  as resid_scaled_7pt_nb's, on the march body
  resid_scaled_7pt_nb
                2 / 4 columns    (x, y) columns per block (1)
                waves 2.0        z chunks sized for two waves of the card
                                 at the kernel's occupancy (one)
                march at every size
                                 (as built: grids below 262,144 elements
                                 on the one-thread-per-element kernel)

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
WAVES = "constexpr float kWaves = 1.0f;"
LIMITER = (
    "  float phi = 0.0f;\n"
    "  if (up != 0.0f) {\n"
    "    const float r = up / safe;\n"
    "    if (!(r <= 0.0f) || r == -INFINITY) phi = (r + fabsf(r)) / (1.0f + fabsf(r));\n"
    "  }\n"
    "  return phi * down;")
for _k in ("flux_all", "apply_dot_7pt"):
    EDITS[_k] = {f"waves {n}": [(WAVES, WAVES.replace("1.0f", f"{n}f"))]
                 for n in ("0.5", "2.0")}
MINB = "constexpr int kMinBlocks = 6;"
EDITS["flux_all"]["8 blocks per SM"] = [(MINB, MINB.replace("6", "8"))]
EDITS["flux_all"]["no blocks per SM"] = [(
    "__launch_bounds__(kBlock, kMinBlocks)\nflux_all_kernel(",
    "__launch_bounds__(kBlock)\nflux_all_kernel(")]
EDITS["flux_all"]["every division"] = [(LIMITER, (
    "  const float r = up / safe;\n"
    "  const float phi = (r + fabsf(r)) / (1.0f + fabsf(r));\n"
    "  return phi * down;"))]
DOT_BOUNDS = "__global__ void __launch_bounds__(kBlock)\napply_dot_kernel("
EDITS["apply_dot_7pt"].update({
    f"{n} blocks per SM": [(DOT_BOUNDS, DOT_BOUNDS.replace("(kBlock)", f"(kBlock, {n})"))]
    for n in (4, 8)})
PER_WARP = "constexpr int kPerWarp = 16;"
EDITS["apply_dot_7pt"].update({
    f"{n} planes per warp": [(PER_WARP, PER_WARP.replace("16", str(n)))]
    for n in (4, 8)})
EDITS["flux_all"]["one-division limiter"] = [(
    "  const float safe = fabsf(down) > kEps ? down : (down >= 0.0f ? kEps : -kEps);\n"
    + LIMITER,
    "  const float den = fabsf(up) + fabsf(down);\n"
    "  return den > 0.0f ? (up * fabsf(down) + fabsf(up) * down) / den : 0.0f;")]
OVER_H = "  return d * rh;\n}"
TILE = "constexpr int kTZ = 32, kTY = 8, kBlock"
EDITS["correct_divmax"] = {
    "IEEE division": [(OVER_H, "  return d / h;\n}")],
    "IEEE division, zero skipped": [(OVER_H,
                                     "  return d == 0.0f ? d : d / h;\n}")],
    "tile 16 x 16": [(TILE, "constexpr int kTZ = 16, kTY = 16, kBlock")],
    "tile 8 x 32": [(TILE, "constexpr int kTZ = 8, kTY = 32, kBlock")],
    **{f"waves {n}": [(WAVES, WAVES.replace("1.0f", f"{n}f"))]
       for n in ("0.5", "2.0")},
    **{f"{n} blocks per SM": [(MINB.replace("6", "4"), MINB.replace("6", n))]
       for n in "368"},
    "unroll 2": [("    for (int i = i0; i < i1; ++i) {\n      const int64_t c = i * sx + q;",
                  "#pragma unroll 2\n    for (int i = i0; i < i1; ++i) {\n"
                  "      const int64_t c = i * sx + q;")],
    "no blocks per SM": [("__launch_bounds__(kBlock, kMinBlocks)\ncorrect_divmax_kernel(",
                          "__launch_bounds__(kBlock)\ncorrect_divmax_kernel(")]}
CHEB_BOUNDS = "__global__ void __launch_bounds__(kBlock) cheb2_kernel("
for _k in ("cheb2_pre_7pt", "cheb2_post_dot_7pt"):
    EDITS[_k] = {
        "block 32 x 8": [("constexpr int kTZ = 32, kTY = 16;",
                          "constexpr int kTZ = 32, kTY = 8;")],
        **{f"waves {n}": [(WAVES, WAVES.replace("1.0f", f"{n}f"))]
           for n in ("0.5", "2.0")},
        **{f"{n} blocks per SM": [(CHEB_BOUNDS, CHEB_BOUNDS.replace(
            "(kBlock)", f"(kBlock, {n})"))] for n in "34"}}
# The island's launch forms are cases (RESID_CASES); the edits change how
# a block of the slab-table kernel reads its slab and its operands.
SLAB_READ = "  const Slab<T>& s = t.s[n];\n"
SLAB_SWITCH = ("  Slab<T> s;\n  switch (n) {\n"
               + "".join(f"    case {m}: s = t.s[{m}]; break;\n"
                         for m in range(15))
               + "    default: s = t.s[15]; break;\n  }\n")
LD = ("__device__ __forceinline__ float ld(const float* a, int64_t i) "
      "{ return a[i]; }\n__device__ __forceinline__ float ld(const "
      "__nv_bfloat16* a, int64_t i) {\n  return __bfloat162float(a[i]);\n}")
LDG = ("__device__ __forceinline__ float ld(const float* a, int64_t i) "
       "{ return __ldg(a + i); }\n__device__ __forceinline__ float ld(const "
       "__nv_bfloat16* a, int64_t i) {\n  return __bfloat162float(__ldg(a + "
       "i));\n}")
EDITS["resid_scaled_7pt_h"] = {
    "table by switch": [(SLAB_READ, SLAB_SWITCH)],
    "ldg loads": [(LD, LDG)],
    "division": [(
        "  const int n = nx == 1 ? z : (int)__umulhi((unsigned)z, magic);",
        "  const int n = z / nx;")]}
BCOLS = "constexpr int kCB = 32, kCC = 1;"
EDITS["resid_scaled_7pt_nb"] = {
    **{f"{n} columns": [(BCOLS, BCOLS.replace("kCC = 1", f"kCC = {n}"))]
       for n in (2, 4)},
    "waves 2.0": [("constexpr float kRWaves = 1.0f;",
                   "constexpr float kRWaves = 2.0f;")],
    "march at every size": [("constexpr int64_t kMarchFrom = 262144;",
                             "constexpr int64_t kMarchFrom = 0;")]}
PBLOCK = "constexpr int kPBlock = 128;"
TILE_XY = "constexpr int kTX = 4, kTY = 4;"
EDITS["apply_7pt_nb"] = {
    **{f"pairs block {n}": [(PBLOCK, PBLOCK.replace("128", str(n)))]
       for n in (64, 256, 512)},
    **{f"march tile {x} x {y}": [(TILE_XY, f"constexpr int kTX = {x}, "
                                           f"kTY = {y};")]
       for x, y in ((1, 1), (2, 2), (2, 4), (3, 4))},
    "march waves 2.0": [("constexpr float kRWaves = 1.0f;",
                         "constexpr float kRWaves = 2.0f;")]}
# The body each apply variant changes (only that body is timed on it).
APPLY_EDIT_BODY = {name: name.split()[0] for name in EDITS["apply_7pt_nb"]}
RUNS_NB = "constexpr int kDSlotRuns = 3;"
PLANES_NB = "    for (int k = warp; k < nz; k += kDZ) {"
EDITS["apply_dot_7pt_nb"] = {
    **{f"unroll {n}": [(PLANES_NB, f"#pragma unroll {n}\n" + PLANES_NB)]
       for n in (2, 4)},
    **{f"{n} z warps": [("constexpr int kDZ = 8,", f"constexpr int kDZ = {n},")]
       for n in (4, 16)},
    **{f"{n} slot runs": [(RUNS_NB, RUNS_NB.replace("3", str(n)))]
       for n in (6, 12)},
    "5 blocks per SM": [(
        "__launch_bounds__(kDBlock)\napply_dot_batch_kernel(",
        "__launch_bounds__(kDBlock, 5)\napply_dot_batch_kernel(")],
    # Diagnostics (their dots are not the function's): the main pass
    # alone, and with the ticket but no final sum.
    "diag no dot": [("  rows[warp][lane] = acc;\n  __syncthreads();\n  if (warp == 0",
                     "  if (nb > 0) return;\n  rows[warp][lane] = acc;\n"
                     "  __syncthreads();\n  if (warp == 0")],
    "diag no final sum": [("  if (!last) return;\n", "  if (nb > 0) return;\n")]}
EDITS["fct_iter"]["isnan selects"] = [
    ('  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));',
     "  r = isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);"),
    ('  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));',
     "  r = isnan(a) ? a : isnan(b) ? b : fminf(a, b);")]
FLAGS = {"fct_iter": {"fast division": ["-prec-div=false"]},
         "flux_all": {"fast division": ["-prec-div=false"]}}
ENTRY = {"fct_iter": "mules_fct_launch", "momentum_rhs": "momentum_rhs_launch",
         "flux_all": "mules_flux_launch", "apply_dot_7pt": "seven_point_launch",
         "correct_divmax": "correction_launch",
         "cheb2_pre_7pt": "cheb2_launch", "cheb2_post_dot_7pt": "cheb2_launch",
         "resid_scaled_7pt_h": "seven_point_halo_launch",
         "resid_scaled_7pt_nb": "seven_point_batch_launch",
         "apply_dot_7pt_nb": "seven_point_batch_launch",
         "apply_7pt_nb": "seven_point_batch_launch"}
SOURCE = {"fct_iter": "mules_fct", "momentum_rhs": "momentum_rhs",
          "flux_all": "mules_flux", "apply_dot_7pt": "seven_point",
          "correct_divmax": "correction", "cheb2_pre_7pt": "cheb2",
          "cheb2_post_dot_7pt": "cheb2", "resid_scaled_7pt_h": "seven_point",
          "resid_scaled_7pt_nb": "seven_point_batch",
          "apply_dot_7pt_nb": "seven_point_batch",
          "apply_7pt_nb": "seven_point_batch"}
# Each kernel's function giving its scratch size, and whether its entry
# takes the floats before the grid extents.
PARTIALS = {"apply_dot_7pt": "seven_point_num_partials",
            "correct_divmax": "correction_num_partials",
            "cheb2_post_dot_7pt": "cheb2_num_partials"}
FLOATS_FIRST = ("cheb2_pre_7pt", "cheb2_post_dot_7pt")
# Mangled-name fragments of each kernel's main instantiation, any one set
# of them: fct_iter on bf16 streams, single grid; momentum_rhs with dev2
# and ∇·U, single grid; flux_all with bf16 uc and anti, single grid;
# apply-dot in f32, single grid (the one-launch kernel, or the earlier
# design's per-plane kernel in mode 2).
MAIN = {"fct_iter": [("fct_iter_kernel", "nv_bfloat16Lb0E")],
        "momentum_rhs": [("momentum_rhs_kernel", "Lb1ELb1ELb0E")],
        "flux_all": [("flux_all_kernel", "I13__nv_bfloat16S", "Lb0E")],
        "apply_dot_7pt": [("apply_dot_kernelIfLb0E",),
                          ("seven_point_kernelIfLi2ELb0ELb0E",)],
        "correct_divmax": [("correct_divmax_kernelILb1ELb0E",)],
        "cheb2_pre_7pt": [("cheb2_kernelI13__nv_bfloat16S", "Li0E")],
        "cheb2_post_dot_7pt": [("cheb2_kernelI13__nv_bfloat16fLi2E",)],
        "resid_scaled_7pt_h": [
            ("seven_point_slabs_kernelI13__nv_bfloat16Li1ELb0E",),
            ("seven_point_kernelI13__nv_bfloat16Li1ELb0ELb1E",)],
        "resid_scaled_7pt_nb": [
            ("march_batch_kernelI13__nv_bfloat16Li1ELb0ELi1E",),
            ("resid_batch_kernelI13__nv_bfloat16Lb0E",),
            ("seven_point_batch_kernelI13__nv_bfloat16Li1ELb0E",)],
        "apply_dot_7pt_nb": [("apply_dot_batch_kernelIfE",),
                             ("seven_point_batch_kernelIfLi2ELb0E",)]}
# seven_point_launch's apply-dot mode and dtype (f32, unit diagonal).
APPLY_DOT, F32 = 2, 0


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


def main_parts(kernel, names):
    """The first of MAIN[kernel]'s fragment sets that a function named in
    `names` matches (a build holds one design's instantiations)."""
    return next((parts for parts in MAIN[kernel]
                 if any(all(p in fn for p in parts) for fn in names)), ())


def is_main(parts, fn):
    return bool(parts) and all(p in fn for p in parts)


def sass_count(kernel, lib, cuobjdump, parts=None):
    """SASS instructions of the main instantiation in `lib` (or of the
    function whose name holds every fragment of `parts`)."""
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    parts = parts or main_parts(kernel, re.findall(r"Function : (\S+)", out))
    count, fn = 0, None
    for line in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn and is_main(parts, fn) and re.match(
                r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            count += 1
    return count


def ptxas_report(kernel, log, parts=None):
    """Registers, spill bytes and static shared memory of the main
    instantiation (or as `sass_count`'s `parts`), from nvcc's `-Xptxas
    -v` output."""
    pattern = r"(?:Compiling entry function|Function properties for) '?([\w$]+)"
    parts = parts or main_parts(kernel, re.findall(pattern, log))
    rep, fn = {}, None
    for line in log.splitlines():
        m = re.search(pattern, line)
        if m:
            fn = m.group(1)
            continue
        if not fn or not is_main(parts, fn):
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
    """(inputs, outputs, call) of `kernel` at SHAPE: `call` lists the
    entry point's leading ints, its pointer arguments (tensors; None for
    a null pointer; "partials" and "ticket" for the apply-dot scratch,
    made per build) and its trailing floats."""
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
        return ins, outs, ([1], [*ins, *outs], [*SPACING, 1e-12])
    if kernel == "flux_all":
        alpha = cells(0, 1)
        phis = [1e-3 * cells(-1, 1) for _ in range(3)]
        ucs = [(1e-3 * cells(-1, 1)).to(torch.bfloat16) for _ in range(3)]
        outs = [torch.empty_like(alpha, dtype=dt) for _ in range(3)
                for dt in (torch.float32, torch.bfloat16)]
        ins = (alpha, *phis, *ucs)
        return ins, outs, ([1, 1], [*ins, *outs], [])
    if kernel in FLOATS_FIRST:
        from openfoam_tpp_tpu_torch.ops.kernels.seven_point import cheb_coefs

        cheb = list(cheb_coefs(2.0, 0.10))   # SolverKnobs' defaults
        bf = torch.bfloat16
        x, b = cells(-1, 1, bf), cells(-1, 1, bf)
        w = [cells(0.05, 0.3, bf) for _ in range(3)]
        w[0][0], w[1][:, 0], w[2][:, :, 0] = 0, 0, 0
        if kernel == "cheb2_pre_7pt":
            outs = [torch.empty_like(b), torch.empty_like(b)]
            return (b, *w), outs, ([0, 1, 1], [None, b, *w, *outs, None,
                                               None, "ticket"], cheb)
        outs = [torch.empty_like(b, dtype=torch.float32),
                torch.empty((), dtype=torch.float32, device=dev)]
        return (x, b, *w), outs, ([2, 1, 0], [x, b, *w, outs[0], None,
                                              "partials", outs[1], "ticket"],
                                  cheb)
    if kernel == "apply_dot_7pt":
        p = cells(-1, 1)
        w = [cells(0.05, 0.3) for _ in range(3)]
        w[0][0], w[1][:, 0], w[2][:, :, 0] = 0, 0, 0
        outs = [torch.empty_like(p),
                torch.empty((), dtype=torch.float32, device=dev)]
        return (p, *w), outs, ([APPLY_DOT, F32, 0],
                               [p, *w, None, None, outs[0], "partials",
                                outs[1], "ticket"], [])
    face_shapes = ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))

    def faces():
        f = [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).to(dev)
             for s in face_shapes]
        f[0][0], f[0][-1], f[1][:, 0], f[1][:, -1] = 0, 0, 0, 0
        f[2][:, :, 0], f[2][:, :, -1] = 0, 0
        return f

    if kernel == "correct_divmax":
        vel, beta, aps = faces(), faces(), faces()
        beta = [0.2 + 8e-4 * b.abs() for b in beta]
        for a in aps:
            a.abs_()
            a[a < 0.2] = 0
        dp, vfrac = cells(-50, 50), cells(0, 1)
        vfrac[vfrac < 0.1] = 0
        topo = (cells(0, 1)[:, :, 0] > 0.3).float().contiguous()
        rho, dt = cells(1, 998), torch.tensor(3.7e-3, device=dev)
        ins = (dp, *vel, *beta, *aps, vfrac, topo, rho, dt)
        outs = [torch.empty(s, device=dev) for s in face_shapes] + [
            torch.empty((), dtype=torch.float32, device=dev)]
        return ins, outs, ([1], [dt, *ins[:-1], *outs[:3], "partials",
                                 outs[3], "ticket"], list(SPACING))
    vel, rp = faces(), faces()
    ins = (*vel, *rp, cells(1e-5, 2e-3), cells(-0.1, 0.1))
    outs = [torch.empty(s, device=dev) for s in face_shapes]
    return ins, outs, ([1], [*ins, *outs], list(SPACING))


def read_bytes(tensors, plane_only=None):
    """Bytes a call must move: each tensor once, but of `plane_only`
    (correct_divmax's cell density, whose top plane alone is read) one
    (nx, ny) plane."""
    return sum(t.numel() * t.element_size()
               // (t.shape[-1] if t is plane_only else 1) for t in tensors)


def real_types(entry, text):
    """The ctypes types of `entry`'s floating-point scalar arguments in
    `text`, in order (a source may take the spacing as double and eps as
    float)."""
    sig = re.search(rf"int {entry}\(([^)]*)\)", text).group(1)
    return [ctypes.c_double if m == "double" else ctypes.c_float
            for m in re.findall(r"\b(float|double)\s+\w+\s*(?:,|$)", sig)]


def runner(torch, _build, kernel, lib_path, text, call):
    """A no-argument launch of the build at `lib_path` (source `text`)."""
    lib = ctypes.CDLL(lib_path)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(lib, ENTRY[kernel])
    lead, args, scal = call
    first = next(a for a in args if isinstance(a, torch.Tensor))
    if any(isinstance(a, str) for a in args):
        scratch = {"ticket": torch.zeros(1, dtype=torch.int32,
                                         device=first.device)}
        if kernel in PARTIALS:
            count = getattr(lib, PARTIALS[kernel])
            count.argtypes = [ci] * 3
            count.restype = ci
            scratch["partials"] = torch.empty(count(*SHAPE), dtype=torch.float32,
                                              device=first.device)
        if not re.search(rf"int {ENTRY[kernel]}\([^)]*ticket", text):
            args = [a for a in args if not (isinstance(a, str) and a == "ticket")]
        args = [scratch[a] if isinstance(a, str) else a for a in args]
    floats_first = kernel in FLOATS_FIRST
    ft = real_types(ENTRY[kernel], text)
    if len(ft) != len(scal):
        raise SystemExit(f"{lib_path}: {ENTRY[kernel]} takes {len(ft)} "
                         f"real scalars, the call {len(scal)}")
    fn.argtypes = ([ci] * len(lead) + [vp] * len(args)
                   + (ft + [ci] * 3 if floats_first else [ci] * 3 + ft)
                   + [vp])
    fn.restype = ci
    ptrs = [ctypes.c_void_p(None) if a is None else _build.ptr(a) for a in args]
    stream = _build.stream_of(first)
    tail = [*scal, *SHAPE] if floats_first else [*SHAPE, *scal]

    def launch():
        _build.check(fn(*lead, *ptrs, *tail, stream), lib_path)
    launch.keep = args   # the scratch tensors live as long as the launch
    return launch


HALO_ENTRY = {"flux_all": "mules_flux_halo_launch",
              "apply_dot_7pt": "seven_point_halo_launch",
              "correct_divmax": "correction_halo_launch"}
N_SHARDS = 4


def island(torch, _build, kernel, lib_path, text, ins, outs):
    """(launch, bytes): the N_SHARDS halo launches of one island of
    `kernel` over x-slabs of `ins`, writing into slab views of `outs`,
    with the global-end halos as the island fills them (clamp planes
    below and above; a zero weight plane above)."""
    lib = ctypes.CDLL(lib_path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, HALO_ENTRY[kernel])
    nx = SHAPE[0]
    nxl = nx // N_SHARDS
    keep, calls, n_bytes = [], [], 0

    def planes(t, lo, hi):
        """Planes lo … hi − 1 of t, clamped into [0, nx), contiguous."""
        return torch.stack([t[min(max(q, 0), nx - 1)]
                            for q in range(lo, hi)]).contiguous()

    chain = (kernel == "apply_dot_7pt"
             and re.search(r"int seven_point_halo_launch\([^)]*acc", text))
    # A source whose halo launch takes a row window gets the full one.
    window = ((0, SHAPE[1]) if re.search(
        rf"int {HALO_ENTRY[kernel]}\([^)]*int y1", text) else ())
    dot = None
    for sh in range(N_SHARDS):
        x0, x1 = sh * nxl, (sh + 1) * nxl
        slab = lambda t: t[x0:x1]
        scal, rho_slab = [], None
        if kernel == "flux_all":
            alpha, phis, ucs = ins[0], ins[1:4], ins[4:7]
            args = [slab(alpha), planes(alpha, x0 - 2, x0),
                    planes(alpha, x1, x1 + 1), *map(slab, phis),
                    *map(slab, ucs), *map(slab, outs)]
            lead = [1, 1]
        elif kernel == "correct_divmax":
            dp, (u, v, w), (bx, by, bz) = ins[0], ins[1:4], ins[4:7]
            (ax, ay, az), (vfrac, topo, rho) = ins[7:10], ins[10:13]
            # The x faces above the slab: the next shard's first, zeros at
            # the global end (the sealed wall).
            hi = lambda t: (planes(t, x1, x1 + 1) if x1 < nx
                            else torch.zeros_like(t[:1]))
            count = lib.correction_num_partials
            count.argtypes = [ci] * 3
            count.restype = ci
            part = torch.empty(count(nxl, *SHAPE[1:]), dtype=torch.float32,
                               device=dp.device)
            dm = torch.empty((), dtype=torch.float32, device=dp.device)
            rho_slab = slab(rho)
            args = [ins[13], slab(dp), planes(dp, x0 - 1, x0),
                    planes(dp, x1, x1 + 1), slab(u), hi(u), slab(v), slab(w),
                    slab(bx), hi(bx), slab(by), slab(bz), slab(ax), hi(ax),
                    slab(ay), slab(az), slab(vfrac), slab(topo), rho_slab,
                    *(slab(o) for o in outs[:3]), part, dm]
            if re.search(r"int correction_halo_launch\([^)]*ticket", text):
                args.append(torch.zeros(1, dtype=torch.int32, device=dp.device))
            lead, scal = [1], list(SPACING)
        else:
            p, w = ins[0], ins[1:4]
            wx_hi = (planes(w[0], x1, x1 + 1) if x1 < nx
                     else torch.zeros_like(w[0][:1]))
            lib.seven_point_num_partials.argtypes = [ci] * 3
            lib.seven_point_num_partials.restype = ci
            part = torch.empty(lib.seven_point_num_partials(nxl, *SHAPE[1:]),
                               dtype=torch.float32, device=p.device)
            d = torch.empty((), dtype=torch.float32, device=p.device)
            args = [slab(p), planes(p, x0 - 1, x0), planes(p, x1, x1 + 1),
                    wx_hi, *map(slab, w), None, None, slab(outs[0]), part, d]
            if chain:
                args += [torch.zeros(1, dtype=torch.int32, device=p.device),
                         dot]
            dot = d
            lead = [APPLY_DOT, F32, 0]
        keep.append(args)
        n_bytes += read_bytes([
            a for a in args if a is not None and a.dim() > 0 and a.numel() > 1
            and (kernel == "flux_all" or a is not part)], rho_slab)
        fn.argtypes = ([ci] * len(lead) + [vp] * len(args)
                       + [ci] * (3 + len(window))
                       + real_types(HALO_ENTRY[kernel], text)
                       + [vp])
        fn.restype = ci
        calls.append((lead, [ctypes.c_void_p(None) if a is None
                             else _build.ptr(a) for a in args], scal))
    stream = _build.stream_of(ins[0])

    def launch():
        for lead, ptrs, scal in calls:
            _build.check(fn(*lead, *ptrs, nxl, SHAPE[1], SHAPE[2], *window,
                            *scal, stream), lib_path)
    launch.keep = keep
    return launch, n_bytes


RESID = ("resid_scaled_7pt_h", "resid_scaled_7pt_nb")
# The V-cycle residual's cases: (form, shape, the (dtype, diag) pairs
# timed); every form is run in f32 and bf16, unit and with diagonal, and
# held bitwise against the unchanged source. "island": the x-sharded
# step's island over 4 x-slabs, one launch of a table of 4 slabs;
# "island1": 4 launches of a table of one slab ("island" and "island1"
# alike: the 4 halo launches of a source without the table, chained where
# the source chains them); "single": the single-grid kernel
# (row 2: the top level of the default step, unit, and two coarse levels
# with their diagonal); "batch": the sweep's three levels, 128 cases.
RESID_CASES = {
    "resid_scaled_7pt_h": [("island", SHAPE, [("bf16", False), ("bf16", True)]),
                           ("island1", SHAPE, [("bf16", False)]),
                           ("single", SHAPE, [("bf16", False)]),
                           ("single", (14, 14, 14), [("bf16", True)]),
                           ("single", (4, 4, 4), [("bf16", True)])],
    "resid_scaled_7pt_nb": [("batch", (12, 12, 50, 128), [("bf16", False)]),
                            ("batch", (6, 6, 25, 128), [("bf16", True)]),
                            ("batch", (3, 3, 13, 128), [("bf16", True)])]}


def resid_operands(torch, shape, dtype, diag, seed, dev):
    """(p, (wx, wy, wz), diag or None, b, out): seeded, zero wall faces."""
    rng = np.random.default_rng(seed)

    def cells(lo=None, hi=None):
        a = rng.standard_normal(shape) if lo is None else rng.uniform(lo, hi, shape)
        return torch.from_numpy(a.astype(np.float32)).to(dev).to(dtype)

    p, b = cells(), cells()
    w = [cells(0.05, 0.3) for _ in range(3)]
    w[0][0], w[1][:, 0], w[2][:, :, 0] = 0, 0, 0
    d = cells(1.5, 2.5) if diag else None
    return p, tuple(w), d, b, torch.full_like(p, float("nan"))


def resid_launch(torch, _build, lib_path, text, form, p, w, d, b, out):
    """(launch, bytes) of one resid call of `form` with the build at
    `lib_path` (source `text`): mode 1 of its C entry point. An island
    covers N_SHARDS x-slabs with the global-end halos the island fills:
    one launch of their table ("island"), or one launch per slab of a
    table of one ("island1"); a source without the table launches its
    halo entry per slab, each after the first chained to the one before
    it (mode 3) where the source chains launches."""
    lib = ctypes.CDLL(lib_path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ptr = lambda t: ctypes.c_void_p(None) if t is None else _build.ptr(t)
    head = [1, 0 if p.dtype == torch.float32 else 1, int(d is not None)]
    stream = _build.stream_of(p)
    n_bytes = read_bytes([t for t in (p, *w, d, b, out) if t is not None])
    if form == "single":
        fn = lib.seven_point_launch
        fn.argtypes = [ci] * 3 + [vp] * 10 + [ci] * 3 + [vp]
        calls, keep = [(*head, *map(ptr, (p, *w, d, b, out, None, None,
                                          None)), *p.shape, stream)], []
    elif form == "batch":
        fn = lib.seven_point_batch_launch
        nul = [None] * (3 if takes_ticket(text) else 2)
        fn.argtypes = [ci] * 3 + [vp] * (7 + len(nul)) + [ci] * 4 + [vp]
        calls, keep = [(*head, *map(ptr, (p, *w, d, b, out, *nul)),
                        *p.shape, stream)], []
    else:
        nx = p.shape[0]
        nxl = nx // N_SHARDS
        plane = lambda t, q: t[min(max(q, 0), nx - 1)][None].contiguous()
        calls, keep, table = [], [], []
        for sh in range(N_SHARDS):
            x0, x1 = sh * nxl, (sh + 1) * nxl
            halo = (plane(p, x0 - 1), plane(p, x1),
                    plane(w[0], x1) if x1 < nx else torch.zeros_like(w[0][:1]))
            keep.append(halo)
            n_bytes += read_bytes(halo)
            slab = lambda t: None if t is None else t[x0:x1]
            table.append([slab(p), *halo, *map(slab, w), slab(d), slab(b),
                          slab(out)])
        if "int seven_point_slabs_launch(" in text:
            fn = lib.seven_point_slabs_launch
            fn.argtypes = [ci] * 4 + [vp] + [ci] * 3 + [vp]
            groups = [table] if form == "island" else [[t] for t in table]
            for group in groups:
                ptrs = (vp * (10 * len(group)))()
                ptrs[:] = [None if t is None else t.data_ptr()
                           for row in group for t in row]
                keep.append(ptrs)
                calls.append((*head, len(group), ptrs, nxl, *p.shape[1:],
                              stream))
        else:
            fn = lib.seven_point_halo_launch
            fn.argtypes = [ci] * 3 + [vp] * 14 + [ci] * 3 + [vp]
            for sh, row in enumerate(table):
                chained = sh > 0 and "griddepcontrol" in text
                calls.append((3 if chained else 1, *head[1:],
                              *map(ptr, (*row, None, None, None, None)),
                              nxl, *p.shape[1:], stream))

    def launch():
        for args in calls:
            _build.check(fn(*args), lib_path)
    launch.keep = (p, w, d, b, out, keep)   # alive as long as the launch
    return launch, n_bytes


def time_resid(torch, _build, device_ms, kernel, libs, texts, logs, cuobjdump,
               dev):
    """Every build of `kernel` on RESID_CASES: outputs held bitwise against
    the unchanged source's in every case, the timed cases in ROUNDS
    rounds of alternating order. Prints and returns the report."""
    names = [name for k, name in libs if k == kernel]
    builds = {name: {"sass_main": sass_count(kernel, libs[kernel, name],
                                             cuobjdump),
                     **ptxas_report(kernel, logs[kernel, name]),
                     "bitwise_vs_as_built": True} for name in names}
    cases, timed = [], []
    for n_case, (form, shape, times) in enumerate(RESID_CASES[kernel]):
        for tag, diag in (("f32", False), ("f32", True), ("bf16", False),
                          ("bf16", True)):
            dtype = torch.float32 if tag == "f32" else torch.bfloat16
            p, w, d, b, out = resid_operands(torch, shape, dtype, diag,
                                             2024 + n_case, dev)
            label = (f"{form} {'x'.join(map(str, shape))} {tag} "
                     f"{'diag' if diag else 'unit'}")
            calls, ref = {}, None
            for name in names:
                launch, n_bytes = resid_launch(
                    torch, _build, libs[kernel, name], texts[kernel, name],
                    form, p, w, d, b, out)
                out.fill_(float("nan"))
                launch()
                torch.cuda.synchronize()
                got = out.clone()
                if ref is None:
                    ref = got
                if not torch.equal(got, ref):
                    builds[name]["bitwise_vs_as_built"] = False
                    print(f"{kernel}: {name} differs from as built in {label}",
                          flush=True)
                calls[name] = launch
            cases.append({"case": label, "bytes": n_bytes,
                          "bound_us": n_bytes / HBM_BYTES_PER_S * 1e6,
                          "us": {name: [] for name in names}})
            if (tag, diag) in times:
                timed.append((cases[-1], calls))
    for rnd in range(ROUNDS):
        for case, calls in timed:
            for name in (names if rnd % 2 == 0 else names[::-1]):
                case["us"][name].append(device_ms(calls[name], REPS) * 1e3)
    for name in names:
        r = builds[name]
        print(f"{kernel:19s} {name:22s} bitwise vs as built "
              f"{r['bitwise_vs_as_built']}  SASS {r['sass_main']}  regs "
              f"{r.get('registers')}  spills {r.get('spill_store_bytes')}/"
              f"{r.get('spill_load_bytes')} B  static smem "
              f"{r.get('static_smem_bytes')} B", flush=True)
    for case, _ in timed:
        for name in names:
            us = case["us"][name]
            med = float(np.median(us))
            case.setdefault("median_us", {})[name] = med
            print(f"  {case['case']:28s} {name:22s} {med:8.2f} us median of "
                  f"{ROUNDS} ({min(us):.2f}-{max(us):.2f})  "
                  f"{med / case['bound_us']:5.2f}x its {case['bound_us']:.2f} us "
                  f"bound", flush=True)
    return {"builds": builds, "cases": [c for c in cases if c["us"][names[0]]]}


# The batch apply's cases: (shape, dtype, stored diagonal), the shapes
# the sweep paths launch it at (scripts/port_batch_apply_paths.py counts
# them; `--apply-shapes` adds every shape of such a count): the sweep's
# top level (f32 unit, CG's true residual) and its first coarse level
# (bf16 with diagonal, the V-cycle's residual), the same on a farm
# position of 32 cases, and the extended blocks of the sweeps over ranks.
APPLY_NB_CASES = [((12, 12, 50, 128), "f32", False),
                  ((6, 6, 25, 128), "bf16", True),
                  ((12, 12, 50, 32), "f32", False),
                  ((6, 6, 25, 32), "bf16", True),
                  ((7, 7, 50, 128), "f32", False),
                  ((7, 7, 50, 64), "f32", False)]
APPLY_BODIES = ("element", "march", "pairs")
# Mangled-name fragment of each body's instantiation, by (T, DIAG).
APPLY_FRAGMENT = {"element": "seven_point_batch_kernelI{t}Li0ELb{d}E",
                  "march": "march_batch_kernelI{t}Li0ELb{d}E",
                  "pairs": "apply_pairs_kernelI{t}Lb{d}E"}


def apply_nb_cases(path):
    """APPLY_NB_CASES and every (shape, dtype, diagonal) that the JSON of
    scripts/port_batch_apply_paths.py at `path` counts."""
    cases = list(APPLY_NB_CASES)
    if not path:
        return cases
    with open(path) as f:
        report = json.load(f)
    for res in report.values():
        if not isinstance(res, dict):
            continue
        for key in (*res.get("apply_per_step", {}),
                    *res.get("apply_per_step_all_ranks", {})):
            shape, dtype, diag = key.split()
            case = (tuple(int(n) for n in shape.split("x")),
                    "f32" if dtype == "float32" else "bf16", diag == "diag")
            if case not in cases:
                cases.append(case)
    return cases


def time_apply_nb(torch, _build, device_ms, libs, texts, logs, cuobjdump,
                  dev, shapes_file):
    """The batch apply's bodies, as built and in each variant, at the
    shapes of `apply_nb_cases(shapes_file)`: every run's output (and the
    plain version's) held bitwise against the as-built
    one-thread-per-element body's, timed with the plain version in ROUNDS
    rounds of alternating order beside an empty kernel of one block and
    of one full wave of 256-thread blocks (the launch floor).
    A source without the body entry point runs its mode 0. Prints and
    returns the report."""
    from openfoam_tpp_tpu_torch.ops.kernels.seven_point import apply_7pt_plain

    kernel = "apply_7pt_nb"
    vp, ci = ctypes.c_void_p, ctypes.c_int
    names = [name for k, name in libs if k == kernel]
    runs, reports = [], {}
    for name in names:
        text = texts[kernel, name]
        lib = ctypes.CDLL(libs[kernel, name])
        if "int seven_point_batch_apply_launch(" in text:
            fn = lib.seven_point_batch_apply_launch
            fn.argtypes = [ci] * 3 + [vp] * 6 + [ci] * 4 + [vp]
            nul = 0
            bodies = [APPLY_EDIT_BODY[name]] if name in APPLY_EDIT_BODY \
                else list(APPLY_BODIES)
        else:
            fn = lib.seven_point_batch_launch
            nul = 3 if takes_ticket(text) else 2
            fn.argtypes = [ci] * 3 + [vp] * (7 + nul) + [ci] * 4 + [vp]
            bodies = ["mode 0"]
        fn.restype = ci
        for body in bodies:
            runs.append((name, body, fn, nul))
            if body in APPLY_FRAGMENT:
                for t, d in (("f32", False), ("bf16", True)):
                    frag = (APPLY_FRAGMENT[body].format(
                        t="f" if t == "f32" else "13__nv_bfloat16", d=int(d)),)
                    reports.setdefault(f"{name} / {body}", {})[
                        f"{t} {'diag' if d else 'unit'}"] = {
                        "sass": sass_count(kernel, libs[kernel, name],
                                           cuobjdump, frag),
                        **ptxas_report(kernel, logs[kernel, name], frag)}
    base = ctypes.CDLL(libs[kernel, "as built"])
    empty = base.seven_point_batch_empty_launch
    empty.argtypes, empty.restype = [ci, ci, vp], ci
    wave = torch.cuda.get_device_properties(dev).multi_processor_count * 8
    stream = _build.stream_of(torch.empty(1, device=dev))

    def floor(blocks):
        return lambda: _build.check(empty(blocks, 256, stream), "empty kernel")

    floors = {"one block": (floor(1), []), f"one wave ({wave} blocks)":
              (floor(wave), [])}
    cases = []
    for n_case, (shape, tag, diag) in enumerate(
            apply_nb_cases(shapes_file)):
        dtype = torch.float32 if tag == "f32" else torch.bfloat16
        p, w, d, _, out = resid_operands(torch, shape, dtype, diag,
                                         3024 + n_case, dev)
        n_bytes = read_bytes([t for t in (p, *w, d, out) if t is not None])
        label = (f"{'x'.join(map(str, shape))} {tag} "
                 f"{'diag' if diag else 'unit'}")
        ptrs = [_build.ptr(t) if t is not None else vp(None)
                for t in (p, *w, d)]
        calls, ref = {}, None
        plain = (lambda p=p, w=w, d=d: apply_7pt_plain(p, w, d))
        for name, body, fn, nul in runs:
            if body in ("march", "pairs") and shape[3] % 2:
                continue
            if body == "mode 0":
                args = (0, 0 if tag == "f32" else 1, int(diag), *ptrs, vp(None),
                        _build.ptr(out), *[vp(None)] * nul, *shape, stream)
            else:
                args = (APPLY_BODIES.index(body), 0 if tag == "f32" else 1,
                        int(diag), *ptrs, _build.ptr(out), *shape, stream)
            launch = (lambda fn=fn, args=args, path=libs[kernel, name]:
                      _build.check(fn(*args), path))
            out.fill_(float("nan"))
            launch()
            torch.cuda.synchronize()
            got = out.clone()
            if ref is None:
                ref = got
            calls[f"{name} / {body}"] = (launch, torch.equal(got, ref))
        calls["plain PyTorch"] = (plain, torch.equal(plain(), ref))
        cases.append({"case": label, "bytes": n_bytes,
                      "bound_us": n_bytes / HBM_BYTES_PER_S * 1e6,
                      "calls": calls, "keep": (p, w, d, out),
                      "us": {k: [] for k in calls}})
    for rnd in range(ROUNDS):
        for key, (fn, us) in floors.items():
            us.append(device_ms(fn, REPS) * 1e3)
        for case in cases:
            order = list(case["calls"])
            for key in (order if rnd % 2 == 0 else order[::-1]):
                case["us"][key].append(
                    device_ms(case["calls"][key][0], REPS) * 1e3)
    for key, rep in reports.items():
        print(f"{kernel} {key:28s} "
              + "  ".join(f"{v}: SASS {r.get('sass')} regs "
                          f"{r.get('registers')} spills "
                          f"{r.get('spill_store_bytes')}/"
                          f"{r.get('spill_load_bytes')}"
                          for v, r in rep.items()), flush=True)
    floor_us = {}
    for key, (_, us) in floors.items():
        floor_us[key] = float(np.median(us))
        print(f"{kernel} empty kernel, {key}: {floor_us[key]:.2f} us median "
              f"of {ROUNDS} ({min(us):.2f}-{max(us):.2f})", flush=True)
    for case in cases:
        case["median_us"] = {}
        case["bitwise_vs_element"] = {}
        for key, (_, same) in case.pop("calls").items():
            us = case["us"][key]
            med = case["median_us"][key] = float(np.median(us))
            case["bitwise_vs_element"][key] = same
            print(f"  {case['case']:22s} {key:28s} {med:7.2f} us median of "
                  f"{ROUNDS} ({min(us):.2f}-{max(us):.2f})  "
                  f"{med / case['bound_us']:5.2f}x its {case['bound_us']:.2f} "
                  f"us bound  {'bitwise' if same else 'DIFFERS'}", flush=True)
        del case["keep"]
    return {"floor_us": floor_us, "builds": reports, "cases": cases}


def takes_ticket(text):
    """Whether the batch source's entry takes the ticket counter."""
    return bool(re.search(r"int seven_point_batch_launch\([^)]*ticket", text))


DOT_NB_SHAPE = (12, 12, 50, 128)
DOT_NB_SETS = 4   # input sets cycled through in the L2-cold timing
DOT_RTOL = 1e-5


def kernels_per_call(torch, fn):
    """CUDA kernels one call of `fn` runs (torch.profiler, after a warm-up
    call): the larger of the trace's device events and its launch calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    n_dev = sum(1 for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA)
    n_api = sum(1 for e in events if e.name.startswith(("cudaLaunchKernel",
                                                        "cuLaunchKernel")))
    return max(n_dev, n_api)


def time_apply_dot_nb(torch, _build, device_ms, libs, texts, logs, cuobjdump,
                      dev):
    """Every build of the batch apply-dot at DOT_NB_SHAPE in f32: Â·p held
    bitwise and the dots to DOT_RTOL against the unchanged source's, timed
    warm (one input set) and cold (DOT_NB_SETS sets in turn) in ROUNDS
    rounds of alternating order. Prints and returns the report."""
    kernel = "apply_dot_7pt_nb"
    nx, ny, nz, nb = DOT_NB_SHAPE
    rng = np.random.default_rng(2024)
    vp, ci = ctypes.c_void_p, ctypes.c_int

    def operands():
        f = lambda lo, hi: torch.from_numpy(rng.uniform(
            lo, hi, DOT_NB_SHAPE).astype(np.float32)).to(dev)
        w = [f(0.05, 0.3) for _ in range(3)]
        w[0][0], w[1][:, 0], w[2][:, :, 0] = 0, 0, 0
        return f(-1, 1), w, torch.empty_like(w[0])

    sets = [operands() for _ in range(DOT_NB_SETS)]
    p0, w0, out0 = sets[0]
    n_bytes = read_bytes([p0, *w0, out0]) + nb * 4
    bound_us = n_bytes / HBM_BYTES_PER_S * 1e6
    names = [name for k, name in libs if k == kernel]
    builds, ref = {}, None
    for name in names:
        text = texts[kernel, name]
        lib = ctypes.CDLL(libs[kernel, name])
        count = lib.seven_point_batch_num_partials
        count.argtypes, count.restype = [ci] * 3, ci
        part = torch.empty(count(nx, ny, nz) * nb, dtype=torch.float32,
                           device=dev)
        dots = torch.empty(nb, dtype=torch.float32, device=dev)
        ticket = ([torch.zeros(-(-nb // 32), dtype=torch.int32, device=dev)]
                  if takes_ticket(text) else [])
        fn = lib.seven_point_batch_launch
        fn.argtypes = [ci] * 3 + [vp] * (9 + len(ticket)) + [ci] * 4 + [vp]
        fn.restype = ci
        stream = _build.stream_of(p0)
        calls = [[_build.ptr(t) if t is not None else vp(None)
                  for t in (p, *w, None, None, out, part, dots, *ticket)]
                 for p, w, out in sets]

        def launcher(ptr_sets, fn=fn, stream=stream, path=libs[kernel, name]):
            turn = [0]

            def launch():
                ptrs = ptr_sets[turn[0] % len(ptr_sets)]
                turn[0] += 1
                _build.check(fn(2, 0, 0, *ptrs, *DOT_NB_SHAPE, stream), path)
            return launch

        warm, cold = launcher(calls[:1]), launcher(calls)
        out0.fill_(float("nan"))
        warm()
        torch.cuda.synchronize()
        got = (out0.clone(), dots.clone())
        warm()
        torch.cuda.synchronize()
        repeats = torch.equal(dots, got[1])
        if ref is None:
            ref = got
        r = builds[name] = {
            "bitwise_ap_vs_as_built": torch.equal(got[0], ref[0]),
            "dots_max_rel_vs_as_built": float(
                ((got[1] - ref[1]).abs() / ref[1].abs()).max()),
            "dots_repeat_bitwise": repeats,
            "dots_bitwise_vs_as_built": torch.equal(got[1], ref[1]),
            "cuda_kernels_per_call": kernels_per_call(torch, warm),
            "sass_main": sass_count(kernel, libs[kernel, name], cuobjdump),
            **ptxas_report(kernel, logs[kernel, name]),
            "us_warm": [], "us_cold": [], "keep": (part, dots, ticket),
            "calls": (warm, cold)}
        r["agrees"] = (r["bitwise_ap_vs_as_built"] and repeats
                       and r["dots_max_rel_vs_as_built"] <= DOT_RTOL)
    for rnd in range(ROUNDS):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            warm, cold = builds[name]["calls"]
            builds[name]["us_warm"].append(device_ms(warm, REPS) * 1e3)
            builds[name]["us_cold"].append(device_ms(cold, REPS) * 1e3)
    for name in names:
        r = builds[name]
        del r["keep"], r["calls"]
        for key in ("warm", "cold"):
            us = r[f"us_{key}"]
            r[f"median_us_{key}"] = float(np.median(us))
            r[f"x_bound_{key}"] = r[f"median_us_{key}"] / bound_us
        print(f"{kernel} {name:20s} {'' if r['agrees'] else 'DIFFERS '}"
              f"warm {r['median_us_warm']:7.2f} us "
              f"({min(r['us_warm']):.2f}-{max(r['us_warm']):.2f}, "
              f"{r['x_bound_warm']:.2f}x bound)  cold {r['median_us_cold']:7.2f} "
              f"us ({r['x_bound_cold']:.2f}x)  kernels/call "
              f"{r['cuda_kernels_per_call']}  dots rel vs as built "
              f"{r['dots_max_rel_vs_as_built']:.2e} (bitwise "
              f"{r['dots_bitwise_vs_as_built']})  SASS {r['sass_main']}  regs "
              f"{r.get('registers')}  spills {r.get('spill_store_bytes')}/"
              f"{r.get('spill_load_bytes')} B  static smem "
              f"{r.get('static_smem_bytes')} B", flush=True)
    print(f"{kernel}: shape {DOT_NB_SHAPE} f32 unit, {n_bytes / 1e6:.2f} MB, "
          f"byte bound {bound_us:.2f} us; warm: one input set (in L2), cold: "
          f"{DOT_NB_SETS} sets in turn", flush=True)
    return {"shape": DOT_NB_SHAPE, "bytes": n_bytes, "bound_us": bound_us,
            "builds": builds}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of another source with one kernel's C "
                         "interface")
    ap.add_argument("--only", action="append", default=[], choices=sorted(ENTRY),
                    help="time only this kernel (repeatable; default all)")
    ap.add_argument("--apply-shapes", default=None, metavar="JSON",
                    help="scripts/port_batch_apply_paths.py's --out: the "
                         "batch apply is also timed at every shape it counts")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from openfoam_tpp_tpu_torch.ops.kernels import _build
    from openfoam_tpp_tpu_torch.utils.devtime import device_ms

    kernels = sorted(args.only or ENTRY)
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
        if not owner:
            raise SystemExit(f"--source {spec}: defines none of "
                             f"{[ENTRY[k] for k in kernels]}")
        for k in owner:
            builds[k, name] = (text, [])

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
        if kernel == "apply_7pt_nb":
            report["kernels"][kernel] = time_apply_nb(
                torch, _build, device_ms, libs,
                {key: t for key, (t, _) in builds.items()}, logs, cuobjdump,
                dev, args.apply_shapes)
            print(f"{kernel}: {card}", flush=True)
            continue
        if kernel == "apply_dot_7pt_nb":
            report["kernels"][kernel] = time_apply_dot_nb(
                torch, _build, device_ms, libs,
                {key: t for key, (t, _) in builds.items()}, logs, cuobjdump,
                dev)
            print(f"{kernel}: {card}", flush=True)
            continue
        if kernel in RESID:
            report["kernels"][kernel] = time_resid(
                torch, _build, device_ms, kernel, libs,
                {key: t for key, (t, _) in builds.items()}, logs, cuobjdump,
                dev)
            print(f"{kernel}: {card}", flush=True)
            continue
        ins, outs, call = operands(torch, kernel, dev)
        n_bytes = read_bytes([t for t in (*ins, *outs) if t.dim() > 0],
                             ins[12] if kernel == "correct_divmax" else None)
        bound_us = n_bytes / HBM_BYTES_PER_S * 1e6
        calls, results, ref = {}, {}, None
        for (k, name), lib in libs.items():
            if k != kernel:
                continue
            launch = calls[name] = runner(torch, _build, kernel, lib,
                                          builds[kernel, name][0], call)
            launch()
            torch.cuda.synchronize()
            got = [o.float().clone() for o in outs]
            if ref is None:
                ref = got
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            scale = max(float(r.abs().max()) for r in ref)
            results[name] = {"rel_err_vs_as_built": err / scale, "us": [],
                             "sass_main": sass_count(kernel, lib, cuobjdump),
                             **ptxas_report(kernel, logs[kernel, name])}
        islands, island_bytes = {}, 0
        if kernel in HALO_ENTRY:
            for name in calls:
                islands[name], island_bytes = island(
                    torch, _build, kernel, libs[kernel, name],
                    builds[kernel, name][0], ins, outs)
                results[name]["island_us"] = []
        order = list(calls)
        for rnd in range(ROUNDS):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                results[name]["us"].append(device_ms(calls[name], REPS) * 1e3)
                if name in islands:
                    results[name]["island_us"].append(
                        device_ms(islands[name], REPS) * 1e3)
        island_bound_us = island_bytes / HBM_BYTES_PER_S * 1e6
        for name, r in results.items():
            us = float(np.median(r["us"]))
            r.update(median_us=us, x_bound=us / bound_us)
            if "island_us" in r:
                ius = float(np.median(r["island_us"]))
                r.update(island_median_us=ius,
                         island_x_bound=ius / island_bound_us)
            print(f"{kernel:12s} {name:22s} {us:9.2f} us median of {ROUNDS} "
                  f"({min(r['us']):.2f}-{max(r['us']):.2f})  "
                  f"{us / bound_us:6.2f}x bound  rel err vs as built "
                  f"{r['rel_err_vs_as_built']:.2e}  SASS {r['sass_main']}  "
                  f"regs {r.get('registers')}  spills "
                  f"{r.get('spill_store_bytes')}/{r.get('spill_load_bytes')} B  "
                  f"static smem {r.get('static_smem_bytes')} B"
                  + (f"  island x{N_SHARDS} {r['island_median_us']:.2f} us "
                     f"({r['island_x_bound']:.2f}x its bound)"
                     if "island_us" in r else ""), flush=True)
        print(f"{kernel}: shape {SHAPE}, {n_bytes / 1e6:.2f} MB, byte bound "
              f"{bound_us:.2f} us; {card}", flush=True)
        if islands:
            print(f"{kernel}: island of {N_SHARDS} x-slabs, "
                  f"{island_bytes / 1e6:.2f} MB, byte bound "
                  f"{island_bound_us:.2f} us", flush=True)
        report["kernels"][kernel] = {"bytes": n_bytes, "bound_us": bound_us,
                                     "island_bytes": island_bytes,
                                     "island_bound_us": island_bound_us,
                                     "builds": results}
    with open(os.path.join(repo, "perf_out", "port_kernel_variants.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
