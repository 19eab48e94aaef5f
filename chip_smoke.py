#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (openfoam_tpp_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on any fault (nothing is caught):
  1. build every CUDA kernel from csrc/ with nvcc (one process per
     source, all at once) and print the build time;
  2. hold every kernel entry point against its plain PyTorch version on
     the card, at the 112³ flagship shapes, from seeded random inputs
     with zero wall faces; print errors beside tolerances, kernel / plain
     device times (20 launches queued behind a device-side wait, so the
     host's cost per call does not pace them), bytes, bounds and the CUDA
     kernels one call runs (torch.profiler; one for apply-dot and its
     batch form, the MULES fluxes, the projection epilogue and the cheb2
     smoothers); the apply-dot and cheb2 post-dot dots and the div max
     bitwise equal from call to call; the batch-native entry points at the sweep's
     12×12×50×128, and the batch resid also at the V-cycle's coarser
     6×6×25×128 and 3×3×13×128 levels with its diagonal (one case
     bitwise equal to the single-grid kernel);
     then the seven halo entry points of the
     x-sharded step on those inputs cut into 4 x-shards: per shard against
     their plain versions, and the shards composed against the single-grid
     kernels on the whole grid (bitwise, the apply-dot dot and the div
     max included), with the island's time beside the single-grid
     kernel's (the 7-point apply and resid: one launch over the table of
     slabs, beside four launches of one slab each); `fct_iter` and
     `fct_iter_h` (every shard, and the island against the single grid)
     also bitwise equal to plain at spacing (0.002, 0.013, 0.004), where
     1.0f / (float)h is an ulp off the plain versions' (float)(1.0 / h),
     and with a NaN λ among λ and anti of ±0 (NaN where plain has NaN,
     bit for bit elsewhere), and `momentum_rhs(_h)` there to their
     tolerance; then `correct_divmax_h` in its closed-top form on the
     6DoF tutorial tank's operands (phase 8's 80×80×160 chamfered tank
     cut into 4 x-slabs of 20 planes: its apertures and volume fractions,
     seeded fields), every slab bitwise its plain version and the island
     bitwise the single-grid kernel, its 4 launches timed beside their
     bytes and bound;
  3. drive the step path: the flagship single-tank case
     (H0.208/D0.2/R0.004/f1.88, mesh 0.00185, round_to=8 → 112³) through
     `make_step(..., carry_precond=True)` in the bench's configuration,
     SolverControls(use_pallas=True), for N_STEPS steps from rest; then
     the apply_7pt and resid_scaled_7pt calls of every V-cycle level and
     of the CG's true residual (their count from the hierarchy's shapes),
     the CG's apply_dot_7pt calls, the three flux_all calls, the nine
     fct_iter calls, the momentum_rhs call and the correct_divmax call of
     one step from the state reached, captured, each held against its
     plain version, timed again (at most STEP_TIMED_CALLS per level)
     (rows 1–7 on a real step's operands), and so the cheb2_pre_7pt and
     cheb2_post_dot_7pt calls of
     one OFTPP_SMOOTH_SWEEPS=2 step (rows 9a, 9c); then, from
     that state, one run of N_SHORT steps each of that
     configuration, of mom_pallas=False, of OFTPP_FINISH_PALLAS=1, of
     OFTPP_SMOOTH_SWEEPS=2 (the fused cheb2 smoothers, r·z from the exit
     kernel) and of that with OFTPP_FUSED_RZ=0 (each variable set while
     that step is built). Each run checks alpha bounds, Courant, p_iters,
     finiteness and that exactly the kernels of its path were launched
     (counts set to 0 just before it and read just after); with two
     sweeps, that the fused smoothers ran once per V-cycle;
     3b. from that state, N_SHARDED steps each of the unsharded default
     step and of the x-sharded step make_step(spmd=SpmdCtx(S)) with S = 4
     (28×112×112 per shard) and S = 1 (edge halos only), then the 4-shard
     step with OFTPP_SMOOTH_SWEEPS=2: the checks of 3, p_iters within 2
     at every step, 4 shards against 1 after 3 steps within the JAX spmd
     test's bounds, every pair (either sharded step against the unsharded
     one too) after 3 and N_SHARDED steps within phase 4's; and the halo
     kernels alone launched, once per island call for the 7-point apply
     and resid (one launch over the held slabs), S times for the others;
  4. from that state, N_CMP steps with the kernels and N_CMP with every
     entry point swapped for its plain version, for the finish-on step
     with one sweep, with two sweeps and with two sweeps and
     OFTPP_FUSED_RZ=0 (together all eleven entry points); compare alpha,
     u, v, w, p;
  5. drive the case path as a user does: `setup_case` of the flagship
     with duration 0.1 s in a temporary directory, `run_case` on the card
     with OFTPP_SMOOTH_SWEEPS=2, a second `run_case` (resumes, 0 steps)
     and `extract_interface`; checks the launches per V-cycle, the
     fields, the write times, the checkpoints, the probe files and
     `interface_summary.csv`; then `--action profile` on that case
     (N_PROFILE steps from its last checkpoint under torch.profiler):
     `summary.txt` with profile_case's keys and the card's name, a
     Chrome trace holding kernel events, the seven default kernels
     launched;
  6. drive the sweep path at the width the JAX package benches: 128 cases
     of the default tank (H 0.1, D 0.02, mesh 0.002, round_to=4 →
     12×12×50 per case, 921,600 cells in the batch) with the case axis
     trailing. `make_sweep_step` (one geometry, 128 forcing rows) for
     N_SWEEP steps from rest: alpha bounds, Courant, every case's
     p_iters (logged as histograms: the slowest case's per step, and
     every case's), finiteness, and that the batch-native 7-point kernels ran
     while the single-grid 7-point, MULES, momentum and correction
     kernels were launched 0 times. Then the lockstep geometry step
     (`make_geom_sweep_step`, what `runsweep` runs) on the same rows:
     all case times bitwise equal. Beside them the solo step of one such
     case (`use_pallas=True`) times 128: what the sweep replaces. Then,
     from the state the sweep reached, N_CMP steps with the kernels
     against N_CMP with the entry points swapped for their plain versions
     and against N_CMP of the OFTPP_SWEEP_PALLAS=0 step; device ops and
     busy time per step (torch.profiler, 2 steps) from that state;
  7. drive the manager's sweep as a user does: `expand_sweep` → 128 cases
     of mixed geometry (8 freq × 4 R × 2 H × 2 D, duration 0.1 s) in a
     temporary directory, `setup_case` each, `--action runsweep`
     (lockstep): per-case checkpoints at t = 0, 0.05, 0.1 with the f32
     target bitwise, one probe row per step per case, a second `runsweep`
     takes 0 steps; then `--percase-dt` on four fresh cases (0.05 s)
     with a 20 ms ramp: the lax case takes fewer steps than the stiff one;
  8. drive the 6DoF path: the reference tutorial's 20 × 20 × 40 m tank
     in its true shape class, `build_chamfer_tank_geometry(20, 20, 40,
     mesh=0.25, chamfer=0.2, z0=-20)` → 80×80×160, 865,280 fluid cells,
     filled to z = 0, under the gen6DoF sine table (100 rows over 40 s,
     resampled as `build_case_motion` does): `make_step(...,
     SolverControls(use_pallas=True), motion=..., carry_precond=True)`
     N_6DOF steps from rest with phase 3's checks, the seven default
     kernels launched and `correct_divmax` in its closed-top form; from
     that state N_6DOF_FINISH steps of the step built with
     OFTPP_FINISH_PALLAS=1 (the finish kernel stays off in a rotating
     frame); |ω| and |dω| at the end; N_CMP steps with the kernels
     against N_CMP with the entry points swapped for their plain
     versions (phase 4's limits, p after removing each field's fluid
     mean); one step's `correct_divmax` call bitwise equal to its plain
     version and timed beside row 7; then `setup_case_6dof` of that tank
     with duration 0.1 s, `run_case` on the card and a second
     `run_case` (resumes, 0 steps): checkpoints, write times, alpha;
  9. surface tension on the flagship: water's σ = 0.072 N/m against
     air, `make_step(..., SolverControls(use_pallas=True),
     carry_precond=True)` N_CSF steps from rest with phase 3's checks and
     the seven default kernels launched; the CFL dt of every step against
     the capillary bound (never above it; where it binds is logged) and
     the largest |κ| in the interface band; N_GATED steps of the step
     built with OFTPP_FINISH_PALLAS=1 (the finish kernel stays off: κ is
     set); device ops and busy time per step (torch.profiler, 2 steps)
     against the σ = 0 step from the same state; N_CMP steps with the
     kernels against N_CMP with the entry points swapped for their plain
     versions (phase 4's limits);
 10. drive the tiled sweep: `bench.py bench_sweep`'s BENCH_TILED layout,
     128 cases of the default tank at round_to=8 (16×16×50, 4000 fluid
     cells each) merged along x into 2048×16×50 (512,000 fluid cells),
     rows R = 0.002 + 2e-5·i, f = 1.5 + 0.01·i, through
     `make_tiled_sweep_step(..., SolverControls(use_pallas=True))`
     N_TILED steps from rest with phase 3's checks, the seven default
     kernels launched and every block's mass to 1e-3; N_GATED steps of
     the step built with OFTPP_FINISH_PALLAS=1 (off: G varies along x);
     every call of the seven default kernels in one tiled step (the
     V-cycle's apply and resid calls on every level among them) held
     against its plain version and timed at this shape, as in phase 3;
     device ops per step; N_CMP steps kernels against plain; 8 of the
     cases tiled against `make_sweep_step` of the same 8 after
     N_TILED_VS_SWEEP steps from rest (the JAX tiled-sweep test's
     bounds); ms/step, aggregate cell-updates/s and ops per step beside
     phase 6's batched sweep;
 11. the manager's top layer, right after phase 5 and on its case (the
     three snapshots kept): (a) `--action flow` against the reference's
     potential-flow oracle (A_PT 3.146940e-02 m to 1e-7, F 0.056894 to
     1e-6) and its CSV's rows; (b) `--action video`: one frame per
     snapshot, the file written and decoded (PIL for MJPEG AVI, cv2 for
     MP4), render s per frame and the dashboard's s, the host's
     matplotlib / PIL / imageio / cv2 (without matplotlib: the verb's
     refusal, rc 1); (d) `--action run --submit`: the script's #SBATCH
     lines (gpu partition, gpu:1, one node), rc 1 without sbatch, and
     its body run with bash resumes the finished case (0 steps);
     (e) OFTPP_DEBUG_NANS=1 from the t = 0.05 checkpoint in fresh cases
     of duration 0.06 s: the trapped clean run against the untrapped one
     (fields bitwise, else phase 4's limits; p_iters equal; ms/step of
     each), a NaN in an interior u cell raising FloatingPointError at
     step 1 with no later checkpoint, and a NaN operand of the MULES flux
     kernel caught by the kernel hook; (c) the menu in this process on
     piped answers: build the flagship (0.02 s), run it on the card,
     postprocess with flow and interface: rc 0, case.json byte-equal to
     setup_case's, the seven default kernels launched (flux_all 3,
     fct_iter 9, momentum_rhs and correct_divmax 1 per step), phase 3's
     checks on the run. After phase 7 it prints utils/resources.py's
     constants as this run measured them (phase 5's rate and bytes per
     fluid cell, phase 7's per fluid cell of the batch, the card's
     memory);
 12. the device mesh on one card (parallel/sharding.py): (a) phase 6's
     128 cases through the lockstep geometry step farmed by
     `sharded_step` over `make_mesh(4, case_axis=4, devices=[cuda:0] * 4)`
     (32 cases a position, the parts carried on their device from step to
     step), N_FARM steps from rest beside the unfarmed step's run from
     rest: ms/step, device ops and busy ms per step (torch.profiler, 2
     steps), the launches of rows 10a–c, every case's t and dt equal
     across the positions, the farm's fields within phase 4's limits of
     the unfarmed batch's, the slowest case's p_iters histogram equal and
     every case's p_iters within 1 at every step (the batch kernels keep
     their bits in a 32-case part, checked on seeded operands, but the
     plain per-case sums over the cells do not); on a machine with
     more than one card the same farm over distinct cards (else it says
     it did not run); then `--action runsweep --devices 4 --device
     cuda:0` through `cli.main` on phase 7's study against the unfarmed
     `runsweep` of the same cases (checkpoint times bitwise, fields
     within phase 4's limits of each case's scale, the velocities' plus
     the farm's drift measured by scripts/farm_gap.py, FARM_DRIFT·t,
     probe rows and times equal), and the same farm with a planted fault
     (two cases exchange their forcing across positions 0 and 1), which
     that check must refuse;
     (b)
     `run_case(devices=4, device="cuda:0")` on the flagship for 0.1 s:
     the grid rounded as the JAX package rounds it (128×128×112), only
     the halo kernels launched (11a–b once an island, the rest 4 times),
     killed after the first interval and resumed, the final checkpoint
     against the SpmdCtx(1) step through the same advance (bitwise, else
     phase 3b's limits); (c) `run_case(devices="2x2", device="cuda:0")`
     for 0.05 s: 112³, the global step with the seven default kernels
     (flux_all 3, fct_iter 9, momentum_rhs and correct_divmax 1 per
     step), bitwise the same case run alone on the card; then phase 8's
     6DoF tank case with `devices=2` for 0.05 s, the same kernels,
     bitwise the case alone; (d) the x-sharded step over ranks, one
     spawned process a shard (parallel/ranks.py): (i) one rank under
     NCCL on the card, N_RANK1 flagship steps (128×128×112) from rest,
     bitwise the single-process SpmdCtx(1) step with the same launches;
     which gloo collectives take CUDA tensors (two ranks on the card);
     (ii-a) four ranks sharing the card under gloo, N_RANK_STATE steps
     from phase 3's 112³ state (local nx 28 → 14 → 7: the V-cycle
     gathers its second coarse level on every rank) against the
     single-process SpmdCtx(4) step from that state: the first step's
     alpha and dt bitwise, after the last every field within phase 4's
     limits, p_iters within 1, only the halo kernels on every rank;
     (ii) `run_case(devices=4, device="cuda:0", ranks=True)`: four ranks
     sharing the card under gloo on (b)'s case, killed after the first
     interval and resumed from (b)'s own t = 0.05 checkpoint (rank 0
     reads it and scatters it): from that state p_iters within 1 of
     (b)'s at every step and the final checkpoint within phase 3b's
     limits of (b)'s; write times bitwise (b)'s; from rest the p_iters
     and the checkpoints at 0.05 and 0.1 are printed beside (b)'s, not
     held (once a last bit of a CG dot moves a stop, the two runs part at
     the CG tolerance, the size of the flow this early);
     (iii) every rank launched the halo kernels alone (11a-b
     once an island call, the rest once a call), and per step each rank's
     plane exchanges, bytes sent, all-reduces and host seconds in them;
     (iv) with more than one card, the same run over min(count, 4)
     distinct cards under NCCL (else it says it did not run);
     (e) the 6DoF tank and a grid that is not a multiple of 8·N over
     ranks: (i) one NCCL rank on the card, N_RANK1_6DOF steps of phase
     8's tank from phase 8's state under its motion, bitwise the
     single-process SpmdCtx(1) step with the same launches (the halo
     kernels alone; rank, single, single, rank in turns, ms/step of
     each); (ii) `run_case(devices=4, device="cuda:0", ranks=True)` of
     phase 8's case (0.1 s, x-slabs of nxl = 20 planes, which its log
     names), four gloo ranks sharing the card, killed after the first
     interval and resumed from the lone run's t = 0.05 checkpoint, held
     against phase 8's lone run: write times bitwise, case.json and
     6DoF.dat byte-equal, every rank's motion table the case's bit for
     bit, the final checkpoint within phase 3b's limits plus
     FARM_DRIFT·0.05 s, the resumed p_iters within 1 of the one-process
     SpmdCtx(4) step's from that checkpoint (whether equal is printed)
     and printed beside the lone run's; from rest the p_iters and its
     own checkpoints are printed beside the lone run's, not held;
     (iii) phase 5's 112³ case copied with its t = 0 and 0.05
     checkpoints and resumed to 0.1 s by `run_case(devices=4,
     device="cuda:0", ranks=True)` with OFTPP_SMOOTH_SWEEPS=2, as phase 5
     ran it (nxl 28 → 14 → 7, the odd level gathered): the checkpoint's
     grid kept, write times bitwise phase 5's, the final checkpoint
     within phase 3b's limits of phase 5's, the p_iters printed beside
     phase 5's; (iv) for (ii) and (iii), per rank, the launches of rows
     11a–12d and of no single-grid kernel, and per step the plane
     exchanges, bytes sent, all-reduces and host s in them, with the
     run's ms/step with and without writes and its p_iters histogram.

It then prints the `kernels` JSON line, the card's name and power limit,
and last `{"ok": true, "device": {...}}`. It exits non-zero, printing no
result, when no CUDA device is available or the package is missing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types
import unittest.mock as mock

import numpy as np

N_STEPS = 60
N_TIMED = 50          # the last N_TIMED of the N_STEPS are timed
N_SHORT = 20          # steps of each same-state run
N_SHORT_TIMED = 15    # ... the last N_SHORT_TIMED timed
N_SHARDED = 12        # steps of each run of phase 3b
N_SHARDED_TIMED = 8   # ... the last N_SHARDED_TIMED timed
N_CMP = 5
SWEEP_CASES = 128     # the JAX package's sweep bench width
N_SWEEP = 30          # steps of each sweep run from rest
N_SWEEP_TIMED = 20    # ... the last N_SWEEP_TIMED timed
REPS = 20             # kernel timing launches (after 3 warm-up)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak bandwidth
F32_FLOPS = 67e12           # H100 SXM f32, outside the tensor cores
F32_RTOL = 1e-6
BF16_RTOL = 2.0 ** -8
DOT_RTOL = 1e-5
# The momentum RHS plain version sums its ~20 terms in solver/momentum.py's
# order and divides by the spacing through PyTorch's reciprocal; 1e-5 of
# the output scale (the JAX parity test's bound).
MOM_RTOL = 1e-5
# Sharded steps against each other and against the unsharded step, field:
# (kind, limit, floor). 4 shards against 1 (the pair the JAX spmd test
# holds, test_spmd_kernels.py:329-338: the same path, halo exchanges
# against edge fills) after 3 steps: 2e-3 of scale, the CG tolerance's
# order, with a 2e-6 floor for the near-zero velocities of an early
# transient. Every other pair and step count: phase 4's limits (kernels
# against plain versions), for its reasons: the two solves stop on other
# iterates every step, here because the sharded step's coarse levels run
# the plain path, which rounds every bf16 operation where the kernels
# round once (measured 2.2e-3 of w's scale after 3 steps against the
# unsharded step; ROADMAP §3), and an ulp can flip a bf16 λ at the 1000:1
# interface.
JAX_SPMD_TOLS = {k: ("rel", 2e-3, 2e-6) for k in ("alpha", "u", "v", "w", "p")}
SHARD_TOLS = {"alpha": ("abs", 1e-3, 0.0), "u": ("rel", 1e-2, 0.0),
              "v": ("rel", 1e-2, 0.0), "w": ("rel", 1e-2, 0.0),
              "p": ("rel", 1e-4, 0.0)}

# Per-cell f32 operation counts of each function's own arithmetic (for
# the operations half of the bound; the bytes half is the larger for all).
# fct_iter: one R± per cell (~60) and three λ updates (6 each).
# momentum_rhs: per component 3 convection fluxes (mass-flux average, van
# Leer limiter with 2 divisions, MUSCL value, product: ~16 with the
# difference) + 3 viscous and 3 dev2 fluxes (~8 each) + sums: ~105.
# cheb2_*: two 7-point applies (13 each) and the Chebyshev updates between
# them (pre 8, post 9), plus the dot's multiply-add.
FLOPS_PER_CELL = {
    "apply_7pt": 13, "resid_scaled_7pt": 15, "apply_dot_7pt": 15,
    "cheb2_pre_7pt": 34, "cheb2_post_7pt": 35, "cheb2_post_dot_7pt": 37,
    "flux_all": 3 * 30, "fct_iter": 60 + 3 * 6,
    "momentum_rhs": 3 * 105, "correct_divmax": 3 * 6 + 11 + 3,
    "momentum_finish": 3 * 11,
    "apply_7pt_nb": 13, "resid_scaled_7pt_nb": 15, "apply_dot_7pt_nb": 15,
    "apply_7pt_h": 13, "resid_scaled_7pt_h": 15, "apply_dot_7pt_h": 15,
    "flux_all_h": 3 * 30, "fct_iter_h": 60 + 3 * 6,
    "momentum_rhs_h": 3 * 105, "correct_divmax_h": 3 * 6 + 11 + 3,
}
# Kernels of the default configuration; momentum_finish is opt-in.
DEFAULT_PATH = ("apply_7pt", "resid_scaled_7pt", "apply_dot_7pt", "flux_all",
                "fct_iter", "momentum_rhs", "correct_divmax")
FUSED = ("momentum_rhs", "correct_divmax", "momentum_finish")
# Added by OFTPP_SMOOTH_SWEEPS=2: the V-cycle's entry and exit smoothers
# (the exit kernel with CG's r·z, or without it under OFTPP_FUSED_RZ=0).
CHEB2_RZ = ("cheb2_pre_7pt", "cheb2_post_dot_7pt")
CHEB2_NO_RZ = ("cheb2_pre_7pt", "cheb2_post_7pt")
# The manager phase's parameter study: 8 × 4 × 2 × 2 = SWEEP_CASES cases of
# mixed geometry on one 12×12×50 grid. ramp: the 1 s soft start of the
# default 10 s run, not 10% of this cut duration.
MANAGER_SWEEP = {"freq": [1.5 + 0.1 * i for i in range(8)],
                 "R": [0.002, 0.003, 0.004, 0.005], "H": [0.1, 0.08],
                 "D": [0.02, 0.016], "mesh": 0.002, "geo": "flat",
                 "duration": 0.1, "dt": 0.001, "ramp": 1.0}
# The sweep path: only the 7-point family has batch-native kernels.
BATCH_PATH = ("apply_7pt_nb", "resid_scaled_7pt_nb", "apply_dot_7pt_nb")
# The x-sharded step (make_step(spmd=SpmdCtx(S))): only the halo kernels,
# S launches per island call (one for the 7-point apply and resid).
HALO_PATH = ("apply_7pt_h", "resid_scaled_7pt_h", "apply_dot_7pt_h",
             "flux_all_h", "fct_iter_h", "momentum_rhs_h", "correct_divmax_h")
N_SHARDS = 4
# Phase 8: the reference tutorial's 20 × 20 × 40 m tank in its true shape
# class at 0.25 m (80×80×160, 865,280 fluid cells), filled to z = 0.
TANK6DOF = {"Lx": 20.0, "Ly": 20.0, "Lz": 40.0, "mesh": 0.25,
            "chamfer": 0.2, "z0": -20.0}
SHAPE_6DOF, FLUID_6DOF = (80, 80, 160), 865280
DT0_6DOF = 0.01
N_6DOF = 30           # steps from rest
N_6DOF_TIMED = 20     # ... the last N_6DOF_TIMED timed
N_6DOF_FINISH = 5     # steps of the step built with OFTPP_FINISH_PALLAS=1
CHEB_LMAX, CHEB_LMIN = 2.0, 0.10      # SolverKnobs defaults
# Phase 9: the flagship with water's surface tension against air.
SIGMA_WATER = 0.072   # N/m
N_CSF = 30            # steps from rest
N_CSF_TIMED = 20      # ... the last N_CSF_TIMED timed
N_GATED = 5           # steps of a step built with OFTPP_FINISH_PALLAS=1
# Phase 10: bench.py bench_sweep's tiled layout (BENCH_TILED=1): 128 cases
# of the default tank at round_to=8 (16×16×50, 4000 fluid cells each)
# side by side along x, 2048×16×50 and 512,000 fluid cells.
TILED_CASES = 128
TILED_SHAPE, TILED_FLUID = (2048, 16, 50), 512000
N_TILED = 30          # steps from rest
N_TILED_TIMED = 20    # ... the last N_TILED_TIMED timed
TILED_VS_SWEEP = 8    # cases held against the batched sweep ...
N_TILED_VS_SWEEP = 5  # ... over this many steps (the JAX test's)
# The default tank of the sweep phases.
SWEEP_TANK = dict(H=0.1, D=0.02, mesh=0.002, geo="flat")
# Kernels against plain versions over N_CMP steps (phase 4's limits),
# field: (kind, limit). Per call the kernels match their plain versions
# to an ulp (phase 2). Over N_CMP steps an ulp can flip the rounding of a
# bf16 λ (2^-8 of that face's antidiffusive flux), which moves an
# interface cell's alpha by ~1e-4 (limit 1e-3) and, where the density
# jumps 1000:1, its face velocities by a few 1e-3 of the field's scale
# (limit 1e-2); p is held to 1e-4 of its scale, the CG tolerance's order.
CMP_TOLS = {"alpha": ("abs", 1e-3), "u": ("rel", 1e-2), "v": ("rel", 1e-2),
            "w": ("rel", 1e-2), "p": ("rel", 1e-4)}
# The JAX tiled-sweep test's bounds (tests/test_tiled_sweep.py:85-107):
# tiled against batched cases after N_TILED_VS_SWEEP steps.
TILED_TOLS = {"t": 1e-6, "dt": 1e-5, "alpha": 5e-4, "w": 5e-3, "mass": 1e-3}
N_PROFILE = 3         # steps the profile verb traces (after its 3 warm-up)
# Phase 11: the flagship built, run and postprocessed through the menu.
MENU_CASE = dict(H=0.208, D=0.2, mesh=0.00185, geo="flat", R=0.004,
                 freq=1.88, duration=0.02, dt=0.001, ramp=2.0)
TRAP_T_END = 0.15     # the trap's cost: steps from phase 5's t = 0.05 to this
# The stats keys of utils/profiling.py's profile_case (the JAX module's).
PROFILE_KEYS = ("n_steps", "fluid_cells", "grid", "device", "mean_step_ms",
                "p50_step_ms", "p95_step_ms", "cell_updates_per_sec",
                "final_dt", "p_iters", "trace_dir")
# Phase 12: the device mesh on one card. The farm: phase 6's SWEEP_CASES
# cases over FARM_POSITIONS case positions of one card (32 cases each),
# N_FARM steps from rest, not fewer: at 15 the farm's velocity gaps
# exceed phase 4's limits, relative to the smaller early flow (measured
# on an H100).
FARM_POSITIONS = 4
N_FARM = N_SWEEP
N_FARM_TIMED = N_SWEEP_TIMED
# The farm's velocity drift from the unfarmed batch, per second of
# simulated time (m/s per s): hold_runsweep adds FARM_DRIFT·t to phase
# 4's velocity limits. Set from scripts/farm_gap.py on an H100 (phase
# 7's study, seeds 0-3): the parts' per-case CG dots differ in their last
# bits from step 1 on, and at the write times the largest velocity gap
# was 6.95e-4 m/s at 0.05 s and 1.33e-3 at 0.1 s (0.0139 m/s per s at
# most: FARM_DRIFT is 1.44x that); the planted fault of `SwappedParams`
# reached 3.08e-3 at 0.1 s (1.54x FARM_DRIFT·t).
FARM_DRIFT = 0.02
# The flagship case of the x and NxM decompositions (phase 5's, the
# ramp the 20 s run's 2 s): `run_case(devices=4)` rounds nx and ny to
# 8·4 = 32, the JAX package's rounding for its kernel islands.
MESH_CASE = dict(H=0.208, D=0.2, geo="flat", R=0.004, freq=1.88,
                 mesh=0.00185, dt=0.001, ramp=2.0)
SHARDED_RUN_SHAPE = (128, 128, 112)
# Phase 3's flagship grid (112³).
FLAGSHIP = dict(H=0.208, D=0.2, mesh=0.00185, geo="flat", round_to=8)
FLAGSHIP_SHAPE = (112, 112, 112)
# Where two runs' fields differ, the next CFL dt follows the largest
# speed, whose limit is 1e-2 of its scale (SHARD_TOLS, CMP_TOLS): dt is
# held to the same 1e-2 relative. The write times stay bitwise.
DT_TOL = {"dt": ("rel", 1e-2, 0.0)}
# Spacings at which 1.0f / (float)h is an ulp off (float)(1.0 / h), the
# reciprocal PyTorch's CUDA division by a Python float multiplies by
# (the plain versions'); the flagship's 0.00185 is not one of them.
F1_SPACING = (0.002, 0.013, 0.004)
REPLACES = {
    "apply_7pt": "openfoam_tpp_tpu/ops/pallas/seven_point.py:229",
    "resid_scaled_7pt": "openfoam_tpp_tpu/ops/pallas/seven_point.py:258",
    "apply_dot_7pt": "openfoam_tpp_tpu/ops/pallas/seven_point.py:286",
    "cheb2_pre_7pt": "openfoam_tpp_tpu/ops/pallas/seven_point.py:500",
    "cheb2_post_7pt": "openfoam_tpp_tpu/ops/pallas/seven_point.py:523",
    "cheb2_post_dot_7pt": "openfoam_tpp_tpu/ops/pallas/seven_point.py:548",
    "flux_all": "openfoam_tpp_tpu/ops/pallas/mules_flux.py:135",
    "fct_iter": "openfoam_tpp_tpu/ops/pallas/mules_fct.py:217",
    "momentum_rhs": "openfoam_tpp_tpu/ops/pallas/momentum_rhs.py:387",
    "correct_divmax": "openfoam_tpp_tpu/ops/pallas/correction.py:149",
    "momentum_finish": "openfoam_tpp_tpu/ops/pallas/mom_finish.py:88",
    "apply_7pt_nb": "openfoam_tpp_tpu/ops/pallas/seven_point_batch.py:174",
    "resid_scaled_7pt_nb":
        "openfoam_tpp_tpu/ops/pallas/seven_point_batch.py:191",
    "apply_dot_7pt_nb": "openfoam_tpp_tpu/ops/pallas/seven_point_batch.py:215",
    "apply_7pt_h": "openfoam_tpp_tpu/ops/pallas/halo7.py:141",
    "resid_scaled_7pt_h": "openfoam_tpp_tpu/ops/pallas/halo7.py:160",
    "apply_dot_7pt_h": "openfoam_tpp_tpu/ops/pallas/halo7.py:179",
    "flux_all_h": "openfoam_tpp_tpu/ops/pallas/mules_flux.py:179",
    "fct_iter_h": "openfoam_tpp_tpu/ops/pallas/mules_fct.py:261",
    "momentum_rhs_h": "openfoam_tpp_tpu/ops/pallas/momentum_rhs.py:463",
    "correct_divmax_h": "openfoam_tpp_tpu/ops/pallas/correction.py:219",
}
SOURCE = {
    "apply_7pt": "openfoam_tpp_tpu_torch/csrc/seven_point.cu",
    "resid_scaled_7pt": "openfoam_tpp_tpu_torch/csrc/seven_point.cu",
    "apply_dot_7pt": "openfoam_tpp_tpu_torch/csrc/seven_point.cu",
    "cheb2_pre_7pt": "openfoam_tpp_tpu_torch/csrc/cheb2.cu",
    "cheb2_post_7pt": "openfoam_tpp_tpu_torch/csrc/cheb2.cu",
    "cheb2_post_dot_7pt": "openfoam_tpp_tpu_torch/csrc/cheb2.cu",
    "flux_all": "openfoam_tpp_tpu_torch/csrc/mules_flux.cu",
    "fct_iter": "openfoam_tpp_tpu_torch/csrc/mules_fct.cu",
    "momentum_rhs": "openfoam_tpp_tpu_torch/csrc/momentum_rhs.cu",
    "correct_divmax": "openfoam_tpp_tpu_torch/csrc/correction.cu",
    "momentum_finish": "openfoam_tpp_tpu_torch/csrc/mom_finish.cu",
    "apply_7pt_nb": "openfoam_tpp_tpu_torch/csrc/seven_point_batch.cu",
    "resid_scaled_7pt_nb": "openfoam_tpp_tpu_torch/csrc/seven_point_batch.cu",
    "apply_dot_7pt_nb": "openfoam_tpp_tpu_torch/csrc/seven_point_batch.cu",
    "apply_7pt_h": "openfoam_tpp_tpu_torch/csrc/seven_point.cu",
    "resid_scaled_7pt_h": "openfoam_tpp_tpu_torch/csrc/seven_point.cu",
    "apply_dot_7pt_h": "openfoam_tpp_tpu_torch/csrc/seven_point.cu",
    "flux_all_h": "openfoam_tpp_tpu_torch/csrc/mules_flux.cu",
    "fct_iter_h": "openfoam_tpp_tpu_torch/csrc/mules_fct.cu",
    "momentum_rhs_h": "openfoam_tpp_tpu_torch/csrc/momentum_rhs.cu",
    "correct_divmax_h": "openfoam_tpp_tpu_torch/csrc/correction.cu",
}


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def environ(**values):
    """Set environment variables for the block (the port reads its OFTPP_*
    variables when a step is built)."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def max_err(got, ref):
    """(max abs error, scale) between two tensors or tuples of tensors."""
    if not isinstance(got, (tuple, list)):
        got, ref = (got,), (ref,)
    err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.float().abs().max()) for r in ref)
    return err, scale


def nan_and_zeros(ts, nan_at=None):
    """Copies of the tensors `ts` with +0 and −0 on a quarter of the cells
    each (a fixed pattern), and with `nan_at` a NaN in the first of them
    at that index."""
    out = []
    for t in ts:
        t = t.clone()
        flat = t.view(-1)
        flat[1::4] = 0.0
        flat[3::4] = -0.0
        out.append(t)
    if nan_at is not None:
        out[0][nan_at] = float("nan")
    return tuple(out)


def same_bits(got, ref):
    """Tuples of tensors with NaN at the same places and every other
    value equal bit for bit (signed zeros included)."""
    import torch

    for g, r in zip(got, ref):
        nan = torch.isnan(g)
        as_int = torch.int32 if g.dtype == torch.float32 else torch.int16
        if not (g.dtype == r.dtype and torch.equal(nan, torch.isnan(r))
                and torch.equal(g.view(as_int)[~nan], r.view(as_int)[~nan])):
            return False
    return True


# Entry points whose every call is one CUDA kernel launch (checked).
ONE_LAUNCH = ("apply_dot_7pt", "apply_dot_7pt_h", "apply_dot_7pt_nb",
              "apply_7pt_h", "resid_scaled_7pt_h",
              "flux_all", "flux_all_h",
              "correct_divmax", "correct_divmax_h", "cheb2_pre_7pt",
              "cheb2_post_7pt", "cheb2_post_dot_7pt")
# The host API calls that launch a kernel, as the profiler names them.
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx")


def cuda_launches(name, fn):
    """CUDA kernels one call of `fn` runs (torch.profiler, after a warm-up
    call): the larger of the trace's device events and its kernel-launch
    API calls; must be 1 for ONE_LAUNCH. The device events alone can
    miss a kernel: on the chip machine a trace in which CUPTI requested
    a new activity buffer during the call held the launch but not the
    kernel (logged when it happens)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    n_dev = sum(1 for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA)
    n_api = sum(1 for e in events if e.name in LAUNCH_APIS)
    if n_dev != n_api:
        log(f"  {name}: {n_dev} device event(s) in the trace, {n_api} "
            f"kernel launch(es); host events {[e.name for e in events]}")
    n = max(n_dev, n_api)
    if name in ONE_LAUNCH and n != 1:
        raise AssertionError(f"{name}: one call ran {n} CUDA kernels, not 1")
    return n


def make_check(rows, n_cells):
    """`check(name, variant, main, kern, plain, ins, outs, tol)`: hold one
    kernel variant against its plain version, time both, compute its bound
    from the operands, log, raise on disagreement, and keep the row of a
    main-path variant in `rows`."""
    import torch

    from openfoam_tpp_tpu_torch.utils.devtime import device_ms

    def check(name, variant, main, kern, plain, ins, outs, tol):
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err, scale = max_err(got, ref)
        rel = err / max(scale, 1e-30)
        ms, plain_ms = device_ms(kern, REPS), device_ms(plain, REPS)
        b = nbytes(*ins) + nbytes(*outs)
        t_bytes = b / HBM_BYTES_PER_S * 1e3
        t_ops = FLOPS_PER_CELL[name] * n_cells / F32_FLOPS * 1e3
        ok = rel <= tol
        n_launch = cuda_launches(name, kern) if main else None
        log(f"  {name:17s} {variant:22s} max_abs_err={err:.3e} rel={rel:.3e} "
            f"tol={tol:.1e} {'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  bytes {b / 1e6:.2f} MB  "
            f"bound {max(t_bytes, t_ops):.4f} ms"
            + (f"  CUDA launches per call {n_launch}" if main else ""))
        if not ok:
            raise AssertionError(f"{name} {variant}: kernel disagrees with "
                                 f"its plain version ({rel:.3e} > {tol:.1e})")
        if main:
            rows[name] = {
                "name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None, "variant": variant, "bytes": b,
                "cuda_launches_per_call": n_launch,
            }

    return check


def phase_kernels(shape, spacing, dev):
    """Each entry point against its plain version at `shape`; returns the
    measured rows of the main-path variants keyed by kernel name."""
    import torch

    from openfoam_tpp_tpu_torch.ops.kernels import correction as ck
    from openfoam_tpp_tpu_torch.ops.kernels import mom_finish as mfk
    from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as mrk
    from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as mf
    from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as mfx
    from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp

    rng = np.random.default_rng(2024)
    n_cells = int(np.prod(shape))

    def arr(lo=None, hi=None, dtype=torch.float32):
        a = (rng.standard_normal(shape) if lo is None
             else rng.uniform(lo, hi, shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev).to(dtype)

    def weights(dtype):
        w = [arr(0.05, 0.3, dtype) for _ in range(3)]
        w[0][0] = 0
        w[1][:, 0] = 0
        w[2][:, :, 0] = 0
        return tuple(w)

    rows = {}
    check = make_check(rows, n_cells)

    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        tol = F32_RTOL if tag == "f32" else BF16_RTOL
        p, b = arr(dtype=dtype), arr(dtype=dtype)
        w = weights(dtype)
        d = arr(1.5, 2.5, dtype)
        # Main-path variants: f32 unit apply (CG true residual), bf16 unit
        # resid (V-cycle top level), f32 apply+dot (CG curvature step).
        for diag in (None, d):
            v = f"{tag} {'diag' if diag is not None else 'unit'}"
            check("apply_7pt", v, tag == "f32" and diag is None,
                  lambda: sp.apply_7pt(p, w, diag),
                  lambda: sp.apply_7pt_plain(p, w, diag),
                  (p, *w, diag), (p,), tol)
            check("resid_scaled_7pt", v, tag == "bf16" and diag is None,
                  lambda: sp.resid_scaled_7pt(p, w, diag, b),
                  lambda: sp.resid_scaled_7pt_plain(p, w, diag, b),
                  (p, *w, diag, b), (p,), tol)
        ap_k, dot_k = sp.apply_dot_7pt(p, w)
        ap_p, dot_p = sp.apply_dot_7pt_plain(p, w)
        dot_again = sp.apply_dot_7pt(p, w)[1]
        derr = abs(float(dot_k) - float(dot_p)) / max(abs(float(dot_p)), 1e-30)
        same = float(dot_again) == float(dot_k)
        log(f"  apply_dot_7pt     {tag} dot kernel {float(dot_k)!r} plain "
            f"{float(dot_p)!r} rel_err={derr:.3e} tol={DOT_RTOL:.1e}; again "
            f"{'bitwise equal' if same else 'DIFFERS'}; Â·p "
            f"{'bitwise' if torch.equal(ap_k, ap_p) else 'not bitwise'} "
            "equal to plain")
        if derr > DOT_RTOL or not same:
            raise AssertionError(f"apply_dot_7pt {tag}: dot disagrees or "
                                 "does not repeat")
        check("apply_dot_7pt", f"{tag} unit", tag == "f32",
              lambda: sp.apply_dot_7pt(p, w)[0],
              lambda: sp.apply_dot_7pt_plain(p, w)[0], (p, *w), (p,), tol)
        # The fused cheb2 smoothers. Main-path variants: the bf16 cycle,
        # whose exit kernels store f32 (the hand-off to CG).
        cheb = (CHEB_LMAX, CHEB_LMIN)
        same = all(torch.equal(g, r) for g, r in zip(
            sp.cheb2_pre_7pt(b, w, *cheb), sp.cheb2_pre_7pt_plain(b, w, *cheb)))
        log(f"  cheb2_pre_7pt     {tag} x, r {'bitwise' if same else 'not bitwise'}"
            " equal to plain")
        check("cheb2_pre_7pt", tag, tag == "bf16",
              lambda: sp.cheb2_pre_7pt(b, w, *cheb),
              lambda: sp.cheb2_pre_7pt_plain(b, w, *cheb),
              (b, *w), (b, b), tol)
        outs = [(None, tag)] + ([(torch.float32, "bf16 → f32")]
                                if tag == "bf16" else [])
        for out, v in outs:
            main = tag == "bf16" and out is not None
            z_tol = tol if out is None else F32_RTOL
            z_k, dot_k = sp.cheb2_post_dot_7pt(p, b, w, *cheb, out_dtype=out)
            z_p, dot_p = sp.cheb2_post_dot_7pt_plain(p, b, w, *cheb,
                                                     out_dtype=out)
            dot_again = sp.cheb2_post_dot_7pt(p, b, w, *cheb,
                                              out_dtype=out)[1]
            derr = (abs(float(dot_k) - float(dot_p))
                    / max(abs(float(dot_p)), 1e-30))
            same = float(dot_again) == float(dot_k)
            log(f"  cheb2_post_dot_7pt {v} dot kernel {float(dot_k)!r} plain "
                f"{float(dot_p)!r} rel_err={derr:.3e} tol={DOT_RTOL:.1e}; "
                f"again {'bitwise equal' if same else 'DIFFERS'}; z "
                f"{'bitwise' if torch.equal(z_k, z_p) else 'not bitwise'} "
                "equal to plain")
            if derr > DOT_RTOL or not same:
                raise AssertionError(f"cheb2_post_dot_7pt {v}: dot disagrees "
                                     "or does not repeat")
            if not torch.equal(z_k, sp.cheb2_post_7pt(p, b, w, *cheb,
                                                      out_dtype=out)):
                raise AssertionError(f"cheb2_post_dot_7pt {v}: z is not "
                                     "cheb2_post_7pt's")
            check("cheb2_post_7pt", v, main,
                  lambda: sp.cheb2_post_7pt(p, b, w, *cheb, out_dtype=out),
                  lambda: sp.cheb2_post_7pt_plain(p, b, w, *cheb,
                                                  out_dtype=out),
                  (p, b, *w), (z_k,), z_tol)
            check("cheb2_post_dot_7pt", v, main,
                  lambda: sp.cheb2_post_dot_7pt(p, b, w, *cheb,
                                                out_dtype=out)[0],
                  lambda: sp.cheb2_post_dot_7pt_plain(p, b, w, *cheb,
                                                      out_dtype=out)[0],
                  (p, b, *w), (z_k,), z_tol)

    alpha = arr(0, 1)
    phis = tuple(1e-3 * arr() for _ in range(3))
    for tag, dt in (("bf16 uc/anti", torch.bfloat16), ("f32", torch.float32)):
        ucs = tuple((1e-3 * arr()).to(dt) for _ in range(3))
        anti_dt = dt if dt == torch.bfloat16 else None
        outs = [alpha] * 3 + [ucs[0]] * 3
        check("flux_all", tag, dt == torch.bfloat16,
              lambda: sum(mfx.flux_all(alpha, phis, ucs, anti_dt), ()),
              lambda: sum(mfx.flux_all_plain(alpha, phis, ucs, anti_dt), ()),
              (alpha, *phis, *ucs), outs,
              BF16_RTOL if dt == torch.bfloat16 else F32_RTOL)

    al = arr(0, 1)
    amax = torch.clamp(al + arr(0, 0.2), max=1.0)
    amin = torch.clamp(al - arr(0, 0.2), min=0.0)
    dt_iv = arr(1e-4, 2e-4)
    fct_spacing = (0.00185, 0.00185, 0.00185)
    for tag, dt in (("bf16 λ/anti", torch.bfloat16), ("f32", torch.float32)):
        lams = tuple(arr(0, 1, dt) for _ in range(3))
        antis = tuple((1e-3 * arr()).to(dt) for _ in range(3))
        for h, v in ((fct_spacing, tag), (F1_SPACING, f"{tag} h F1")):
            check("fct_iter", v, dt == torch.bfloat16 and h == fct_spacing,
                  lambda: mf.fct_iter(lams, antis, al, amax, amin, dt_iv, h),
                  lambda: mf.fct_iter_plain(lams, antis, al, amax, amin,
                                            dt_iv, h),
                  (*lams, *antis, al, amax, amin, dt_iv), lams,
                  BF16_RTOL if dt == torch.bfloat16 else F32_RTOL)
        # F1: at spacings where 1.0f / (float)h is an ulp off (float)(1.0
        # / h), the reciprocal the plain version multiplies by, λ is
        # bitwise equal to plain all the same.
        same = all(map(torch.equal, mf.fct_iter(lams, antis, al, amax, amin,
                                                dt_iv, F1_SPACING),
                       mf.fct_iter_plain(lams, antis, al, amax, amin, dt_iv,
                                         F1_SPACING)))
        log(f"  fct_iter          {tag} at h {F1_SPACING}: λ "
            f"{'bitwise equal' if same else 'NOT bitwise equal'} to plain")
        if not same:
            raise AssertionError(f"fct_iter {tag}: not bitwise equal to its "
                                 f"plain version at h {F1_SPACING}")
        # A NaN λ among λ and anti of ±0: NaN where the plain version has
        # it (the TPU kernel's clips keep a NaN), bit for bit elsewhere.
        nan_in = (*nan_and_zeros(lams, tuple(n // 2 for n in shape)),
                  *nan_and_zeros(antis), al, amax, amin, dt_iv, F1_SPACING)
        nan_in = (nan_in[:3], nan_in[3:6], *nan_in[6:])
        got = mf.fct_iter(*nan_in)
        same = same_bits(got, mf.fct_iter_plain(*nan_in))
        n_nan = sum(int(torch.isnan(g).sum()) for g in got)
        log(f"  fct_iter          {tag} NaN λ, ±0 operands: {n_nan} NaN "
            f"faces, {'NaN and bits as plain' if same else 'DIFFERS'}")
        if not (same and n_nan):
            raise AssertionError(f"fct_iter {tag}: a NaN operand gives "
                                 "other NaNs or bits than plain")

    # The fused momentum / projection kernels: physical inputs, whose wall
    # faces (velocities, mass fluxes, apertures) are zero.
    nx, ny, nz = shape

    def faces(lo=-1.0, hi=1.0, open_top=True):
        f = [torch.from_numpy(rng.uniform(lo, hi, s).astype(np.float32)).to(dev)
             for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]
        f[0][0], f[0][-1], f[1][:, 0], f[1][:, -1], f[2][:, :, 0] = 0, 0, 0, 0, 0
        if not open_top:
            f[2][:, :, -1] = 0
        return tuple(f)

    vel, rp = faces(), faces()
    mu, div_u = arr(1e-5, 2e-3), 0.1 * arr(-1, 1)
    for dev2 in (True, False):
        check("momentum_rhs", f"dev2 {'on' if dev2 else 'off'}", dev2,
              lambda: mrk.momentum_rhs(*vel, rp, mu, div_u, spacing, dev2),
              lambda: mrk.momentum_rhs_plain(*vel, rp, mu, div_u, spacing, dev2),
              (*vel, *rp, mu, div_u if dev2 else None), vel, MOM_RTOL)
    check("momentum_rhs", "dev2 on, h F1", False,
          lambda: mrk.momentum_rhs(*vel, rp, mu, div_u, F1_SPACING),
          lambda: mrk.momentum_rhs_plain(*vel, rp, mu, div_u, F1_SPACING),
          (*vel, *rp, mu, div_u), vel, MOM_RTOL)

    dp, vfrac = arr(-50, 50), arr(0, 1)
    vfrac[vfrac < 0.1] = 0
    beta = faces(8e-4, 1e-3)
    rho = arr(1, 998)
    topo = (arr(0, 1)[:, :, 0] > 0.3).float().contiguous()
    dt0 = torch.tensor(3.7e-3, device=dev)
    for open_top in (True, False):
        aps = faces(0.0, 1.0, open_top)
        for a in aps:
            a[a < 0.2] = 0
        args = (dp, *vel, beta, *aps, vfrac, topo, rho, dt0, spacing)
        tag = f"open top {'on' if open_top else 'off'}"
        got = ck.correct_divmax(*args, open_top=open_top)
        ref = ck.correct_divmax_plain(*args, open_top=open_top)
        again = ck.correct_divmax(*args, open_top=open_top)[3]
        derr = (abs(float(got[3]) - float(ref[3]))
                / max(abs(float(ref[3])), 1e-30))
        same = float(again) == float(got[3])
        log(f"  correct_divmax    {tag} div_max kernel {float(got[3])!r} plain "
            f"{float(ref[3])!r} rel_err={derr:.3e} tol={F32_RTOL:.1e}; again "
            f"{'bitwise equal' if same else 'DIFFERS'}; u_c, v_c, w_c, "
            f"div_max {'bitwise' if all(map(torch.equal, got, ref)) else 'not bitwise'}"
            " equal to plain")
        if derr > F32_RTOL or not same:
            raise AssertionError(f"correct_divmax {tag}: div_max disagrees "
                                 "or does not repeat")
        check("correct_divmax", tag, open_top,
              lambda: ck.correct_divmax(*args, open_top=open_top)[:3],
              lambda: ck.correct_divmax_plain(*args, open_top=open_top)[:3],
              (dp, *vel, *beta, *aps, vfrac, rho[:, :, -1],
               topo if open_top else None), vel, F32_RTOL)

    aps = faces(0.0, 1.0)
    for a in aps:
        a[a < 0.25] = 0
    vc = faces(-50, 50)
    vc = (vc[0][:-1].contiguous(), vc[1], vc[2])
    ro, rn = arr(1, 998), arr(1, 998)
    G = torch.tensor([0.31, -0.12, -9.81], device=dev)
    dt1 = torch.tensor(2.9e-3, device=dev)
    check("momentum_finish", "f32", True,
          lambda: mfk.momentum_finish(*vel, vc, ro, rn, *aps, dt1, G),
          lambda: mfk.momentum_finish_plain(*vel, vc, ro, rn, *aps, dt1, G),
          (*vel, *vc, ro, rn, *aps), vel, F32_RTOL)
    return rows


def phase_batch_kernels(shape4, dev):
    """The three batch-native entry points at the sweep's batched shape,
    f32 and bf16, unit and stored diagonal: against their plain versions
    (tolerances as the single-grid family's) and, bitwise, against the
    single-grid kernel looped over the cases. Returns the rows of the
    main-path variants."""
    import torch

    from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp

    rng = np.random.default_rng(2025)
    n_cases = shape4[3]

    def arr(lo=None, hi=None, dtype=torch.float32):
        a = (rng.standard_normal(shape4) if lo is None
             else rng.uniform(lo, hi, shape4)).astype(np.float32)
        return torch.from_numpy(a).to(dev).to(dtype)

    def per_case(fn, *args):
        """`fn` on each case's contiguous operands, restacked."""
        outs = [fn(*(None if a is None else a[..., i].contiguous()
                     for a in args)) for i in range(n_cases)]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack([o[k] for o in outs], -1)
                         for k in range(len(outs[0])))
        return torch.stack(outs, -1)

    rows = {}
    check = make_check(rows, int(np.prod(shape4)))
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        tol = F32_RTOL if tag == "f32" else BF16_RTOL
        p, b = arr(dtype=dtype), arr(dtype=dtype)
        w = [arr(0.05, 0.3, dtype) for _ in range(3)]
        w[0][0] = 0
        w[1][:, 0] = 0
        w[2][:, :, 0] = 0
        w = tuple(w)
        d = arr(1.5, 2.5, dtype)
        # Main-path variants as for the single-grid family: f32 unit apply
        # (CG true residual), bf16 unit resid (V-cycle top level), f32
        # apply+dot (CG curvature step).
        for diag in (None, d):
            v = f"{tag} {'diag' if diag is not None else 'unit'}"
            check("apply_7pt_nb", v, tag == "f32" and diag is None,
                  lambda: sp.apply_7pt_nb(p, w, diag),
                  lambda: sp.apply_7pt_plain(p, w, diag),
                  (p, *w, diag), (p,), tol)
            check("resid_scaled_7pt_nb", v, tag == "bf16" and diag is None,
                  lambda: sp.resid_scaled_7pt_nb(p, w, diag, b),
                  lambda: sp.resid_scaled_7pt_plain(p, w, diag, b),
                  (p, *w, diag, b), (p,), tol)
            looped = (
                per_case(lambda q, x, y, z, dg: sp.apply_7pt(q, (x, y, z), dg),
                         p, *w, diag),
                per_case(lambda q, x, y, z, dg, r: sp.resid_scaled_7pt(
                    q, (x, y, z), dg, r), p, *w, diag, b))
            batch = (sp.apply_7pt_nb(p, w, diag),
                     sp.resid_scaled_7pt_nb(p, w, diag, b))
            if not all(torch.equal(g, r) for g, r in zip(batch, looped)):
                raise AssertionError(f"batch kernels {v}: a case differs from "
                                     "the single-grid kernel on that case")
        ap_k, dots_k = sp.apply_dot_7pt_nb(p, w)
        ap_p, dots_p = sp.apply_dot_7pt_plain(p, w)
        ap_l, dots_l = per_case(lambda q, x, y, z: sp.apply_dot_7pt(
            q, (x, y, z)), p, *w)
        derr = float(((dots_k - dots_p).abs() / dots_p.abs()).max())
        lerr = float(((dots_k - dots_l).abs() / dots_l.abs()).max())
        log(f"  apply_dot_7pt_nb  {tag} per-case dots {tuple(dots_k.shape)}: "
            f"max rel_err vs plain {derr:.3e}, vs the single-grid kernel per "
            f"case {lerr:.3e}, tol={DOT_RTOL:.1e}")
        if (max(derr, lerr) > DOT_RTOL or not torch.equal(ap_k, ap_l)
                or tuple(dots_k.shape) != (n_cases,)):
            raise AssertionError(f"apply_dot_7pt_nb {tag}: disagrees")
        check("apply_dot_7pt_nb", f"{tag} unit", tag == "f32",
              lambda: sp.apply_dot_7pt_nb(p, w)[0],
              lambda: sp.apply_dot_7pt_plain(p, w)[0], (p, *w),
              (p, dots_k), tol)
    log(f"  every case of the batch kernels equals the single-grid kernel on "
        f"that case, bitwise ({n_cases} cases, f32 and bf16)")
    # The V-cycle's two coarser levels of the sweep, where most of row
    # 10b's launches run: bf16 with the stored diagonal, against the plain
    # version and, bitwise, against the single-grid kernel on one case.
    from openfoam_tpp_tpu_torch.utils.devtime import device_ms

    levels = {}
    for nx, ny, nz in ((6, 6, 25), (3, 3, 13)):
        lvl = (nx, ny, nz, n_cases)
        at = lambda lo=None, hi=None: torch.from_numpy(
            (rng.standard_normal(lvl) if lo is None
             else rng.uniform(lo, hi, lvl)).astype(np.float32)
        ).to(dev).to(torch.bfloat16)
        p, b, d = at(), at(), at(1.5, 2.5)
        w = [at(0.05, 0.3) for _ in range(3)]
        w[0][0], w[1][:, 0], w[2][:, :, 0] = 0, 0, 0
        kern = lambda: sp.resid_scaled_7pt_nb(p, w, d, b)
        plain = lambda: sp.resid_scaled_7pt_plain(p, w, d, b)
        got = kern()
        err, scale = max_err(got, plain())
        i = n_cases - 1
        lane = lambda t: t[..., i].contiguous()
        same = torch.equal(got[..., i], sp.resid_scaled_7pt(
            lane(p), [lane(x) for x in w], lane(d), lane(b)))
        ms, plain_ms = device_ms(kern, REPS), device_ms(plain, REPS)
        bound = nbytes(p, *w, d, b, got) / HBM_BYTES_PER_S * 1e3
        tag = "x".join(map(str, lvl))
        log(f"  resid_scaled_7pt_nb {tag} bf16 diag max_abs_err={err:.3e} "
            f"rel={err / scale:.3e} tol={BF16_RTOL:.1e}; case {i} "
            f"{'bitwise' if same else 'NOT bitwise'} equal to the single-grid "
            f"kernel  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
            f"{bound:.4f} ms")
        if err / scale > BF16_RTOL or not same:
            raise AssertionError(f"resid_scaled_7pt_nb {tag}: disagrees")
        levels[tag] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound}
    rows["resid_scaled_7pt_nb"]["levels"] = levels
    return rows


def phase_halo_kernels(shape, spacing, dev, n_shards=N_SHARDS):
    """The seven halo entry points of the x-sharded step at `shape` cut
    into `n_shards` x-slabs, in every dtype their route uses: per shard
    against the plain version (each row's single-grid tolerance), and the
    island (the shards composed into one tensor) against the single-grid
    kernel on the whole grid, bitwise for every elementwise output, the
    dot and the div max to 1e-6 relative. Times the S launches of a row
    on exchanged halos (`ms`; for apply and resid the one launch over a
    table of the S slabs, with the S launches of a table of one slab
    beside it), the S plain calls, the island with its exchanges and the
    single-grid kernel. Returns the main-path rows."""
    import torch

    from openfoam_tpp_tpu_torch.ops.kernels import correction as ck
    from openfoam_tpp_tpu_torch.ops.kernels import halo7
    from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as mrk
    from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as mf
    from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as mfx
    from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp
    from openfoam_tpp_tpu_torch.parallel import spmd as sm
    from openfoam_tpp_tpu_torch.utils.devtime import device_ms

    ctx = sm.SpmdCtx(n_shards)
    rng = np.random.default_rng(2026)
    n_cells = int(np.prod(shape))
    nx, ny, nz = shape
    rows = {}

    def arr(lo=None, hi=None, dtype=torch.float32):
        a = (rng.standard_normal(shape) if lo is None
             else rng.uniform(lo, hi, shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev).to(dtype)

    def faces(lo=-1.0, hi=1.0, open_top=True):
        f = [torch.from_numpy(rng.uniform(lo, hi, sh).astype(np.float32)).to(dev)
             for sh in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]
        f[0][0], f[0][-1], f[1][:, 0], f[1][:, -1], f[2][:, :, 0] = 0, 0, 0, 0, 0
        if not open_top:
            f[2][:, :, -1] = 0
        return tuple(f)

    def flat(out):
        """Outputs as a flat tuple of tensors."""
        if isinstance(out, torch.Tensor):
            return (out,)
        return tuple(t for o in out for t in flat(o))

    def scalar_err(got, ref):
        return max((abs(float(g) - float(r)) / max(abs(float(r)), 1e-30)
                    for g, r in zip(got, ref)), default=0.0)

    def check(name, variant, main, shards, island, single, tol, n_scalar=0,
              scalar_tol=F32_RTOL, scalar_bitwise=False, table=None):
        """`shards`: per shard (kernel call, plain call, operands). The
        last `n_scalar` outputs are 0-d scalars (the island reduces them
        over the shards): per shard within `scalar_tol` of the plain
        version's, and within F32_RTOL of the single-grid kernel's (with
        `scalar_bitwise`, equal to it). `table`: (kernel call, plain call)
        of the island entry point over all S slabs, held against the
        plain versions slab by slab; it is then the row's kernel (timed,
        its CUDA launches counted), the S per-shard launches timed
        beside it."""
        err, scale, p_err = 0.0, 0.0, 0.0
        for kern, plain, _ in shards:
            got, ref = flat(kern()), flat(plain())
            n_el = len(got) - n_scalar
            e, sc = max_err(got[:n_el], ref[:n_el])
            err, scale = max(err, e), max(scale, sc)
            p_err = max(p_err, scalar_err(got[n_el:], ref[n_el:]))
        if table is not None:
            e, sc = max_err(flat(table[0]()), flat(table[1]()))
            err, scale = max(err, e), max(scale, sc)
        rel = err / max(scale, 1e-30)
        got, ref = flat(island()), flat(single())
        torch.cuda.synchronize()
        n_el = len(got) - n_scalar
        bitwise = all(torch.equal(g, r) for g, r in zip(got[:n_el], ref[:n_el]))
        s_err = scalar_err(got[n_el:], ref[n_el:])
        if scalar_bitwise:
            bitwise = bitwise and all(float(g) == float(r) for g, r in
                                      zip(got[n_el:], ref[n_el:]))
        shards_ms = device_ms(lambda: [k() for k, _, _ in shards], REPS)
        ms = shards_ms if table is None else device_ms(table[0], REPS)
        plain_ms = device_ms(lambda: [p() for _, p, _ in shards], REPS)
        island_ms, single_ms = device_ms(island, REPS), device_ms(single, REPS)
        b = sum(nbytes(*ops) for _, _, ops in shards)
        t_bytes = b / HBM_BYTES_PER_S * 1e3
        t_ops = FLOPS_PER_CELL[name] * n_cells / F32_FLOPS * 1e3
        ok = (rel <= tol and bitwise and s_err <= F32_RTOL
              and p_err <= scalar_tol)
        n_launch = (cuda_launches(name, shards[0][0] if table is None
                                  else table[0]) if main else None)
        log(f"  {name:18s} {variant:14s} x{n_shards}: per shard max_abs_err="
            f"{err:.3e} rel={rel:.3e} tol={tol:.1e}"
            + (f", scalar rel_err={p_err:.3e} tol={scalar_tol:.1e}"
               if n_scalar else "")
            + f"; island vs single-grid {'bitwise' if bitwise else 'DIFFERS'}"
            + (f", scalar rel_err={s_err:.3e} tol={F32_RTOL:.1e}"
               if n_scalar else "")
            + f" {'ok' if ok else 'FAIL'}  kernels {ms:.4f} ms"
            + (f" (one launch; {n_shards} launches of one slab "
               f"{shards_ms:.4f} ms)" if table is not None else "")
            + f"  plain {plain_ms:.4f} ms  island {island_ms:.4f} ms  "
            f"single-grid {single_ms:.4f} ms  bytes {b / 1e6:.2f} MB  bound "
            f"{max(t_bytes, t_ops):.4f} ms"
            + (f"  CUDA launches per {'island' if table else 'shard'} call "
               f"{n_launch}" if main else ""))
        if not ok:
            raise AssertionError(f"{name} {variant}: halo kernel disagrees "
                                 f"(plain {rel:.3e}, island bitwise "
                                 f"{bitwise}, scalar {s_err:.3e})")
        if main:
            rows[name] = {
                "name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None, "variant": f"{variant} x{n_shards}",
                "bytes": b, "island_ms": island_ms,
                "single_grid_ms": single_ms, "scalar_rel_err": s_err,
                "cuda_launches_per_call": n_launch,
                "shard_launches_ms": shards_ms if table is not None else None}

    held = list(ctx.held)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        tol = F32_RTOL if tag == "f32" else BF16_RTOL
        p, b, d = arr(dtype=dtype), arr(dtype=dtype), arr(1.5, 2.5, dtype)
        w = [arr(0.05, 0.3, dtype) for _ in range(3)]
        w[0][0], w[1][:, 0], w[2][:, :, 0] = 0, 0, 0
        w = tuple(w)
        ps, bs, ds = ctx.split(p), ctx.split(b), ctx.split(d)
        ws = [ctx.split(x) for x in w]
        halos = sm.exchange_halo(ps, 1, ctx)
        wx_hi = sm.exchange_hi(ws[0], 1, ctx)
        hw = [(*halos[i], wx_hi[i], tuple(x[i] for x in ws)) for i in held]
        # The island entry points' table: the columns of hw, one list each.
        cols = [[h[c] for h in hw] for c in range(4)]
        for diag in (None, d):
            v = f"{tag} {'diag' if diag is not None else 'unit'}"
            dg = (lambda i: None) if diag is None else (lambda i: ds[i])
            dgs = None if diag is None else ds
            check("apply_7pt_h", v, tag == "f32" and diag is None,
                  [(lambda i=i: halo7.apply_7pt_h(ps[i], *hw[i], dg(i)),
                    lambda i=i: halo7.apply_7pt_h_plain(ps[i], *hw[i], dg(i)),
                    (ps[i], *hw[i][:3], *hw[i][3], dg(i), ps[i]))
                   for i in held],
                  lambda: sm.apply_7pt(p, w, ctx, diag=diag),
                  lambda: sp.apply_7pt(p, w, diag), tol,
                  table=(lambda: halo7.apply_7pt_hs(ps, *cols, diags=dgs),
                         lambda: halo7.apply_7pt_hs_plain(ps, *cols,
                                                          diags=dgs)))
            check("resid_scaled_7pt_h", v, tag == "bf16" and diag is None,
                  [(lambda i=i: halo7.resid_scaled_7pt_h(
                      ps[i], *hw[i], bs[i], dg(i)),
                    lambda i=i: halo7.resid_scaled_7pt_h_plain(
                        ps[i], *hw[i], bs[i], dg(i)),
                    (ps[i], *hw[i][:3], *hw[i][3], bs[i], dg(i), ps[i]))
                   for i in held],
                  lambda: sm.resid_scaled_7pt(p, w, ctx, b, diag=diag),
                  lambda: sp.resid_scaled_7pt(p, w, diag, b), tol,
                  table=(lambda: halo7.resid_scaled_7pt_hs(
                             ps, *cols, bs, diags=dgs),
                         lambda: halo7.resid_scaled_7pt_hs_plain(
                             ps, *cols, bs, diags=dgs)))
        if tag == "f32":   # the CG curvature step is f32 only
            check("apply_dot_7pt_h", "f32 unit", True,
                  [(lambda i=i: halo7.apply_dot_7pt_h(ps[i], *hw[i]),
                    lambda i=i: halo7.apply_dot_7pt_h_plain(ps[i], *hw[i]),
                    (ps[i], *hw[i][:3], *hw[i][3], ps[i])) for i in held],
                  lambda: sm.apply_dot_7pt(p, w, ctx),
                  lambda: sp.apply_dot_7pt(p, w), tol, n_scalar=1,
                  scalar_tol=DOT_RTOL)
            # The shards' chain adds the planes in the single-grid
            # kernel's order: the island's dot is that kernel's, bitwise.
            dots = [float(sm.apply_dot_7pt(p, w, ctx)[1]) for _ in range(3)]
            single = float(sp.apply_dot_7pt(p, w)[1])
            log(f"  apply_dot_7pt_h    island dot over 3 calls {dots}, "
                f"single-grid kernel {single!r}")
            if dots != [single] * 3:
                raise AssertionError("apply_dot_7pt_h: the island dot does "
                                     "not repeat or differs from the "
                                     "single-grid kernel's")

        # MULES: `dtype` is the compression-flux input and anti output
        # (flux_all) and the λ/anti streams (fct_iter), bf16 by default.
        alpha = arr(0, 1)
        phis = tuple(1e-3 * arr() for _ in range(3))
        ucs = tuple((1e-3 * arr()).to(dtype) for _ in range(3))
        anti_dt = dtype if tag == "bf16" else None
        a_s = ctx.split(alpha)
        a_h = sm.exchange_halo(a_s, 2, ctx)
        ph_s, uc_s = [ctx.split(f) for f in phis], [ctx.split(f) for f in ucs]
        fa = [(a_s[i], a_h[i][0], a_h[i][1][:1], tuple(f[i] for f in ph_s),
               tuple(f[i] for f in uc_s), anti_dt) for i in held]
        check("flux_all_h", f"{tag} uc/anti", tag == "bf16",
              [(lambda i=i: mfx.flux_all_h(*fa[i]),
                lambda i=i: mfx.flux_all_h_plain(*fa[i]),
                (*fa[i][:3], *fa[i][3], *fa[i][4], a_s[i], a_s[i], a_s[i],
                 *(torch.empty_like(a_s[i], dtype=dtype),) * 3))
               for i in held],
              lambda: sm.flux_all(alpha, phis, ucs, ctx, anti_dtype=anti_dt),
              lambda: mfx.flux_all(alpha, phis, ucs, anti_dt), tol)
        al = arr(0, 1)
        cells = (al, torch.clamp(al + arr(0, 0.2), max=1.0),
                 torch.clamp(al - arr(0, 0.2), min=0.0), arr(1e-4, 2e-4))
        lams = tuple(arr(0, 1, dtype) for _ in range(3))
        antis = tuple((1e-3 * arr()).to(dtype) for _ in range(3))
        antis[0][0], antis[1][:, 0], antis[2][:, :, 0] = 0, 0, 0
        fct_h = (0.00185, 0.00185, 0.00185)
        cs = [ctx.split(c) for c in cells]
        cl = [sm.exchange_halo(c, 1, ctx) for c in cs]

        def fct_args(lams, antis, h):
            """fct_iter_h's arguments per shard."""
            ls = [ctx.split(x) for x in lams]
            ans = [ctx.split(x) for x in antis]
            lh = [sm.exchange_halo(x, 1, ctx, hi_edge="zero") for x in ls]
            ah = [sm.exchange_halo(x, 1, ctx, hi_edge="zero") for x in ans]
            return [(tuple(x[i] for x in ls),
                     (lh[0][i], (lh[1][i][0], None), (lh[2][i][0], None)),
                     tuple(x[i] for x in ans),
                     (ah[0][i], (ah[1][i][0], None), (ah[2][i][0], None)),
                     tuple(c[i][0] for c in cl), *(c[i] for c in cs), h)
                    for i in held]

        fi = fct_args(lams, antis, fct_h)
        check("fct_iter_h", f"{tag} λ/anti", tag == "bf16",
              [(lambda i=i: mf.fct_iter_h(*fi[i]),
                lambda i=i: mf.fct_iter_h_plain(*fi[i]),
                (*fi[i][0], *fi[i][2], *fi[i][5:9], *fi[i][4],
                 *(h for hs in fi[i][1] + fi[i][3] for h in hs
                   if h is not None), *fi[i][0]))
               for i in held],
              lambda: sm.fct_iters(lams, antis, *cells, fct_h, 1, ctx),
              lambda: mf.fct_iter(lams, antis, *cells, fct_h), tol)
        # F1 (as in phase 2): every shard bitwise equal to plain at
        # spacings where the two reciprocal forms differ.
        f1 = fct_args(lams, antis, F1_SPACING)
        same = all(torch.equal(g, r) for a in f1 for g, r in
                   zip(mf.fct_iter_h(*a), mf.fct_iter_h_plain(*a)))
        same_island = all(map(torch.equal, sm.fct_iters(
            lams, antis, *cells, F1_SPACING, 1, ctx), mf.fct_iter(
            lams, antis, *cells, F1_SPACING)))
        log(f"  fct_iter_h         {tag} at h {F1_SPACING}: every shard "
            f"{'bitwise equal' if same else 'NOT bitwise equal'} to plain, "
            f"the island {'bitwise equal' if same_island else 'DIFFERS'} "
            "to the single grid")
        if not (same and same_island):
            raise AssertionError(f"fct_iter_h {tag}: not bitwise at h "
                                 f"{F1_SPACING}")
        # A NaN λ (the first plane of the third shard, which the second
        # reads as its halo) among λ and anti of ±0, as in phase 2.
        nl = nan_and_zeros(lams, (nx // 2, ny // 2, nz // 2))
        na = nan_and_zeros(antis)
        same = all(same_bits(mf.fct_iter_h(*a), mf.fct_iter_h_plain(*a))
                   for a in fct_args(nl, na, F1_SPACING))
        same_island = same_bits(
            sm.fct_iters(nl, na, *cells, F1_SPACING, 1, ctx),
            mf.fct_iter(nl, na, *cells, F1_SPACING))
        log(f"  fct_iter_h         {tag} NaN λ, ±0 operands: every shard "
            f"{'NaN and bits as plain' if same else 'DIFFERS from plain'}, "
            f"the island {'as the single grid' if same_island else 'DIFFERS'}")
        if not (same and same_island):
            raise AssertionError(f"fct_iter_h {tag}: a NaN operand gives "
                                 "other NaNs or bits than plain")

    # The momentum and projection islands: physical inputs with zero wall
    # faces, f32.
    vel, rp = faces(), faces()
    mu, div_u = arr(1e-5, 2e-3), 0.1 * arr(-1, 1)
    us, rxs = ctx.split(vel[0], nx), ctx.split(rp[0], nx)
    others = [ctx.split(t) for t in (*vel[1:], *rp[1:], mu, div_u)]
    uh = sm.exchange_halo(us, 2, ctx, hi_edge="zero")
    vh, wh = (sm.exchange_halo(o, 2, ctx) for o in others[:2])
    rxh = sm.exchange_halo(rxs, 1, ctx, hi_edge="zero")
    ryh, rzh, muh = (sm.exchange_halo(o, 1, ctx) for o in others[2:5])
    duh = sm.exchange_halo(others[5], 1, ctx, lo_edge="zero")
    for dev2 in (True, False):
        ma = [(us[i], others[0][i], others[1][i], rxs[i], others[2][i],
               others[3][i], others[4][i], others[5][i],
               (*uh[i], *vh[i], *wh[i], *rxh[i], ryh[i][0], rzh[i][0],
                *muh[i], duh[i][0]), spacing, dev2) for i in held]
        check("momentum_rhs_h", f"dev2 {'on' if dev2 else 'off'}", dev2,
              [(lambda i=i: mrk.momentum_rhs_h(*ma[i]),
                lambda i=i: mrk.momentum_rhs_h_plain(*ma[i]),
                (*ma[i][:7], ma[i][7] if dev2 else None,
                 *(h for h in ma[i][8] if dev2 or h is not duh[i][0]),
                 us[i], others[0][i], others[1][i]))
               for i in held],
              lambda: sm.momentum_rhs(*vel, rp, mu, div_u, spacing, ctx,
                                      dev2=dev2),
              lambda: mrk.momentum_rhs(*vel, rp, mu, div_u, spacing, dev2),
              MOM_RTOL)
    f1 = [ma[i][:9] + (F1_SPACING, True) for i in held]
    check("momentum_rhs_h", "dev2 on, h F1", False,
          [(lambda i=i: mrk.momentum_rhs_h(*f1[i]),
            lambda i=i: mrk.momentum_rhs_h_plain(*f1[i]), f1[i][:8])
           for i in held],
          lambda: sm.momentum_rhs(*vel, rp, mu, div_u, F1_SPACING, ctx),
          lambda: mrk.momentum_rhs(*vel, rp, mu, div_u, F1_SPACING),
          MOM_RTOL)

    dp, vfrac = arr(-50, 50), arr(0, 1)
    vfrac[vfrac < 0.1] = 0
    beta = faces(8e-4, 1e-3)
    rho = arr(1, 998)
    topo = (arr(0, 1)[:, :, 0] > 0.3).float().contiguous()
    dt0 = torch.tensor(3.7e-3, device=dev)
    dps = ctx.split(dp)
    dh = sm.exchange_halo(dps, 1, ctx)
    for open_top in (True, False):
        aps = faces(0.0, 1.0, open_top)
        for a in aps:
            a[a < 0.2] = 0
        packed = [ctx.split(t, nx) for t in (vel[0], beta[0], aps[0])]
        his = [sm.exchange_hi(t, 1, ctx) for t in packed]
        rest = [ctx.split(t) for t in (*vel[1:], *beta[1:], *aps[1:], vfrac,
                                       topo, rho)]
        ca = [(dps[i], *dh[i], packed[0][i], his[0][i], rest[0][i],
               rest[1][i], packed[1][i], his[1][i], rest[2][i], rest[3][i],
               packed[2][i], his[2][i], rest[4][i], rest[5][i], rest[6][i],
               rest[7][i] if open_top else None, rest[8][i], dt0, spacing,
               open_top) for i in held]
        tag = f"open top {'on' if open_top else 'off'}"
        check("correct_divmax_h", tag, open_top,
              [(lambda i=i: ck.correct_divmax_h(*ca[i]),
                lambda i=i: ck.correct_divmax_h_plain(*ca[i]),
                (*ca[i][:16], ca[i][16], ca[i][17][:, :, -1],
                 packed[0][i], rest[0][i], rest[1][i]))
               for i in held],
              lambda: sm.correct_divmax(dp, *vel, beta, *aps, vfrac, topo,
                                        rho, dt0, spacing, ctx,
                                        open_top=open_top),
              lambda: ck.correct_divmax(dp, *vel, beta, *aps, vfrac, topo,
                                        rho, dt0, spacing, open_top=open_top),
              F32_RTOL, n_scalar=1, scalar_bitwise=True)
    for name, single in (("apply_7pt_h", "row 3"),
                         ("resid_scaled_7pt_h", "row 2")):
        r = rows[name]
        log(f"  {name:18s} island, {r['cuda_launches_per_call']} CUDA "
            f"launch(es) {r['ms']:.4f} ms ({n_shards} launches of one slab "
            f"{r['shard_launches_ms']:.4f} ms) beside the single-grid kernel "
            f"({single}) {r['single_grid_ms']:.4f} ms: "
            f"{r['ms'] / r['single_grid_ms']:.2f}x")
    return rows


def counters():
    """name → (module, entry point, plain version), for every kernel."""
    from openfoam_tpp_tpu_torch.ops.kernels import correction as ck
    from openfoam_tpp_tpu_torch.ops.kernels import halo7
    from openfoam_tpp_tpu_torch.ops.kernels import mom_finish as mfk
    from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as mrk
    from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as mf
    from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as mfx
    from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp

    return {
        "apply_7pt": (sp, "apply_7pt", sp.apply_7pt_plain),
        "resid_scaled_7pt": (sp, "resid_scaled_7pt", sp.resid_scaled_7pt_plain),
        "apply_dot_7pt": (sp, "apply_dot_7pt", sp.apply_dot_7pt_plain),
        "apply_7pt_nb": (sp, "apply_7pt_nb", sp.apply_7pt_plain),
        "resid_scaled_7pt_nb": (sp, "resid_scaled_7pt_nb",
                                sp.resid_scaled_7pt_plain),
        "apply_dot_7pt_nb": (sp, "apply_dot_7pt_nb", sp.apply_dot_7pt_plain),
        "cheb2_pre_7pt": (sp, "cheb2_pre_7pt", sp.cheb2_pre_7pt_plain),
        "cheb2_post_7pt": (sp, "cheb2_post_7pt", sp.cheb2_post_7pt_plain),
        "cheb2_post_dot_7pt": (sp, "cheb2_post_dot_7pt",
                               sp.cheb2_post_dot_7pt_plain),
        "flux_all": (mfx, "flux_all", mfx.flux_all_plain),
        "fct_iter": (mf, "fct_iter", mf.fct_iter_plain),
        "momentum_rhs": (mrk, "momentum_rhs", mrk.momentum_rhs_plain),
        "correct_divmax": (ck, "correct_divmax", ck.correct_divmax_plain),
        "momentum_finish": (mfk, "momentum_finish", mfk.momentum_finish_plain),
        # Rows 11a-b: the step launches them through the island entry
        # points, one launch an island.
        "apply_7pt_h": (halo7, "apply_7pt_hs", halo7.apply_7pt_hs_plain),
        "resid_scaled_7pt_h": (halo7, "resid_scaled_7pt_hs",
                               halo7.resid_scaled_7pt_hs_plain),
        "apply_dot_7pt_h": (halo7, "apply_dot_7pt_h",
                            halo7.apply_dot_7pt_h_plain),
        "flux_all_h": (mfx, "flux_all_h", mfx.flux_all_h_plain),
        "fct_iter_h": (mf, "fct_iter_h", mf.fct_iter_h_plain),
        "momentum_rhs_h": (mrk, "momentum_rhs_h", mrk.momentum_rhs_h_plain),
        "correct_divmax_h": (ck, "correct_divmax_h",
                             ck.correct_divmax_h_plain),
    }


def drive(label, step, state, bundle, params, n_steps, n_timed, n_fluid,
          expect, snap_at=None):
    """`n_steps` steps of `step` from (state, bundle), the last `n_timed`
    timed, with every launch count set to 0 just before and read just
    after. Checks the run and that exactly the kernels in `expect` ran.
    The stats carry every step's p_iters and CFL dt (`dt_cfl`, the
    state's dt); with `snap_at` also the state after that many steps
    (`snapshot`)."""
    import torch

    fns = {k: getattr(m, a) for k, (m, a, _) in counters().items()}
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    diags, dts = [], []
    t_first = time.perf_counter()
    for i in range(n_steps):
        if i == n_steps - n_timed:
            torch.cuda.synchronize()
            t_timed = time.perf_counter()
        state, d, bundle = step(state, params, precond=bundle)
        diags.append(d)
        dts.append(state.dt)
        if i + 1 == snap_at:
            snapshot = state
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k: f.launches for k, f in fns.items()}
    wall = t_end - t_timed
    iters = [int(d.p_iters) for d in diags]
    co = max(float(d.courant) for d in diags)
    a_min = min(float(d.alpha_min) for d in diags)
    a_max = max(float(d.alpha_max) for d in diags)
    hist = {int(k): int(v) for k, v in zip(*np.unique(iters, return_counts=True))}
    stats = {"steps": n_steps, "timed_steps": n_timed,
             "ms_per_step": wall / n_timed * 1e3,
             "cell_updates_per_s": n_fluid * n_timed / wall,
             "p_iters_hist": hist, "max_courant": co,
             "max_div_error": max(float(d.div_error) for d in diags),
             "sim_t": float(state.t),
             "launches_per_step": {k: v / n_steps for k, v in launches.items()},
             "p_iters": iters,
             "dt_cfl": [float(x) for x in torch.stack(dts).cpu()]}
    if snap_at is not None:
        stats["snapshot"] = snapshot
    log(f"[{label}] {n_steps} steps in {t_end - t_first:.2f} s; last "
        f"{n_timed}: {stats['ms_per_step']:.3f} ms/step, "
        f"{stats['cell_updates_per_s']:.4e} cell-updates/s, "
        f"sim t={float(state.t):.5f} s, dt={float(state.dt):.3e} s")
    log(f"  p_iters histogram {hist}; max Courant {co:.4f}; alpha in "
        f"[{a_min:.3e}, {a_max:.6f}]; max div error "
        f"{stats['max_div_error']:.3e}")
    log(f"  kernel launches {launches}")
    fields = (state.alpha, state.u, state.v, state.w, state.p)
    if not all(bool(torch.isfinite(v).all()) for v in fields):
        raise AssertionError(f"{label}: non-finite field")
    if a_min < 0.0 or a_max > 1.0:
        raise AssertionError(f"{label}: alpha out of [0, 1]: [{a_min}, {a_max}]")
    if co > 0.6:
        raise AssertionError(f"{label}: Courant {co} > 0.6")
    if max(iters) >= 50:
        raise AssertionError(f"{label}: p_iters reached {max(iters)}")
    ran = {k for k, v in launches.items() if v > 0}
    if ran != set(expect):
        raise AssertionError(f"{label}: kernels launched {sorted(ran)}, "
                             f"expected {sorted(expect)}")
    # The fused smoothers run once per V-cycle: one before CG's loop and
    # one per iteration.
    vcycles = sum(iters) + n_steps
    for k in set(expect) & set(CHEB2_RZ + CHEB2_NO_RZ):
        if launches[k] != vcycles:
            raise AssertionError(f"{label}: {k} launched {launches[k]} "
                                 f"times in {vcycles} V-cycles")
    return state, bundle, launches, stats


STEP_ROWS = ("apply_7pt", "resid_scaled_7pt", "apply_dot_7pt", "flux_all",
             "fct_iter", "momentum_rhs", "correct_divmax")
STEP_TIMED_CALLS = 24   # calls of one signature timed on step operands


def vcycle_calls(shape, knobs):
    """(apply_7pt, resid_scaled_7pt) calls of one V-cycle of the kernel
    path on a grid of `shape` (solver/poisson.py `_vcycle_hybrid`) with
    one-sweep smoothers: the top level's entry residual and exit
    smoothing; per visit of a coarse level above the coarsest, gamma
    residual applies and gamma smoothing residuals (gamma = mg_l1_gamma
    on the first coarse level, mg_deep_gamma below, each level visited
    gamma times per visit of the one above); the coarsest level's Jacobi
    sweeps less the elided first. The coarse shapes halve, rounded up,
    while a level has more than 256 cells and every side more than 2 (at
    most 9 levels; `_build_coarse_levels`)."""
    if knobs.smooth_sweeps != 1 or knobs.smoother != "chebyshev":
        raise ValueError("vcycle_calls counts one Chebyshev sweep")
    coarse = []
    while len(coarse) < 9 and np.prod(shape) > 256 and min(shape) > 2:
        shape = tuple((n + 1) // 2 for n in shape)
        coarse.append(shape)
    coarsest = knobs.coarsest_sweeps - 1
    if not coarse:
        return 0, 2 + coarsest
    apply, resid, visits = 0, 2, 1
    for i in range(len(coarse) - 1):
        g = max(knobs.mg_l1_gamma if i == 0 else knobs.mg_deep_gamma, 1)
        apply += visits * g
        resid += visits * g
        visits *= g
    return apply, resid + visits * coarsest


def phase_step_operands(step, state, params, rows, names=STEP_ROWS):
    """Kernel rows on the operands of one real step from `state` (phase
    3's flagship, phase 10's tiled grid): of the default step the 7-point
    apply and resid calls of every V-cycle level and the CG's true
    residual (rows 2, 3; their count from `vcycle_calls`), the CG's
    apply_dot_7pt calls (one per iteration), the three flux_all calls,
    the nine fct_iter calls, the momentum_rhs call and the
    correct_divmax call (rows 1, 4, 5, 6, 7); of the two-sweep step the
    cheb2_pre_7pt and cheb2_post_dot_7pt calls (rows 9a, 9c; one each per
    V-cycle). Captured by spies standing in for the entry points `names`,
    every call held against the plain version with phase 2's
    tolerances: f32 outputs F32_RTOL (momentum_rhs MOM_RTOL), bf16
    outputs (the V-cycle's applies and resids, flux anti, FCT λ, the pre
    smoother's x and r) BF16_RTOL, the dots DOT_RTOL and the div max
    F32_RTOL, each scalar bitwise equal over two calls; every call
    launched its kernel. The first STEP_TIMED_CALLS calls of each
    signature (operand shapes and dtypes: one V-cycle level) are timed
    again, kernel and plain version. Adds `step_ms`, `step_plain_ms`
    (means per call, each signature weighted by its calls),
    `step_max_rel_err`, `step_bitwise`, the mean bytes and bound of a
    call (`step_bytes`, `step_bound_ms`: each distinct operand tensor
    read once, each output written once) and `step_levels` (per
    signature: calls, times, bytes, bound) to those rows."""
    import torch

    from openfoam_tpp_tpu_torch.ops.kernels import correction as ck
    from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as mrk
    from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as mf
    from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as mfx
    from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp
    from openfoam_tpp_tpu_torch.solver.poisson import SolverKnobs
    from openfoam_tpp_tpu_torch.utils.devtime import device_ms

    def clone(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, (tuple, list)):
            return type(v)(clone(x) for x in v)
        return v

    def flat(out):
        if isinstance(out, torch.Tensor):
            return [out]
        return [t for o in out for t in flat(o)]

    def tensors(v):
        if isinstance(v, torch.Tensor):
            return [v]
        if isinstance(v, (tuple, list)):
            return [t for x in v for t in tensors(x)]
        if isinstance(v, dict):
            return tensors(list(v.values()))
        return []

    def tol_of(name, t):
        if t.dim() == 0:
            return F32_RTOL if name == "correct_divmax" else DOT_RTOL
        if t.dtype == torch.bfloat16:
            return BF16_RTOL
        return MOM_RTOL if name == "momentum_rhs" else F32_RTOL

    real = {"apply_7pt": (sp, sp.apply_7pt, sp.apply_7pt_plain),
            "resid_scaled_7pt": (sp, sp.resid_scaled_7pt,
                                 sp.resid_scaled_7pt_plain),
            "apply_dot_7pt": (sp, sp.apply_dot_7pt, sp.apply_dot_7pt_plain),
            "flux_all": (mfx, mfx.flux_all, mfx.flux_all_plain),
            "fct_iter": (mf, mf.fct_iter, mf.fct_iter_plain),
            "momentum_rhs": (mrk, mrk.momentum_rhs, mrk.momentum_rhs_plain),
            "correct_divmax": (ck, ck.correct_divmax,
                               ck.correct_divmax_plain),
            "cheb2_pre_7pt": (sp, sp.cheb2_pre_7pt, sp.cheb2_pre_7pt_plain),
            "cheb2_post_dot_7pt": (sp, sp.cheb2_post_dot_7pt,
                                   sp.cheb2_post_dot_7pt_plain)}
    real = {name: real[name] for name in names}
    calls = {name: [] for name in real}

    def spy(name):
        def call(*a, **k):
            calls[name].append((clone(a), clone(k)))
            return real[name][1](*a, **k)
        # The entry point counts on the module's attribute: while the spy
        # stands in for it, the count lands here.
        call.launches = 0
        return call

    spies = {name: spy(name) for name in real}
    with contextlib.ExitStack() as stack:
        for name, (mod, _, _) in real.items():
            stack.enter_context(mock.patch.object(mod, name, spies[name]))
        _, d, _ = step(state, params, precond=step.init_precond(state))
    torch.cuda.synchronize()
    # One V-cycle before CG's loop and one per iteration; the CG's true
    # residual before and after its one refinement pass.
    vcycles = int(d.p_iters) + 1
    n_apply, n_resid = vcycle_calls(tuple(state.alpha.shape), SolverKnobs())
    want = {"apply_7pt": vcycles * n_apply + 2,
            "resid_scaled_7pt": vcycles * n_resid,
            "apply_dot_7pt": int(d.p_iters), "flux_all": 3, "fct_iter": 9,
            "momentum_rhs": 1, "correct_divmax": 1,
            "cheb2_pre_7pt": vcycles, "cheb2_post_dot_7pt": vcycles}
    for name, (_, kern, plain) in real.items():
        n_calls = len(calls[name])
        if (n_calls != want[name] or spies[name].launches != n_calls
                or not n_calls):
            raise AssertionError(f"step operands: {n_calls} {name} calls "
                                 f"in one step, want {want[name]}; "
                                 f"{spies[name].launches} launched")
        levels, rel, bitwise, bad = {}, 0.0, True, []
        for a, k in calls[name]:
            got, ref = flat(kern(*a, **k)), flat(plain(*a, **k))
            ins = {t.data_ptr(): t for t in tensors((a, k))}
            sig = tuple((tuple(t.shape), str(t.dtype).replace("torch.", ""))
                        for t in tensors((a, k)))
            lv = levels.setdefault(sig, {"calls": 0, "ms": [],
                                         "plain_ms": [], "max_rel_err": 0.0})
            lv["calls"] += 1
            lv["bytes"] = nbytes(*ins.values()) + nbytes(*got)
            # Outputs of one tolerance are held together, as in phase 2.
            for tol in sorted({tol_of(name, r) for r in ref}):
                grp = [(g, r) for g, r in zip(got, ref) if tol_of(name, r) == tol]
                err, scale = max_err(*map(list, zip(*grp)))
                e = err / max(scale, 1e-30)
                rel, lv["max_rel_err"] = max(rel, e), max(lv["max_rel_err"], e)
                if err > tol * max(scale, 1e-30):
                    bad.append(f"{e:.3e} > {tol:.1e} at {sig[0][0]}")
            bitwise = bitwise and all(torch.equal(g, r) for g, r in zip(got, ref)
                                      if r.dim() > 0)
            if (ref[-1].dim() == 0
                    and float(flat(kern(*a, **k))[-1]) != float(got[-1])):
                bad.append("its scalar does not repeat bitwise")
            if len(lv["ms"]) < STEP_TIMED_CALLS:
                lv["ms"].append(device_ms(lambda: kern(*a, **k), REPS))
                lv["plain_ms"].append(device_ms(lambda: plain(*a, **k), REPS))
        step_levels = [
            {"shape": list(sig[0][0]), "dtype": sig[0][1],
             "operands": len(sig), "calls": lv["calls"],
             "timed_calls": len(lv["ms"]), "ms": float(np.mean(lv["ms"])),
             "plain_ms": float(np.mean(lv["plain_ms"])),
             "bytes": lv["bytes"],
             "bound_ms": lv["bytes"] / HBM_BYTES_PER_S * 1e3,
             "max_rel_err": lv["max_rel_err"]}
            for sig, lv in levels.items()]
        mean = lambda key: sum(lv[key] * lv["calls"] for lv in step_levels
                               ) / n_calls
        ms, plain_ms, b = mean("ms"), mean("plain_ms"), mean("bytes")
        log(f"  {name:17s} step operands, {n_calls} call(s): kernel "
            f"{ms:.4f} ms per call  plain {plain_ms:.4f} ms  bytes "
            f"{b / 1e6:.2f} MB  bound {b / HBM_BYTES_PER_S * 1e3:.4f} ms  "
            f"max rel err {rel:.3e}; "
            f"arrays {'bitwise' if bitwise else 'not bitwise'} equal to plain "
            f"{'FAIL ' + '; '.join(bad[:4]) if bad else 'ok'}")
        if len(step_levels) > 1:
            for lv in step_levels:
                log(f"    {tuple(lv['shape'])} {lv['dtype']} "
                    f"({lv['operands']} operands): {lv['calls']} calls, "
                    f"kernel {lv['ms'] * 1e3:.1f} us, plain "
                    f"{lv['plain_ms'] * 1e3:.1f} us, bound "
                    f"{lv['bound_ms'] * 1e3:.2f} us, max rel err "
                    f"{lv['max_rel_err']:.3e}")
        if bad:
            raise AssertionError(f"{name} on step operands: kernel disagrees "
                                 f"with its plain version ({bad[:8]})")
        rows[name].update(step_ms=ms, step_plain_ms=plain_ms,
                          step_max_rel_err=rel, step_bitwise=bitwise,
                          step_bytes=b,
                          step_bound_ms=b / HBM_BYTES_PER_S * 1e3,
                          step_levels=step_levels)


def phase_sharded(build, state, params, n_fluid):
    """The x-sharded step on one card (module docstring, phase 3b): from
    `state`, N_SHARDED steps each of the unsharded default step and of
    make_step(spmd=SpmdCtx(S)) for S = 4 and 1, then the 4-shard step with
    OFTPP_SMOOTH_SWEEPS=2. Returns the 4-shard run's launch counts and the
    phase's stats."""
    import torch

    from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx

    runs, snaps, finals, launches = {}, {}, {}, {}
    for label, n in (("unsharded", None), ("4 shards", N_SHARDS),
                     ("1 shard", 1)):
        stp = build(spmd=None if n is None else SpmdCtx(n))
        finals[label], _, launches[label], runs[label] = drive(
            f"sharded step: {label}, same state", stp, state,
            stp.init_precond(state), params, N_SHARDED, N_SHARDED_TIMED,
            n_fluid, DEFAULT_PATH if n is None else HALO_PATH, snap_at=3)
        snaps[label] = runs[label].pop("snapshot")
        if n is not None:
            check_halo_launches(label, launches[label], runs[label], n, 1)
    stp = build(spmd=SpmdCtx(N_SHARDS), OFTPP_SMOOTH_SWEEPS="2")
    _, _, two, runs["4 shards, two sweeps"] = drive(
        "sharded step: 4 shards, OFTPP_SMOOTH_SWEEPS=2, same state", stp,
        state, stp.init_precond(state), params, N_SHARDED, N_SHARDED_TIMED,
        n_fluid, HALO_PATH)
    check_halo_launches("4 shards, two sweeps", two,
                        runs["4 shards, two sweeps"], N_SHARDS, 2)

    spread, bad = {}, []
    for label, ref in (("4 shards", "1 shard"), ("4 shards", "unsharded"),
                       ("1 shard", "unsharded")):
        iters, ref_iters = runs[label]["p_iters"], runs[ref]["p_iters"]
        d_it = max(abs(a - b) for a, b in zip(iters, ref_iters))
        log(f"[sharded step {label} vs {ref}] p_iters per step {iters} "
            f"({ref}: {ref_iters}); largest difference {d_it}")
        if d_it > 2:
            bad.append(f"{label} vs {ref}: p_iters differ by {d_it} > 2")
        pair = spread[f"{label} vs {ref}"] = {"max_p_iters_diff": d_it}
        tols3 = JAX_SPMD_TOLS if ref == "1 shard" else SHARD_TOLS
        for at, got_s, ref_s, tols in (
                (3, snaps[label], snaps[ref], tols3),
                (N_SHARDED, finals[label], finals[ref], SHARD_TOLS)):
            for k, (kind_t, tol, floor) in tols.items():
                err, scale = max_err(getattr(got_s, k), getattr(ref_s, k))
                lim = max(tol if kind_t == "abs" else tol * scale, floor)
                pair[f"{k}_after_{at}"] = {"max_abs_err": err,
                                           "scale": scale, "limit": lim}
                log(f"  after {at} steps {k}: max_abs_err {err:.3e} limit "
                    f"{lim:.3e} (scale {scale:.3e}, {err / scale:.3e} of it)")
                if err > lim:
                    bad.append(f"{label} vs {ref}, {k} after {at}: "
                               f"{err} > {lim}")
    log("[sharded vs unsharded, same state, one run each] " + "; ".join(
        f"{k}: {runs[k]['ms_per_step']:.3f} ms/step" for k in runs))
    if bad:
        raise AssertionError(f"sharded step: {bad}")
    return launches["4 shards"], {"runs": runs, "spread": spread}


# Halo rows launched once per island call (one launch over the table of
# held slabs); every other halo row launches once per shard.
ISLAND_ROWS = ("apply_7pt_h", "resid_scaled_7pt_h")


def check_halo_launches(label, launches, stats, n_shards, sweeps):
    """Island calls: per step 3 flux islands and 9 FCT islands (3
    subcycles × 3 limiter iterations), one momentum and one epilogue
    island, two true-residual applies; one curvature island per CG
    iteration; per V-cycle (one before CG's loop and one per iteration) 2
    residual islands with one sweep, 4 with two (the generic smoother on
    the sharded top level). The apply and resid rows launch once per
    island call, every other halo row `n_shards` times."""
    steps = stats["steps"]
    iters = sum(stats["p_iters"])
    want = {"flux_all_h": 3 * steps, "fct_iter_h": 9 * steps,
            "momentum_rhs_h": steps, "correct_divmax_h": steps,
            "apply_7pt_h": 2 * steps, "apply_dot_7pt_h": iters,
            "resid_scaled_7pt_h": 2 * sweeps * (iters + steps)}
    per = {k: 1 if k in ISLAND_ROWS else n_shards for k in want}
    got = {k: launches[k] for k in want}
    if got != {k: per[k] * v for k, v in want.items()}:
        raise AssertionError(f"{label}: halo launches {got}, want "
                             f"{per} x {want}")
    log(f"  {label}: apply and resid launched once per island call, every "
        f"other halo row {n_shards} times; every single-grid row 0 times")


def phase_case(geom, base):
    """The case path at full width: `setup_case` of the flagship with a
    0.1 s duration under `base`, `run_case` on the card with
    OFTPP_SMOOTH_SWEEPS=2 (its device bytes above what was allocated
    before it: the peak of max_memory_allocated), a second `run_case`,
    `extract_interface`, then the command line's `--action profile` on
    that case. Returns the launch counts of the first run (set to 0 just
    before it, read just after) and its stats, with the case directory."""
    import torch

    from openfoam_tpp_tpu_torch.manager import cli
    from openfoam_tpp_tpu_torch.utils.profiling import TRACE_FILE

    from openfoam_tpp_tpu_torch.manager.cases import (is_case_done,
                                                      load_case_params,
                                                      setup_case)
    from openfoam_tpp_tpu_torch.manager.runner import (_case_shape_hint,
                                                       build_case_geometry,
                                                       iterate_snapshots,
                                                       run_case)
    from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp
    from openfoam_tpp_tpu_torch.post.interface import extract_interface
    from openfoam_tpp_tpu_torch.solver import poisson
    from openfoam_tpp_tpu_torch.utils.io import list_checkpoints, load_checkpoint

    # ramp: the 2 s soft start of the 20 s flagship run, not 10% of this
    # cut duration (which would jolt the tank to full radius in 10 ms).
    case_params = dict(H=0.208, D=0.2, geo="flat", R=0.004, freq=1.88,
                       mesh=0.00185, duration=0.1, dt=0.001, ramp=2.0)
    fns = {k: getattr(m, a) for k, (m, a, _) in counters().items()}
    top_shape = tuple(geom.shape)
    solves, top_resid = [], [0]
    real_pcg, real_resid = poisson.solve_pcg, sp.resid_scaled_7pt

    def pcg(*a, **k):
        out = real_pcg(*a, **k)
        solves.append(int(out[2]))
        return out

    def resid(p, *a, **k):
        top_resid[0] += tuple(p.shape) == top_shape
        return real_resid(p, *a, **k)

    # The entry point counts on the module's attribute: while `resid`
    # stands in for it, the count lands here.
    resid.launches = 0

    case_dir = setup_case(case_params, base)
    lines = []

    def case_log(line):
        lines.append(line)
        log("  | " + line)

    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with environ(OFTPP_SMOOTH_SWEEPS="2"), \
            mock.patch.object(poisson, "solve_pcg", pcg), \
            mock.patch.object(sp, "resid_scaled_7pt", resid):
        stats = run_case(case_dir, log=case_log)
    torch.cuda.synchronize()
    run_bytes = torch.cuda.max_memory_allocated() - mem0
    launches = {k: f.launches for k, f in fns.items()}
    launches["resid_scaled_7pt"] = resid.launches
    steps = stats["steps"]
    hist = {int(k): int(v)
            for k, v in zip(*np.unique(solves, return_counts=True))}
    log(f"[case path] {steps} steps to t={stats['sim_seconds']:.3f} s in "
        f"{stats['wall_seconds']:.2f} s wall, "
        f"{stats['cell_steps_per_sec']:.4e} cell-updates/s; writing "
        f"checkpoints and probes {stats['io_seconds']:.2f} s; per write "
        f"{[(i['steps'], round(i['wall_seconds'], 2)) for i in stats['intervals']]}")
    log(f"  p_iters histogram {hist}; kernel launches {launches}")
    log(f"  device bytes of the run (peak above what was allocated "
        f"before it) {run_bytes}: {run_bytes / stats['n_cells']:.1f} per "
        f"fluid cell")
    if geom.n_fluid_cells != stats["n_cells"] or len(solves) != steps:
        raise AssertionError(f"case path: {stats['n_cells']} cells, "
                             f"{len(solves)} solves in {steps} steps")
    ran = {k for k, v in launches.items() if v > 0}
    if ran != set(DEFAULT_PATH + CHEB2_RZ):
        raise AssertionError(f"case path: kernels launched {sorted(ran)}")
    vcycles = sum(solves) + steps
    for k in CHEB2_RZ:
        if launches[k] != vcycles:
            raise AssertionError(f"case path: {k} launched {launches[k]} "
                                 f"times in {vcycles} V-cycles")
    if top_resid[0]:
        raise AssertionError(f"case path: {top_resid[0]} unfused smoother "
                             "passes on the top level")
    if max(solves) >= 50:
        raise AssertionError(f"case path: p_iters reached {max(solves)}")
    courants = [float(x) for ln in lines
                for x in re.findall(r"\bCo = ([0-9.eE+-]+)", ln)]
    if len(courants) != 2 or max(courants) > 0.6:
        raise AssertionError(f"case path: Courant per write {courants}")

    # Checkpoints at t = 0, 0.05, 0.1: the time is the f32 target
    # bitwise; fields finite, alpha in [0, 1].
    chks = list_checkpoints(case_dir)
    if len(chks) != 3:
        raise AssertionError(f"case path: checkpoints {chks}")
    for k, (_, path) in enumerate(chks):
        c = load_checkpoint(path)
        want = float(np.float32(k) * np.float32(0.05))
        if float(c["t"]) != want:
            raise AssertionError(f"case path: {path} holds t={c['t']!r}, "
                                 f"not {want!r}")
        if not all(np.isfinite(c[f]).all() for f in "alpha u v w p".split()):
            raise AssertionError(f"case path: non-finite field in {path}")
        if c["alpha"].min() < 0.0 or c["alpha"].max() > 1.0:
            raise AssertionError(f"case path: alpha out of [0, 1] in {path}")
    if int(c["step"]) != steps or not is_case_done(case_dir):
        raise AssertionError("case path: the last checkpoint is not the "
                             "run's end")
    # Phase 12e resumes a copy of this case over ranks: its checkpoints
    # as written.
    chk_bytes = []
    for _, path in chks:
        with open(path, "rb") as f:
            chk_bytes.append((os.path.basename(path), f.read()))

    # Probe files: one row per solver step; the water probe (z = H/4
    # under a surface at H/2) reads ρ_w·g·depth.
    tables = {}
    for name in ("p", "eta"):
        with open(os.path.join(case_dir, "postProcessing", "probes", "0",
                               name)) as f:
            tables[name] = np.array([[float(v) for v in ln.split()]
                                     for ln in f if not ln.startswith("#")])
        if len(tables[name]) != steps:
            raise AssertionError(f"case path: {len(tables[name])} rows in "
                                 f"probes/0/{name} for {steps} steps")
    hydro = 998.2 * 9.81 * (0.208 / 4)
    log(f"  water probe first row {tables['p'][0, 1]:.2f} Pa "
        f"(ρ_w·g·depth {hydro:.2f}), air probe {tables['p'][0, 2]:.3f} Pa; "
        f"η gauges {tables['eta'][-1, 1:]}")
    if abs(tables["p"][0, 1] - hydro) > 0.05 * hydro:
        raise AssertionError("case path: water probe off ρ_w·g·depth")

    # A second run resumes and has nothing left to do.
    lines2 = []
    again = run_case(case_dir, log=lines2.append)
    if again["steps"] != 0 or not any("Resuming" in ln for ln in lines2):
        raise AssertionError(f"case path: second run {again}, {lines2}")

    geom2 = build_case_geometry(load_case_params(case_dir),
                                _case_shape_hint(case_dir))
    out_dir = extract_interface(case_dir, geom2,
                                iterate_snapshots(case_dir))
    with open(os.path.join(out_dir, "interface_summary.csv")) as f:
        summary = f.read().splitlines()
    log(f"  interface_summary.csv {summary}")
    first = [float(v) for v in summary[1].split(",")]
    if (tuple(geom2.shape) != top_shape or len(summary) != 4
            or max(abs(z - 0.104) for z in first[1:4]) > geom.spacing[2]):
        raise AssertionError(f"case path: interface summary {summary}")

    # The profile verb on that case, from its last checkpoint.
    for f in fns.values():
        f.launches = 0
    with environ(OFTPP_PROFILE_STEPS=str(N_PROFILE)):
        rc = cli.main(["--headless", "--base-dir", base, "--case",
                       os.path.basename(case_dir), "--action", "profile"])
    torch.cuda.synchronize()
    prof_launches = {k: f.launches for k, f in fns.items() if f.launches}
    out_dir = os.path.join(case_dir, "postProcessing", "profile")
    with open(os.path.join(out_dir, "summary.txt")) as f:
        prof = dict(ln.rstrip("\n").split(": ", 1)
                    for ln in f if ln.strip())
    with open(os.path.join(out_dir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    n_kernels = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"[profile verb] rc {rc}; summary {prof}; trace "
        f"{os.path.getsize(os.path.join(out_dir, TRACE_FILE)) / 1e6:.1f}"
        f" MB with {n_kernels} kernel events; kernel launches "
        f"{prof_launches}")
    if (rc != 0 or tuple(prof) != PROFILE_KEYS
            or prof["n_steps"] != str(N_PROFILE)
            or prof["device"] != torch.cuda.get_device_name(0)
            or n_kernels == 0 or set(prof_launches) != set(DEFAULT_PATH)):
        raise AssertionError(f"profile verb: rc {rc}, summary {prof}, "
                             f"{n_kernels} kernel events, launches "
                             f"{prof_launches}")
    return launches, {**stats, "p_iters_hist": hist, "profile": prof,
                      "profile_launches": prof_launches,
                      "device_bytes": run_bytes, "case_dir": case_dir,
                      "params": case_params, "p_iters": solves,
                      "checkpoints": chk_bytes}


def drive_sweep(label, step, states, params, n_steps, n_timed, n_fluid,
                lockstep):
    """`n_steps` steps of a sweep step from `states`, the last `n_timed`
    timed, with every launch count set to 0 just before and read just
    after. Checks every case and that exactly the batch-native kernels
    ran; with `lockstep`, that all case times are bitwise equal."""
    import torch

    fns = {k: getattr(m, a) for k, (m, a, _) in counters().items()}
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    diags = []
    for i in range(n_steps):
        if i == n_steps - n_timed:
            torch.cuda.synchronize()
            t_timed = time.perf_counter()
        states, d = step(states, params)
        diags.append(d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_timed
    launches = {k: f.launches for k, f in fns.items()}
    stats = sweep_checks(label, states, diags, launches, wall, n_steps,
                         n_timed, n_fluid, lockstep)
    return states, launches, stats


def sweep_checks(label, states, diags, launches, wall, n_steps, n_timed,
                 n_fluid, lockstep):
    """drive_sweep's stats and checks of a run that ended in the batched
    `states` (every case on one device) after `diags` (one per step)."""
    import torch

    iters = torch.stack([d.p_iters for d in diags]).cpu().numpy()   # (n, B)
    co = float(torch.stack([d.courant for d in diags]).max())
    a_min = float(torch.stack([d.alpha_min for d in diags]).min())
    a_max = float(torch.stack([d.alpha_max for d in diags]).max())
    hist = {int(k): int(v)
            for k, v in zip(*np.unique(iters.max(axis=1), return_counts=True))}
    case_hist = {int(k): int(v)
                 for k, v in zip(*np.unique(iters, return_counts=True))}
    t = states.t.cpu().numpy()
    stats = {"cases": int(t.shape[0]), "steps": n_steps,
             "timed_steps": n_timed, "ms_per_step": wall / n_timed * 1e3,
             "agg_cell_updates_per_s": n_fluid * n_timed / wall,
             "p_iters_max_hist": hist, "p_iters_case_hist": case_hist,
             "p_iters": iters.tolist(),
             "p_iters_mean": float(iters.mean()),
             "max_courant": co, "sim_t_min": float(t.min()),
             "sim_t_max": float(t.max()),
             "launches_per_step": {k: v / n_steps
                                   for k, v in launches.items() if v}}
    log(f"[{label}] {t.shape[0]} cases x {n_steps} steps; last {n_timed}: "
        f"{stats['ms_per_step']:.3f} ms/step, "
        f"{stats['agg_cell_updates_per_s']:.4e} aggregate cell-updates/s; "
        f"sim t in [{t.min():.5f}, {t.max():.5f}] s")
    log(f"  slowest case's p_iters per step {hist} (mean over cases "
        f"{iters.mean():.2f}); max Courant {co:.4f}; alpha in "
        f"[{a_min:.3e}, {a_max:.6f}]")
    log(f"  p_iters of every case and step {case_hist}")
    log(f"  kernel launches { {k: v for k, v in launches.items() if v} }")
    fields = (states.alpha, states.u, states.v, states.w, states.p)
    if not all(bool(torch.isfinite(v).all()) for v in fields):
        raise AssertionError(f"{label}: non-finite field")
    if a_min < 0.0 or a_max > 1.0:
        raise AssertionError(f"{label}: alpha out of [0, 1]: [{a_min}, {a_max}]")
    if co > 0.6:
        raise AssertionError(f"{label}: Courant {co} > 0.6")
    if iters.max() >= 50:
        raise AssertionError(f"{label}: a case's p_iters reached {iters.max()}")
    if states.step.cpu().tolist() != [n_steps] * t.shape[0]:
        raise AssertionError(f"{label}: step counts {states.step.tolist()}")
    ran = {k for k, v in launches.items() if v > 0}
    if ran != set(BATCH_PATH):
        raise AssertionError(
            f"{label}: kernels launched {sorted(ran)}; a sweep step runs "
            f"{sorted(BATCH_PATH)} and no single-grid kernel")
    if lockstep and not bool((states.t == states.t[0]).all()):
        raise AssertionError(f"{label}: case times differ: {t.min()!r} .. "
                             f"{t.max()!r}")
    return stats


def phase_sweep(dev, props):
    """The sweep step at the JAX sweep bench's width (see the module
    docstring, phase 6). Returns the launch counts of the `make_sweep_step`
    run and the phase's stats."""
    import torch

    from openfoam_tpp_tpu_torch.config import SolverControls
    from openfoam_tpp_tpu_torch.core.state import CaseParams, init_state
    from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
    from openfoam_tpp_tpu_torch.parallel.sweep import (batch_params,
                                                       batch_states,
                                                       batch_states_geom,
                                                       build_batched_geometry,
                                                       make_geom_sweep_step,
                                                       make_sweep_step)
    from openfoam_tpp_tpu_torch.solver.timestep import make_step

    tank = dict(H=0.1, D=0.02, mesh=0.002, geo="flat")
    geom = build_tank_geometry(**tank, round_to=4)
    rows = [{"R": 0.002 + 2e-5 * i, "freq": 1.5 + 0.01 * i, "duration": 10.0}
            for i in range(SWEEP_CASES)]
    n_fluid = geom.n_fluid_cells * SWEEP_CASES
    log(f"[sweep] {SWEEP_CASES} cases of {geom.shape}, {geom.n_fluid_cells} "
        f"fluid cells each: batch {tuple(geom.shape) + (SWEEP_CASES,)}, "
        f"{n_fluid} fluid cells")
    params = batch_params(rows, device=dev)
    sweep_step = make_sweep_step(geom, props, SolverControls(), device=dev)
    states, launches, stats = drive_sweep(
        "sweep step: make_sweep_step", sweep_step,
        batch_states(geom, SWEEP_CASES, device=dev), params, N_SWEEP,
        N_SWEEP_TIMED, n_fluid, lockstep=False)

    # The lockstep geometry step on the same rows: what runsweep runs.
    bgeom = build_batched_geometry([{**tank, **r} for r in rows], round_to=4,
                                   device=dev)
    geom_step = make_geom_sweep_step(bgeom, props, SolverControls())
    _, _, lock_stats = drive_sweep(
        "sweep step: make_geom_sweep_step, lockstep", geom_step,
        batch_states_geom(bgeom), params, N_SWEEP, N_SWEEP_TIMED, n_fluid,
        lockstep=True)

    # What the sweep replaces: the solo step of one such case, 128 times.
    solo = make_step(geom, props, SolverControls(use_pallas=True),
                     carry_precond=True, device=dev)
    s1 = init_state(geom, device=dev)
    _, _, _, solo_stats = drive(
        "solo step of one sweep case: use_pallas=True", solo, s1,
        solo.init_precond(s1), CaseParams.make(**rows[0], device=dev), N_SWEEP,
        N_SWEEP_TIMED, geom.n_fluid_cells, DEFAULT_PATH)
    log(f"[sweep vs {SWEEP_CASES} solo steps, one run each] sweep "
        f"{stats['ms_per_step']:.3f} ms/step "
        f"({stats['agg_cell_updates_per_s']:.4e} aggregate cell-updates/s); "
        f"solo {solo_stats['ms_per_step']:.3f} ms/step x {SWEEP_CASES} = "
        f"{solo_stats['ms_per_step'] * SWEEP_CASES:.1f} ms "
        f"({solo_stats['cell_updates_per_s']:.4e} cell-updates/s)")

    # From the state the sweep reached: the kernels against their plain
    # versions (same arithmetic) and against the OFTPP_SWEEP_PALLAS=0 step
    # (the two-sided stencil of the plain path).
    def run(stp, n):
        s = states
        its = []
        for _ in range(n):
            s, dd = stp(s, params)
            its.append(dd.p_iters)
        return s, torch.stack(its).cpu().numpy()

    # Device ops and busy time per step, beside phase 10's tiled sweep.
    stats["ops_per_step"], stats["busy_ms_per_step"] = ops_per_step(
        lambda n: run(sweep_step, n), 2)
    log(f"  sweep step from that state (torch.profiler, 2 steps): "
        f"{stats['ops_per_step']:.1f} device ops, "
        f"{stats['busy_ms_per_step']:.3f} ms busy per step")
    with environ(OFTPP_SWEEP_PALLAS="0"):
        plain_step = make_sweep_step(geom, props, SolverControls(), device=dev)
    s_k, it_k = run(sweep_step, N_CMP)
    with contextlib.ExitStack() as stack:
        for m, attr, plain in counters().values():
            stack.enter_context(mock.patch.object(m, attr, plain))
        s_p, it_p = run(sweep_step, N_CMP)
    s_0, it_0 = run(plain_step, N_CMP)
    torch.cuda.synchronize()
    # The limits of the single-case step (phase 4). Against the
    # OFTPP_SWEEP_PALLAS=0 step the arithmetic differs (face-lite product
    # shifts against the two-sided stencil), so the two CG solves stop on
    # other iterates: each is stopped at 1e-3 of a right-hand side of
    # hydrostatic scale, which leaves up to 1e-3·g·dt of velocity, a floor
    # that counts while the tank has barely begun to move.
    tols = {"alpha": ("abs", 1e-3), "u": ("rel", 1e-2), "v": ("rel", 1e-2),
            "w": ("rel", 1e-2), "p": ("rel", 1e-4)}
    cg_floor = 1e-3 * props.g * float(s_k.dt.max())
    for label, s_ref, it_ref, floor in (
            ("entry points swapped for plain", s_p, it_p, 0.0),
            ("OFTPP_SWEEP_PALLAS=0", s_0, it_0, cg_floor)):
        log(f"[sweep step kernels vs {label}] {N_CMP} steps; largest "
            f"per-case p_iters difference {int(np.abs(it_k - it_ref).max())}")
        bad = []
        for k, (kind_t, tol) in tols.items():
            err, scale = max_err(getattr(s_k, k), getattr(s_ref, k))
            lim = tol if kind_t == "abs" else tol * scale
            if k in "uvw":
                lim += floor
            log(f"  {k}: max_abs_err {err:.3e} limit {lim:.3e} "
                f"(scale {scale:.3e})")
            if err > lim:
                bad.append(f"{k}: {err} > {lim}")
        if bad:
            raise AssertionError(f"sweep step kernels vs {label}: {bad}")
        if np.abs(it_k - it_ref).max() > 1:
            raise AssertionError(f"sweep step kernels vs {label}: p_iters "
                                 "differ by more than 1")
    return launches, {"make_sweep_step": stats, "lockstep_geom": lock_stats,
                      "solo_case": solo_stats}


def phase_manager(dev):
    """The manager's sweep as a user drives it (module docstring, phase
    7). Returns the launch counts of the lockstep `runsweep` and stats."""
    import torch

    from openfoam_tpp_tpu_torch.manager import cli
    from openfoam_tpp_tpu_torch.manager import sweeprun
    from openfoam_tpp_tpu_torch.manager.cases import (expand_sweep,
                                                      is_case_done, setup_case)
    from openfoam_tpp_tpu_torch.utils.io import list_checkpoints, load_checkpoint

    fns = {k: getattr(m, a) for k, (m, a, _) in counters().items()}
    calls = []
    real_run = sweeprun.run_cases_batched

    def run_spy(*a, **k):
        calls.append(real_run(*a, **{**k, "log": lambda ln: log("  | " + ln)}))
        return calls[-1]

    def probe_rows(case_dir, name):
        with open(os.path.join(case_dir, "postProcessing", "probes", "0",
                               name)) as f:
            return np.array([[float(v) for v in ln.split()]
                             for ln in f if not ln.startswith("#")])

    def last(case_dir):
        return load_checkpoint(list_checkpoints(case_dir)[-1][1])

    rows, mode = expand_sweep(MANAGER_SWEEP)
    if mode != "cartesian" or len(rows) != SWEEP_CASES:
        raise AssertionError(f"manager: expand_sweep gave {len(rows)} rows, "
                             f"{mode}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as base, \
            mock.patch.object(sweeprun, "run_cases_batched", run_spy):
        t0 = time.perf_counter()
        dirs = [setup_case(r, base) for r in rows]
        if len(set(dirs)) != SWEEP_CASES:
            raise AssertionError("manager: case names collide")
        log(f"[manager] {len(dirs)} cases set up in "
            f"{time.perf_counter() - t0:.1f} s")
        argv = ["--headless", "--action", "runsweep", "--case", "all",
                "--base-dir", base]
        for f in fns.values():
            f.launches = 0
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if cli.main(argv) != 0 or len(calls) != 1:
            raise AssertionError(f"manager: runsweep failed ({len(calls)} "
                                 "batches)")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sweep_bytes = torch.cuda.max_memory_allocated() - mem0
        launches = {k: f.launches for k, f in fns.items()}
        stats = dict(calls[0])
        steps = stats["steps"]
        log(f"[manager] runsweep: {stats['n_cases']} cases x {steps} steps in "
            f"{wall:.2f} s wall (geometry and case set-up of the batch "
            f"included; stepping and writing {stats['wall_seconds']:.2f} s, "
            f"writing checkpoints and probes {stats['io_seconds']:.2f} s), "
            f"{stats['agg_cell_updates_per_sec']:.4e} aggregate "
            f"cell-updates/s")
        log(f"  kernel launches { {k: v for k, v in launches.items() if v} }")
        # The batch's fluid cells, from its aggregate rate's definition.
        cells = round(stats["agg_cell_updates_per_sec"]
                      * stats["wall_seconds"] / steps)
        log(f"  device bytes of the runsweep (peak above what was allocated "
            f"before it) {sweep_bytes}: {sweep_bytes / SWEEP_CASES:.0f} per "
            f"case, {sweep_bytes / cells:.1f} per fluid cell of the batch "
            f"({cells} cells)")
        ran = {k for k, v in launches.items() if v > 0}
        if ran != set(BATCH_PATH) or stats["n_cases"] != SWEEP_CASES:
            raise AssertionError(f"manager: kernels launched {sorted(ran)}")
        for d in dirs:
            chks = list_checkpoints(d)
            if len(chks) != 3 or not is_case_done(d):
                raise AssertionError(f"manager: checkpoints {chks}")
            for k, (_, path) in enumerate(chks):
                c = load_checkpoint(path)
                want = float(np.float32(k) * np.float32(0.05))
                if float(c["t"]) != want:
                    raise AssertionError(f"manager: {path} holds "
                                         f"t={c['t']!r}, not {want!r}")
                if not all(np.isfinite(c[f]).all()
                           for f in "alpha u v w p".split()):
                    raise AssertionError(f"manager: non-finite field in {path}")
                if c["alpha"].min() < 0.0 or c["alpha"].max() > 1.0:
                    raise AssertionError(f"manager: alpha out of [0, 1] in "
                                         f"{path}")
            if int(c["step"]) != steps:
                raise AssertionError(f"manager: {d} ended at step {c['step']}")
            for name, width in (("p", 3), ("eta", 4)):
                tab = probe_rows(d, name)
                if tab.shape != (steps, width):
                    raise AssertionError(f"manager: probes/0/{name} of {d} is "
                                         f"{tab.shape} for {steps} steps")
        # The water probe of the first case (z = H/4 under a surface at
        # H/2) reads ρ_w·g·depth.
        hydro = 998.2 * 9.81 * (rows[0]["H"] / 4)
        p0 = probe_rows(dirs[0], "p")[0, 1]
        log(f"  first case: water probe first row {p0:.2f} Pa (ρ_w·g·depth "
            f"{hydro:.2f}); 3 checkpoints and {steps} probe rows per case")
        if abs(p0 - hydro) > 0.05 * hydro:
            raise AssertionError("manager: water probe off ρ_w·g·depth")
        # A second runsweep finds every case done; the batch run itself
        # resumes from the last checkpoints and takes 0 steps.
        if cli.main(argv) != 0 or len(calls) != 1:
            raise AssertionError("manager: second runsweep ran a batch")
        if real_run(dirs, log=lambda ln: None)["steps"] != 0:
            raise AssertionError("manager: the resumed batch took steps")

        # --percase-dt: four fresh cases of the default tank, a 20 ms ramp
        # so the stiff case's Courant limit binds.
        lax = dict(H=0.1, D=0.02, mesh=0.002, geo="flat", R=0.0005, freq=1.0,
                   duration=0.05, dt=0.001, ramp=0.02)
        own = [lax, {**lax, "R": 0.002, "freq": 3.0},
               {**lax, "R": 0.003, "freq": 4.5}, {**lax, "R": 0.004, "freq": 6.0}]
        base2 = os.path.join(base, "percase")
        dirs2 = [setup_case(r, base2) for r in own]
        if cli.main(["--headless", "--action", "runsweep", "--case", "all",
                     "--base-dir", base2, "--percase-dt"]) != 0:
            raise AssertionError("manager: runsweep --percase-dt failed")
        own_steps = [int(last(d)["step"]) for d in dirs2]
        log(f"[manager] --percase-dt: steps per case {own_steps} (lax to "
            f"stiff), batch steps {calls[-1]['steps']}")
        for d, n in zip(dirs2, own_steps):
            if float(last(d)["t"]) != float(np.float32(0.05)) \
                    or len(probe_rows(d, "p")) != n:
                raise AssertionError(f"manager: --percase-dt case {d}")
        if not own_steps[0] < own_steps[-1]:
            raise AssertionError("manager: the lax case did not take fewer "
                                 f"steps than the stiff one: {own_steps}")
    return launches, {**stats, "runsweep_wall_seconds": wall,
                      "percase_dt_steps": own_steps,
                      "device_bytes": sweep_bytes, "fluid_cells": cells}


class _Tee:
    """sys.stdout for a block: every line logged (indented) and kept."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def value(self):
        return "".join(self.text)


@contextlib.contextmanager
def tee_stdout():
    """Keep what the block prints to stdout (still shown)."""
    tee = _Tee(sys.stdout)
    saved, sys.stdout = sys.stdout, tee
    try:
        yield tee
    finally:
        sys.stdout = saved


def video_frames(path):
    """Frames decoded from the video at `path`: an MJPEG AVI's JPEG chunks
    through PIL, an MP4 through cv2; None when no decoder is present."""
    if path.endswith(".avi"):
        try:
            from PIL import Image
        except ImportError:
            return None
        import io

        data = open(path, "rb").read()
        pos, frames = data.index(b"movi") + 4, []
        while data[pos:pos + 4] == b"00dc":
            size = int.from_bytes(data[pos + 4:pos + 8], "little")
            frames.append(np.asarray(Image.open(io.BytesIO(
                data[pos + 8:pos + 8 + size])).convert("RGB")))
            pos += 8 + size + size % 2
        return frames
    try:
        import cv2
    except ImportError:
        return None
    cap, frames = cv2.VideoCapture(path), []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(fr)
    cap.release()
    return frames


def phase_top(dev, base, case):
    """The manager's top layer on phase 5's flagship case (module
    docstring, phase 11). Returns its numbers."""
    import shutil
    import torch

    from openfoam_tpp_tpu_torch.config import (PhysicalProperties,
                                               SolverControls)
    from openfoam_tpp_tpu_torch.core.state import CaseParams
    from openfoam_tpp_tpu_torch.manager import cli
    from openfoam_tpp_tpu_torch.manager.cases import setup_case
    from openfoam_tpp_tpu_torch.manager.runner import (get_compiled_advance,
                                                       run_case)
    from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as mfx
    from openfoam_tpp_tpu_torch.post import avi
    from openfoam_tpp_tpu_torch.solver import poisson
    from openfoam_tpp_tpu_torch.utils import nan_trap
    from openfoam_tpp_tpu_torch.utils import potential_flow as pf
    from openfoam_tpp_tpu_torch.utils.io import (list_checkpoints,
                                                 load_checkpoint, to_state)

    case_dir = case["case_dir"]
    name = os.path.basename(case_dir)
    out = {}

    def headless(*argv):
        with tee_stdout() as tee:
            rc = cli.main(["--headless", "--base-dir", base, "--case", name,
                           *argv])
        return rc, tee.value()

    # (a) --action flow: the reference's post_flow.117896.out oracle.
    t0 = time.perf_counter()
    rc, text = headless("--action", "flow")
    csv = os.path.join(case_dir, "postProcessing", "potential_flow",
                       "potential_flow_wall.csv")
    with open(csv) as f:
        rows = f.read().splitlines()
    a_pt = float(rows[1].split(",")[2])       # t = 0, θ = 0: A_PT cos 0
    froude = float(re.search(r"Froude Number \(F\):\s+([0-9.]+)",
                             text).group(1))
    want_rows = 1 + len(np.arange(0.0, 0.1 + 0.01, 0.01)) * 64
    log(f"[top: flow] rc {rc}; A_PT {a_pt:.6e} m (oracle 3.146940e-02), F "
        f"{froude} (oracle 0.056894); {len(rows)} CSV rows ({want_rows} "
        f"expected); {time.perf_counter() - t0:.2f} s")
    if (rc != 0 or abs(a_pt - 3.146940e-02) > 1e-7
            or abs(froude - 0.056894) > 1e-6 or len(rows) != want_rows):
        raise AssertionError("top: flow verb off its oracle")
    out["flow"] = {"A_PT": a_pt, "F": froude, "rows": len(rows)}

    # (b) --action video on the three snapshots.
    have = {}
    for mod in ("matplotlib", "PIL", "imageio", "cv2"):
        try:
            have[mod] = getattr(__import__(mod), "__version__", "?")
        except ImportError:
            have[mod] = None
    log(f"[top: video] host libraries {have}")
    encodes, dash_s = [], []
    real_save, real_dash = avi.save_video, pf.generate_dashboard_animation

    def save_spy(path, frames, *a, **k):
        t = time.perf_counter()
        got = real_save(path, frames, *a, **k)
        encodes.append((got, len(frames), frames[0].shape,
                        time.perf_counter() - t))
        return got

    def dash_spy(*a, **k):
        t = time.perf_counter()
        got = real_dash(*a, **k)
        dash_s.append(time.perf_counter() - t)
        return got

    t0 = time.perf_counter()
    with mock.patch.object(avi, "save_video", save_spy), \
            mock.patch.object(pf, "generate_dashboard_animation", dash_spy):
        rc, text = headless("--action", "video")
    video_s = time.perf_counter() - t0
    if have["matplotlib"] is None:
        log("[top: video] no video rendered: matplotlib is missing here, and "
            f"the verb refuses as the JAX package's does (rc {rc})")
        if rc != 1 or "matplotlib not available" not in text:
            raise AssertionError(f"top: video without matplotlib: rc {rc}")
        out["video"] = {"libraries": have, "rendered": False}
    else:
        path, n_frames, shape, enc_s = encodes[0]
        frames = video_frames(path)
        render_s = video_s - sum(dash_s) - enc_s
        log(f"[top: video] rc {rc}; {path} ({os.path.getsize(path)} bytes), "
            f"{n_frames} frames of {shape}, "
            f"{'%d decoded' % len(frames) if frames is not None else 'no decoder'}"
            f"; render {render_s / n_frames:.2f} s per frame, encode "
            f"{enc_s:.2f} s, dashboard {sum(dash_s):.2f} s "
            f"({encodes[-1][1]} frames); {video_s:.2f} s in all")
        if (rc != 0 or n_frames != 3 or not os.path.getsize(path)
                or (frames is not None and len(frames) != 3)
                or len(dash_s) != 1):
            raise AssertionError(f"top: video rc {rc}, {encodes}")
        out["video"] = {"libraries": have, "rendered": True, "path": path,
                        "frames": n_frames,
                        "render_s_per_frame": render_s / n_frames,
                        "encode_s": enc_s, "dashboard_s": dash_s[0],
                        "dashboard_frames": encodes[-1][1]}

    # (d) --submit on that case, then the job's body run with bash. The
    # job starts in the directory the script was written from: this
    # checkout's root, where `python -m openfoam_tpp_tpu_torch` resolves.
    with contextlib.chdir(os.path.dirname(os.path.abspath(__file__))):
        rc, text = headless("--action", "run", "--submit")
    script = os.path.join(case_dir, "run_simulation.slurm")
    with open(script) as f:
        body = f.read()
    sbatch = [ln for ln in body.splitlines() if ln.startswith("#SBATCH")]
    log(f"[top: submit] rc {rc} (sbatch {shutil.which('sbatch')}); {sbatch}")
    if (rc != (0 if shutil.which("sbatch") else 1)
            or "#SBATCH --gres=gpu:1" not in sbatch
            or "#SBATCH --nodes=1" not in sbatch
            or "#SBATCH --partition=gpu" not in sbatch):
        raise AssertionError("top: submit script")
    # The job runs `python`: this interpreter, under that name.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bin_") as bin_dir:
        shim = os.path.join(bin_dir, "python")
        with open(shim, "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        os.chmod(shim, 0o755)
        t0 = time.perf_counter()
        job = subprocess.run(
            ["bash", script], capture_output=True, text=True, timeout=600,
            env={**os.environ, "PATH": bin_dir + os.pathsep
                 + os.environ.get("PATH", "")})
    job_s = time.perf_counter() - t0
    log("  | " + "\n  | ".join(job.stdout.strip().splitlines()[-4:]))
    log(f"[top: submit] the job's body: rc {job.returncode} in {job_s:.1f} s")
    if (job.returncode != 0 or "Resuming" not in job.stdout
            or "Done: 0 steps" not in job.stdout):
        raise AssertionError(f"top: the job's body failed: {job.stderr[-2000:]}")
    out["submit"] = {"sbatch_lines": sbatch, "job_seconds": job_s}

    # (e) OFTPP_DEBUG_NANS=1 from phase 5's t = 0.05 checkpoint, in fresh
    # cases of duration 0.06 s.
    src = load_checkpoint(os.path.join(case_dir, "chk_t0.050000.npz"))
    trap_params = {**case["params"], "duration": 0.06}

    def fresh(label, payload):
        d = setup_case(trap_params, os.path.join(base, label))
        np.savez(os.path.join(d, "chk_t0.050000.npz"), **payload)
        return d

    def trapped_run(label, payload, env):
        d = fresh(label, payload)
        iters = []
        real_pcg = poisson.solve_pcg

        def pcg(*a, **k):
            res = real_pcg(*a, **k)
            iters.append(int(res[2]))
            return res

        lines = []
        with environ(**env), mock.patch.object(poisson, "solve_pcg", pcg):
            stats = run_case(d, log=lines.append)
        torch.cuda.synchronize()
        return d, stats, iters, lines

    runs = {}
    for label, env in (("off", {}), ("on", {"OFTPP_DEBUG_NANS": "1"})):
        d, stats, iters, lines = trapped_run(f"trap_{label}", src, env)
        last = load_checkpoint(list_checkpoints(d)[-1][1])
        runs[label] = (stats, iters, last, lines)
    (s_off, i_off, c_off, _), (s_on, i_on, c_on, l_on) = runs["off"], runs["on"]
    if not any("NaN trap on" in ln for ln in l_on):
        raise AssertionError("top: the trap did not say it was on")
    diffs = {f: float(np.max(np.abs(c_on[f].astype(np.float64) - c_off[f])))
             for f in "alpha u v w p".split()}
    bitwise = all(np.array_equal(c_on[f], c_off[f]) for f in c_off)
    log(f"[top: trap] clean run_case from t=0.05 to 0.06: {s_on['steps']} "
        f"steps; fields bitwise equal {bitwise} (max |on - off| {diffs}); "
        f"p_iters on {i_on}, off {i_off}")
    if not bitwise:
        for f, (kind, lim) in CMP_TOLS.items():
            scale = 1.0 if kind == "abs" else max(
                float(np.max(np.abs(c_off[f]))), 1e-30)
            if diffs[f] > lim * scale:
                raise AssertionError(f"top: trap on/off {f} differs by "
                                     f"{diffs[f]}")
    if i_on != i_off or s_on["steps"] != s_off["steps"]:
        raise AssertionError("top: p_iters or steps differ with the trap on")
    # The trap's cost: run_case's advance from the same checkpoint to
    # t = TRAP_T_END, off, on, off, on (no checkpoint or probe writes).
    geom, advance = get_compiled_advance(case["params"], PhysicalProperties(),
                                         SolverControls(), case_dir,
                                         device=dev)
    cp = CaseParams.make(R=case["params"]["R"], freq=case["params"]["freq"],
                         duration=TRAP_T_END, ramp=case["params"]["ramp"],
                         device=dev)
    timing, ends = {"off": [], "on": []}, {}
    for on in (False, True, False, True):
        state = to_state(src, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with nan_trap.trap_nans(on) as trap:
            state, _, n, _ = advance(state, cp, TRAP_T_END)
            torch.cuda.synchronize()
        label = "on" if on else "off"
        timing[label].append((time.perf_counter() - t0) / n * 1e3)
        ends.setdefault(label, (n, state, trap.checked if on else 0))
    n_on, st_on, checked = ends["on"]
    n_off, st_off, _ = ends["off"]
    adv_bitwise = n_on == n_off and all(
        torch.equal(getattr(st_on, f), getattr(st_off, f))
        for f in ("alpha", "u", "v", "w", "p", "t", "dt"))
    ms_on, ms_off = min(timing["on"]), min(timing["off"])
    log(f"[top: trap] advance from t=0.05 to {TRAP_T_END}: {n_on} steps; "
        f"trap on {timing['on']} ms/step, off {timing['off']} ms/step "
        f"(host wall, off/on/off/on); {checked / n_on:.0f} outputs checked a "
        f"step; fields bitwise equal {adv_bitwise}")
    if not adv_bitwise:
        raise AssertionError("top: the trapped advance is not bitwise")

    bad = dict(src)
    bad["u"] = bad["u"].copy()
    nx, ny, nz = bad["u"].shape
    bad["u"][nx // 2, ny // 2, nz // 4] = np.nan
    d = fresh("trap_nan", bad)
    try:
        with environ(OFTPP_DEBUG_NANS="1"):
            run_case(d, log=lambda ln: None)
    except FloatingPointError as e:
        nan_msg = str(e)
    else:
        raise AssertionError("top: a NaN in u did not trap")
    chks = [t for t, _ in list_checkpoints(d)]
    log(f"[top: trap] NaN in u[{nx // 2}, {ny // 2}, {nz // 4}]: "
        f"FloatingPointError: {nan_msg}; checkpoints after it {chks}")
    if "step 1 " not in nan_msg or " at openfoam_tpp_tpu_torch/" not in nan_msg \
            or len(chks) != 1:
        raise AssertionError("top: the NaN trap's error or writes")

    # A NaN that first comes out of a CUDA kernel: the MULES flux kernel
    # on the flagship grid with one NaN in alpha.
    g = torch.Generator(device=dev).manual_seed(11)
    shape = tuple(src["alpha"].shape)
    alpha = torch.rand(shape, device=dev, generator=g)
    alpha[shape[0] // 2, shape[1] // 2, shape[2] // 2] = float("nan")
    ones = tuple(torch.ones(shape, device=dev) for _ in range(3))
    try:
        with nan_trap.trap_nans(True):
            mfx.flux_all(alpha, ones, ones)
    except FloatingPointError as e:
        kernel_msg = str(e)
    else:
        raise AssertionError("top: the kernel hook did not fire")
    log(f"[top: trap] NaN operand of flux_all: FloatingPointError: "
        f"{kernel_msg}")
    if "CUDA kernel flux_all (mules_flux)" not in kernel_msg:
        raise AssertionError("top: the kernel hook's error")
    out["trap"] = {"steps": n_on, "ms_per_step_on": timing["on"],
                   "ms_per_step_off": timing["off"], "bitwise": bitwise,
                   "outputs_checked_per_step": checked / n_on,
                   "nan_error": nan_msg, "kernel_error": kernel_msg}
    return out



def phase_menu(base):
    """(c) The interactive menu in this process on piped answers: build
    the flagship (0.02 s), run it on the default device, postprocess it
    with flow and interface, exit. Returns its numbers."""
    import io
    import shutil
    import torch

    from openfoam_tpp_tpu_torch.config import DEFAULTS
    from openfoam_tpp_tpu_torch.manager import cli
    from openfoam_tpp_tpu_torch.manager.cases import list_cases, setup_case
    from openfoam_tpp_tpu_torch.utils.io import list_checkpoints, load_checkpoint

    menu_base = os.path.join(base, "menu")
    os.makedirs(menu_base)
    build = [str(MENU_CASE[k]) for k in DEFAULTS if k != "n_cpus"]
    run = ["2", "1"] + (["n"] if shutil.which("sbatch") else [])
    answers = ["1", *build, *run, "3", "1", "3", "3", "1", "2", "6"]
    fns = {k: getattr(m, a) for k, (m, a, _) in counters().items()}
    for f in fns.values():
        f.launches = 0
    saved_in, sys.stdin = sys.stdin, io.StringIO("\n".join(answers) + "\n")
    t0 = time.perf_counter()
    try:
        with tee_stdout() as tee:
            rc = cli.main(["--base-dir", menu_base])
    finally:
        sys.stdin = saved_in
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in fns.items() if f.launches}
    text = tee.value()
    names = list_cases(menu_base)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ref_") as ref:
        with open(os.path.join(setup_case(MENU_CASE, ref), "case.json"),
                  "rb") as f:
            want = f.read()
    case_dir = os.path.join(menu_base, names[0])
    with open(os.path.join(case_dir, "case.json"), "rb") as f:
        got = f.read()
    chks = list_checkpoints(case_dir)
    c = load_checkpoint(chks[-1][1])
    steps = int(c["step"])
    courants = [float(x) for x in re.findall(r"\bCo = ([0-9.eE+-]+)", text)]
    iters = [int(x) for x in re.findall(r"p: iters (\d+)", text)]
    rate = re.search(r"\(([0-9.e+-]+) cell-updates/s\)", text)
    log(f"\n[top: menu] rc {rc} in {wall:.1f} s; cases {names}; case.json "
        f"byte-equal to setup_case's {got == want}; {steps} steps to "
        f"t={float(c['t'])!r}; Courant per write {courants}, p iters {iters}; "
        f"{rate.group(1) if rate else '?'} cell-updates/s; kernel launches "
        f"{launches}")
    want_per_step = {"flux_all": 3, "fct_iter": 9, "momentum_rhs": 1,
                     "correct_divmax": 1}
    if (rc != 0 or len(names) != 1 or got != want or steps == 0
            or set(launches) != set(DEFAULT_PATH)
            or any(launches[k] != n * steps for k, n in want_per_step.items())):
        raise AssertionError("top: menu run")
    if float(c["t"]) != float(np.float32(0.02)) or len(chks) != 2:
        raise AssertionError(f"top: menu checkpoints {chks}")
    fields = [c[f] for f in "alpha u v w p".split()]
    if (not all(np.isfinite(v).all() for v in fields)
            or c["alpha"].min() < 0.0 or c["alpha"].max() > 1.0
            or not courants or max(courants) > 0.6
            or not iters or max(iters) >= 50):
        raise AssertionError("top: menu run's checks")
    post = os.path.join(case_dir, "postProcessing")
    for f in ("potential_flow/potential_flow_wall.csv",
              "interface/interface_summary.csv"):
        if not os.path.getsize(os.path.join(post, f)):
            raise AssertionError(f"top: menu postprocess wrote no {f}")
    return {"rc": rc, "wall_seconds": wall, "steps": steps,
            "launches": launches,
            "cell_updates_per_s": float(rate.group(1)) if rate else None}


def resource_constants(case, manager):
    """utils/resources.py's constants as this run measured them: phase 5's
    run_case rate and device bytes per fluid cell, phase 7's per fluid
    cell of the 128-case batch, and the card's memory."""
    import torch

    from openfoam_tpp_tpu_torch.utils import resources

    got = {"GPU_CELL_UPDATES_PER_SEC": case["cell_steps_per_sec"],
           "BYTES_PER_CELL": case["device_bytes"] / case["n_cells"],
           "SWEEP_BYTES_PER_CELL": (manager["device_bytes"]
                                    / manager["fluid_cells"]),
           "DEVICE_BYTES": torch.cuda.get_device_properties(0).total_memory}
    log("[top: resource constants] measured in this run / in "
        "utils/resources.py: " + "; ".join(
            f"{k} {v:.6g} / {getattr(resources, k):.6g}"
            for k, v in got.items()))
    return got


def tank6dof_motion(dev, dt):
    """The reference gen6DoF sine table (100 rows over 40 s), resampled as
    `build_case_motion` does for a case of initial step `dt`."""
    from openfoam_tpp_tpu_torch.core.motion import TableMotion
    from openfoam_tpp_tpu_torch.utils.io import (generate_sine_motion_table,
                                                 read_6dof_table)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_6dof_") as d:
        rows = read_6dof_table(generate_sine_motion_table(
            os.path.join(d, "6DoF.dat")))
    return TableMotion.from_table(*rows, resample_dt=min(0.05, dt * 10),
                                  device=dev)


def phase_6dof(dev, props, rows):
    """The 6DoF path (module docstring, phase 8): the chamfered tutorial
    tank at full size from rest, the finish-gated step, kernels against
    plain versions, one step's closed-top `correct_divmax` call, then the
    case path. Returns the phase's stats."""
    import torch

    from openfoam_tpp_tpu_torch.config import SolverControls
    from openfoam_tpp_tpu_torch.core.state import (CaseParams, init_state,
                                                   state_to_numpy)
    from openfoam_tpp_tpu_torch.manager.cases import (is_case_done,
                                                      setup_case_6dof)
    from openfoam_tpp_tpu_torch.manager.runner import run_case
    from openfoam_tpp_tpu_torch.mesh import build_chamfer_tank_geometry
    from openfoam_tpp_tpu_torch.ops.kernels import correction as ck
    from openfoam_tpp_tpu_torch.solver import frame as fr
    from openfoam_tpp_tpu_torch.solver import poisson
    from openfoam_tpp_tpu_torch.solver.timestep import make_step
    from openfoam_tpp_tpu_torch.utils.io import list_checkpoints, load_checkpoint

    t0 = time.perf_counter()
    geom = build_chamfer_tank_geometry(**TANK6DOF)
    n_fluid = geom.n_fluid_cells
    sealed = bool(np.all(geom.ax[-1] == 0.0))
    log(f"[6DoF geometry] chamfered tank {geom.shape}, {n_fluid} fluid "
        f"cells, spacing {geom.spacing}, +x face sealed {sealed}, "
        f"{time.perf_counter() - t0:.1f} s")
    if (tuple(geom.shape) != SHAPE_6DOF or n_fluid != FLUID_6DOF
            or not sealed):
        raise AssertionError(f"6DoF geometry is not the {SHAPE_6DOF} "
                             f"chamfered tank with {FLUID_6DOF} fluid cells "
                             "and a sealed +x face")
    motion = tank6dof_motion(dev, DT0_6DOF)
    params = CaseParams.make(R=0.0, freq=0.0, duration=40.0, device=dev)

    def build(**env):
        with environ(**env):   # gates and knobs are read at build time
            return make_step(geom, props, SolverControls(use_pallas=True),
                             motion=motion, carry_precond=True, device=dev)

    # correct_divmax through a spy that records its form (the count lands
    # on the spy while it stands in for the entry point).
    forms = []
    real_corr = ck.correct_divmax

    def corr(*a, **k):
        forms.append(k["open_top"])
        return real_corr(*a, **k)

    corr.launches = 0
    step = build()
    state = init_state(geom, fill_height=0.0, dt0=DT0_6DOF, device=dev)
    with mock.patch.object(ck, "correct_divmax", corr):
        state, _, _, stats = drive(
            "6DoF step: chamfered tank, use_pallas=True, from rest", step,
            state, step.init_precond(state), params, N_6DOF, N_6DOF_TIMED,
            n_fluid, DEFAULT_PATH)
        forms_main = list(forms)
        with environ(OFTPP_FINISH_PALLAS="1"):
            finish_step = build()
        _, _, _, finish = drive(
            "6DoF step built with OFTPP_FINISH_PALLAS=1, same state",
            finish_step, state, finish_step.init_precond(state), params,
            N_6DOF_FINISH, N_6DOF_FINISH, n_fluid, DEFAULT_PATH)
    if forms != [False] * (N_6DOF + N_6DOF_FINISH):
        raise AssertionError(f"6DoF step: correct_divmax forms {forms}")
    omega, domega = fr.angular_rates(motion, state.t)
    stats["omega_norm"] = float(torch.linalg.vector_norm(omega))
    stats["domega_norm"] = float(torch.linalg.vector_norm(domega))
    log(f"  correct_divmax took the closed-top form in all {len(forms_main)}"
        f" + {N_6DOF_FINISH} calls; at t={float(state.t):.4f} s "
        f"|ω|={stats['omega_norm']:.4e} rad/s, |dω|="
        f"{stats['domega_norm']:.4e} rad/s²; momentum_finish launched 0 "
        "times with OFTPP_FINISH_PALLAS=1 (rotating frame)")
    if stats["omega_norm"] == 0.0 or stats["domega_norm"] == 0.0:
        raise AssertionError("6DoF step: the frame's rates are zero")

    # The whole step, kernels against plain versions, from that state:
    # p after each field's fluid mean is removed (the closed tank's p is
    # defined up to a constant).
    vs_plain = hold_to_plain(
        "6DoF step", steps_from(step, state, params),
        mean_removed=torch.as_tensor(geom.vfrac > 0, device=dev))

    # One 6DoF step's correct_divmax call (the closed-top form), held
    # bitwise against its plain version and timed beside row 7.
    log("[6DoF step operands: the closed-top correct_divmax call]")
    own = {"correct_divmax": {}}
    phase_step_operands(step, state, params, own, ("correct_divmax",))
    closed = own["correct_divmax"]
    nx, ny, nz = geom.shape
    face = (nx + 1) * ny * nz + nx * (ny + 1) * nz + nx * ny * (nz + 1)
    # phase 2's count: dp, vfrac and the top density plane in; u, v, w,
    # β and the apertures in, u, v, w out (no atmosphere plane: the top
    # is closed).
    closed["bytes"] = 4 * (2 * nx * ny * nz + nx * ny + 4 * face)
    closed["bound_ms"] = closed["bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"  closed top at {geom.shape}: {closed['step_ms'] * 1e3:.1f} us, "
        f"{closed['bytes'] / 1e6:.2f} MB, bound "
        f"{closed['bound_ms'] * 1e3:.2f} us "
        f"({closed['step_ms'] / closed['bound_ms']:.2f}x); row 7 (open top, "
        f"112^3): {rows['correct_divmax']['ms'] * 1e3:.1f} us phase 2, "
        f"{rows['correct_divmax']['step_ms'] * 1e3:.1f} us on a flagship "
        "step's operands")
    if not closed["step_bitwise"]:
        raise AssertionError("6DoF step: the closed-top correct_divmax call "
                             "is not bitwise equal to its plain version")

    # The case path: setup_case_6dof, run_case on the card, resume.
    case = {"Lx": TANK6DOF["Lx"], "Ly": TANK6DOF["Ly"],
            "Lz": TANK6DOF["Lz"], "mesh": TANK6DOF["mesh"],
            "chamfer": TANK6DOF["chamfer"], "duration": 0.1,
            "dt": DT0_6DOF}
    fns = {k: getattr(m, a) for k, (m, a, _) in counters().items()}
    solves = []
    real_pcg = poisson.solve_pcg

    def pcg(*a, **k):
        res = real_pcg(*a, **k)
        solves.append(int(res[2]))
        return res

    with tempfile.TemporaryDirectory(prefix="chip_smoke_6dof_case_") as base:
        case_dir = setup_case_6dof(case, base)
        for f in fns.values():
            f.launches = 0
        lines = []
        with mock.patch.object(poisson, "solve_pcg", pcg):
            run_stats = run_case(case_dir, log=lambda ln: (
                lines.append(ln), log("  | " + ln)))
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in fns.items()}
        log(f"[6DoF case path] {run_stats['steps']} steps to "
            f"t={run_stats['sim_seconds']:.3f} s in "
            f"{run_stats['wall_seconds']:.2f} s wall, writing "
            f"{run_stats['io_seconds']:.2f} s; kernel launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if {k for k, v in launches.items() if v} != set(DEFAULT_PATH):
            raise AssertionError(f"6DoF case path: kernels launched "
                                 f"{launches}")
        chks = list_checkpoints(case_dir)
        if len(chks) < 2:
            raise AssertionError(f"6DoF case path: checkpoints {chks}")
        for k, (_, path) in enumerate(chks):
            c = load_checkpoint(path)
            want = float(np.float32(k) * np.float32(0.05))
            if float(c["t"]) != want:
                raise AssertionError(f"6DoF case path: {path} holds "
                                     f"t={c['t']!r}, not {want!r}")
            if not all(np.isfinite(c[f]).all() for f in "alpha u v w p".split()):
                raise AssertionError(f"6DoF case path: non-finite field in "
                                     f"{path}")
            if c["alpha"].min() < 0.0 or c["alpha"].max() > 1.0:
                raise AssertionError(f"6DoF case path: alpha out of [0, 1] "
                                     f"in {path}")
        if not is_case_done(case_dir) or int(c["step"]) != run_stats["steps"]:
            raise AssertionError("6DoF case path: the last checkpoint is not "
                                 "the run's end")
        lines2 = []
        again = run_case(case_dir, log=lines2.append)
        if again["steps"] != 0 or not any("Resuming" in ln for ln in lines2):
            raise AssertionError(f"6DoF case path: second run {again}, "
                                 f"{lines2}")
        # Phase 12e holds the case over ranks against this lone run: its
        # files, checkpoints, write times and p_iters.
        lone = {"case": case, "p_iters": solves,
                "first_interval_steps": run_stats["intervals"][0]["steps"],
                "times": [float(load_checkpoint(p)["t"]) for _, p in chks],
                "final": load_checkpoint(chks[-1][1])}
        for key, rel in (("case_json", "case.json"),
                         ("table", os.path.join("constant", "6DoF.dat")),
                         ("first_checkpoint", chks[1][1])):
            with open(os.path.join(case_dir, rel), "rb") as f:
                lone[key] = f.read()
    return {"step": stats, "finish_gated": finish,
            "closed_top_correct_divmax": closed,
            "kernels_vs_plain_p_iters": vs_plain["p_iters"],
            "case_path": {k: run_stats[k] for k in
                          ("n_cells", "steps", "wall_seconds", "sim_seconds",
                           "io_seconds", "intervals")},
            "state": state_to_numpy(state), "lone_run": lone}


def steps_from(step, state, params):
    """`run(n) -> (state, p_iters list)`: n steps of a carry_precond step
    from `state`, with a fresh preconditioner bundle."""
    def run(n):
        s, b, its = state, step.init_precond(state), []
        for _ in range(n):
            s, d, b = step(s, params, precond=b)
            its.append(int(d.p_iters))
        return s, its
    return run


def hold_to_plain(label, run, mean_removed=None):
    """`run(n) -> (state, p_iters list)` N_CMP steps with the kernels, then
    N_CMP with every entry point swapped for its plain version; the fields
    within CMP_TOLS (phase 4's limits), p_iters within 1. With
    `mean_removed` (a fluid mask) p is compared after each field's fluid
    mean is removed. Returns the errors."""
    import torch

    s_k, it_k = run(N_CMP)
    with contextlib.ExitStack() as stack:
        for m, attr, plain in counters().values():
            stack.enter_context(mock.patch.object(m, attr, plain))
        s_p, it_p = run(N_CMP)
    torch.cuda.synchronize()
    log(f"[{label}: kernels vs plain] {N_CMP} steps; p_iters kernels "
        f"{it_k} plain {it_p}")
    out, bad = {"p_iters": [it_k, it_p]}, []
    for k, (kind_t, tol) in CMP_TOLS.items():
        got, ref = getattr(s_k, k), getattr(s_p, k)
        if k == "p" and mean_removed is not None:
            got, ref = (torch.where(mean_removed, x - x[mean_removed].mean(),
                                    0.0) for x in (got, ref))
        err, scale = max_err(got, ref)
        lim = tol if kind_t == "abs" else tol * scale
        out[k] = {"max_abs_err": err, "scale": scale, "limit": lim}
        log(f"  {k}: max_abs_err {err:.3e} limit {lim:.3e} (scale "
            f"{scale:.3e})")
        if err > lim:
            bad.append(f"{k}: {err} > {lim}")
    if any(abs(a - b) > 1 for a, b in zip(it_k, it_p)):
        bad.append(f"p_iters differ by more than 1: {it_k} {it_p}")
    if bad:
        raise AssertionError(f"{label} kernels vs plain: {bad}")
    return out


def ops_per_step(run, n):
    """(device ops, device busy ms) per step of `run(n)`, which takes n
    steps, under torch.profiler after one untraced step: the larger of
    the trace's device events (kernels, copies, fills) and its launch
    API calls, as `cuda_launches` counts; busy is the union of the
    device events' intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from openfoam_tpp_tpu_torch.utils.devtime import busy_union_us

    run(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(n)
        torch.cuda.synchronize()
    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    n_dev = sum(1 for e in events if e.device_type == cuda)
    n_api = sum(1 for e in events if e.name in LAUNCH_APIS)
    return max(n_dev, n_api) / n, busy_union_us(events) / n / 1e3


def phase_csf(dev, geom, props, params, default_step, main_stats):
    """Surface tension on the flagship (module docstring, phase 9):
    water's σ, use_pallas=True, N_CSF steps from rest; the step built
    with OFTPP_FINISH_PALLAS=1 from that state; whether the capillary
    bound binds; ops per step against the σ = 0 step from the same state,
    and the ops of the step's CSF calls alone; kernels against plain
    versions. Returns the phase's stats and the launch counts of its main
    run."""
    import dataclasses

    import torch

    from openfoam_tpp_tpu_torch.config import SolverControls
    from openfoam_tpp_tpu_torch.core.state import init_state, mixture_density
    from openfoam_tpp_tpu_torch.ops import stencil as st
    from openfoam_tpp_tpu_torch.solver import momentum as mom
    from openfoam_tpp_tpu_torch.solver.timestep import (capillary_dt,
                                                        geometry_arrays,
                                                        make_step)

    csf = dataclasses.replace(props, sigma=SIGMA_WATER)
    n_fluid = geom.n_fluid_cells

    def build(**env):
        with environ(**env):   # gates and knobs are read at build time
            return make_step(geom, csf, SolverControls(use_pallas=True),
                             carry_precond=True, device=dev)

    step = build()
    state = init_state(geom, dt0=1e-3, device=dev)
    state, _, launches, stats = drive(
        f"CSF step: sigma {SIGMA_WATER} N/m, use_pallas=True, from rest",
        step, state, step.init_precond(state), params, N_CSF, N_CSF_TIMED,
        n_fluid, DEFAULT_PATH)
    # The capillary bound as the step forms it, in f32.
    h = np.float32(min(geom.spacing))
    dt_cap = float(np.float32(SolverControls().max_capillary_co) * np.sqrt(
        np.float32(csf.rho1 + csf.rho2) * (h * h * h)
        / np.float32(4.0 * np.pi * SIGMA_WATER)))
    dts = stats["dt_cfl"]
    binds = [i for i, d in enumerate(dts) if abs(d - dt_cap) <= 1e-6 * dt_cap]
    stats["dt_cap"], stats["cap_binds_at_steps"] = dt_cap, binds
    ga = geometry_arrays(geom, device=dev)
    kappa = mom.curvature(state.alpha, geom.spacing, vfrac=ga["vfrac"])
    # Where the smoothed alpha is neither 0 nor 1: where CSF acts.
    band = (mom.smooth_alpha(state.alpha) - 0.5).abs() < 0.49
    stats["max_abs_kappa_band"] = float(kappa[band].abs().max())
    water = state.alpha > 0.5
    for name, q, ax in (("u", state.u, 0), ("v", state.v, 1),
                        ("w", state.w, 2)):
        wet = st.cells_to_faces_avg(water.float(), ax) > 0.5
        stats[f"max_abs_{name}_water"] = float(q[wet].abs().max())
        stats[f"max_abs_{name}_air"] = float(q[~wet].abs().max())
    log("  largest |u|, |v|, |w| at faces in water / air (m/s): " + "; ".join(
        f"{q} {stats[f'max_abs_{q}_water']:.3e} / "
        f"{stats[f'max_abs_{q}_air']:.3e}" for q in "uvw")
        + f"; sqrt(sigma / (rho_w h)) "
        f"{np.sqrt(SIGMA_WATER / (csf.rho1 * float(h))):.3e}")
    log(f"  capillary bound {dt_cap:.4e} s binds at {len(binds)} of "
        f"{N_CSF} steps ({binds}); CFL dt in [{min(dts):.4e}, "
        f"{max(dts):.4e}] s; max |kappa| in the interface band "
        f"{stats['max_abs_kappa_band']:.4e} 1/m; flagship sigma = 0 "
        f"(phase 3): {main_stats['ms_per_step']:.3f} ms/step")
    if max(dts) > dt_cap * (1 + 1e-6):
        raise AssertionError(f"CSF step: a CFL dt {max(dts)} above the "
                             f"capillary bound {dt_cap}")
    gated = build(OFTPP_FINISH_PALLAS="1")
    _, _, _, stats["finish_gated"] = drive(
        "CSF step built with OFTPP_FINISH_PALLAS=1, same state", gated,
        state, gated.init_precond(state), params, N_GATED, N_GATED, n_fluid,
        DEFAULT_PATH)
    log("  momentum_finish launched 0 times with OFTPP_FINISH_PALLAS=1 "
        "(kappa is set)")

    stats["ops_per_step"], stats["busy_ms_per_step"] = ops_per_step(
        steps_from(step, state, params), 2)
    stats["sigma0_ops_per_step"], stats["sigma0_busy_ms_per_step"] = \
        ops_per_step(steps_from(default_step, state, params), 2)

    # The step's CSF calls alone, on the state reached: the capillary
    # bound, κ, the three face sources and their dt·source adds.
    controls = SolverControls()
    beta = [1.0 / st.cells_to_faces_avg(mixture_density(state.alpha, csf),
                                        ax) for ax in range(3)]
    vels = (state.u, state.v, state.w)

    def csf_alone(n):
        for _ in range(n):
            capillary_dt(csf, controls, geom.spacing, torch.float32, dev)
            k = mom.curvature(state.alpha, geom.spacing, vfrac=ga["vfrac"],
                              method=controls.csf_curvature)
            for ax in range(3):
                vels[ax] + state.dt * mom.csf_force(
                    state.alpha, k, csf.sigma, ax, geom.spacing[ax], beta[ax])

    stats["csf_own_ops_per_step"], stats["csf_own_busy_ms_per_step"] = \
        ops_per_step(csf_alone, 2)
    log(f"[CSF vs sigma = 0, same state, torch.profiler, 2 steps] CSF "
        f"{stats['ops_per_step']:.1f} device ops, "
        f"{stats['busy_ms_per_step']:.3f} ms busy per step; sigma = 0 "
        f"{stats['sigma0_ops_per_step']:.1f}, "
        f"{stats['sigma0_busy_ms_per_step']:.3f} (its dt grows past the "
        f"capillary bound, and its CG takes more iterations); the step's "
        f"CSF calls alone {stats['csf_own_ops_per_step']:.1f} ops, "
        f"{stats['csf_own_busy_ms_per_step']:.3f} ms busy")
    stats["vs_plain"] = hold_to_plain("CSF step",
                                      steps_from(step, state, params))
    return stats, launches


def phase_tiled(dev, props, sweep):
    """The tiled sweep (module docstring, phase 10): 128 cases merged along
    x, use_pallas=True, N_TILED steps from rest; the step built with
    OFTPP_FINISH_PALLAS=1; the seven kernels on one tiled step's operands;
    kernels against plain versions; 8 cases tiled against the batched
    sweep; the numbers beside phase 6's batched sweep (`sweep`).
    Returns the phase's stats, the kernel rows at the tiled shape and the
    launch counts of its main run."""
    import torch

    from openfoam_tpp_tpu_torch.config import SolverControls
    from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
    from openfoam_tpp_tpu_torch.parallel.sweep import (batch_params,
                                                       batch_states,
                                                       make_sweep_step)
    from openfoam_tpp_tpu_torch.parallel.tiled_sweep import (
        make_tiled_sweep_step, tile_geometry, tile_state, untile)

    geom = build_tank_geometry(**SWEEP_TANK, round_to=8)
    tshape = tuple(tile_geometry(geom, TILED_CASES).shape)
    n_fluid = geom.n_fluid_cells * TILED_CASES
    log(f"[tiled sweep] {TILED_CASES} cases of {geom.shape} "
        f"({geom.n_fluid_cells} fluid cells each) along x: {tshape}, "
        f"{n_fluid} fluid cells")
    if tshape != TILED_SHAPE or n_fluid != TILED_FLUID:
        raise AssertionError(f"tiled grid {tshape} with {n_fluid} fluid "
                             f"cells, not {TILED_SHAPE} with {TILED_FLUID}")
    rows = [{"R": 0.002 + 2e-5 * i, "freq": 1.5 + 0.01 * i, "duration": 10.0}
            for i in range(TILED_CASES)]
    params = batch_params(rows, device=dev)

    def build(n, **env):
        with environ(**env):   # gates and knobs are read at build time
            core = make_tiled_sweep_step(geom, n, props,
                                         SolverControls(use_pallas=True),
                                         device=dev)

        def stp(s, p, precond=None):
            return (*core(s, p), None)
        stp.init_precond = lambda s: None
        return stp

    step = build(TILED_CASES)
    start = tile_state(geom, TILED_CASES, device=dev)
    state, _, launches, stats = drive(
        f"tiled sweep step: {TILED_CASES} cases, use_pallas=True, from rest",
        step, start, None, params, N_TILED, N_TILED_TIMED, n_fluid,
        DEFAULT_PATH)
    vfrac = torch.as_tensor(geom.vfrac, device=dev)
    nx = geom.shape[0]
    mass = lambda a: (a.reshape(TILED_CASES, nx, *a.shape[1:])
                      * vfrac).sum(dim=(1, 2, 3))
    m0, m1 = mass(start.alpha), mass(state.alpha)
    drift = float(((m1 - m0).abs() / m0).max())
    stats["max_block_mass_drift"] = drift
    log(f"  per-block mass: largest relative change {drift:.3e} (limit "
        f"{TILED_TOLS['mass']:.0e})")
    if drift > TILED_TOLS["mass"]:
        raise AssertionError(f"tiled sweep: block mass drift {drift}")
    gated = build(TILED_CASES, OFTPP_FINISH_PALLAS="1")
    _, _, _, stats["finish_gated"] = drive(
        "tiled sweep step built with OFTPP_FINISH_PALLAS=1, same state",
        gated, state, None, params, N_GATED, N_GATED, n_fluid, DEFAULT_PATH)
    log("  momentum_finish launched 0 times with OFTPP_FINISH_PALLAS=1 "
        "(G_x and G_y vary along x)")

    log(f"[kernels on the operands of one tiled step from that state, "
        f"{tshape}]")
    tiled_rows = {name: {} for name in STEP_ROWS}
    phase_step_operands(step, state, params, tiled_rows)

    run = steps_from(step, state, params)
    stats["ops_per_step"], stats["busy_ms_per_step"] = ops_per_step(run, 2)
    stats["vs_plain"] = hold_to_plain("tiled sweep step", run)

    # TILED_VS_SWEEP cases tiled against the batched sweep of the same
    # cases (the batch-native 7-point kernels, case axis trailing).
    k = TILED_VS_SWEEP
    sub = batch_params(rows[:k], device=dev)
    ts, small = tile_state(geom, k, device=dev), build(k)
    vs = batch_states(geom, k, device=dev)
    vstep = make_sweep_step(geom, props, SolverControls(), device=dev)
    for _ in range(N_TILED_VS_SWEEP):
        ts, _, _ = small(ts, sub)
        vs, _ = vstep(vs, sub)
    torch.cuda.synchronize()
    a_t = untile(ts.alpha, k)
    a_v = np.moveaxis(vs.alpha.cpu().numpy(), -1, 0)
    w_t = untile(ts.w, k)
    w_v = np.moveaxis(vs.w.cpu().numpy(), -1, 0)
    vf = geom.vfrac
    m0 = (untile(tile_state(geom, 1, device=dev).alpha, 1)[0] * vf).sum()
    pair = {
        "t": float(np.abs(float(ts.t) - vs.t.cpu().numpy()).max()
                   / float(ts.t)),
        "dt": abs(float(ts.dt) - float(vs.dt.min())) / float(vs.dt.min()),
        "alpha": float(np.abs(a_t - a_v).max()),
        "w": float(np.abs(w_t - w_v).max()),
        "mass": float(max(abs((a_t[i] * vf).sum() - m0) / m0
                          for i in range(k)))}
    stats["vs_batched_sweep"] = pair
    log(f"[tiled vs batched sweep, {k} cases, {N_TILED_VS_SWEEP} steps from "
        "rest] " + "; ".join(f"{f} {v:.3e} (limit {TILED_TOLS[f]:.0e})"
                             for f, v in pair.items()))
    bad = [f for f, v in pair.items() if v > TILED_TOLS[f]]
    if bad:
        raise AssertionError(f"tiled vs batched sweep: {bad} {pair}")

    b = sweep["make_sweep_step"]
    log(f"[tiled sweep vs phase 6's batched sweep of {TILED_CASES} cases at "
        f"round_to=4, one run each] tiled {stats['ms_per_step']:.3f} "
        f"ms/step, {stats['cell_updates_per_s']:.4e} aggregate "
        f"cell-updates/s, {stats['ops_per_step']:.1f} ops and "
        f"{stats['busy_ms_per_step']:.3f} ms busy per step; batched "
        f"{b['ms_per_step']:.3f} ms/step, {b['agg_cell_updates_per_s']:.4e}, "
        f"{b['ops_per_step']:.1f} ops, {b['busy_ms_per_step']:.3f} ms busy")
    return stats, tiled_rows, launches


def cat_diags(diags):
    """One StepDiagnostics of a farm's step: its positions' per-case
    diagnostics in case order, on the first position's device."""
    from openfoam_tpp_tpu_torch.solver.timestep import StepDiagnostics
    import torch

    dev = diags[0].p_iters.device
    return StepDiagnostics(*(torch.cat([x.to(dev) for x in xs])
                             for xs in zip(*diags)))


def drive_farm(label, farm, parts, pparts, n_steps, n_timed, n_fluid):
    """drive_sweep over a farm: `n_steps` of `farm` from the
    per-position `parts`, which stay on their positions' devices between
    steps, the last `n_timed` timed, with every launch count set to 0 just
    before and read just after; drive_sweep's checks on the gathered
    batch, and lockstep across the positions: every case's t and dt
    equal."""
    import torch

    fns = {k: getattr(m, a) for k, (m, a, _) in counters().items()}
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    diags = []
    for i in range(n_steps):
        if i == n_steps - n_timed:
            torch.cuda.synchronize()
            t_timed = time.perf_counter()
        parts, d = farm(parts, pparts)
        diags.append(cat_diags(d))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_timed
    launches = {k: f.launches for k, f in fns.items()}
    states = farm.sharding.gather(parts, device=parts[0].t.device)
    stats = sweep_checks(label, states, diags, launches, wall, n_steps,
                         n_timed, n_fluid, lockstep=True)
    if not bool((states.dt == states.dt[0]).all()):
        raise AssertionError(f"{label}: case dt differ across positions")
    log(f"  lockstep over {len(parts)} positions: every case at t = "
        f"{float(states.t[0])!r}, dt = {float(states.dt[0])!r}")
    return parts, states, launches, stats


def hold_farm(label, got, ref, got_stats, ref_stats):
    """The farm's batch against the unfarmed one: every field of every
    case within phase 4's limits (CMP_TOLS, of the field's scale over the
    batch); the slowest case's p_iters histogram equal, and every case's
    p_iters at every step within 1 (phase 6's rule for two runs whose
    sums differ in their last bits), with the every-case histograms side
    by side. Returns the errors."""
    out, bad = {"bitwise": True}, []
    for k, (kind_t, tol) in CMP_TOLS.items():
        g, r = getattr(got, k), getattr(ref, k)
        per_case = (g - r).abs().flatten(0, -2).max(dim=0).values
        err, scale = float(per_case.max()), float(r.abs().max())
        lim = tol if kind_t == "abs" else tol * scale
        out["bitwise"] &= err == 0.0
        out[k] = {"max_abs_err": err, "worst_case": int(per_case.argmax()),
                  "scale": scale, "limit": lim}
        log(f"  {k}: max_abs_err {err:.3e} (case {int(per_case.argmax())}) "
            f"limit {lim:.3e} (scale {scale:.3e})")
        if err > lim:
            bad.append(f"{k}: {err} > {lim}")
    it_got, it_ref = (np.asarray(x["p_iters"]) for x in (got_stats,
                                                        ref_stats))
    d_it = int(np.abs(it_got - it_ref).max())
    moved = int((it_got != it_ref).sum())
    out.update(max_p_iters_diff=d_it, case_steps_moved=moved,
               case_hists=[got_stats["p_iters_case_hist"],
                           ref_stats["p_iters_case_hist"]])
    if got_stats["p_iters_max_hist"] != ref_stats["p_iters_max_hist"]:
        bad.append(f"slowest case's p_iters histogram: "
                   f"{got_stats['p_iters_max_hist']} against "
                   f"{ref_stats['p_iters_max_hist']}")
    if d_it > 1:
        bad.append(f"a case's p_iters differ by {d_it} > 1")
    log(f"[{label}] fields bitwise equal: {out['bitwise']}; slowest case's "
        f"p_iters histogram {got_stats['p_iters_max_hist']} against "
        f"{ref_stats['p_iters_max_hist']}; every case and step "
        f"{got_stats['p_iters_case_hist']} against "
        f"{ref_stats['p_iters_case_hist']}: {moved} of "
        f"{it_got.size} case-steps moved, by at most {d_it}")
    if bad:
        raise AssertionError(f"{label}: {bad}")
    return out


def batch_width_bits(dev):
    """Which per-case results of the sweep step's operations keep their
    bits when phase 6's batch (12×12×50×128, seeded operands) is cut into
    the farm's parts of SWEEP_CASES / FARM_POSITIONS cases: the batch
    resid (its two bodies), the batch apply-dot's output and dots, and
    the plain per-case sum over the cells (solver/poisson.py `_dot`)."""
    import torch

    from openfoam_tpp_tpu_torch.ops import stencil as st
    from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp

    rng = np.random.default_rng(12)
    shape = (12, 12, 50, SWEEP_CASES)
    arr = lambda lo, hi: torch.from_numpy(
        rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)
    p, b = arr(-1.0, 1.0), arr(-1.0, 1.0)
    w = [arr(0.05, 0.3) for _ in range(3)]
    w[0][0], w[1][:, 0], w[2][:, :, 0] = 0, 0, 0
    k = SWEEP_CASES // FARM_POSITIONS
    parts = [slice(i * k, (i + 1) * k) for i in range(FARM_POSITIONS)]

    def cut(fn):
        whole = fn(p, tuple(w), b)
        pieces = [fn(p[..., sl].contiguous(),
                     tuple(x[..., sl].contiguous() for x in w),
                     b[..., sl].contiguous()) for sl in parts]
        return whole, pieces

    out = {}
    whole, pieces = cut(lambda q, ww, r: sp.resid_scaled_7pt_nb(q, ww, None,
                                                                r))
    out["resid_scaled_7pt_nb"] = torch.equal(whole, torch.cat(pieces, -1))
    whole, pieces = cut(lambda q, ww, r: sp.apply_dot_7pt_nb(q, ww))
    out["apply_dot_7pt_nb output"] = torch.equal(
        whole[0], torch.cat([x[0] for x in pieces], -1))
    out["apply_dot_7pt_nb dots"] = torch.equal(
        whole[1], torch.cat([x[1] for x in pieces]))
    whole, pieces = cut(lambda q, ww, r: st.sum_cells(q * r))
    out["sum_cells"] = torch.equal(whole, torch.cat(pieces))
    log(f"[mesh: bits of a {k}-case part against the {SWEEP_CASES}-case "
        f"batch, seeded operands] {out}")
    return out


def phase_mesh(dev, props, geom, sweep, flagship, flagship_params):
    """The device mesh on one card (module docstring, phase 12): (a) the
    farm and `runsweep --devices 4`, (b) `run_case(devices=4)`, (c)
    `run_case(devices="2x2")`, (d) the x-sharded step over ranks. `geom`:
    phase 3's flagship grid; `sweep`: phase 6's stats; `flagship` and
    `flagship_params`: phase 3's state and forcing, as numpy. Returns the
    phase's stats."""
    import torch

    from openfoam_tpp_tpu_torch.config import SolverControls
    from openfoam_tpp_tpu_torch.parallel import sharding as sh
    from openfoam_tpp_tpu_torch.parallel.sweep import (batch_params,
                                                       batch_states_geom,
                                                       build_batched_geometry,
                                                       make_geom_sweep_step)

    out = {}
    # (a) the farm: phase 6's rows through the lockstep geometry step.
    rows = [{**SWEEP_TANK, "R": 0.002 + 2e-5 * i, "freq": 1.5 + 0.01 * i,
             "duration": 10.0} for i in range(SWEEP_CASES)]
    bgeom = build_batched_geometry(rows, round_to=4, device=dev)
    params = batch_params(rows, device=dev)
    n_fluid = sum(g.n_fluid_cells for g in bgeom.geoms)
    step = make_geom_sweep_step(bgeom, props, SolverControls())
    ref, _, ref_stats = drive_sweep(
        "mesh: unfarmed lockstep geometry step, from rest", step,
        batch_states_geom(bgeom), params, N_FARM, N_FARM_TIMED, n_fluid,
        lockstep=True)

    def farm_on(devices):
        mesh = sh.make_mesh(len(devices), case_axis=len(devices),
                            devices=devices)
        farm = sh.sharded_step(
            [make_geom_sweep_step(g, props, SolverControls())
             for g in sh.shard_batched_geometry(bgeom, mesh)], mesh,
            batched=True)
        parts = farm.sharding.put(batch_states_geom(bgeom))
        pparts = sh.params_sharding(mesh, batched=True).put(params)
        return farm, parts, pparts

    farm, parts, pparts = farm_on([dev] * FARM_POSITIONS)
    label = (f"mesh: farm over {FARM_POSITIONS} case positions of {dev}, "
             f"{SWEEP_CASES // FARM_POSITIONS} cases each, from rest")
    parts, got, launches, stats = drive_farm(
        label, farm, parts, pparts, N_FARM, N_FARM_TIMED, n_fluid)
    log(f"  launches of rows 10a-c: "
        f"{ {k: launches[k] for k in BATCH_PATH} } "
        f"(unfarmed: { {k: ref_stats['launches_per_step'][k] * N_FARM for k in BATCH_PATH} })")
    # Each position holds 12×12×50×32 = 230,400 elements, under the batch
    # resid's kMarchFrom = 2^18 (csrc/seven_point_batch.cu): the positions
    # take its other body, so bits may differ from the 128-case batch.
    stats["hold"] = hold_farm(label, got, ref, stats, ref_stats)
    stats["bits_by_batch_width"] = batch_width_bits(dev)

    def run_farm(n):
        nonlocal parts
        for _ in range(n):
            parts, _ = farm(parts, pparts)

    stats["ops_per_step"], stats["busy_ms_per_step"] = ops_per_step(run_farm,
                                                                    2)
    r_state = [ref]

    def run_ref(n):
        for _ in range(n):
            r_state[0], _ = step(r_state[0], params)

    ref_stats["ops_per_step"], ref_stats["busy_ms_per_step"] = ops_per_step(
        run_ref, 2)
    log(f"[mesh farm vs the unfarmed batch, {SWEEP_CASES} cases, one run "
        f"each] farm {stats['ms_per_step']:.3f} ms/step, "
        f"{stats['ops_per_step']:.1f} device ops and "
        f"{stats['busy_ms_per_step']:.3f} ms busy per step; unfarmed "
        f"{ref_stats['ms_per_step']:.3f} ms/step, "
        f"{ref_stats['ops_per_step']:.1f} ops, "
        f"{ref_stats['busy_ms_per_step']:.3f} ms busy (phase 6's lockstep "
        f"step {sweep['lockstep_geom']['ms_per_step']:.3f} ms/step, its "
        f"make_sweep_step {sweep['make_sweep_step']['ops_per_step']:.1f} "
        f"ops, {sweep['make_sweep_step']['busy_ms_per_step']:.3f} ms busy)")
    out["farm"], out["unfarmed"] = stats, ref_stats
    n_cards = torch.cuda.device_count()
    k = min(n_cards, FARM_POSITIONS)
    if k > 1 and SWEEP_CASES % k == 0:
        cards = [torch.device("cuda", i) for i in range(k)]
        farm2, parts2, pparts2 = farm_on(cards)
        label2 = f"mesh: farm over {k} distinct cards, from rest"
        _, got2, _, stats2 = drive_farm(label2, farm2, parts2, pparts2,
                                        N_FARM, N_FARM_TIMED, n_fluid)
        stats2["hold"] = hold_farm(label2, got2, ref, stats2, ref_stats)
        out["farm_distinct_cards"] = stats2
    else:
        log(f"[mesh farm on distinct cards] did not run: "
            f"torch.cuda.device_count() = {n_cards}")
    out["runsweep"] = phase_mesh_runsweep(dev)
    out["x_run"], x_final, x_times = phase_mesh_x_run(dev)
    out["nxm_run"] = phase_mesh_nxm_run(dev, geom)
    out["x_ranks"] = phase_mesh_x_ranks(dev, out["x_run"], x_final, x_times,
                                        flagship, flagship_params)
    out["x_run"].pop("first_checkpoint")
    return out


def probe_table(case_dir, name, start=0.0):
    """A probe file's rows, of a run started at `start` s."""
    with open(os.path.join(case_dir, "postProcessing", "probes",
                           f"{start:g}", name)) as f:
        return np.array([[float(v) for v in ln.split()]
                         for ln in f if not ln.startswith("#")])


class SwappedParams:
    """A planted fault of the farm: the first case of position 0 and the
    second of position 1 exchange their forcing parameters (in
    `runsweep`'s order of phase 7's study every position holds the same
    32 (R, freq) pairs in the same order: these two differ in freq, 1.5
    against 1.6 Hz)."""

    def __init__(self, real):
        self.real = real

    def __call__(self, mesh, batched=False):
        sharding = self.real(mesh, batched)
        return types.SimpleNamespace(put=lambda tree: self.swap(
            sharding.put(tree)))

    @staticmethod
    def swap(parts):
        a, b = parts[0], parts[1]
        fa = {f.name: getattr(a, f.name).clone()
              for f in dataclasses.fields(a)}
        fb = {f.name: getattr(b, f.name).clone()
              for f in dataclasses.fields(b)}
        for k in fa:
            fa[k][0], fb[k][1] = getattr(b, k)[1], getattr(a, k)[0]
        return [type(a)(**fa), type(b)(**fb), *parts[2:]]


def hold_runsweep(pairs):
    """Per case (farmed dir, unfarmed dir) the checkpoints' times bitwise,
    and each checkpoint's fields within phase 4's limits of the case's
    own scale, the velocities' plus FARM_DRIFT·t; the probe files' rows
    and times equal, p within 2e-3 of its scale and η within phase 4's
    alpha limit over the tank's height (1e-3 · H). Returns (the largest
    error over its limit per field, the faults)."""
    from openfoam_tpp_tpu_torch.manager.cases import load_case_params
    from openfoam_tpp_tpu_torch.utils.io import list_checkpoints, load_checkpoint

    worst, bad = {}, []
    for d, e in pairs:
        cf, co = list_checkpoints(d), list_checkpoints(e)
        if [t for t, _ in cf] != [t for t, _ in co] \
                or cf[-1][0] != round(MANAGER_SWEEP["duration"], 6):
            bad.append(f"{d}: checkpoints {cf} against {co}")
            continue
        for (_, fp), (_, op) in zip(cf[1:], co[1:]):
            got, want = load_checkpoint(fp), load_checkpoint(op)
            if got["t"] != want["t"]:
                bad.append(f"{fp}: t {got['t']!r} against {want['t']!r}")
            for k, (kind_t, tol) in CMP_TOLS.items():
                err = float(np.abs(got[k] - want[k]).max())
                lim = tol if kind_t == "abs" else tol * float(
                    np.abs(want[k]).max())
                if k in "uvw":
                    lim += FARM_DRIFT * float(want["t"])
                worst[k] = max(worst.get(k, 0.0), err / lim if lim else err)
                if err > lim:
                    bad.append(f"{fp}: {k} {err} > {lim}")
        height = load_case_params(d)["H"]
        for name, lim_of in (("p", lambda b: 2e-3 * np.abs(b).max()),
                             ("eta", lambda b: 1e-3 * height)):
            a, b = probe_table(d, name), probe_table(e, name)
            if a.shape != b.shape or not np.array_equal(a[:, 0], b[:, 0]):
                bad.append(f"{d}: probes/0/{name} {a.shape} against "
                           f"{b.shape}")
                continue
            err, lim = (float(np.abs(a[:, 1:] - b[:, 1:]).max()),
                        lim_of(b[:, 1:]))
            worst[f"probe_{name}"] = max(worst.get(f"probe_{name}", 0.0),
                                         err / lim)
            if err > lim:
                bad.append(f"{d}: probes/0/{name} {err} > {lim}")
    return worst, bad


def phase_mesh_runsweep(dev):
    """(a) `runsweep --devices 4 --device cuda:0` on phase 7's study
    through `cli.main`, against the unfarmed `runsweep` of the same cases
    (`hold_runsweep`: the velocities' limit adds the farm's drift from
    the batch that scripts/farm_gap.py measured, FARM_DRIFT); then the
    same farm with a planted fault (`SwappedParams`: two cases of
    positions 0 and 1 exchange their forcing), which the same check
    must refuse."""
    import torch

    from openfoam_tpp_tpu_torch.manager import cli
    from openfoam_tpp_tpu_torch.manager.cases import expand_sweep, setup_case
    from openfoam_tpp_tpu_torch.parallel import sharding as sh

    fns = {k: getattr(m, a) for k, (m, a, _) in counters().items()}
    rows, _ = expand_sweep(MANAGER_SWEEP)
    card = f"{dev.type}:{dev.index or 0}"
    farmed = ["--devices", str(FARM_POSITIONS)]
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_farm_") as base:
        for sub, extra in (("farm", farmed), ("one", []), ("swap", farmed)):
            dirs = [setup_case(r, os.path.join(base, sub)) for r in rows]
            for f in fns.values():
                f.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                text = stack.enter_context(tee_stdout())
                if sub == "swap":
                    stack.enter_context(mock.patch.object(
                        sh, "params_sharding",
                        SwappedParams(sh.params_sharding)))
                rc = cli.main(["--headless", "--action", "runsweep", "--case",
                               "all", "--base-dir", os.path.join(base, sub),
                               "--device", card] + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: f.launches for k, f in fns.items() if f.launches}
            done = re.findall(r"Batch done: (\d+) cases x (\d+) steps",
                              text.value())
            log(f"[mesh runsweep {sub}: {' '.join(extra) or 'unfarmed'} "
                f"--device {card}] rc {rc}, {len(dirs)} cases, {done}, "
                f"{wall:.2f} s wall; kernel launches {launches}")
            if rc != 0 or set(launches) != set(BATCH_PATH) or len(done) != 1:
                raise AssertionError(f"mesh runsweep {sub}: rc {rc}, "
                                     f"launches {launches}, batches {done}")
            if extra and f"over {FARM_POSITIONS} devices" not in text.value():
                raise AssertionError("mesh runsweep: the batch was not farmed")
            runs[sub] = {"dirs": dirs, "wall_seconds": wall,
                         "steps": int(done[0][1]), "launches": launches}
        worst, bad = hold_runsweep(zip(runs["farm"]["dirs"],
                                       runs["one"]["dirs"]))
        s_worst, s_bad = hold_runsweep(zip(runs["swap"]["dirs"],
                                           runs["one"]["dirs"]))
    log(f"  farmed against unfarmed, {len(rows)} cases: steps "
        f"{runs['farm']['steps']} and {runs['one']['steps']}; largest error "
        f"over its limit per field {worst}")
    log(f"  planted fault (one case of position 0 and one of position 1 "
        f"exchange their forcing): "
        f"{len(s_bad)} faults found, largest error over its limit per "
        f"field {s_worst}")
    if bad or runs["farm"]["steps"] != runs["one"]["steps"]:
        raise AssertionError(f"mesh runsweep: {bad[:5]} ({len(bad)} faults)")
    if not s_bad:
        raise AssertionError("mesh runsweep: the planted fault passed the "
                             "farm's check")
    return {k: {kk: v for kk, v in r.items() if kk != "dirs"}
            for k, r in runs.items()} | {"worst_over_limit": worst,
                                         "swap_worst_over_limit": s_worst,
                                         "swap_faults": len(s_bad)}


def advance_to(geom, controls, spmd, params, dev, targets):
    """The runner's advance of `make_step(geom, controls, spmd=spmd)` from
    rest through the write targets: what `run_case` computes on that
    grid. Returns the final state."""
    from openfoam_tpp_tpu_torch.config import PhysicalProperties
    from openfoam_tpp_tpu_torch.core.state import CaseParams, init_state
    from openfoam_tpp_tpu_torch.manager.runner import make_advance
    from openfoam_tpp_tpu_torch.post.probes import (default_probe_points,
                                                    default_wave_columns,
                                                    make_probe_sampler)
    from openfoam_tpp_tpu_torch.solver.timestep import make_step

    step = make_step(geom, PhysicalProperties(), controls, carry_precond=True,
                     spmd=spmd, device=dev)
    sampler, width = make_probe_sampler(geom, default_probe_points(geom),
                                        default_wave_columns(geom), device=dev)
    adv = make_advance(step, sampler=sampler, sample_width=width)
    state = init_state(geom, dt0=params["dt"], device=dev)
    cp = CaseParams.make(params["R"], params["freq"], params["duration"],
                         params["ramp"], device=dev)
    for t in targets:
        state = adv(state, cp, t)[0]
    return state


def hold_checkpoint(label, chk, state, tols, held=True, drift=0.0):
    """A checkpoint's fields against a state: bitwise, or within `tols`
    (field: (kind, limit, floor)), the velocities' limits plus `drift`
    (m/s); `held=False` reports the fields and their limits without
    holding them."""
    out, bad = {}, []
    for k in ("alpha", "u", "v", "w", "p", "t", "dt"):
        ref = getattr(state, k).cpu().numpy()
        err = float(np.abs(chk[k] - ref).max())
        scale = float(np.abs(ref).max())
        out[k] = {"max_abs_err": err, "scale": scale}
        if k in tols and err:
            kind_t, tol, floor = tols[k]
            lim = max(tol if kind_t == "abs" else tol * scale, floor)
            lim += drift if k in "uvw" else 0.0
            out[k]["limit"] = lim
            if err > lim:
                bad.append(f"{k}: {err} > {lim}")
        elif err:
            bad.append(f"{k}: {err} (held bitwise)")
    bitwise = all(v["max_abs_err"] == 0.0 for v in out.values())
    log(f"  {label}: bitwise {bitwise}; "
        + "; ".join(f"{k} {v['max_abs_err']:.3e}" for k, v in out.items())
        + ("" if held else f" (reported, not held; over the limits: "
           f"{bad or 'none'})"))
    if bad and held:
        raise AssertionError(f"{label}: {bad}")
    return {"bitwise": bitwise, **out}


def phase_mesh_x_run(dev):
    """(b) `run_case(devices=4, device="cuda:0")` on the flagship for two
    write intervals: the grid rounded as the JAX package rounds it, the
    halo kernels alone launched (11a-b once an island, the rest 4 times),
    killed after the first interval and resumed; the final checkpoint
    against the SpmdCtx(1) step through the same advance (bitwise; else
    phase 3b's limits). Returns (stats, with the t = 0.05 checkpoint's
    file under "first_checkpoint", the final checkpoint, the write times
    of the checkpoints)."""
    import torch

    from openfoam_tpp_tpu_torch.config import SolverControls
    from openfoam_tpp_tpu_torch.manager.cases import setup_case
    from openfoam_tpp_tpu_torch.manager.runner import (build_case_geometry,
                                                       run_case)
    from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
    from openfoam_tpp_tpu_torch.solver import poisson
    from openfoam_tpp_tpu_torch.utils.io import list_checkpoints, load_checkpoint

    params = {**MESH_CASE, "duration": 0.1}
    card = f"{dev.type}:{dev.index or 0}"
    geom = build_case_geometry(params, devices=N_SHARDS, device=dev)
    log(f"[mesh run_case(devices={N_SHARDS}, device={card!r})] flagship "
        f"grid rounded to {geom.shape} ({geom.n_fluid_cells} fluid cells)")
    if tuple(geom.shape) != SHARDED_RUN_SHAPE:
        raise AssertionError(f"mesh x run: grid {geom.shape}")
    fns = {k: getattr(m, a) for k, (m, a, _) in counters().items()}
    solves = []
    real_pcg = poisson.solve_pcg

    def pcg(*a, **k):
        res = real_pcg(*a, **k)
        solves.append(int(res[2]))
        return res

    with tempfile.TemporaryDirectory(prefix="chip_smoke_xrun_") as base:
        case = setup_case(params, base)
        for f in fns.values():
            f.launches = 0
        torch.cuda.synchronize()
        with mock.patch.object(poisson, "solve_pcg", pcg):
            stats = run_case(case, devices=N_SHARDS, device=card,
                             log=lambda ln: log("  | " + ln))
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in fns.items()}
        steps = stats["steps"]
        ms = stats["wall_seconds"] / max(steps, 1) * 1e3
        log(f"  {steps} steps in {stats['wall_seconds']:.2f} s wall "
            f"({ms:.1f} ms/step with writes; writing "
            f"{stats['io_seconds']:.2f} s); p_iters {solves}")
        ran = {k for k, v in launches.items() if v}
        if ran != set(HALO_PATH) or len(solves) != steps:
            raise AssertionError(f"mesh x run: kernels {sorted(ran)}, "
                                 f"{len(solves)} solves for {steps} steps")
        check_halo_launches("mesh x run", launches,
                            {"steps": steps, "p_iters": solves}, N_SHARDS, 1)
        chks = list_checkpoints(case)
        for t, path in chks:
            if t > 0.05 + 1e-9:
                os.remove(path)
        again = run_case(case, devices=N_SHARDS, device=card,
                         log=lambda ln: log("  | " + ln))
        chks = list_checkpoints(case)
        if [round(t, 6) for t, _ in chks] != [0.0, 0.05, 0.1] \
                or again["steps"] >= steps:
            raise AssertionError(f"mesh x run: resume gave {chks}, "
                                 f"{again['steps']} steps")
        final = load_checkpoint(chks[-1][1])
        times = [float(load_checkpoint(p)["t"]) for _, p in chks]
        with open(chks[1][1], "rb") as f:   # the t = 0.05 checkpoint
            first_chk = f.read()
        probe_rows = len(probe_table(case, "p"))
    targets = [float(np.float32(k) * np.float32(0.05)) for k in (1, 2)]
    one = advance_to(geom, SolverControls(use_pallas=True), SpmdCtx(1),
                     params, dev, targets)
    held = hold_checkpoint("resumed 4-shard run against SpmdCtx(1)", final,
                           one, {**SHARD_TOLS, **DT_TOL})
    if probe_rows != int(final["step"]):
        raise AssertionError(f"mesh x run: {probe_rows} probe rows for "
                             f"{final['step']} steps")
    return ({"shape": list(geom.shape), "steps": steps,
             "first_interval_steps": stats["intervals"][0]["steps"],
             "first_checkpoint": first_chk,
             "resumed_steps": again["steps"], "wall_seconds":
             stats["wall_seconds"], "io_seconds": stats["io_seconds"],
             "ms_per_step_with_writes": ms, "p_iters": solves,
             "launches": {k: launches[k] for k in HALO_PATH},
             "against_spmd1": held}, final, times)


def run_alone_and_on_mesh(label, setup, devices, card):
    """One case set up twice (`setup(base) -> case dir`), run by
    `run_case` on `card` alone and over the mesh `devices` (positions
    sharing the card), each with every launch count set to 0 just before
    and read just after: (stats, launches, final checkpoint) of each."""
    import torch

    from openfoam_tpp_tpu_torch.manager.runner import run_case
    from openfoam_tpp_tpu_torch.utils.io import list_checkpoints, load_checkpoint

    fns = {k: getattr(m, a) for k, (m, a, _) in counters().items()}
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as base:
        for name, devs in (("mesh", devices), ("alone", None)):
            case = setup(os.path.join(base, name))
            for f in fns.values():
                f.launches = 0
            torch.cuda.synchronize()
            stats = run_case(case, devices=devs, device=card,
                             log=lambda ln: log(f"  | [{name}] " + ln))
            torch.cuda.synchronize()
            launches = {k: f.launches for k, f in fns.items() if f.launches}
            out[name] = (stats, launches,
                         load_checkpoint(list_checkpoints(case)[-1][1]))
    for name, (stats, launches, _) in out.items():
        ms = stats["wall_seconds"] / max(stats["steps"], 1) * 1e3
        log(f"[{label}, {name}] {stats['steps']} steps in "
            f"{stats['wall_seconds']:.2f} s wall ({ms:.1f} ms/step with "
            f"writes), kernel launches {launches}")
    return out


def phase_mesh_nxm_run(dev, geom):
    """(c) `run_case(devices="2x2", device="cuda:0")` on the flagship for
    one write interval: the JAX package's grid for 2x2 (112³, phase 3's),
    the global step with the single-grid kernels (the seven default ones,
    flux_all 3, fct_iter 9, momentum_rhs and correct_divmax once a step),
    the same path as the case run alone on the card, so its checkpoint
    is held bitwise against the lone run's. Then phase 8's 6DoF tank
    case (0.05 s) with `devices=2` against the same case alone: the
    same kernels, bitwise."""
    from openfoam_tpp_tpu_torch.manager.cases import (setup_case,
                                                      setup_case_6dof)
    from openfoam_tpp_tpu_torch.manager.runner import build_case_geometry

    params = {**MESH_CASE, "duration": 0.05}
    card = f"{dev.type}:{dev.index or 0}"
    g2 = build_case_geometry(params, devices="2x2", device=dev)
    six = {"Lx": TANK6DOF["Lx"], "Ly": TANK6DOF["Ly"], "Lz": TANK6DOF["Lz"],
           "mesh": TANK6DOF["mesh"], "chamfer": TANK6DOF["chamfer"],
           "duration": 0.05, "dt": DT0_6DOF}
    want_per_step = {"flux_all": 3, "fct_iter": 9, "momentum_rhs": 1,
                     "correct_divmax": 1}
    out = {"shape": list(g2.shape)}
    for key, label, setup, devices in (
            ("nxm", f"mesh run_case(devices='2x2', device={card!r})",
             lambda b: setup_case(params, b), "2x2"),
            ("tank6dof", f"mesh 6DoF run_case(devices=2, device={card!r})",
             lambda b: setup_case_6dof(six, b), 2)):
        runs = run_alone_and_on_mesh(label, setup, devices, card)
        (stats, launches, final), (_, alone_l, alone) = (runs["mesh"],
                                                          runs["alone"])
        bad = []
        if (set(launches) != set(DEFAULT_PATH) or launches != alone_l
                or any(launches[k] != n * stats["steps"]
                       for k, n in want_per_step.items())):
            bad.append(f"launches {launches} (alone {alone_l})")
        diff = {k: float(np.abs(final[k] - alone[k]).max())
                for k in ("alpha", "u", "v", "w", "p", "t", "dt", "step")}
        if any(diff.values()):
            bad.append(f"against the lone run {diff} (held bitwise)")
        log(f"  {label}: kernels as alone {launches == alone_l}; against "
            f"the lone run, bitwise {not any(diff.values())}")
        if key == "nxm" and (tuple(g2.shape) != tuple(geom.shape)
                             or final["alpha"].shape != tuple(geom.shape)):
            bad.append(f"grid {g2.shape}, phase 3's {tuple(geom.shape)}")
        if bad:
            raise AssertionError(f"{label}: {bad}")
        ms = stats["wall_seconds"] / max(stats["steps"], 1) * 1e3
        out[key] = {"steps": stats["steps"],
                    "wall_seconds": stats["wall_seconds"],
                    "ms_per_step_with_writes": ms, "launches": launches,
                    "bitwise_alone": True}
    return out


# Phase 12d: the x-sharded step over ranks (parallel/ranks.py).
N_RANK1 = 10           # steps of (i): one NCCL rank against SpmdCtx(1)
N_RANK_STATE = 3       # steps of (ii-a): four ranks from phase 3's state
PROBE_TIMEOUT_S = 60   # the gloo probe's collectives wait at most this


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_turns(ctx, geom, cp, start, n_steps, motion=None):
    """`n_steps` of the x-sharded step as the one rank (`SpmdCtx(1,
    ranks=ctx)`) and as the single-process SpmdCtx(1) step, each from
    `start()` (a fresh global state) with its preconditioner carry, in
    turns (rank, single, single, rank: the first run of the process pays
    its warm-up). Returns the fields' comparison of each pair, and each
    run's p_iters, ms/step and launches."""
    import torch

    from openfoam_tpp_tpu_torch.config import (PhysicalProperties,
                                               SolverControls)
    from openfoam_tpp_tpu_torch.parallel import ranks as rk
    from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
    from openfoam_tpp_tpu_torch.solver.timestep import make_step

    dev = ctx.device

    def run(spmd):
        step = make_step(geom, PhysicalProperties(),
                         SolverControls(use_pallas=True), motion=motion,
                         carry_precond=True, spmd=spmd, device=dev)
        state = start()
        if spmd.ranks is not None:
            state = rk.scatter_state(state, geom.shape, ctx)
        bundle = step.init_precond(state)
        before = rk.launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        iters = []
        for _ in range(n_steps):
            state, diag, bundle = step(state, cp, precond=bundle)
            iters.append(diag.p_iters)
        sync(dev)
        wall = time.perf_counter() - t0
        after = rk.launch_counts()
        return state, {"p_iters": [int(i) for i in iters],
                       "ms_per_step": wall / n_steps * 1e3,
                       "launches": {k: after[k] - before[k] for k in after
                                    if after[k] != before[k]}}

    rank, single = SpmdCtx(1, ranks=ctx), SpmdCtx(1)
    turns = [run(spmd) for spmd in (rank, single, single, rank)]
    fields = ("alpha", "u", "v", "w", "p", "t", "dt", "step")
    pairs = [(turns[0][0], turns[1][0]), (turns[3][0], turns[2][0])]
    return {"grid": list(geom.shape), "backend": ctx.backend,
            "bitwise": all(torch.equal(getattr(a, k), getattr(b, k))
                           for a, b in pairs for k in fields),
            "max_abs_diff": {k: max(float((getattr(a, k).double()
                                           - getattr(b, k).double())
                                          .abs().max()) for a, b in pairs)
                             for k in fields},
            "rank": turns[0][1], "single": turns[1][1],
            "ms_per_step_turns": {
                "rank": [turns[0][1]["ms_per_step"], turns[3][1]["ms_per_step"]],
                "single": [turns[1][1]["ms_per_step"],
                           turns[2][1]["ms_per_step"]]},
            "exchange": ctx.stats.as_dict()}


def rank_one_job(ctx, log, params, n_steps):
    """Phase 12d (i), in the one rank's process (rank 0 of 1, NCCL):
    `rank_turns` of the flagship's x-sharded step from rest."""
    from openfoam_tpp_tpu_torch.core.state import CaseParams, init_state
    from openfoam_tpp_tpu_torch.manager.runner import build_case_geometry

    dev = ctx.device
    geom = build_case_geometry(params, devices=N_SHARDS, device=dev)
    cp = CaseParams.make(params["R"], params["freq"], params["duration"],
                         params["ramp"], device=dev)
    return rank_turns(ctx, geom, cp,
                      lambda: init_state(geom, dt0=params["dt"], device=dev),
                      n_steps)


def rank_one_6dof_job(ctx, log, init, n_steps):
    """Phase 12e (i), in the one rank's process (rank 0 of 1, NCCL):
    `rank_turns` of the 6DoF tutorial tank's x-sharded step under phase
    8's motion, from phase 8's state `init` (numpy)."""
    from openfoam_tpp_tpu_torch.core.state import CaseParams, state_from_numpy
    from openfoam_tpp_tpu_torch.mesh import build_chamfer_tank_geometry

    dev = ctx.device
    geom = build_chamfer_tank_geometry(**TANK6DOF)
    cp = CaseParams.make(R=0.0, freq=0.0, duration=40.0, device=dev)
    return rank_turns(ctx, geom, cp,
                      lambda: state_from_numpy(init, device=dev), n_steps,
                      motion=tank6dof_motion(dev, DT0_6DOF))


def rank_state_job(ctx, log, tank, init, params, n_steps):
    """Phase 12d (ii-a), in each rank's process: `n_steps` of the
    x-sharded step over the ranks from phase 3's state `init` (numpy;
    rank 0 scatters it), and on rank 0 the single-process
    SpmdCtx(world) step from the same state. Every rank returns its
    launches and exchange stats; rank 0 also both runs' p_iters and, for
    the first and the last step, each field's largest difference and
    scale."""
    from openfoam_tpp_tpu_torch.config import (PhysicalProperties,
                                               SolverControls)
    from openfoam_tpp_tpu_torch.core.state import (params_from_numpy,
                                                   state_from_numpy,
                                                   state_to_numpy)
    from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
    from openfoam_tpp_tpu_torch.parallel import ranks as rk
    from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
    from openfoam_tpp_tpu_torch.solver.timestep import make_step

    dev = ctx.device
    geom = build_tank_geometry(**tank)
    par = params_from_numpy(params, device=dev)

    def steps(spmd, state):
        step = make_step(geom, PhysicalProperties(),
                         SolverControls(use_pallas=True), carry_precond=True,
                         spmd=spmd, device=dev)
        bundle = step.init_precond(state)
        states, iters = [], []
        for _ in range(n_steps):
            state, diag, bundle = step(state, par, precond=bundle)
            states.append(state)
            iters.append(int(diag.p_iters))
        return states[0], states[-1], iters

    whole = state_from_numpy(init, device=dev) if ctx.rank == 0 else None
    before = rk.launch_counts()
    first, last, iters = steps(SpmdCtx(ctx.world, ranks=ctx),
                               rk.scatter_state(whole, geom.shape, ctx))
    after = rk.launch_counts()
    first, last = (state_to_numpy(rk.gather_state(s, ctx))
                   for s in (first, last))
    out = {"launches": {k: after[k] - before[k] for k in after
                        if after[k] != before[k]},
           "iters": iters, "exchange": ctx.stats.as_dict()}
    if ctx.rank == 0:
        r_first, r_last, r_iters = steps(SpmdCtx(ctx.world), whole)
        diff = lambda a, b: {k: (float(np.abs(a[k] - b[k]).max()),
                                 float(np.abs(b[k]).max()))
                             for k in ("alpha", "u", "v", "w", "p", "t",
                                       "dt")}
        out.update(ref_iters=r_iters,
                   first=diff(first, state_to_numpy(r_first)),
                   last=diff(last, state_to_numpy(r_last)))
    return out


def gloo_cuda_job(ctx, log):
    """Which gloo collectives take CUDA tensors here (ranks sharing a
    card): all_reduce, broadcast and all_gather tried once each on a
    CUDA tensor, the result checked. Point-to-point is not tried: gloo
    takes CPU tensors there (PyTorch's backend table), and the ranks
    stage their planes through the host."""
    import torch
    import torch.distributed as dist

    t = torch.full((4,), float(ctx.rank + 1), device=ctx.device)
    world = ctx.world

    def all_reduce():
        x = t.clone()
        dist.all_reduce(x)
        return x, torch.full((4,), world * (world + 1) / 2)

    def broadcast():
        x = t.clone()
        dist.broadcast(x, 0)
        return x, torch.ones(4)

    def all_gather():
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return torch.cat(parts), torch.cat([torch.full((4,), r + 1.0)
                                            for r in range(world)])

    out = {}
    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather", all_gather)):
        try:
            got, want = fn()
            sync(ctx.device)
            out[name] = ("takes CUDA tensors" if torch.equal(got.cpu(), want)
                         else f"wrong result {got.cpu().tolist()}")
        except (RuntimeError, ValueError) as e:
            out[name] = "refuses CUDA tensors: " + str(e).splitlines()[0][:160]
    out["send/recv"] = "not tried (CPU tensors only); staged through the host"
    return out


def rank_launches(counts):
    """A rank's 'module.function' launch counts under chip_smoke's row
    names."""
    names = {f"{m.__name__.rsplit('.', 1)[1]}.{a}": k
             for k, (m, a, _) in counters().items()}
    return {names[k]: v for k, v in counts.items() if k in names}


def hold_rank_steps(label, res):
    """`rank_state_job`'s results: the first step's alpha and dt bitwise
    the single-process step's (the dt is a maximum, MULES has no sum over
    the grid), after the last step every field within phase 4's limits
    (`SHARD_TOLS`) of it, p_iters within 1 at every step, every rank's
    launches the halo kernels' alone."""
    r0 = res[0]
    bad = []
    for r, rs in enumerate(res):
        launches = rank_launches(rs["launches"])
        ran = {k for k, v in launches.items() if v}
        if ran != set(HALO_PATH) or rs["iters"] != r0["iters"]:
            bad.append(f"rank {r}: kernels {sorted(ran)}, p_iters "
                       f"{rs['iters']}")
    for k in ("alpha", "dt"):
        if r0["first"][k][0] != 0.0:
            bad.append(f"first step {k}: {r0['first'][k][0]} (held bitwise)")
    for k, (kind_t, tol, floor) in SHARD_TOLS.items():
        err, scale = r0["last"][k]
        lim = max(tol if kind_t == "abs" else tol * scale, floor)
        if err > lim:
            bad.append(f"after {N_RANK_STATE} steps {k}: {err} > {lim}")
    d_it = max(abs(a - b) for a, b in zip(r0["iters"], r0["ref_iters"]))
    if d_it > 1:
        bad.append(f"p_iters {r0['iters']} against {r0['ref_iters']}")
    log(f"[{label}] {N_RANK_STATE} steps against SpmdCtx({len(res)}) in one "
        f"process: first step alpha and dt bitwise "
        f"{r0['first']['alpha'][0] == 0.0 and r0['first']['dt'][0] == 0.0}"
        f" (first step: " + "; ".join(
            f"{k} {e:.3e} of {sc:.3e}" for k, (e, sc) in r0["first"].items())
        + f"); after the last: " + "; ".join(
            f"{k} {e:.3e} of {sc:.3e}" for k, (e, sc) in r0["last"].items())
        + f"; p_iters {r0['iters']} / {r0['ref_iters']}; every rank launched "
        f"the halo kernels alone")
    if bad:
        raise AssertionError(f"{label}: {bad}")
    return {k: r0[k] for k in ("first", "last", "iters", "ref_iters")}


def hold_rank_run(label, stats, ref_iters, ref_name="phase 12b's", sweeps=1):
    """A run_case over ranks: every rank launched the halo kernels alone
    (11a-b once an island call, the rest once a call: one slab a rank;
    `sweeps` smoothing sweeps) with the same p_iters, which lie within 1
    of `ref_iters` step by step (None: not held); per step its ms with
    and without writes, plane exchanges, bytes, reductions and host
    seconds in them, each rank's; the p_iters histogram. Returns those
    numbers."""
    steps = stats["steps"]
    per_rank = []
    for r, rs in enumerate(stats["ranks"]):
        launches = rank_launches(rs["launches"])
        ran = {k for k, v in launches.items() if v}
        if ran != set(HALO_PATH) or rs["p_iters"] != stats["ranks"][0][
                "p_iters"] or len(rs["p_iters"]) != steps:
            raise AssertionError(f"{label}, rank {r}: kernels {sorted(ran)}, "
                                 f"p_iters {rs['p_iters']}")
        check_halo_launches(f"{label}, rank {r} on {rs['device']}",
                            launches, {"steps": steps,
                                       "p_iters": rs["p_iters"]}, 1, sweeps)
        row = {"device": rs["device"], "backend": rs["backend"],
               "exchanges_per_step": rs["exchanges"] / steps,
               "bytes_per_step": rs["bytes"] / steps,
               "all_reduces_per_step": rs["all_reduces"] / steps,
               "gathers": rs["gathers"],
               "exchange_s_per_step": rs["seconds"] / steps,
               "launches": {k: launches[k] for k in HALO_PATH}}
        per_rank.append(row)
        log(f"  rank {r} ({rs['device']}, {rs['backend']}): per step "
            f"{row['exchanges_per_step']:.1f} plane exchanges, "
            f"{row['bytes_per_step'] / 1e6:.3f} MB sent, "
            f"{row['all_reduces_per_step']:.1f} all-reduces, "
            f"{row['exchange_s_per_step'] * 1e3:.1f} ms host in them "
            f"({rs['gathers']} whole-array gathers in the run)")
    iters = stats["ranks"][0]["p_iters"]
    ms = stats["wall_seconds"] / max(steps, 1) * 1e3
    ms_bare = ((stats["wall_seconds"] - stats["io_seconds"])
               / max(steps, 1) * 1e3)
    hist = {int(k): int(v)
            for k, v in zip(*np.unique(iters, return_counts=True))}
    log(f"  {label}: {steps} steps, {ms:.1f} ms/step with writes, "
        f"{ms_bare:.1f} without (writing {stats['io_seconds']:.2f} s); "
        f"p_iters {iters}, histogram {hist}")
    if ref_iters is not None:
        if len(iters) != len(ref_iters):
            raise AssertionError(f"{label}: {len(iters)} steps against "
                                 f"{len(ref_iters)}")
        d_it = max(abs(a - b) for a, b in zip(iters, ref_iters))
        log(f"  {label}: p_iters against {ref_name} {ref_iters}: largest "
            f"difference {d_it}")
        if d_it > 1:
            raise AssertionError(f"{label}: p_iters differ by {d_it} > 1")
    return {"steps": steps, "ms_per_step_with_writes": ms,
            "ms_per_step_without_writes": ms_bare,
            "io_seconds": stats["io_seconds"], "p_iters": iters,
            "p_iters_hist": hist, "ranks": per_rank}


def run_ranks_killed_and_resumed(label, setup, devices, device, ranks,
                                 restart, lines=None):
    """`run_case(devices=..., device=..., ranks=...)` of a fresh case
    (`setup(base) -> case dir`) over two write intervals, killed after
    the first and resumed from `restart` (the bytes of another run's t =
    0.05 checkpoint, put in place of this run's): (first run's stats,
    resumed run's stats, this run's own checkpoint at 0.05, its
    checkpoint at 0.1 before the kill, the final checkpoint, the write
    times after each run, probe rows, the bytes of case.json and
    constant/6DoF.dat). `lines` collects the runs' log lines."""
    from openfoam_tpp_tpu_torch.manager.runner import run_case
    from openfoam_tpp_tpu_torch.utils.io import (list_checkpoints,
                                                 load_checkpoint)

    def case_log(ln):
        if lines is not None:
            lines.append(ln)
        log(f"  | [{label}] " + ln)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_xranks_") as base:
        case = setup(base)
        times, runs = [], []
        for kill in (True, False):
            runs.append(run_case(case, devices=devices, device=device,
                                 ranks=ranks, log=case_log))
            chks = list_checkpoints(case)
            times.append([float(load_checkpoint(p)["t"]) for _, p in chks])
            if kill:
                own = [load_checkpoint(p) for _, p in chks[1:]]
                os.remove(chks[2][1])
                with open(chks[1][1], "wb") as f:
                    f.write(restart)
        final = load_checkpoint(list_checkpoints(case)[-1][1])
        rows = len(probe_table(case, "p"))
        files = {}
        for rel in ("case.json", os.path.join("constant", "6DoF.dat")):
            if os.path.exists(os.path.join(case, rel)):
                with open(os.path.join(case, rel), "rb") as f:
                    files[rel] = f.read()
    return runs[0], runs[1], own[0], own[1], final, times, rows, files


def run_case_fresh(params, devices, device, label):
    """`run_case` of a fresh case: its stats."""
    from openfoam_tpp_tpu_torch.manager.cases import setup_case
    from openfoam_tpp_tpu_torch.manager.runner import run_case

    with tempfile.TemporaryDirectory(prefix="chip_smoke_xranks_") as base:
        return run_case(setup_case(params, base), devices=devices,
                        device=device,
                        log=lambda ln: log(f"  | [{label}] " + ln))


def hold_ranks_to_12b(label, x_run, x_final, x_times, run):
    """A killed and resumed run over ranks (`run_ranks_killed_and_resumed`
    restarted from phase 12b's t = 0.05 checkpoint) against phase 12b's
    run: from that same state, every step's p_iters within 1 of 12b's and
    the final checkpoint within phase 3b's limits of 12b's, the
    velocities' plus FARM_DRIFT·0.05 s (the drift of the farm's parts
    from the batch, whose CG dots differ in their last bits as the
    ranks' do from one process's: the ranks add their slabs' sums in rank
    order, one process sums the whole grid); the write times bitwise, a
    probe row a step. From rest the two runs are reported, not held: a
    moved last bit moves a CG stop, and from then on they part at the CG
    tolerance, the size of the velocities this early in the ramp."""
    import torch

    first, again, own_half, own_end, final, times, rows, _ = run
    x_half = npz_from_bytes(x_run["first_checkpoint"])
    n1 = x_run["first_interval_steps"]
    out = hold_rank_run(label, first, None)
    iters, ref = out["p_iters"], x_run["p_iters"]
    d_rest = max(abs(a - b) for a, b in zip(iters, ref))
    log(f"  {label}, from rest: p_iters {iters} against phase 12b's {ref} "
        f"({len(iters)} and {len(ref)} steps; largest difference {d_rest}, "
        "not held: the trajectories part at the first moved stop)")
    out["from_rest_max_p_iters_diff"] = d_rest
    out["resumed"] = hold_rank_run(label + ", resumed from phase 12b's "
                                   "t = 0.05 checkpoint", again, ref[n1:])
    tols = {**SHARD_TOLS, **DT_TOL}
    as_state = lambda d: types.SimpleNamespace(
        **{k: torch.as_tensor(v) for k, v in d.items()})
    out["own_at_0.05"] = hold_checkpoint(
        f"{label}, own t = 0.05 checkpoint against phase 12b's", own_half,
        as_state(x_half), tols, held=False)
    out["own_at_0.1"] = hold_checkpoint(
        f"{label}, own t = 0.1 checkpoint against phase 12b's", own_end,
        as_state(x_final), tols, held=False)
    out["final"] = hold_checkpoint(
        f"{label}, resumed, final against phase 12b's", final,
        as_state(x_final), tols,
        drift=FARM_DRIFT * (float(x_final["t"]) - float(x_half["t"])))
    if times != [x_times, x_times] or rows != int(final["step"]):
        raise AssertionError(f"{label}: write times {times} against "
                             f"{x_times}; {rows} probe rows for "
                             f"{final['step']} steps")
    log(f"  {label}: write times bitwise phase 12b's {x_times}; {rows} "
        "probe rows, one a step")
    return out


def phase_mesh_x_ranks(dev, x_run, x_final, x_times, flagship,
                       flagship_params):
    """(d) The x-sharded step over ranks, one process a shard
    (parallel/ranks.py): (i) one rank under NCCL on the card against the
    SpmdCtx(1) step (bitwise); gloo's CUDA collectives probed; (ii)
    `run_case(devices=4, device=card, ranks=True)` of the flagship, four
    ranks sharing the card under gloo, killed after the first interval and
    resumed, held against phase 12b's run (`x_run`, its final checkpoint
    and write times); (iii) each rank's launches and exchange counts;
    (iv) over min(count, 4) distinct cards under NCCL where the host has
    more than one."""
    import torch

    from openfoam_tpp_tpu_torch.parallel import ranks as rk

    from openfoam_tpp_tpu_torch.manager.cases import setup_case

    card = f"cuda:{dev.index or 0}" if dev.type == "cuda" else str(dev)
    params = {**MESH_CASE, "duration": 0.1}

    def setup(base):
        return setup_case(params, base)

    out = {}
    t0 = time.perf_counter()
    (one,) = rk.launch(rank_one_job, [card], args=(params, N_RANK1),
                       log=lambda ln: log("  | " + ln))
    want = {k: v for k, v in one["single"]["launches"].items()}
    log(f"[mesh x over ranks (i): 1 rank, {one['backend']}, {card}] "
        f"{N_RANK1} flagship steps {one['grid']} from rest in "
        f"{time.perf_counter() - t0:.1f} s with the spawn: bitwise "
        f"SpmdCtx(1) {one['bitwise']} (max diffs {one['max_abs_diff']}); "
        f"ms/step in turns (rank, single, single, rank): "
        f"{one['ms_per_step_turns']}; p_iters "
        f"{one['rank']['p_iters']} / {one['single']['p_iters']}")
    if (not one["bitwise"] or one["rank"]["launches"] != want
            or one["rank"]["p_iters"] != one["single"]["p_iters"]):
        raise AssertionError(f"mesh x over ranks (i): bitwise "
                             f"{one['bitwise']}, launches "
                             f"{one['rank']['launches']} against {want}")
    out["one_rank"] = one
    try:
        probe = rk.launch(gloo_cuda_job, [card] * 2,
                          timeout_s=PROBE_TIMEOUT_S,
                          log=lambda ln: log("  | " + ln))[0]
    except RuntimeError as e:   # the probe informs; it decides nothing
        probe = {"probe": f"failed: {e}"}
    log(f"[mesh x over ranks: gloo collectives on CUDA tensors, 2 ranks on "
        f"{card}] {probe}")
    out["gloo_cuda"] = probe

    label = (f"mesh x over ranks (ii-a): {N_SHARDS} ranks sharing {card}, "
             f"phase 3's state ({FLAGSHIP_SHAPE})")
    res = rk.launch(rank_state_job, [card] * N_SHARDS,
                    args=(FLAGSHIP, flagship, flagship_params, N_RANK_STATE),
                    log=lambda ln: log("  | " + ln))
    out["from_phase3"] = hold_rank_steps(label, res)

    label = f"mesh x over ranks (ii): {N_SHARDS} ranks sharing {card}"
    run = run_ranks_killed_and_resumed(label, setup, N_SHARDS, card, True,
                                       x_run["first_checkpoint"])
    out["shared_card"] = hold_ranks_to_12b(label, x_run, x_final, x_times,
                                           run)
    n_cards = torch.cuda.device_count()
    k = min(n_cards, N_SHARDS)
    if k == N_SHARDS:
        label = f"mesh x over ranks (iv): {k} distinct cards"
        run = run_ranks_killed_and_resumed(label, setup, k, "cuda", False,
                                           x_run["first_checkpoint"])
        out["distinct_cards"] = hold_ranks_to_12b(label, x_run, x_final,
                                                  x_times, run)
    elif k > 1:
        # Another grid (nx rounds to 8·k): held as a run alone.
        label = f"mesh x over ranks (iv): {k} distinct cards"
        first = run_case_fresh(params, k, "cuda", label)
        out["distinct_cards"] = hold_rank_run(label, first, None)
    else:
        log(f"[mesh x over ranks (iv): distinct cards] did not run: "
            f"device_count = {n_cards}")
    return out


# Phase 12e: the 6DoF tank and a grid not a multiple of 8·N over ranks.
N_RANK1_6DOF = 10      # steps of (i): one NCCL rank from phase 8's state


def one_process_resume(geom, motion, params, chk_bytes, target, dev):
    """The runner's advance of the one-process `SpmdCtx(N_SHARDS)` step
    (with `motion`) from the checkpoint `chk_bytes` to `target`: what the
    ranks compute from that state, their sums added in one process.
    Returns (final state, p_iters of every step)."""
    from openfoam_tpp_tpu_torch.config import (PhysicalProperties,
                                               SolverControls)
    from openfoam_tpp_tpu_torch.manager.runner import (_case_params,
                                                       make_advance)
    from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
    from openfoam_tpp_tpu_torch.solver.timestep import make_step
    from openfoam_tpp_tpu_torch.utils.io import to_state

    inner = make_step(geom, PhysicalProperties(),
                      SolverControls(use_pallas=True), motion=motion,
                      carry_precond=True, spmd=SpmdCtx(N_SHARDS), device=dev)
    iters = []

    def step(*a, **k):
        out = inner(*a, **k)
        iters.append(int(out[1].p_iters))
        return out

    step.init_precond = inner.init_precond
    state = to_state(npz_from_bytes(chk_bytes), device=dev)
    state = make_advance(step)(state, _case_params(params, dev), target)[0]
    return state, iters


def npz_from_bytes(data):
    """A checkpoint's fields from its file's bytes."""
    from openfoam_tpp_tpu_torch.utils.io import load_checkpoint

    with tempfile.NamedTemporaryFile(suffix=".npz") as f:
        f.write(data)
        f.flush()
        return load_checkpoint(f.name)


def velocity_gaps(label, chk, state):
    """Log where two runs' velocities part: the largest gap of u, v and w
    on faces between two water cells (alpha > 0.5 on both sides) and
    between two air cells (alpha < 0.01), beside each set's scale.
    Returns {field: (water gap, water scale, air gap, air scale)}."""
    a, out = chk["alpha"], {}
    for ax, k in enumerate("uvw"):
        gap = np.abs(chk[k] - getattr(state, k).cpu().numpy())
        ref = np.abs(getattr(state, k).cpu().numpy())
        pad = np.pad(a, [(1, 1) if d == ax else (0, 0) for d in range(3)],
                     mode="edge")
        lo = pad[tuple(slice(0, -1) if d == ax else slice(None)
                       for d in range(3))]
        hi = pad[tuple(slice(1, None) if d == ax else slice(None)
                       for d in range(3))]
        row = []
        for mask in ((lo > 0.5) & (hi > 0.5), (lo < 0.01) & (hi < 0.01)):
            row += [float(gap[mask].max(initial=0.0)),
                    float(ref[mask].max(initial=0.0))]
        out[k] = tuple(row)
    log(f"  {label}: largest velocity gap in water / air faces (scale): "
        + "; ".join(f"{k} {w:.3e} ({ws:.3e}) / {r:.3e} ({rs:.3e})"
                    for k, (w, ws, r, rs) in out.items()))
    return out


def phase_ranks_6dof(dev, six, case5):
    """Phase 12e (module docstring): the 6DoF tutorial tank over ranks
    against phase 8 (`six`: its state and lone case run), and phase 5's
    112³ case (`case5`) resumed over ranks on its own grid. Returns the
    phase's stats."""
    import torch

    from openfoam_tpp_tpu_torch.core.state import state_to_numpy
    from openfoam_tpp_tpu_torch.manager.cases import (load_case_params,
                                                      setup_case,
                                                      setup_case_6dof)
    from openfoam_tpp_tpu_torch.manager.runner import (build_case_geometry,
                                                       build_case_motion,
                                                       run_case)
    from openfoam_tpp_tpu_torch.parallel import ranks as rk
    from openfoam_tpp_tpu_torch.utils.io import (list_checkpoints,
                                                 load_checkpoint)

    card = f"cuda:{dev.index or 0}" if dev.type == "cuda" else str(dev)
    out = {}
    as_state = lambda d: types.SimpleNamespace(
        **{k: torch.as_tensor(v) for k, v in d.items()})
    tols = {**SHARD_TOLS, **DT_TOL}

    # (i) one NCCL rank against the one-process SpmdCtx(1) step, bitwise.
    t0 = time.perf_counter()
    (one,) = rk.launch(rank_one_6dof_job, [card],
                       args=(six["state"], N_RANK1_6DOF),
                       log=lambda ln: log("  | " + ln))
    ran = rank_launches(one["rank"]["launches"])
    log(f"[6DoF over ranks (i): 1 rank, {one['backend']}, {card}] "
        f"{N_RANK1_6DOF} steps of the {one['grid']} tutorial tank from phase "
        f"8's state in {time.perf_counter() - t0:.1f} s with the spawn: "
        f"bitwise SpmdCtx(1) {one['bitwise']} (max diffs "
        f"{one['max_abs_diff']}); ms/step in turns (rank, single, single, "
        f"rank): {one['ms_per_step_turns']}; p_iters "
        f"{one['rank']['p_iters']} / {one['single']['p_iters']}; launches "
        f"{ran}")
    if (not one["bitwise"]
            or one["rank"]["launches"] != one["single"]["launches"]
            or one["rank"]["p_iters"] != one["single"]["p_iters"]
            or {k for k, v in ran.items() if v} != set(HALO_PATH)):
        raise AssertionError(f"6DoF over ranks (i): bitwise "
                             f"{one['bitwise']}, launches "
                             f"{one['rank']['launches']} against "
                             f"{one['single']['launches']}")
    out["one_rank"] = one

    # (ii) four gloo ranks sharing the card: the tutorial case through
    # run_case, killed after the first interval and resumed from the lone
    # run's t = 0.05 checkpoint, held against phase 8's lone run.
    lone = six["lone_run"]
    label = f"6DoF over ranks (ii): {N_SHARDS} ranks sharing {card}"
    lines = []
    run = run_ranks_killed_and_resumed(
        label, lambda base: setup_case_6dof(lone["case"], base), N_SHARDS,
        card, True, lone["first_checkpoint"], lines)
    first, again, own_half, own_end, final, times, rows, files = run
    nxl = SHAPE_6DOF[0] // N_SHARDS
    if not any(f"nxl = {nxl} planes" in ln for ln in lines):
        raise AssertionError(f"{label}: no log line names nxl = {nxl}")
    res = hold_rank_run(label, first, None)
    n1 = lone["first_interval_steps"]
    iters, ref = res["p_iters"], lone["p_iters"]
    d_rest = max(abs(a - b) for a, b in zip(iters, ref))
    log(f"  {label}, from rest: p_iters {iters} against the lone run's "
        f"{ref} ({len(iters)} and {len(ref)} steps; largest difference "
        f"{d_rest}, not held: the coarse levels run plain under spmd, "
        "and the trajectories part at the first moved stop)")
    res["from_rest_max_p_iters_diff"] = d_rest
    # The same state through the one-process SpmdCtx(4) step: the ranks'
    # preconditioner with the sums added in one process.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_6dof_table_") as d:
        cdir = setup_case_6dof(lone["case"], d)
        params = load_case_params(cdir)
        motion = build_case_motion(params, cdir, device=dev)
    one_state, one_iters = one_process_resume(
        build_case_geometry(params), motion, params,
        lone["first_checkpoint"], lone["times"][-1], dev)
    res["resumed"] = hold_rank_run(
        label + ", resumed from phase 8's t = 0.05 checkpoint", again,
        one_iters, ref_name="the one-process SpmdCtx(4) step's from it")
    r_iters = res["resumed"]["p_iters"]
    res["resumed"]["p_iters_equal_one_process"] = r_iters == one_iters
    res["resumed"]["lone_p_iters"] = ref[n1:]
    log(f"  {label}, resumed: p_iters {r_iters}, equal to the one-process "
        f"SpmdCtx(4) step's {one_iters}: {r_iters == one_iters}; the lone "
        f"run's {ref[n1:]} (reported)")
    lone_half = npz_from_bytes(lone["first_checkpoint"])
    res["own_at_0.05"] = hold_checkpoint(
        f"{label}, own t = 0.05 checkpoint against the lone run's", own_half,
        as_state(lone_half), tols, held=False)
    res["own_at_0.1"] = hold_checkpoint(
        f"{label}, own t = 0.1 checkpoint against the lone run's", own_end,
        as_state(lone["final"]), tols, held=False)
    # Phase 3b's limits plus FARM_DRIFT·t: in the air (1/ρ a thousand
    # times the water's) a last bit of the pressure is velocity noise, and
    # any change in the order of the CG's sums moves it (the one-process
    # sharded step parts from the lone run as far as the ranks do).
    drift = FARM_DRIFT * float(lone["final"]["t"])
    res["final"] = hold_checkpoint(
        f"{label}, resumed, final against the lone run's", final,
        as_state(lone["final"]), tols, drift=drift)
    res["final_gaps"] = velocity_gaps(
        f"{label}, resumed, against the lone run", final,
        as_state(lone["final"]))
    res["final_vs_one_process"] = hold_checkpoint(
        f"{label}, resumed, final against the one-process SpmdCtx(4) "
        "step's", final, one_state, tols, drift=drift)
    res["one_process_vs_lone"] = hold_checkpoint(
        "one-process SpmdCtx(4) step, resumed, final against the lone "
        "run's", state_to_numpy(one_state), as_state(lone["final"]), tols,
        held=False)
    same_files = (files.get("case.json") == lone["case_json"]
                  and files.get(os.path.join("constant", "6DoF.dat"))
                  == lone["table"])
    digests = {r["motion_sha256"] for r in first["ranks"] + again["ranks"]}
    if (times != [lone["times"], lone["times"]] or rows != int(final["step"])
            or not same_files or digests != {motion.sha256()}):
        raise AssertionError(f"{label}: write times {times} against "
                             f"{lone['times']}; {rows} probe rows for "
                             f"{final['step']} steps; case files equal "
                             f"{same_files}; table digests {digests}")
    log(f"  {label}: write times bitwise the lone run's {lone['times']}; "
        f"case.json and constant/6DoF.dat byte-equal; every rank's table "
        f"bits the case's; {rows} probe rows, one a step")
    out["tank6dof"] = res

    # (iii) phase 5's 112³ case, copied with its t = 0.05 checkpoint and
    # resumed over four gloo ranks (nxl 28 → 14 → 7: 112 is not a
    # multiple of 8·4), held against phase 5's own t = 0.1 checkpoint.
    label = (f"112^3 over ranks (iii): {N_SHARDS} ranks sharing {card}, "
             "phase 5's case resumed at t = 0.05")
    lines = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_b_ranks_") as base:
        case_dir = setup_case(case5["params"], base)
        for name, data in case5["checkpoints"][:2]:
            with open(os.path.join(case_dir, name), "wb") as f:
                f.write(data)
        with environ(OFTPP_SMOOTH_SWEEPS="2"):   # as phase 5 ran it
            stats = run_case(case_dir, devices=N_SHARDS, device=card,
                             ranks=True, log=lambda ln: (
                                 lines.append(ln),
                                 log(f"  | [{label}] " + ln)))
        chks = list_checkpoints(case_dir)
        times = [float(load_checkpoint(p)["t"]) for _, p in chks]
        final = load_checkpoint(chks[-1][1])
        rows = len(probe_table(case_dir, "p", start=times[1]))
    want = [float(npz_from_bytes(d)["t"]) for _, d in case5["checkpoints"]]
    ref5 = npz_from_bytes(case5["checkpoints"][-1][1])
    nxl = FLAGSHIP_SHAPE[0] // N_SHARDS
    if (not any(f"nxl = {nxl} planes" in ln for ln in lines)
            or final["alpha"].shape != FLAGSHIP_SHAPE or times != want
            or rows != stats["steps"]):
        raise AssertionError(f"{label}: grid {final['alpha'].shape}, write "
                             f"times {times} against {want}, {rows} probe "
                             f"rows for {stats['steps']} steps, log {lines}")
    # The same state through the one-process SpmdCtx(4) step.
    with environ(OFTPP_SMOOTH_SWEEPS="2"):
        one_state, one_iters = one_process_resume(
            build_case_geometry(case5["params"]), None, case5["params"],
            case5["checkpoints"][1][1], want[-1], dev)
    res = hold_rank_run(label, stats, one_iters, sweeps=2,
                        ref_name="the one-process SpmdCtx(4) step's from it")
    n1 = case5["intervals"][0]["steps"]
    d_it = max(abs(a - b)
               for a, b in zip(res["p_iters"], case5["p_iters"][n1:]))
    log(f"  {label}: p_iters {res['p_iters']} against phase 5's "
        f"{case5['p_iters'][n1:]} (reported; largest difference {d_it}); "
        f"write times bitwise phase 5's {want}; {rows} probe rows, one a "
        "step")
    res["phase5_p_iters"] = case5["p_iters"][n1:]
    drift = FARM_DRIFT * want[-1]
    res["final"] = hold_checkpoint(
        f"{label}, final against phase 5's t = 0.1 checkpoint", final,
        as_state(ref5), tols, drift=drift)
    res["final_gaps"] = velocity_gaps(
        f"{label}, against phase 5", final, as_state(ref5))
    res["final_vs_one_process"] = hold_checkpoint(
        f"{label}, final against the one-process SpmdCtx(4) step's", final,
        one_state, tols, drift=drift)
    res["one_process_vs_phase5"] = hold_checkpoint(
        "one-process SpmdCtx(4) step, resumed, final against phase 5's",
        state_to_numpy(one_state), as_state(ref5), tols, held=False)
    out["flagship_resumed"] = res
    return out


def phase_closed_top_halo(dev):
    """Phase 2's halo part, (v): `correct_divmax_h` in its closed-top form
    on the 6DoF tutorial tank's operands cut into N_SHARDS x-slabs
    (20×80×160 each): the chamfered tank's apertures and volume
    fractions, seeded dp, velocities, face 1/ρ and density, the
    velocities zero where the aperture is; every slab bitwise its plain
    version (the div max too), the island bitwise the single-grid
    kernel; the N_SHARDS launches timed (device µs) beside their bytes
    and bound. Returns the row."""
    import torch

    from openfoam_tpp_tpu_torch.mesh import build_chamfer_tank_geometry
    from openfoam_tpp_tpu_torch.ops.kernels import correction as ck
    from openfoam_tpp_tpu_torch.parallel import spmd as sm
    from openfoam_tpp_tpu_torch.solver.timestep import geometry_arrays
    from openfoam_tpp_tpu_torch.utils.devtime import device_ms

    geom = build_chamfer_tank_geometry(**TANK6DOF)
    ga = geometry_arrays(geom, device=dev)
    spacing = tuple(float(h) for h in geom.spacing)
    nx, ny, nz = geom.shape
    ctx = sm.SpmdCtx(N_SHARDS)
    rng = np.random.default_rng(2017)

    def arr(shape, lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32)).to(dev)

    aps = (ga["ax"], ga["ay"], ga["az"])
    vel = tuple(torch.where(a > 0, arr(a.shape, -1.0, 1.0), 0.0) for a in aps)
    beta = tuple(arr(a.shape, 8e-4, 1e-3) for a in aps)
    dp, rho = arr(geom.shape, -50.0, 50.0), arr(geom.shape, 1.0, 998.0)
    vfrac, topo = ga["vfrac"], ga["top_open"]
    dt0 = torch.tensor(3.7e-3, device=dev)
    dps = ctx.split(dp)
    dh = sm.exchange_halo(dps, 1, ctx)
    packed = [ctx.split(t, nx) for t in (vel[0], beta[0], aps[0])]
    his = [sm.exchange_hi(t, 1, ctx) for t in packed]
    rest = [ctx.split(t) for t in (*vel[1:], *beta[1:], *aps[1:], vfrac,
                                   rho)]
    ca = [(dps[i], *dh[i], packed[0][i], his[0][i], rest[0][i], rest[1][i],
           packed[1][i], his[1][i], rest[2][i], rest[3][i], packed[2][i],
           his[2][i], rest[4][i], rest[5][i], rest[6][i], None, rest[7][i],
           dt0, spacing, False) for i in ctx.held]
    kern = [lambda a=a: ck.correct_divmax_h(*a) for a in ca]
    plain = [lambda a=a: ck.correct_divmax_h_plain(*a) for a in ca]
    slabs = all(same_bits(k(), p()) for k, p in zip(kern, plain))
    args = (dp, *vel, beta, *aps, vfrac, topo, rho, dt0, spacing)
    island = same_bits(sm.correct_divmax(*args, ctx, open_top=False),
                       ck.correct_divmax(*args, open_top=False))
    torch.cuda.synchronize()
    ms = device_ms(lambda: [k() for k in kern], REPS)
    plain_ms = device_ms(lambda: [p() for p in plain], REPS)
    single_ms = device_ms(lambda: ck.correct_divmax(*args, open_top=False),
                          REPS)
    # Phase 2's count of a call's bytes: every operand read once (the
    # density's top plane; no atmosphere plane: the top is closed), u, v
    # and w written once.
    b = sum(nbytes(*a[:16], a[17][:, :, -1], a[3], a[5], a[6]) for a in ca)
    bound_ms = b / HBM_BYTES_PER_S * 1e3
    log(f"  correct_divmax_h   closed top, 6DoF slabs x{N_SHARDS} "
        f"({nx // N_SHARDS}x{ny}x{nz}): every slab bitwise plain {slabs}, "
        f"island bitwise the single-grid kernel {island}; kernels "
        f"{ms * 1e3:.1f} us ({N_SHARDS} launches, {ms * 1e3 / N_SHARDS:.1f} "
        f"a slab)  plain {plain_ms * 1e3:.1f} us  single-grid "
        f"{single_ms * 1e3:.1f} us  bytes {b / 1e6:.2f} MB  bound "
        f"{bound_ms * 1e3:.2f} us ({ms / bound_ms:.2f}x)")
    if not (slabs and island):
        raise AssertionError("correct_divmax_h closed top on the 6DoF "
                             "slabs: not bitwise its plain version or the "
                             "single-grid kernel")
    return {"shape": [nx // N_SHARDS, ny, nz], "slabs": N_SHARDS, "ms": ms,
            "plain_ms": plain_ms, "single_grid_ms": single_ms, "bytes": b,
            "bound_ms": bound_ms, "bitwise_plain": slabs,
            "bitwise_single_grid": island}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from openfoam_tpp_tpu_torch.config import PhysicalProperties, SolverControls
    from openfoam_tpp_tpu_torch.core.state import (CaseParams, init_state,
                                                   state_to_numpy)
    from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
    from openfoam_tpp_tpu_torch.ops.kernels import _build
    from openfoam_tpp_tpu_torch.solver.timestep import make_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    laps, t_lap = {}, [t_start]

    def lap(phase):
        """Log and keep the wall seconds since the last lap."""
        now = time.perf_counter()
        laps[phase] = now - t_lap[0]
        t_lap[0] = now
        log(f"[phase {phase}] {laps[phase]:.1f} s")

    # 1. build
    t0 = time.perf_counter()
    logs = _build.build_all(ptxas_verbose=True)
    log(f"[build] {len(logs)} kernel sources, nvcc in parallel: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3's geometry first: phase 2 uses its shape.
    t0 = time.perf_counter()
    geom = build_tank_geometry(**FLAGSHIP)
    n_fluid = geom.n_fluid_cells
    log(f"[geometry] {geom.shape}, {n_fluid} fluid cells, "
        f"{time.perf_counter() - t0:.1f} s")

    lap("1")

    # 2. kernels against their plain versions
    log(f"[kernels vs plain] shape {geom.shape}, {REPS} timed launches each")
    spacing = tuple(float(h) for h in geom.spacing)
    rows = phase_kernels(geom.shape, spacing, dev)
    shape4 = (12, 12, 50, SWEEP_CASES)
    log(f"[batch kernels vs plain and vs the single-grid kernels] shape "
        f"{shape4}, {REPS} timed launches each")
    rows.update(phase_batch_kernels(shape4, dev))
    log(f"[halo kernels vs plain and, composed, vs the single-grid kernels] "
        f"shape {geom.shape} in {N_SHARDS} x-shards, {REPS} timed launches "
        "each")
    rows.update(phase_halo_kernels(geom.shape, spacing, dev))
    closed_halo = phase_closed_top_halo(dev)

    lap("2")

    # 3. the step path: the bench's configuration from rest, then the
    # five configurations from the state it reached
    props = PhysicalProperties()
    params = CaseParams.make(R=0.004, freq=1.88, duration=20.0, device=dev)

    def build(controls=SolverControls(use_pallas=True), spmd=None, **env):
        with environ(**env):   # gates and knobs are read at build time
            return make_step(geom, props, controls, carry_precond=True,
                             spmd=spmd, device=dev)

    step = build()
    state = init_state(geom, dt0=1e-3, device=dev)
    bundle = step.init_precond(state)
    state, bundle, launches, main = drive(
        "step path: use_pallas=True", step, state, bundle, params, N_STEPS,
        N_TIMED, n_fluid, DEFAULT_PATH)
    log("[kernels on the operands of one flagship step from that state]")
    phase_step_operands(step, state, params, rows)
    sweeps2 = {"OFTPP_SMOOTH_SWEEPS": "2"}
    rz_off = {**sweeps2, "OFTPP_FUSED_RZ": "0"}
    finish = {"OFTPP_FINISH_PALLAS": "1"}
    configs = {
        "use_pallas": (step, DEFAULT_PATH),
        "mom_pallas_false": (build(SolverControls(use_pallas=True,
                                                  mom_pallas=False)),
                             [k for k in DEFAULT_PATH if k not in FUSED]),
        "finish_on": (build(**finish), DEFAULT_PATH + ("momentum_finish",)),
        "sweeps2": (build(**sweeps2), DEFAULT_PATH + CHEB2_RZ),
        "sweeps2_fused_rz_off": (build(**rz_off), DEFAULT_PATH + CHEB2_NO_RZ),
    }
    log("[the fused smoothers on the operands of one two-sweep step from "
        "that state]")
    phase_step_operands(configs["sweeps2"][0], state, params, rows, CHEB2_RZ)
    runs = {}
    for name, (stp, expect) in configs.items():
        # A bundle of this configuration's own knobs (one or two sweeps
        # share its arrays; built anew all the same).
        _, _, run_launches, runs[name] = drive(
            f"{name}, same state", stp, state, stp.init_precond(state),
            params, N_SHORT, N_SHORT_TIMED, n_fluid, expect)
        if name == "finish_on":
            launches["momentum_finish"] = run_launches["momentum_finish"]
        if name == "sweeps2_fused_rz_off":
            launches["cheb2_post_7pt"] = run_launches["cheb2_post_7pt"]
    log("[one or two sweeps, same state, one run each: resolves no gain] "
        + "; ".join(f"{k}: {runs[k]['ms_per_step']:.3f} ms/step, p_iters "
                    f"{runs[k]['p_iters_hist']}"
                    for k in ("use_pallas", "sweeps2", "sweeps2_fused_rz_off")))

    lap("3")

    # 3b. the x-sharded step from the same state
    halo_launches, sharded = phase_sharded(build, state, params, n_fluid)
    for k in HALO_PATH:
        launches[k] = halo_launches[k]
    lap("3b")

    # 4. the whole step, kernels against plain versions, from one state:
    # the finish-on step with one sweep, with two, and with two and the
    # separate r·z (together all eleven entry points are swapped)
    for label, env in (("one sweep", finish),
                       ("two sweeps", {**finish, **sweeps2}),
                       ("two sweeps, r·z apart", {**finish, **rz_off})):
        hold_to_plain(f"step, {label}",
                      steps_from(build(**env), state, params))

    lap("4")

    # 5. the case path, as a user drives it; 11. the manager's top layer,
    # on that case first
    with tempfile.TemporaryDirectory(prefix="chip_smoke_case_") as base:
        case_launches, case = phase_case(geom, base)
        for k in CHEB2_RZ:
            launches[k] = case_launches[k]
        lap("5")
        top = phase_top(dev, base, case)
        top["menu"] = phase_menu(base)
        lap("11")

    # 6. the sweep step; 7. the manager's sweep
    sweep_launches, sweep = phase_sweep(dev, props)
    for k in BATCH_PATH:
        launches[k] = sweep_launches[k]
    lap("6")
    _, manager = phase_manager(dev)
    lap("7")
    top["resources"] = resource_constants(case, manager)

    # 8. the 6DoF path
    tank6dof = phase_6dof(dev, props, rows)
    lap("8")

    # 9. surface tension on the flagship; 10. the tiled sweep
    csf, csf_launches = phase_csf(dev, geom, props, params, step, main)
    lap("9")
    tiled, tiled_rows, tiled_launches = phase_tiled(dev, props, sweep)
    lap("10")

    # 12. the device mesh on one card
    mesh = phase_mesh(torch.device("cuda", 0), props, geom, sweep,
                      state_to_numpy(state),
                      {k: getattr(params, k).cpu().numpy()
                       for k in ("orbit_radius", "omega", "ramp_time")})
    lap("12")
    mesh["ranks_6dof"] = phase_ranks_6dof(dev, tank6dof, case)
    lap("12e")
    for key in ("state", "lone_run"):
        tank6dof.pop(key)
    case.pop("checkpoints")
    log("[kernels: flagship (phase 2 / a flagship step's operands) and the "
        f"tiled {TILED_SHAPE} step's operands, us per call; of the V-cycle "
        "rows the finest level's calls, then the mean of all]")
    for name in STEP_ROWS:
        r, t = rows[name], tiled_rows[name]
        # The finest level: the calls that move the most bytes.
        rf, tf = (max(x["step_levels"], key=lambda lv: lv["bytes"])
                  for x in (r, t))
        every = (f"  all {sum(lv['calls'] for lv in t['step_levels'])} "
                 f"calls {t['step_ms'] * 1e3:.1f} (flagship "
                 f"{r['step_ms'] * 1e3:.1f})"
                 if len(t["step_levels"]) > 1 else "")
        log(f"  {name:17s} flagship {r['ms'] * 1e3:.1f} / "
            f"{rf['ms'] * 1e3:.1f} (bound {rf['bound_ms'] * 1e3:.2f})  "
            f"tiled {tf['ms'] * 1e3:.1f} (bound {tf['bound_ms'] * 1e3:.2f}, "
            f"{tf['ms'] / tf['bound_ms']:.2f}x){every}"
            f"  launches per step: CSF "
            f"{csf['launches_per_step'][name]:.2f}, tiled "
            f"{tiled['launches_per_step'][name]:.2f}")

    out = []
    for name in REPLACES:
        r = dict(rows[name])
        r["launches"] = launches[name]
        out.append(r)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    detail = {"kernels": out, "shape": list(geom.shape), "fluid_cells": n_fluid,
              "runs": {"use_pallas_from_rest": main, "same_state": runs,
                       "sharded": sharded, "case_path": case, "sweep": sweep,
                       "runsweep": manager, "tank6dof": tank6dof,
                       "csf": csf, "tiled": tiled, "top": top,
                       "mesh": mesh},
              "tiled_kernel_rows": tiled_rows, "phase_seconds": laps,
              "closed_top_halo_6dof": closed_halo,
              "launches": {"csf": csf_launches, "tiled": tiled_launches}}
    os.makedirs(os.path.join(repo, "perf_out"), exist_ok=True)
    with open(os.path.join(repo, "perf_out", "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in out]}))
    print(smi.stdout.strip().splitlines()[0])
    # The run drives one card, whatever else the host holds.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
