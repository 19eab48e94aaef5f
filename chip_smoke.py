#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (openfoam_tpp_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on any fault (nothing is caught):
  1. build every CUDA kernel from csrc/ with nvcc (one process per
     source, all at once) and print the build time;
  2. hold every kernel entry point against its plain PyTorch version on
     the card, at the 112³ flagship shapes, from seeded random inputs
     with zero boundary-face weights; print errors beside tolerances and
     kernel / plain times;
  3. drive the port's main path: the flagship single-tank case
     (H0.208/D0.2/R0.004/f1.88, mesh 0.00185, round_to=8 → 112³) through
     `make_step(..., carry_precond=True)` with
     SolverControls(use_pallas=True, mom_pallas=False) for N_STEPS steps;
     check alpha bounds, Courant, p_iters, finiteness and that every
     kernel was launched;
  4. from the same state, N_CMP steps with the kernels and N_CMP with
     their plain versions on the card; compare alpha, u, v, w, p.

It then prints the `kernels` JSON line, the card's name and power limit,
and last `{"ok": true, "device": {...}}`. It exits non-zero, printing no
result, when no CUDA device is available or the package is missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import unittest.mock as mock

import numpy as np

N_STEPS = 100
N_TIMED = 90          # the last N_TIMED of the N_STEPS are timed
N_CMP = 5
REPS = 20             # kernel timing launches (after 3 warm-up)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak bandwidth
F32_FLOPS = 67e12           # H100 SXM f32, outside the tensor cores
F32_RTOL = 1e-6
BF16_RTOL = 2.0 ** -8
DOT_RTOL = 1e-5

# Per-cell f32 operation counts of each kernel's arithmetic (for the
# operations half of the bound; every kernel here is bandwidth-bound).
FLOPS_PER_CELL = {
    "apply_7pt": 13, "resid_scaled_7pt": 15, "apply_dot_7pt": 15,
    "flux_all": 3 * 30, "fct_iter": 4 * 60 + 3 * 6,
}
REPLACES = {
    "apply_7pt": "openfoam_tpp_tpu/ops/pallas/seven_point.py:229",
    "resid_scaled_7pt": "openfoam_tpp_tpu/ops/pallas/seven_point.py:258",
    "apply_dot_7pt": "openfoam_tpp_tpu/ops/pallas/seven_point.py:286",
    "flux_all": "openfoam_tpp_tpu/ops/pallas/mules_flux.py:135",
    "fct_iter": "openfoam_tpp_tpu/ops/pallas/mules_fct.py:217",
}
SOURCE = {
    "apply_7pt": "openfoam_tpp_tpu_torch/csrc/seven_point.cu",
    "resid_scaled_7pt": "openfoam_tpp_tpu_torch/csrc/seven_point.cu",
    "apply_dot_7pt": "openfoam_tpp_tpu_torch/csrc/seven_point.cu",
    "flux_all": "openfoam_tpp_tpu_torch/csrc/mules_flux.cu",
    "fct_iter": "openfoam_tpp_tpu_torch/csrc/mules_fct.cu",
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=REPS):
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def max_err(got, ref):
    """(max abs error, scale) between two tensors or tuples of tensors."""
    if not isinstance(got, (tuple, list)):
        got, ref = (got,), (ref,)
    err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.float().abs().max()) for r in ref)
    return err, scale


def phase_kernels(shape, dev):
    """Each entry point against its plain version at `shape`; returns the
    measured rows of the main-path variants keyed by kernel name."""
    import torch

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

    def check(name, variant, main, kern, plain, ins, outs, tol):
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err, scale = max_err(got, ref)
        rel = err / max(scale, 1e-30)
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        b = nbytes(*ins) + nbytes(*outs)
        t_bytes = b / HBM_BYTES_PER_S * 1e3
        t_ops = FLOPS_PER_CELL[name] * n_cells / F32_FLOPS * 1e3
        ok = rel <= tol
        log(f"  {name:17s} {variant:22s} max_abs_err={err:.3e} rel={rel:.3e} "
            f"tol={tol:.1e} {'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  bytes {b / 1e6:.2f} MB  "
            f"bound {max(t_bytes, t_ops):.4f} ms")
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
            }

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
        derr = abs(float(dot_k) - float(dot_p)) / max(abs(float(dot_p)), 1e-30)
        log(f"  apply_dot_7pt     {tag} dot kernel {float(dot_k)!r} plain "
            f"{float(dot_p)!r} rel_err={derr:.3e} tol={DOT_RTOL:.1e}")
        if derr > DOT_RTOL:
            raise AssertionError(f"apply_dot_7pt {tag}: dot disagrees")
        check("apply_dot_7pt", f"{tag} unit", tag == "f32",
              lambda: sp.apply_dot_7pt(p, w)[0],
              lambda: sp.apply_dot_7pt_plain(p, w)[0], (p, *w), (p,), tol)

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
    spacing = (0.00185, 0.00185, 0.00185)
    for tag, dt in (("bf16 λ/anti", torch.bfloat16), ("f32", torch.float32)):
        lams = tuple(arr(0, 1, dt) for _ in range(3))
        antis = tuple((1e-3 * arr()).to(dt) for _ in range(3))
        check("fct_iter", tag, dt == torch.bfloat16,
              lambda: mf.fct_iter(lams, antis, al, amax, amin, dt_iv, spacing),
              lambda: mf.fct_iter_plain(lams, antis, al, amax, amin, dt_iv,
                                        spacing),
              (*lams, *antis, al, amax, amin, dt_iv), lams,
              BF16_RTOL if dt == torch.bfloat16 else F32_RTOL)
    return rows


def counters():
    from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as mf
    from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as mfx
    from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp

    return {"apply_7pt": sp.apply_7pt, "resid_scaled_7pt": sp.resid_scaled_7pt,
            "apply_dot_7pt": sp.apply_dot_7pt, "flux_all": mfx.flux_all,
            "fct_iter": mf.fct_iter}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from openfoam_tpp_tpu_torch.config import PhysicalProperties, SolverControls
    from openfoam_tpp_tpu_torch.core.state import CaseParams, init_state
    from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
    from openfoam_tpp_tpu_torch.ops.kernels import _build
    from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as mf
    from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as mfx
    from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp
    from openfoam_tpp_tpu_torch.solver.timestep import make_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

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
    geom = build_tank_geometry(H=0.208, D=0.2, mesh=0.00185, geo="flat",
                               round_to=8)
    n_fluid = geom.n_fluid_cells
    log(f"[geometry] {geom.shape}, {n_fluid} fluid cells, "
        f"{time.perf_counter() - t0:.1f} s")

    # 2. kernels against their plain versions
    log(f"[kernels vs plain] shape {geom.shape}, {REPS} timed launches each")
    rows = phase_kernels(geom.shape, dev)

    # 3. the main path
    props = PhysicalProperties()
    controls = SolverControls(use_pallas=True, mom_pallas=False)
    step = make_step(geom, props, controls, carry_precond=True, device=dev)
    params = CaseParams.make(R=0.004, freq=1.88, duration=20.0, device=dev)
    state = init_state(geom, dt0=1e-3, device=dev)
    fns = counters()
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    bundle = step.init_precond(state)
    diags = []
    t_first = time.perf_counter()
    for i in range(N_STEPS):
        if i == N_STEPS - N_TIMED:
            torch.cuda.synchronize()
            t_timed = time.perf_counter()
        state, d, bundle = step(state, params, precond=bundle)
        diags.append(d)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k: f.launches for k, f in fns.items()}
    wall = t_end - t_timed
    ms_step = wall / N_TIMED * 1e3
    iters = [int(d.p_iters) for d in diags]
    co = max(float(d.courant) for d in diags)
    a_min = min(float(d.alpha_min) for d in diags)
    a_max = max(float(d.alpha_max) for d in diags)
    hist = {int(k): int(v) for k, v in zip(*np.unique(iters, return_counts=True))}
    log(f"[main path] {N_STEPS} steps in {t_end - t_first:.2f} s; last "
        f"{N_TIMED}: {ms_step:.3f} ms/step, "
        f"{n_fluid * N_TIMED / wall:.4e} cell-updates/s, "
        f"sim t={float(state.t):.5f} s, dt={float(state.dt):.3e} s")
    log(f"  p_iters histogram {hist}; max Courant {co:.4f}; alpha in "
        f"[{a_min:.3e}, {a_max:.6f}]; max div error "
        f"{max(float(d.div_error) for d in diags):.3e}")
    log(f"  kernel launches {launches} "
        f"(per step: {({k: v / N_STEPS for k, v in launches.items()})})")
    fields = {k: getattr(state, k) for k in ("alpha", "u", "v", "w", "p")}
    if not all(bool(torch.isfinite(v).all()) for v in fields.values()):
        raise AssertionError("non-finite field after the main path")
    if a_min < 0.0 or a_max > 1.0:
        raise AssertionError(f"alpha out of [0, 1]: [{a_min}, {a_max}]")
    if co > 0.6:
        raise AssertionError(f"Courant {co} > 0.6")
    if max(iters) >= 50:
        raise AssertionError(f"p_iters reached {max(iters)}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{launches}")

    # 4. the whole step, kernels against plain versions, from one state
    def run(n):
        s, b = state, bundle
        its = []
        for _ in range(n):
            s, dd, b = step(s, params, precond=b)
            its.append(int(dd.p_iters))
        return s, its

    s_k, it_k = run(N_CMP)
    with mock.patch.object(sp, "apply_7pt", sp.apply_7pt_plain), \
            mock.patch.object(sp, "resid_scaled_7pt", sp.resid_scaled_7pt_plain), \
            mock.patch.object(sp, "apply_dot_7pt", sp.apply_dot_7pt_plain), \
            mock.patch.object(mfx, "flux_all", mfx.flux_all_plain), \
            mock.patch.object(mf, "fct_iter", mf.fct_iter_plain):
        s_p, it_p = run(N_CMP)
    torch.cuda.synchronize()
    log(f"[step kernels vs plain] {N_CMP} steps; p_iters kernels {it_k} "
        f"plain {it_p}")
    # Per call the kernels match their plain versions to an ulp (phase 2).
    # Over 5 steps an ulp can flip the rounding of a bf16 λ (2^-8 of that
    # face's antidiffusive flux), which moves an interface cell's alpha by
    # ~1e-4 (limit 1e-3) and, where the density jumps 1000:1, its face
    # velocities by a few 1e-3 of the field's scale (limit 1e-2); p is
    # held to 1e-4 of its scale, the CG tolerance's order.
    tols = {"alpha": ("abs", 1e-3), "u": ("rel", 1e-2), "v": ("rel", 1e-2),
            "w": ("rel", 1e-2), "p": ("rel", 1e-4)}
    bad = []
    for k, (kind_t, tol) in tols.items():
        err, scale = max_err(getattr(s_k, k), getattr(s_p, k))
        lim = tol if kind_t == "abs" else tol * scale
        log(f"  {k}: max_abs_err {err:.3e} limit {lim:.3e} (scale {scale:.3e})")
        if err > lim:
            bad.append(f"{k}: {err} > {lim}")
    if bad:
        raise AssertionError(f"step kernels vs plain: {bad}")
    if any(abs(a - b) > 1 for a, b in zip(it_k, it_p)):
        raise AssertionError(f"p_iters differ by more than 1: {it_k} {it_p}")

    out = []
    for name in REPLACES:
        r = dict(rows[name])
        r["launches"] = launches[name]
        out.append(r)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    detail = {"kernels": out, "main_path": {
        "shape": list(geom.shape), "fluid_cells": n_fluid,
        "steps": N_STEPS, "timed_steps": N_TIMED, "ms_per_step": ms_step,
        "cell_updates_per_s": n_fluid * N_TIMED / wall,
        "p_iters_hist": hist, "launches_per_step":
            {k: v / N_STEPS for k, v in launches.items()},
        "max_courant": co, "sim_t": float(state.t)}}
    os.makedirs(os.path.join(repo, "perf_out"), exist_ok=True)
    with open(os.path.join(repo, "perf_out", "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in out]}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
