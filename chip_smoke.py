#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (openfoam_tpp_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on any fault (nothing is caught):
  1. build every CUDA kernel from csrc/ with nvcc (one process per
     source, all at once) and print the build time;
  2. hold every kernel entry point against its plain PyTorch version on
     the card, at the 112³ flagship shapes, from seeded random inputs
     with zero wall faces; print errors beside tolerances, kernel / plain
     times, bytes and bounds;
  3. drive the port's main path: the flagship single-tank case
     (H0.208/D0.2/R0.004/f1.88, mesh 0.00185, round_to=8 → 112³) through
     `make_step(..., carry_precond=True)` in the bench's configuration,
     SolverControls(use_pallas=True), for N_STEPS steps from rest; then,
     from the state it reached, one run of N_SHORT steps each of that
     configuration, of mom_pallas=False and of OFTPP_FINISH_PALLAS=1 (set
     while that step is built). Each run checks alpha bounds, Courant,
     p_iters, finiteness and that exactly the kernels of its path were
     launched (counts set to 0 just before it and read just after);
  4. from that state, N_CMP steps of the finish-on step with the kernels
     and N_CMP with all eight entry points swapped for their plain
     versions; compare alpha, u, v, w, p.

It then prints the `kernels` JSON line, the card's name and power limit,
and last `{"ok": true, "device": {...}}`. It exits non-zero, printing no
result, when no CUDA device is available or the package is missing.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import unittest.mock as mock

import numpy as np

N_STEPS = 100
N_TIMED = 90          # the last N_TIMED of the N_STEPS are timed
N_SHORT = 20          # steps of each same-state run
N_SHORT_TIMED = 15    # ... the last N_SHORT_TIMED timed
N_CMP = 5
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

# Per-cell f32 operation counts of each kernel's arithmetic (for the
# operations half of the bound; the bytes half is the larger for all).
# momentum_rhs: per component 3 convection fluxes (mass-flux average, van
# Leer limiter with 2 divisions, MUSCL value, product: ~16 with the
# difference) + 3 viscous and 3 dev2 fluxes (~8 each) + sums: ~105.
FLOPS_PER_CELL = {
    "apply_7pt": 13, "resid_scaled_7pt": 15, "apply_dot_7pt": 15,
    "flux_all": 3 * 30, "fct_iter": 4 * 60 + 3 * 6,
    "momentum_rhs": 3 * 105, "correct_divmax": 3 * 6 + 11 + 3,
    "momentum_finish": 3 * 11,
}
# Kernels of the default configuration; momentum_finish is opt-in.
DEFAULT_PATH = ("apply_7pt", "resid_scaled_7pt", "apply_dot_7pt", "flux_all",
                "fct_iter", "momentum_rhs", "correct_divmax")
FUSED = ("momentum_rhs", "correct_divmax", "momentum_finish")
REPLACES = {
    "apply_7pt": "openfoam_tpp_tpu/ops/pallas/seven_point.py:229",
    "resid_scaled_7pt": "openfoam_tpp_tpu/ops/pallas/seven_point.py:258",
    "apply_dot_7pt": "openfoam_tpp_tpu/ops/pallas/seven_point.py:286",
    "flux_all": "openfoam_tpp_tpu/ops/pallas/mules_flux.py:135",
    "fct_iter": "openfoam_tpp_tpu/ops/pallas/mules_fct.py:217",
    "momentum_rhs": "openfoam_tpp_tpu/ops/pallas/momentum_rhs.py:387",
    "correct_divmax": "openfoam_tpp_tpu/ops/pallas/correction.py:149",
    "momentum_finish": "openfoam_tpp_tpu/ops/pallas/mom_finish.py:88",
}
SOURCE = {
    "apply_7pt": "openfoam_tpp_tpu_torch/csrc/seven_point.cu",
    "resid_scaled_7pt": "openfoam_tpp_tpu_torch/csrc/seven_point.cu",
    "apply_dot_7pt": "openfoam_tpp_tpu_torch/csrc/seven_point.cu",
    "flux_all": "openfoam_tpp_tpu_torch/csrc/mules_flux.cu",
    "fct_iter": "openfoam_tpp_tpu_torch/csrc/mules_fct.cu",
    "momentum_rhs": "openfoam_tpp_tpu_torch/csrc/momentum_rhs.cu",
    "correct_divmax": "openfoam_tpp_tpu_torch/csrc/correction.cu",
    "momentum_finish": "openfoam_tpp_tpu_torch/csrc/mom_finish.cu",
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
    fct_spacing = (0.00185, 0.00185, 0.00185)
    for tag, dt in (("bf16 λ/anti", torch.bfloat16), ("f32", torch.float32)):
        lams = tuple(arr(0, 1, dt) for _ in range(3))
        antis = tuple((1e-3 * arr()).to(dt) for _ in range(3))
        check("fct_iter", tag, dt == torch.bfloat16,
              lambda: mf.fct_iter(lams, antis, al, amax, amin, dt_iv,
                                  fct_spacing),
              lambda: mf.fct_iter_plain(lams, antis, al, amax, amin, dt_iv,
                                        fct_spacing),
              (*lams, *antis, al, amax, amin, dt_iv), lams,
              BF16_RTOL if dt == torch.bfloat16 else F32_RTOL)

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
        got = ck.correct_divmax(*args, open_top=open_top)[3]
        ref = ck.correct_divmax_plain(*args, open_top=open_top)[3]
        derr = abs(float(got) - float(ref)) / max(abs(float(ref)), 1e-30)
        log(f"  correct_divmax    {tag} div_max kernel {float(got)!r} plain "
            f"{float(ref)!r} rel_err={derr:.3e} tol={F32_RTOL:.1e}")
        if derr > F32_RTOL:
            raise AssertionError(f"correct_divmax {tag}: div_max disagrees")
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


def counters():
    """name → (module, entry point, plain version), for every kernel."""
    from openfoam_tpp_tpu_torch.ops.kernels import correction as ck
    from openfoam_tpp_tpu_torch.ops.kernels import mom_finish as mfk
    from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as mrk
    from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as mf
    from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as mfx
    from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp

    return {
        "apply_7pt": (sp, "apply_7pt", sp.apply_7pt_plain),
        "resid_scaled_7pt": (sp, "resid_scaled_7pt", sp.resid_scaled_7pt_plain),
        "apply_dot_7pt": (sp, "apply_dot_7pt", sp.apply_dot_7pt_plain),
        "flux_all": (mfx, "flux_all", mfx.flux_all_plain),
        "fct_iter": (mf, "fct_iter", mf.fct_iter_plain),
        "momentum_rhs": (mrk, "momentum_rhs", mrk.momentum_rhs_plain),
        "correct_divmax": (ck, "correct_divmax", ck.correct_divmax_plain),
        "momentum_finish": (mfk, "momentum_finish", mfk.momentum_finish_plain),
    }


def drive(label, step, state, bundle, params, n_steps, n_timed, n_fluid,
          expect):
    """`n_steps` steps of `step` from (state, bundle), the last `n_timed`
    timed, with every launch count set to 0 just before and read just
    after. Checks the run and that exactly the kernels in `expect` ran."""
    import torch

    fns = {k: getattr(m, a) for k, (m, a, _) in counters().items()}
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    diags = []
    t_first = time.perf_counter()
    for i in range(n_steps):
        if i == n_steps - n_timed:
            torch.cuda.synchronize()
            t_timed = time.perf_counter()
        state, d, bundle = step(state, params, precond=bundle)
        diags.append(d)
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
             "launches_per_step": {k: v / n_steps for k, v in launches.items()}}
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
    return state, bundle, launches, stats


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
    spacing = tuple(float(h) for h in geom.spacing)
    rows = phase_kernels(geom.shape, spacing, dev)

    # 3. the main path: the bench's configuration from rest, then the
    # three configurations from the state it reached
    props = PhysicalProperties()
    params = CaseParams.make(R=0.004, freq=1.88, duration=20.0, device=dev)

    def build(controls):
        return make_step(geom, props, controls, carry_precond=True, device=dev)

    step = build(SolverControls(use_pallas=True))
    state = init_state(geom, dt0=1e-3, device=dev)
    bundle = step.init_precond(state)
    state, bundle, launches, main = drive(
        "main path: use_pallas=True", step, state, bundle, params, N_STEPS,
        N_TIMED, n_fluid, DEFAULT_PATH)
    # The three configurations, each from the state reached.
    saved = os.environ.get("OFTPP_FINISH_PALLAS")
    os.environ["OFTPP_FINISH_PALLAS"] = "1"
    try:   # the gate is read when the step is built
        step_fin = build(SolverControls(use_pallas=True))
    finally:
        if saved is None:
            os.environ.pop("OFTPP_FINISH_PALLAS")
        else:
            os.environ["OFTPP_FINISH_PALLAS"] = saved
    configs = {
        "use_pallas": (step, DEFAULT_PATH),
        "mom_pallas_false": (build(SolverControls(use_pallas=True,
                                                  mom_pallas=False)),
                             [k for k in DEFAULT_PATH if k not in FUSED]),
        "finish_on": (step_fin, list(counters())),
    }
    runs = {}
    for name, (stp, expect) in configs.items():
        _, _, run_launches, runs[name] = drive(
            f"{name}, same state", stp, state, bundle, params, N_SHORT,
            N_SHORT_TIMED, n_fluid, expect)
        if name == "finish_on":
            launches["momentum_finish"] = run_launches["momentum_finish"]

    # 4. the whole step, kernels against plain versions, from one state,
    # in the finish-on configuration (all eight entry points swapped)
    def run(n):
        s, b = state, bundle
        its = []
        for _ in range(n):
            s, dd, b = step_fin(s, params, precond=b)
            its.append(int(dd.p_iters))
        return s, its

    s_k, it_k = run(N_CMP)
    with contextlib.ExitStack() as stack:
        for m, attr, plain in counters().values():
            stack.enter_context(mock.patch.object(m, attr, plain))
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
    detail = {"kernels": out, "shape": list(geom.shape), "fluid_cells": n_fluid,
              "runs": {"use_pallas_from_rest": main, "same_state": runs}}
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
