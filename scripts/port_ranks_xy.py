"""'NxM' over ranks on the card, without the rest of chip_smoke.py.

    python3 scripts/port_ranks_xy.py

Builds the kernels, runs the card tests of the halo kernels (the
windowed apply-dot and epilogue among them), then chip_smoke.py's phase
2 halo parts (iv)-(vi), phases 5 and 8 (what 12e and 12f resume from),
12e and 12f; writes the phases' stats to perf_out/port_ranks_xy.json and
prints the card's name and power limit. About 6 minutes on an H100."""
import json, os, subprocess, sys, tempfile, time
repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the checkout
sys.path.insert(0, repo)
import chip_smoke as cs


def main():
    import torch
    from openfoam_tpp_tpu_torch.config import PhysicalProperties
    from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
    from openfoam_tpp_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all(ptxas_verbose=True)
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    for name in ("seven_point", "correction"):
        for line in logs[name].splitlines():
            if ("apply_dot" in line or "correct_divmax" in line or "registers" in line):
                cs.log(f"  {name}: {line.strip()}")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q", "-x",
                        "tests/test_torch_cuda.py", "-m", "gpu", "-k",
                        "halo or apply_dot or correct_divmax or island"],
                       cwd=repo, capture_output=True, text=True)
    cs.log(r.stdout[-3000:] + r.stderr[-2000:])
    cs.log(f"[card tests] rc {r.returncode} {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    geom = build_tank_geometry(**cs.FLAGSHIP)
    spacing = tuple(float(h) for h in geom.spacing)
    t0 = time.perf_counter()
    out = {"halo": cs.phase_halo_kernels(geom.shape, spacing, dev)}
    cs.phase_closed_top_halo(dev)
    out["xy"] = cs.phase_xy_halo_kernels(geom.shape, spacing, dev)
    cs.log(f"[2 iv-vi] {time.perf_counter() - t0:.1f} s")
    rows = {"correct_divmax": {"ms": float("nan"), "step_ms": float("nan")}}
    with tempfile.TemporaryDirectory(prefix="ranks_xy_case_") as base:
        t0 = time.perf_counter()
        _, case = cs.phase_case(geom, base)
        cs.log(f"[5] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    six = cs.phase_6dof(dev, PhysicalProperties(), rows)
    cs.log(f"[8] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    e = cs.phase_ranks_6dof(dev, six, case)
    cs.log(f"[12e] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["12f"] = cs.phase_ranks_xy(dev, six, case, e)
    cs.log(f"[12f] {time.perf_counter() - t0:.1f} s")
    os.makedirs(os.path.join(repo, "perf_out"), exist_ok=True)
    with open(os.path.join(repo, "perf_out", "port_ranks_xy.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    print("ranks xy OK" if r.returncode == 0 else "ranks xy: card tests FAILED")
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
